"""Processor, generation and packaging of the PyTorch port, on the CPU.

The processor must produce JAX's inputs exactly; greedy generation must
give JAX's tokens on the same weights (tiny config, fp32).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from paligemma_tpu import generation as jgen
from paligemma_tpu import processing as jproc
from paligemma_tpu.config import tiny_config as j_tiny_config
from paligemma_tpu.models import paligemma as jpg
import paligemma_tpu_torch
from paligemma_tpu_torch import generation as tgen
from paligemma_tpu_torch import processing as tproc
from paligemma_tpu_torch.ops import _build
from paligemma_tpu_torch.utils.convert import from_jax_params

REPO = Path(__file__).resolve().parent.parent
PROMPTS = ["describe", "what is the total revenue?", ""]


def _images():
    rng = np.random.RandomState(0)
    return [Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
            for h, w in ((64, 48), (20, 33), (32, 32))]


def _processors(cfg_j, cfg_t):
    vj, vt = cfg_j.vision_config, cfg_t.vision_config
    pj = jproc.PaliGemmaProcessor(jproc.ByteTokenizer(), vj.num_image_tokens, vj.image_size)
    pt = tproc.PaliGemmaProcessor(tproc.ByteTokenizer(), vt.num_image_tokens, vt.image_size)
    return pj, pt


@pytest.fixture(scope="module")
def setup():
    """Aligned configs, processors and the same weights in both packages."""
    pj, pt = _processors(j_tiny_config(), paligemma_tpu_torch.tiny_config())
    cfg_j = jproc.align_config(j_tiny_config(), pj)
    cfg_t = tproc.align_config(paligemma_tpu_torch.tiny_config(), pt)
    tproc.assert_aligned(pt, cfg_t)
    params = jpg.init_params(cfg_j, jax.random.PRNGKey(1), jnp.float32)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg_t, device="cpu")
    return cfg_j, params, pj, cfg_t, model, pt


def test_processor_inputs_equal_jax(setup):
    _, _, pj, _, _, pt = setup
    images = _images()
    for i, prompt in enumerate(PROMPTS):
        a = pj([prompt], [images[i]])
        b = pt([prompt], [images[i]])
        np.testing.assert_array_equal(b["input_ids"], a["input_ids"])
        np.testing.assert_array_equal(b["attention_mask"], a["attention_mask"])
        np.testing.assert_allclose(b["pixel_values"], a["pixel_values"], rtol=0, atol=1e-6)
    batch_j, batch_t = pj(PROMPTS, images), pt(PROMPTS, images)
    np.testing.assert_array_equal(batch_t["input_ids"], batch_j["input_ids"])
    with pytest.raises(ValueError):
        pt(PROMPTS, images[:1])


def test_align_config_and_tokenizer_match_jax(setup):
    cfg_j, _, pj, cfg_t, _, pt = setup
    assert cfg_t.image_token_index == cfg_j.image_token_index == pt.image_token_id
    assert cfg_t.vocab_size == cfg_j.vocab_size
    assert cfg_t.text_config.vocab_size == cfg_j.text_config.vocab_size
    with pytest.raises(ValueError):
        tproc.assert_aligned(pt, paligemma_tpu_torch.tiny_config())
    ids = [300, 65, 66, pt.tokenizer.eos_token_id, 10]
    for skip in (True, False):
        assert pt.tokenizer.decode(ids, skip) == pj.tokenizer.decode(ids, skip)


def _inputs(proc, i=0):
    out = proc([PROMPTS[i]], [_images()[i]])
    return out["input_ids"], out["pixel_values"]


def test_generate_tokens_equal_jax(setup):
    cfg_j, params, pj, _, model, pt = setup
    ids, pix = _inputs(pt)
    ref, _ = jgen.generate(params, cfg_j, jnp.asarray(ids), jnp.asarray(pix), max_new_tokens=12,
                           eos_token_id=pj.tokenizer.eos_token_id, cache_dtype=jnp.float32,
                           stop_at_eos=False)
    steps = []
    got, cache = tgen.generate(model, torch.from_numpy(ids), torch.from_numpy(pix), 12,
                               -1, step_callback=steps.append)
    assert got == ref and len(got) == 12
    assert steps == list(range(12))
    assert cache.length == ids.shape[1] + 11


def test_decode_steps_agree_with_generate(setup):
    _, _, _, _, model, pt = setup
    ids, pix = map(torch.from_numpy, _inputs(pt, 1))
    want, _ = tgen.generate(model, ids, pix, 9, -1)
    cache = tgen.make_cache(model, 1, ids.shape[1], 9)
    logits, cache = tgen.prefill(model, ids, pix, cache)
    assert tuple(logits.shape) == (1, 1, model.cfg.text_config.vocab_size)
    first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    toks, last, cache = tgen.decode_steps(model, first, cache, 8)
    assert toks.dtype == torch.int32 and tuple(toks.shape) == (1, 8)
    assert [int(first)] + toks[0].tolist() == want
    assert int(last) == want[-1] and cache.length == ids.shape[1] + 8


def test_eos_stops_generation(setup):
    _, _, _, _, model, pt = setup
    ids, pix = map(torch.from_numpy, _inputs(pt, 2))
    full, _ = tgen.generate(model, ids, pix, 10, -1)
    eos = full[4]
    got, cache = tgen.generate(model, ids, pix, 10, eos)
    assert got == full[: full.index(eos) + 1]
    assert cache.length == ids.shape[1] + len(got) - 1
    with pytest.raises(ValueError, match="batch-1"):
        tgen.generate(model, ids.repeat(2, 1), pix.repeat(2, 1, 1, 1), 3, eos)


def test_import_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import paligemma_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'paligemma_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'paligemma_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('paligemma_tpu_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15  # every module of the port was imported


def test_nvcc_command_targets_sm90a_into_the_ignored_build_dir(monkeypatch, tmp_path):
    """One compile per source (started together by ``build``), then one
    link into the hashed directory under the ignored build dir."""
    cmds = _build.compile_commands(tmp_path, "nvcc")
    for cmd in cmds:
        assert cmd[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
        assert {"-c", "-O3", "-std=c++17"} <= set(cmd) and "-shared" not in cmd
        assert Path(cmd[cmd.index("-o") + 1]).parent == tmp_path
    srcs = {Path(c).name for cmd in cmds for c in cmd if c.endswith(".cu")}
    assert srcs == {"flash_attention.cu", "decode_attention.cu", "quant_matmul.cu", "w4a8.cu"}
    assert len(cmds) == len(srcs)
    objs = [cmd[cmd.index("-o") + 1] for cmd in cmds]
    link = _build.link_command(_build.library_path(), objs, "nvcc")
    assert link[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"] and "-shared" in link
    assert link[-len(objs):] == objs
    out = Path(link[link.index("-o") + 1])
    assert out.name == _build.LIB_NAME and out.parent.parent == _build.BUILD_DIR
    assert out.parent.name == _build.source_hash()
    rel = _build.BUILD_DIR.relative_to(REPO).as_posix() + "/"
    assert rel in (REPO / ".gitignore").read_text().split()
    # A changed flag is a new build directory, as a changed source is.
    monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-lineinfo"])
    assert _build.source_hash() != out.parent.name

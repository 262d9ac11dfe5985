"""Processor, generation and packaging of the PyTorch port, on the CPU.

The processor must produce JAX's inputs exactly; greedy generation must
give JAX's tokens on the same weights (tiny config, fp32), through
``generate``, ``generate_chunked`` and ``generate_scan``, with the float
and the int8 cache; the cache length lives on the device and must hold
JAX's. Sampled generation repeats itself under one seed (its draws cannot
be JAX's; ``test_torch_sampling.py`` holds them to JAX's nucleus).
"""
import os
import subprocess
import sys
import time
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
from paligemma_tpu_torch.models import gemma
from paligemma_tpu_torch.ops import _build
from paligemma_tpu_torch.utils import memory, profiling
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


# ---------------------------------------------------------------------------
# The device-length cache, generate_chunked and generate_scan, sampling
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def varied(setup):
    """Weights whose greedy stream for request 0 changes token after its
    first steps ([10, 10, 1017, 823, 823, ...]), so that an EOS inside the
    stream is followed by other tokens and the trim and the freeze act."""
    cfg_j, _, _, cfg_t, _, pt = setup
    params = jpg.init_params(cfg_j, jax.random.PRNGKey(3), jnp.float32)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg_t, device="cpu")
    ids, pix = _inputs(pt)
    full, _ = tgen.generate(model, torch.from_numpy(ids), torch.from_numpy(pix), 9, -1)
    # EOS: the first token after step 0 that the next step does not repeat.
    i = next(i for i in range(1, len(full) - 1) if full[i + 1] != full[i] and full[i] not in full[:i])
    return cfg_j, params, model, pt, full[i]


CACHES = {"float": (jnp.float32, None), "int8": (jnp.int8, torch.int8)}


@pytest.mark.parametrize("kv", list(CACHES))
def test_device_length_cache_holds_jax_length(varied, kv):
    cfg_j, params, model, pt, _ = varied
    jdtype, tdtype = CACHES[kv]
    ids, pix = _inputs(pt)
    t = ids.shape[1]
    jcache = jgen.make_cache(cfg_j, 1, t, 4, jdtype)
    lg_j, jcache = jax.jit(jpg.prefill, static_argnums=(1, 5))(
        params, cfg_j, jnp.asarray(ids), jnp.asarray(pix), jcache, False)
    cache = tgen.make_cache(model, 1, t, 4, tdtype)
    lg_t, cache = tgen.prefill(model, torch.from_numpy(ids), torch.from_numpy(pix), cache)
    assert cache.length.dtype == torch.int32 and cache.length.dim() == 0
    assert int(cache.length) == int(jcache.length) == t == cache.host_length
    assert cache.valid.tolist() == [t]
    first = jnp.argmax(lg_j[:, -1], -1).astype(jnp.int32)[:, None]
    toks_j, _, jcache = jgen.decode_steps(params, cfg_j, first, jcache, jax.random.PRNGKey(0), 3)
    toks_t, _, cache = tgen.decode_steps(model, torch.from_numpy(np.array(first)), cache, 3)
    assert int(cache.length) == int(jcache.length) == t + 3 == cache.host_length
    assert cache.valid.tolist() == [t + 3]
    assert toks_t.tolist() == np.asarray(toks_j).tolist()
    with pytest.raises(ValueError, match="cache full"):
        tgen.decode_steps(model, toks_t[:, -1:], cache, 2)


@pytest.mark.parametrize("with_eos", [False, True])
@pytest.mark.parametrize("max_new", [8, 9])  # 7 and 8 decode steps: the last chunk of 3 ragged
@pytest.mark.parametrize("kv", list(CACHES))
def test_generate_chunked_matches_jax(varied, kv, max_new, with_eos):
    cfg_j, params, model, pt, eos_in_stream = varied
    jdtype, tdtype = CACHES[kv]
    eos = eos_in_stream if with_eos else -1
    ids, pix = _inputs(pt)
    ref = jgen.generate_chunked(params, cfg_j, jnp.asarray(ids), jnp.asarray(pix), max_new, eos,
                                cache_dtype=jdtype, chunk=3)
    ref_gen, _ = jgen.generate(params, cfg_j, jnp.asarray(ids), jnp.asarray(pix), max_new, eos,
                               cache_dtype=jdtype)
    ids_t, pix_t = torch.from_numpy(ids), torch.from_numpy(pix)
    pieces = list(tgen.generate_chunked_stream(model, ids_t, pix_t, max_new, eos, cache_dtype=tdtype,
                                               chunk=3))
    got, _ = tgen.generate(model, ids_t, pix_t, max_new, eos, cache_dtype=tdtype)
    assert sum(pieces, []) == tgen.generate_chunked(model, ids_t, pix_t, max_new, eos,
                                                    cache_dtype=tdtype, chunk=3)
    assert sum(pieces, []) == ref == ref_gen == got
    assert len(pieces[0]) == 1 and all(1 <= len(p) <= 3 for p in pieces[1:])
    if with_eos:  # stopped at the EOS inside the stream
        assert got[-1] == eos and len(got) < max_new
    else:
        assert len(got) == max_new


@pytest.mark.parametrize("with_eos", [False, True])
@pytest.mark.parametrize("kv", list(CACHES))
def test_generate_scan_matches_jax(varied, kv, with_eos):
    """Batch 2 (request 0's prompt with two images): with the EOS of row
    0's stream, row 0 stops early and its later tokens are frozen to EOS."""
    cfg_j, params, model, pt, eos_in_stream = varied
    jdtype, tdtype = CACHES[kv]
    eos = eos_in_stream if with_eos else -1
    images = _images()
    inputs = pt([PROMPTS[0]] * 2, [images[0], images[1]])
    ids, pix = inputs["input_ids"], inputs["pixel_values"]
    max_new = 8
    jcache = jgen.make_cache(cfg_j, 2, ids.shape[1], max_new, jdtype)
    ref = jgen.generate_scan(params, cfg_j, jnp.asarray(ids), jnp.asarray(pix), jcache,
                             jax.random.PRNGKey(0), max_new, eos)
    got = tgen.generate_scan(model, torch.from_numpy(ids), torch.from_numpy(pix), max_new, eos,
                             cache_dtype=tdtype)
    assert isinstance(got, tgen.GenerationResult)
    assert got.tokens.dtype == torch.int32 and got.num_valid.dtype == torch.int32
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.num_valid.numpy(), np.asarray(ref.num_valid))
    if with_eos:  # row 0 froze after its EOS; unfrozen, it goes on with other tokens
        n0 = int(got.num_valid[0])
        assert n0 < max_new and (got.tokens[0, n0 - 1:] == eos).all()
        free = tgen.generate_scan(model, torch.from_numpy(ids), torch.from_numpy(pix), max_new, -1,
                                  cache_dtype=tdtype)
        assert (free.tokens[0, n0:] != eos).all()
    else:
        assert got.num_valid.tolist() == [max_new, max_new]


def test_sampled_generation_repeats_with_its_seed(varied):
    """One seed gives one stream, through every path (each draws once a
    token from the generator); another seed another; temperature 0 under
    do_sample is greedy."""
    _, _, model, pt, _ = varied
    ids, pix = map(torch.from_numpy, _inputs(pt))
    vocab = model.cfg.text_config.vocab_size

    def run(path, seed, **kw):
        gen = torch.Generator().manual_seed(seed)
        kw = dict(do_sample=True, temperature=0.8, top_p=0.9, generator=gen, **kw)
        if path == "generate":
            return tgen.generate(model, ids, pix, 10, -1, **kw)[0]
        if path == "chunked":
            return tgen.generate_chunked(model, ids, pix, 10, -1, chunk=3, **kw)
        return tgen.generate_scan(model, ids, pix, 10, -1, **kw).tokens[0].tolist()

    a = run("generate", 7)
    assert a == run("generate", 7) == run("chunked", 7) == run("scan", 7)
    assert a != run("generate", 8)
    assert all(0 <= x < vocab for x in a)
    greedy, _ = tgen.generate(model, ids, pix, 10, -1)
    assert run("generate", 7, stop_at_eos=False) == a
    sampled_t0, _ = tgen.generate(model, ids, pix, 10, -1, do_sample=True, temperature=0.0,
                                  generator=torch.Generator().manual_seed(7))
    assert sampled_t0 == greedy


def test_pooled_cache_is_reused_once_dropped(setup):
    """The pool hands out a dropped cache's buffers again (with what was
    captured on them), never those of a cache a caller still holds."""
    _, _, _, _, model, pt = setup
    ids, pix = map(torch.from_numpy, _inputs(pt, 2))
    _, first = tgen.generate(model, ids, pix, 5, -1)
    ptr, graphs = first.k.data_ptr(), first.graphs
    # One decode runner, and a prefill runner of this request's shape (the
    # pool may have handed these buffers to other prompts before).
    assert sum(k[0] != "prefill" for k in graphs) == 1
    assert any(k[0] == "prefill" and k[3] == tuple(ids.shape) for k in graphs)
    kept = dict(graphs)
    _, held = tgen.generate(model, ids, pix, 5, -1)
    assert held.k.data_ptr() != ptr  # ``first`` is still held
    del first
    toks, again = tgen.generate(model, ids, pix, 5, -1)
    assert again.k.data_ptr() == ptr and again.graphs is graphs and graphs == kept  # nothing new
    assert int(again.length) == again.host_length == ids.shape[1] + 4
    assert toks == tgen.generate(model, ids, pix, 5, -1)[0]


def test_pooled_caches_share_length_buckets_and_stay_bounded(setup):
    """A pooled cache's length is rounded up to whole steps, so requests of
    nearby lengths get one shape (and, once dropped, one cache and its
    graphs); the pool keeps the ``POOL_SLOTS`` caches handed out last."""
    _, _, _, _, model, _ = setup
    step = tgen.CACHE_LENGTH_STEP
    a = tgen._pooled_cache(model, 1, step + 1, 2, None)
    assert a.max_len == 2 * step
    ptr = a.k.data_ptr()
    del a
    b = tgen._pooled_cache(model, 1, step + 3, step - 3, None)
    assert b.max_len == 2 * step and b.k.data_ptr() == ptr
    held = [tgen._pooled_cache(model, 2, 1, step * k, None) for k in range(1, tgen.POOL_SLOTS + 3)]
    assert [c.max_len for c in held] == [step * (k + 1) for k in range(1, tgen.POOL_SLOTS + 3)]
    slots = tgen._CACHE_POOL[model]
    assert [s[1].k.data_ptr() for s in slots] == [c.k.data_ptr() for c in held[-tgen.POOL_SLOTS:]]
    assert b.k.data_ptr() == ptr and int(b.length) == 0  # dropped from the pool, still its holder's


# ---------------------------------------------------------------------------
# The prefill (a CUDA graph per input shape on the card; eager here)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prompt", [0, 1])  # two prompt lengths
@pytest.mark.parametrize("kv", list(CACHES))
def test_prefill_matches_jitted_jax_prefill(setup, kv, prompt):
    """``generation.prefill`` gives jitted JAX's last-position logits and
    writes its cache rows, length and valid length; again on the same
    buffers, emptied (the runner kept with the cache)."""
    cfg_j, params, _, _, model, pt = setup
    jdtype, tdtype = CACHES[kv]
    ids, pix = _inputs(pt, prompt)
    t = ids.shape[1]
    jcache = jgen.make_cache(cfg_j, 1, t, 3, jdtype)
    lg_j, jcache = jax.jit(jpg.prefill, static_argnums=(1, 5))(
        params, cfg_j, jnp.asarray(ids), jnp.asarray(pix), jcache, False)
    cache = tgen.make_cache(model, 1, t, 3, tdtype)
    for _ in range(2):
        cache = gemma.reset_cache(cache)
        lg_t, cache = tgen.prefill(model, torch.from_numpy(ids), torch.from_numpy(pix), cache)
        assert lg_t.dtype == torch.float32 and tuple(lg_t.shape) == tuple(lg_j.shape) == (1, 1, cfg_j.vocab_size)
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), rtol=1e-5, atol=1e-5)
        assert int(cache.length) == int(jcache.length) == t == cache.host_length
        assert cache.valid.tolist() == [t]
        if kv == "float":
            for got, ref in ((cache.k, jcache.k), (cache.v, jcache.v)):
                np.testing.assert_allclose(got[:, :, :t].numpy(), np.asarray(ref[:, :, :t]), rtol=1e-5, atol=1e-5)
                assert not got[:, :, t:].any()
        else:  # K/V ~1e-6 apart in fp32: the int8 values within one step
            for got, ref in ((cache.k, jcache.k), (cache.v, jcache.v)):
                diff = got[:, :, :t].numpy().astype(np.int32) - np.asarray(ref[:, :, :t], np.int32)
                assert np.abs(diff).max() <= 1 and not got[:, :, t:].any()
            for got, ref in ((cache.k_scale, jcache.k_scale), (cache.v_scale, jcache.v_scale)):
                np.testing.assert_allclose(got[:, :, :t].numpy(), np.asarray(ref[:, :, :t]), rtol=1e-5)
    assert [k[0] for k in cache.graphs] == ["prefill"]  # one runner, no graph on the CPU
    assert all(r.graph is None for r in cache.graphs.values())
    with pytest.raises(ValueError, match="empty cache"):
        tgen.prefill(model, torch.from_numpy(ids), torch.from_numpy(pix), cache)


def test_prepare_prefill_captures_nothing_on_the_cpu(setup):
    _, _, _, _, model, pt = setup
    ids, pix = _inputs(pt)
    cache = tgen.make_cache(model, 1, ids.shape[1], 4)
    assert tgen.prepare_prefill(model, cache, ids.shape, pix.shape) == 0.0
    assert int(cache.length) == cache.host_length == 0 and not cache.graphs
    assert not cache.k.any() and not cache.v.any() and not cache.valid.any()


def test_prefill_runners_stay_bounded_least_recently_used_first(setup):
    """A cache keeps the ``PREFILL_GRAPHS`` prefill runners (on the card,
    graphs) of the input shapes it served last; its decode runners do not
    count against them. On the CPU a runner holds no graph."""
    _, _, _, _, model, pt = setup
    img = _images()[0]
    inputs = [pt(["x" * n], [img]) for n in range(1, tgen.PREFILL_GRAPHS + 3)]
    lengths = [x["input_ids"].shape[1] for x in inputs]
    assert len(set(lengths)) == len(lengths)
    cache = tgen.make_cache(model, 1, max(lengths), 4)

    def run(i):
        nonlocal cache
        cache = gemma.reset_cache(cache)
        logits, cache = tgen.prefill(model, torch.from_numpy(inputs[i]["input_ids"]),
                                     torch.from_numpy(inputs[i]["pixel_values"]), cache)
        return logits

    def kept():  # prompt lengths of the prefill runners, least recently used first
        return [k[3][1] for k in cache.graphs if k[0] == "prefill"]

    first = run(0)
    tgen.decode_steps(model, first.argmax(-1).to(torch.int32), cache, 2)  # a decode runner
    for i in range(1, tgen.PREFILL_GRAPHS):
        run(i)
    assert kept() == lengths[: tgen.PREFILL_GRAPHS]
    run(0)  # used again: now the most recent
    run(tgen.PREFILL_GRAPHS)  # one past the bound: the least recently used goes
    assert kept() == [*lengths[2: tgen.PREFILL_GRAPHS], lengths[0], lengths[tgen.PREFILL_GRAPHS]]
    assert len(cache.graphs) == tgen.PREFILL_GRAPHS + 1  # and the decode runner
    assert all(r.graph is None for r in cache.graphs.values())
    assert torch.equal(run(0), first)


def test_memory_probes_and_tree_bytes(setup):
    _, _, _, _, model, _ = setup
    n_model = sum(t.numel() * t.element_size() for t in (*model.parameters(), *model.buffers()))
    assert memory.tree_bytes(model) == n_model
    cache = tgen.make_cache(model, 2, 5, 3)
    k = cache.k.numel() * cache.k.element_size()
    assert memory.tree_bytes(cache) == 2 * k + 4 + 2 * 4  # k, v, the length, two valid rows
    q8 = tgen.make_cache(model, 2, 5, 3, torch.int8)
    assert memory.tree_bytes(q8) == 2 * q8.k.numel() + 2 * 4 * q8.k_scale.numel() + 12  # + fp32 scales
    assert memory.tree_bytes({"a": [cache.k, (cache.v, 3)], "b": None}) == 2 * k
    assert memory.estimate_live_mb(model, cache) == (n_model + 2 * k + 12) / 2**20
    assert memory.device_memory_stats("cpu") == {}
    assert memory.bytes_in_use("cpu") == memory.peak_bytes_in_use("cpu") == 0
    assert memory.peak_memory_mb("cpu") == 0.0


def test_profiling_timed_trace_and_annotate():
    # The module keeps ``timed`` and ``fence``; traces are taken with
    # ``torch.profiler`` itself.
    x = torch.arange(6.0)
    out, seconds = profiling.timed(lambda: x * 2, device="cpu")
    assert torch.equal(out, x * 2) and seconds >= 0.0
    _, slept = profiling.timed(lambda: time.sleep(0.01), device="cpu")
    assert slept >= 0.01
    profiling.fence([x, {"y": x}])  # CPU tensors: nothing to wait for
    assert not hasattr(profiling, "trace") and not hasattr(profiling, "annotate")

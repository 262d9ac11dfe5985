"""The KV-cache-off arm and the ablation harness of the PyTorch port against
the JAX package's, on the CPU (tiny config, fp32).

``forward_nocache`` must give JAX's logits within 1e-5 over a padded buffer
whose pad region is poisoned (other tokens there change no valid position),
and ``ablation_study_torch.py --smoke`` must write the JSON keys that
``ablation_study.py --smoke`` writes, with cached and uncached tokens
identical.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ablation_study as jax_ablation
import ablation_study_torch as torch_ablation
from paligemma_tpu.config import tiny_config as j_tiny_config
from paligemma_tpu.models import paligemma as jpg
import paligemma_tpu_torch
from paligemma_tpu_torch.models import paligemma as tpg
from paligemma_tpu_torch.ops import kernels
from paligemma_tpu_torch.processing import align_config
from paligemma_tpu_torch.utils.convert import from_jax_params


@pytest.fixture(scope="module")
def weights():
    cfg_j = j_tiny_config()
    params = jpg.init_params(cfg_j, jax.random.PRNGKey(2), jnp.float32)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), paligemma_tpu_torch.tiny_config(),
                            device="cpu")
    return cfg_j, params, model


@pytest.mark.parametrize("valid", [[30], [21, 30]])
def test_forward_nocache_matches_jax_with_a_poisoned_pad_region(weights, valid):
    cfg_j, params, model = weights
    b, t = len(valid), 36
    n_img = cfg_j.vision_config.num_image_tokens
    rng = np.random.RandomState(3)
    ids = rng.randint(2, 250, size=(b, t)).astype(np.int32)
    ids[:, :n_img] = cfg_j.image_token_index
    pix = rng.randn(b, 3, 32, 32).astype(np.float32)
    vl = np.asarray(valid, np.int32)
    got = tpg.forward_nocache(model, torch.from_numpy(ids), torch.from_numpy(pix), torch.from_numpy(vl)).numpy()
    want = np.asarray(jpg.forward_nocache(params, cfg_j, jnp.asarray(ids), jnp.asarray(pix), jnp.asarray(vl)))
    for r, v in enumerate(valid):
        np.testing.assert_allclose(got[r, :v], want[r, :v], rtol=1e-5, atol=1e-5)
    poisoned = ids.copy()
    for r, v in enumerate(valid):
        poisoned[r, v:] = rng.randint(2, 250, size=t - v)
    again = tpg.forward_nocache(model, torch.from_numpy(poisoned), torch.from_numpy(pix), torch.from_numpy(vl))
    for r, v in enumerate(valid):
        np.testing.assert_array_equal(again.numpy()[r, :v], got[r, :v])
    # No mask: every position of the buffer, as JAX's cache-free forward.
    full = tpg.forward_nocache(model, torch.from_numpy(ids), torch.from_numpy(pix)).numpy()
    np.testing.assert_allclose(full, np.asarray(jpg.forward_nocache(params, cfg_j, jnp.asarray(ids), jnp.asarray(pix))),
                               rtol=1e-5, atol=1e-5)


def test_forward_nocache_last_valid_logits_are_the_prefill_logits(weights):
    """The uncached step's selection (the last valid position of a padded
    buffer) gives the cached prefill's last-position logits."""
    from paligemma_tpu_torch import generation

    _, _, model = weights
    cfg = model.cfg
    n_img = cfg.vision_config.num_image_tokens
    ids = torch.cat([torch.full((1, n_img), cfg.image_token_index), torch.arange(5, 14)[None]], 1).to(torch.int32)
    pix = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(4))
    buf = torch.cat([ids, torch.full((1, 7), 9, dtype=torch.int32)], 1)
    nocache = tpg.forward_nocache(model, buf, pix, torch.tensor([ids.shape[1]], dtype=torch.int32))
    cached, _ = generation.prefill(model, ids, pix, generation.make_cache(model, 1, ids.shape[1], 1))
    torch.testing.assert_close(nocache[:, ids.shape[1] - 1], cached[:, -1], rtol=1e-5, atol=1e-5)


def test_ablation_smoke_writes_the_jax_harness_keys(tmp_path):
    """``ablation_study_torch.py --smoke --only_cpu=True``: the JSON keys of
    JAX ``ablation_study.py --smoke``, cached and uncached tokens identical,
    the runs' token counts, and no kernel launched on the CPU."""
    before = kernels.launch_counts()
    summary = torch_ablation.main(["--smoke", "--only_cpu=True", "--output_dir", str(tmp_path / "torch")])
    assert kernels.launch_counts() == before
    jax_ablation.main(["--smoke", "--output_dir", str(tmp_path / "jax")])
    out = {}
    for name in ("torch", "jax"):
        d = tmp_path / f"{name}_smoke"
        out[name] = (json.loads((d / "results_detailed.json").read_text()),
                     json.loads((d / "summary_statistics.json").read_text()))
    (t_res, t_sum), (j_res, j_sum) = out["torch"], out["jax"]
    assert [sorted(r) for r in t_res] == [sorted(r) for r in j_res]
    assert t_sum.keys() == j_sum.keys() == summary.keys()
    assert all(t_sum[k].keys() == j_sum[k].keys() for k in t_sum)
    assert all(t_sum[k][m].keys() == j_sum[k][m].keys() for k in t_sum for m in t_sum[k] if isinstance(t_sum[k][m], dict))
    checks = [r["tokens_identical"] for r in t_res if "tokens_identical" in r]
    assert checks == [True, True]
    assert all(r["tokens_generated"] == r["max_tokens_target"] for r in t_res)
    assert all(r["peak_memory_mb"] > 0 for r in t_res)  # the CPU's analytic lower bound


def test_ablation_runner_arms_agree_over_the_warm_up_boundary(tmp_path):
    """Past the 32 warm-up tokens both arms still give one stream, on
    weights whose greedy stream changes token."""
    from paligemma_tpu_torch.processing import ByteTokenizer, PaliGemmaProcessor

    cfg = paligemma_tpu_torch.tiny_config()
    proc = PaliGemmaProcessor(ByteTokenizer(), cfg.vision_config.num_image_tokens, cfg.vision_config.image_size)
    model = tpg.init_params(align_config(cfg, proc), 0, device="cpu")
    with torch.no_grad():
        model.llm.final_norm.weight.normal_(0.0, 2.0, generator=torch.Generator().manual_seed(9))
    item = dict(torch_ablation.COCO_BENCHMARK[1])
    _, path = torch_ablation.get_image(item, str(tmp_path))
    runner = torch_ablation.Runner(model, proc, max_new_tokens=40)
    toks = {}
    for cached in (True, False):
        config = {"kv_cache": cached, "temperature": 0.0, "max_tokens": 40}
        toks[cached] = torch_ablation.run_inference(runner, proc, path, item["prompt"], config,
                                                    return_tokens=True)["token_ids"]
    assert toks[True] == toks[False] and len(toks[True]) == 40 and len(set(toks[True])) > 1

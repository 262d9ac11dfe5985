"""The port's pipeline (``paligemma_tpu_torch/parallel/pipeline.py``), its
dry run and its launcher, on the CPU.

Ranks run over gloo (``parallel.mesh.spawn``; rank functions in
``torch_parallel_workers.py``); the JAX side runs in this process. As
``tests/test_pipeline.py`` holds the JAX pipeline:

- the GPipe forward at (stages, layers, microbatches) = (2, 2, 2) and
  (4, 4, 3): every stage's final-normed hidden states within 2e-5 of JAX's
  ``gemma.forward`` on the same weights;
- the pipelined loss against JAX's ``paligemma.loss_fn`` and the port's,
  and each stage's qkv gradients (``loss.backward()`` through the reverse
  schedule) against ``jax.grad`` of the loss;
- ``python -m paligemma_tpu_torch.parallel.dryrun 4``'s function ends in its
  summary line;
- a rank that raises fails the spawn with that rank's traceback.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch.multiprocessing import ProcessRaisedException

import torch_parallel_workers as W
from paligemma_tpu.config import tiny_config
from paligemma_tpu.models import gemma as jgemma
from paligemma_tpu.models import paligemma as jpg
from paligemma_tpu_torch.parallel.dryrun import dryrun_multichip
from paligemma_tpu_torch.parallel.mesh import spawn

CASES = [(2, 2, 2), (4, 4, 3)]


def _cfg(n_layers):
    cfg = tiny_config()
    return dataclasses.replace(cfg, text_config=dataclasses.replace(cfg.text_config, num_hidden_layers=n_layers))


def _loss_inputs(cfg):
    b, n_img = 4, cfg.vision_config.num_image_tokens
    ids = jnp.concatenate([jnp.full((b, n_img), cfg.image_token_index, jnp.int32),
                           jax.random.randint(jax.random.PRNGKey(1), (b, 4), 2, 250)], axis=1)
    size = cfg.vision_config.image_size
    pix = jax.random.normal(jax.random.PRNGKey(2), (b, 3, size, size))
    return np.asarray(ids, np.int32), np.asarray(pix, np.float32), np.asarray(ids, np.int32)


@pytest.fixture(scope="module")
def runs():
    """Each case's spawn, run once: (JAX params, embeds, loss inputs, rank
    results); the (2, 2, 2) case also runs the pipelined loss."""
    cache = {}

    def get(case):
        if case not in cache:
            stages, layers, micro = case
            cfg = _cfg(layers)
            params = jpg.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
            embeds = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (micro * 2, 5, cfg.text_config.hidden_size)))
            loss_inputs = _loss_inputs(cfg) if case == CASES[0] else None
            tree = jax.tree_util.tree_map(np.asarray, params)
            cache[case] = (params, embeds, loss_inputs,
                           spawn(W.pipeline_worker, stages, "gloo", "cpu", tree, layers, embeds, micro, loss_inputs,
                                 timeout_s=240))
        return cache[case]

    return get


@pytest.mark.parametrize("case", CASES, ids=[f"s{s}_l{l}_m{m}" for s, l, m in CASES])
def test_pipelined_forward_matches_single_device(runs, case):
    params, embeds, _, ranks = runs(case)
    tc = _cfg(case[1]).text_config
    b, t = embeds.shape[:2]
    positions = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32)[None, :], (b, t))
    ref, _ = jgemma.forward(params["llm"], tc, jnp.asarray(embeds), positions, cache=None, mask=None)
    assert sorted(r["stage"] for r in ranks) == list(range(case[0]))
    for r in ranks:  # every stage returns the hidden states
        np.testing.assert_allclose(r["hidden"], np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_pipelined_loss_matches_and_differentiates(runs):
    params, _, (ids, pix, labels), ranks = runs(CASES[0])
    cfg = _cfg(CASES[0][1])

    def f(p):
        return jpg.loss_fn(p, cfg, jnp.asarray(ids), jnp.asarray(pix), jnp.asarray(labels))

    ref = float(f(params))
    g_ref = np.asarray(jax.grad(f)(params)["llm"]["layers"]["qkv"])  # (L, in, out)
    seen = set()
    for r in ranks:
        np.testing.assert_allclose(r["loss"], ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["loss"], r["unsharded_loss"], rtol=1e-5, atol=1e-5)
        for li, g in r["qkv_grads"].items():  # the port's (out, in) weight
            np.testing.assert_allclose(g, g_ref[li].T, rtol=2e-4, atol=2e-5)
            seen.add(li)
    assert seen == set(range(CASES[0][1]))  # every layer's gradient, from its stage


def test_dryrun_on_four_ranks_ends_in_its_summary():
    line = dryrun_multichip(4)
    assert line.startswith("dryrun_multichip ok: mesh=(2x2) ")
    for arm in ("serving", "spec_serving", "kvquant_serving", "int8_serving", "w4a8_serving", "lmw4_serving"):
        assert f" {arm}(tp=4)_tokens_identical=True" in line


def test_spawn_fails_with_the_rank_traceback():
    with pytest.raises(ProcessRaisedException, match="rank 1 failed on purpose"):
        spawn(W.failing_worker, 2, "gloo", "cpu", timeout_s=60)

"""The port's parallel package (``paligemma_tpu_torch/parallel/``) against the
JAX package's sharded steps, on the CPU.

Each check spawns 2 or 4 ranks over gloo (``parallel.mesh.spawn``; the rank
functions are in ``torch_parallel_workers.py``, which imports no JAX). The
JAX side runs in this process on the 8 virtual CPU devices of
``tests/conftest.py``, with JAX's own sharded steps. Both hold the same
weights (``utils/convert.from_jax_params``) and inputs (the batch of
``tests/test_sharding.py``). One spawn a mesh shape serves every check of
that shape.

- The sharded prefill at (data, model) in (2, 1), (1, 2), (1, 4), (2, 2)
  ((1, 2) splits tiny's 2 kv heads, (1, 4) replicates them): each rank's
  logits and cache K against JAX's sharded prefill and the unsharded one
  at JAX's bar, 2e-4.
- The sharded decode at (2, 2); the sequence-parallel prefill, the int8
  weight-only and the a8 prefill at (1, 2).
- The sequence-parallel prefill at (1, 4), where tiny's 22 tokens do not
  split 4 ways: the logits against JAX's sequence-parallel prefill on the
  same mesh and the unsharded one at 2e-4, the cache K against the
  unsharded cache (nothing written past T). The a8 prefill under sequence
  parallelism at (1, 2) and (1, 4): within 2e-4 of the port's unsharded a8
  model and within the repo's 2% bar of JAX's sequence-parallel a8
  prefill; one row-parallel a8 product's rows bit for bit the whole
  product's.
- ``shard_params``: each rank's bytes are those the rules give, and its
  gate and up rows are its slices of each half.
- The DP x TP LoRA step at (2, 2) against JAX's step and the port's
  unsharded ``lora.train_step``: the loss within rtol 1e-4, the adapters
  within rtol 1e-3 / atol 1e-5; once more with padded rows of unequal valid
  label counts (the global-count rule).
- The TP continuous engine at model = 2: tokens equal to the unsharded
  engine's and to JAX's engine over a 2-device TP mesh, plain and spec_k 3.
- Single-process pieces: the sharding rules at the 3B geometry, and the
  collectives over a group of one process.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import torch_parallel_workers as W
from paligemma_tpu import continuous as jcont
from paligemma_tpu import generation as jgen
from paligemma_tpu import lora as jlora
from paligemma_tpu import runtime
from paligemma_tpu.models import paligemma as jpg
from paligemma_tpu.parallel import sharding as jshd
from paligemma_tpu.parallel import steps as jsteps
from paligemma_tpu.parallel.mesh import make_mesh as jmake_mesh
from paligemma_tpu.processing import ByteTokenizer as JByteTokenizer
from paligemma_tpu.processing import PaliGemmaProcessor as JProcessor
from paligemma_tpu.quantization import quantize_params as jquantize
import paligemma_tpu_torch
from paligemma_tpu_torch.parallel import comm, sharding
from paligemma_tpu_torch.parallel.mesh import Mesh, single_device_mesh, spawn
from paligemma_tpu_torch.utils.convert import lora_from_jax

BAR = dict(rtol=2e-4, atol=2e-4)
LOGIT_BAR = 0.02
MESHES = [(2, 1), (1, 2), (1, 4), (2, 2)]


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def inputs(cfg):
    """tests/test_sharding.py's batch: 8 rows of image tokens + 6 text ids."""
    n_img = cfg.vision_config.num_image_tokens
    b, t_text = 8, 6
    ids_text = jax.random.randint(jax.random.PRNGKey(1), (b, t_text), 2, 250)
    ids = jnp.concatenate([jnp.full((b, n_img), cfg.image_token_index, jnp.int32), ids_text], axis=1)
    size = cfg.vision_config.image_size
    pix = jax.random.normal(jax.random.PRNGKey(2), (b, 3, size, size))
    return np.asarray(ids, np.int32), np.asarray(pix, np.float32)


def _train_case(cfg, ids, pix, unequal: bool):
    batch = {"input_ids": ids, "pixel_values": pix, "labels": ids.copy(),
             "valid_len": np.full((ids.shape[0],), ids.shape[1], np.int32)}
    if unequal:  # right-padded rows; data rank 0's rows hold 15 valid labels, rank 1's 19
        n_img = cfg.vision_config.num_image_tokens
        valid = np.array([22, 18, 22, 17, 20, 22, 19, 22], np.int32)
        labels = batch["labels"]
        labels[:, :n_img] = cfg.ignore_index
        for r, v in enumerate(valid):
            labels[r, v:] = cfg.ignore_index
        batch["valid_len"] = valid
    lcfg = jlora.LoraConfig(r=2, alpha=4, dropout=0.0)
    adapter = jlora.init_lora(cfg, lcfg, jax.random.PRNGKey(3))
    return batch, lcfg, adapter


CHECKS = {
    (1, 2): {"sp": True, "int8": True, "a8": True, "a8_sp": True, "bytes": True},
    (1, 4): {"sp": True, "a8_sp": True, "bytes": True},
    (2, 2): {"decode": True, "train": False, "train_unequal": True},
}
TRAIN_LR = 1e-2


@pytest.fixture(scope="module")
def runs(cfg, params, inputs):
    """Each mesh shape's spawn, run once at first use: {(data, model): [rank
    results]}."""
    ids, pix = inputs
    tree = _tree(params)
    cache = {}

    def get(shape):
        if shape not in cache:
            checks = dict(CHECKS.get(shape, {}))
            for name in ("train", "train_unequal"):
                if name in checks:
                    batch, _, adapter = _train_case(cfg, ids, pix, checks[name])
                    checks[name] = {"batch": batch, "adapter": _tree(adapter), "lr": TRAIN_LR}
            cache[shape] = spawn(W.mesh_worker, shape[0] * shape[1], "gloo", "cpu", tree, ids, pix, *shape,
                                 checks, timeout_s=240)
        return cache[shape]

    return get


def _jax_prefill(cfg, params, ids, pix, shape, qparams=None, sequence_parallel=False):
    """JAX's sharded prefill (logits, cache K) on a (data, model) mesh."""
    data, model = shape
    p = params if qparams is None else qparams
    cache = jgen.make_cache(cfg, ids.shape[0], ids.shape[1], 4, jnp.float32)
    mesh = jmake_mesh(data=data, model=model, devices=jax.devices()[: data * model])
    sp = jax.device_put(p, jshd.param_shardings(cfg, mesh, params=qparams))
    sc = jax.device_put(cache, jshd.cache_shardings(mesh))
    run = jsteps.make_sharded_prefill(cfg, mesh, sequence_parallel=sequence_parallel, params=qparams)
    logits, new = run(sp, ids, pix, sc)
    return np.asarray(logits), np.asarray(new.k)


def _jax_a8_prefill(cfg, params, ids, pix, shape, sequence_parallel=False):
    """JAX's sharded int8 prefill with ``runtime.prefill_a8`` on (tiny's
    prompt is 22 tokens: ``a8_min_seq`` 8): the logits."""
    qp = jquantize(params, llm_only=True)
    jax.clear_caches()  # the a8 flag is trace-time state
    old_min = runtime.a8_min_seq
    runtime.set_prefill_a8(True)
    runtime.a8_min_seq = 8
    try:
        return _jax_prefill(cfg, params, ids, pix, shape, qparams=qp, sequence_parallel=sequence_parallel)[0]
    finally:
        runtime.set_prefill_a8(False)
        runtime.a8_min_seq = old_min
        jax.clear_caches()


def _rows(x, r, data):
    n = x.shape[0] // data
    return x[r["rank"][0] * n:(r["rank"][0] + 1) * n]


def _rank_k(k, r, data):
    first, count = r["kv"]
    n = k.shape[1] // data
    d = r["rank"][0]
    return k[:, d * n:(d + 1) * n, :, first:first + count]


@pytest.fixture(scope="module")
def unsharded(cfg, params, inputs):
    """JAX's unsharded prefill of the batch: (logits, cache K)."""
    ids, pix = inputs
    cache = jgen.make_cache(cfg, ids.shape[0], ids.shape[1], 4, jnp.float32)
    logits, cache = jpg.prefill(params, cfg, jnp.asarray(ids), jnp.asarray(pix), cache)
    return np.asarray(logits), np.asarray(cache.k)


@pytest.mark.parametrize("shape", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
def test_sharded_prefill_matches_jax(cfg, params, inputs, runs, unsharded, shape):
    ids, pix = inputs
    ref_logits, ref_k = _jax_prefill(cfg, params, ids, pix, shape)
    for r in runs(shape):
        for logits, k in ((ref_logits, ref_k), unsharded):
            np.testing.assert_allclose(r["logits"], _rows(logits, r, shape[0]), **BAR)
            np.testing.assert_allclose(r["k"], _rank_k(k, r, shape[0]), **BAR)
    if shape == (1, 4):  # tiny's 2 kv heads replicated: each rank keeps the one its q head reads
        assert [r["kv"] for r in runs(shape)] == [(0, 1), (0, 1), (1, 1), (1, 1)]
    if shape[1] == 2:
        assert [r["kv"] for r in runs(shape)][:2] == [(0, 1), (1, 1)]


def test_sharded_decode_matches_jax(cfg, params, inputs, runs):
    ids, pix = inputs
    cache = jgen.make_cache(cfg, ids.shape[0], ids.shape[1], 4, jnp.float32)
    logits, cache1 = jpg.prefill(params, cfg, jnp.asarray(ids), jnp.asarray(pix), cache)
    tok = jnp.argmax(logits[:, -1, :], -1).astype(jnp.int32)[:, None]
    ref, _ = jpg.decode_step(params, cfg, tok, cache1)
    mesh = jmake_mesh(data=2, model=2, devices=jax.devices()[:4])
    sp = jax.device_put(params, jshd.param_shardings(cfg, mesh))
    sc = jax.device_put(cache1, jshd.cache_shardings(mesh))
    got_j, _ = jsteps.make_sharded_decode(cfg, mesh)(sp, tok, sc)
    for r in runs((2, 2)):
        np.testing.assert_array_equal(r["decode_tok"], _rows(np.asarray(tok), r, 2))
        np.testing.assert_allclose(r["decode"], _rows(np.asarray(got_j), r, 2), **BAR)
        np.testing.assert_allclose(r["decode"], _rows(np.asarray(ref), r, 2), **BAR)
    a, b = (r["decode"] for r in runs((2, 2))[:2])  # one model group: the same logits
    np.testing.assert_array_equal(a, b)


def test_sequence_parallel_prefill_matches(runs, unsharded):
    for r in runs((1, 2)):
        np.testing.assert_allclose(r["sp"], unsharded[0], **BAR)
        np.testing.assert_allclose(r["sp"], r["logits"], **BAR)


def test_sequence_parallel_prefill_at_an_uneven_length_matches_jax(cfg, params, inputs, runs, unsharded):
    """T = 22 over 4 ranks (padded to 24): the logits within 2e-4 of JAX's
    sequence-parallel prefill on a (1, 4) mesh and of the unsharded one;
    the cache K within 2e-4 of the unsharded cache's up to T and zero past
    it (the padding rows are never written)."""
    ids, pix = inputs
    t = ids.shape[1]
    assert t % 4
    ref_logits, ref_k = _jax_prefill(cfg, params, ids, pix, (1, 4), sequence_parallel=True)
    for r in runs((1, 4)):
        np.testing.assert_allclose(r["sp"], ref_logits, **BAR)
        np.testing.assert_allclose(r["sp"], unsharded[0], **BAR)
        np.testing.assert_allclose(r["sp_k"][:, :, :t], _rank_k(ref_k, r, 1)[:, :, :t], **BAR)
        np.testing.assert_allclose(r["sp_k"][:, :, :t], _rank_k(unsharded[1], r, 1)[:, :, :t], **BAR)
        np.testing.assert_allclose(r["sp_k"], r["k"], **BAR)
        assert not r["sp_k"][:, :, t:].any()


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=["1x2", "1x4"])
def test_sequence_parallel_a8_prefill_matches_jax(cfg, params, inputs, runs, shape):
    """``prefill_a8`` under sequence parallelism: the rank's logits within
    2e-4 of the port's unsharded a8 model, and within the repo's bar between
    the packages' bf16 trunks (2% of the largest logit, as
    ``test_sharded_quantized_prefill_matches_jax``) of JAX's
    sequence-parallel a8 prefill on the same mesh; layer 0's down product
    under sequence parallelism (int32 sums reduce-scattered along T) bit
    for bit the whole a8 product's rows of this rank."""
    ids, pix = inputs
    ref = _jax_a8_prefill(cfg, params, ids, pix, shape, sequence_parallel=True)
    for r in runs(shape):
        np.testing.assert_allclose(r["a8_sp"], r["a8_sp_whole"], **BAR)
        np.testing.assert_allclose(r["a8_sp"], ref, rtol=0, atol=LOGIT_BAR * float(np.abs(ref).max()))
        got, want = r["a8_sp_rows"]
        assert got.shape == want.shape == (2, -(-ids.shape[1] // shape[1]), got.shape[-1])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arm", ["int8", "a8"])
def test_sharded_quantized_prefill_matches_jax(cfg, params, inputs, runs, arm):
    """The quantized trunk is bf16 (the int8 embedding's lookup): the rank's
    logits within JAX's 2e-4 of the port's unsharded quantized model, and
    within the repo's bar between the packages' bf16 trunks (2% of the
    largest logit, ``test_torch_quant_modes.py``) of JAX's sharded ones."""
    ids, pix = inputs
    qp = jquantize(params, llm_only=True)
    jax.clear_caches()  # the a8 flag is trace-time state
    old_min = runtime.a8_min_seq
    runtime.set_prefill_a8(arm == "a8")
    runtime.a8_min_seq = 8
    try:
        ref, _ = _jax_prefill(cfg, params, ids, pix, (1, 2), qparams=qp)
    finally:
        runtime.set_prefill_a8(False)
        runtime.a8_min_seq = old_min
        jax.clear_caches()
    for r in runs((1, 2)):
        np.testing.assert_allclose(r[arm], r[arm + "_whole"], **BAR)
        np.testing.assert_allclose(r[arm], ref, rtol=0, atol=LOGIT_BAR * float(np.abs(ref).max()))


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=["1x2", "1x4"])
def test_shard_params_bytes_and_gate_up_halves(cfg, runs, shape):
    model = shape[1]
    i = cfg.text_config.intermediate_size
    for r in runs(shape):
        assert r["bytes"] == r["want_bytes"] < r["full_bytes"]
        assert r["bytes_int8"] == r["want_bytes_int8"] and r["bytes_w4a8"] == r["want_bytes_w4a8"]
        m, full = r["rank"][1], r["gate_up_full"]
        n = i // model
        want = np.concatenate([full[m * n:(m + 1) * n], full[i + m * n:i + (m + 1) * n]])
        np.testing.assert_array_equal(r["gate_up"], want)


def _rank_mesh(shape, r):
    g = comm.Group(None, [0])
    return Mesh(shape[0], shape[1], r["rank"][0] * shape[1] + r["rank"][1], torch.device("cpu"), g, g)


@pytest.mark.parametrize("case", ["train", "train_unequal"])
def test_sharded_train_step_matches_jax_and_unsharded(cfg, params, inputs, runs, case):
    ids, pix = inputs
    batch, lcfg, adapter = _train_case(cfg, ids, pix, case == "train_unequal")
    opt = jlora.default_optimizer(lr=TRAIN_LR, accum_steps=1)
    mesh = jmake_mesh(data=2, model=2, devices=jax.devices()[:4])
    sp = jax.device_put(params, jshd.param_shardings(cfg, mesh))
    sad = jax.device_put(adapter, jshd.lora_shardings(cfg, mesh))
    step = jsteps.make_sharded_train_step(cfg, lcfg, opt, mesh)
    loss, new_ad, _ = step(sp, sad, opt.init(sad), {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(0))
    want_ad = lora_from_jax(_tree(new_ad), device="cpu")
    for r in runs((2, 2)):
        got = r[case]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-4)
        np.testing.assert_allclose(got["loss"], got["unsharded_loss"], rtol=1e-4)
        want = sharding.shard_lora(want_ad, paligemma_tpu_torch.tiny_config(), _rank_mesh((2, 2), r))
        for name in ("q", "k", "v"):
            for x in ("a", "b"):
                g = got["adapter"]["layers"][name][x]
                np.testing.assert_allclose(g, want["layers"][name][x].numpy(), rtol=1e-3, atol=1e-5)
                np.testing.assert_allclose(g, got["unsharded_adapter"]["layers"][name][x], rtol=1e-3, atol=1e-5)
    if case == "train_unequal":  # the data ranks' own means would differ from the global one
        labels = batch["labels"][:, 1:]
        counts = [(labels[:4] != cfg.ignore_index).sum(), (labels[4:] != cfg.ignore_index).sum()]
        assert counts[0] != counts[1]


PROMPTS = ["a", "tell me more", "mid", "the longest prompt of them all"]


@pytest.fixture(scope="module")
def engine_setup():
    """tests/test_torch_continuous.py's setup: tiny fp32, the final norm
    redrawn so that greedy streams change token."""
    from paligemma_tpu.config import tiny_config as j_tiny_config

    cfg0 = j_tiny_config()
    tok = JByteTokenizer()
    pj = JProcessor(tok, cfg0.vision_config.num_image_tokens, cfg0.vision_config.image_size)
    cfg_j = dataclasses.replace(cfg0, image_token_index=pj.image_token_id,
                                vocab_size=max(cfg0.vocab_size, tok.vocab_size + 1200))
    p = jpg.init_params(cfg_j, jax.random.PRNGKey(0), jnp.float32)
    norm = p["llm"]["final_norm"]
    p["llm"]["final_norm"] = jnp.asarray(np.random.RandomState(3).randn(*norm.shape) * 2, jnp.float32)
    rng = np.random.RandomState(7)
    images = [Image.fromarray(rng.randint(0, 255, (20, 28, 3), np.uint8)) for _ in range(4)]
    return p, cfg_j, pj, images


ENGINE_KW = dict(n_slots=2, max_new_tokens=9, chunk=3)
BUDGETS = [5, 9, 3, 7]
VARIANTS = {"plain": {}, "spec3": {"spec_k": 3}}


@pytest.fixture(scope="module")
def engine_runs(engine_setup):
    p, cfg_j, _, images = engine_setup
    subs = list(zip(PROMPTS, images, BUDGETS))
    return spawn(W.engine_worker, 2, "gloo", "cpu", _tree(p), {"vocab_size": cfg_j.vocab_size}, subs,
                 ENGINE_KW, VARIANTS, timeout_s=240)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_tp_continuous_engine_matches_unsharded_and_jax(engine_setup, engine_runs, variant):
    p, cfg_j, pj, images = engine_setup
    mesh = jmake_mesh(data=1, model=2, devices=jax.devices()[:2])
    sp = jax.device_put(p, jshd.param_shardings(cfg_j, mesh))
    eng = jcont.ContinuousBatcher(sp, cfg_j, pj, cache_dtype=jnp.float32, prefetch=False, **ENGINE_KW,
                                  **VARIANTS[variant])
    reqs = [eng.submit(pr, im, max_new_tokens=m) for pr, im, m in zip(PROMPTS, images, BUDGETS)]
    eng.run()
    want = [r.tokens for r in reqs]
    for r in engine_runs:
        assert r["attn_tp"]
        assert r[variant]["tp"] == r[variant]["unsharded"] == want
    assert len({len(x) for x in want}) > 1 and any(len(set(x)) > 1 for x in want)


def test_sharding_rules_at_3b():
    """The rules at PaliGemma-3B-224 over 2 ranks: 4 query heads a rank
    sharing the one kv head (replicated), the vocab split 128576 a rank,
    SigLIP's 16 heads 8 a rank; the rank's config carries its counts."""
    cfg = paligemma_tpu_torch.paligemma_3b_pt_224()
    for rank in (0, 1):
        p = sharding.plan(cfg, 2, rank)
        assert (p.attn, p.kv_split, p.kv_local, p.kv_first) == (True, False, 1, 0)
        assert p.mlp and p.vocab and p.vis_attn and p.vis_mlp
        tc = sharding.rank_config(cfg, p).text_config
        assert (tc.num_attention_heads, tc.num_key_value_heads, tc.intermediate_size) == (4, 1, 8192)
    assert cfg.text_config.vocab_size // 2 == 128576
    odd = dataclasses.replace(cfg, text_config=dataclasses.replace(cfg.text_config, num_attention_heads=6,
                                                                   num_key_value_heads=3))
    assert not sharding.plan(odd, 2, 0).attn  # kv heads would straddle the ranks: whole


def test_collectives_over_a_one_process_group():
    """A mesh without a process group: every collective is the identity, and
    the Functions pass gradients through unchanged."""
    mesh = single_device_mesh("cpu")
    g = mesh.model_group
    x = torch.randn(2, 4, 3, requires_grad=True)
    y = comm.copy_to_model(x, g) * 2
    y = comm.reduce_from_model(y, g)
    y = comm.gather_from_model(y, g, -1)
    y = comm.scatter_seq(comm.gather_seq(y, g), g)
    y.sum().backward()
    torch.testing.assert_close(x.grad, torch.full_like(x, 2.0))
    assert comm.capturable(torch.nn.Linear(2, 2)) and g.backend == "none"


def test_sharded_model_without_a_process_group_runs_as_the_whole(cfg, params, inputs):
    """``shard_params`` over a 1 x 1 mesh without a process group: the same
    logits as the unsharded port model, bit for bit (its collectives are
    copies)."""
    from paligemma_tpu_torch.models import gemma
    from paligemma_tpu_torch.models import paligemma as tpg
    from paligemma_tpu_torch.utils.convert import from_jax_params

    ids, pix = (torch.tensor(a) for a in inputs)
    tcfg = paligemma_tpu_torch.tiny_config()
    full = from_jax_params(_tree(params), tcfg, device="cpu")
    one = sharding.shard_params(full, tcfg, single_device_mesh("cpu"))
    outs = []
    for m in (full, one):
        cache = gemma.init_cache(m.cfg.text_config, ids.shape[0], ids.shape[1] + 2, torch.float32, "cpu")
        outs.append(tpg.prefill(m, ids, pix, cache)[0])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)

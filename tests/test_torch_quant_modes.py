"""The int4 weight-only mode, the int8 KV cache and the int8 x int8 prefill
projections of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs go through both packages. The JAX side runs its Pallas
kernels in interpret mode (its own CPU route) and its jitted functions; the
port runs the plain versions of its kernels. The port packs int4 in its own
layout, so the tests compare unpacked values and scales, never bytes. Each
test states its tolerance where it sets it.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paligemma_tpu import generation as jgen
from paligemma_tpu import quantization as jquant
from paligemma_tpu import runtime
from paligemma_tpu.config import tiny_config as j_tiny_config
from paligemma_tpu.models import gemma as jgemma
from paligemma_tpu.models import paligemma as jpg
from paligemma_tpu.ops import pallas_quant as jpq
import paligemma_tpu_torch
from paligemma_tpu_torch import generation as tgen
from paligemma_tpu_torch import quantization as tquant
from paligemma_tpu_torch.models import gemma as tgemma
from paligemma_tpu_torch.models import paligemma as tpg
from paligemma_tpu_torch.ops import cuda_attention as ca
from paligemma_tpu_torch.ops import kernels, quant
from paligemma_tpu_torch.utils.convert import from_jax_params

BF16_RTOL = 2.0**-7  # two bf16 ulps: the fp32 sums differ in order, then round once
LOGIT_BAR = 0.02  # of the largest logit: the PR 2 bar for the quantized tiny models


def _t(x):
    """numpy (or JAX) array -> torch tensor, bf16 kept as bf16."""
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# int4 weight-only
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("o", [40, 1024])  # one whole-width block; two 512-column blocks
def test_quantize_tensor_int4_matches_jax_values(o):
    rng = np.random.RandomState(10)
    w = rng.randn(2, 48, o).astype(np.float32)  # stacked (L, in, out) kernels
    w[1, :, 3] = 0.0  # an all-zero channel takes the 1e-8 floor
    jt = jquant.quantize_tensor_int4(jnp.asarray(w), axis=1)
    vals = np.asarray(jpq.unpack_int4(jt.packed))  # (L, in, out)
    for l in range(2):
        tw = tquant.quantize_tensor_int4(torch.from_numpy(w[l].T.copy()))
        assert isinstance(tw, tquant.Q4Linear) and tw.packed.dtype == torch.uint8
        assert tuple(tw.packed.shape) == (o, 24)
        np.testing.assert_array_equal(quant.unpack_int4(tw.packed).numpy(), vals[l].T)
        np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jt.scale[l, 0]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,d,o", [
    (1, 4096, 1024),  # two d-blocks and two 512-column out-blocks of the TPU kernel
    (13, 96, 200),    # a ragged O: one whole-width block
    (100, 64, 1024),
])
def test_q4_matmul_plain_matches_jax(m, d, o, dtype):
    rng = np.random.RandomState(11)
    q = rng.randint(-7, 8, (d, o)).astype(np.int8)
    s = ((rng.rand(1, o) + 0.5) * 0.01).astype(np.float32)
    x = jnp.asarray(rng.randn(1, m, d) * 3, dtype)
    ref = jpq.q4_matmul(x, jpq.pack_int4(jnp.asarray(q)), jnp.asarray(s))
    packed = quant.pack_int4(torch.from_numpy(q.T.copy()))
    got = quant.q4_matmul(_t(x), packed, torch.from_numpy(s[0]))
    assert got.dtype == _t(x).dtype and tuple(got.shape) == (1, m, o)
    # fp32: the same exact products summed in another order (1e-5 of outputs
    # ~1); bf16: one rounding of those sums, so up to two bf16 ulps apart.
    rtol, atol = (1e-5, 1e-5) if dtype == "float32" else (BF16_RTOL, 1e-3)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=rtol, atol=atol)
    got32 = quant.q4_matmul(_t(x), packed, torch.from_numpy(s[0]), out_dtype=torch.float32)
    assert got32.dtype == torch.float32


def test_int4_proj_routing_and_layout():
    """int4 mode: every decoder projection is a Q4Linear that takes ``q4``
    at any row count; the lm_head stays ``q8`` with fp32 out."""
    model = tpg.init_params(
        paligemma_tpu_torch.tiny_config(), 0, device="cpu")
    q4 = tquant.quantize_params(model, mode="int4")
    layer = q4.llm.layers[0]
    assert all(isinstance(getattr(layer, n), tquant.Q4Linear) for n in ("qkv", "o", "gate_up", "down"))
    assert isinstance(q4.llm.embed, tquant.QLinear) and q4.llm.embed_w4 is None
    assert tquant.params_bytes(q4.llm.layers) < tquant.params_bytes(model.llm.layers) / 6
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    fns = kernels.PLAIN._replace(q8=spy("q8", quant.q8_matmul_plain), q4=spy("q4", quant.q4_matmul_plain))
    d = q4.cfg.text_config.hidden_size
    for rows in (1, 100):
        calls.clear()
        layer.mlp(torch.randn(1, rows, d, dtype=torch.bfloat16), fns)
        assert calls == ["q4", "q4"]
    calls.clear()
    assert tgemma.logits(q4.llm, torch.randn(1, 1, d, dtype=torch.bfloat16), fns).dtype == torch.float32
    assert calls == ["q8"]


# ---------------------------------------------------------------------------
# int8 KV cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_rows_bit_identical_to_jitted_jax(dtype):
    rng = np.random.RandomState(12)
    x = (rng.randn(3, 7, 2, 256) * rng.rand(3, 7, 2, 1) * 5).astype(np.float32)
    x[0, 0, 0] = 0.0  # the 1e-8 floor
    x[0, 1, 0, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -126.5]  # exact ties near xs = 1
    xj = jnp.asarray(x, dtype)
    qj, sj = jax.jit(jgemma.quantize_kv_rows)(xj)
    qt, st = tgemma.quantize_kv_rows(_t(xj))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))


def test_init_cache_int8_and_dequantized_decode_read():
    cfg = paligemma_tpu_torch.tiny_config().text_config
    cache = tgemma.init_cache(cfg, 2, 9, torch.int8, device="cpu")
    assert isinstance(cache, tgemma.QuantKVCache) and isinstance(cache, tgemma.KVCache)
    assert cache.k.dtype == torch.int8 and tuple(cache.k_scale.shape) == (2, 2, 9, 2)
    assert cache.v_scale.dtype == torch.float32 and cache.max_len == 9 and cache.length == 0
    # The plain decode over an int8 cache is the plain decode over the
    # cache dequantized as the reference reads it (bit for bit).
    rng = np.random.RandomState(13)
    q = torch.from_numpy(rng.randn(2, 1, 4, 8).astype(np.float32)).to(torch.bfloat16)
    kv = torch.from_numpy(rng.randn(2, 2, 9, 2, 8).astype(np.float32))
    (kq, ks), (vq, vs) = tgemma.quantize_kv_rows(kv[0]), tgemma.quantize_kv_rows(kv[1])
    valid = torch.tensor([9, 4], dtype=torch.int32)
    got = ca.decode_attention(q, kq, vq, valid, k_scale=ks, v_scale=vs)
    k_bf = kq.to(torch.bfloat16) * ks.to(torch.bfloat16)[..., None]
    v_bf = vq.to(torch.bfloat16) * vs.to(torch.bfloat16)[..., None]
    assert torch.equal(got, ca.decode_attention_plain(q, k_bf, v_bf, valid))


# ---------------------------------------------------------------------------
# int8 x int8 projections (qproj_a8)
# ---------------------------------------------------------------------------


def _a8_case(dtype, t=40, seed=14):
    rng = np.random.RandomState(seed)
    w = rng.randn(256, 96).astype(np.float32)
    qt = jquant.quantize_tensor(jnp.asarray(w), axis=0)  # (in, out) int8, (1, out) scales
    x = jnp.asarray(rng.randn(2, t, 256) * 3, dtype)
    tq = tquant.QLinear(_t(qt.q).t().contiguous(), _t(qt.scale)[0], prefill_a8=True)
    return qt, x, tq


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qproj_a8_matches_jitted_jax(dtype):
    qt, x, tq = _a8_case(dtype)
    ref = jax.jit(jquant.qproj_a8)(x, qt)
    xt = _t(x)
    # The activation quantization is jitted JAX's to the bit (its quant is
    # quantize_kv_rows' math without the clip, which never binds) ...
    xq, xs = quant.quantize_rows_s8_rcp(xt)
    xq_j, xs_j = jax.jit(jgemma.quantize_kv_rows)(x)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(xq_j))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(xs_j))
    # ... the int32 accumulators are exact ...
    acc = (xq.double() @ tq.weight.double().t()).to(torch.int32)
    exact = np.einsum("btd,de->bte", xq.numpy().astype(np.int64), np.asarray(qt.q).astype(np.int64))
    np.testing.assert_array_equal(acc.numpy(), exact)
    # ... and the output is (acc * xs) * s rounded to x.dtype: within one
    # fp32 ulp of JAX's rescale (so within one bf16 ulp in bf16).
    got = tquant.qproj_a8(xt, tq)
    assert got.dtype == xt.dtype
    if dtype == "float32":
        np.testing.assert_array_max_ulp(_np(got), _np(ref), maxulp=1)
    else:
        np.testing.assert_allclose(_np(got), _np(ref), rtol=2.0**-8, atol=0)


def test_qproj_a8_routing_is_static_on_length(monkeypatch):
    """With the flag on, calls of T >= A8_MIN_SEQ take the a8 product and
    shorter ones keep the exact weight-only result; with it off nothing
    changes (the reference's test of the same name)."""
    qt, x, tq = _a8_case("float32")
    x_long, x_short = _t(x), _t(x)[:, :8]
    plain = tquant.QLinear(tq.weight, tq.scale)
    assert tquant.A8_MIN_SEQ == 32 and not plain.prefill_a8
    base_long, base_short = tquant.qproj(x_long, plain), tquant.qproj(x_short, plain)
    assert torch.equal(tquant.qproj(x_long, tq), tquant.qproj_a8(x_long, tq))
    assert torch.equal(tquant.qproj(x_short, tq), base_short)
    assert not torch.equal(tquant.qproj(x_long, tq), base_long)
    assert torch.equal(base_short, quant.q8_matmul_plain(x_short, tq.weight, tq.scale))
    monkeypatch.setattr(tquant, "A8_MIN_SEQ", 8)
    assert torch.equal(tquant.qproj(x_short, tq), tquant.qproj_a8(x_short, tq))


def test_a8_wrapper_refuses_what_int_mm_does_not_take():
    x = torch.empty(1, 40, 64, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        quant.a8_matmul(x, torch.empty(16, 64, dtype=torch.int8, device="meta"), torch.empty(16, device="meta"))
    assert quant.a8_matmul.calls == 0
    x = torch.zeros(1, 40, 64, dtype=torch.bfloat16)
    q, s = torch.ones(16, 64, dtype=torch.int8), torch.ones(16)
    assert torch.equal(quant.a8_matmul(x, q, s), quant.a8_matmul_plain(x, q, s))
    assert kernels.KERNELS.a8 is quant.a8_matmul and kernels.PLAIN.a8 is quant.a8_matmul_plain
    assert kernels.KERNELS.q4 is quant.q4_matmul and kernels.PLAIN.q4 is quant.q4_matmul_plain


def test_quantize_params_prefill_a8_marks_every_qproj_weight():
    model = tpg.init_params(
        paligemma_tpu_torch.tiny_config(), 0, device="cpu")
    w4 = tquant.quantize_params(model, mode="w4a8", prefill_a8=True, llm_only=False)
    layer = w4.llm.layers[0]
    assert layer.qkv.prefill_a8 and layer.o.prefill_a8 and layer.gate_up_i8.prefill_a8
    assert w4.vision.layers[0].fc1.prefill_a8 and w4.projector.prefill_a8
    assert not w4.llm.embed.prefill_a8  # the lm_head never takes the a8 product
    q8 = tquant.quantize_params(model, mode="int8")
    assert not q8.llm.layers[0].qkv.prefill_a8


# ---------------------------------------------------------------------------
# Tiny models against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def base():
    """(jax cfg, fp32 JAX params, fp32 port model) on the same weights."""
    cfg = j_tiny_config()
    params = jpg.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                            paligemma_tpu_torch.tiny_config(), device="cpu")
    return cfg, params, model


def _ids(cfg, n_text, seed):
    rng = np.random.RandomState(seed)
    n_img = cfg.vision_config.num_image_tokens
    ids = np.concatenate([np.full((1, n_img), cfg.image_token_index, np.int32),
                          rng.randint(2, 250, (1, n_text)).astype(np.int32)], axis=1)
    size = cfg.vision_config.image_size
    return ids, rng.randn(1, 3, size, size).astype(np.float32)


@contextlib.contextmanager
def _jax_flags(prefill_a8):
    """The JAX side with its Pallas attention and, with ``prefill_a8``, the
    a8 projections from 8 positions on (the tiny prompts are 22-76 tokens);
    flags are read at trace time, so the jit caches are cleared around them."""
    prev = runtime.use_pallas_attention, runtime.prefill_a8, runtime.a8_min_seq
    runtime.set_pallas_attention(True)
    runtime.set_prefill_a8(prefill_a8)
    runtime.a8_min_seq = 8
    jax.clear_caches()
    try:
        yield
    finally:
        runtime.set_pallas_attention(prev[0])
        runtime.set_prefill_a8(prev[1])
        runtime.a8_min_seq = prev[2]
        jax.clear_caches()


MODEL_ARMS = [  # mode (None: the fp32 model), llm_only, int8 cache, prefill_a8, text tokens
    ("int4", True, False, False, 6),
    ("int4", True, False, False, 60),   # 76 prompt rows
    (None, True, True, False, 6),       # fp32 model, int8 cache
    ("int8", True, True, False, 6),
    ("int8", False, False, True, 6),    # a8 in SigLIP, the projector and the decoder
    ("w4a8", True, False, True, 60),    # a8 in qkv/o and the int8 companions
]


@pytest.mark.parametrize("mode,llm_only,kv_int8,prefill_a8,n_text", MODEL_ARMS)
def test_quant_mode_model_matches_jax(base, monkeypatch, mode, llm_only, kv_int8, prefill_a8, n_text):
    """Prefill and five decode steps of the JAX package (jitted, greedy as
    its ``generate`` is) against the port's on the same weights; then the
    port's ``generate`` must give the JAX tokens."""
    cfg, params, model = base
    ids, pix = _ids(cfg, n_text, seed=15)
    n_new = 6
    jq, tq = params, model
    if mode is not None:
        jq = jquant.quantize_params(params, llm_only=llm_only, mode=mode)
        tq = tquant.quantize_params(model, llm_only=llm_only, mode=mode, prefill_a8=prefill_a8)
    monkeypatch.setattr(tquant, "A8_MIN_SEQ", 8)
    act = jnp.float32 if mode is None else jnp.bfloat16
    with _jax_flags(prefill_a8):
        prefill = jax.jit(jpg.prefill, static_argnums=1)
        step = jax.jit(jpg.decode_step, static_argnums=1)
        cache = jgen.make_cache(cfg, 1, ids.shape[1], n_new, jnp.int8 if kv_int8 else act)
        lg, cache = prefill(jq, cfg, jnp.asarray(ids), jnp.asarray(pix), cache)
        prefill_cache = cache
        logits_j, toks_j = [np.asarray(lg)], [int(jnp.argmax(lg[0, -1]))]
        for _ in range(n_new - 1):
            lg, cache = step(jq, cfg, jnp.asarray([[toks_j[-1]]], jnp.int32), cache)
            logits_j.append(np.asarray(lg))
            toks_j.append(int(jnp.argmax(lg[0, -1])))

    cache_dtype = torch.int8 if kv_int8 else None
    cache = tgen.make_cache(tq, 1, ids.shape[1], n_new, cache_dtype)
    assert isinstance(cache, tgemma.QuantKVCache) == kv_int8
    lg_t, cache = tpg.prefill(tq, torch.from_numpy(ids), torch.from_numpy(pix), cache)
    if kv_int8:
        t = ids.shape[1]
        # The port's int8 cache holds exactly the quantized rows of the K/V
        # its prefill writes into a cache in the activation dtype ...
        plain = tgen.make_cache(tq, 1, ids.shape[1], n_new)
        tpg.prefill(tq, torch.from_numpy(ids), torch.from_numpy(pix), plain)
        for c, c_scale, rows in ((cache.k, cache.k_scale, plain.k), (cache.v, cache.v_scale, plain.v)):
            want_q, want_s = tgemma.quantize_kv_rows(rows[:, :, :t])
            assert torch.equal(c[:, :, :t], want_q) and torch.equal(c_scale[:, :, :t], want_s)
        # ... and JAX's holds its own K/V's, which agree with the port's to
        # ~1e-6 (fp32) or, in bf16 trunks that round at other places, to
        # ~1% after two layers (the source of the 2% logit bar): the scales
        # to that, the int8 values to one step (fp32) or two (bf16).
        steps, rtol = (1, 1e-5) if mode is None else (2, LOGIT_BAR)
        for got, ref in ((cache.k, prefill_cache.k), (cache.v, prefill_cache.v)):
            diff = np.abs(got[:, :, :t].numpy().astype(np.int32) - np.asarray(ref[:, :, :t], np.int32))
            assert diff.max() <= steps
        for got, ref in ((cache.k_scale, prefill_cache.k_scale), (cache.v_scale, prefill_cache.v_scale)):
            np.testing.assert_allclose(got[:, :, :t].numpy(), np.asarray(ref[:, :, :t]), rtol=rtol)
    logits_t = [lg_t]
    for tok in toks_j[:-1]:
        d, cache = tpg.decode_step(tq, torch.tensor([[tok]], dtype=torch.int32), cache)
        logits_t.append(d)
    # fp32 model: the int8 cache's values, one step apart in a few places,
    # move the logits by far less than 0.1% of the largest; quantized
    # models: bf16 trunks that round at slightly different places, 2% of
    # the largest logit, the bar chip_smoke holds the card to.
    bar = 1e-3 if mode is None else LOGIT_BAR
    for got, ref in zip(logits_t, logits_j):
        assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
        np.testing.assert_allclose(_np(got), ref, rtol=0, atol=bar * float(np.abs(ref).max()))
    toks_t, final = tgen.generate(tq, torch.from_numpy(ids), torch.from_numpy(pix), n_new, -1,
                                  cache_dtype=cache_dtype)
    assert isinstance(final, tgemma.QuantKVCache) == kv_int8
    assert toks_t == toks_j

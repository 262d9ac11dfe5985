"""int8 and w4a8 serving modes of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs go through both packages. The JAX side runs its Pallas
quant kernels in interpret mode (its own CPU route) and the port runs the
plain versions of its kernels. The port packs int4 in its own layout, so the
tests compare unpacked values and scales, never bytes. Each test states its
tolerance where it sets it.
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
from paligemma_tpu_torch.ops import kernels, quant
from paligemma_tpu_torch.utils.convert import from_jax_params

BF16_RTOL = 2.0**-7  # two bf16 ulps: the fp32 sums differ in order, then round once


def _t(x):
    """numpy (or JAX) array -> torch tensor, bf16 kept as bf16."""
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# Quantizers: exact values and scales
# ---------------------------------------------------------------------------


def test_quantize_tensor_matches_jax_exactly():
    rng = np.random.RandomState(0)
    w = rng.randn(2, 48, 40).astype(np.float32)  # stacked (L, in, out) kernels
    w[1, :, 3] = 0.0  # an all-zero channel takes the 1e-8 floor
    jq = jquant.quantize_tensor(jnp.asarray(w), axis=1)
    for l in range(2):
        tq = tquant.quantize_tensor(torch.from_numpy(w[l].T.copy()))
        np.testing.assert_array_equal(tq.weight.numpy(), np.asarray(jq.q[l]).T)
        np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale[l, 0]))
    emb = rng.randn(300, 32).astype(np.float32)  # per-row (V, D) embedding
    je = jquant.quantize_tensor(jnp.asarray(emb), axis=1)
    te = tquant.quantize_tensor(torch.from_numpy(emb))
    np.testing.assert_array_equal(te.weight.numpy(), np.asarray(je.q))
    np.testing.assert_array_equal(te.scale.numpy(), np.asarray(je.scale[:, 0]))
    np.testing.assert_array_equal(
        tquant.dequantize(te).numpy(), np.asarray(jquant.dequantize(je)))


def test_pack_int4_roundtrip_and_layout():
    q = torch.from_numpy(np.random.RandomState(1).randint(-8, 8, (3, 5, 64)).astype(np.int8))
    packed = quant.pack_int4(q)
    assert packed.dtype == torch.uint8 and tuple(packed.shape) == (3, 5, 32)
    assert torch.equal(quant.unpack_int4(packed), q)
    # byte 4i + k holds column 8i + k (low nibble) and 8i + 4 + k (high nibble)
    b = int(packed[0, 0, 5])
    lo, hi = ((b & 15) ^ 8) - 8, ((b >> 4) ^ 8) - 8
    assert (lo, hi) == (int(q[0, 0, 9]), int(q[0, 0, 13]))
    with pytest.raises(ValueError, match="multiple of 8"):
        quant.pack_int4(q[..., :12])


def test_quantize_w4a8_and_embed_w4_match_jax_values():
    rng = np.random.RandomState(2)
    w = rng.randn(2, 64, 2048).astype(np.float32)  # two 1024-column tiles per layer
    jt = jquant.quantize_tensor_w4a8_tiled(jnp.asarray(w), axis=1)
    vals = np.asarray(jpq.unpack_int4_mxu_tiled(jt.packed))  # (L, in, out)
    for l in range(2):
        tw = tquant.quantize_tensor_w4a8(torch.from_numpy(w[l].T.copy()))
        np.testing.assert_array_equal(quant.unpack_int4(tw.packed).numpy(), vals[l].T)
        np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jt.scale[l, 0]))
        assert tuple(tw.packed.shape) == (2048, 32) and tw.packed.dtype == torch.uint8
    emb = rng.randn(1000, 256).astype(np.float32)  # vocab padded to 1024 on the JAX side
    je = jquant.quantize_embed_w4(jnp.asarray(emb))
    te = tquant.quantize_embed_w4(torch.from_numpy(emb))
    jvals = np.asarray(jpq.unpack_int4_mxu_tiled(je.packed))  # (D, Vp)
    np.testing.assert_array_equal(quant.unpack_int4(te.packed).numpy(), jvals[:, :1000].T)
    np.testing.assert_array_equal(te.scale.numpy(), np.asarray(je.scale[0, :1000]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_s8_bit_identical_to_jax(dtype):
    rng = np.random.RandomState(3)
    x = rng.randn(6, 96).astype(np.float32) * 3
    # amax 127 gives xs = 1 exactly, so these rows hold exact .5 ties.
    x[0, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -3.5]
    x[1, :] = 0.0  # the 1e-8 floor
    xj = jnp.asarray(x, dtype)
    xq_j, xs_j, _ = jpq.quantize_rows_s8(xj)
    xq_t, xs_t = quant.quant_rows(_t(xj))
    np.testing.assert_array_equal(xq_t.numpy(), np.asarray(xq_j))
    np.testing.assert_array_equal(xs_t.numpy(), np.asarray(xs_j)[:, 0])
    assert xq_t[0, :8].tolist() == [127, 0, 2, 2, 0, -2, 126, -4]


# ---------------------------------------------------------------------------
# Matmuls: the port's plain versions against the JAX kernels (interpret)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 13, 100])
def test_q8_matmul_plain_matches_jax(m, dtype):
    rng = np.random.RandomState(4)
    d, o = 4096, 1024  # two d-blocks and two out-blocks of the TPU kernel
    w = rng.randn(d, o).astype(np.float32) * d**-0.5
    qt = jquant.quantize_tensor(jnp.asarray(w), axis=0)
    x = jnp.asarray(rng.randn(1, m, d), dtype)
    ref_kernel = jpq.q8_matmul(x, qt.q, qt.scale)
    ref_qproj = jquant.qproj(x, qt)
    got = quant.q8_matmul(_t(x), _t(qt.q).t().contiguous(), _t(qt.scale)[0])
    assert got.dtype == _t(x).dtype and tuple(got.shape) == (1, m, o)
    # fp32: the same products summed in another order (1e-5 of outputs ~1);
    # bf16: one rounding of those sums, so up to two bf16 ulps apart.
    rtol, atol = (1e-5, 1e-5) if dtype == "float32" else (BF16_RTOL, 1e-3)
    for ref in (ref_kernel, ref_qproj):
        np.testing.assert_allclose(_np(got), _np(ref), rtol=rtol, atol=atol)


def _w4_case(rng, d, o):
    q = rng.randint(-7, 8, (d, o)).astype(np.int8)
    s = ((rng.rand(1, o) + 0.5) * 0.01).astype(np.float32)
    return q, s, quant.pack_int4(torch.from_numpy(q.T.copy())), torch.from_numpy(s[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 5, 13])
def test_q4a8_matmul_plain_matches_jax(m, dtype):
    rng = np.random.RandomState(5)
    d, o = 256, 512
    q, s, packed, scale = _w4_case(rng, d, o)
    x = jnp.asarray(rng.randn(1, m, d), dtype)
    # Multi-block TPU geometry: nb_o = 2, nb_d = 2 (tiled), two 256-column
    # blocks (flat).
    tiled = jpq.pack_int4_mxu_tiled(jnp.asarray(q), block_o=256, block_d=128)
    assert tiled.shape == (2, 2, 128, 128)
    refs = [
        jpq.q4a8_matmul_tiled(x, tiled, jnp.asarray(s)),
        jpq.q4a8_matmul(x, jpq.pack_int4_mxu(jnp.asarray(q), 256), jnp.asarray(s), block_o=256),
    ]
    got = quant.q4a8_matmul(_t(x), packed, scale)
    # The integer sums are exact on both sides; the JAX kernel's hi-nibble
    # 16x / (s/16) factoring is exact in binary, so they agree to the ulp
    # (the bar of tests/test_quantization.py:310 for its own oracle).
    for ref in refs:
        np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-6, atol=1e-5)
    got32 = quant.q4a8_matmul(_t(x), packed, scale, out_dtype=torch.float32)
    ref32 = jpq.q4a8_matmul_tiled(x, tiled, jnp.asarray(s), out_dtype=jnp.float32)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(_np(got32), _np(ref32), rtol=1e-6, atol=1e-5)


def _mlp_case(m, seed=6):
    rng = np.random.RandomState(seed)
    d, inter = 256, 512
    qg, sg, gu_p, gu_s = _w4_case(rng, d, 2 * inter)
    qd, sd, dn_p, dn_s = _w4_case(rng, inter, d)
    x = jnp.asarray(rng.randn(1, m, d), jnp.bfloat16)
    return d, inter, (qg, sg, qd, sd), (gu_p, gu_s, dn_p, dn_s), x


@pytest.mark.parametrize("m", [1, 5])
def test_mlp_w4a8_plain_matches_jax_unfused_pair(m):
    d, inter, (qg, sg, qd, sd), tw, x = _mlp_case(m)
    gu = jpq.pack_int4_mxu_tiled(jnp.asarray(qg), block_o=256, block_d=128)
    dn = jpq.pack_int4_mxu_tiled(jnp.asarray(qd), block_o=128, block_d=128)
    h = jpq.q4a8_matmul_tiled(x, gu, jnp.asarray(sg))
    act = jax.nn.gelu(h[..., :inter].astype(jnp.float32), approximate=True).astype(x.dtype)
    ref = jpq.q4a8_matmul_tiled(act * h[..., inter:], dn, jnp.asarray(sd))
    got = quant.mlp_w4a8(_t(x), *tw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (1, m, d)
    # The same ops in the same order; only the fp32 tanh-GELU is another
    # library's, which can move a bf16 rounding of the gated activation by
    # one ulp and a requantized value by one step: one bf16 ulp of the output.
    np.testing.assert_allclose(_np(got), _np(ref), rtol=2.0**-8, atol=1e-6)


@pytest.mark.parametrize("m", [1, 5])
def test_mlp_w4a8_plain_close_to_jax_fused_kernels(m):
    d, inter, (qg, sg, qd, sd), tw, x = _mlp_case(m, seed=7)
    gu = jpq.pack_int4_mxu_tiled(jnp.asarray(qg), block_o=256, block_d=128)
    dn = jpq.pack_int4_mxu_tiled(jnp.asarray(qd), block_o=128, block_d=128)
    fused = jpq.mlp_w4a8(x, jpq.Q4A8TiledTensor(gu, jnp.asarray(sg)),
                         jpq.Q4A8TiledTensor(dn, jnp.asarray(sd)), inter)
    stacked = jpq.mlp_w4a8_stacked(
        x, gu[None], jpq.regroup_scales_stacked(jnp.asarray(sg)[None], 4, 128),
        dn[None], jpq.regroup_scales_stacked(jnp.asarray(sd)[None], 2, 64), jnp.int32(0), inter)
    got = _np(quant.mlp_w4a8(_t(x), *tw))
    # The interpreter skips the bf16 rounding of the gated activation that
    # the hardware order (and the port) applies: JAX's own 0.05 bar.
    for ref in (fused, stacked):
        np.testing.assert_allclose(got, _np(ref), rtol=0.05, atol=0.05)


@pytest.mark.parametrize("m", [1, 2, 5])
def test_w4a8_geglu_plain_matches_jax_gate_and_quantize(m):
    """``w4a8_geglu_plain`` (the plain version of the gate_up kernel with the
    GeGLU epilogue), quantized as the down GEMV's prologue quantizes it,
    against the JAX kernel's gate_up product (interpret mode) followed by
    the ``_gate_and_quantize`` arithmetic of ``pallas_quant.py:631-638``."""
    d, inter, (qg, sg, _, _), (gu_p, gu_s, _, _), x = _mlp_case(m, seed=8)
    gu = jpq.q4a8_matmul_tiled(x, jpq.pack_int4_mxu_tiled(jnp.asarray(qg), block_o=256, block_d=128),
                               jnp.asarray(sg))[0]

    def gate_and_quantize(gu):
        gate, up = gu[:, :inter], gu[:, inter:]
        act = jax.nn.gelu(gate.astype(jnp.float32), approximate=True)
        h = (act.astype(gu.dtype) * up).astype(jnp.float32)
        hs = jnp.maximum(jnp.max(jnp.abs(h), axis=-1, keepdims=True), 1e-8) / 127.0
        return jnp.round(h / hs).astype(jnp.int8), hs[:, 0]

    h = quant.w4a8_geglu_plain(_t(x), gu_p, gu_s)
    assert h.dtype == torch.bfloat16 and tuple(h.shape) == (1, m, inter)
    hq, hs = quant.quantize_rows_s8(h[0])
    # Op by op, JAX divides as the port does (IEEE): the same scales to the
    # bit. The fp32 tanh-GELU is another library's, which can move an h by
    # one bf16 ulp and its int8 value by one step.
    jq, js = gate_and_quantize(gu)
    np.testing.assert_array_equal(hs.numpy(), np.asarray(js))
    assert np.abs(hq.numpy().astype(np.int32) - np.asarray(jq, np.int32)).max() <= 1
    # Jitted, XLA on the CPU keeps the gated activation in fp32 (it skips
    # its bf16 rounding, as the interpreter does in the fused kernels' test
    # above) and turns the division by 127 into a product with its fp32
    # reciprocal (ROADMAP Queue 3): each h moves by at most a bf16 ulp, so
    # the scales agree within one bf16 ulp and the values within one step.
    jq, js = jax.jit(gate_and_quantize)(gu)
    np.testing.assert_allclose(hs.numpy(), np.asarray(js), rtol=2.0**-8, atol=0)
    assert np.abs(hq.numpy().astype(np.int32) - np.asarray(jq, np.int32)).max() <= 1


def test_cpu_wrappers_take_the_plain_versions_and_count_no_launch():
    d, inter, _, tw, x = _mlp_case(3)
    xt = _t(x)
    quant.reset_launch_counts()
    assert torch.equal(quant.mlp_w4a8(xt, *tw), quant.mlp_w4a8_plain(xt, *tw))
    assert torch.equal(quant.q4a8_matmul(xt, tw[0], tw[1]), quant.q4a8_matmul_plain(xt, tw[0], tw[1]))
    q = torch.ones(8, d, dtype=torch.int8)
    assert torch.equal(quant.q8_matmul(xt, q, torch.ones(8)), quant.q8_matmul_plain(xt, q, torch.ones(8)))
    assert all(v == 0 for v in kernels.launch_counts().values())
    assert kernels.KERNELS.q8 is quant.q8_matmul and kernels.PLAIN.mlp_w4a8 is quant.mlp_w4a8_plain


def test_non_cpu_activations_never_fall_back_to_the_plain_version():
    x = torch.empty(2, 64, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        quant.q8_matmul(x, torch.empty(8, 64, dtype=torch.int8, device="meta"),
                        torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        quant.quant_rows(x)
    assert all(v == 0 for v in quant.launch_counts().values())


# ---------------------------------------------------------------------------
# Model level, tiny config
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
def _jax_flags(lm_head_w4):
    """The JAX side with its Pallas attention and the arm's lm_head flag;
    flags are read at trace time, so the jit caches are cleared around them."""
    prev = runtime.use_pallas_attention, runtime.lm_head_w4
    runtime.set_pallas_attention(True)
    runtime.lm_head_w4 = lm_head_w4
    jax.clear_caches()
    try:
        yield
    finally:
        runtime.set_pallas_attention(prev[0])
        runtime.lm_head_w4 = prev[1]
        jax.clear_caches()


ARMS = [  # mode, llm_only, lm_head_w4, text tokens (16 image tokens before them)
    ("int8", True, False, 6),
    ("w4a8", True, False, 6),
    ("w4a8", True, True, 6),
    ("int8", False, False, 6),
    ("w4a8", True, True, 60),  # 76 prompt rows: the int8 companions' prefill
]


@pytest.mark.parametrize("mode,llm_only,lm_head_w4,n_text", ARMS)
def test_quantized_model_matches_jax(base, mode, llm_only, lm_head_w4, n_text):
    """Prefill and five decode steps of the JAX package (jitted, greedy as
    its ``generate`` is) against the port's on the same quantized weights;
    then the port's ``generate`` must give the JAX tokens."""
    cfg, params, model = base
    ids, pix = _ids(cfg, n_text, seed=8)
    n_new = 6
    jq = jquant.quantize_params(params, llm_only=llm_only, mode=mode)
    tq = tquant.quantize_params(model, llm_only=llm_only, mode=mode, lm_head_w4=lm_head_w4)
    with _jax_flags(lm_head_w4):
        prefill = jax.jit(jpg.prefill, static_argnums=1)
        step = jax.jit(jpg.decode_step, static_argnums=1)
        cache = jgen.make_cache(cfg, 1, ids.shape[1], n_new, jnp.bfloat16)
        lg, cache = prefill(jq, cfg, jnp.asarray(ids), jnp.asarray(pix), cache)
        logits_j, toks_j = [np.asarray(lg)], [int(jnp.argmax(lg[0, -1]))]
        for _ in range(n_new - 1):
            lg, cache = step(jq, cfg, jnp.asarray([[toks_j[-1]]], jnp.int32), cache)
            logits_j.append(np.asarray(lg))
            toks_j.append(int(jnp.argmax(lg[0, -1])))

    cache = tgen.make_cache(tq, 1, ids.shape[1], n_new)
    assert cache.k.dtype == torch.bfloat16  # the trunk is bf16 under an int8 embedding
    lg_t, cache = tpg.prefill(tq, torch.from_numpy(ids), torch.from_numpy(pix), cache)
    logits_t = [lg_t]
    for tok in toks_j[:-1]:
        d, cache = tpg.decode_step(tq, torch.tensor([[tok]], dtype=torch.int32), cache)
        logits_t.append(d)
    # Both trunks run in bf16 (the merge casts to the int8 embedding's bf16
    # lookup) and round at slightly different places (norms, RoPE, attention
    # order): 2% of the largest logit, the bar chip_smoke holds the card to.
    for got, ref in zip(logits_t, logits_j):
        assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
        np.testing.assert_allclose(_np(got), ref, rtol=0, atol=0.02 * float(np.abs(ref).max()))
    toks_t, _ = tgen.generate(tq, torch.from_numpy(ids), torch.from_numpy(pix), n_new, -1)
    assert toks_t == toks_j


def test_quantize_params_layout_and_sharing(base):
    _, _, model = base
    q8 = tquant.quantize_params(model, mode="int8")
    w4 = tquant.quantize_params(model, mode="w4a8", lm_head_w4=True)
    vis = tquant.quantize_params(model, llm_only=False)
    layer = w4.llm.layers[0]
    assert isinstance(q8.llm.layers[1].down, tquant.QLinear)
    assert isinstance(layer.gate_up, tquant.W4A8Linear) and isinstance(layer.qkv, tquant.QLinear)
    assert isinstance(layer.gate_up_i8, tquant.QLinear) and isinstance(layer.down_i8, tquant.QLinear)
    assert isinstance(w4.llm.embed_w4, tquant.W4A8Linear) and w4.llm.lm_head_w4
    assert q8.llm.embed_w4 is None and not q8.llm.lm_head_w4
    assert isinstance(vis.vision.layers[0].fc1, tquant.QLinear)
    assert isinstance(vis.projector, tquant.QLinear)
    assert vis.projector.bias.data_ptr() == model.projector.bias.data_ptr()
    assert isinstance(q8.vision.layers[0].fc1, torch.nn.Linear)
    # The input model is untouched and the unquantized tensors are shared.
    assert isinstance(model.llm.layers[0].qkv, torch.nn.Linear)
    assert q8.llm.final_norm.weight is model.llm.final_norm.weight
    assert tquant.params_bytes(q8.llm) < tquant.params_bytes(model.llm) / 2
    assert tgemma.activation_dtype(q8.llm) == torch.bfloat16
    assert tgemma.activation_dtype(model.llm) == torch.float32


def test_quantize_params_refuses_what_it_does_not_support(base):
    model = base[2]
    with pytest.raises(ValueError, match="fp8"):
        tquant.quantize_params(model, mode="fp8")
    with pytest.raises(ValueError, match="lm_head_w4"):
        tquant.quantize_params(model, mode="int8", lm_head_w4=True)


def test_mlp_and_lm_head_routing_follow_the_row_count(base):
    """w4a8: <= 64 rows take the fused MLP and the 4-bit lm_head, more rows
    the int8 companions and the int8 lm_head (the reference's rules)."""
    model = tquant.quantize_params(base[2], mode="w4a8", lm_head_w4=True)
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append((name, a[0].shape[0] * a[0].shape[1]))
            return fn(*a, **k)
        return wrapped

    fns = kernels.PLAIN._replace(
        q8=spy("q8", quant.q8_matmul_plain), q4a8=spy("q4a8", quant.q4a8_matmul_plain),
        mlp_w4a8=spy("mlp", quant.mlp_w4a8_plain))
    d = model.cfg.text_config.hidden_size
    layer = model.llm.layers[0]
    for rows, want in ((64, ["mlp"]), (65, ["q8", "q8"])):
        calls.clear()
        layer.mlp(torch.randn(1, rows, d, dtype=torch.bfloat16), fns)
        assert [c[0] for c in calls] == want
    for rows, want in ((64, "q4a8"), (65, "q8")):
        calls.clear()
        lg = tgemma.logits(model.llm, torch.randn(1, rows, d, dtype=torch.bfloat16), fns)
        assert [c[0] for c in calls] == [want] and lg.dtype == torch.float32
        assert lg.shape[-1] == model.cfg.text_config.vocab_size

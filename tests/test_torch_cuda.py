"""The port's CUDA kernels on the card (marker ``gpu``; skipped without one).

    python -m pytest -m gpu tests/test_torch_cuda.py

Each kernel is held to its plain version on the same inputs (two bf16 ulps,
see chip_smoke.py; the integer stages exactly), and a tiny model's kernel
path to its plain path, in bf16 and in the int8, int4 and w4a8 modes and
with the int8 KV cache; decode attention gives one output for one set of
visible rows at every cache length; the decode step replayed as a CUDA
graph must give the eager step's tokens and launch counts, greedy and
sampled, and the prefill's graph the eager prefill's bits; the decode
kernel's verify shape (T queries) gives each query row the bits of the
one-query kernel, and the speculative verify iteration replayed as a CUDA
graph the eager iteration's tokens and counts. Under autograd, flash goes
through ``FlashAttentionFn`` (the kernel's bits forward, the plain
version's gradient backward), every other wrapper refuses a grad-requiring
input, ``gemma.logits`` has a gradient, and a LoRA train step and a
``lora_rank`` engine run on the card; the compiled train step (CUDA graph
replays) gives the eager step's bits, captures once a shape and flavour,
resumes as an uninterrupted run and fails a step whose capture raises; the
compiled eval loss gives the eager loss's bits; a join prefill's row 0 at
group batch 32 parts from group batch 1 at no kernel of the port.
"""
import dataclasses
import math

import pytest
import torch

import paligemma_tpu_torch
from paligemma_tpu_torch import generation, quantization
from paligemma_tpu_torch.models import gemma, paligemma
from paligemma_tpu_torch.ops import cuda_attention as ca
from paligemma_tpu_torch.ops import kernels, quant
from paligemma_tpu_torch.ops.kernels import PLAIN
from paligemma_tpu_torch.ops.sampling import select_token_traced

pytestmark = pytest.mark.gpu
RTOL, ATOL = 2.0**-7, 2e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(gen, shape, dev):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


@pytest.mark.parametrize("b,t,h,hkv,d,valid", [
    (1, 256, 16, 16, 72, None),
    (1, 100, 8, 1, 256, [61]),
    (2, 77, 4, 2, 64, [77, 20]),
    # The tile edges: 32-row query blocks with warp pairs splitting 64-row
    # kv tiles (one batch row's grid is small), 64-row query blocks with
    # 32-row kv tiles (one batch row's grid fills the card).
    (1, 63, 16, 16, 72, None),
    (1, 64, 8, 1, 256, None),
    (1, 65, 8, 1, 256, [40]),
    (1, 129, 4, 2, 8, None),
    (4, 129, 16, 16, 72, [129, 64, 65, 1]),
    (9, 65, 8, 1, 256, None),
    (2, 129, 48, 48, 72, [129, 64]),
    (3, 65, 72, 9, 256, None),
])
def test_flash_kernel_matches_plain(cuda, b, t, h, hkv, d, valid):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = _rand(gen, (b, t, h, d), cuda), _rand(gen, (b, t, hkv, d), cuda), _rand(gen, (b, t, hkv, d), cuda)
    vl = None if valid is None else torch.tensor(valid, dtype=torch.int32, device=cuda)
    before = ca.launch_counts()["flash_attention"]
    out = ca.flash_attention(q, k, v, vl, gen_start=t - 5, gen_end=t - 2)
    torch.cuda.synchronize()
    assert ca.launch_counts()["flash_attention"] == before + 1
    torch.testing.assert_close(out, ca.flash_attention_plain(q, k, v, vl, gen_start=t - 5, gen_end=t - 2),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,t,h,hkv,d,valid", [
    (1, 300, 8, 1, 256, 70),    # kv tiles 2-4 of 64 rows wholly masked
    (4, 300, 8, 1, 256, 5),
    (4, 300, 32, 4, 256, 5),    # 64-row query blocks, 32-row kv tiles
    (1, 200, 4, 4, 72, 20),
])
def test_flash_kernel_ignores_masked_kv_tiles(cuda, b, t, h, hkv, d, valid):
    gen = torch.Generator(device=cuda).manual_seed(2)
    fused = _rand(gen, (b, t, (h + 2 * hkv) * d), cuda)  # q, k, v as views of one projection
    q, k, v = (x.view(b, t, -1, d) for x in fused.split([h * d, hkv * d, hkv * d], dim=-1))
    vl = torch.full((b,), valid, dtype=torch.int32, device=cuda)
    out = ca.flash_attention(q, k, v, vl)
    torch.testing.assert_close(out, ca.flash_attention_plain(q, k, v, vl), rtol=RTOL, atol=ATOL)
    k2, v2 = k.clone(), v.clone()
    k2[:, valid:], v2[:, valid:] = 1e4, 1e4
    assert torch.equal(ca.flash_attention(q, k2, v2, vl), out)


@pytest.mark.parametrize("b,s,h,hkv,d,valid", [
    (1, 1100, 8, 1, 256, [700]),
    (2, 300, 4, 2, 72, [300, 33]),
    (1, 1, 8, 1, 256, [1]),        # one position, a cluster of one block
    (1, 17, 8, 1, 64, [17]),
    (1, 308, 8, 1, 256, [292]),    # the main path's length
    (1, 4128, 8, 1, 256, [4100]),  # the 896-px preset's length
    (1, 4128, 8, 1, 256, [1]),     # one visible position
    # One past each cluster size the host picks (1, 2, 4, 8, 16 blocks).
    (1, 65, 8, 1, 256, [65]),
    (1, 129, 8, 1, 256, [129]),
    (1, 257, 8, 1, 256, [257]),
    (1, 513, 8, 1, 256, [513]),
    (1, 1100, 8, 1, 256, [40]),    # blocks with no visible position
    (2, 500, 4, 2, 64, [5, 300]),  # with the window below
])
def test_decode_kernel_matches_plain(cuda, b, s, h, hkv, d, valid):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = _rand(gen, (b, 1, h, d), cuda)
    kc, vc = _rand(gen, (2, b, s, hkv, d), cuda)[1], _rand(gen, (2, b, s, hkv, d), cuda)[1]
    vl = torch.tensor(valid, dtype=torch.int32, device=cuda)
    win = {"gen_start": 400, "gen_end": 420} if s == 500 else {}
    out = ca.decode_attention(q, kc, vc, vl, **win)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ca.decode_attention_plain(q, kc, vc, vl, **win), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("valid,lengths", [
    (292, (308, 320, 384, 512, 1100, 4128)),  # clusters of 8 and 16 blocks, one and more tiles a block
    (1000, (1024, 1100, 4128)),
])
def test_decode_does_not_depend_on_the_cache_length(cuda, kv_int8, valid, lengths):
    """One q and one set of visible K/V rows, poisoned past them, in caches
    of several lengths give one output, bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    q = _rand(gen, (1, 1, 8, 256), cuda)
    rows = [_rand(gen, (1, valid, 1, 256), cuda) for _ in range(2)]
    vl = torch.tensor([valid], dtype=torch.int32, device=cuda)
    outs = []
    for s_len in lengths:
        k, v = (torch.full((3, 1, s_len, 1, 256), 1e4, dtype=torch.bfloat16, device=cuda) for _ in range(2))
        k[1, :, :valid], v[1, :, :valid] = rows
        kw = {}
        if kv_int8:
            (k, ks), (v, vs) = gemma.quantize_kv_rows(k), gemma.quantize_kv_rows(v)
            kw = {"k_scale": ks[1], "v_scale": vs[1]}
        outs.append(ca.decode_attention(q, k[1], v[1], vl, **kw))  # a layer of a stacked cache
    torch.cuda.synchronize()
    assert all(torch.equal(out, outs[0]) for out in outs[1:])


def test_decode_refuses_a_cache_longer_than_its_shared_memory_holds(cuda):
    longest = ca.decode_max_len(8, 256)
    gen = torch.Generator(device=cuda).manual_seed(12)
    q = _rand(gen, (1, 1, 8, 256), cuda)
    k, v = _rand(gen, (1, 30000, 1, 256), cuda), _rand(gen, (1, 30000, 1, 256), cuda)
    vl = torch.tensor([longest - 5], dtype=torch.int32, device=cuda)
    before = ca.launch_counts()["decode_attention"]
    with pytest.raises(ValueError, match=f"longest it takes .* is {longest}"):
        ca.decode_attention(q, k, v, vl)
    assert ca.launch_counts()["decode_attention"] == before
    out = ca.decode_attention(q, k[:, :longest], v[:, :longest], vl)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ca.decode_attention_plain(q, k[:, :longest], v[:, :longest], vl),
                               rtol=RTOL, atol=ATOL)


def test_kernels_refuse_fp32(cuda):
    x = torch.zeros(1, 8, 2, 16, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        ca.flash_attention(x, x, x)


def test_tiny_model_kernel_path_matches_plain_path(cuda):
    cfg = paligemma_tpu_torch.tiny_config()
    # The kernels take head_dim in multiples of 8: widen tiny SigLIP's 6 to 8.
    cfg = dataclasses.replace(cfg, vision_config=dataclasses.replace(
        cfg.vision_config, hidden_size=32, intermediate_size=64))
    model = paligemma.init_params(cfg, 0, device=cuda, dtype=torch.bfloat16)
    n_img = cfg.vision_config.num_image_tokens
    ids = torch.cat([torch.full((1, n_img), cfg.image_token_index), torch.arange(2, 9)[None]], 1).to(cuda)
    pix = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(0)).to(cuda, torch.bfloat16)
    got, _ = generation.generate(model, ids, pix, 6, -1)
    want, _ = generation.generate(model, ids, pix, 6, -1, fns=PLAIN)
    assert got[0] == want[0]


# ---------------------------------------------------------------------------
# int8 and w4a8 kernels (ops/quant.py)
# ---------------------------------------------------------------------------


# The q8/q4 GEMV's edges: each count of n8 tiles of x rows, O with a ragged
# last 16-row tile, D with a ragged last chunk of K.
GEMV_EDGES = [(m, o, d) for m in (1, 2, 3, 8, 9, 33, 64) for o in (200, 201, 2560) for d in (2048, 16416)]


def _int8(gen, shape, dev, lo=-127, hi=128):
    return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32).to(torch.int8)


@pytest.mark.parametrize("m,o,d", [
    (1, 2560, 2048),    # decode qkv, GEMV tiling
    (3, 1000, 336),     # ragged O and D against the tiles
    (64, 2048, 2048),   # the largest GEMV call
    (9, 2048, 16384),   # GEMV in passes over D, rows 8 at a time
    (276, 2560, 2048),  # prefill, GEMM tiling
    (130, 200, 48),     # ragged GEMM edges
    (65, 2560, 2048),   # the first row count of the GEMM
    (276, 200, 2048),   # O not a multiple of the 128-column blocks
    (256, 4304, 1152),  # SigLIP fc1
    (97, 201, 64),      # odd O
    (276, 2048, 16400), # split K, D not a multiple of splits x 64
    *GEMV_EDGES,
])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_q8_matmul_kernel_matches_plain(cuda, m, o, d, out_dtype):
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = _rand(gen, (m, d), cuda)
    q, s = _int8(gen, (o, d), cuda), torch.rand(o, generator=gen, device=cuda) * 0.01 + 1e-3
    before = quant.q8_matmul.launches
    out = quant.q8_matmul(x, q, s, out_dtype)
    torch.cuda.synchronize()
    assert quant.q8_matmul.launches == before + 1 and out.dtype == out_dtype
    torch.testing.assert_close(out.float(), quant.q8_matmul_plain(x, q, s, out_dtype).float(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("geglu", [False, True])
@pytest.mark.parametrize("m,d", [(1, 2048), (5, 16384), (70, 200)])
def test_quant_rows_kernel_is_bit_identical_to_plain(cuda, m, d, geglu):
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = _rand(gen, (m, 2 * d if geglu else d), cuda)
    x[0, :4] = torch.tensor([127.0, 0.5, 1.5, -2.5], device=cuda)  # exact ties at xs = 1
    xq, xs = quant.quant_rows(x, geglu)
    torch.cuda.synchronize()
    pq, ps = quant.quant_rows_plain(x, geglu)
    assert torch.equal(xs, ps)
    # The GeGLU prologue's tanh may differ from PyTorch's by an fp32 ulp,
    # which can move one value across a rounding step.
    assert int((xq.int() - pq.int()).abs().max()) <= (1 if geglu else 0)


# The w4a8 GEMV's edges: each count of n8 tiles of x rows and one row on
# either side of it, O with a ragged last 16-row tile, D of one to 64 ring
# steps (and a ragged last one).
W4A8_EDGES = [(m, o, d) for m in (1, 2, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64)
              for o in (520, 1000) for d in (64, 96, 2048, 16384)]


@pytest.mark.parametrize("m,o,d", [
    (1, 32768, 2048), (1, 2048, 16384), (7, 1000, 96),
    (100, 520, 64),     # two groups of 64 rows over the grid
    (13, 2048, 16384),  # two n8 tiles of x rows, K split over the warps
    *W4A8_EDGES,
])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_w4a8_gemv_kernel_matches_plain(cuda, m, o, d, out_dtype):
    gen = torch.Generator(device=cuda).manual_seed(4)
    xq, xs = _int8(gen, (m, d), cuda), torch.rand(m, generator=gen, device=cuda) + 0.01
    packed = quant.pack_int4(_int8(gen, (o, d), cuda, -8, 8))
    s = torch.rand(o, generator=gen, device=cuda) * 0.01 + 1e-3
    out = quant.w4a8_gemv(xq, xs, packed, s, out_dtype)
    torch.cuda.synchronize()
    # Exact integer sums and the same fp32 epilogue: bit-identical.
    assert torch.equal(out, quant.w4a8_gemv_plain(xq, xs, packed, s, out_dtype))


@pytest.mark.parametrize("m,o,d", [
    (1, 257152, 2048),  # the 4-bit lm_head
    (1, 2560, 2048), (2, 2048, 16384), (3, 1000, 96), (5, 520, 64), (8, 2048, 16384),
])
@pytest.mark.parametrize("max_rows", [None, 8])  # the routing rule, and the prologue's limit
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_q4a8_matmul_quantizing_prologue_is_bit_identical(cuda, monkeypatch, m, o, d, max_rows, out_dtype):
    if max_rows is not None:
        monkeypatch.setattr(quant, "W4A8_PROLOGUE_MAX_ROWS", max_rows)
    gen = torch.Generator(device=cuda).manual_seed(10)
    wide = _rand(gen, (m, d + 64), cuda)  # rows with a stride
    x = wide[:, 32:32 + d]
    x[0, :4] = torch.tensor([127.0, 0.5, 1.5, -2.5], device=cuda)  # exact ties at xs = 1
    packed = quant.pack_int4(_int8(gen, (o, d), cuda, -7, 8))
    s = torch.rand(o, generator=gen, device=cuda) * 0.01 + 1e-3
    before = quant.launch_counts()
    out = quant.q4a8_matmul(x, packed, s, out_dtype)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in quant.launch_counts().items()}
    fused = m <= quant.W4A8_PROLOGUE_MAX_ROWS
    assert launched["w4a8_gemv"] == 1 and launched["quant_rows"] == (0 if fused else 1)
    # The prologue's scales and int8 values are quant_rows' (the same
    # arithmetic), and the sums exact: bit-identical.
    assert torch.equal(out, quant.q4a8_matmul_plain(x, packed, s, out_dtype))


@pytest.mark.parametrize("m,d,inter", [(1, 2048, 16384), (3, 96, 520), (8, 2048, 16384), (2, 64, 40)])
def test_w4a8_geglu_kernel_matches_plain(cuda, m, d, inter):
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = _rand(gen, (1, m, d), cuda)
    gu = quant.pack_int4(_int8(gen, (2 * inter, d), cuda, -7, 8))
    gs = (torch.rand(2 * inter, generator=gen, device=cuda) + 0.5) / (4.3 * 73 * d**0.5)
    before = quant.w4a8_geglu.launches
    h = quant.w4a8_geglu(x, gu, gs)
    torch.cuda.synchronize()
    assert quant.w4a8_geglu.launches == before + 1 and h.shape == (1, m, inter)
    ref = quant.w4a8_geglu_plain(x, gu, gs)
    # The gate and up sums are exact and rounded as the plain version's; the
    # fp32 tanh may differ from PyTorch's by an ulp, which can move an h by
    # one bf16 ulp and its int8 value by one step, never the row scale.
    hq, hs = quant.quantize_rows_s8(h)
    pq, ps = quant.quantize_rows_s8(ref)
    assert torch.equal(hs, ps)
    assert int((hq.int() - pq.int()).abs().max()) <= 1
    torch.testing.assert_close(h, ref, rtol=2.0**-7, atol=0.0)


@pytest.mark.parametrize("m", [1, 2, 3, 5, 13, 64])
def test_mlp_w4a8_kernels_match_plain(cuda, m):
    gen = torch.Generator(device=cuda).manual_seed(5)
    d, inter = 2048, 16384
    x = _rand(gen, (1, m, d), cuda)
    gu = quant.pack_int4(_int8(gen, (2 * inter, d), cuda, -7, 8))
    dn = quant.pack_int4(_int8(gen, (d, inter), cuda, -7, 8))
    gs = torch.rand(2 * inter, generator=gen, device=cuda) * 0.01 + 1e-3
    ds = torch.rand(d, generator=gen, device=cuda) * 0.01 + 1e-3
    before = quant.launch_counts()
    out = quant.mlp_w4a8(x, gu, gs, dn, ds)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in quant.launch_counts().items()}
    if m <= quant.W4A8_PROLOGUE_MAX_ROWS:
        # w4a8_geglu, then the down GEMV with the quantizing prologue.
        assert (launched["w4a8_geglu"], launched["w4a8_gemv"], launched["quant_rows"]) == (1, 1, 0)
    else:
        assert (launched["w4a8_geglu"], launched["w4a8_gemv"], launched["quant_rows"]) == (0, 2, 2)
    torch.testing.assert_close(out, quant.mlp_w4a8_plain(x, gu, gs, dn, ds), rtol=RTOL, atol=ATOL)
    # No state outlives a call: another input in between, then the first
    # input again gives the first output bit for bit.
    quant.mlp_w4a8(_rand(gen, (1, m, d), cuda) * 4, gu, gs, dn, ds)
    again = quant.mlp_w4a8(x, gu, gs, dn, ds)
    torch.cuda.synchronize()
    assert torch.equal(again, out)


@pytest.mark.parametrize("mode,lm_head_w4", [("int8", False), ("w4a8", False), ("w4a8", True), ("int4", False)])
def test_tiny_quantized_model_kernel_path_matches_plain_path(cuda, mode, lm_head_w4):
    cfg = paligemma_tpu_torch.tiny_config()
    # The kernels take head_dim in multiples of 8: widen tiny SigLIP's 6 to 8.
    cfg = dataclasses.replace(cfg, vision_config=dataclasses.replace(
        cfg.vision_config, hidden_size=32, intermediate_size=64))
    model = paligemma.init_params(cfg, 0, device=cuda, dtype=torch.bfloat16)
    model = quantization.quantize_params(model, llm_only=False, mode=mode, lm_head_w4=lm_head_w4)
    n_img = cfg.vision_config.num_image_tokens
    ids = torch.cat([torch.full((1, n_img), cfg.image_token_index), torch.arange(2, 9)[None]], 1).to(cuda)
    pix = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(0)).to(cuda, torch.bfloat16)
    before = quant.launch_counts()
    got, _ = generation.generate(model, ids, pix, 6, -1)
    launched = {k: v - before[k] for k, v in quant.launch_counts().items()}
    want, _ = generation.generate(model, ids, pix, 6, -1, fns=PLAIN)
    assert got[0] == want[0]
    assert launched["q8_matmul"] > 0
    if mode == "w4a8":
        # Six forwards of at most 64 rows. The prefill's MLPs (23 rows, above
        # the prologue's rows): two quant_rows and two w4a8_gemv launches
        # each. Each of the five decode steps' MLPs: w4a8_geglu and one
        # w4a8_gemv launch. The 4-bit lm_head row of each forward (its last
        # position): one w4a8_gemv launch.
        layers = cfg.text_config.num_hidden_layers
        assert ids.shape[1] > quant.W4A8_PROLOGUE_MAX_ROWS
        lm = 6 if lm_head_w4 else 0
        assert launched["quant_rows"] == 2 * layers
        assert launched["w4a8_gemv"] == 2 * layers + 5 * layers + lm
        assert launched["w4a8_geglu"] == 5 * layers
    if mode == "int4":
        # Six forwards, four int4 projections per layer in each.
        assert launched["q4_matmul"] == 4 * cfg.text_config.num_hidden_layers * 6


# ---------------------------------------------------------------------------
# int4 weight-only matmul, the int8 KV cache, the int8 x int8 projection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,o,d", [
    (1, 2560, 2048),    # decode qkv
    (1, 2048, 2048),    # decode o
    (1, 32768, 2048),   # decode gate_up
    (1, 2048, 16384),   # decode down
    (64, 2560, 2048),   # the largest GEMV call
    (276, 32768, 2048), # prefill gate_up, GEMM tiling
    (276, 2048, 16384), # prefill down
    (3, 1000, 352),     # ragged rows and widths
    (130, 200, 64),     # ragged GEMM edges
    (65, 2560, 2048),   # the first row count of the GEMM
    (276, 200, 2048),   # O not a multiple of the 128-column blocks
    (256, 4304, 1152),  # SigLIP fc1
    (97, 201, 64),      # odd O
    (276, 2048, 16416), # split K, D not a multiple of splits x 64
    *GEMV_EDGES,
])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_q4_matmul_kernel_matches_plain(cuda, m, o, d, out_dtype):
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = _rand(gen, (m, d), cuda)
    packed = quant.pack_int4(_int8(gen, (o, d), cuda, -7, 8))
    s = (torch.rand(o, generator=gen, device=cuda) + 0.5) / (4.3 * d**0.5)
    before = quant.q4_matmul.launches
    out = quant.q4_matmul(x, packed, s, out_dtype)
    torch.cuda.synchronize()
    assert quant.q4_matmul.launches == before + 1 and out.dtype == out_dtype
    torch.testing.assert_close(out.float(), quant.q4_matmul_plain(x, packed, s, out_dtype).float(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("s_len,valid", [(308, 292), (1100, 700), (4128, 4100), (1100, 40)])
def test_int8_kv_decode_is_the_dequantized_bf16_decode(cuda, s_len, valid):
    """The int8 read is bit for bit "dequantize the cache, then the bf16
    kernel", within the kernel bar of the plain version, and blind to a
    poisoned tail past the valid length."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = _rand(gen, (1, 1, 8, 256), cuda)
    kv = [gemma.quantize_kv_rows(_rand(gen, (3, 1, s_len, 1, 256), cuda)) for _ in range(2)]
    (kq, ks), (vq, vs) = [(c[1], c_scale[1]) for c, c_scale in kv]  # a layer of a stacked cache
    vl = torch.tensor([valid], dtype=torch.int32, device=cuda)
    out = ca.decode_attention(q, kq, vq, vl, k_scale=ks, v_scale=vs)
    deq = [ca.dequantize_cache(c, c_scale, torch.bfloat16) for c, c_scale in ((kq, ks), (vq, vs))]
    torch.cuda.synchronize()
    assert torch.equal(out, ca.decode_attention(q, *deq, vl))
    torch.testing.assert_close(out, ca.decode_attention_plain(q, kq, vq, vl, k_scale=ks, v_scale=vs),
                               rtol=RTOL, atol=ATOL)
    for c, c_scale in ((kq, ks), (vq, vs)):
        c[:, valid:], c_scale[:, valid:] = 127, 1e4
    poisoned = ca.decode_attention(q, kq, vq, vl, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert torch.equal(poisoned, out)


@pytest.mark.parametrize("m,o,d", [(276, 2560, 2048), (276, 2048, 16384), (256, 4304, 1152)])
def test_a8_matmul_on_the_card_is_its_exact_plain_version(cuda, m, o, d):
    gen = torch.Generator(device=cuda).manual_seed(8)
    x = _rand(gen, (1, m, d), cuda)
    q, s = _int8(gen, (o, d), cuda), torch.rand(o, generator=gen, device=cuda) * 0.01 + 1e-3
    out = quant.a8_matmul(x, q, s)
    torch.cuda.synchronize()
    assert torch.equal(out, quant.a8_matmul_plain(x, q, s))
    with pytest.raises(ValueError, match="more than 16 rows"):
        quant.a8_matmul(x[:, :16], q, s)


def test_tiny_int8_kv_model_kernel_path_matches_plain_path(cuda):
    cfg = paligemma_tpu_torch.tiny_config()
    cfg = dataclasses.replace(cfg, vision_config=dataclasses.replace(
        cfg.vision_config, hidden_size=32, intermediate_size=64))
    model = paligemma.init_params(cfg, 0, device=cuda, dtype=torch.bfloat16)
    n_img = cfg.vision_config.num_image_tokens
    ids = torch.cat([torch.full((1, n_img), cfg.image_token_index), torch.arange(2, 9)[None]], 1).to(cuda)
    pix = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(0)).to(cuda, torch.bfloat16)
    got, cache = generation.generate(model, ids, pix, 6, -1, cache_dtype=torch.int8)
    want, _ = generation.generate(model, ids, pix, 6, -1, fns=PLAIN, cache_dtype=torch.int8)
    assert isinstance(cache, gemma.QuantKVCache) and got[0] == want[0]


# ---------------------------------------------------------------------------
# The decode step as a CUDA graph (generation.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_int8", [False, True])
def test_decode_graph_gives_the_eager_tokens_and_launch_counts(cuda, kv_int8):
    cfg = paligemma_tpu_torch.tiny_config()
    cfg = dataclasses.replace(cfg, vision_config=dataclasses.replace(
        cfg.vision_config, hidden_size=32, intermediate_size=64))
    model = paligemma.init_params(cfg, 0, device=cuda, dtype=torch.bfloat16)
    n_img, layers = cfg.vision_config.num_image_tokens, cfg.text_config.num_hidden_layers
    ids = torch.cat([torch.full((1, n_img), cfg.image_token_index), torch.arange(2, 9)[None]], 1).to(cuda)
    pix = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(0)).to(cuda, torch.bfloat16)
    cache_dtype = torch.int8 if kv_int8 else None
    n = 7

    def prefilled():
        cache = generation.make_cache(model, 1, ids.shape[1], n + 1, cache_dtype)
        logits, cache = generation.prefill(model, ids, pix, cache)
        return logits[:, -1], cache

    def eager(temperature):  # the step issued launch by launch, no graph
        gen = torch.Generator(device=cuda).manual_seed(3)
        last, cache = prefilled()
        tok = select_token_traced(last, gen, True, 0.8 if temperature else 0.0, 0.9)[:, None]
        out = [int(tok)]
        for _ in range(n):
            lg, cache = paligemma.decode_step(model, tok, cache)
            tok = select_token_traced(lg[:, -1], gen, True, temperature, torch.full((1, 1), 0.9, device=cuda))
            tok = tok[:, None]
            out.append(int(tok))
        return out

    greedy = eager(torch.zeros(1, 1, device=cuda))
    last, cache = prefilled()
    assert generation.prepare_decode(model, cache) > 0.0 and generation.prepare_decode(model, cache) == 0.0
    before = kernels.launch_counts()
    toks, tok, cache = generation.decode_steps(model, last.argmax(-1).to(torch.int32)[:, None], cache, n)
    counts = {k: v - before[k] for k, v in kernels.launch_counts().items()}
    assert [greedy[0]] + toks[0].tolist() == greedy and int(tok) == greedy[-1]
    assert int(cache.length) == cache.host_length == ids.shape[1] + n
    assert counts == {**{k: 0 for k in counts}, "decode_attention": n * layers}
    got, _ = generation.generate(model, ids, pix, n + 1, -1, cache_dtype=cache_dtype)
    assert got == greedy

    sampled = eager(torch.full((1, 1), 0.8, device=cuda))
    kw = dict(do_sample=True, temperature=0.8, top_p=0.9, cache_dtype=cache_dtype)
    runs = [generation.generate(model, ids, pix, n + 1, -1, generator=torch.Generator(device=cuda).manual_seed(s),
                                **kw)[0] for s in (3, 3, 4)]
    assert runs[0] == runs[1] == sampled != runs[2]
    chunked = generation.generate_chunked(model, ids, pix, n + 1, -1, chunk=3,
                                          generator=torch.Generator(device=cuda).manual_seed(3), **kw)
    assert chunked == sampled


# ---------------------------------------------------------------------------
# The prefill as a CUDA graph (generation.py)
# ---------------------------------------------------------------------------


def _cache_tensors(cache):
    return {f.name: getattr(cache, f.name) for f in dataclasses.fields(cache)
            if isinstance(getattr(cache, f.name), torch.Tensor)}


@pytest.mark.parametrize("kv_int8", [False, True])
def test_prefill_graph_is_the_eager_prefill_bit_for_bit(cuda, kv_int8):
    """Two prompt lengths in one cache: the first call of a shape (the
    eager warm-up) and its replays give the eager prefill's logits, cache,
    length and valid length bit for bit, and its launches;
    ``prepare_prefill`` captures ahead and leaves the cache empty."""
    cfg = paligemma_tpu_torch.tiny_config()
    cfg = dataclasses.replace(cfg, vision_config=dataclasses.replace(
        cfg.vision_config, hidden_size=32, intermediate_size=64))
    model = paligemma.init_params(cfg, 0, device=cuda, dtype=torch.bfloat16)
    n_img = cfg.vision_config.num_image_tokens
    pix = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(0)).to(cuda, torch.bfloat16)
    prompts = [torch.cat([torch.full((1, n_img), cfg.image_token_index), torch.arange(2, 2 + n)[None]], 1).to(cuda)
               for n in (7, 4)]
    cache_dtype = torch.int8 if kv_int8 else None
    cache = generation.make_cache(model, 1, prompts[0].shape[1], 4, cache_dtype)
    for ids in prompts:
        eager_cache = generation.make_cache(model, 1, prompts[0].shape[1], 4, cache_dtype)
        before = kernels.call_counts()
        want, eager_cache = paligemma.prefill(model, ids, pix, eager_cache, full_logits=False)
        want_counts = {k: v - before[k] for k, v in kernels.call_counts().items()}
        for _ in range(3):  # the first call of the shape, then two replays
            cache = gemma.reset_cache(cache)
            before = kernels.call_counts()
            got, cache = generation.prefill(model, ids, pix, cache)
            torch.cuda.synchronize()
            assert {k: v - before[k] for k, v in kernels.call_counts().items()} == want_counts
            assert torch.equal(got, want) and cache.host_length == ids.shape[1]
            ref = _cache_tensors(eager_cache)
            assert all(torch.equal(x, ref[name]) for name, x in _cache_tensors(cache).items())
    runners = [r for key, r in cache.graphs.items() if key[0] == "prefill"]
    assert len(runners) == 2 and all(r.graph is not None for r in runners)

    fresh = generation.make_cache(model, 1, prompts[0].shape[1], 4, cache_dtype)
    assert generation.prepare_prefill(model, fresh, prompts[1].shape, pix.shape) > 0.0
    assert generation.prepare_prefill(model, fresh, prompts[1].shape, pix.shape) == 0.0
    assert fresh.host_length == 0 and not any(x.any() for x in _cache_tensors(fresh).values())
    got, fresh = generation.prefill(model, prompts[1], pix, fresh)
    assert torch.equal(got, want)
    assert all(torch.equal(x, ref[name]) for name, x in _cache_tensors(fresh).items())


# ---------------------------------------------------------------------------
# Batched serving, the no-cache pass and checkpoint loading on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("b,s,valid,window", [
    (4, 340, [276, 250, 263, 276], (276, 300)),  # batched decode: each row's prompt + the shared window
    (1, 308, [292], (292, 300)),
    (2, 4128, [40, 4000], (4050, 4100)),         # a cluster of 16 blocks
])
def test_decode_window_end_on_the_device_is_the_host_window(cuda, kv_int8, b, s, valid, window):
    """The window's end read on the device gives the host int's bits, also
    from a captured graph whose end moves between replays, and within the
    plain version's bar; rows past the end are never read."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    q = _rand(gen, (b, 1, 8, 256), cuda)
    k, v = _rand(gen, (2, b, s, 1, 256), cuda), _rand(gen, (2, b, s, 1, 256), cuda)
    kw = {}
    if kv_int8:
        (k, ks), (v, vs) = gemma.quantize_kv_rows(k), gemma.quantize_kv_rows(v)
        kw = {"k_scale": ks[1], "v_scale": vs[1]}
    k, v = k[1], v[1]  # a layer of a stacked cache
    vl = torch.tensor(valid, dtype=torch.int32, device=cuda)
    w0, w1 = window
    end = torch.tensor(w1, dtype=torch.int32, device=cuda)
    host = ca.decode_attention(q, k, v, vl, gen_start=w0, gen_end=w1, **kw)
    dev = ca.decode_attention(q, k, v, vl, gen_start=w0, gen_end=end, **kw)
    torch.cuda.synchronize()
    assert torch.equal(dev, host)
    torch.testing.assert_close(dev, ca.decode_attention_plain(q, k, v, vl, gen_start=w0, gen_end=end, **kw),
                               rtol=RTOL, atol=ATOL)
    poisoned = k.clone(), v.clone()
    for c in poisoned:
        c[:, w1:] = 100
    assert torch.equal(ca.decode_attention(q, *poisoned, vl, gen_start=w0, gen_end=end, **kw), host)

    graph = torch.cuda.CUDAGraph()
    ca.decode_attention(q, k, v, vl, gen_start=w0, gen_end=end, **kw)  # warm-up
    with torch.cuda.graph(graph):
        out = ca.decode_attention(q, k, v, vl, gen_start=w0, gen_end=end, **kw)
    for e in (w0 + 1, w1 - 3, w1):
        end.fill_(e)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, ca.decode_attention(q, k, v, vl, gen_start=w0, gen_end=e, **kw))


@pytest.mark.parametrize("t,h,hkv,d,valid", [
    (276, 8, 1, 256, [276, 250, 263, 200]),  # batched prefill of the 224-px prompts
    (512, 8, 1, 256, [276, 276, 300, 512]),  # the ablation's prompt bucket at 224 px
    (256, 16, 16, 72, None),                 # SigLIP at 224 px
    (129, 48, 48, 72, [129, 64, 100, 1]),    # 64-row query blocks at every batch size
])
def test_flash_row_is_bit_identical_at_every_batch_size(cuda, t, h, hkv, d, valid):
    """Each row of a batch-4 call gives the bits of the batch-1 call on that
    row: the tiling never depends on the batch."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    q, k, v = _rand(gen, (4, t, h, d), cuda), _rand(gen, (4, t, hkv, d), cuda), _rand(gen, (4, t, hkv, d), cuda)
    vl = None if valid is None else torch.tensor(valid, dtype=torch.int32, device=cuda)
    out = ca.flash_attention(q, k, v, vl)
    for i in range(4):
        one = ca.flash_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1], None if vl is None else vl[i:i + 1])
        torch.cuda.synchronize()
        assert torch.equal(out[i:i + 1], one)


def _tiny_served(cuda):
    """A tiny bf16 model whose SigLIP head_dim the kernels take, its byte
    processor, four images and four prompts of different lengths."""
    import numpy as np
    from PIL import Image

    from paligemma_tpu_torch.processing import ByteTokenizer, PaliGemmaProcessor, align_config

    cfg = paligemma_tpu_torch.tiny_config()
    cfg = dataclasses.replace(cfg, vision_config=dataclasses.replace(
        cfg.vision_config, hidden_size=32, intermediate_size=64))
    proc = PaliGemmaProcessor(ByteTokenizer(), cfg.vision_config.num_image_tokens, cfg.vision_config.image_size)
    cfg = align_config(cfg, proc)
    model = paligemma.init_params(cfg, 0, device=cuda, dtype=torch.bfloat16)
    with torch.no_grad():  # a final norm that makes greedy streams change token
        model.llm.final_norm.weight.normal_(0.0, 2.0, generator=torch.Generator(device=cuda).manual_seed(5))
    rng = np.random.RandomState(0)
    images = [Image.fromarray(rng.randint(0, 256, (40, 30 + 5 * i, 3), dtype=np.uint8)) for i in range(4)]
    images[3] = images[0]
    prompts = ["describe", "what is the total revenue?", "caption en", "describe"]  # the last repeats the first
    return model, proc, images, prompts


def test_batch_generate_on_the_card_gives_each_row_its_batch1_first_token(cuda):
    from paligemma_tpu_torch import serving

    model, proc, images, prompts = _tiny_served(cuda)
    layers = model.cfg.text_config.num_hidden_layers
    before = kernels.launch_counts()
    _, rows = serving.batch_generate(model, proc, prompts, images, max_new_tokens=9, eos_token_id=-1,
                                     return_tokens=True)
    counts = {k: v - before[k] for k, v in kernels.launch_counts().items()}
    # One prefill (the capture's warm-up step is not counted), then 16 replays.
    assert counts["decode_attention"] == 16 * layers
    _, plain_rows = serving.batch_generate(model, proc, prompts, images, max_new_tokens=9, eos_token_id=-1,
                                           return_tokens=True, fns=PLAIN)
    for i, (prompt, image) in enumerate(zip(prompts, images)):
        out = proc(text=[prompt], images=[image])
        ids = torch.from_numpy(out["input_ids"]).to(cuda)
        pix = torch.from_numpy(out["pixel_values"]).to(cuda, torch.bfloat16)
        one, _ = generation.generate(model, ids, pix, 9, -1, stop_at_eos=False)
        assert rows[i][0] == one[0] == plain_rows[i][0]
    assert rows[0] == rows[3]  # the repeated request


def test_forward_nocache_kernel_path_matches_plain_and_ignores_the_padding(cuda):
    model, proc, images, prompts = _tiny_served(cuda)
    out = proc(text=[prompts[1]], images=[images[1]])
    t0 = out["input_ids"].shape[1]
    buf = torch.zeros((1, t0 + 20), dtype=torch.int32, device=cuda)
    buf[:, :t0] = torch.from_numpy(out["input_ids"]).to(cuda)
    pix = torch.from_numpy(out["pixel_values"]).to(cuda, torch.bfloat16)
    valid = torch.tensor([t0], dtype=torch.int32, device=cuda)
    got = paligemma.forward_nocache(model, buf, pix, valid)[0, t0 - 1]
    want = paligemma.forward_nocache(model, buf, pix, valid, PLAIN)[0, t0 - 1]
    assert float((got - want).abs().max()) <= 0.02 * float(want.abs().max())
    buf[:, t0:] = 7  # other tokens in the padding: the valid positions do not see them
    assert torch.equal(paligemma.forward_nocache(model, buf, pix, valid)[0, t0 - 1], got)


@pytest.mark.parametrize("streaming", [False, True])
def test_checkpoint_loads_onto_the_card(cuda, tmp_path, streaming):
    from paligemma_tpu_torch.utils import checkpoint

    model, _, _, _ = _tiny_served(cuda)
    checkpoint.save_hf_checkpoint(model, str(tmp_path), max_shard_bytes=200_000)
    loaded, cfg = checkpoint.load_model(str(tmp_path), streaming=streaming)
    assert cfg == model.cfg
    want = model.state_dict()
    assert all(t.is_cuda and t.dtype == torch.bfloat16 and torch.equal(t, want[k])
               for k, t in loaded.state_dict().items())


# ---------------------------------------------------------------------------
# Speculative decoding: the decode kernel's verify shape, the verify
# iteration as a CUDA graph (generation.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("t", [2, 4, 8, 13, 16])
@pytest.mark.parametrize("s_len,valid", [(308, [300]), (1100, [700, 1090]), (4128, [4100])])
def test_verify_decode_rows_are_the_one_query_kernel(cuda, kv_int8, t, s_len, valid):
    """Query i of row b sees valid[b] + i positions: bit for bit the T = 1
    call at that length, within the bar of the plain version, blind to
    rows past the last query's positions."""
    gen = torch.Generator(device=cuda).manual_seed(t + s_len)
    b = len(valid)
    q = _rand(gen, (b, t, 8, 256), cuda)
    k, v = _rand(gen, (2, b, s_len, 1, 256), cuda), _rand(gen, (2, b, s_len, 1, 256), cuda)
    kw = {}
    if kv_int8:
        (k, ks), (v, vs) = gemma.quantize_kv_rows(k), gemma.quantize_kv_rows(v)
        kw = {"k_scale": ks[1], "v_scale": vs[1]}
    k, v = k[1], v[1]  # a layer of a stacked cache
    vl = torch.tensor(valid, dtype=torch.int32, device=cuda)
    before = ca.launch_counts()["decode_attention"]
    out = ca.decode_attention(q, k, v, vl, **kw)
    assert ca.launch_counts()["decode_attention"] == before + 1 and out.shape == q.shape
    for i in range(t):
        assert torch.equal(out[:, i:i + 1], ca.decode_attention(q[:, i:i + 1], k, v, vl + i, **kw))
    torch.testing.assert_close(out, ca.decode_attention_plain(q, k, v, vl, **kw), rtol=RTOL, atol=ATOL)
    for r, n_vis in enumerate(valid):
        k[r, n_vis + t - 1:], v[r, n_vis + t - 1:] = (127, 127) if kv_int8 else (1e4, 1e4)
        if kv_int8:
            kw["k_scale"][r, n_vis + t - 1:], kw["v_scale"][r, n_vis + t - 1:] = 1e4, 1e4
    assert torch.equal(ca.decode_attention(q, k, v, vl, **kw), out)


def test_verify_decode_refuses_17_queries(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    k = _rand(gen, (1, 308, 1, 256), cuda)
    vl = torch.tensor([290], dtype=torch.int32, device=cuda)
    before = ca.launch_counts()["decode_attention"]
    with pytest.raises(ValueError, match="queries"):
        ca.decode_attention(_rand(gen, (1, 17, 8, 256), cuda), k, k, vl)
    assert ca.launch_counts()["decode_attention"] == before


@pytest.mark.parametrize("drafter", ["ngram", "longest"])
@pytest.mark.parametrize("kv_int8", [False, True])
def test_spec_graph_gives_the_eager_iterations_and_launch_counts(cuda, kv_int8, drafter):
    """decode_steps_spec (replays of the captured verify iteration) against
    the iteration issued launch by launch on the same state: the same
    tokens, counts, buffers and cache length; each replay adds one
    iteration's launches."""
    cfg = paligemma_tpu_torch.tiny_config()
    cfg = dataclasses.replace(cfg, vision_config=dataclasses.replace(
        cfg.vision_config, hidden_size=32, intermediate_size=64))
    model = paligemma.init_params(cfg, 0, device=cuda, dtype=torch.bfloat16)
    with torch.no_grad():  # a final norm whose greedy streams change token
        model.llm.final_norm.weight.normal_(-1.0, 1.0, generator=torch.Generator(device=cuda).manual_seed(3))
    n_img, layers = cfg.vision_config.num_image_tokens, cfg.text_config.num_hidden_layers
    ids = torch.cat([torch.full((1, n_img), cfg.image_token_index),
                     torch.tensor([[5, 6, 7, 5, 6, 7, 5, 6]])], 1).to(cuda, torch.int32)
    pix = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(0)).to(cuda, torch.bfloat16)
    cache_dtype, k, n, t = (torch.int8 if kv_int8 else None), 4, 3, ids.shape[1]

    def prefilled():
        cache = generation.make_cache(model, 1, t, 40, cache_dtype)
        logits, cache = generation.prefill(model, ids, pix, cache)
        first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        ids_buf = torch.zeros((1, t + 40), dtype=torch.int32, device=cuda)
        ids_buf[:, :t], ids_buf[0, t] = ids, first[0, 0]
        return first, cache, ids_buf, torch.tensor(t + 1, dtype=torch.int32, device=cuda)

    first, cache, ids_buf, buf_len = prefilled()
    st = generation._SpecState(
        token=first.clone(), ids=torch.zeros((1, cache.max_len + k), dtype=torch.int32, device=cuda),
        buf_len=buf_len.clone(), out=torch.zeros((1, cache.max_len + k), dtype=torch.int32, device=cuda),
        produced=torch.zeros((), dtype=torch.int32, device=cuda), iters=torch.zeros((), dtype=torch.int32,
                                                                                        device=cuda),
        temperature=torch.zeros((1, 1), device=cuda), top_p=torch.zeros((1, 1), device=cuda))
    st.ids[:, :ids_buf.shape[1]] = ids_buf
    while int(st.produced) < 12:
        generation._verify_iteration(model, cache, st, kernels.KERNELS, k, n, drafter, False)
    want = (st.out[0, :int(st.produced)].tolist(), int(st.produced), int(st.iters), int(cache.length))

    first, cache, ids_buf, buf_len = prefilled()
    before = kernels.launch_counts()
    out, produced, iters, tok, cache, ids_out, bl = generation.decode_steps_spec(
        model, first, cache, ids_buf, buf_len, 12, k=k, n=n, drafter=drafter)
    counts = {x: v - before[x] for x, v in kernels.launch_counts().items()}
    p = int(produced)
    assert (out[0, :p].tolist(), p, int(iters), int(cache.length)) == want
    assert cache.host_length == int(cache.length) == t + p and int(bl) == t + 1 + p
    assert int(tok) == want[0][-1] and ids_out[0, t + 1:t + 1 + p].tolist() == want[0]
    assert counts == {**{x: 0 for x in counts}, "decode_attention": int(iters) * layers}
    # generate_spec: 16 tokens from the prefill's first (the rest may part
    # from generate's where bf16 projections of k rows and of one row round
    # a near tie apart; chip_smoke bounds that).
    got = generation.generate_spec(model, ids, pix, 16, -1, cache_dtype=cache_dtype, chunk=8, k=k,
                                   drafter=drafter)
    assert len(got) == 16 and got[0] == int(first)


# ---------------------------------------------------------------------------
# Continuous serving (paligemma_tpu_torch/continuous.py)
# ---------------------------------------------------------------------------


def _top_two_gap(model, ids, pix, prefix, cache_dtype=None):
    """(top-1 minus top-2 logit, 2% of the largest |logit|) of batch 1's
    eager step that chooses the token after ``prefix``."""
    cache = generation.make_cache(model, 1, ids.shape[1], len(prefix) + 1, cache_dtype)
    lg, cache = paligemma.prefill(model, ids, pix, cache, full_logits=False)
    for t in prefix:
        lg, cache = paligemma.decode_step(model, torch.tensor([[t]], dtype=torch.int32, device=ids.device), cache)
    last = lg[0, -1].float()
    top = last.topk(2).values
    return float(top[0] - top[1]), 0.02 * float(last.abs().max())


@pytest.mark.parametrize("spec", [0, 4])
@pytest.mark.parametrize("kv_int8", [False, True])
def test_slot_step_graph_is_the_eager_step_bit_for_bit(cuda, kv_int8, spec):
    """A chunk of replays of the captured slot step (plain, or the per-row
    verify) against the same step issued launch by launch from the same
    engine state: every buffer and the whole slot cache equal bit for bit;
    each replay adds one step's launches."""
    from paligemma_tpu_torch.continuous import ContinuousBatcher

    model, proc, images, prompts = _tiny_served(cuda)
    layers = model.cfg.text_config.num_hidden_layers
    eng = ContinuousBatcher(model, proc, n_slots=3, max_new_tokens=24, chunk=4, kv_quant=kv_int8,
                            spec_k=spec, prefetch=False)
    for p, im in zip(prompts[:3], images[:3]):
        eng.submit(p, im)
    eng.step()  # the join and a first chunk: rows at ragged lengths
    runner = eng._step_runner(spec, False)
    c = eng.full_cache
    tensors = eng.state.tensors() + [getattr(c, f) for f in ("k", "v", "k_scale", "v_scale") if hasattr(c, f)]
    saved = [x.clone() for x in tensors]
    n = 3

    def reset():
        for dst, src in zip(tensors, saved):
            dst.copy_(src)
        eng.state.step.zero_()
        eng.state.counts.zero_()

    reset()
    before = kernels.launch_counts()
    runner.run(n, (None, None))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["decode_attention"] - before["decode_attention"] == n * layers
    graph_out = [x.clone() for x in tensors]
    reset()
    for _ in range(n):
        runner.step((None, None))
    torch.cuda.synchronize()
    for got, want in zip(graph_out, tensors):
        assert torch.equal(got, want)
    eng.close()


def test_free_slot_past_the_window_faults_nothing_on_the_card(cuda):
    """A free slot whose stale length passed a shrunk window keeps stepping
    (its writes clamped to its own rows): no device fault, and the tokens of
    the window engine are the full-cache engine's."""
    from paligemma_tpu_torch.continuous import ContinuousBatcher

    model, proc, images, prompts = _tiny_served(cuda)

    def run(**kw):
        eng = ContinuousBatcher(model, proc, n_slots=2, max_new_tokens=160, chunk=4, prefetch=False, **kw)
        long_r = eng.submit(prompts[0], images[0], max_new_tokens=140)
        short = eng.submit(prompts[1], images[1], max_new_tokens=6)
        while not long_r.done:
            eng.step()
        late = eng.submit(prompts[2], images[2], max_new_tokens=30)
        past = False
        while eng.step():
            past |= int(eng.state.lengths[1]) > eng.window
        torch.cuda.synchronize()
        eng.close()
        assert all(r.error is None for r in (long_r, short, late))
        return [r.tokens for r in (long_r, short, late)], eng, past

    base, _, _ = run()
    win, eng, past = run(kv_window=True)
    assert past and eng.window_resizes >= 2
    assert win == base


def test_prepared_engine_joins_every_group_size_without_a_capture(cuda):
    """After ``prepare()`` at 8 slots, ``_prefills`` holds a join prefill of
    every (group batch of ``join_batches``, prompt bucket), and groups of 1,
    2, 3, 5 and 8 join at 1, 2, 4, 8 and 8 by replays only: ``graph_log``
    does not grow."""
    from paligemma_tpu_torch.continuous import ContinuousBatcher, join_batches

    model, proc, images, prompts = _tiny_served(cuda)
    eng = ContinuousBatcher(model, proc, n_slots=8, max_new_tokens=6, chunk=4)
    eng.prepare()
    assert sorted(eng._prefills) == [(b, t) for b in join_batches(8) for t in eng.prompt_budgets]
    n = len(eng.graph_log)
    for g in (1, 2, 3, 5, 8):
        reqs = [eng.submit(prompts[i % 4], images[i % 4], max_new_tokens=2) for i in range(g)]
        eng.run()
        assert all(r.done and r.error is None for r in reqs)
    eng.close()
    assert len(eng.graph_log) == n
    assert [(g_b, len(m)) for g_b, m in eng.join_log] == [(1, 1), (2, 2), (4, 3), (8, 5), (8, 8)]


@pytest.mark.parametrize("kw", [{}, {"spec_k": 4, "kv_window": True}], ids=["plain", "spec_window"])
def test_tiny_engine_gives_batch1_tokens(cuda, kw):
    """Each request's tokens are batch-1 ``generate``'s, up to a first
    difference where batch 1's top two logits lie within 2% (a bf16 GEMM of
    the slots' rows can round a near tie apart from a one-row GEMM)."""
    from paligemma_tpu_torch.continuous import ContinuousBatcher

    model, proc, images, prompts = _tiny_served(cuda)
    eng = ContinuousBatcher(model, proc, n_slots=2, max_new_tokens=20, chunk=4, **kw)
    reqs = [eng.submit(p, im, max_new_tokens=m) for p, im, m in zip(prompts, images, [12, 20, 7, 12])]
    eng.run()
    eng.close()
    assert reqs[0].tokens == reqs[3].tokens  # the repeated request
    for r, p, im in zip(reqs, prompts, images):
        assert r.error is None
        out = proc(text=[p], images=[im])
        ids = torch.from_numpy(out["input_ids"]).to(cuda)
        pix = torch.from_numpy(out["pixel_values"]).to(cuda, torch.bfloat16)
        ref, _ = generation.generate(model, ids, pix, r.max_new_tokens, proc.tokenizer.eos_token_id)
        div = next((i for i, (a, b) in enumerate(zip(r.tokens, ref)) if a != b), None)
        if div is None:
            assert r.tokens == ref
        else:
            gap, bar = _top_two_gap(model, ids, pix, ref[:div])
            assert gap <= bar, (div, gap, bar)


# ---------------------------------------------------------------------------
# Gradients through the kernel path (LoRA training)
# ---------------------------------------------------------------------------


def _cos_and_gap(got, ref):
    got, ref = got.double().flatten(), ref.double().flatten()
    cos = float(got @ ref / (got.norm() * ref.norm()))
    return cos, abs(float(got.norm() / ref.norm()) - 1.0)


@pytest.mark.parametrize("b,t,h,hkv,d,valid", [
    (1, 256, 16, 16, 72, None),        # SigLIP-224
    (2, 320, 8, 1, 256, None),         # the Gemma training shape
    (2, 320, 8, 1, 256, [320, 300]),   # ... with a right-padded row
    (3, 77, 4, 2, 64, [77, 20, 51]),
])
def test_flash_function_forward_is_the_kernel_and_backward_the_plain_gradient(cuda, b, t, h, hkv, d, valid):
    """``FlashAttentionFn``: the forward is the no-grad kernel call bit for
    bit (one launch); dq, dk, dv equal autograd of ``flash_attention_plain``
    (the same computation run apart: within 1e-5 relative) and lie within
    cosine 0.9999 of the fp32 gradient."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (_rand(gen, (b, t, n, d), cuda).requires_grad_() for n in (h, hkv, hkv))
    vl = None if valid is None else torch.tensor(valid, dtype=torch.int32, device=cuda)
    w = torch.randn((b, t, h, d), generator=gen, device=cuda)
    before = ca.launch_counts()["flash_attention"]
    out = ca.flash_attention(q, k, v, vl)
    assert out.grad_fn is not None and ca.launch_counts()["flash_attention"] == before + 1
    with torch.no_grad():
        assert torch.equal(out, ca.flash_attention(q, k, v, vl))
    grads = torch.autograd.grad((out.float() * w).sum(), (q, k, v))
    assert ca.launch_counts()["flash_attention"] == before + 2  # the backward launches nothing
    ref = torch.autograd.grad((ca.flash_attention_plain(q, k, v, vl).float() * w).sum(), (q, k, v))
    wide = [x.detach().float().requires_grad_() for x in (q, k, v)]
    ref32 = torch.autograd.grad((ca.flash_attention_plain(*wide, vl) * w).sum(), wide)
    for g, r, r32 in zip(grads, ref, ref32):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), r.float(), rtol=1e-5, atol=1e-5 * float(r.float().abs().max()))
        assert _cos_and_gap(g, r32)[0] >= 0.9999


def test_kernels_without_a_backward_raise_under_grad(cuda):
    """Every wrapper but flash refuses a grad-requiring CUDA input under
    grad mode before it launches; under ``no_grad`` it runs."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = _rand(gen, (4, 64), cuda).requires_grad_()
    q8 = torch.randint(-127, 128, (32, 64), dtype=torch.int8, device=cuda, generator=gen)
    sc = torch.rand(32, device=cuda, generator=gen) * 0.01
    packed = quant.pack_int4(torch.randint(-8, 8, (32, 64), dtype=torch.int8, device=cuda, generator=gen))
    xq = torch.randint(-127, 128, (4, 64), dtype=torch.int8, device=cuda, generator=gen)
    xs = torch.rand(4, device=cuda, generator=gen)
    qd = _rand(gen, (1, 1, 8, 64), cuda).requires_grad_()
    cache = _rand(gen, (1, 32, 1, 64), cuda)
    calls = {
        "decode_attention": lambda: ca.decode_attention(qd, cache, cache, torch.tensor([5], device=cuda,
                                                                                           dtype=torch.int32)),
        "q8_matmul": lambda: quant.q8_matmul(x, q8, sc),
        "q4_matmul": lambda: quant.q4_matmul(x, packed, sc),
        "a8_matmul": lambda: quant.a8_matmul(x, q8, sc),
        "q4a8_matmul": lambda: quant.q4a8_matmul(x, packed, sc),
        "w4a8_gemv": lambda: quant.w4a8_gemv(xq, xs.requires_grad_(), packed, sc, torch.bfloat16),
        "w4a8_geglu": lambda: quant.w4a8_geglu(x, packed, sc),
        "mlp_w4a8": lambda: quant.mlp_w4a8(x, packed, sc, packed, sc),
        "quant_rows": lambda: quant.quant_rows(x),
    }
    for name, call in calls.items():
        before = kernels.call_counts()
        with pytest.raises(ValueError, match=f"{name}: the CUDA kernel has no backward"):
            call()
        assert kernels.call_counts() == before, name
    with torch.no_grad():
        quant.q8_matmul(x, q8, sc)


def test_logits_gradient_is_the_widened_products(cuda):
    """``gemma.logits`` on a bf16 hidden that requires grad: fp32 logits
    equal to the no-grad call, and d hidden within cosine 0.9999 and 2^-6
    of the largest element of autograd of the widened fp32 product."""
    cfg = paligemma_tpu_torch.tiny_config().text_config
    llm = gemma.GemmaModel(dataclasses.replace(cfg, vocab_size=3000, hidden_size=256), torch.bfloat16).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(8)
    with torch.no_grad():
        llm.embed.normal_(0.0, 0.05, generator=gen)
    llm.embed.requires_grad_(False)
    h = _rand(gen, (2, 7, 256), cuda).requires_grad_()
    g = torch.randn((2, 7, 3000), generator=gen, device=cuda)
    out = gemma.logits(llm, h)
    with torch.no_grad():
        assert out.dtype == torch.float32 and torch.equal(out, gemma.logits(llm, h))
    (dh,) = torch.autograd.grad((out * g).sum(), h)
    (ref,) = torch.autograd.grad(((h.float() @ llm.embed.float().t()) * g).sum(), h)
    assert dh.dtype == torch.bfloat16
    assert _cos_and_gap(dh, ref)[0] >= 0.9999
    assert float((dh.float() - ref.float()).abs().max()) <= 2.0**-6 * float(ref.float().abs().max())


def _tiny_lora_batch(cuda, model, proc, images, prompts, pad=0, which=(1, 2)):
    """Two rows of the tiny served traffic as a training batch, right-padded
    to the longer row plus ``pad``."""
    rows = [proc(text=[prompts[i]], images=[images[i]]) for i in which]
    t = max(r["input_ids"].shape[1] for r in rows) + pad
    ids = torch.zeros((2, t), dtype=torch.int32)
    valid = torch.tensor([r["input_ids"].shape[1] for r in rows], dtype=torch.int32)
    for i, r in enumerate(rows):
        ids[i, : valid[i]] = torch.from_numpy(r["input_ids"][0])
    labels = torch.full_like(ids, -100)
    n_img = model.cfg.vision_config.num_image_tokens
    for i in range(2):
        labels[i, n_img: valid[i]] = ids[i, n_img: valid[i]]
    return {"input_ids": ids.to(cuda), "labels": labels.to(cuda), "valid_len": valid.to(cuda),
            "pixel_values": torch.cat([torch.from_numpy(r["pixel_values"]) for r in rows]).to(cuda)}


def test_tiny_lora_train_step_on_the_card(cuda):
    """One train step on the tiny bf16 model: the adapter gradients through
    the kernels within cosine 0.999 and 1% in norm of those through the
    plain versions (same dropout masks), flash launched once a SigLIP and
    a Gemma layer and nothing else; the optimizer moves B."""
    from paligemma_tpu_torch import lora

    model, proc, images, prompts = _tiny_served(cuda)
    batch = _tiny_lora_batch(cuda, model, proc, images, prompts)
    lcfg = lora.LoraConfig(r=4, alpha=8, dropout=0.1)
    ad = lora.init_lora(model.cfg, lcfg, torch.Generator(device=cuda).manual_seed(1), device=cuda)
    for mod in ad["layers"].values():
        mod["b"].normal_(0.0, 0.05, generator=torch.Generator(device=cuda).manual_seed(2))

    def grads(fns):
        live = lora._map(lambda x: x.detach().requires_grad_(), ad)
        loss = paligemma.loss_fn(model, batch["input_ids"], batch["pixel_values"], batch["labels"],
                                 valid_len=batch["valid_len"], lora=live, lora_scale=lcfg.scale,
                                 lora_dropout=lcfg.dropout, lora_generator=torch.Generator(device=cuda).manual_seed(3),
                                 fns=fns)
        return loss, torch.autograd.grad(loss, lora.adapter_leaves(live))

    kernels.reset_launch_counts()
    loss_k, gk = grads(kernels.KERNELS)
    counts = {k: v for k, v in kernels.call_counts().items() if v}
    layers = model.cfg.vision_config.num_hidden_layers + model.cfg.text_config.num_hidden_layers
    assert counts == {"flash_attention": layers}
    loss_p, gp = grads(PLAIN)
    assert torch.isfinite(loss_k) and abs(float(loss_k - loss_p)) <= 0.01 * abs(float(loss_p))
    cos, gap = _cos_and_gap(torch.cat([g.flatten() for g in gk]), torch.cat([g.flatten() for g in gp]))
    assert cos >= 0.999 and gap <= 0.01, (cos, gap)
    opt = lora.default_optimizer(lr=1e-2, accum_steps=1)
    step = lora.make_train_step(lcfg, opt)
    b0 = ad["layers"]["q"]["b"].clone()
    state = opt.init(ad)
    _, ad, state = step(model, ad, state, batch, torch.Generator(device=cuda).manual_seed(3))
    assert not torch.equal(b0, ad["layers"]["q"]["b"])


def _tiny_training(cuda, accum=2):
    from paligemma_tpu_torch import lora

    model, proc, images, prompts = _tiny_served(cuda)
    lcfg = lora.LoraConfig(r=4, alpha=8, dropout=0.1)
    ad = lora.init_lora(model.cfg, lcfg, torch.Generator(device=cuda).manual_seed(1), device=cuda)
    opt = lora.default_optimizer(lr=1e-2, accum_steps=accum)
    return model, proc, images, prompts, lcfg, ad, opt


def _clone_state(state):
    return {k: [t.clone() for t in v] if isinstance(v, list) else v for k, v in state.items()}


def test_compiled_train_step_is_the_eager_step_bit_for_bit(cuda):
    """5 micro-steps, accumulation 2, dropout 0.1, from one adapter,
    optimizer state and generator state: the replayed CUDA graphs give each
    loss, the adapter, the state and the generator's state of
    ``lora.train_step`` bit for bit, with one capture a flavour at its
    first micro-step and the eager launches."""
    from paligemma_tpu_torch import lora

    model, proc, images, prompts, lcfg, ad, opt = _tiny_training(cuda)
    batches = [_tiny_lora_batch(cuda, model, proc, images, prompts, which=w) for w in ((1, 2), (0, 3))]
    start = (lora._map(lambda t: t.clone(), ad), opt.init(ad))
    runs = {}
    for name in ("eager", "compiled"):
        a, state = lora._map(lambda t: t.clone(), start[0]), _clone_state(start[1])
        gen = torch.Generator(device=cuda).manual_seed(7)
        step = lora.make_train_step(lcfg, opt) if name == "compiled" else (
            lambda m, a, s, b, g: lora.train_step(m, a, s, b, g, lcfg, opt))
        losses, captures = [], []
        kernels.reset_launch_counts()
        for i in range(5):
            n = len(getattr(step, "log", ()))
            loss, a, state = step(model, a, state, batches[i % 2], gen)
            losses.append(float(loss))
            captures.append(len(getattr(step, "log", ())) - n)
        torch.cuda.synchronize()
        runs[name] = (losses, a, state, gen.get_state(), captures, kernels.launch_counts())
    (le, ae, se, ge, _, ce), (lc, ac, sc, gc, cap, cc) = runs["eager"], runs["compiled"]
    assert lc == le and all(math.isfinite(x) for x in lc)
    assert all(torch.equal(x, y) for x, y in zip(lora.adapter_leaves(ae), lora.adapter_leaves(ac)))
    assert all(torch.equal(x, y) for k in ("acc", "mu", "nu") for x, y in zip(se[k], sc[k]))
    assert (se["mini_step"], se["count"]) == (sc["mini_step"], sc["count"]) == (1, 2)
    assert torch.equal(ge, gc)
    assert cap == [1, 1, 0, 0, 0] and ce == cc
    assert not torch.equal(ae["layers"]["q"]["b"], start[0]["layers"]["q"]["b"])


def test_compiled_train_step_captures_once_a_shape(cuda):
    """A new batch shape captures its graphs; a shape seen before replays."""
    from paligemma_tpu_torch import lora

    model, proc, images, prompts, lcfg, ad, opt = _tiny_training(cuda, accum=1)
    step = lora.make_train_step(lcfg, opt)
    state = opt.init(ad)
    gen = torch.Generator(device=cuda).manual_seed(7)
    short, long = (_tiny_lora_batch(cuda, model, proc, images, prompts, pad=p) for p in (0, 6))
    counts = []
    for batch in (short, short, long, short, long):
        _, ad, state = step(model, ad, state, batch, gen)
        counts.append(len(step.log))
    assert counts == [1, 1, 2, 2, 2]
    assert {e["key"][0][0][1] for e in step.log} == {tuple(short["input_ids"].shape), tuple(long["input_ids"].shape)}


def test_resume_into_the_compiled_step_equals_an_uninterrupted_compiled_run(cuda, tmp_path):
    from paligemma_tpu_torch import lora

    model, proc, images, prompts = _tiny_served(cuda)
    batches = [_tiny_lora_batch(cuda, model, proc, images, prompts, which=w) for w in ((1, 2), (0, 3))] * 3
    kw = dict(lcfg=lora.LoraConfig(r=2, alpha=4, dropout=0.1), lr=1e-2, accum_steps=3, log_every=0,
              save_train_state_too=True)
    full, losses = lora.train(model, batches, save_every_n_steps=0, output_dir=str(tmp_path / "a"), **kw)
    lora.train(model, batches[:2], save_every_n_steps=2, output_dir=str(tmp_path / "b"), **kw)
    resumed, losses_r = lora.train(model, batches, save_every_n_steps=0, output_dir=str(tmp_path / "b"),
                                   resume=True, logger=lambda m: None, **kw)
    assert losses_r == losses[2:] and len(losses) == 6
    for a, b in zip(lora.adapter_leaves(full), lora.adapter_leaves(resumed)):
        assert a.is_cuda and torch.equal(a, b)


def test_a_step_that_raises_in_its_capture_is_a_failed_step_in_train(cuda, tmp_path, monkeypatch):
    """The first capture raises: ``train`` counts one failure and skips the
    batch (the adapter and state as they were), the next call captures
    and trains; a capture that raises every time re-raises after three."""
    from paligemma_tpu_torch import lora

    model, proc, images, prompts = _tiny_served(cuda)
    batch = _tiny_lora_batch(cuda, model, proc, images, prompts)
    real, calls = lora._step_on_device, []

    def flaky(*args, fail_every=False):
        if torch.cuda.is_current_stream_capturing():
            calls.append(1)
            if fail_every or len(calls) == 1:
                raise RuntimeError("capture failed on purpose")
        return real(*args)

    monkeypatch.setattr(lora, "_step_on_device", flaky)
    logs = []
    ad, losses = lora.train(model, [batch] * 4, lcfg=lora.LoraConfig(r=2, alpha=4), accum_steps=1, lr=1e-2,
                            output_dir=str(tmp_path / "a"), logger=logs.append, save_every_n_steps=0)
    assert sum("clearing caches and skipping" in m for m in logs) == 1 and len(losses) == 3
    assert all(math.isfinite(x) for x in losses)
    monkeypatch.setattr(lora, "_step_on_device", lambda *a: flaky(*a, fail_every=True))
    logs.clear()
    with pytest.raises(RuntimeError, match="on purpose"):
        lora.train(model, [batch] * 5, lcfg=lora.LoraConfig(r=2, alpha=4), output_dir=str(tmp_path / "b"),
                   logger=logs.append)
    assert sum("clearing caches and skipping" in m for m in logs) == 3


def test_compiled_eval_loss_is_the_eager_loss_bit_for_bit(cuda):
    from paligemma_tpu_torch import lora

    model, proc, images, prompts, lcfg, ad, _ = _tiny_training(cuda)
    for mod in ad["layers"].values():
        mod["b"].normal_(0.0, 0.05, generator=torch.Generator(device=cuda).manual_seed(2))
    fn = lora.make_eval_loss(lcfg.scale)
    for pad in (0, 5, 0):
        batch = _tiny_lora_batch(cuda, model, proc, images, prompts, pad=pad)
        ref = lora.eval_loss(model, ad, batch, lcfg.scale)
        for _ in range(2):  # the first call of a shape (its capture's warm-up), then a replay
            assert torch.equal(fn(model, ad, batch), ref)
    assert len(fn.graphs) == 2
    base = lora.eval_loss(model, None, batch, lcfg.scale)
    assert torch.equal(fn(model, None, batch), base) and not torch.equal(base, ref)


def test_join_prefill_row_parts_at_no_kernel_of_the_port(cuda):
    """The tiny bf16 model's join prefill (``serving.batched_prefill``) at
    group batch 1 and 32, one request at row 0 in both: row 0 compared op by
    op; where it parts, the op is PyTorch's, never a kernel of the port
    (flash is launched at both group batches)."""
    from paligemma_tpu_torch import serving
    from paligemma_tpu_torch.utils import rowdiff

    model, proc, images, prompts = _tiny_served(cuda)
    rows = [proc(text=[p], images=[im]) for p, im in zip(prompts, images)]
    t = max(r["input_ids"].shape[1] for r in rows)
    ids = torch.zeros((32, t), dtype=torch.int32, device=cuda)
    valid = torch.zeros(32, dtype=torch.int32, device=cuda)
    pix = torch.zeros((32, *rows[0]["pixel_values"].shape[1:]), dtype=torch.bfloat16, device=cuda)
    for i in range(32):
        r = rows[i % 4]
        n = r["input_ids"].shape[1]
        ids[i, :n], valid[i] = torch.from_numpy(r["input_ids"][0]).to(cuda), n
        pix[i] = torch.from_numpy(r["pixel_values"][0]).to(cuda, torch.bfloat16)

    def run(fns, b):
        cache = gemma.init_cache(model.cfg.text_config, b, t, torch.bfloat16, cuda)
        return serving.batched_prefill(model, ids[:b], pix[:b], valid[:b], cache, fns)[0]

    before = kernels.launch_counts()["flash_attention"]
    diff = rowdiff.first_row_difference(run, 1, 32, labels=rowdiff.model_labels(model))
    layers = model.cfg.vision_config.num_hidden_layers + model.cfg.text_config.num_hidden_layers
    assert kernels.launch_counts()["flash_attention"] - before == 2 * layers
    assert diff is None or not diff["op"].startswith("fns."), diff


def test_full_width_join_prefill_row_parts_first_at_a_cublas_product(cuda):
    """The finding this pins: at the 3B-224 widths (one SigLIP and one Gemma
    layer, seeded random weights, 256 image tokens + 93 text), row 0 of a
    join prefill at group batch 32 parts from the same row at group batch 1
    first at a bf16 ``aten.mm`` (cuBLAS) of the Gemma layer; the SigLIP
    tower, the qkv product and the flash kernel before it agree bit for
    bit. A request's tokens may so depend on its group batch by design
    (ROADMAP.md, Queue 3)."""
    from paligemma_tpu_torch import serving
    from paligemma_tpu_torch.utils import rowdiff

    cfg = paligemma_tpu_torch.paligemma_3b_pt_224()
    cfg = dataclasses.replace(
        cfg, vision_config=dataclasses.replace(cfg.vision_config, num_hidden_layers=1),
        text_config=dataclasses.replace(cfg.text_config, num_hidden_layers=1))
    model = paligemma.init_params(cfg, 0, device=cuda, dtype=torch.bfloat16)
    n_img, size, t = cfg.vision_config.num_image_tokens, cfg.vision_config.image_size, 349
    gen = torch.Generator(device=cuda).manual_seed(16)
    ids = torch.randint(3, 30000, (32, t), generator=gen, device=cuda, dtype=torch.int32)
    pix = torch.randn((32, 3, size, size), generator=gen, device=cuda).to(torch.bfloat16)
    valid = torch.tensor([t - 10 * (i % 7) for i in range(32)], dtype=torch.int32, device=cuda)

    def run(fns, b):
        cache = gemma.init_cache(cfg.text_config, b, t, torch.bfloat16, cuda)
        return serving.batched_prefill(model, ids[:b], pix[:b], valid[:b], cache, fns)[0]

    diff = rowdiff.first_row_difference(run, 1, 32, labels=rowdiff.model_labels(model))
    assert diff is not None and diff["op"] == "aten.mm" and diff["where"] == "gemma layer 0", diff
    assert "sequence" not in diff and diff["differing"] > 0


def test_tiny_lora_engine_on_the_card(cuda):
    """A lora_rank engine's captured slot graphs read the adapters each join
    writes in place: a base request gives the base engine's tokens, an
    adapted one its tokens alone beside the others, and differs from base."""
    from paligemma_tpu_torch import lora
    from paligemma_tpu_torch.continuous import ContinuousBatcher

    model, proc, images, prompts = _tiny_served(cuda)
    lcfg = lora.LoraConfig(r=2, alpha=4)
    ad = lora.init_lora(model.cfg, lcfg, torch.Generator(device=cuda).manual_seed(1), device=cuda)
    for mod in ad["layers"].values():
        mod["b"].normal_(0.0, 1.0, generator=torch.Generator(device=cuda).manual_seed(2))

    def run(reqs, lora_rank=4):
        eng = ContinuousBatcher(model, proc, n_slots=3, max_new_tokens=12, chunk=4, lora_rank=lora_rank)
        if lora_rank:
            eng.register_adapter("fin", ad, lcfg.scale)
        eng.prepare()
        n = len(eng.graph_log)
        out = [eng.submit(prompts[i], images[i], adapter=a) for i, a in reqs]
        eng.run()
        eng.close()
        assert len(eng.graph_log) == n and all(r.error is None for r in out)
        return [r.tokens for r in out]

    together = run([(0, "fin"), (1, None), (2, "fin")])
    base = run([(0, None), (1, None), (2, None)], lora_rank=None)
    assert together[1] == base[1]
    assert together[0] != base[0] or together[2] != base[2]
    assert run([(0, "fin"), (1, None), (2, None)])[0] == together[0]

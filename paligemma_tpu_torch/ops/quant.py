"""int8, int4 and w4a8 matmuls: hand-written CUDA kernels and their plain versions.

Port of ``paligemma_tpu/ops/pallas_quant.py`` (``q8_matmul``,
``q4_matmul``, ``quantize_rows_s8``, ``q4a8_matmul[_tiled]``,
``mlp_w4a8[_stacked]``) and of the reference's ``qproj_a8`` product. Each
public function dispatches on the device of its activation tensor:

- a CPU tensor takes the plain PyTorch version beside it (``*_plain``),
- a CUDA tensor launches the kernels of ``csrc/quant_matmul.cu`` and
  ``csrc/w4a8.cu`` (``a8_matmul``: ``torch._int_mm``) or raises; there is no
  fallback.

The weight layout is the port's own, ``nn.Linear``'s ``(out, in)``:

- int8: ``q`` (O, D) int8 with one fp32 scale per output row, ``s`` (O,);
  the tied lm_head (V, D) with its per-row scales is the same shape.
- int4 (int4 weight-only and w4a8): ``packed`` (O, D/2) uint8, two signed
  nibbles of one output row per byte. Within each group of 8 input columns
  ``8i..8i+7``, byte ``4i + k`` holds column ``8i + k`` in its low nibble
  and ``8i + 4 + k`` in its high nibble, so ``(w << 4) & 0xF0F0F0F0`` /
  ``w & 0xF0F0F0F0`` of one 32-bit word of packed bytes are 16 times four
  columns each, exact in int8 lanes: the s8 operands of the w4a8 kernels'
  tensor-core products as they stand.

Numerics, as in the reference:

- ``q8_matmul`` and ``q4_matmul``: ``(x @ q^T)`` accumulated in fp32 (the
  weights are exact in bf16), times the scale in fp32, rounded once to the
  output dtype.
- ``quant_rows``: per row ``xs = max(absmax, 1e-8) / 127``,
  ``xq = round_half_even(x / xs)``.
- ``a8_matmul`` (the reference's ``qproj_a8``): per row
  ``xs = max(absmax, 1e-8) * fp32(1/127)`` (``quantize_rows_s8_rcp``),
  ``xq = round(x / xs)``, an exact int32 product with the int8 weight, then
  ``(float(acc) * xs) * s`` rounded to x.dtype.
- ``w4a8_gemv``: exact int32 accumulation of int8 x int4, then
  ``(float(acc) * xs) * s``. Every partial sum is an integer below 2^24 in
  magnitude (|acc| <= 127 * 7 * 16384 at the widest row), so the plain
  version's fp32 product is exact too.
- ``w4a8_geglu``: quant -> gate_up GEMV (bf16 out) -> fp32 tanh-GELU of
  gate, rounded to the activation dtype, times up: h (M, I).
- ``mlp_w4a8``: ``w4a8_geglu``, then quant -> down GEMV.

Each kernel wrapper counts its launches in its ``launches`` attribute:
``w4a8_gemv`` counts every launch of the w4a8 GEMV kernel, also those that
``q4a8_matmul`` and ``mlp_w4a8`` make (with the quantizing prologue, or
after a ``quant_rows`` launch, which ``quant_rows`` counts), and
``w4a8_geglu`` those of the gate_up kernel with the GeGLU epilogue.
``a8_matmul`` launches no kernel of the port and counts its calls in
``calls``.
"""
from __future__ import annotations

import functools
from typing import Callable, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from paligemma_tpu_torch.ops import _build
from paligemma_tpu_torch.ops.cuda_attention import refuse_grad

# A reduction of a row-parallel product's partial results over its group.
Reduce = Callable[[torch.Tensor], torch.Tensor]

# Rows of one fused-MLP call; more rows take the int8 companions
# (the reference's VMEM budget, kept as the routing rule).
MLP_FUSED_MAX_ROWS = 64
# Rows up to which the w4a8 kernels quantize their bf16 rows of x in their
# own prologue (csrc/w4a8.cu takes at most 8): q4a8_matmul is then one
# launch and mlp_w4a8 two. More rows take a quant_rows launch first, and
# mlp_w4a8 four launches. Every block of a prologue GEMV quantizes all its
# rows (the down GEMV: 16384 values a row in each of 128 blocks), ~5 us a
# row for the MLP, while the quant_rows route costs ~8 us whatever the rows:
# on the H100 the 3B MLP took 0.0251 / 0.0315 / 0.0366 ms at 1 / 2 / 3 rows
# with the prologue and 0.0334 / 0.0338 / 0.0336 with quant_rows first, the
# 4-bit lm_head 0.0921 / 0.0923 ms at 2 rows and 0.0998 / 0.0944 at 4
# (scripts/w4a8_variants.py; PERF.md section 6).
W4A8_PROLOGUE_MAX_ROWS = 2
# The most rows the prologue kernels take (csrc/w4a8.cu's kQuantMaxRows).
_PROLOGUE_KERNEL_MAX_ROWS = 8


# ---------------------------------------------------------------------------
# Packing (the port's int4 layout)
# ---------------------------------------------------------------------------


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7] (..., D) -> packed (..., D/2) uint8."""
    *lead, d = q.shape
    if d % 8:
        raise ValueError(f"pack_int4: the packed dim {d} must be a multiple of 8")
    g = q.reshape(*lead, d // 8, 2, 4).to(torch.int16)  # (..., group, lo|hi, k)
    byte = (g[..., 0, :] & 15) | ((g[..., 1, :] & 15) << 4)
    return byte.to(torch.uint8).reshape(*lead, d // 2)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_int4``: (..., D/2) uint8 -> int8 values (..., D)."""
    *lead, h = packed.shape
    b = packed.reshape(*lead, h // 4, 1, 4).to(torch.int16)
    lo = ((b & 15) ^ 8) - 8
    hi = ((b >> 4) ^ 8) - 8
    return torch.cat([lo, hi], dim=-2).reshape(*lead, 2 * h).to(torch.int8)


# ---------------------------------------------------------------------------
# Per-row int8 activation quantization (optionally with the GeGLU prologue)
# ---------------------------------------------------------------------------


def geglu(gu: torch.Tensor) -> torch.Tensor:
    """(..., 2I) fused [gate | up] -> (..., I): fp32 tanh-GELU of gate,
    rounded to gu.dtype, times up in gu.dtype."""
    gate, up = gu.chunk(2, dim=-1)
    return F.gelu(gate.float(), approximate="tanh").to(gu.dtype) * up


def quantize_rows_s8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D) -> (xq int8 (..., D), xs fp32 (...)): per-row symmetric int8.

    Both divisions are IEEE divisions of two tensors: on CUDA, PyTorch turns
    a division by a Python scalar into a product with its reciprocal, which
    can move ``xs`` by an ulp from the kernel's (and the reference's)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1).clamp_min(1e-8)
    xs = amax / torch.full_like(amax, 127.0)
    xq = torch.round(xf / xs[..., None]).to(torch.int8)
    return xq, xs


def quantize_rows_s8_rcp(x: torch.Tensor, amax_reduce: Optional[Reduce] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D) -> (xq int8 (..., D), xs fp32 (...)) as the reference's jitted
    ``qproj_a8`` and ``quantize_kv_rows`` compute it: XLA turns their
    ``/ 127.0`` into a product with the fp32 reciprocal, so
    ``xs = max(absmax, 1e-8) * fp32(1/127)``; ``xq = round(x / xs)`` stays an
    IEEE division of two tensors (clipped to [-127, 127], which never binds).
    ``amax_reduce`` maps the rows' absmax to that of whole rows (a
    row-parallel product's columns: the max over the model group)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    xs = amax.clamp_min(1e-8) * (1.0 / 127.0)
    xq = torch.round(xf / xs[..., None]).clamp_(-127, 127).to(torch.int8)
    return xq, xs


def quant_rows_plain(x: torch.Tensor, geglu_prologue: bool = False):
    """Plain version of ``quant_rows`` (any device)."""
    return quantize_rows_s8(geglu(x) if geglu_prologue else x)


def quant_rows(x: torch.Tensor, geglu_prologue: bool = False):
    """(M, D) -> (xq (M, D) int8, xs (M,) fp32); with ``geglu_prologue`` the
    input is a fused (M, 2I) [gate | up] row and the output covers (M, I)."""
    if x.device.type == "cpu":
        return quant_rows_plain(x, geglu_prologue)
    refuse_grad("quant_rows", x)
    m, width = x.shape
    d = width // 2 if geglu_prologue else width
    _check_rows("quant_rows", x, d_multiple=16 if geglu_prologue else 8)
    xq = torch.empty((m, d), dtype=torch.int8, device=x.device)
    xs = torch.empty((m,), dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    rc = lib.pg_quant_rows(
        x.data_ptr(), xq.data_ptr(), xs.data_ptr(), m, d, x.stride(0), int(geglu_prologue),
        _stream(x),
    )
    _build.check(lib, "quant_rows", rc)
    quant_rows.launches += 1
    return xq, xs


quant_rows.launches = 0


# ---------------------------------------------------------------------------
# Weight-only matmuls: int8 and packed int4
# ---------------------------------------------------------------------------


# More rows than this take the GEMM tiling of csrc/quant_matmul.cu
# (its kGemvMaxRows), which may split K and then needs a workspace.
_GEMV_MAX_ROWS = 64
# The split-K arrival counters (csrc/quant_matmul.cu's kMaxSplitTiles).
_SPLIT_COUNTERS = 4096


@functools.cache
def _split_counters(device: torch.device) -> torch.Tensor:
    """The arrival counters of the split-K GEMM on ``device``: zeroed once;
    every launch leaves them at zero. All calls use one stream, so they
    never run at the same time."""
    return torch.zeros(_SPLIT_COUNTERS, dtype=torch.int32, device=device)


def _weight_only(name, entry, x, w, scale, out_dtype, w_dtype, cols_per_byte):
    """Launch ``entry`` of ``csrc/quant_matmul.cu``: x (..., D) @ the (O, D)
    weight stored as (O, D / cols_per_byte) ``w_dtype`` -> (..., O)."""
    out_dtype = out_dtype or x.dtype
    *lead, d = x.shape
    x2 = x.reshape(-1, d)
    m, o = x2.shape[0], w.shape[0]
    # One 16-byte weight vector holds 16 int8 or 32 int4 columns.
    _check_rows(name, x2, d_multiple=16 * cols_per_byte)
    _check_weight(name, x2, w, scale, w_dtype, (o, d // cols_per_byte))
    out = torch.empty((m, o), dtype=_out_dtype(name, out_dtype), device=x.device)
    f32 = int(out.dtype == torch.float32)
    lib = _build.load_library()
    ws = counters = None
    if m > _GEMV_MAX_ROWS:
        nbytes = lib.pg_quant_matmul_workspace(m, o, d, int(cols_per_byte == 2), f32)
        if nbytes:
            ws = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
            counters = _split_counters(x.device)
    rc = getattr(lib, entry)(
        x2.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), m, o, d, x2.stride(0),
        f32, None if ws is None else ws.data_ptr(), None if counters is None else counters.data_ptr(),
        _stream(x),
    )
    _build.check(lib, name, rc)
    return out.reshape(*lead, o)


def q8_matmul_plain(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """Plain version of ``q8_matmul`` (any device)."""
    y = (x.float() @ q.float().t()) * scale
    return y.to(out_dtype or x.dtype)


def q8_matmul(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """x (..., D) @ int8 (O, D)^T times the per-row scales (O,) -> (..., O)
    in ``out_dtype`` (default x.dtype; the kernel writes bf16 or fp32)."""
    if x.device.type == "cpu":
        return q8_matmul_plain(x, q, scale, out_dtype)
    refuse_grad("q8_matmul", x, q, scale)
    out = _weight_only("q8_matmul", "pg_q8_matmul", x, q, scale, out_dtype, torch.int8, 1)
    q8_matmul.launches += 1
    return out


q8_matmul.launches = 0


def q4_matmul_plain(
    x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain version of ``q4_matmul`` (any device)."""
    y = (x.float() @ unpack_int4(packed).float().t()) * scale
    return y.to(out_dtype or x.dtype)


def q4_matmul(
    x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """x (..., D) @ packed int4 (O, D/2)^T times the per-row scales (O,) ->
    (..., O) in ``out_dtype`` (default x.dtype; the kernel writes bf16 or
    fp32). The int4 weight-only matmul: the activations stay in x.dtype."""
    if x.device.type == "cpu":
        return q4_matmul_plain(x, packed, scale, out_dtype)
    refuse_grad("q4_matmul", x, packed, scale)
    out = _weight_only("q4_matmul", "pg_q4_matmul", x, packed, scale, out_dtype, torch.uint8, 2)
    q4_matmul.launches += 1
    return out


q4_matmul.launches = 0


# ---------------------------------------------------------------------------
# int8 x int8 projection (the reference's qproj_a8, an XLA einsum there)
# ---------------------------------------------------------------------------


def _a8_rescale(acc: torch.Tensor, xs: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype,
                acc_reduce: Optional[Reduce], row_select: Optional[Reduce]) -> torch.Tensor:
    """The int32 sums (..., O) reduced by ``acc_reduce``, times the rows'
    scales (...) that ``row_select`` keeps and the output rows' scales."""
    if acc_reduce is not None:
        acc = acc_reduce(acc)
    if row_select is not None:
        xs = row_select(xs)
    return (acc.float() * xs[..., None] * scale).to(dtype)


def a8_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                    amax_reduce: Optional[Reduce] = None, acc_reduce: Optional[Reduce] = None,
                    row_select: Optional[Reduce] = None) -> torch.Tensor:
    """Plain version of ``a8_matmul`` (any device). The product is taken in
    float64, exact for these integer sums (fp32 is not: 127^2 x 2048 is
    above 2^24)."""
    xq, xs = quantize_rows_s8_rcp(x, amax_reduce)
    acc = (xq.double() @ q.double().t()).to(torch.int32)
    return _a8_rescale(acc, xs, scale, x.dtype, acc_reduce, row_select)


def a8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
              amax_reduce: Optional[Reduce] = None, acc_reduce: Optional[Reduce] = None,
              row_select: Optional[Reduce] = None) -> torch.Tensor:
    """x (..., D) quantized to int8 per row @ int8 (O, D)^T with an exact
    int32 product, rescaled per row and per output row -> (..., O) in
    x.dtype. On the card the product is ``torch._int_mm`` (cuBLASLt), which
    takes more than 16 rows and widths that are multiples of 8; anything
    else raises. A row-parallel product (x and q hold a slice of D) passes
    ``amax_reduce`` (the rows' absmax over the slices: a max over the
    model group) and ``acc_reduce`` (the int32 sums (..., O) over the
    slices: exact), so every rank gets the whole product's bits; a
    sequence-parallel one's ``acc_reduce`` keeps this rank's rows of the
    sums and ``row_select`` the same rows of the rows' scales (...)."""
    if x.device.type == "cpu":
        return a8_matmul_plain(x, q, scale, amax_reduce, acc_reduce, row_select)
    if x.device.type != "cuda":
        raise ValueError(f"a8_matmul: activations must be on a CUDA device, got {x.device}")
    refuse_grad("a8_matmul", x, q, scale)
    *lead, d = x.shape
    x2 = x.reshape(-1, d)
    m, o = x2.shape[0], q.shape[0]
    if m <= 16 or d % 8 or o % 8:
        raise ValueError(
            f"a8_matmul: torch._int_mm needs more than 16 rows and widths that are "
            f"multiples of 8, got ({m}, {d}) @ ({d}, {o})"
        )
    _check_weight("a8_matmul", x2, q, scale, torch.int8, (o, d))
    xq, xs = quantize_rows_s8_rcp(x2, amax_reduce)
    acc = torch._int_mm(xq, q.t())  # the (O, D) weight as a column-major (D, O)
    a8_matmul.calls += 1
    return _a8_rescale(acc.reshape(*lead, o), xs.reshape(lead), scale, x.dtype, acc_reduce, row_select)


a8_matmul.calls = 0


# ---------------------------------------------------------------------------
# w4a8: int8 activations x packed int4 weights
# ---------------------------------------------------------------------------


def w4a8_gemv_plain(
    xq: torch.Tensor, xs: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Plain version of ``w4a8_gemv`` (any device); the fp32 product is
    exact (integer partial sums below 2^24)."""
    acc = xq.float() @ unpack_int4(packed).float().t()
    return (acc * xs[:, None] * scale).to(out_dtype)


def w4a8_gemv(
    xq: torch.Tensor, xs: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """xq (M, D) int8 with row scales xs (M,) @ packed int4 (O, D/2)^T with
    row scales (O,) -> (M, O) in ``out_dtype`` (bf16 or fp32), one launch
    (64 rows of x at a time stream the weight once)."""
    if xq.device.type == "cpu":
        return w4a8_gemv_plain(xq, xs, packed, scale, out_dtype)
    refuse_grad("w4a8_gemv", xq, xs, packed, scale)
    m, d = xq.shape
    o = packed.shape[0]
    if xq.dtype != torch.int8 or xs.dtype != torch.float32 or xs.shape != (m,):
        raise TypeError("w4a8_gemv: xq (M, D) int8 and xs (M,) fp32 required")
    if d % 32:
        raise ValueError(f"w4a8_gemv: D = {d} must be a multiple of 32 (16-byte packed rows)")
    if not (xq.is_contiguous() and xs.is_contiguous()):
        raise ValueError("w4a8_gemv: xq and xs must be contiguous")
    _check_weight("w4a8_gemv", xq, packed, scale, torch.uint8, (o, d // 2))
    out = torch.empty((m, o), dtype=_out_dtype("w4a8_gemv", out_dtype), device=xq.device)
    lib = _build.load_library()
    rc = lib.pg_w4a8_gemv(
        xq.data_ptr(), xs.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
        m, o, d, int(out.dtype == torch.float32), _stream(xq),
    )
    _build.check(lib, "w4a8_gemv", rc)
    w4a8_gemv.launches += 1
    return out


w4a8_gemv.launches = 0


def _prologue_rows(name: str, x2: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> None:
    """Checks of a w4a8 kernel that quantizes its bf16 rows x2 (M, D) in its
    prologue, against ``packed`` (O, D/2)."""
    m, d = x2.shape
    if m > _PROLOGUE_KERNEL_MAX_ROWS:
        raise ValueError(f"{name}: {m} rows; the prologue takes at most {_PROLOGUE_KERNEL_MAX_ROWS}")
    _check_rows(name, x2, d_multiple=32)
    _check_weight(name, x2, packed, scale, torch.uint8, (packed.shape[0], d // 2))


def q4a8_matmul_plain(
    x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain version of ``q4a8_matmul`` (any device)."""
    *lead, d = x.shape
    xq, xs = quant_rows_plain(x.reshape(-1, d))
    y = w4a8_gemv_plain(xq, xs, packed, scale, out_dtype or x.dtype)
    return y.reshape(*lead, packed.shape[0])


def q4a8_matmul(
    x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """x (..., D) -> per-row int8 -> @ packed int4 (O, D/2)^T -> (..., O) in
    ``out_dtype`` (default x.dtype). Port of ``q4a8_matmul_tiled`` (and of
    ``q4a8_matmul``: the port has one w4a8 layout). Up to
    ``W4A8_PROLOGUE_MAX_ROWS`` rows one launch of the w4a8 GEMV, which
    quantizes x in its prologue; more rows a ``quant_rows`` launch first."""
    if x.device.type == "cpu":
        return q4a8_matmul_plain(x, packed, scale, out_dtype)
    refuse_grad("q4a8_matmul", x, packed, scale)
    *lead, d = x.shape
    x2 = x.reshape(-1, d)
    out_dtype = _out_dtype("q4a8_matmul", out_dtype or x.dtype)
    if x2.shape[0] > W4A8_PROLOGUE_MAX_ROWS:
        xq, xs = quant_rows(x2)
        return w4a8_gemv(xq, xs, packed, scale, out_dtype).reshape(*lead, packed.shape[0])
    _prologue_rows("q4a8_matmul", x2, packed, scale)
    m, o = x2.shape[0], packed.shape[0]
    out = torch.empty((m, o), dtype=out_dtype, device=x.device)
    lib = _build.load_library()
    rc = lib.pg_q4a8_gemv(
        x2.data_ptr(), x2.stride(0), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
        m, o, d, int(out_dtype == torch.float32), _stream(x),
    )
    _build.check(lib, "q4a8_matmul", rc)
    w4a8_gemv.launches += 1
    return out.reshape(*lead, o)


def w4a8_geglu_plain(x: torch.Tensor, gu_packed: torch.Tensor, gu_scale: torch.Tensor) -> torch.Tensor:
    """Plain version of ``w4a8_geglu`` (any device)."""
    *lead, d = x.shape
    xq, xs = quant_rows_plain(x.reshape(-1, d))
    h = geglu(w4a8_gemv_plain(xq, xs, gu_packed, gu_scale, x.dtype))
    return h.reshape(*lead, gu_packed.shape[0] // 2)


def w4a8_geglu(x: torch.Tensor, gu_packed: torch.Tensor, gu_scale: torch.Tensor) -> torch.Tensor:
    """The first half of ``mlp_w4a8``: x (..., D) bf16 -> per-row int8 -> @
    the fused [gate | up] packed int4 (2I, D/2)^T with its row scales (2I,)
    -> fp32 tanh-GELU of gate, rounded to bf16, times up -> h (..., I) bf16,
    one launch (the GeGLU in the GEMV's epilogue). Takes at most 8 rows (the
    kernel quantizes x in its prologue); ``mlp_w4a8`` calls it up to
    ``W4A8_PROLOGUE_MAX_ROWS`` rows."""
    if x.device.type == "cpu":
        return w4a8_geglu_plain(x, gu_packed, gu_scale)
    refuse_grad("w4a8_geglu", x, gu_packed, gu_scale)
    *lead, d = x.shape
    x2 = x.reshape(-1, d)
    if gu_packed.shape[0] % 2:
        raise ValueError("w4a8_geglu: the fused [gate | up] weight needs an even row count")
    _prologue_rows("w4a8_geglu", x2, gu_packed, gu_scale)
    m, inter = x2.shape[0], gu_packed.shape[0] // 2
    h = torch.empty((m, inter), dtype=torch.bfloat16, device=x.device)
    lib = _build.load_library()
    rc = lib.pg_w4a8_geglu(
        x2.data_ptr(), x2.stride(0), gu_packed.data_ptr(), gu_scale.data_ptr(), h.data_ptr(),
        m, inter, d, _stream(x),
    )
    _build.check(lib, "w4a8_geglu", rc)
    w4a8_geglu.launches += 1
    return h.reshape(*lead, inter)


w4a8_geglu.launches = 0


def mlp_w4a8_plain(
    x: torch.Tensor, gu_packed: torch.Tensor, gu_scale: torch.Tensor,
    dn_packed: torch.Tensor, dn_scale: torch.Tensor,
) -> torch.Tensor:
    """Plain version of ``mlp_w4a8`` (any device)."""
    return q4a8_matmul_plain(w4a8_geglu_plain(x, gu_packed, gu_scale), dn_packed, dn_scale)


def mlp_w4a8(
    x: torch.Tensor, gu_packed: torch.Tensor, gu_scale: torch.Tensor,
    dn_packed: torch.Tensor, dn_scale: torch.Tensor,
) -> torch.Tensor:
    """GeGLU MLP ``down(gelu_tanh(gate(x)) * up(x))`` with both weights in
    w4a8. Port of ``mlp_w4a8`` and ``mlp_w4a8_stacked`` (a layer of a
    stacked tensor is a view here, so one function serves both). Up to
    ``W4A8_PROLOGUE_MAX_ROWS`` rows two launches on one stream:
    ``w4a8_geglu`` into an (M, I) bf16 scratch, then the down GEMV, which
    quantizes it in its prologue. More rows four: quant_rows, the gate_up
    GEMV into an (M, 2I) scratch, quant_rows with the GeGLU prologue, the
    down GEMV."""
    if x.device.type == "cpu":
        return mlp_w4a8_plain(x, gu_packed, gu_scale, dn_packed, dn_scale)
    refuse_grad("mlp_w4a8", x, gu_packed, gu_scale, dn_packed, dn_scale)
    *lead, d = x.shape
    x2 = x.reshape(-1, d)
    if x2.shape[0] <= W4A8_PROLOGUE_MAX_ROWS:
        y = q4a8_matmul(w4a8_geglu(x2, gu_packed, gu_scale), dn_packed, dn_scale)
    else:
        xq, xs = quant_rows(x2)
        gu = w4a8_gemv(xq, xs, gu_packed, gu_scale, x.dtype)
        hq, hs = quant_rows(gu, geglu_prologue=True)
        y = w4a8_gemv(hq, hs, dn_packed, dn_scale, x.dtype)
    return y.reshape(*lead, dn_packed.shape[0])


# ---------------------------------------------------------------------------
# Checks shared by the wrappers
# ---------------------------------------------------------------------------


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _out_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: the kernel writes bf16 or fp32, not {dtype}")
    return dtype


def _check_rows(name: str, x: torch.Tensor, d_multiple: int) -> None:
    """A 2-d bf16 activation on a CUDA device with 16-byte aligned rows."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: activations must be on a CUDA device, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bf16 activations, got {x.dtype}")
    if x.dim() != 2 or x.stride(-1) != 1:
        raise ValueError(f"{name}: rows with a unit stride required")
    if x.shape[-1] % d_multiple or x.stride(0) % 8 or x.data_ptr() % 16:
        raise ValueError(
            f"{name}: the row width ({x.shape[-1]}) must be a multiple of {d_multiple} "
            "and rows 16-byte aligned"
        )


def _check_weight(name, x, w, scale, dtype, shape) -> None:
    if w.device != x.device or scale.device != x.device:
        raise ValueError(f"{name}: weights must be on the activations' device {x.device}")
    if w.dtype != dtype or tuple(w.shape) != tuple(shape) or not w.is_contiguous():
        raise ValueError(
            f"{name}: weight must be contiguous {dtype} of shape {tuple(shape)}, "
            f"got {w.dtype} {tuple(w.shape)}"
        )
    if w.data_ptr() % 16:
        raise ValueError(f"{name}: the weight must be 16-byte aligned")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (shape[0],) or not scale.is_contiguous():
        raise ValueError(f"{name}: scale must be contiguous fp32 of shape ({shape[0]},)")


_COUNTED = (q8_matmul, q4_matmul, w4a8_gemv, w4a8_geglu, quant_rows)


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _COUNTED}


def add_launch_counts(counts: Mapping[str, int]) -> None:
    """Add ``counts[name]`` to the launch count of each kernel named there,
    and ``counts["a8_matmul"]`` to ``a8_matmul``'s call count."""
    for fn in _COUNTED:
        fn.launches += counts.get(fn.__name__, 0)
    a8_matmul.calls += counts.get("a8_matmul", 0)


def reset_launch_counts() -> None:
    """Zero every launch count, and ``a8_matmul``'s call count."""
    for fn in _COUNTED:
        fn.launches = 0
    a8_matmul.calls = 0

"""Flash and decode attention: hand-written CUDA kernels and their plain versions.

Port of ``paligemma_tpu/ops/pallas_attention.py``. Each public function
dispatches on the device of its query tensor:

- a CPU tensor takes the plain PyTorch version beside it (``*_plain``),
- a CUDA tensor launches the kernel from ``paligemma_tpu_torch/csrc`` or
  raises; there is no fallback.

Each wrapper counts its kernel launches in its ``launches`` attribute, so a
run can show that it went through the kernels (``reset_launch_counts``).
The model functions reach these through ``ops.kernels.KernelFns``.

The plain versions compute what the kernels compute, unblocked: fp32 scores
times ``scale``, invisible positions set to ``NEG_INF``, and

- flash: unnormalized ``P`` (masked entries zeroed) rounded to the value
  dtype, fp32 ``P @ V``, then divided by the fp32 row sum;
- decode: ``P`` normalized first, then rounded to the value dtype, then
  fp32 ``P @ V``; query ``i`` of a verify call (T > 1) sees one position
  more than query ``i - 1`` (``decode_attention``). An int8 cache (with
  its per-row ``k_scale`` / ``v_scale``) is first dequantized as the
  reference reads it: values and scales each cast to the query dtype,
  their product rounded to it.

Visibility follows ``ops.attention.LengthMask``: batch row ``b`` sees kv
positions ``[0, valid_len[b]) ∪ [gen_start, gen_end)``. The plain versions
take each window bound as a host int or a one-element tensor on any device;
the flash kernel takes host ints, the decode kernel a host ``gen_start``
and a host or device ``gen_end``.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple, Union

import torch

from paligemma_tpu_torch.ops import _build
from paligemma_tpu_torch.ops.attention import MASK_VALUE as NEG_INF
from paligemma_tpu_torch.ops.attention import LengthMask

MAX_HEAD_DIM = 256
# The dynamic shared memory a block may take on an sm_90 card (the kernel
# library is built for sm_90a only).
MAX_SHARED_BYTES = 232448

ValidLen = Optional[Union[int, torch.Tensor]]
Window = Optional[Union[int, torch.Tensor]]


def _window(gen_start: Window, gen_end: Window) -> Tuple[int, int]:
    """The shared window as host ints (a CUDA tensor would need a sync)."""
    out = []
    for x in (gen_start, gen_end):
        if isinstance(x, torch.Tensor):
            if x.device.type != "cpu":
                raise TypeError("gen_start/gen_end must be host ints or CPU tensors")
            x = int(x)
        out.append(0 if x is None else int(x))
    return out[0], out[1]


def _device_window_end(gen_end: Window, q: torch.Tensor) -> Optional[torch.Tensor]:
    """``gen_end`` as the decode kernel reads it on the device: a one-element
    int32 tensor on q's device, or None when it is a host value."""
    if not isinstance(gen_end, torch.Tensor) or gen_end.device.type == "cpu":
        return None
    if gen_end.device != q.device or gen_end.dtype != torch.int32 or gen_end.numel() != 1:
        raise ValueError(f"decode_attention: a device gen_end must be one int32 on {q.device}")
    return gen_end.reshape(1).contiguous()


def _plain_bound(x: Window) -> Union[int, torch.Tensor]:
    """A window bound for the plain versions: 0 for None, a host int, or a
    one-element tensor on any device, compared on the device."""
    if x is None:
        return 0
    if isinstance(x, torch.Tensor):
        return x.reshape(())
    return int(x)


def _valid(valid_len: ValidLen, b: int, s_len: int, device) -> torch.Tensor:
    """(B,) int32 visible-prefix lengths on ``device``."""
    if valid_len is None:
        return torch.full((b,), s_len, dtype=torch.int32, device=device)
    valid = torch.as_tensor(valid_len, dtype=torch.int32, device=device).reshape(-1)
    if valid.shape[0] == 1 and b > 1:
        valid = valid.expand(b)
    if valid.shape[0] != b:
        raise ValueError(f"valid_len has {valid.shape[0]} rows for batch {b}")
    return valid.contiguous()


def _masked_scores(
    q: torch.Tensor, k: torch.Tensor, valid_len: ValidLen, scale: Optional[float],
    gen_start: Window, gen_end: Window, per_query: bool = False,
) -> torch.Tensor:
    """fp32 grouped scores (B, Hkv, G, T, S) times ``scale``; the additive
    ``LengthMask`` puts every invisible position at exactly ``NEG_INF``.
    ``per_query``: query ``i`` sees ``[0, valid[b] + i)`` and the window (the
    verify step's threshold), else every query sees ``[0, valid[b])`` and it."""
    b, t, h, d = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    scale = d**-0.5 if scale is None else scale
    valid = _valid(valid_len, b, s_len, q.device)
    if per_query:
        rows = (valid[:, None] + torch.arange(t, dtype=torch.int32, device=q.device)).reshape(-1)
        mask = LengthMask(rows, _plain_bound(gen_start), _plain_bound(gen_end)).materialize(s_len)
        mask = mask.reshape(b, t, 1, 1, s_len).permute(0, 2, 3, 1, 4)  # (B, 1, 1, T, S)
    else:
        mask = LengthMask(valid, _plain_bound(gen_start), _plain_bound(gen_end)).materialize(s_len)
    qg = q.reshape(b, t, hkv, h // hkv, d)
    return torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * scale + mask


def _apply_pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """fp32 (B, T, H, D) from probabilities (B, Hkv, G, T, S) rounded to v.dtype."""
    b, hkv, g, t, _ = p.shape
    acc = torch.einsum("bkgts,bskd->btkgd", p.to(v.dtype).float(), v.float())
    return acc.reshape(b, t, hkv * g, -1)


# ---------------------------------------------------------------------------
# Flash attention (SigLIP, Gemma prefill)
# ---------------------------------------------------------------------------


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid_len: ValidLen = None,
    scale: Optional[float] = None,
    gen_start: Window = None,
    gen_end: Window = None,
) -> torch.Tensor:
    """Plain version of ``flash_attention`` (any device)."""
    b, t, h, _ = q.shape
    s = _masked_scores(q, k, valid_len, scale, gen_start, gen_end)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > NEG_INF * 0.5, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)  # (B, Hkv, G, T, 1)
    acc = _apply_pv(p, v)
    l = l.permute(0, 3, 1, 2, 4).reshape(b, t, h, 1)
    return (acc / l).to(q.dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid_len: ValidLen = None,
    scale: Optional[float] = None,
    gen_start: Window = None,
    gen_end: Window = None,
) -> torch.Tensor:
    """Bidirectional (prefix-LM) attention with GQA.

    q: (B, T, H, D); k, v: (B, S, Hkv, D) with H % Hkv == 0. ``valid_len``:
    None, an int or a (B,) int tensor. Returns (B, T, H, D) in q.dtype.

    Under grad mode with an input that requires grad, the call goes through
    ``FlashAttentionFn`` (``FlashAttentionPlainFn`` on the CPU), which gives
    it a gradient; otherwise it is one launch, or the plain version on the
    CPU.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        fn = FlashAttentionPlainFn if q.device.type == "cpu" else FlashAttentionFn
        return fn.apply(q, k, v, valid_len, scale, gen_start, gen_end)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, valid_len, scale, gen_start, gen_end)
    out = launch_flash(q, k, v, valid_len, scale, gen_start, gen_end)
    flash_attention.launches += 1
    return out


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward is one launch of the
    flash kernel (the bits of the call without grad, counted as a launch);
    the backward is the gradient of ``flash_attention_plain``'s function,
    recomputed from the saved q, k, v and mask arguments with
    ``torch.autograd.grad`` through the plain version (fp32 scores and
    softmax, as the reference's trainer differentiates its XLA attention).
    It launches no kernel of the port."""

    @staticmethod
    def _forward(q, k, v, valid_len, scale, gen_start, gen_end):
        out = launch_flash(q, k, v, valid_len, scale, gen_start, gen_end)
        flash_attention.launches += 1
        return out

    @classmethod
    def forward(cls, ctx, q, k, v, valid_len=None, scale=None, gen_start=None, gen_end=None):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (valid_len, scale, gen_start, gen_end)
        return cls._forward(q, k, v, valid_len, scale, gen_start, gen_end)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = (x.detach().requires_grad_() for x in ctx.saved_tensors)
        with torch.enable_grad():
            out = flash_attention_plain(q, k, v, *ctx.mask)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad_out)
        return (dq, dk, dv) + (None,) * 4


class FlashAttentionPlainFn(FlashAttentionFn):
    """``FlashAttentionFn`` with the plain forward (any device): the same
    backward, so the CPU holds it to the reference."""

    @staticmethod
    def _forward(q, k, v, valid_len, scale, gen_start, gen_end):
        return flash_attention_plain(q, k, v, valid_len, scale, gen_start, gen_end)


def refuse_grad(name: str, *xs) -> None:
    """Raise before a launch when a kernel without a backward would end the
    autograd graph: grad mode is on and one of ``xs`` requires grad."""
    if torch.is_grad_enabled() and any(isinstance(x, torch.Tensor) and x.requires_grad for x in xs):
        raise ValueError(f"{name}: the CUDA kernel has no backward; call it under torch.no_grad() "
                         "or on inputs that do not require grad")


def launch_flash(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid_len: ValidLen = None,
    scale: Optional[float] = None, gen_start: Window = None, gen_end: Window = None, lib=None,
) -> torch.Tensor:
    """One launch of ``pg_flash_attention`` on CUDA tensors, from the port's
    kernel library or from ``lib``, a build of another version of
    ``csrc/flash_attention.cu`` (``scripts/flash_variants.py``); counts nothing."""
    b, t, h, d = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    _check_cuda("flash_attention", q, k, v, h, hkv, d)
    if v.shape != k.shape or k.shape[0] != b or t < 1 or s_len < 1:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    scale = d**-0.5 if scale is None else scale
    win = _window(gen_start, gen_end)
    valid = None if valid_len is None else _valid(valid_len, b, s_len, q.device)
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load_library() if lib is None else lib
    rc = lib.pg_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if valid is None else valid.data_ptr(),
        b, t, s_len, h, hkv, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        win[0], win[1], float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, "flash_attention", rc)
    return out


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# Decode attention (one query, or a verify step's T, against the KV cache)
# ---------------------------------------------------------------------------

# The most queries a batch row that ``decode_attention`` takes on CUDA (the
# drafts of a verify step).
MAX_DECODE_QUERIES = 16


def dequantize_cache(c: torch.Tensor, c_scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, S, Hkv, D) int8 rows with (B, S, Hkv) fp32 scales -> ``dtype``, as
    the reference reads its int8 cache: ``c.astype(dtype) * scale.astype(dtype)``."""
    return c.to(dtype) * c_scale.to(dtype)[..., None]


def decode_attention_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid_len: ValidLen,
    scale: Optional[float] = None,
    gen_start: Window = None,
    gen_end: Window = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of ``decode_attention`` (any device, any T)."""
    if k_scale is not None:
        k_cache = dequantize_cache(k_cache, k_scale, q.dtype)
        v_cache = dequantize_cache(v_cache, v_scale, q.dtype)
    s = _masked_scores(q, k_cache, valid_len, scale, gen_start, gen_end, per_query=True)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return _apply_pv(p, v_cache).to(q.dtype)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid_len: ValidLen,
    scale: Optional[float] = None,
    gen_start: Window = None,
    gen_end: Window = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """GQA attention of a decode step (T = 1) or a speculative verify step
    (T > 1) against the preallocated cache.

    q: (B, T, H, D) this step's queries (RoPE applied), 1 <= T <=
    ``MAX_DECODE_QUERIES`` on CUDA; query ``i`` of row ``b`` sees the
    positions ``[0, valid_len[b] + i)`` and the window (T = 1: the decode
    step's ``[0, valid_len[b])``). k_cache, v_cache:
    (B, S, Hkv, D), typically one layer's view of the (L, B, S, Hkv, D)
    cache, read through their strides: in q.dtype, or int8 with the
    (B, S, Hkv) fp32 row scales ``k_scale`` and ``v_scale`` (views of the
    int8 cache's scales). Returns (B, T, H, D) in q.dtype. One launch: a
    thread-block cluster per (batch row, query, kv head) holds the row's
    scores in shared memory, so a longer cache than ``decode_max_len(H // Hkv, D)``
    positions (25600 at 8 query heads a kv head and head_dim 256) raises a
    ``ValueError`` before any launch. The result depends on the visible
    rows, not on S: the same q and visible rows in a longer buffer give the
    same bits, and query ``i`` of a verify call gives the bits of a T = 1
    call at visible length ``valid_len[b] + i``. ``gen_start`` is a host
    int; ``gen_end`` a host int or a one-element int32 tensor on q's
    device, which the kernel reads there (batched serving's window end
    moves every step of a captured graph).
    """
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k_cache, v_cache, valid_len, scale, gen_start, gen_end, k_scale, v_scale
        )
    refuse_grad("decode_attention", q, k_cache, v_cache)
    b, t, h, d = q.shape
    s_len, hkv = k_cache.shape[1], k_cache.shape[2]
    kv8 = k_scale is not None or v_scale is not None
    _check_cuda("decode_attention", q, k_cache, v_cache, h, hkv, d, torch.int8 if kv8 else torch.bfloat16)
    for sc in (k_scale, v_scale) if kv8 else ():
        if (sc is None or sc.device != q.device or sc.dtype != torch.float32
                or tuple(sc.shape) != (b, s_len, hkv)):
            raise ValueError(
                f"decode_attention: an int8 cache needs k_scale and v_scale, fp32 "
                f"({b}, {s_len}, {hkv}) on {q.device}"
            )
    if not 1 <= t <= MAX_DECODE_QUERIES:
        raise ValueError(f"decode_attention: the kernel takes 1 to {MAX_DECODE_QUERIES} queries a row, got {t}")
    if v_cache.shape != k_cache.shape or k_cache.shape[0] != b or s_len < 1:
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)}, cache {tuple(k_cache.shape)}, {tuple(v_cache.shape)}"
        )
    if h // hkv > 8:
        raise ValueError(f"decode_attention: the kernel takes at most 8 query heads per kv head, got {h // hkv}")
    if _decode_shared_bytes(s_len, h // hkv, d) > MAX_SHARED_BYTES:
        raise ValueError(
            f"decode_attention: a cache of {s_len} positions does not fit the kernel's shared memory; "
            f"the longest it takes at {h // hkv} query heads a kv head and head_dim {d} is "
            f"{decode_max_len(h // hkv, d)}"
        )
    scale = d**-0.5 if scale is None else scale
    win_end = _device_window_end(gen_end, q)
    win = _window(gen_start, None if win_end is not None else gen_end)
    valid = None if valid_len is None else _valid(valid_len, b, s_len, q.device)
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load_library()
    rc = lib.pg_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        None if valid is None else valid.data_ptr(),
        b, t, s_len, h, hkv, d,
        q.stride(0), q.stride(1), q.stride(2),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        *((k_scale.data_ptr(), v_scale.data_ptr(), *k_scale.stride(), *v_scale.stride())
          if kv8 else (None, None, 0, 0, 0, 0, 0, 0)),
        win[0], win[1], None if win_end is None else win_end.data_ptr(), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, "decode_attention", rc)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _decode_tiles(s_len: int) -> int:
    """The 64-row tiles of the decode kernel's fullest block at cache length
    ``s_len``: a cluster of the smallest power of two C with 64 C >= S (at
    most 16), tile i in block i mod C (``csrc/decode_attention.cu``)."""
    c = 1
    while c < 16 and 64 * c < s_len:
        c *= 2
    return -(-_round_up(s_len, 64) // 64 // c)


def _decode_shared_bytes(s_len: int, g: int, d: int) -> int:
    """The decode kernel's dynamic shared memory a block, by its ``Layout``:
    the queries, the partial outputs, the k parts' sums, the statistics,
    fp32 scores and bf16 probabilities of the block's tiles, and a ring of
    four 64-row bf16 tiles."""
    dp, pl = _round_up(d, 16), 64 * _decode_tiles(s_len)
    part = _round_up(2 * 8 * (dp + 8), 16)
    red = part + _round_up(4 * g * d, 16)
    stats = red + 4 * 12 * 4 * 32
    scores = stats + _round_up(16 * g, 16)
    probs = scores + _round_up(4 * g * pl, 16)
    ring = probs + _round_up(2 * 8 * (pl + 8), 16)
    return ring + 4 * 64 * (2 * dp + 16)


def decode_max_len(g: int, d: int) -> int:
    """The longest cache ``decode_attention`` takes on CUDA with ``g`` query
    heads a kv head and head_dim ``d``: 1024 positions a tile of the
    16-block cluster's fullest block, as many tiles as shared memory holds."""
    tiles = 1
    while _decode_shared_bytes(1024 * (tiles + 1), g, d) <= MAX_SHARED_BYTES:
        tiles += 1
    return 1024 * tiles


def _check_cuda(name: str, q, k, v, h: int, hkv: int, d: int, kv_dtype=torch.bfloat16) -> None:
    """Raise on any input the CUDA kernels do not take (K/V in ``kv_dtype``)."""
    for x, dtype in ((q, torch.bfloat16), (k, kv_dtype), (v, kv_dtype)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name}: tensors must share one CUDA device")
        if x.dtype != dtype:
            raise TypeError(f"{name}: the kernel takes bf16 queries and {kv_dtype} K/V, got {x.dtype}")
        if x.dim() != 4 or x.stride(-1) != 1:
            raise ValueError(f"{name}: 4-d tensors with a unit stride on head_dim required")
        # Vector loads of 8 values along head_dim (16 bytes of bf16, 8 of int8).
        if x.data_ptr() % (8 * x.element_size()) or any(st % 8 for st in x.stride()[:3]):
            raise ValueError(f"{name}: rows must be aligned to 8 values (strides a multiple of 8)")
    if k.shape[3] != d or d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {d} must be a multiple of 8 in [8, {MAX_HEAD_DIM}]")
    if hkv < 1 or h % hkv:
        raise ValueError(f"{name}: {h} query heads do not group over {hkv} kv heads")


_COUNTED = (flash_attention, decode_attention)


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _COUNTED}


def add_launch_counts(counts: Mapping[str, int]) -> None:
    """Add ``counts[name]`` to the launch count of each kernel named there."""
    for fn in _COUNTED:
        fn.launches += counts.get(fn.__name__, 0)


def reset_launch_counts() -> None:
    for fn in _COUNTED:
        fn.launches = 0

"""Gemma decoder (port of ``paligemma_tpu/models/gemma.py``), bf16/fp32 path.

Token embedding scaled by sqrt(hidden) in the activation dtype, pre-RMSNorm
blocks (input_ln -> GQA attention -> +res -> post_ln -> GeGLU MLP -> +res),
final RMSNorm, fp32 logits through the tied embedding.

- The KV cache is preallocated, ``(L, B, max_len, Hkv, hd)``, with its
  length on the device, a 0-d int32 tensor, as the reference's. Forward
  writes this step's K/V IN PLACE at that length (``index_copy_`` with a
  device index, the counterpart of ``dynamic_update_slice``) and advances
  it on the device (JAX returns a new cache instead). A decode step reads
  nothing back to the host, so it can be captured in a CUDA graph and
  replayed (``generation.py``). A host mirror, ``host_length``, serves
  only the bounds checks; forward advances it, and so does a caller that
  replays captured steps.
- Prefill (T > 1) writes K/V into the (empty) cache, then attends over the
  fresh K/V only with ``flash_attention`` (bidirectional prefix-LM,
  all-zeros mask).
- Decode (T == 1) attends over the whole cache buffer with
  ``decode_attention``; unwritten slots are masked by the per-row valid
  length, a preallocated (B,) int32 device tensor set from the device
  length, or by the caller's ``LengthMask`` (batched serving).
- The speculative verify step (``multi_token_decode``) is T > 1 tokens
  over a warm cache: their K/V are written at ``length + arange(T)`` and
  the T queries go to ``decode_attention`` with ``valid = length + 1``,
  so query i sees ``[0, length + i]`` (the reference's per-query
  threshold). The length advances by T; the caller rolls it back to the
  accepted count, and ``host_length`` is then an upper bound until the
  caller sets it.
- Per-row lengths (``row_lengths``, continuous batching: each row a slot
  at its own length) replace the shared length: row b writes at
  ``row_lengths[b]`` (``+ arange(T)`` in the verify shape, ``index_put_``
  with (B, T) row and position indices) and sees
  ``[0, row_lengths[b] + 1 + i)``; ``cache.length`` is neither read nor
  advanced. A write position past the buffer is clamped to the row's last
  position (an index past the buffer would be a device-side assert on
  CUDA): only a row whose length passed the buffer writes there, a free
  slot that nothing reads until a join rewrites its rows and length. The
  bounds check of the rows that matter is the caller's, on its host
  mirror of their lengths (``check_row_room``).
- Without a cache, ``forward`` is the full bidirectional pass of the
  no-cache ablation arm, under an optional per-row ``LengthMask``.
- The int8 cache (``QuantKVCache``, ``init_cache(dtype=torch.int8)``) keeps
  each written K and V row as int8 with one fp32 scale
  (``quantize_kv_rows``). Prefill still attends over its fresh, unquantized
  K/V; decode reads the int8 rows, dequantized as the reference does.
- q/k/v and gate/up are fused projections, stored in ``nn.Linear``'s
  (out, in) layout. ``quantization.quantize_params`` swaps them for
  ``QLinear`` (int8), ``Q4Linear`` (int4 weight-only) or ``W4A8Linear``
  (int4 with int8 activations) modules; ``proj`` dispatches the float,
  int8 and int4 types, and the MLP routes w4a8 calls of up to
  ``MLP_FUSED_MAX_ROWS`` rows to the fused MLP and larger ones to the int8
  companions, as the reference does. An int8 embedding makes the trunk bf16
  (its lookup is bf16) and gives fp32 logits through ``q8``.
- LoRA adapters on the q/k/v projections (``lora``, the reference's
  ``_lora_delta``): ``scale * (drop(x) @ A) @ B`` added to each projection's
  output after the fused qkv split and before RoPE. Adapters are a dict
  ``{"q"|"k"|"v": {"a": (L, D, r), "b": (L, r, out)}}`` shared by every row,
  or ``(L, B, D, r)`` / ``(L, B, r, out)`` per row (continuous serving's
  slots). Their products are PyTorch ``matmul`` calls, as the reference's
  are XLA einsums outside its kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from paligemma_tpu_torch import quantization
from paligemma_tpu_torch.config import GemmaConfig
from paligemma_tpu_torch.ops.attention import LengthMask
from paligemma_tpu_torch.ops.kernels import KERNELS, KernelFns
from paligemma_tpu_torch.ops.quant import MLP_FUSED_MAX_ROWS, geglu, quantize_rows_s8_rcp
from paligemma_tpu_torch.ops.norms import rms_norm
from paligemma_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from paligemma_tpu_torch.parallel import comm
from paligemma_tpu_torch.quantization import Q4Linear, QLinear, W4A8Linear, qproj


@dataclasses.dataclass
class KVCache:
    """Preallocated per-layer KV cache on the device.

    k, v: (num_layers, batch, max_len, kv_heads, head_dim).
    length: () int32 device tensor, the number of written positions.
    valid: (batch,) int32 device tensor, the decode kernel's visible length.
    host_length: host mirror of ``length`` for the bounds checks.
    graphs: the prefill and decode graphs captured on these buffers
    (``generation.py``), shared by every ``KVCache`` object over them.
    """

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor
    valid: torch.Tensor
    host_length: int = dataclasses.field(default=0, kw_only=True)
    graphs: dict = dataclasses.field(default_factory=dict, kw_only=True, compare=False, repr=False)

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


@dataclasses.dataclass
class QuantKVCache(KVCache):
    """The int8 cache (port of ``QuantKVCache``): k, v int8 (L, B, S, Hkv,
    hd) and one fp32 scale per written row, k_scale, v_scale (L, B, S, Hkv)."""

    k_scale: torch.Tensor
    v_scale: torch.Tensor


# (..., hd) -> ((..., hd) int8, (...) fp32 per-row scale): the reference's
# jitted quantize_kv_rows is quantize_rows_s8_rcp's arithmetic, to the bit.
quantize_kv_rows = quantize_rows_s8_rcp


def init_cache(
    cfg: GemmaConfig, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda"
) -> KVCache:
    """Preallocated cache; ``dtype=torch.int8`` returns a ``QuantKVCache``."""
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads, cfg.head_dim)
    k = torch.zeros(shape, dtype=dtype, device=device)
    v = torch.zeros(shape, dtype=dtype, device=device)
    length = torch.zeros((), dtype=torch.int32, device=device)
    valid = torch.zeros(batch, dtype=torch.int32, device=device)
    if dtype == torch.int8:
        k_scale = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        return QuantKVCache(k, v, length, valid, k_scale, torch.zeros_like(k_scale))
    return KVCache(k, v, length, valid)


def reset_cache(cache: KVCache) -> KVCache:
    """A new ``KVCache`` object over ``cache``'s buffers, zeroed and empty,
    that shares its captured graphs; ``cache`` must be out of use."""
    for f in dataclasses.fields(cache):
        x = getattr(cache, f.name)
        if isinstance(x, torch.Tensor):
            x.zero_()
    return dataclasses.replace(cache, host_length=0)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, dtype=dtype))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


def proj(x: torch.Tensor, w: nn.Module, fns: KernelFns) -> torch.Tensor:
    """``x @ W^T`` in x.dtype for a bias-free float, int8 or int4 projection
    (the reference's ``_proj``; w4a8 weights are routed by ``mlp`` and
    ``logits``)."""
    if isinstance(w, QLinear):
        return qproj(x, w, fns)
    if isinstance(w, Q4Linear):
        return fns.q4(x, w.packed, w.scale)
    return F.linear(x, w.weight)


def row_parallel(x: torch.Tensor, w: nn.Module, fns: KernelFns, tp: comm.ModelParallel,
                 seq: int = 0) -> torch.Tensor:
    """A row-parallel product under TP (x and w hold this rank's slice of
    the contraction): the partial products reduced over the model group
    (reduce-scattered along T with ``seq``, the sequence's length) in fp32
    and rounded once to x.dtype, as the whole product is rounded once. An
    int8 x int8 call (``prefill_a8``) reduces the rows' absmax (a max) and
    its int32 sums (exact; reduce-scattered along T with ``seq``, each rank
    then rescaling its own rows), so every rank gets the whole product's
    bits. ``w``: float, int8 or int4 (not bias-added)."""
    if isinstance(w, QLinear) and w.prefill_a8 and x.shape[-2] >= quantization.A8_MIN_SEQ:
        g = tp.group
        acc_reduce, row_select = (lambda a: comm.all_reduce(a, g)), None
        if seq:
            acc_reduce, row_select = (lambda a: comm.scatter_seq(a, g)), (lambda s: comm.seq_shard(s, g))
        return fns.a8(x, w.weight, w.scale, amax_reduce=lambda a: comm.all_reduce_max(a, g),
                      acc_reduce=acc_reduce, row_select=row_select)
    if isinstance(w, QLinear):
        y = fns.q8(x, w.weight, w.scale, out_dtype=torch.float32)
    elif isinstance(w, Q4Linear):
        y = fns.q4(x, w.packed, w.scale, out_dtype=torch.float32)
    else:
        y = wide_linear(x, w.weight)
    return tp.leave(y, seq).to(x.dtype)


def wide_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w^T`` accumulated and returned in fp32 (..., O) without
    rounding through x.dtype: on CUDA ``torch.mm(..., out_dtype=float32)``
    from the bf16 operands (under autograd ``_WideLogits``, which gives it
    a gradient for x); elsewhere the operands are widened."""
    x2 = x.reshape(-1, x.shape[-1])
    if x2.is_cuda and x2.dtype != torch.float32:
        if torch.is_grad_enabled() and x2.requires_grad:
            out = _WideLogits.apply(x2, w)
        else:
            out = torch.mm(x2, w.t(), out_dtype=torch.float32)
    else:
        out = x2.float() @ w.float().t()
    return out.reshape(*x.shape[:-1], w.shape[0])


def lora_delta(
    x: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    scale: float,
    dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """LoRA update ``scale * (drop(x) @ A) @ B`` of x (B, T, D) in x.dtype
    (the reference's ``_lora_delta``).

    Shared adapters a (D, r), b (r, out), or per-row a (B, D, r),
    b (B, r, out). The adapters are rounded to x.dtype and each product is
    one ``matmul`` in x.dtype (fp32 accumulation, one rounding to x.dtype,
    as the reference's einsums with ``preferred_element_type=float32``),
    then times ``scale`` rounded to x.dtype (1.0: no product). An
    all-zeros row is an exact no-op. With ``dropout`` > 0 and a
    ``generator``, each element of x is kept with probability
    ``1 - dropout`` (drawn from the generator) and divided by it.
    """
    dt = x.dtype
    xl = x
    if dropout > 0.0 and generator is not None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - dropout
        xl = torch.where(keep, x / (1.0 - dropout), 0.0).to(dt)
    out = torch.matmul(torch.matmul(xl, a.to(dt)), b.to(dt))
    return out if scale == 1.0 else out * float(torch.tensor(scale, dtype=dt))


LORA_TARGETS = ("q", "k", "v")


class GemmaLayer(nn.Module):
    def __init__(self, cfg: GemmaConfig, dtype=None):
        super().__init__()
        d, i = cfg.hidden_size, cfg.intermediate_size
        h, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        self.cfg = cfg
        self.input_ln = RMSNorm(d, cfg.rms_norm_eps, dtype)
        self.qkv = nn.Linear(d, (h + 2 * hkv) * hd, bias=False, dtype=dtype)
        self.o = nn.Linear(h * hd, d, bias=False, dtype=dtype)
        self.post_ln = RMSNorm(d, cfg.rms_norm_eps, dtype)
        self.gate_up = nn.Linear(d, 2 * i, bias=False, dtype=dtype)  # fused gate | up
        self.down = nn.Linear(i, d, bias=False, dtype=dtype)
        # Tensor parallelism (parallel/sharding.py): the collectives around
        # the attention's and the MLP's products (None: unsharded). Where
        # the kv weights are replicated over the model group, qkv holds
        # all ``kv_weight_heads`` kv heads and this rank keeps the
        # ``cfg.num_key_value_heads`` from ``kv_first`` on, those its query
        # heads read.
        self.attn_tp: Optional[comm.ModelParallel] = None
        self.mlp_tp: Optional[comm.ModelParallel] = None
        self.kv_weight_heads, self.kv_first = hkv, 0

    def attention(self, x, cos, sin, cache: Optional[KVCache], pos, li: int, fns: KernelFns,
                  mask: Optional[LengthMask] = None, multi_decode: bool = False, lora=None,
                  lora_scale: float = 1.0, lora_dropout: float = 0.0,
                  lora_generator: Optional[torch.Generator] = None, seq: int = 0):
        """``pos``: the write positions, (T,) int64 shared by every row, or
        a pair of (B, T) int64 row and position indices (per-row lengths).
        ``lora``: this layer's adapters, ``{"q"|"k"|"v": (a, b)}``; each
        target draws its own dropout mask, in the order q, k, v. ``seq``
        (sequence parallelism): the sequence's T, x being this rank's shard
        of it padded to a multiple of the model group's size; 0 without."""
        cfg, tp = self.cfg, self.attn_tp
        if tp is not None:
            x = tp.enter(x, seq)
        b, t, _ = x.shape
        h, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        hkv_w = self.kv_weight_heads
        q, k, v = proj(x, self.qkv, fns).split([h * hd, hkv_w * hd, hkv_w * hd], dim=-1)
        if lora is not None:
            q, k, v = (y + lora_delta(x, *lora[name], lora_scale, lora_dropout, lora_generator)
                       for name, y in zip(LORA_TARGETS, (q, k, v)))
        k, v = k.view(b, t, hkv_w, hd), v.view(b, t, hkv_w, hd)
        if hkv_w != hkv:  # replicated kv weights: keep this rank's kv heads
            k, v = (y[:, :, self.kv_first:self.kv_first + hkv].contiguous() for y in (k, v))
        q = apply_rope(q.view(b, t, h, hd), cos, sin)
        k = apply_rope(k, cos, sin)
        scale = hd**-0.5
        window = {} if mask is None else {
            "valid_len": mask.valid, "gen_start": mask.gen_start, "gen_end": mask.gen_end}
        if cache is not None:
            # In place at the device positions ``pos``.
            k_st, v_st, row_scales = k, v, {}
            if isinstance(cache, QuantKVCache):
                (k_st, ks), (v_st, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
                _write(cache.k_scale[li], pos, ks)
                _write(cache.v_scale[li], pos, vs)
                row_scales = {"k_scale": cache.k_scale[li], "v_scale": cache.v_scale[li]}
            _write(cache.k[li], pos, k_st.to(cache.k.dtype))
            _write(cache.v[li], pos, v_st.to(cache.v.dtype))
            if t == 1 or multi_decode:  # over the cache (a verify step: T queries)
                window = {"valid_len": cache.valid, **window}
                out = fns.decode(q, cache.k[li], cache.v[li], scale=scale, **window, **row_scales)
                return self._out(out.reshape(b, t, h * hd), fns, seq)
        # Prefill, or the pass without a cache: bidirectional over the fresh,
        # unquantized K/V only (exact: nothing else is visible yet), under
        # the per-row mask when there is one (right-padded rows).
        out = fns.flash(q, k, v, scale=scale, **window)
        return self._out(out.reshape(b, t, h * hd), fns, seq)

    def _out(self, attn: torch.Tensor, fns: KernelFns, seq: int) -> torch.Tensor:
        """The o projection (row-parallel under TP)."""
        if self.attn_tp is None:
            return proj(attn, self.o, fns)
        return row_parallel(attn, self.o, fns, self.attn_tp, seq)

    def mlp(self, x: torch.Tensor, fns: KernelFns, seq: int = 0) -> torch.Tensor:
        """The GeGLU MLP; under TP gate_up is column-parallel (each rank its
        gate half and the matching up half) and down row-parallel. The w4a8
        fused MLP's weights stay whole on every rank (as the reference's),
        so its calls need no collective."""
        gu_w, dn_w = self.gate_up, self.down
        if isinstance(gu_w, W4A8Linear):
            if x.shape[0] * x.shape[1] <= MLP_FUSED_MAX_ROWS:
                return fns.mlp_w4a8(x, gu_w.packed, gu_w.scale, dn_w.packed, dn_w.scale)
            gu_w, dn_w = self.gate_up_i8, self.down_i8  # matrix-shaped calls
        tp = self.mlp_tp
        if tp is None:
            return proj(geglu(proj(x, gu_w, fns)), dn_w, fns)
        return row_parallel(geglu(proj(tp.enter(x, seq), gu_w, fns)), dn_w, fns, tp, seq)

    def forward(self, h, cos, sin, cache: Optional[KVCache], pos, li: int, fns: KernelFns,
                mask: Optional[LengthMask] = None, multi_decode: bool = False, lora=None,
                lora_scale: float = 1.0, lora_dropout: float = 0.0,
                lora_generator: Optional[torch.Generator] = None, seq: int = 0):
        h = h + self.attention(self.input_ln(h), cos, sin, cache, pos, li, fns, mask, multi_decode,
                               lora, lora_scale, lora_dropout, lora_generator, seq)
        return h + self.mlp(self.post_ln(h), fns, seq)


class GemmaModel(nn.Module):
    def __init__(self, cfg: GemmaConfig, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size, dtype=dtype))
        self.layers = nn.ModuleList(GemmaLayer(cfg, dtype) for _ in range(cfg.num_hidden_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)
        # Set by quantization.quantize_params(mode="w4a8"): the 4-bit lm_head
        # copy, and whether calls of up to 64 rows use it.
        self.embed_w4: Optional[W4A8Linear] = None
        self.lm_head_w4 = False
        # Vocab parallelism (parallel/sharding.py): the embedding holds rows
        # [vocab_start, vocab_start + rows) and lookups and logits go
        # through the model group (None: the whole table).
        self.vocab_tp: Optional[comm.ModelParallel] = None
        self.vocab_start = 0


def activation_dtype(model: GemmaModel) -> torch.dtype:
    """The trunk's dtype: that of the text embeddings (bf16 when the
    embedding is int8, as the reference's lookup gives)."""
    return torch.bfloat16 if isinstance(model.embed, QLinear) else model.embed.dtype


def forward(
    model: GemmaModel,
    inputs_embeds: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[KVCache] = None,
    fns: KernelFns = KERNELS,
    mask: Optional[LengthMask] = None,
    multi_token_decode: bool = False,
    row_lengths: Optional[torch.Tensor] = None,
    lora=None,
    lora_scale: float = 1.0,
    lora_dropout: float = 0.0,
    lora_generator: Optional[torch.Generator] = None,
    sequence_parallel: bool = False,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Decoder trunk: unscaled embeds (B, T, D) + (B, T) positions ->
    (final-normed hidden (B, T, D), the same cache advanced by T).

    With a cache, K/V are written at the device ``cache.length``; T == 1
    decodes over the cache, T > 1 is a prefill into an empty cache, or with
    ``multi_token_decode`` a verify step over the warm cache: query i sees
    the written positions up to its own, ``[0, length + i]``. Nothing
    is read back from the device: the checks use ``cache.host_length``.
    Without a cache, T positions attend to each other bidirectionally (the
    reference's no-cache pass).

    ``mask`` (an ``ops.attention.LengthMask``): row b sees kv positions
    ``[0, valid[b]) ∪ [gen_start, gen_end)``. On a prefill or the pass
    without a cache it masks each row's right padding (the window is
    empty); on a decode step it replaces the cache's own visible length
    (batched serving: each row's prompt plus the shared generated window,
    whose end may be a device tensor). None: every written position.

    ``row_lengths`` ((B,) int32 on the cache's device; T == 1, or T > 1
    with ``multi_token_decode``): each row at its own length, the
    reference's ``row_lengths``. Row b writes this step's K/V at
    ``row_lengths[b] + arange(T)`` (clamped to the buffer) and its query i
    sees ``[0, row_lengths[b] + 1 + i)``; RoPE positions are the caller's.
    The cache's shared length is neither read nor advanced, and the bounds
    check is the caller's (``check_row_room`` on its host mirror).

    ``lora``: q/k/v adapters (``{"layers": {...}}`` or the layers dict;
    shared or per row, see ``lora_delta``); layer ``li`` takes
    ``[li]`` of each. ``lora_dropout`` with ``lora_generator`` draws one
    mask a layer and target (training).

    ``sequence_parallel`` (a tensor-parallel model; a prefill or the pass
    without a cache): the residual stream between blocks is this rank's
    ``1 / size`` of T (padded with zero rows to a multiple of the size),
    gathered before each column-parallel product and reduce-scattered
    after each row-parallel one; the final norm runs on the shard and the
    hidden states are gathered along T at the end. Every product,
    attention and cache write sees the T real rows only (``comm.py``).
    """
    cfg = model.cfg
    dtype = inputs_embeds.dtype
    b, t, _ = inputs_embeds.shape
    # sqrt(hidden) rounded to the activation dtype, as a host scalar.
    h = inputs_embeds * float(torch.tensor(cfg.hidden_size**0.5, dtype=dtype))
    cos, sin = rope_cos_sin(
        positions, cfg.head_dim, cfg.rope_theta, cfg.max_position_embeddings, dtype
    )
    pos = None
    if multi_token_decode and (cache is None or mask is not None):
        raise ValueError("multi_token_decode needs a cache and no mask")
    if row_lengths is not None:
        if cache is None or mask is not None or (t != 1 and not multi_token_decode) or sequence_parallel:
            raise ValueError("row_lengths needs a cache, no mask, T == 1 (or multi_token_decode) and no "
                             "sequence_parallel")
        cols = (row_lengths.long()[:, None] + _arange(t, row_lengths)).clamp_max(cache.max_len - 1)
        pos = (_arange(b, row_lengths)[:, None].expand(b, t), cols)
        cache.valid.copy_(row_lengths + 1)  # query i sees valid + i (decode_attention)
        for li, layer in enumerate(model.layers):
            h = layer(h, cos, sin, cache, pos, li, fns, None, True, _layer_lora(lora, li), lora_scale,
                      lora_dropout, lora_generator)
        return model.final_norm(h), cache
    if cache is not None:
        if t > 1 and not multi_token_decode and cache.host_length:
            raise ValueError("prefill (T > 1) needs an empty cache")
        if cache.host_length + t > cache.max_len:
            raise ValueError(f"cache full: {cache.host_length} + {t} > {cache.max_len}")
        pos = cache.length + _arange(t, cache.length)
        # A verify step's query i sees [0, length + 1 + i) (decode_attention).
        cache.valid.copy_((cache.length + (1 if multi_token_decode else t)).expand(b))
    seq = None
    if sequence_parallel:
        if multi_token_decode or model.layers[0].attn_tp is None:
            raise ValueError("sequence_parallel needs a tensor-parallel model and a prefill")
        seq = model.layers[0].attn_tp.group
        h = comm.seq_shard(h, seq)
    for li, layer in enumerate(model.layers):
        h = layer(h, cos, sin, cache, pos, li, fns, mask, multi_token_decode, _layer_lora(lora, li),
                  lora_scale, lora_dropout, lora_generator, 0 if seq is None else t)
    if cache is not None:
        cache.length.add_(t)
        cache.host_length += t
    h = model.final_norm(h)
    return (h if seq is None else comm.gather_seq(h, seq, t)), cache


def _layer_lora(lora, li: int):
    """Layer ``li``'s slices ``{target: (a, b)}`` of the stacked adapters."""
    if lora is None:
        return None
    layers = lora.get("layers", lora)
    return {name: (layers[name]["a"][li], layers[name]["b"][li]) for name in LORA_TARGETS}


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=like.device)


def _write(buf: torch.Tensor, pos, val: torch.Tensor) -> None:
    """Write ``val`` (B, T, ...) into ``buf`` (B, S, ...) at ``pos``: along
    dim 1 at shared positions (T,), or at per-row (row, position) pairs."""
    if isinstance(pos, tuple):
        buf.index_put_(pos, val)
    else:
        buf.index_copy_(1, pos, val)


def check_row_room(lengths: Sequence[int], t: int, max_len: int) -> None:
    """Raise ``ValueError`` if a row at one of these host lengths would write
    ``t`` positions past a buffer of ``max_len``."""
    top = max(lengths, default=0)
    if top + t > max_len:
        raise ValueError(f"cache full: a row at {top} + {t} > {max_len}")


def logits(model: GemmaModel, hidden: torch.Tensor, fns: KernelFns = KERNELS) -> torch.Tensor:
    """Tied lm_head, fp32 logits (B, T, V).

    The product is accumulated and returned in fp32 without rounding through
    the activation dtype (``wide_linear``).
    An int8 embedding goes through ``fns.q8`` with fp32 out; with
    ``lm_head_w4`` on, calls of up to 64 rows go through the 4-bit copy.
    Vocab-parallel (``model.vocab_tp``): each rank's slice of the vocab,
    gathered to every rank; the 4-bit copy is whole on every rank.
    """
    if model.lm_head_w4 and hidden.shape[0] * hidden.shape[1] <= MLP_FUSED_MAX_ROWS:
        w4 = model.embed_w4
        return fns.q4a8(hidden, w4.packed, w4.scale, out_dtype=torch.float32)
    tp = model.vocab_tp
    if tp is not None:  # each rank's product gives part of d hidden: f
        hidden = comm.copy_to_model(hidden, tp.group)
    emb = model.embed
    if isinstance(emb, QLinear):
        out = fns.q8(hidden, emb.weight, emb.scale, out_dtype=torch.float32)
    else:
        out = wide_linear(hidden, emb)
    return out if tp is None else comm.gather_from_model(out, tp.group, -1)


class _WideLogits(torch.autograd.Function):
    """``torch.mm(h, E^T, out_dtype=float32)`` (which has no derivative in
    PyTorch) with its gradient for h: ``d h = d logits @ E`` accumulated in
    fp32 from ``d logits`` rounded to E's dtype, rounded to h's dtype. Saves
    E as it is (no fp32 copy of the (V, D) table); E takes no gradient."""

    @staticmethod
    def forward(ctx, h2: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        if emb.requires_grad:
            raise ValueError("logits: the tied embedding takes no gradient on this path")
        ctx.save_for_backward(emb)
        ctx.h_dtype = h2.dtype
        return torch.mm(h2, emb.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (emb,) = ctx.saved_tensors
        dh = torch.mm(grad.to(emb.dtype), emb, out_dtype=torch.float32)
        return dh.to(ctx.h_dtype), None


def embed_tokens(model: GemmaModel, input_ids: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup (unscaled). An int8 row is widened to bf16 and
    scaled by its scale rounded to bf16, as the reference does.
    Vocab-parallel (``model.vocab_tp``): each rank looks up the ids in its
    rows, zeros the others, and the group's sum is every row (exact)."""
    tp = model.vocab_tp
    if tp is None:
        return _lookup(model.embed, input_ids)
    emb = model.embed
    n = (emb.weight if isinstance(emb, QLinear) else emb).shape[0]
    local = input_ids - model.vocab_start
    inside = (local >= 0) & (local < n)
    rows = _lookup(emb, torch.where(inside, local, 0))
    return comm.reduce_from_model(torch.where(inside[..., None], rows, 0), tp.group)


def _lookup(emb, ids: torch.Tensor) -> torch.Tensor:
    if isinstance(emb, QLinear):
        rows = emb.weight[ids].to(torch.bfloat16)
        return rows * emb.scale[ids].to(torch.bfloat16)[..., None]
    return F.embedding(ids, emb)

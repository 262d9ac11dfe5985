"""Gemma decoder (port of ``paligemma_tpu/models/gemma.py``), bf16/fp32 path.

Token embedding scaled by sqrt(hidden) in the activation dtype, pre-RMSNorm
blocks (input_ln -> GQA attention -> +res -> post_ln -> GeGLU MLP -> +res),
final RMSNorm, fp32 logits through the tied embedding.

- The KV cache is preallocated, ``(L, B, max_len, Hkv, hd)``, with its
  length kept as a host int. Forward writes this step's K/V into it IN PLACE
  and advances ``length`` (JAX returns a new cache instead).
- Prefill (T > 1) writes K/V into the cache, then attends over the fresh K/V
  only with ``flash_attention`` (bidirectional prefix-LM, all-zeros mask).
- Decode (T == 1) attends over the whole cache buffer with
  ``decode_attention``; unwritten slots are masked by the per-row valid
  length, a preallocated (B,) int32 device tensor filled from the host
  length, so no step reads anything back from the device.
- q/k/v and gate/up are fused projections, stored in ``nn.Linear``'s
  (out, in) layout.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from paligemma_tpu_torch.config import GemmaConfig
from paligemma_tpu_torch.ops.cuda_attention import KERNELS, AttentionFns
from paligemma_tpu_torch.ops.norms import rms_norm
from paligemma_tpu_torch.ops.rope import apply_rope, rope_cos_sin


@dataclasses.dataclass
class KVCache:
    """Preallocated per-layer KV cache on the device.

    k, v: (num_layers, batch, max_len, kv_heads, head_dim).
    length: host int, the number of written positions.
    valid: (batch,) int32 device tensor, the decode kernel's visible length.
    """

    k: torch.Tensor
    v: torch.Tensor
    length: int
    valid: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_cache(
    cfg: GemmaConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None
) -> KVCache:
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=0,
        valid=torch.zeros(batch, dtype=torch.int32, device=device),
    )


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, dtype=dtype))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


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

    def attention(self, x, cos, sin, cache: Optional[KVCache], li: int, attn: AttentionFns):
        cfg = self.cfg
        b, t, _ = x.shape
        h, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        q, k, v = F.linear(x, self.qkv.weight).split([h * hd, hkv * hd, hkv * hd], dim=-1)
        q = apply_rope(q.view(b, t, h, hd), cos, sin)
        k = apply_rope(k.view(b, t, hkv, hd), cos, sin)
        v = v.view(b, t, hkv, hd)
        scale = hd**-0.5
        if cache is not None:
            pos = cache.length
            cache.k[li, :, pos : pos + t] = k  # in place
            cache.v[li, :, pos : pos + t] = v
            if t == 1:
                out = attn.decode(q, cache.k[li], cache.v[li], cache.valid, scale=scale)
                return F.linear(out.reshape(b, t, h * hd), self.o.weight)
        # Prefill: bidirectional over the fresh K/V only (exact: nothing else
        # is visible yet).
        out = attn.flash(q, k, v, scale=scale)
        return F.linear(out.reshape(b, t, h * hd), self.o.weight)

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        gate, up = F.linear(x, self.gate_up.weight).chunk(2, dim=-1)
        act = F.gelu(gate.float(), approximate="tanh").to(x.dtype)
        return F.linear(act * up, self.down.weight)

    def forward(self, h, cos, sin, cache: Optional[KVCache], li: int, attn: AttentionFns):
        h = h + self.attention(self.input_ln(h), cos, sin, cache, li, attn)
        return h + self.mlp(self.post_ln(h))


class GemmaModel(nn.Module):
    def __init__(self, cfg: GemmaConfig, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size, dtype=dtype))
        self.layers = nn.ModuleList(GemmaLayer(cfg, dtype) for _ in range(cfg.num_hidden_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)


def forward(
    model: GemmaModel,
    inputs_embeds: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[KVCache] = None,
    attn: AttentionFns = KERNELS,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Decoder trunk: unscaled embeds (B, T, D) + (B, T) positions ->
    (final-normed hidden (B, T, D), the same cache advanced by T).

    With a cache, K/V are written at ``cache.length``; T == 1 decodes over
    the cache, T > 1 is a prefill into an empty cache.
    """
    cfg = model.cfg
    dtype = inputs_embeds.dtype
    b, t, _ = inputs_embeds.shape
    h = inputs_embeds * torch.tensor(cfg.hidden_size**0.5, dtype=dtype)
    cos, sin = rope_cos_sin(
        positions, cfg.head_dim, cfg.rope_theta, cfg.max_position_embeddings, dtype
    )
    if cache is not None:
        if t > 1 and cache.length:
            raise ValueError("prefill (T > 1) needs an empty cache")
        if cache.length + t > cache.max_len:
            raise ValueError(f"cache full: {cache.length} + {t} > {cache.max_len}")
        cache.valid.fill_(cache.length + t)
    for li, layer in enumerate(model.layers):
        h = layer(h, cos, sin, cache, li, attn)
    if cache is not None:
        cache.length += t
    return model.final_norm(h), cache


def logits(model: GemmaModel, hidden: torch.Tensor) -> torch.Tensor:
    """Tied lm_head, fp32 logits (B, T, V).

    The product is accumulated and returned in fp32 without rounding through
    the activation dtype. On CUDA ``torch.mm(..., out_dtype=float32)`` does
    that straight from the bf16 operands; elsewhere the operands are widened.
    """
    emb = model.embed
    h2 = hidden.reshape(-1, hidden.shape[-1])
    if h2.is_cuda and h2.dtype != torch.float32:
        out = torch.mm(h2, emb.t(), out_dtype=torch.float32)
    else:
        out = h2.float() @ emb.float().t()
    return out.reshape(*hidden.shape[:-1], emb.shape[0])


def embed_tokens(model: GemmaModel, input_ids: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup (unscaled)."""
    return F.embedding(input_ids, model.embed)

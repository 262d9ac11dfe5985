"""Attention reference ops (port of ``paligemma_tpu/ops/attention.py``).

Scores are fp32 and scaled by ``1/sqrt(head_dim)``; softmax is fp32, the
probabilities are cast to the activation dtype, and the PV product
accumulates in fp32. GQA reshapes queries to (kv_heads, group) and broadcasts
against the un-repeated K/V (no ``repeat_kv``). The only masking is over
padded or unwritten KV slots (PaliGemma's prefix-LM mask is all zeros over
valid positions).

Products of bf16 inputs are taken in fp32 (``.float()`` before the einsum)
so that they match JAX's ``preferred_element_type=float32``: bf16 values and
their pairwise products are exact in fp32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

# Large negative additive-mask value, safe in fp32 softmax.
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

IntOrTensor = Union[int, torch.Tensor]


class LengthMask(NamedTuple):
    """Structured mask: row ``b`` sees kv positions
    ``[0, valid[b]) ∪ [gen_start, gen_end)``."""

    valid: torch.Tensor  # (B,) int32 — per-row visible prefix
    gen_start: IntOrTensor  # shared window start (empty if >= end)
    gen_end: IntOrTensor  # shared window end (exclusive)

    def materialize(self, s_len: int) -> torch.Tensor:
        """Additive fp32 mask (B, 1, 1, 1, S) for the einsum attention path."""
        s = torch.arange(s_len, device=self.valid.device)
        own = s[None, :] < self.valid[:, None]
        gen = (s[None, :] >= self.gen_start) & (s[None, :] < self.gen_end)
        m = torch.where(own | gen, 0.0, MASK_VALUE).to(torch.float32)
        return m[:, None, None, None, :]


def make_length_mask(
    valid_len: IntOrTensor, batch: Optional[int] = None, device=None
) -> LengthMask:
    """LengthMask with an empty shared window from scalar or (B,) lengths."""
    valid = torch.as_tensor(valid_len, dtype=torch.int32, device=device).reshape(-1)
    if batch is not None and valid.shape[0] == 1 and batch > 1:
        valid = valid.expand(batch)
    return LengthMask(valid=valid, gen_start=0, gen_end=0)


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Full multi-head attention: q (B,T,H,D), k/v (B,S,H,D) -> (B,T,H,D)."""
    d = q.shape[-1]
    scale = d**-0.5 if scale is None else scale
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = (probs / probs.sum(dim=-1, keepdim=True)).to(q.dtype)
    out = torch.einsum("bhts,bshd->bthd", probs.float(), v.float())
    return out.to(q.dtype)


def gqa_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query attention: q (B,T,H,D), k/v (B,S,Hkv,D) -> (B,T,H,D).

    ``mask`` is additive and broadcastable to (B, Hkv, G, T, S) — typically
    (B, 1, 1, 1, S) from ``length_mask`` or ``LengthMask.materialize``.
    """
    b, t, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scale = d**-0.5 if scale is None else scale
    qg = q.reshape(b, t, hkv, g, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * scale
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = (probs / probs.sum(dim=-1, keepdim=True)).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs.float(), v.float())
    return out.to(q.dtype).reshape(b, t, h, d)


def length_mask(valid_len: IntOrTensor, max_len: int, batch: int = 1) -> torch.Tensor:
    """Additive (B, 1, 1, 1, S) mask: 0 where ``s < valid_len`` else MASK_VALUE."""
    valid = torch.as_tensor(valid_len).reshape(-1, 1)
    s = torch.arange(max_len, device=valid.device)
    m = torch.where(s[None, :] < valid, 0.0, MASK_VALUE).to(torch.float32)
    if m.shape[0] == 1 and batch > 1:
        m = m.expand(batch, max_len)
    return m[:, None, None, None, :]

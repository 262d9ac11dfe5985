"""Normalization ops (port of ``paligemma_tpu/ops/norms.py``).

- RMSNorm computes in fp32 and scales by ``(1 + weight)`` with a
  zero-initialized weight (Gemma).
- LayerNorm takes fp32 statistics, applies the affine in fp32 and casts back
  (SigLIP).
"""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Gemma RMSNorm: fp32 compute, ``normed * (1 + w)``, cast back to x.dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + weight.float())).to(x.dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """LayerNorm with fp32 statistics, affine, cast back to x.dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = (xf - mean) * (var + eps) ** -0.5
    return (normed * weight.float() + bias.float()).to(x.dtype)

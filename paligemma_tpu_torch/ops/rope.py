"""Rotary position embedding (port of ``paligemma_tpu/ops/rope.py``).

Half-rotation ``[-x2, x1]`` with positions clamped to
``max_position_embeddings - 1``. Frequencies are computed in fp32; cos/sin are
cast to the activation dtype before they are applied.
"""
from __future__ import annotations

from typing import Tuple

import torch


def rope_cos_sin(
    positions: torch.Tensor,
    head_dim: int,
    theta: float = 10000.0,
    max_position_embeddings: int = 8192,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos, sin of shape (B, T, head_dim) in ``dtype`` for (B, T) int positions."""
    positions = positions.clamp(0, max_position_embeddings - 1)
    exponent = (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
        / head_dim
    )
    inv_freq = 1.0 / (theta**exponent)
    freqs = positions.float()[..., None] * inv_freq  # (B, T, head_dim // 2)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, T, H, head_dim); cos, sin: (B, T, head_dim)."""
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    return x * cos + _rotate_half(x) * sin

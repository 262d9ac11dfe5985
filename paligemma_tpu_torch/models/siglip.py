"""SigLIP ViT vision encoder (port of ``paligemma_tpu/models/siglip.py``).

Patch embedding as one matmul over channel-major (C, P, P) patches, learned
absolute position embedding, pre-LN blocks with full bidirectional attention
(``flash_attention``), tanh-GELU MLP, final post-layernorm. Output
``(B, num_patches, hidden)``.

Layers are a ``ModuleList`` in place of the JAX package's stacked ``(L, ...)``
params and ``lax.scan``. Linear weights use ``nn.Linear``'s (out, in) layout;
``utils/convert.py`` transposes the JAX (in, out) kernels. Each projection
rounds its product to the activation dtype before adding the bias, as the
reference does, for a float weight and for an int8 ``QLinear`` alike.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from paligemma_tpu_torch.config import SiglipVisionConfig
from paligemma_tpu_torch.models.gemma import row_parallel
from paligemma_tpu_torch.ops.kernels import KERNELS, KernelFns
from paligemma_tpu_torch.ops.norms import layer_norm
from paligemma_tpu_torch.parallel import comm
from paligemma_tpu_torch.quantization import QLinear, qproj


def linear(x: torch.Tensor, layer: nn.Module, fns: KernelFns,
           tp: Optional[comm.ModelParallel] = None) -> torch.Tensor:
    """``x @ W`` rounded to x.dtype, then ``+ b`` (the reference's order).
    ``tp``: a row-parallel product (``gemma.row_parallel``), its (replicated)
    bias added once after the reduction."""
    if tp is not None:
        y = row_parallel(x, layer, fns, tp)
    elif isinstance(layer, QLinear):
        y = qproj(x, layer, fns)
    else:
        y = F.linear(x, layer.weight)
    return y if layer.bias is None else y + layer.bias


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(dim, dtype=dtype))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class SiglipLayer(nn.Module):
    """One pre-LN encoder block."""

    def __init__(self, cfg: SiglipVisionConfig, dtype=None):
        super().__init__()
        d, i = cfg.hidden_size, cfg.intermediate_size
        self.cfg = cfg
        self.ln1 = LayerNorm(d, cfg.layer_norm_eps, dtype)
        self.qkv = nn.Linear(d, 3 * d, dtype=dtype)  # fused q | k | v
        self.o = nn.Linear(d, d, dtype=dtype)
        self.ln2 = LayerNorm(d, cfg.layer_norm_eps, dtype)
        self.fc1 = nn.Linear(d, i, dtype=dtype)
        self.fc2 = nn.Linear(i, d, dtype=dtype)
        # Tensor parallelism (parallel/sharding.py): the collectives around
        # the attention (qkv split by heads, o row-parallel) and the MLP
        # (fc1 column-, fc2 row-parallel); None: unsharded. ``n_heads``:
        # the heads this rank holds.
        self.attn_tp: Optional[comm.ModelParallel] = None
        self.mlp_tp: Optional[comm.ModelParallel] = None
        self.n_heads = cfg.num_attention_heads

    def forward(self, h: torch.Tensor, fns: KernelFns) -> torch.Tensor:
        cfg = self.cfg
        b, n, _ = h.shape
        w = self.n_heads * cfg.head_dim
        x = self.ln1(h)
        if self.attn_tp is not None:
            x = self.attn_tp.enter(x)
        qkv = linear(x, self.qkv, fns)
        q, k, v = (y.view(b, n, self.n_heads, cfg.head_dim) for y in qkv.split(w, dim=-1))
        h = h + linear(fns.flash(q, k, v).reshape(b, n, w), self.o, fns, self.attn_tp)
        x = self.ln2(h)
        if self.mlp_tp is not None:
            x = self.mlp_tp.enter(x)
        x = linear(x, self.fc1, fns)
        x = F.gelu(x.float(), approximate="tanh").to(x.dtype)
        return h + linear(x, self.fc2, fns, self.mlp_tp)


class SiglipVisionModel(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig, dtype=None):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        patch_in = cfg.num_channels * cfg.patch_size * cfg.patch_size
        self.patch_embedding = nn.Linear(patch_in, d, dtype=dtype)
        self.position_embedding = nn.Parameter(torch.empty(cfg.num_patches, d, dtype=dtype))
        self.layers = nn.ModuleList(SiglipLayer(cfg, dtype) for _ in range(cfg.num_hidden_layers))
        self.post_layernorm = LayerNorm(d, cfg.layer_norm_eps, dtype)


def extract_patches(pixel_values: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, N, C*P*P), channel-major like the conv weight (D, C, P, P)."""
    b, c, h, w = pixel_values.shape
    p = patch_size
    x = pixel_values.reshape(b, c, h // p, p, w // p, p)
    x = x.permute(0, 2, 4, 1, 3, 5)  # (B, Hp, Wp, C, P, P)
    return x.reshape(b, (h // p) * (w // p), c * p * p)


def embed(model: SiglipVisionModel, pixel_values: torch.Tensor, fns: KernelFns = KERNELS) -> torch.Tensor:
    """Patch + position embedding."""
    w = model.patch_embedding.weight
    patches = extract_patches(pixel_values, model.cfg.patch_size).to(w.dtype)
    return linear(patches, model.patch_embedding, fns) + model.position_embedding


def apply(
    model: SiglipVisionModel, pixel_values: torch.Tensor, fns: KernelFns = KERNELS
) -> torch.Tensor:
    """Full encoder: (B, C, H, W) -> (B, N, D)."""
    h = embed(model, pixel_values, fns)
    for layer in model.layers:
        h = layer(h, fns)
    return model.post_layernorm(h)

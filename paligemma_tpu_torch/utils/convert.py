"""Carry weights from the JAX package's parameter tree into the port.

The input is ``paligemma_tpu.models.paligemma``'s tree as nested dicts of
numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``); nothing here
imports jax. This is the only place where layouts change:

- the stacked leading ``(L, ...)`` axis of the layer params is split into
  the port's per-layer modules;
- dense kernels, stored ``(in, out)`` by JAX, are transposed to
  ``nn.Linear``'s ``(out, in)``;
- LayerNorm ``scale`` becomes ``weight``.

LoRA adapters keep the reference's layout (``lora_from_jax``,
``lora_to_jax``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from paligemma_tpu_torch.config import PaliGemmaConfig
from paligemma_tpu_torch.models.paligemma import PaliGemma, empty_model

Tree = Dict[str, Any]


def state_dict_from_jax(tree: Tree) -> Dict[str, np.ndarray]:
    """The port's ``state_dict`` names -> arrays, from the JAX tree."""
    sd: Dict[str, np.ndarray] = {}

    def dense(prefix: str, p: Tree, idx=None) -> None:
        k = p["kernel"] if idx is None else p["kernel"][idx]
        sd[f"{prefix}.weight"] = k.T
        sd[f"{prefix}.bias"] = p["bias"] if idx is None else p["bias"][idx]

    def norm(prefix: str, p: Tree, idx=None) -> None:
        sd[f"{prefix}.weight"] = p["scale"] if idx is None else p["scale"][idx]
        sd[f"{prefix}.bias"] = p["bias"] if idx is None else p["bias"][idx]

    vis = tree["vision"]
    dense("vision.patch_embedding", vis["patch_embedding"])
    sd["vision.position_embedding"] = vis["position_embedding"]
    lay = vis["layers"]
    for l in range(lay["ln1"]["scale"].shape[0]):
        pre = f"vision.layers.{l}"
        norm(f"{pre}.ln1", lay["ln1"], l)
        dense(f"{pre}.qkv", lay["attn"]["qkv"], l)
        dense(f"{pre}.o", lay["attn"]["o"], l)
        norm(f"{pre}.ln2", lay["ln2"], l)
        dense(f"{pre}.fc1", lay["mlp"]["fc1"], l)
        dense(f"{pre}.fc2", lay["mlp"]["fc2"], l)
    norm("vision.post_layernorm", vis["post_layernorm"])
    dense("projector", tree["projector"])

    llm = tree["llm"]
    sd["llm.embed"] = llm["embed"]
    lay = llm["layers"]
    for l in range(lay["input_ln"].shape[0]):
        pre = f"llm.layers.{l}"
        sd[f"{pre}.input_ln.weight"] = lay["input_ln"][l]
        sd[f"{pre}.post_ln.weight"] = lay["post_ln"][l]
        for name in ("qkv", "o", "gate_up", "down"):
            sd[f"{pre}.{name}.weight"] = lay[name][l].T
    sd["llm.final_norm.weight"] = llm["final_norm"]
    return sd


def from_jax_params(
    tree: Tree, cfg: PaliGemmaConfig, device="cuda", dtype: torch.dtype = torch.float32
) -> PaliGemma:
    """A ``PaliGemma`` on ``device`` in ``dtype`` holding the JAX tree's weights."""
    model = empty_model(cfg, device, dtype)
    sd = {
        name: torch.tensor(np.asarray(arr, dtype=np.float32))
        for name, arr in state_dict_from_jax(tree).items()
    }
    model.load_state_dict(sd, strict=True)
    return model


def lora_from_jax(tree: Tree, device="cuda", dtype: torch.dtype = torch.float32) -> Tree:
    """JAX LoRA adapters (nested dicts of numpy arrays, the layout of
    ``paligemma_tpu/lora.py``: ``{"layers": {"q": {"a": (L, D, r), "b":
    (L, r, out)}, ...}}``) as the port's: the same layout, as tensors."""
    return {k: lora_from_jax(v, device, dtype) if isinstance(v, dict)
            else torch.tensor(np.asarray(v, dtype=np.float32)).to(device, dtype)
            for k, v in tree.items()}


def lora_to_jax(tree: Tree) -> Tree:
    """Inverse of ``lora_from_jax``: fp32 numpy arrays in the same layout."""
    return {k: lora_to_jax(v) if isinstance(v, dict) else v.detach().to("cpu", torch.float32).numpy()
            for k, v in tree.items()}

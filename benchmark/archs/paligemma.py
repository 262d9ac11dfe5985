"""The PaliGemma layout: a SigLIP tower, a linear projector and a decoder
with the port's layer equations, served by the port's ``PaliGemma``.

Weights: names and shapes are the port's state-dict layout (fused q|k|v
and gate|up, ``nn.Linear``'s (out, in)), worked out from the configuration
file's ``vision`` and ``text`` sizes. The groups are the tower with the
projector, the embedding, the decoder's norms, then each decoder layer's
projections, so that an int8 copy of a layer frees its bf16 buffer.

Distributions: a linear weight N(0, 1/fan_in); the embedding N(0, 1/d)
(the decoder scales it by sqrt(d)); biases and the tower's position
embedding N(0, 0.02^2); LayerNorm scales 1 + N(0, 0.1^2); a decoder
RMSNorm weight N(0, 0.1^2) (it scales by 1 + w); the final norm's weight
N(-1, 1), so that (1 + w) ~ N(0, 1). With the port's own scheme (that
weight 0) the tied lm_head scores each token's own embedding far above
every other, and a greedy stream repeats its input token.

The reference is ``reference/vlm.py``; the operation counts are
``harness/work.py``'s.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from PIL import Image

from harness import work
from harness.weights import Spec, layer_norm, linear
from reference import vlm


def groups(config: dict) -> List[Tuple[str, Spec]]:
    """The weight groups in a fixed order, each a list of tensor specs."""
    vision, text = config["vision"], config["text"]
    d, i, p = vision["hidden_size"], vision["intermediate_size"], vision["patch_size"]
    n_patch = (vision["image_size"] // p) ** 2
    tower: Spec = linear("vision.patch_embedding", d, 3 * p * p, True)
    tower.append(("vision.position_embedding", (n_patch, d), 0.02, 0.0))
    for li in range(vision["num_hidden_layers"]):
        pre = f"vision.layers.{li}."
        tower += layer_norm(pre + "ln1", d) + linear(pre + "qkv", 3 * d, d, True)
        tower += linear(pre + "o", d, d, True) + layer_norm(pre + "ln2", d)
        tower += linear(pre + "fc1", i, d, True) + linear(pre + "fc2", d, i, True)
    tower += layer_norm("vision.post_layernorm", d)
    big_d, big_i = text["hidden_size"], text["intermediate_size"]
    tower += linear("projector", big_d, d, True)
    h, hkv, hd = text["num_attention_heads"], text["num_key_value_heads"], text["head_dim"]
    n_layers = text["num_hidden_layers"]
    norms: Spec = [(f"llm.layers.{li}.{n}.weight", (big_d,), 0.1, 0.0)
                   for li in range(n_layers) for n in ("input_ln", "post_ln")]
    norms.append(("llm.final_norm.weight", (big_d,), 1.0, -1.0))
    out = [("tower", tower), ("embed", [("llm.embed", (text["vocab_size"], big_d), big_d**-0.5, 0.0)]),
           ("norms", norms)]
    for li in range(n_layers):
        pre = f"llm.layers.{li}."
        layer = linear(pre + "qkv", (h + 2 * hkv) * hd, big_d, False) + linear(pre + "o", big_d, h * hd, False)
        layer += linear(pre + "gate_up", 2 * big_i, big_d, False) + linear(pre + "down", big_d, big_i, False)
        out.append((f"layer{li}", layer))
    return out


def port_config(config: dict) -> dict:
    """The configuration file's sizes as the port's ``config.json`` dict."""
    v, t = config["vision"], config["text"]
    return {
        "pad_token_id": 0,
        "projection_dim": t["hidden_size"],
        "hidden_size": t["hidden_size"],
        "vision_config": {k: v[k] for k in ("hidden_size", "intermediate_size", "num_attention_heads",
                                            "num_hidden_layers", "patch_size", "image_size", "layer_norm_eps")},
        "text_config": {k: t[k] for k in ("hidden_size", "intermediate_size", "num_attention_heads",
                                          "num_key_value_heads", "head_dim", "num_hidden_layers", "vocab_size",
                                          "max_position_embeddings", "rms_norm_eps", "rope_theta")},
    }


def build_model(config: dict, W: Dict[str, torch.Tensor]):
    """(port model, processor): the port's modules over the tensors of
    ``W`` (no copy), then the configuration's serving format."""
    from paligemma_tpu_torch import quantization
    from paligemma_tpu_torch.config import PaliGemmaConfig
    from paligemma_tpu_torch.models.paligemma import PaliGemma
    from paligemma_tpu_torch.processing import ByteTokenizer, PaliGemmaProcessor, align_config

    cfg = PaliGemmaConfig.from_dict(port_config(config))
    proc = PaliGemmaProcessor(ByteTokenizer(), cfg.vision_config.num_image_tokens, cfg.vision_config.image_size)
    cfg = align_config(cfg, proc)
    if cfg.text_config.vocab_size != config["text"]["vocab_size"]:
        raise ValueError("the byte tokenizer's ids do not fit the configuration's vocab")
    dtype = next(iter(W.values())).dtype
    with torch.device("meta"):
        model = PaliGemma(cfg, dtype)
    model.load_state_dict(W, strict=True, assign=True)
    model.requires_grad_(False)
    fmt = config["serve"]["weights"]
    if fmt == "int8":
        model = quantization.quantize_params(model, mode="int8")
    elif fmt != "bf16":
        raise ValueError(f"unknown serving format {fmt!r}")
    return model, proc


def reference(W: Dict[str, torch.Tensor], config: dict, fmt: str) -> vlm.Reference:
    return vlm.Reference(W, config["vision"], config["text"], fmt)


def n_image_tokens(config: dict) -> int:
    v = config["vision"]
    return (v["image_size"] // v["patch_size"]) ** 2


def inputs(config: dict, image: Image.Image, prompt: str) -> Tuple[torch.Tensor, np.ndarray]:
    """(pixels, token ids) as the port's processor makes them."""
    return vlm.pixels(image, config["vision"]["image_size"]), vlm.token_ids(prompt, n_image_tokens(config))


def request_flops(config: dict, positions: int, first: int, last: int) -> float:
    return work.request_flops(config["vision"], config["text"], positions, first, last)

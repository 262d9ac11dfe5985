"""An architecture that only the tests provide (``archs.toy``): the port's
PaliGemma and the plain reference's classes, reached by hooks of its own.

Its weights are split otherwise than ``archs/paligemma.py``'s: a group for
each tower layer, the patch embedding with the projector, and a group for
each decoder layer holding its norms with its projections. Its operation
count is two a decoder weight a token, plus attention over the positions
each token sees.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from harness.weights import Spec, layer_norm, linear
from reference import vlm

CALLS: Dict[str, int] = {}


def _called(name: str) -> None:
    CALLS[name] = CALLS.get(name, 0) + 1


def groups(config: dict) -> List[Tuple[str, Spec]]:
    _called("groups")
    v, t = config["vision"], config["text"]
    d, p = v["hidden_size"], v["patch_size"]
    out = [("ends", linear("vision.patch_embedding", d, 3 * p * p, True)
            + [("vision.position_embedding", ((v["image_size"] // p) ** 2, d), 0.02, 0.0)]
            + layer_norm("vision.post_layernorm", d) + linear("projector", t["hidden_size"], d, True))]
    for li in range(v["num_hidden_layers"]):
        pre = f"vision.layers.{li}."
        out.append((f"tower{li}", layer_norm(pre + "ln1", d) + linear(pre + "qkv", 3 * d, d, True)
                    + linear(pre + "o", d, d, True) + layer_norm(pre + "ln2", d)
                    + linear(pre + "fc1", v["intermediate_size"], d, True)
                    + linear(pre + "fc2", d, v["intermediate_size"], True)))
    big_d, inter = t["hidden_size"], t["intermediate_size"]
    q, kv = t["num_attention_heads"] * t["head_dim"], t["num_key_value_heads"] * t["head_dim"]
    out.append(("head", [("llm.embed", (t["vocab_size"], big_d), big_d**-0.5, 0.0),
                         ("llm.final_norm.weight", (big_d,), 1.0, -1.0)]))
    for li in range(t["num_hidden_layers"]):
        pre = f"llm.layers.{li}."
        out.append((f"block{li}", [(pre + "input_ln.weight", (big_d,), 0.1, 0.0),
                                   (pre + "post_ln.weight", (big_d,), 0.1, 0.0)]
                    + linear(pre + "qkv", q + 2 * kv, big_d, False) + linear(pre + "o", big_d, q, False)
                    + linear(pre + "gate_up", 2 * inter, big_d, False) + linear(pre + "down", big_d, inter, False)))
    return out


def build_model(config: dict, W: Dict[str, torch.Tensor]):
    _called("build_model")
    from paligemma_tpu_torch import quantization
    from paligemma_tpu_torch.config import PaliGemmaConfig
    from paligemma_tpu_torch.models.paligemma import PaliGemma
    from paligemma_tpu_torch.processing import ByteTokenizer, PaliGemmaProcessor, align_config

    d = config["text"]["hidden_size"]
    cfg = PaliGemmaConfig.from_dict({"pad_token_id": 0, "projection_dim": d, "hidden_size": d,
                                     "vision_config": config["vision"], "text_config": config["text"]})
    proc = PaliGemmaProcessor(ByteTokenizer(), cfg.vision_config.num_image_tokens, cfg.vision_config.image_size)
    cfg = align_config(cfg, proc)
    with torch.device("meta"):
        model = PaliGemma(cfg, next(iter(W.values())).dtype)
    model.load_state_dict(W, strict=True, assign=True)
    model.requires_grad_(False)
    if config["serve"]["weights"] == "int8":
        model = quantization.quantize_params(model, mode="int8")
    return model, proc


def reference(W: Dict[str, torch.Tensor], config: dict, fmt: str) -> vlm.Reference:
    _called("reference")
    return vlm.Reference(W, config["vision"], config["text"], fmt)


def n_image_tokens(config: dict) -> int:
    _called("n_image_tokens")
    return (config["vision"]["image_size"] // config["vision"]["patch_size"]) ** 2


def inputs(config: dict, image, prompt: str):
    _called("inputs")
    return vlm.pixels(image, config["vision"]["image_size"]), vlm.token_ids(prompt, n_image_tokens(config))


def request_flops(config: dict, positions: int, first: int, last: int) -> float:
    _called("request_flops")
    t = config["text"]
    q, kv = t["num_attention_heads"] * t["head_dim"], t["num_key_value_heads"] * t["head_dim"]
    weights = t["num_hidden_layers"] * t["hidden_size"] * (2 * q + 2 * kv + 3 * t["intermediate_size"])
    tokens = max(0, last - first)
    seen = sum(positions + j for j in range(first, last))
    return 2.0 * weights * tokens + 4.0 * t["num_hidden_layers"] * t["hidden_size"] * seen

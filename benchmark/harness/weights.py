"""The model's weights, made on the device from the seed.

Names and shapes are the port's state-dict layout (fused q|k|v and
gate|up, ``nn.Linear``'s (out, in)), worked out here from the
configuration file's sizes. Each group of tensors (the tower with the
projector, the embedding, the decoder's norms, each decoder layer's
projections) is one ``normal_`` call of its own generator on one flat
buffer in the served dtype, so any group can be made again alone and gives
the same bits. Each tensor is then a view of its group's buffer, scaled and
shifted in place. The projections have groups of their own so that an
int8 copy of them frees the bf16 buffers.

Distributions: a linear weight N(0, 1/fan_in); the embedding N(0, 1/d)
(the decoder scales it by sqrt(d)); biases and the tower's position
embedding N(0, 0.02^2); LayerNorm scales 1 + N(0, 0.1^2); a decoder
RMSNorm weight N(0, 0.1^2) (it scales by 1 + w); the final norm's weight
N(-1, 1), so that (1 + w) ~ N(0, 1). With the port's own scheme (that
weight 0) the tied lm_head scores each token's own embedding far above
every other, and a greedy stream repeats its input token.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# (name, shape, std, mean) of each tensor of a group.
Spec = List[Tuple[str, tuple, float, float]]


def _linear(name: str, out: int, inp: int, bias: bool) -> Spec:
    spec = [(name + ".weight", (out, inp), inp**-0.5, 0.0)]
    if bias:
        spec.append((name + ".bias", (out,), 0.02, 0.0))
    return spec


def _layer_norm(name: str, d: int) -> Spec:
    return [(name + ".weight", (d,), 0.1, 1.0), (name + ".bias", (d,), 0.02, 0.0)]


def groups(vision: dict, text: dict) -> List[Tuple[str, Spec]]:
    """The weight groups in a fixed order, each a list of tensor specs."""
    d, i, p = vision["hidden_size"], vision["intermediate_size"], vision["patch_size"]
    n_patch = (vision["image_size"] // p) ** 2
    tower: Spec = _linear("vision.patch_embedding", d, 3 * p * p, True)
    tower.append(("vision.position_embedding", (n_patch, d), 0.02, 0.0))
    for li in range(vision["num_hidden_layers"]):
        pre = f"vision.layers.{li}."
        tower += _layer_norm(pre + "ln1", d) + _linear(pre + "qkv", 3 * d, d, True)
        tower += _linear(pre + "o", d, d, True) + _layer_norm(pre + "ln2", d)
        tower += _linear(pre + "fc1", i, d, True) + _linear(pre + "fc2", d, i, True)
    tower += _layer_norm("vision.post_layernorm", d)
    big_d, big_i = text["hidden_size"], text["intermediate_size"]
    tower += _linear("projector", big_d, d, True)
    h, hkv, hd = text["num_attention_heads"], text["num_key_value_heads"], text["head_dim"]
    n_layers = text["num_hidden_layers"]
    norms: Spec = [(f"llm.layers.{li}.{n}.weight", (big_d,), 0.1, 0.0)
                   for li in range(n_layers) for n in ("input_ln", "post_ln")]
    norms.append(("llm.final_norm.weight", (big_d,), 1.0, -1.0))
    out = [("tower", tower), ("embed", [("llm.embed", (text["vocab_size"], big_d), big_d**-0.5, 0.0)]),
           ("norms", norms)]
    for li in range(n_layers):
        pre = f"llm.layers.{li}."
        layer = _linear(pre + "qkv", (h + 2 * hkv) * hd, big_d, False) + _linear(pre + "o", big_d, h * hd, False)
        layer += _linear(pre + "gate_up", 2 * big_i, big_d, False) + _linear(pre + "down", big_d, big_i, False)
        out.append((f"layer{li}", layer))
    return out


def _numel(shape: tuple) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def group_seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + index) % (2**63)


@torch.no_grad()
def make_group(spec: Spec, seed: int, index: int, device, dtype) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, index))
    flat = torch.empty(sum(_numel(s) for _, s, _, _ in spec), dtype=dtype, device=device)
    flat.normal_(generator=gen)
    out, off = {}, 0
    for name, shape, std, mean in spec:
        n = _numel(shape)
        t = flat[off:off + n].view(shape)
        t.mul_(std)
        if mean:
            t.add_(mean)
        out[name] = t
        off += n
    return out


def make_weights(vision: dict, text: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Every tensor of the model, name -> view of its group's buffer."""
    weights: Dict[str, torch.Tensor] = {}
    for index, (_, spec) in enumerate(groups(vision, text)):
        weights.update(make_group(spec, seed, index, device, dtype))
    return weights


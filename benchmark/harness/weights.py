"""The model's weights, made on the device from the seed.

The configuration's architecture (``archs.load(config).groups``) lays the
tensors out in groups: names, shapes, and the std and mean of each. Each
group is one ``normal_`` call of its own generator on one flat buffer in
the served dtype, so any group can be made again alone and gives the same
bits. Each tensor is then a view of its group's buffer, scaled and shifted
in place. ``linear`` and ``layer_norm`` are the specs an architecture's
groups are built from.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

import archs

# (name, shape, std, mean) of each tensor of a group.
Spec = List[Tuple[str, tuple, float, float]]


def linear(name: str, out: int, inp: int, bias: bool) -> Spec:
    """An (out, in) weight N(0, 1/fan_in), with a bias N(0, 0.02^2)."""
    spec = [(name + ".weight", (out, inp), inp**-0.5, 0.0)]
    if bias:
        spec.append((name + ".bias", (out,), 0.02, 0.0))
    return spec


def layer_norm(name: str, d: int) -> Spec:
    """A LayerNorm's scale 1 + N(0, 0.1^2) and bias N(0, 0.02^2)."""
    return [(name + ".weight", (d,), 0.1, 1.0), (name + ".bias", (d,), 0.02, 0.0)]


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


def make_weights(config: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Every tensor of the model, name -> view of its group's buffer."""
    weights: Dict[str, torch.Tensor] = {}
    for index, (_, spec) in enumerate(archs.load(config).groups(config)):
        weights.update(make_group(spec, seed, index, device, dtype))
    return weights


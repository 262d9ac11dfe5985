"""Device memory probes (port of ``paligemma_tpu/utils/memory.py``).

The reference reads PJRT's ``memory_stats()``; here the CUDA caching
allocator's counters are read for an explicit device. A CPU device has no
such counters, and every probe returns 0 for it, as the reference does for
a backend without stats.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch
from torch import nn

Device = Union[str, torch.device]


def device_memory_stats(device: Device = "cuda") -> dict:
    """``torch.cuda.memory_stats`` of a CUDA device; {} for any other."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    return torch.cuda.memory_stats(device)


def bytes_in_use(device: Device = "cuda") -> int:
    """Bytes the caching allocator has handed out on ``device`` now."""
    return int(device_memory_stats(device).get("allocated_bytes.all.current", 0))


def peak_bytes_in_use(device: Device = "cuda") -> int:
    """The most bytes handed out on ``device`` since the last
    ``torch.cuda.reset_peak_memory_stats``."""
    device = torch.device(device)
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def peak_memory_mb(device: Device = "cuda") -> float:
    return peak_bytes_in_use(device) / 1024 / 1024


def tree_bytes(tree) -> int:
    """Total bytes of the tensors in ``tree``: a module's parameters and
    buffers, a dataclass's tensor fields (a ``KVCache``), or nested lists,
    tuples and dicts of these. Anything else counts 0."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, nn.Module):
        return sum(tree_bytes(t) for t in (*tree.parameters(), *tree.buffers()))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return sum(tree_bytes(getattr(tree, f.name)) for f in dataclasses.fields(tree)
                   if isinstance(getattr(tree, f.name), torch.Tensor))
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def estimate_live_mb(*trees) -> float:
    """The live trees' bytes in MiB: an in-use lower bound where no
    allocator peak is at hand, not a peak."""
    return sum(tree_bytes(t) for t in trees) / 1024 / 1024

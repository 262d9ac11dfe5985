"""Timing utilities of the port.

- ``fence``: ``torch.cuda.synchronize`` on the CUDA devices of the tensors
  given (a no-op for CPU tensors): PyTorch returns before the card is done.
- ``timed``: ``perf_counter`` bracketed by a fence on both sides.

Traces are taken with ``torch.profiler`` directly (``benchmark/harness/trace.py``).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Iterator, Tuple, Union

import torch


def _devices(x: Any) -> Iterator[torch.device]:
    """The devices of the tensors in ``x`` (nested lists, tuples, dicts), or
    ``x`` itself when it names a device."""
    if isinstance(x, torch.Tensor):
        yield x.device
    elif isinstance(x, (torch.device, str)):
        yield torch.device(x)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _devices(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _devices(v)


def fence(x: Any) -> None:
    """Wait until the work queued on the CUDA devices that ``x`` lives on
    (tensors, or a device) has finished."""
    for device in {d for d in _devices(x) if d.type == "cuda"}:
        torch.cuda.synchronize(device)


def timed(fn: Callable[[], Any], device: Union[str, torch.device] = "cuda") -> Tuple[Any, float]:
    """Run ``fn()`` between two fences; returns (result, seconds).

    The first fence drains the work already queued on ``device``, so the
    time does not take in an earlier tail; the second waits for ``fn``'s
    own work, on the devices of the tensors it returned and on ``device``."""
    fence(device)
    t0 = time.perf_counter()
    out = fn()
    fence([out, device])
    return out, time.perf_counter() - t0

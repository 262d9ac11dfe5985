"""Token selection (port of ``paligemma_tpu/ops/sampling.py``): greedy argmax
and temperature + nucleus (top-p) sampling.

- The nucleus is the reference's: sorted probabilities, drop every token
  whose cumulative mass *before* it exceeds p (``method="sort"``), or the
  same set found sort-free by a 30-step bisection of the probability
  threshold (``"threshold"``); ``"auto"`` takes the threshold above a vocab
  of 16384. The nucleus is deterministic and equals JAX's.
- The draw is JAX's ``categorical(log(kept + 1e-30))`` as a Gumbel-max:
  ``argmax(log(kept + 1e-30) - log(-log(u)))`` with ``u`` from ``torch.rand``
  on an explicit ``torch.Generator`` (None: the device's default). JAX's
  PRNG stream cannot be reproduced, so sampled parity is distributional.
- ``temperature`` and ``top_p`` may be Python floats or tensors, 0-d or
  (B, 1), on the logits' device: the counterpart of JAX's traced values, so
  one captured CUDA graph serves every sampled pair. Nothing here reads a
  value back to the host.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

Scalar = Union[float, torch.Tensor]

# Above this vocab "auto" takes the sort-free threshold (the reference's).
SORT_MAX_VOCAB = 16384


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the vocab axis. logits: (B, V) -> (B,) int32."""
    return logits.argmax(dim=-1).to(torch.int32)


def _nucleus_threshold(probs: torch.Tensor, top_p: Scalar, iters: int = 30) -> torch.Tensor:
    """Bisect the probability threshold of the top-p nucleus: t (B, 1), the
    largest threshold whose mass ``sum(probs >= t)`` still exceeds p, so
    ``probs >= t`` is the sorted-prefix nucleus (up to ties at the boundary
    probability). Sort-free: masked sums only, O(V) a step."""
    lo = torch.zeros(probs.shape[:-1] + (1,), dtype=torch.float32, device=probs.device)
    hi = probs.amax(dim=-1, keepdim=True)
    for _ in range(iters):
        mid = (lo + hi) * 0.5
        mass = torch.where(probs >= mid, probs, 0.0).sum(dim=-1, keepdim=True)
        feasible = mass > top_p
        lo, hi = torch.where(feasible, mid, lo), torch.where(feasible, hi, mid)
    return lo


def _sort_nucleus(probs: torch.Tensor, top_p: Scalar):
    """The reference's sorted route: (descending probs, their vocab ids,
    drop mask), dropping where the cumulative mass before a token exceeds p."""
    probs_sort, sort_idx = probs.sort(dim=-1, descending=True)
    cumsum = probs_sort.cumsum(dim=-1)
    return probs_sort, sort_idx, (cumsum - probs_sort) > top_p


def _categorical(weights: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """JAX's ``categorical(key, log(weights + 1e-30))`` as a Gumbel-max over
    uniforms from ``generator``: (B, V) -> (B,) int64."""
    u = torch.rand(weights.shape, generator=generator, device=weights.device)
    gumbel = -torch.log(-torch.log(u.clamp_min_(torch.finfo(torch.float32).tiny)))
    return (torch.log(weights + 1e-30) + gumbel).argmax(dim=-1)


def sample_top_p(
    logits: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    temperature: Scalar = 0.8,
    top_p: Scalar = 0.9,
    method: str = "auto",
) -> torch.Tensor:
    """Temperature + nucleus sampling. logits: (B, V) -> (B,) int32."""
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    if method == "auto":
        method = "threshold" if probs.shape[-1] > SORT_MAX_VOCAB else "sort"
    if method == "threshold":
        kept = torch.where(probs >= _nucleus_threshold(probs, top_p), probs, 0.0)
        kept = kept / kept.sum(dim=-1, keepdim=True)
        return _categorical(kept, generator).to(torch.int32)
    if method != "sort":
        raise ValueError(f"sample_top_p: unknown method {method!r}")
    probs_sort, sort_idx, drop = _sort_nucleus(probs, top_p)
    probs_sort = torch.where(drop, 0.0, probs_sort)
    probs_sort = probs_sort / probs_sort.sum(dim=-1, keepdim=True)
    draw = _categorical(probs_sort, generator)
    return sort_idx.gather(-1, draw[:, None])[:, 0].to(torch.int32)


def sample_rows(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    temperature: Scalar,
    top_p: Scalar,
) -> torch.Tensor:
    """Per-row temperature + threshold-nucleus sampling; rows with
    temperature <= 0 decode greedily. logits (B, V); temperature, top_p (B,)
    (or anything that broadcasts to it) -> (B,) int32."""
    b = logits.shape[0]
    temperature = torch.as_tensor(temperature, dtype=torch.float32, device=logits.device)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=logits.device)
    temperature = temperature.reshape(-1, 1).expand(b, 1)
    top_p = top_p.reshape(-1, 1).expand(b, 1)
    probs = torch.softmax(logits.float() / temperature.clamp_min(1e-6), dim=-1)
    kept = torch.where(probs >= _nucleus_threshold(probs, top_p), probs, 0.0)
    kept = kept / kept.sum(dim=-1, keepdim=True)
    draw = _categorical(kept, generator).to(torch.int32)
    return torch.where(temperature[:, 0] > 0.0, draw, greedy(logits))


def select_token(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    do_sample: bool,
    temperature: float,
    top_p: float,
) -> torch.Tensor:
    """Greedy or top-p by host flags (the reference's generation branch):
    sampled only when ``do_sample`` and ``temperature > 0``."""
    if do_sample and temperature > 0.0:
        return sample_top_p(logits, generator, temperature, top_p)
    return greedy(logits)


def select_token_traced(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    do_sample: bool,
    temperature: Scalar,
    top_p: Scalar,
) -> torch.Tensor:
    """``select_token`` with ``temperature`` and ``top_p`` as values on the
    device (only ``do_sample`` is a host branch): every sampled pair shares
    one captured graph, and ``temperature <= 0`` under ``do_sample``
    decodes greedily on the device."""
    if not do_sample:
        return greedy(logits)
    if not isinstance(temperature, torch.Tensor):  # a host value: branch on the host
        if temperature <= 0.0:
            return greedy(logits)
        return sample_top_p(logits, generator, max(temperature, 1e-6), top_p)
    draw = sample_top_p(logits, generator, temperature.clamp_min(1e-6), top_p)
    return torch.where(temperature.reshape(-1) > 0.0, draw, greedy(logits))

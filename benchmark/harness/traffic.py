"""The one traffic generator: a mix file's parameters and a seed -> requests.

Every seed gets the same multiset of sizes and gaps in another order: each
drawn quantity takes the stratified quantiles (i + 0.5) / n of its
distribution, shuffled by the seed, so runs on different seeds do the same
work. A closed loop's list is stratified in blocks of ``clients``
requests, so that the stretch a window reaches holds the whole set too. Prompts are printable ASCII; images are uint8 noise cut from one
seeded pool of bytes at a seeded offset.

Mix parameters (``traffic/<mix>.json``):

- ``loop``: "open" (arrivals on a schedule; the cell gives ``rate_per_s``)
  or "closed" (``clients`` callers, each sending its next request when the
  last one completes).
- ``output``: ``{"dist": "lognormal", "median", "sigma", "min", "max"}``
  or ``{"dist": "uniform", "min", "max"}``: each request's
  ``max_new_tokens`` (nothing else ends a request).
- ``prompt_bytes``: [min, max] bytes of prompt text, uniform.
- ``image_px``: [min, max] pixels of each side, uniform and independent.
- ``first_wave`` (closed loops): "residual" gives the first ``n_slots``
  requests the remaining life of a request met at a random moment (its
  length drawn in proportion to the length, then a uniform share of it),
  so the window starts near the steady state.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import List, Optional

import numpy as np
from PIL import Image

POOL_BYTES = 4 << 20  # the noise pool; an image is a slice of it
CLOSED_SPECS = 8192  # requests a closed loop can draw before it cycles


@dataclasses.dataclass
class Spec:
    index: int
    prompt: str
    width: int
    height: int
    offset: int  # into the noise pool
    max_new: int
    arrival: Optional[float] = None  # seconds after the window opens (open loop)


def _strata(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def _uniform_int(u: np.ndarray, lo: int, hi: int) -> np.ndarray:
    return np.minimum(lo + np.floor(u * (hi - lo + 1)), hi).astype(np.int64)


def output_lengths(out: dict, u: np.ndarray) -> np.ndarray:
    if out["dist"] == "uniform":
        return _uniform_int(u, out["min"], out["max"])
    if out["dist"] == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf(float(x)) for x in u])
        vals = np.round(np.exp(math.log(out["median"]) + out["sigma"] * z))
        return np.clip(vals, out["min"], out["max"]).astype(np.int64)
    raise ValueError(f"unknown output distribution {out['dist']!r}")


def residual_lengths(out: dict, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The remaining budget of requests met at random moments: a length
    drawn in proportion to itself, then ``ceil(v x length)``."""
    if out["dist"] != "uniform":
        raise ValueError("a residual first wave needs uniform output lengths")
    lo, hi = out["min"], out["max"]
    length = np.sqrt(lo * lo + u * (hi * hi - lo * lo))
    return np.clip(np.ceil(v * length), 1, hi).astype(np.int64)


def _shuffled_strata(rng, n: int, block: int) -> np.ndarray:
    """n stratified quantiles: each run of ``block`` (the last may be
    shorter) holds a whole stratified set, in the seed's order."""
    return np.concatenate([rng.permutation(_strata(min(block, n - i))) for i in range(0, n, block)])


def make_specs(mix: dict, seed: int, n: int, n_slots: int = 0, block: int = 0) -> List[Spec]:
    """``n`` requests in the order they are sent; with ``block``, every
    ``block`` consecutive requests hold the whole set of sizes, so any
    stretch of a closed loop does the same work whatever the seed."""
    rng = np.random.default_rng(int(seed))
    block = block or n
    k = min(n_slots, n) if mix.get("first_wave") == "residual" else 0
    lengths = output_lengths(mix["output"], _shuffled_strata(rng, n - k, block))
    if k:
        # One set of (length, share) pairs for every seed, in the seed's order.
        pairs = residual_lengths(mix["output"], _strata(k), np.random.default_rng(0).permutation(_strata(k)))
        lengths = np.concatenate([rng.permutation(pairs), lengths])
    p_lo, p_hi = mix["prompt_bytes"]
    prompt_len = _uniform_int(_shuffled_strata(rng, n, block), p_lo, p_hi)
    i_lo, i_hi = mix["image_px"]
    width = _uniform_int(_shuffled_strata(rng, n, block), i_lo, i_hi)
    height = _uniform_int(_shuffled_strata(rng, n, block), i_lo, i_hi)
    specs = []
    for i in range(n):
        text = bytes(rng.integers(32, 127, int(prompt_len[i]), dtype=np.uint8)).decode("ascii")
        size = int(width[i]) * int(height[i]) * 3
        specs.append(Spec(i, text, int(width[i]), int(height[i]),
                          int(rng.integers(0, POOL_BYTES - size + 1)), int(lengths[i])))
    return specs


def open_loop(mix: dict, seed: int, rate: float, seconds: float) -> List[Spec]:
    """round(rate x seconds) requests whose gaps are the stratified
    quantiles of an exponential of that rate, shuffled, scaled to fill
    [0, seconds); the first is due when the window opens."""
    n = max(1, int(round(rate * seconds)))
    specs = make_specs(mix, seed, n)
    rng = np.random.default_rng(int(seed) + 1)
    gaps = -np.log1p(-rng.permutation(_strata(n))) / rate
    starts = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    starts *= seconds / float(np.sum(gaps))
    for spec, t in zip(specs, starts):
        spec.arrival = float(t)
    return specs


def closed_loop(mix: dict, seed: int, n_slots: int) -> List[Spec]:
    """The callers' requests in the order they are sent, each run of
    ``clients`` of them a whole stratified set."""
    return make_specs(mix, seed, CLOSED_SPECS, n_slots, block=mix["clients"])


def noise_pool(seed: int) -> np.ndarray:
    return np.random.default_rng(int(seed) + 2).integers(0, 256, POOL_BYTES, dtype=np.uint8)


def image(pool: np.ndarray, spec: Spec) -> Image.Image:
    n = spec.width * spec.height * 3
    return Image.fromarray(pool[spec.offset:spec.offset + n].reshape(spec.height, spec.width, 3))

"""Operations and bytes that the model's work needs, from the configuration's
shapes alone (never from what implements the work), and the roofline
arithmetic over them. ``v`` and ``t`` are the configuration file's
``vision`` and ``text`` groups. A multiply-add counts as two operations;
each input byte is counted read once and each output byte written once.

The decoder's projections, per layer: qkv ((H + 2 Hkv) hd x D), o (D x
H hd), gate_up (2 I x D), down (D x I); the lm_head is the tied (V x D)
embedding.
"""
from __future__ import annotations

from typing import Iterable, List, Tuple

BF16 = 2


def projections(t: dict) -> List[Tuple[int, int]]:
    """(out, in) of one decoder layer's projections."""
    d, h, hkv, hd, i = (t[k] for k in ("hidden_size", "num_attention_heads", "num_key_value_heads",
                                        "head_dim", "intermediate_size"))
    return [((h + 2 * hkv) * hd, d), (d, h * hd), (2 * i, d), (d, i)]


def linear_params(t: dict) -> int:
    """Weights of every decoder projection (not the lm_head)."""
    return t["num_hidden_layers"] * sum(o * i for o, i in projections(t))


def tower_flops(v: dict, text_hidden: int) -> float:
    """One image through the patch embedding, the SigLIP layers (attention
    over all patches) and the projector."""
    d, i, p = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    n = (v["image_size"] // p) ** 2
    per_layer = 2 * n * (4 * d * d + 2 * d * i) + 4 * n * n * d
    return 2 * n * 3 * p * p * d + v["num_hidden_layers"] * per_layer + 2 * n * d * text_hidden


def attention_flops(t: dict, keys_sum: float) -> float:
    """QK^T and PV of queries that together see ``keys_sum`` keys."""
    return 4 * t["num_hidden_layers"] * t["num_attention_heads"] * t["head_dim"] * keys_sum


def lm_head_flops(t: dict, rows: int) -> float:
    return 2 * rows * t["hidden_size"] * t["vocab_size"]


def prefill_flops(t: dict, p: int) -> float:
    """A prompt of ``p`` positions (image and text), every position seeing
    all ``p``; the lm_head of the last position only."""
    return 2 * p * linear_params(t) + attention_flops(t, p * p) + lm_head_flops(t, 1)


def request_flops(v: dict, t: dict, p: int, first: int, last: int) -> float:
    """What tokens ``first`` .. ``last - 1`` of a request with a ``p``-position
    prompt need: token 0 is the prefill (with the image), token j >= 1 a
    decode step whose query sees p + j positions."""
    total = 0.0
    if first == 0 and last > 0:
        total += tower_flops(v, t["hidden_size"]) + prefill_flops(t, p)
        first = 1
    n = max(0, last - first)
    if n:
        total += n * (2 * linear_params(t) + lm_head_flops(t, 1)) + attention_flops(t, sum_keys(p, first, last))
    return total


def sum_keys(p: int, first: int, last: int) -> int:
    """Positions seen by the queries of tokens first .. last - 1 (token j
    sits at position p + j - 1 and sees p + j positions)."""
    n = last - first
    return n * p + (first + last - 1) * n // 2


def int8_bytes(o: int, i: int, rows: int, out_bytes: int = BF16) -> int:
    """An int8 weight-only product: the weight, one fp32 scale a row, the
    rows of x read and of the output written."""
    return o * i + 4 * o + rows * i * BF16 + rows * o * out_bytes


def gemv_step_bytes(t: dict, rows: int) -> int:
    """Every decoder projection and the int8 lm_head (fp32 out) at ``rows``."""
    layer = sum(int8_bytes(o, i, rows) for o, i in projections(t))
    return t["num_hidden_layers"] * layer + lm_head_bytes(t, rows)


def lm_head_bytes(t: dict, rows: int) -> int:
    return int8_bytes(t["vocab_size"], t["hidden_size"], rows, out_bytes=4)


def gemm_join(t: dict, rows: int) -> Tuple[float, float]:
    """(operations, bytes) of the decoder's int8 projections over ``rows``
    prompt positions of one join."""
    flops = 2.0 * rows * linear_params(t)
    nbytes = t["num_hidden_layers"] * sum(int8_bytes(o, i, rows) for o, i in projections(t))
    return flops, float(nbytes)


def decode_attention_bytes(t: dict, keys_sum: int, queries: int, cache_bytes: int = BF16) -> float:
    """K and V of the positions each query sees, with q and out."""
    l, h, hkv, hd = (t[k] for k in ("num_hidden_layers", "num_attention_heads", "num_key_value_heads",
                                     "head_dim"))
    return l * (2 * keys_sum * hkv * hd * cache_bytes + 2 * queries * h * hd * BF16)


def bound_s(flops: float, nbytes: float, peaks: dict) -> float:
    """The least time the card could take: operations at the bf16 peak or
    bytes at the memory rate, whichever is larger."""
    return max(flops / peaks["bf16_flops_per_s"], nbytes / peaks["hbm_bytes_per_s"])


def sum_bound(items: Iterable[Tuple[float, float]], peaks: dict) -> float:
    return sum(bound_s(f, b, peaks) for f, b in items)

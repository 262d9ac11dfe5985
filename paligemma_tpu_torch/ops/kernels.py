"""The bundle of kernel functions the model functions run.

Every model function takes one ``fns`` argument, a ``KernelFns``:

- ``KERNELS`` holds the dispatching wrappers (a CPU tensor runs the plain
  version, a CUDA tensor launches the kernel or raises);
- ``PLAIN`` holds the plain PyTorch versions, which never launch a kernel,
  so a caller can run the same model on the card without the kernels.
"""
from __future__ import annotations

from typing import Callable, Mapping, NamedTuple

import torch

from paligemma_tpu_torch.ops import cuda_attention as ca
from paligemma_tpu_torch.ops import quant


class KernelFns(NamedTuple):
    """``flash``: SigLIP and prefill attention; ``decode``: one token against
    the cache (bf16 or int8); ``q8``: every int8 projection and the int8
    lm_head; ``q4``: the int4 weight-only projections; ``a8``: int8 x int8
    projections of long calls (``prefill_a8``; a row-parallel call passes
    its group's reductions); ``q4a8``: the 4-bit lm_head;
    ``mlp_w4a8``: the w4a8 MLP."""

    flash: Callable[..., torch.Tensor]
    decode: Callable[..., torch.Tensor]
    q8: Callable[..., torch.Tensor]
    q4: Callable[..., torch.Tensor]
    a8: Callable[..., torch.Tensor]
    q4a8: Callable[..., torch.Tensor]
    mlp_w4a8: Callable[..., torch.Tensor]


KERNELS = KernelFns(
    ca.flash_attention, ca.decode_attention, quant.q8_matmul, quant.q4_matmul, quant.a8_matmul,
    quant.q4a8_matmul, quant.mlp_w4a8,
)
PLAIN = KernelFns(
    ca.flash_attention_plain, ca.decode_attention_plain, quant.q8_matmul_plain,
    quant.q4_matmul_plain, quant.a8_matmul_plain, quant.q4a8_matmul_plain, quant.mlp_w4a8_plain,
)


def launch_counts() -> dict:
    """Launches of every kernel."""
    return {**ca.launch_counts(), **quant.launch_counts()}


def call_counts() -> dict:
    """``launch_counts`` and the int8 x int8 products' calls under the name
    ``a8_matmul`` (``torch._int_mm``, not a kernel of the port): what the
    replay of a CUDA graph adds back."""
    return {**launch_counts(), "a8_matmul": quant.a8_matmul.calls}


def add_launch_counts(counts: Mapping[str, int]) -> None:
    """Add ``counts`` (named as ``call_counts`` names them) to the launch
    counts and the int8 x int8 calls. The replay of a CUDA graph adds what
    was captured in it: its kernels run without their wrappers."""
    ca.add_launch_counts(counts)
    quant.add_launch_counts(counts)


def reset_launch_counts() -> None:
    """Zero every launch count (and ``quant.a8_matmul``'s call count)."""
    ca.reset_launch_counts()
    quant.reset_launch_counts()

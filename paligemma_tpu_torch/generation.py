"""Greedy generation (port of ``paligemma_tpu/generation.py``: ``make_cache``,
prefill, ``decode_steps`` and ``generate``).

- ``decode_steps`` runs a chunk of greedy steps with no host sync inside it:
  tokens stay on the device until the caller reads the chunk.
- ``generate`` is the batch-1 loop of the reference's inference script with
  a host-side EOS exit (one ``.item()`` per token, like the reference).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from paligemma_tpu_torch.models import gemma, paligemma
from paligemma_tpu_torch.models.gemma import KVCache
from paligemma_tpu_torch.models.paligemma import PaliGemma
from paligemma_tpu_torch.ops.kernels import KERNELS, KernelFns
from paligemma_tpu_torch.ops.sampling import greedy


def make_cache(
    model: PaliGemma,
    batch: int,
    prompt_len: int,
    max_new_tokens: int,
    cache_dtype: Optional[torch.dtype] = None,
) -> KVCache:
    """A cache for ``prompt_len + max_new_tokens`` positions on the model's
    device. ``cache_dtype`` None: the decoder's activation dtype (the
    attention kernels take the activations' dtype; an int8 embedding makes
    it bf16); ``torch.int8``: a ``QuantKVCache``."""
    dtype = gemma.activation_dtype(model.llm) if cache_dtype is None else cache_dtype
    return gemma.init_cache(
        model.cfg.text_config, batch, prompt_len + max_new_tokens, dtype,
        model.llm.final_norm.weight.device,
    )


@torch.no_grad()
def prefill(
    model: PaliGemma,
    input_ids: torch.Tensor,
    pixel_values: torch.Tensor,
    cache: KVCache,
    fns: KernelFns = KERNELS,
) -> Tuple[torch.Tensor, KVCache]:
    """Prefill with last-position logits only: (B, 1, V) fp32 + warm cache."""
    return paligemma.prefill(model, input_ids, pixel_values, cache, full_logits=False, fns=fns)


@torch.no_grad()
def decode_steps(
    model: PaliGemma,
    token: torch.Tensor,
    cache: KVCache,
    n_steps: int,
    fns: KernelFns = KERNELS,
) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """``n_steps`` greedy steps from the (B, 1) ``token``.

    Returns (tokens (B, n_steps), last token (B, 1), cache); nothing is read
    back to the host.
    """
    toks = []
    for _ in range(n_steps):
        logits, cache = paligemma.decode_step(model, token, cache, fns)
        token = greedy(logits[:, -1, :])[:, None]
        toks.append(token)
    return torch.cat(toks, dim=1), token, cache


@torch.no_grad()
def generate(
    model: PaliGemma,
    input_ids: torch.Tensor,
    pixel_values: torch.Tensor,
    max_new_tokens: int,
    eos_token_id: int,
    step_callback: Optional[Callable[[int], None]] = None,
    fns: KernelFns = KERNELS,
    cache_dtype: Optional[torch.dtype] = None,
) -> Tuple[List[int], KVCache]:
    """Batch-1 greedy generation with a host EOS exit (``eos_token_id=-1``
    never matches a token, so it always runs ``max_new_tokens`` steps).

    ``step_callback(step)`` runs after each token has reached the host
    (step 0 is the prefill's token). ``cache_dtype``: as ``make_cache``'s
    (``torch.int8`` for the int8 cache). Returns (token ids, final cache).
    """
    b, t = input_ids.shape
    if b != 1:
        raise ValueError(f"generate() is batch-1 (got batch {b})")
    cache = make_cache(model, b, t, max_new_tokens, cache_dtype)
    logits, cache = prefill(model, input_ids, pixel_values, cache, fns)
    token = greedy(logits[:, -1, :])
    out = [int(token[0])]
    if step_callback is not None:
        step_callback(0)
    for step in range(1, max_new_tokens):
        if out[-1] == eos_token_id:
            break
        logits, cache = paligemma.decode_step(model, token[:, None], cache, fns)
        token = greedy(logits[:, -1, :])
        out.append(int(token[0]))  # host sync, like the reference's .item()
        if step_callback is not None:
            step_callback(step)
    return out, cache

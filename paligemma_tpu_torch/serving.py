"""Batched multi-image VQA serving (port of ``paligemma_tpu/serving.py``).

N images + N prompts -> one right-padded batch -> batched prefill ->
decode -> N decoded strings. Prompts are templated as the reference does
(``<image>*N + BOS + prompt + \\n``) and right-padded to the longest.
PaliGemma's prefix-LM attention is bidirectional over the prefix, so pad
slots are masked: row b attends to its own prompt ``[0, valid_b)`` plus
every shared generated slot ``[T_pad, length + 1)``; pad slots (garbage K/V
from the padded prefill, or stale rows of a pooled cache) stay masked. Per
row, RoPE positions are ``valid_b + g`` after g generated tokens, so each
row continues at its own length, as if it ran unpadded at batch 1.

- ``batched_prefill`` is eager (the first token's logits of each row's
  last valid position).
- A decode step is one CUDA graph on a CUDA cache, captured once per
  (cache buffers, model, ``fns``, ``t_prompt``, sampling) and replayed n
  times a chunk: the counterpart of the reference's jitted ``lax.scan``.
  The window's end, ``length + 1``, is computed on the device inside the
  step and read there by the decode kernel, so one graph serves every
  step. The row lengths are a static buffer of the graph, set before each
  chunk. On a CPU cache the same step runs eagerly.
- ``batch_generate`` takes its cache from ``generation``'s per-model pool,
  so a batch of a known shape captures nothing.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from paligemma_tpu_torch import generation
from paligemma_tpu_torch.generation import Scalar
from paligemma_tpu_torch.models import gemma, paligemma
from paligemma_tpu_torch.models.gemma import KVCache
from paligemma_tpu_torch.models.paligemma import PaliGemma
from paligemma_tpu_torch.ops.attention import LengthMask, make_length_mask
from paligemma_tpu_torch.ops.kernels import KERNELS, KernelFns
from paligemma_tpu_torch.ops.sampling import select_token_traced

# Decode steps a ``batch_generate`` chunk takes between host reads (the
# reference's chunk).
CHUNK = 16


def pad_batch(
    processor,
    prompts: List[str],
    images: List,
    prompt_bucket: Optional[int] = None,
    batch_bucket: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Per-sample processing + right-padding.

    Pads to the longest prompt; ``prompt_bucket`` rounds the padded length
    up to a multiple, and ``batch_bucket`` rounds the batch size up by
    repeating the first sample, so serving traffic reuses a few shapes (and
    their captured graphs).

    Returns (input_ids (B', T), valid_len (B',), pixel_values, real_batch).
    """
    assert len(prompts) == len(images)
    ids_list, pix_list = [], []
    for prompt, image in zip(prompts, images):
        out = processor(text=[prompt], images=[image])
        ids_list.append(np.asarray(out["input_ids"][0], np.int32))
        pix_list.append(out["pixel_values"][0])
    real_b = len(ids_list)
    if batch_bucket:
        while len(ids_list) % batch_bucket:
            ids_list.append(ids_list[0])
            pix_list.append(pix_list[0])
    max_len = max(len(x) for x in ids_list)
    if prompt_bucket:
        max_len = -(-max_len // prompt_bucket) * prompt_bucket
    b = len(ids_list)
    ids = np.zeros((b, max_len), np.int32)
    valid = np.zeros((b,), np.int32)
    for i, row in enumerate(ids_list):
        ids[i, : len(row)] = row
        valid[i] = len(row)
    return ids, valid, np.stack(pix_list, axis=0), real_b


@torch.no_grad()
def batched_prefill(
    model: PaliGemma,
    input_ids: torch.Tensor,
    pixel_values: torch.Tensor,
    valid: torch.Tensor,
    cache: KVCache,
    fns: KernelFns = KERNELS,
    lora=None,
) -> Tuple[torch.Tensor, KVCache]:
    """Prefill a right-padded batch with per-row validity masking.

    ``valid`` (B,) int32 on the model's device. Returns (fp32 logits (B, V)
    of each row's last valid position, the warm cache). The cache's length
    advances by the padded T; pad slots hold garbage K/V that decode keeps
    masked. RoPE positions past a row's length are clamped to its last.
    ``lora``: per-row decoder adapters (``{"q"|"k"|"v": {"a": (L, B, D, r),
    "b": (L, B, r, out)}}``, the scale folded into b): each row of a join
    group carries its own.
    """
    b, t = input_ids.shape
    embeds = paligemma.merge_prefix(model, input_ids, paligemma.encode_image(model, pixel_values, fns))
    last = (valid - 1).clamp_min(0)
    positions = torch.minimum(
        torch.arange(t, dtype=torch.int32, device=input_ids.device)[None, :], last[:, None])
    mask = make_length_mask(valid, batch=b, device=input_ids.device)
    hidden, cache = gemma.forward(model.llm, embeds, positions, cache, fns, mask=mask, lora=lora)
    idx = last.long()[:, None, None].expand(b, 1, hidden.shape[-1])
    return gemma.logits(model.llm, hidden.gather(1, idx), fns)[:, 0, :], cache


def _batched_decode_step(
    model: PaliGemma, cache: KVCache, st: generation._StepState, valid: torch.Tensor,
    t_prompt: int, fns: KernelFns, do_sample: bool,
) -> None:
    """One decode step of a padded batch, in place: ``st.token`` -> the next
    token, the cache advanced by one. ``valid`` (B,): the rows' prompt
    lengths. With g = length - t_prompt tokens generated, row b sits at
    position valid_b + g and sees ``[0, valid_b) ∪ [t_prompt, length + 1)``
    (this step's write included)."""
    positions = (valid + (cache.length - t_prompt))[:, None]
    mask = LengthMask(valid=valid, gen_start=t_prompt, gen_end=cache.length + 1)
    embeds = gemma.embed_tokens(model.llm, st.token)
    hidden, _ = gemma.forward(model.llm, embeds, positions, cache, fns, mask=mask)
    logits = gemma.logits(model.llm, hidden, fns)[:, -1, :]
    st.token.copy_(select_token_traced(logits, st.generator, do_sample, st.temperature, st.top_p)[:, None])
    st.out.index_copy_(1, st.step, st.token)
    st.step.add_(1)


class _BatchedDecodeRunner(generation._DecodeRunner):
    """``_batched_decode_step`` on one cache's buffers for one ``t_prompt``:
    eager on a CPU cache, a CUDA graph replayed once a step on a CUDA cache
    (captured by ``generation._DecodeRunner``, with the row lengths a
    static buffer)."""

    def __init__(self, model, cache, fns, do_sample, t_prompt: int):
        self.t_prompt = t_prompt
        self.valid = torch.zeros(cache.valid.shape[0], dtype=torch.int32, device=cache.k.device)
        super().__init__(model, cache, fns, do_sample, freeze=False)

    def _step(self, model, cache) -> None:
        _batched_decode_step(model, cache, self.state, self.valid, self.t_prompt, self.fns, self.do_sample)

    def start_rows(self, token: torch.Tensor, valid: torch.Tensor, temperature: Scalar,
                   top_p: Scalar) -> None:
        self.valid.copy_(valid)
        self.start(token, temperature, top_p)


def _runner(model: PaliGemma, cache: KVCache, fns: KernelFns, do_sample: bool,
            t_prompt: int) -> _BatchedDecodeRunner:
    """The cache's batched-step runner, captured now if it has none that
    reads this model and these buffers."""
    key = ("batched", id(model), fns, do_sample, t_prompt)
    runner = cache.graphs.get(key)
    if runner is None or not runner.serves(model, cache):
        runner = cache.graphs[key] = _BatchedDecodeRunner(model, cache, fns, do_sample, t_prompt)
    return runner


@torch.no_grad()
def prepare_batched_decode(
    model: PaliGemma, cache: KVCache, t_prompt: int, fns: KernelFns = KERNELS, *,
    do_sample: bool = False,
) -> float:
    """Capture the cache's batched decode step for ``t_prompt`` now, before a
    timed chunk needs it. Returns the capture's host ms (0.0 when nothing
    was captured: a CPU cache, or captured already)."""
    had = cache.graphs.get(("batched", id(model), fns, do_sample, t_prompt))
    runner = _runner(model, cache, fns, do_sample, t_prompt)
    return runner.capture_ms if runner is not had else 0.0


@torch.no_grad()
def batched_decode_steps(
    model: PaliGemma,
    token: torch.Tensor,
    cache: KVCache,
    valid: torch.Tensor,
    n_steps: int,
    t_prompt: int,
    fns: KernelFns = KERNELS,
    *,
    generator: Optional[torch.Generator] = None,
    do_sample: bool = False,
    temperature: Scalar = 0.8,
    top_p: Scalar = 0.9,
) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """``n_steps`` batched decode steps from the (B, 1) ``token`` after a
    ``batched_prefill`` of padded length ``t_prompt`` with row lengths
    ``valid`` (B,); on a CUDA cache, ``n_steps`` replays of the captured
    step with no host sync.

    Returns (tokens (B, n_steps) int32, last token (B, 1), cache).
    """
    runner = _runner(model, cache, fns, do_sample, t_prompt)
    runner.start_rows(token, valid, temperature, top_p)
    runner.run(model, cache, n_steps, generator)
    st = runner.state
    return st.out[:, :n_steps].clone(), st.token.clone(), cache


def batched_decode_step(
    model: PaliGemma, token: torch.Tensor, cache: KVCache, valid: torch.Tensor, t_prompt: int,
    fns: KernelFns = KERNELS, **kwargs,
) -> Tuple[torch.Tensor, KVCache]:
    """One batched decode step: (next token (B,), cache)."""
    toks, _, cache = batched_decode_steps(model, token, cache, valid, 1, t_prompt, fns, **kwargs)
    return toks[:, 0], cache


@torch.no_grad()
def batch_generate(
    model: PaliGemma,
    processor,
    prompts: List[str],
    images: List,
    max_new_tokens: int = 100,
    do_sample: bool = False,
    temperature: float = 0.8,
    top_p: float = 0.9,
    eos_token_id: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    cache_dtype: Optional[torch.dtype] = None,
    prompt_bucket: Optional[int] = None,
    batch_bucket: Optional[int] = None,
    return_tokens: bool = False,
    fns: KernelFns = KERNELS,
):
    """End-to-end batched VQA: prompts + images -> decoded strings.

    ``return_tokens=True`` returns (texts, token_id_lists) instead. See
    ``pad_batch`` for the shape-bucketing knobs. Decodes in ``CHUNK``-step
    chunks (one host read a chunk) until every row has emitted EOS or
    ``max_new_tokens`` are out; each row is trimmed at its first EOS.
    """
    if eos_token_id is None:
        eos_token_id = processor.tokenizer.eos_token_id
    ids_np, valid_np, pix_np, real_b = pad_batch(processor, prompts, images, prompt_bucket, batch_bucket)
    b, t = ids_np.shape
    dev = model.llm.final_norm.weight.device
    ids = torch.from_numpy(ids_np).to(dev)
    valid = torch.from_numpy(valid_np).to(dev)
    pix = torch.from_numpy(pix_np).to(dev, model.vision.patch_embedding.weight.dtype)

    # The cache holds a whole number of chunks, so every chunk replays one
    # graph; surplus tokens are trimmed below.
    alloc = -(-max(max_new_tokens - 1, 1) // CHUNK) * CHUNK + 1
    cache = generation._pooled_cache(model, b, t, alloc, cache_dtype)
    logits, cache = batched_prefill(model, ids, pix, valid, cache, fns)
    tok = select_token_traced(logits, generator, do_sample, temperature, top_p)

    columns = [tok.cpu().numpy()[:, None]]
    done = columns[0][:, 0] == eos_token_id
    remaining = max_new_tokens - 1
    tok = tok[:, None]
    while remaining > 0 and not bool(np.all(done)):
        toks, tok, cache = batched_decode_steps(
            model, tok, cache, valid, CHUNK, t, fns, generator=generator, do_sample=do_sample,
            temperature=temperature, top_p=top_p,
        )
        toks_np = toks.cpu().numpy()  # one host read a chunk
        columns.append(toks_np)
        done = done | np.any(toks_np == eos_token_id, axis=1)
        remaining -= CHUNK

    mat = np.concatenate(columns, axis=1)[:, :max_new_tokens]
    outs, token_rows = [], []
    for i in range(real_b):
        row = mat[i].tolist()
        if eos_token_id in row:
            row = row[: row.index(eos_token_id) + 1]
        token_rows.append(row)
        outs.append(processor.tokenizer.decode(row, skip_special_tokens=True))
    if return_tokens:
        return outs, token_rows
    return outs

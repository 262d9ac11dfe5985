"""PaliGemma: SigLIP tower + projector + Gemma decoder (port of
``paligemma_tpu/models/paligemma.py``, the prefill/decode/verify path).

- The projector is one biased linear, vision_hidden -> projection_dim; image
  features are scaled by 1/sqrt(hidden) to cancel the decoder's sqrt(hidden)
  embedding scale.
- The processor emits image tokens as a fixed-length prefix, so the merge is
  a concat; only ``input_ids[:, n_img:]`` is embedded (the image token id may
  lie outside the embedding table, and ``F.embedding`` raises where
  ``jnp.take`` clamps).
- Prefill positions are 0..T-1; a decode step sits at position = cache
  length, read on the device (nothing goes back to the host), and a
  speculative verify step (``verify_step``) at length .. length + k - 1.
- ``forward_nocache`` is the KV-cache-off ablation arm and the LoRA
  trainer's forward: the full bidirectional pass over a (padded) buffer,
  positions 0..T-1; ``loss_fn`` its shifted cross-entropy; ``forward`` the
  reference-shaped router over the three.

Every function takes ``fns``, the kernel functions to run
(``ops.kernels.KernelFns``); the default dispatches to the CUDA kernels on a
CUDA tensor, ``ops.kernels.PLAIN`` runs the plain versions.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from paligemma_tpu_torch.config import PaliGemmaConfig
from paligemma_tpu_torch.models import gemma, siglip
from paligemma_tpu_torch.models.gemma import GemmaModel, KVCache, RMSNorm
from paligemma_tpu_torch.models.siglip import LayerNorm, SiglipVisionModel, linear
from paligemma_tpu_torch.ops.attention import make_length_mask
from paligemma_tpu_torch.ops.kernels import KERNELS, KernelFns


class PaliGemma(nn.Module):
    def __init__(self, cfg: PaliGemmaConfig, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.vision = SiglipVisionModel(cfg.vision_config, dtype)
        self.projector = nn.Linear(cfg.vision_config.hidden_size, cfg.projection_dim, dtype=dtype)
        self.llm = GemmaModel(cfg.text_config, dtype)


def empty_model(cfg: PaliGemmaConfig, device, dtype: torch.dtype) -> PaliGemma:
    """A PaliGemma with uninitialized storage on ``device`` (no init pass)."""
    with torch.device("meta"):
        model = PaliGemma(cfg, dtype)
    return model.to_empty(device=device).requires_grad_(False)


def init_params(
    cfg: PaliGemmaConfig,
    generator: Union[int, torch.Generator],
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> PaliGemma:
    """Random weights made on ``device`` from a seed or generator, with the
    reference's scheme: linear weights and embeddings ~ N(0, 1/fan_in),
    biases 0, LayerNorm scale 1, RMSNorm weight 0 (it scales by 1 + w)."""
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=device).manual_seed(int(generator))
    model = empty_model(cfg, device, dtype)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, mod.in_features**-0.5, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, RMSNorm):
                mod.weight.zero_()
        for emb in (model.vision.position_embedding, model.llm.embed):
            emb.normal_(0.0, emb.shape[-1] ** -0.5, generator=generator)
    return model


def encode_image(
    model: PaliGemma, pixel_values: torch.Tensor, fns: KernelFns = KERNELS
) -> torch.Tensor:
    """(B, C, H, W) -> (B, N_img, hidden): vision tower, projector, 1/sqrt(hidden)."""
    feats = siglip.apply(model.vision, pixel_values, fns)
    proj = linear(feats, model.projector, fns)
    return proj / torch.tensor(model.cfg.hidden_size**0.5, dtype=proj.dtype)


def merge_prefix(
    model: PaliGemma, input_ids: torch.Tensor, image_features: torch.Tensor
) -> torch.Tensor:
    """Image features at positions [0, N_img), text embeddings after them."""
    n_img = image_features.shape[1]
    text_embeds = gemma.embed_tokens(model.llm, input_ids[:, n_img:])
    return torch.cat([image_features.to(text_embeds.dtype), text_embeds], dim=1)


def prefill(
    model: PaliGemma,
    input_ids: torch.Tensor,
    pixel_values: torch.Tensor,
    cache: KVCache,
    full_logits: bool = True,
    fns: KernelFns = KERNELS,
    sequence_parallel: bool = False,
) -> Tuple[torch.Tensor, KVCache]:
    """Image + templated prompt -> fp32 logits (B, T or 1, V) + the warm cache.

    ``full_logits=False`` computes the lm_head for the last position only.
    ``sequence_parallel``: see ``gemma.forward`` (a tensor-parallel model).
    """
    b, t = input_ids.shape
    embeds = merge_prefix(model, input_ids, encode_image(model, pixel_values, fns))
    positions = torch.arange(t, dtype=torch.int32, device=input_ids.device).expand(b, t)
    hidden, cache = gemma.forward(model.llm, embeds, positions, cache, fns,
                                  sequence_parallel=sequence_parallel)
    if not full_logits:
        hidden = hidden[:, -1:, :]
    return gemma.logits(model.llm, hidden, fns), cache


def decode_step(
    model: PaliGemma, token: torch.Tensor, cache: KVCache, fns: KernelFns = KERNELS
) -> Tuple[torch.Tensor, KVCache]:
    """One step: (B, 1) token -> (B, 1, V) fp32 logits; the cache advances by
    one. The position is the device cache length, so the step reads nothing
    back to the host and can be captured in a CUDA graph."""
    positions = cache.length.view(1, 1).expand(token.shape[0], 1)
    embeds = gemma.embed_tokens(model.llm, token)
    hidden, cache = gemma.forward(model.llm, embeds, positions, cache, fns)
    return gemma.logits(model.llm, hidden, fns), cache


def verify_step(
    model: PaliGemma, tokens: torch.Tensor, cache: KVCache, fns: KernelFns = KERNELS
) -> Tuple[torch.Tensor, KVCache]:
    """Speculative verify step: (B, k) tokens ``[last accepted, d1 ..
    d_{k-1}]`` at positions ``length .. length + k - 1`` in one forward ->
    (B, k, V) fp32 logits. Row i's logits predict the token after position
    ``length + i`` (query i sees the cache up to its own position), so its
    argmax is what the i-th of k sequential ``decode_step`` calls would
    choose. The cache holds the K/V of all k positions and ``length`` has
    advanced by k; the caller rolls ``length`` back to the accepted count
    (the rows past it are invisible to every later step and overwritten
    when those positions are reached)."""
    b, k = tokens.shape
    positions = (cache.length + torch.arange(k, dtype=torch.int32, device=tokens.device)).expand(b, k)
    embeds = gemma.embed_tokens(model.llm, tokens)
    hidden, cache = gemma.forward(model.llm, embeds, positions, cache, fns, multi_token_decode=True)
    return gemma.logits(model.llm, hidden, fns), cache


def forward_nocache(
    model: PaliGemma,
    input_ids: torch.Tensor,
    pixel_values: torch.Tensor,
    valid_len: Optional[torch.Tensor] = None,
    fns: KernelFns = KERNELS,
    lora=None,
    lora_scale: float = 1.0,
    lora_dropout: float = 0.0,
    lora_generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Cache-free full forward for the KV-cache-off ablation arm and the
    LoRA trainer: fp32 logits (B, T, V).

    The reference's no-cache loop body: full bidirectional attention over
    the whole (padded) sequence, positions 0..T-1. ``valid_len`` ((B,) int32
    on the device, or None: all T) masks the padding slots, so one padded
    buffer serves every step; positions past it are don't-cares. ``lora``
    and its scale, dropout and generator go to ``gemma.forward``; the
    vision tower and the projector carry no adapter and run without
    building an autograd graph.
    """
    b, t = input_ids.shape
    with torch.no_grad():
        embeds = merge_prefix(model, input_ids, encode_image(model, pixel_values, fns))
    positions = torch.arange(t, dtype=torch.int32, device=input_ids.device).expand(b, t)
    mask = None if valid_len is None else make_length_mask(valid_len, batch=b, device=input_ids.device)
    hidden, _ = gemma.forward(model.llm, embeds, positions, None, fns, mask=mask, lora=lora,
                              lora_scale=lora_scale, lora_dropout=lora_dropout,
                              lora_generator=lora_generator)
    return gemma.logits(model.llm, hidden, fns)


def shifted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int,
                          count_reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """Mean next-token cross-entropy: position t's logits against label
    t + 1, fp32 log-softmax, labels equal to ``ignore_index`` skipped, the
    sum over valid labels divided by ``max(n_valid, 1)``. ``count_reduce``
    maps this batch's count of valid labels to the divisor's (data
    parallelism: the count over every data rank's rows)."""
    if labels.shape != logits.shape[:2]:
        raise ValueError(f"labels {tuple(labels.shape)} do not match the logits' {tuple(logits.shape[:2])}")
    shift_logits = logits[:, :-1, :]
    shift_labels = labels[:, 1:].long()
    valid = shift_labels != ignore_index
    safe = torch.where(valid, shift_labels, 0)
    logp = torch.log_softmax(shift_logits.float(), dim=-1)
    tok_lp = logp.gather(-1, safe[..., None])[..., 0]
    n_valid = valid.sum()
    if count_reduce is not None:
        n_valid = count_reduce(n_valid)
    return -torch.where(valid, tok_lp, 0.0).sum() / n_valid.clamp_min(1)


def loss_fn(
    model: PaliGemma,
    input_ids: torch.Tensor,
    pixel_values: torch.Tensor,
    labels: torch.Tensor,
    valid_len: Optional[torch.Tensor] = None,
    lora=None,
    lora_scale: float = 1.0,
    lora_dropout: float = 0.0,
    lora_generator: Optional[torch.Generator] = None,
    fns: KernelFns = KERNELS,
    count_reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Shifted cross-entropy with ignore_index over ``forward_nocache``'s
    logits: a 0-d fp32 tensor (``count_reduce``: see
    ``shifted_cross_entropy``)."""
    logits = forward_nocache(model, input_ids, pixel_values, valid_len, fns, lora=lora,
                             lora_scale=lora_scale, lora_dropout=lora_dropout,
                             lora_generator=lora_generator)
    return shifted_cross_entropy(logits, labels, model.cfg.ignore_index, count_reduce)


def forward(
    model: PaliGemma,
    input_ids: torch.Tensor,
    pixel_values: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
    kv_cache: Optional[KVCache] = None,
    labels: Optional[torch.Tensor] = None,
    fns: KernelFns = KERNELS,
) -> Dict[str, object]:
    """Reference-shaped forward: ``{"logits"[, "loss"][, "kv_cache"]}``.

    Routing on host values, as the reference's: no cache -> the full
    forward without a cache; an empty cache -> prefill; a warm cache and
    one token -> a decode step (more than one token raises ValueError).
    ``attention_mask`` must be all ones ("The input cannot be padded");
    padded batches go through ``serving``.
    """
    if attention_mask is not None and not bool((attention_mask == 1).all()):
        raise AssertionError("The input cannot be padded")
    out: Dict[str, object] = {}
    if kv_cache is None:
        logits = forward_nocache(model, input_ids, pixel_values, fns=fns)
    else:
        if kv_cache.host_length > 0:
            if input_ids.shape[1] != 1:
                raise ValueError(
                    "warm-cache continuation supports one token per step "
                    f"(got {input_ids.shape[1]}); decode token-by-token, or prefill the "
                    "whole prefix into a fresh cache"
                )
            logits, kv_cache = decode_step(model, input_ids, kv_cache, fns)
        else:
            logits, kv_cache = prefill(model, input_ids, pixel_values, kv_cache, fns=fns)
        out["kv_cache"] = kv_cache
    out["logits"] = logits
    if labels is not None:
        out["loss"] = shifted_cross_entropy(logits, labels, model.cfg.ignore_index)
    return out

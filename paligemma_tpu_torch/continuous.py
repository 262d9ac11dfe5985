"""Continuous (slot-level) batching (port of ``paligemma_tpu/continuous.py``):
requests join and leave a running batch.

A fixed set of decode slots stays hot. Each chunk steps every slot; a new
request joins between chunks (a bucketed prefill of its group, whose K/V
rows are scattered into free slots) and leaves on its EOS or its budget.
Each slot carries its own length: K/V writes, RoPE positions and the
visible prefix are per row (``gemma.forward(row_lengths=...)``), so a slot
gives the tokens it would give alone at batch 1.

The device programs, each the counterpart of a jitted function of the
reference:

- ``_slot_decode_step`` (``slot_decode_steps``'s body) and
  ``_slot_verify_step`` (``slot_decode_steps_spec``'s body) run in place on
  the engine's static buffers (``_SlotState``) and on one window of the
  slot cache. On a CUDA model each is captured as one CUDA graph per key
  (window width, chunk flavour: plain, plain with the token history, or
  speculative with its k, n and drafter; greedy or sampled) and a chunk is
  n replays of it (a whole-chunk graph measured no faster, PERF.md). The
  reference picks greedy or sampled on the device (``lax.cond`` over the
  occupied rows' temperatures); the host knows the same fact, the
  temperatures of its occupied requests, and picks the graph.
- ``_resize_kv`` is a view: the cache is allocated once at full length and
  a window of width W is ``[:, :, :W]`` of it. The decode kernel's result
  does not depend on the buffer's length, so a view gives the reference's
  bits and copies nothing.
- The join's ``serving.batched_prefill`` is one captured graph per (group
  batch, prompt bucket) (``_JoinPrefill``), the counterpart of the jitted
  one; ``_insert_group`` stays eager. The reference pads every group of 2
  or more to ``n_slots`` (each shape is a compile); here a group runs at
  the smallest rung of ``join_batches(n_slots)`` that holds it (1, the
  powers of two below ``n_slots``, ``n_slots``), each rung one graph.

Writes past a buffer: the reference drops out-of-bounds scatter writes and
clamps ``dynamic_update_slice``, and relies on both (a freed slot keeps
stepping; a freed slot's stale length can pass a shrunk window). On CUDA
an index past a buffer is a device-side assert, so no such index reaches
the device: cache writes are clamped to a row's last position
(``gemma.forward``), the token-history scatter to the buffer's last column,
and the verify's ``out`` / history writes clamp their start as
``dynamic_update_slice`` does. Only rows of free slots (and the trash row
that takes a group's pad rows) ever write there, and nothing reads those
rows before a join rewrites them.

Multi-tenant LoRA (``lora_rank``): every slot carries its own q/k/v
adapters, rows of per-slot tensors ``(L, n_slots + 1, D, r)`` allocated
once (``_SlotState.lora``) and written in place by each join (a base
request, a pad row and the trash row take the all-zeros adapter, an exact
no-op). The captured graphs read those tensors; the join group's adapters
reach the captured join prefill through static buffers of its runner.
Registered adapters have their scale folded into b and are zero-padded to
the engine's rank.

Tensor parallelism: the model may be a rank's tensor-parallel model
(``parallel.sharding.shard_params``). Every rank of its model group runs
the same engine on the same requests: the logits are gathered to every
rank, so the host's decisions (tokens, joins, evictions, the speculative
policy) are the same on each, and the sampling generators are seeded
alike. Its cache holds the rank's kv heads (``model.cfg`` is the rank's).
Over gloo nothing is captured (``generation.graphs_on``): the steps and
join prefills run eagerly; over NCCL as on one card.

Captures run in ``thread_local`` mode and under the engine's device lock,
which the prefetch worker's staged uploads also take. Staged uploads go
through pinned host memory on a side stream with an event that the
engine's stream waits on. One host read a chunk: the chunk's tokens (and
the first tokens of groups joined before it) are copied to pinned memory
right behind the chunk, the join of the next group is enqueued, and then
the host waits for that copy only.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import threading
import time
from collections import OrderedDict, defaultdict, deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from paligemma_tpu_torch import generation, lora, processing, quantization, serving
from paligemma_tpu_torch.models import gemma
from paligemma_tpu_torch.models.gemma import KVCache
from paligemma_tpu_torch.models.paligemma import PaliGemma
from paligemma_tpu_torch.ops.cuda_attention import MAX_DECODE_QUERIES
from paligemma_tpu_torch.ops.kernels import KERNELS, KernelFns
from paligemma_tpu_torch.ops.sampling import greedy, sample_rows

# ---------------------------------------------------------------------------
# The device programs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class _SlotState:
    """The engine's per-slot buffers on the device (the static buffers every
    captured step reads and writes). B = n_slots + 1 (the trash row)."""

    token: torch.Tensor  # (B, 1) int32, each slot's current token
    lengths: torch.Tensor  # (B,) int32, each slot's length
    temps: torch.Tensor  # (B,) fp32, <= 0: greedy
    topps: torch.Tensor  # (B,) fp32
    out: torch.Tensor  # (B, W) int32, a chunk's tokens
    step: torch.Tensor  # (1,) int64, a plain chunk's column
    counts: torch.Tensor  # (B,) int32, a speculative chunk's tokens a row
    ids_buf: Optional[torch.Tensor] = None  # (B, L) int32 prompt + emitted ids
    buf_lens: Optional[torch.Tensor] = None  # (B,) int32
    noise: Optional[torch.Tensor] = None  # () fp32, the draft-noise probability
    # Per-slot adapters {"q"|"k"|"v": {"a": (L, B, D, r), "b": (L, B, r, out)}}
    # fp32, scale folded into b; written in place by joins, never by a step.
    lora: Optional[dict] = None

    def tensors(self) -> List[torch.Tensor]:
        return [getattr(self, f.name) for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)]


def _rows(b: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(b, dtype=torch.int64, device=like.device)


def _slot_decode_step(model: PaliGemma, cache: KVCache, st: _SlotState, fns: KernelFns,
                      do_sample: bool, track_ids: bool, generator: Optional[torch.Generator]) -> None:
    """One decode step of every slot, in place: each row at its own length
    (positions, K/V writes, visible prefix), per-row temperature and top-p
    when sampled. With ``track_ids`` the token is also appended to the row's
    history (an adaptive engine's plain chunk), clamped to the buffer."""
    lens = st.lengths
    embeds = gemma.embed_tokens(model.llm, st.token)
    hidden, _ = gemma.forward(model.llm, embeds, lens[:, None], cache, fns, row_lengths=lens, lora=st.lora)
    logits = gemma.logits(model.llm, hidden, fns)[:, -1, :]
    nxt = sample_rows(logits, generator, st.temps, st.topps) if do_sample else greedy(logits)
    if track_ids:
        col = st.buf_lens.long().clamp_max(st.ids_buf.shape[1] - 1)
        st.ids_buf.index_put_((_rows(nxt.shape[0], nxt), col), nxt)
        st.buf_lens.add_(1)
    st.token.copy_(nxt[:, None])
    st.out.index_copy_(1, st.step, st.token)
    st.step.add_(1)
    st.lengths.add_(1)


def _propose_rows(drafter: str, ids_buf: torch.Tensor, buf_lens: torch.Tensor,
                  token: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """(B, k-1) drafts, ``generation.propose_row`` over every row."""
    return torch.func.vmap(lambda r, bl, t: generation.propose_row(drafter, r, bl, t, k, n))(
        ids_buf, buf_lens, token)


def _clamped_columns(start: torch.Tensor, width: int, k: int) -> torch.Tensor:
    """(B, k) columns of a k-wide write at ``start`` with the start clamped
    to ``[0, width - k]``, as ``dynamic_update_slice`` clamps it."""
    return start.long().clamp(0, width - k)[:, None] + torch.arange(k, device=start.device)


def _slot_verify_step(model: PaliGemma, cache: KVCache, st: _SlotState, fns: KernelFns, k: int, n: int,
                      drafter: str, do_sample: bool, generator: Optional[torch.Generator],
                      noise_generator: Optional[torch.Generator]) -> None:
    """One speculative verify iteration of every slot, in place: k-1 drafts
    a row from its own history (replaced by uniform vocab ids with
    probability ``st.noise``, from the noise generator), one k-token forward
    at per-row positions, the model's choice at every position (one batched
    per-row sampled choice over the B x k rows, or greedy), and per row the
    longest prefix of drafts its choices repeat plus one token. The shared
    cache length is not advanced."""
    b = st.token.shape[0]
    drafts = _propose_rows(drafter, st.ids_buf, st.buf_lens, st.token[:, 0], k, n)
    if st.noise is not None:
        dev = drafts.device
        flip = torch.rand(drafts.shape, generator=noise_generator, device=dev) < st.noise
        junk = torch.randint(0, model.cfg.text_config.vocab_size, drafts.shape,
                             generator=noise_generator, device=dev, dtype=torch.int32)
        drafts = torch.where(flip, junk, drafts)
    inp = torch.cat([st.token, drafts.to(torch.int32)], dim=1)  # (B, k)
    lens = st.lengths
    positions = lens[:, None] + torch.arange(k, dtype=torch.int32, device=lens.device)
    embeds = gemma.embed_tokens(model.llm, inp)
    hidden, _ = gemma.forward(model.llm, embeds, positions, cache, fns, multi_token_decode=True,
                              row_lengths=lens, lora=st.lora)
    flat = gemma.logits(model.llm, hidden, fns).reshape(b * k, -1)
    if do_sample:
        a = sample_rows(flat, generator, st.temps.repeat_interleave(k), st.topps.repeat_interleave(k))
    else:
        a = greedy(flat)
    a = a.reshape(b, k)
    matched = torch.cumprod((inp[:, 1:] == a[:, :-1]).to(torch.int32), dim=1).sum(dim=1)
    accept = (matched + 1).to(torch.int32)
    rows = _rows(b, a)[:, None].expand(b, k)
    st.out.index_put_((rows, _clamped_columns(st.counts, st.out.shape[1], k)), a)
    st.ids_buf.index_put_((rows, _clamped_columns(st.buf_lens, st.ids_buf.shape[1], k)), a)
    st.token.copy_(a.gather(1, matched[:, None]))
    st.lengths.add_(accept)
    st.buf_lens.add_(accept)
    st.counts.add_(accept)


def _resize_kv(full: KVCache, target: int) -> KVCache:
    """The window of width ``target`` of the full-length slot cache: a view
    ``[:, :, :target]`` of every buffer (no copy). Rows past every occupied
    length are unwritten or a free slot's."""
    cut = {f: getattr(full, f)[:, :, :target] for f in ("k", "v", "k_scale", "v_scale")
           if hasattr(full, f)}
    return dataclasses.replace(full, **cut, graphs={})


def _stack_group_adapters(group: Sequence[dict]) -> dict:
    """Per-request adapters ``{target: {"a": (L, D, r), "b": (L, r, out)}}``
    -> the group's, with a row axis: ``(L, G, D, r)`` / ``(L, G, r, out)``."""
    return {n: {x: torch.stack([ad[n][x] for ad in group], dim=1) for x in ("a", "b")}
            for n in group[0]}


def _insert_group(full: KVCache, temp_kv: Sequence[torch.Tensor], slots: torch.Tensor, st: _SlotState,
                  valid: torch.Tensor, logits: torch.Tensor, generator: Optional[torch.Generator],
                  req_temps: torch.Tensor, req_topps: torch.Tensor, sampled: bool,
                  prompt_ids: Optional[torch.Tensor], grouped: Optional[dict] = None) -> torch.Tensor:
    """A join group's first tokens (per-row sampled, or greedy when no
    joiner samples) and its prefilled K/V rows (with the int8 cache's
    scales) scattered into ``[:, slots, :t_b]``; lengths, tokens,
    temperatures and top-p set, with a token history each joiner's prompt
    and first token, and with per-slot adapters the group's stacked
    adapters (``grouped``) written into the slots' rows in place. ``slots``
    (G,) int64: pad rows name the trash row. Returns the (G,) int32 first
    tokens, left on the device."""
    first = sample_rows(logits, generator, req_temps, req_topps) if sampled else greedy(logits)
    t_b = temp_kv[0].shape[2]
    names = ("k", "v", "k_scale", "v_scale")[: len(temp_kv)]
    for name, src in zip(names, temp_kv):
        dst = getattr(full, name)
        dst[:, slots, :t_b] = src.to(dst.dtype)
    st.lengths[slots] = valid
    st.token[slots, 0] = first
    st.temps[slots] = req_temps
    st.topps[slots] = req_topps
    if st.ids_buf is not None:
        st.ids_buf[slots, : prompt_ids.shape[1]] = prompt_ids
        st.ids_buf[slots, valid.long()] = first
        st.buf_lens[slots] = valid + 1
    if st.lora is not None:
        for name, ad in st.lora.items():
            for x in ("a", "b"):
                ad[x][:, slots] = grouped[name][x]
    return first


class _SlotRunner(generation._Captured):
    """One step function on the engine's buffers and one window: eager on
    the CPU; on CUDA captured once (the warm-up step undone on the engine's
    buffers; its K/V writes land at positions no row sees yet and are
    rewritten by the real step), a chunk being n replays. ``step(gens)``
    draws from ``gens`` = (sampling generator, noise generator); ``uses``
    says which of the two the flavour draws from. The graph draws from
    generators of its own for those, set from the engine's before the
    replays and copied back after."""

    def __init__(self, engine: "ContinuousBatcher", cache: KVCache, step, uses: tuple):
        super().__init__(engine.model, cache, engine.fns)
        self.step = step
        self.generators = (None, None)
        self.mib = 0.0
        if engine.graphs:
            dev = engine.device
            self.generators = tuple(torch.Generator(device=dev) if u else None for u in uses)
            targets = engine.state.tensors() + [cache.valid]
            saved = [x.clone() for x in targets]

            def restore():
                for dst, src in zip(targets, saved):
                    dst.copy_(src)

            self.mib = engine._capture_locked(
                lambda: self._capture(dev, lambda: step(self.generators), restore,
                                      [g for g in self.generators if g is not None], pool=engine.pool))

    def run(self, n: int, generators: tuple) -> None:
        if self.graph is None:
            for _ in range(n):
                self.step(generators)
            return
        pairs = [(m, g) for m, g in zip(self.generators, generators) if m is not None]
        for mine, theirs in pairs:
            mine.set_state(theirs.get_state())
        for _ in range(n):
            self._replay()
        for mine, theirs in pairs:
            theirs.set_state(mine.get_state())


class _JoinPrefill(generation._Captured):
    """``serving.batched_prefill`` for one (group batch, prompt bucket) into
    a temporary cache of its own: eager on the CPU; on CUDA the first call
    is the eager prefill (the capture's warm-up, the call's answer), then
    every call copies its inputs into the graph's static buffers and
    replays. Its logits and cache rows are overwritten by the next call."""

    def __init__(self, engine: "ContinuousBatcher", g_b: int, bucket: int):
        dev = engine.device
        self.cache = gemma.init_cache(engine.cfg.text_config, g_b, bucket, engine.kv_dtype, dev)
        super().__init__(engine.model, self.cache, engine.fns)
        size = engine.cfg.vision_config.image_size
        self.ids = torch.zeros((g_b, bucket), dtype=torch.int32, device=dev)
        self.pix = torch.zeros((g_b, 3, size, size), dtype=engine.pix_dtype, device=dev)
        self.valid = torch.zeros(g_b, dtype=torch.int32, device=dev)
        # The group's per-row adapters (a static input of the graph).
        self.lora = None if engine.state.lora is None else {
            n: {x: t.new_zeros((t.shape[0], g_b, *t.shape[2:])) for x, t in ad.items()}
            for n, ad in engine.state.lora.items()}
        self.logits, self.mib = None, 0.0

    def _run(self, model: PaliGemma) -> torch.Tensor:
        self.cache.length.zero_()
        self.cache.host_length = 0
        logits, _ = serving.batched_prefill(model, self.ids, self.pix, self.valid, self.cache, self.fns,
                                            lora=self.lora)
        return logits

    def run(self, engine: "ContinuousBatcher", ids: torch.Tensor, pix: torch.Tensor,
            valid: torch.Tensor, grouped: Optional[dict] = None) -> torch.Tensor:
        self.ids.copy_(ids)
        self.pix.copy_(pix)
        self.valid.copy_(valid)
        if self.lora is not None:
            for name, ad in self.lora.items():
                for x, buf in ad.items():
                    buf.copy_(grouped[name][x])
        if not engine.graphs:
            return self._run(engine.model)
        if self.graph is None:
            out = {}

            def capture():
                out["logits"], self.logits = self._capture(
                    engine.device, lambda: self._run(engine.model), count_warm_up=True, pool=engine.pool)

            self.mib = engine._capture_locked(capture)
            return out["logits"]
        self._replay()
        return self.logits

    def kv(self) -> tuple:
        c = self.cache
        return tuple(getattr(c, f) for f in ("k", "v", "k_scale", "v_scale") if hasattr(c, f))


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def join_batches(n_slots: int) -> tuple:
    """The group batches a join prefill runs at: 1, the powers of two below
    ``n_slots``, and ``n_slots``. A group of g joins at the smallest that
    holds g."""
    return tuple(sorted({2**i for i in range(n_slots.bit_length()) if 2**i < n_slots} | {1, n_slots}))


def window_buckets(prompt_budget: int, chunk: int, slack: int, s_len: int) -> tuple:
    """The cache window's widths (the reference's ladder, multiples of 128
    up to ``s_len``): the floor of a plain chunk, of the worst speculative
    chunk (``slack``), one between that and the full length, the full
    length."""
    def bucket(n):
        return min(-(-n // 128) * 128, s_len)
    b0 = bucket(prompt_budget + chunk + 1)
    b1 = bucket(prompt_budget + slack + 1)
    mid = bucket(-(-(b1 + s_len) // 2))
    return tuple(sorted({b0, b1, mid, s_len}))


class Request:
    """One submitted generation request and its accumulating result."""

    _ids = itertools.count()  # count().__next__ is atomic in CPython

    def __init__(self, prompt: str, image, max_new_tokens: int, temperature: float = 0.0,
                 top_p: float = 0.9, adapter: Optional[str] = None):
        self.id = next(Request._ids)
        self.adapter = adapter  # a registered LoRA adapter's name, or None
        self.prompt = prompt
        self.image = image
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature  # <= 0: greedy
        self.top_p = top_p
        self.tokens: List[int] = []
        self.done = False
        self.error: Optional[Exception] = None
        # The prefetch pipeline's state: (ids (t,), valid, uint8 pixels) once
        # preprocessed; ``_claimed`` marks preprocessing in flight (under the
        # engine's ``_prep_cv``).
        self.prep = None
        self._claimed = False
        # Streaming hook: called from the engine-driving thread with
        # (new_tokens, done) once per chunk that touched this request.
        self.on_tokens = None
        self.notified = 0
        # Set (from any thread) to stop decoding this request at the next
        # chunk boundary.
        self.cancelled = False
        # Its way to the first token on ``time.perf_counter_ns``'s clock, each
        # None until it happens: submitted, taken into a join group, its join
        # enqueued, its first token held by the engine's thread.
        self.t_submit: Optional[int] = None
        self.t_taken: Optional[int] = None
        self.t_joined: Optional[int] = None
        self.t_first: Optional[int] = None


class ContinuousBatcher:
    """Slot-level continuous batching engine (the reference's
    ``ContinuousBatcher``).

    Args:
      model: a ``PaliGemma`` on its device (the engine runs where it is),
        or a rank's tensor-parallel model (every rank runs the engine).
      processor: a ``PaliGemmaProcessor``.
      n_slots: decode batch width (one trash row rides along). A join group
        of g runs its prefill at the smallest of ``join_batches(n_slots)``
        holding g, its pad rows landing in the trash row.
      prompt_budget: an int, or prompt buckets: a join group prefills at the
        smallest bucket covering its prompts (image tokens + BOS + text).
      max_new_tokens: each slot's budget (the cache is sized for it).
      chunk: decode steps a plain chunk; joins and evictions happen between
        chunks.
      cache_dtype: the KV cache dtype (None: the decoder's activation
        dtype); ``kv_quant`` makes it the int8 cache.
      kv_window: keep the live cache at the smallest of a few position
        buckets covering every occupied slot plus one chunk's writes.
      prefill_cache_size: LRU size of the content-keyed prefix cache
        (single-joiner groups; an entry owns copies of its K/V and logits).
      prefetch: preprocess queued requests on a worker thread and stage the
        next full groups' uint8 pixels on the device, two waves deep.
      spec_k / spec_ks: per-slot speculative decoding (one rung, or a
        ladder the adaptive policy climbs); ``spec_chunk`` verify
        iterations a speculative chunk; ``spec_adaptive``,
        ``spec_max_slots``, ``spec_min_accept``, ``spec_probe_every``: the
        reference's policy; ``draft_noise``: the probability that a draft
        is replaced by a uniform vocab id (its own generator; it lowers
        acceptance only); ``spec_drafter``: "ngram" or "longest".
      lora_rank: serve LoRA adapters of rank up to this, a different one
        in every slot (``register_adapter``, ``submit(..., adapter=name)``);
        requests without one ride the all-zeros adapter.
      seed: one ``torch.Generator`` on the engine's device for sampling
        (the draft noise draws from a second one).
      fns: the kernel functions (``ops.kernels.KERNELS``).
    """

    def __init__(
        self,
        model: PaliGemma,
        processor,
        n_slots: int = 4,
        prompt_budget: Optional[object] = None,
        max_new_tokens: int = 64,
        chunk: int = 8,
        cache_dtype: Optional[torch.dtype] = None,
        kv_quant: bool = False,
        kv_window: bool = False,
        do_sample: bool = False,
        temperature: float = 0.0,
        top_p: float = 0.9,
        eos_token_id: Optional[int] = None,
        seed: int = 0,
        lora_rank: Optional[int] = None,
        prefill_cache_size: int = 0,
        prefetch: bool = True,
        spec_k: int = 0,
        spec_ngram: int = 3,
        spec_chunk: Optional[int] = None,
        spec_adaptive: bool = False,
        spec_max_slots: Optional[int] = None,
        spec_min_accept: Optional[float] = None,
        spec_probe_every: int = 8,
        spec_ks: Optional[Sequence[int]] = None,
        draft_noise: float = 0.0,
        spec_drafter: str = "ngram",
        fns: KernelFns = KERNELS,
    ):
        self.model, self.processor, self.fns = model, processor, fns
        self.cfg = cfg = model.cfg
        self.device = dev = model.llm.final_norm.weight.device
        self.n_slots = n_slots
        n_img = cfg.vision_config.num_image_tokens
        if prompt_budget is None:
            prompt_budget = n_img + 32
        buckets = ((int(prompt_budget),) if isinstance(prompt_budget, int)
                   else tuple(sorted(int(b) for b in prompt_budget)))
        if not buckets:
            raise ValueError("prompt_budget must be an int or a non-empty sequence of ints")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.prompt_budgets = buckets
        self.prompt_budget = buckets[-1]
        self.max_new_tokens = max_new_tokens
        self.chunk = chunk
        self.do_sample, self.temperature, self.top_p = do_sample, temperature, top_p
        self.eos_token_id = eos_token_id if eos_token_id is not None else processor.tokenizer.eos_token_id
        self.generator = torch.Generator(device=dev).manual_seed(seed)

        if spec_ks:
            self.spec_ks = tuple(sorted({int(x) for x in spec_ks}))
            if spec_k and int(spec_k) not in self.spec_ks:
                raise ValueError(f"spec_k={spec_k} must be one of spec_ks={spec_ks}")
        else:
            self.spec_ks = (int(spec_k),) if spec_k else ()
        if any(x < 2 for x in self.spec_ks):
            raise ValueError(f"speculative k values must be >= 2, got {self.spec_ks}")
        self.spec_k = self.spec_ks[-1] if self.spec_ks else 0
        if generation._uses_prefill_a8(model) and self.spec_k and self.spec_k + 1 >= quantization.A8_MIN_SEQ:
            raise ValueError(
                f"spec_k={self.spec_k} verify depth {self.spec_k + 1} >= quantization.A8_MIN_SEQ="
                f"{quantization.A8_MIN_SEQ} would route the verify through the int8 x int8 product "
                "while plain chunks stay weight-only; lower spec_k or disable prefill_a8")
        if dev.type == "cuda" and self.spec_k > MAX_DECODE_QUERIES:
            raise ValueError(f"spec_k={self.spec_k}: the CUDA decode kernel verifies at most "
                             f"{MAX_DECODE_QUERIES} queries a row")
        self.spec_ngram = int(spec_ngram)
        if spec_drafter not in ("ngram", "longest"):
            raise ValueError(f"unknown spec_drafter {spec_drafter!r}")
        self.spec_drafter = spec_drafter
        self.spec_chunk = int(spec_chunk) if spec_chunk else chunk
        if self.spec_k and self.spec_chunk < 1:
            raise ValueError(f"spec_chunk must be >= 1, got {spec_chunk}")
        self.spec_adaptive = bool(spec_adaptive) and self.spec_k > 0
        if len(self.spec_ks) > 1 and not self.spec_adaptive:
            raise ValueError("a multi-rung spec_ks ladder requires spec_adaptive (the policy picks the rung)")
        self.spec_max_slots = int(spec_max_slots) if spec_max_slots is not None else None
        self.spec_min_accept = None if spec_min_accept is None else float(spec_min_accept)
        self.spec_probe_every = int(spec_probe_every)
        self._probe_interval = self.spec_probe_every
        self._probing = False
        self._spec_rung = 0
        self.draft_noise = float(draft_noise) if draft_noise > 0.0 else None
        self.noise_generator = torch.Generator(device=dev).manual_seed(seed + 0x6E6F)
        self.spec_accept_ema: Optional[float] = None
        self._chunks_since_spec = 0
        self.spec_mode_log: List[bool] = []
        self.spec_k_log: List[int] = []
        # Serving observability (the server's /metrics reads these).
        self.tokens_delivered = 0
        self.chunks_run = 0
        self.host_t: Dict[str, float] = defaultdict(float)
        self.join_groups = 0
        # The recent join groups, (group batch, the members' request ids).
        self.join_log: deque = deque(maxlen=1024)
        # Rows run by join prefills (prefix cache hits run none), and the
        # pad rows among them.
        self.join_rows = 0
        self.join_pad_rows = 0
        # A speculative chunk writes up to spec_chunk x k positions past a
        # row's length plus k; size the cache for either flavour's worst case.
        slack = max(chunk, self.spec_chunk * self.spec_k) + self.spec_k if self.spec_k else chunk
        s_len = self.prompt_budget + max_new_tokens + slack
        b = n_slots + 1  # the trash row takes a group's pad rows
        self.trash_row = n_slots
        self.join_batches = join_batches(n_slots)
        self.s_len = s_len
        self.max_advance = slack
        self.window_buckets = window_buckets(self.prompt_budget, chunk, slack, s_len) if kv_window else None
        self.host_lengths = np.zeros((n_slots,), np.int64)
        self.window_resizes = 0
        self.kv_quant = bool(kv_quant)
        act = gemma.activation_dtype(model.llm)
        self.cache_dtype = act if cache_dtype is None else cache_dtype
        self.kv_dtype = torch.int8 if kv_quant else self.cache_dtype
        self.pix_dtype = model.vision.patch_embedding.weight.dtype
        self.window = self.window_buckets[0] if self.window_buckets else s_len
        self.full_cache = gemma.init_cache(cfg.text_config, b, s_len, self.kv_dtype, dev)
        self._views: Dict[int, KVCache] = {}
        self.cache = self._view(self.window)

        def zeros(shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.state = _SlotState(
            token=zeros((b, 1)), lengths=zeros(b),
            temps=zeros(b, torch.float32), topps=torch.full((b,), 0.9, dtype=torch.float32, device=dev),
            out=zeros((b, max(chunk, self.spec_chunk * self.spec_k))), step=zeros(1, torch.int64),
            counts=zeros(b),
            ids_buf=zeros((b, s_len)) if self.spec_k else None,
            buf_lens=zeros(b) if self.spec_k else None,
            noise=(torch.tensor(self.draft_noise, dtype=torch.float32, device=dev)
                   if self.draft_noise is not None else None),
        )
        self.lora_rank = int(lora_rank) if lora_rank else None
        self._adapters: Dict[str, dict] = {}
        self._zero_adapter = None
        if self.lora_rank:
            tc = cfg.text_config
            l, d, r = tc.num_hidden_layers, tc.hidden_size, self.lora_rank
            outs = lora.out_dims(cfg).items()
            self.state.lora = {n: {"a": zeros((l, b, d, r), torch.float32),
                                   "b": zeros((l, b, r, out), torch.float32)} for n, out in outs}
            self._zero_adapter = {n: {"a": zeros((l, d, r), torch.float32), "b": zeros((l, r, out), torch.float32)}
                                  for n, out in outs}
        self.spec_verifies = 0
        self.spec_emitted = 0
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.pending: deque = deque()
        self.completed: List[Request] = []
        self._pending_first: List = []

        # The captured graphs (step graphs by key, join prefills by shape),
        # one memory pool for all of them (they run one after another on
        # one stream and keep their results in static buffers), and a log
        # of each capture: key, ms, MiB the pool grew by.
        # No graph of a model sharded over gloo (generation.graphs_on): its
        # steps run eagerly.
        self.graphs = generation.graphs_on(model, dev)
        self.pool = torch.cuda.graph_pool_handle() if self.graphs else None
        self._steps: Dict[tuple, _SlotRunner] = {}
        self._prefills: Dict[tuple, _JoinPrefill] = {}
        self.graph_log: List[dict] = []
        self._device_lock = threading.Lock()

        self.prefill_cache_size = prefill_cache_size
        self._prefill_cache: "OrderedDict[str, tuple]" = OrderedDict()
        self.prefill_cache_hits = 0

        self.prefetch = bool(prefetch)
        self._pixel_lut = torch.from_numpy(processing.pixel_lut()).to(dev, self.pix_dtype)
        # The affine replaces the gather only if it gives the gather's values
        # over the whole 0..255 ramp in the pixel dtype on this device.
        center, mul = processing.pixel_affine_coeffs()
        self._pixel_aff = (torch.from_numpy(center).to(dev), torch.from_numpy(mul).to(dev))
        ramp = torch.arange(256, dtype=torch.uint8, device=dev)[None, None, None, :].expand(1, 3, 1, 256)
        via_aff = processing.apply_pixel_affine(*self._pixel_aff, ramp, self.pix_dtype)
        self.pixel_affine = bool(torch.equal(processing.apply_pixel_lut(self._pixel_lut, ramp), via_aff))
        if not self.pixel_affine:
            self._pixel_aff = None
        self._proc_lock = threading.Lock()
        self._prep_cv = threading.Condition()
        self._prep_stop = False
        self._prefetch_thread: Optional[threading.Thread] = None
        self._prep_lookahead = 2 * n_slots
        # Staged group uploads: (request ids, device uint8 stack, the upload's
        # (event, pinned host copy) or None), at most stage_depth waves.
        self._staged: deque = deque()
        self.stage_depth = 2
        self.staged_hits = 0
        self.staged_misses = 0
        self._upload_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    # -- device buffers and graphs ------------------------------------------

    def _view(self, width: int) -> KVCache:
        if width not in self._views:
            self._views[width] = _resize_kv(self.full_cache, width)
        return self._views[width]

    def _capture_locked(self, capture) -> float:
        """Run ``capture()`` under the device lock (no staged upload runs
        meanwhile); log and return the MiB the graph pool grew by."""
        with self._device_lock:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()  # as the capture itself does on entry
            before = torch.cuda.memory_reserved(self.device)
            capture()
            torch.cuda.synchronize(self.device)
            mib = (torch.cuda.memory_reserved(self.device) - before) / 2**20
        return mib

    def _log_capture(self, key, runner) -> None:
        if runner.graph is not None:
            self.graph_log.append({"key": key, "ms": runner.capture_ms, "mib": runner.mib})

    def _step_runner(self, k_chunk: int, sampled: bool) -> _SlotRunner:
        """The step of this chunk flavour on the current window (captured at
        its first use on CUDA). Keyed on the window's width (every window is
        a view at the same address), the flavour (plain, plain with the
        token history, or speculative with k, n and the drafter), greedy or
        sampled."""
        if k_chunk:
            flavour = ("spec", k_chunk, self.spec_ngram, self.spec_drafter, self.draft_noise is not None)
        else:
            flavour = ("plain", bool(self.spec_k))
        key = (self.window, flavour, sampled)
        runner = self._steps.get(key)
        if runner is None:
            cache, st, model, fns = self.cache, self.state, self.model, self.fns
            if k_chunk:
                n, drafter = self.spec_ngram, self.spec_drafter

                def step(gens):
                    _slot_verify_step(model, cache, st, fns, k_chunk, n, drafter, sampled,
                                      gens[0], gens[1])
            else:
                track = bool(self.spec_k)

                def step(gens):
                    _slot_decode_step(model, cache, st, fns, sampled, track, gens[0])

            uses = (sampled, bool(k_chunk) and self.draft_noise is not None)
            runner = self._steps[key] = _SlotRunner(self, cache, step, uses)
            self._log_capture(key, runner)
        return runner

    def _prefill(self, ids: np.ndarray, pix: torch.Tensor, valid: np.ndarray, grouped: Optional[dict] = None):
        """The join group's batched prefill through its shape's runner, with
        the group's stacked adapters when the engine has ``lora_rank``:
        (logits (G, V), the temporary cache's K/V buffers)."""
        g_b, bucket = ids.shape
        runner = self._prefills.get((g_b, bucket))
        if runner is None:
            runner = self._prefills[(g_b, bucket)] = _JoinPrefill(self, g_b, bucket)
        had = runner.graph is not None
        logits = runner.run(self, self._h2d(ids), pix, self._h2d(valid), grouped)
        if not had:
            self._log_capture(("prefill", g_b, bucket), runner)
        return logits, runner.kv()

    @torch.no_grad()
    def prepare(self) -> float:
        """Capture every graph this engine can run before traffic needs it,
        on its empty state: the join prefill of each prompt bucket at every
        group batch of ``join_batches`` (each uploaded to the device, so
        that no join's first replay waits to upload it), and the step of
        every window and chunk flavour (plain; each speculative rung),
        greedy and sampled. Nothing on the CPU, nor for a model sharded
        over gloo. Returns the captures' host ms."""
        if not self.graphs:
            return 0.0
        t0 = time.perf_counter()
        size = self.cfg.vision_config.image_size
        for bucket in self.prompt_budgets:
            for g_b in self.join_batches:
                self._prefill(np.zeros((g_b, bucket), np.int32),
                              torch.zeros((g_b, 3, size, size), dtype=self.pix_dtype, device=self.device),
                              np.full((g_b,), bucket, np.int32), self._group_adapters([None] * g_b))
                self._prefills[(g_b, bucket)].upload(self.device)
        if not self.spec_k:
            flavours = (0,)
        elif self.spec_adaptive:
            flavours = (0,) + self.spec_ks
        else:
            flavours = (self.spec_k,)
        window = self.window
        for width in self.window_buckets or (self.s_len,):
            self.window, self.cache = width, self._view(width)
            for k in flavours:
                for sampled in (False, True):
                    self._step_runner(k, sampled)
        self.window, self.cache = window, self._view(window)
        torch.cuda.synchronize(self.device)
        return (time.perf_counter() - t0) * 1e3

    def _h2d(self, x: np.ndarray) -> torch.Tensor:
        """A small host array on the engine's device; on CUDA through pinned
        memory without blocking the host (a copy from pageable memory would
        wait for the chunk the join overlaps)."""
        t = torch.from_numpy(x)
        return t.pin_memory().to(self.device, non_blocking=True) if self.device.type == "cuda" else t

    # -- request lifecycle ---------------------------------------------------

    def register_adapter(self, name: str, adapter: dict, scale: float = 1.0) -> None:
        """Register a LoRA adapter for multi-tenant serving under ``name``.

        ``adapter``: ``{"layers": {"q"|"k"|"v": {"a": (L, D, r), "b": (L, r,
        out)}}}`` or the layers dict (tensors or arrays, e.g. from
        ``lora.load_adapter``); ``scale``: alpha / r. The scale is folded
        into b (one graph serves adapters of every alpha), and a rank below
        the engine's ``lora_rank`` is zero-padded to it (exact); a higher
        rank raises. Re-registering a name drops the prefix cache."""
        if not self.lora_rank:
            raise ValueError("engine built without lora_rank")
        layers = adapter.get("layers", adapter)
        out = {}
        for tgt in gemma.LORA_TARGETS:
            a = torch.as_tensor(layers[tgt]["a"]).to(self.device, torch.float32)
            b = torch.as_tensor(layers[tgt]["b"]).to(self.device, torch.float32) * float(scale)
            r = a.shape[-1]
            if r > self.lora_rank:
                raise ValueError(f"adapter rank {r} exceeds engine lora_rank {self.lora_rank}")
            pad = self.lora_rank - r
            out[tgt] = {"a": torch.nn.functional.pad(a, (0, pad)),
                        "b": torch.nn.functional.pad(b, (0, 0, 0, pad))}
        self._adapters[name] = out
        self._prefill_cache.clear()

    @property
    def adapters(self) -> List[str]:
        """The registered adapters' names, sorted."""
        return sorted(self._adapters)

    def _group_adapters(self, names: Sequence[Optional[str]]) -> Optional[dict]:
        """The stacked adapters of a join group's rows (None: the zero
        adapter), or None on an engine without ``lora_rank``."""
        if not self.lora_rank:
            return None
        return _stack_group_adapters([self._zero_adapter if n is None else self._adapters[n] for n in names])

    def submit(self, prompt: str, image, max_new_tokens: Optional[int] = None,
               temperature: Optional[float] = None, top_p: Optional[float] = None,
               do_sample: Optional[bool] = None, adapter: Optional[str] = None) -> Request:
        """Queue a request; sampling values default to the engine's, and
        ``do_sample=False`` (or temperature <= 0) is greedy. ``adapter``
        names a registered LoRA adapter (an unknown name raises)."""
        if adapter is not None and adapter not in self._adapters:
            raise ValueError(f"unknown adapter {adapter!r}; register_adapter it first")
        if do_sample is None:
            do_sample = self.do_sample
        if temperature is None:
            temperature = self.temperature
        if top_p is None:
            top_p = self.top_p
        eff_t = float(temperature) if (do_sample and temperature > 0) else 0.0
        if max_new_tokens is None:
            max_new_tokens = self.max_new_tokens
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        req = Request(prompt, image, max_new_tokens, temperature=eff_t, top_p=float(top_p), adapter=adapter)
        if req.max_new_tokens > self.max_new_tokens:
            raise ValueError(f"max_new_tokens {req.max_new_tokens} exceeds the engine budget "
                             f"{self.max_new_tokens} (cache is sized statically)")
        self._ensure_prefetch()
        req.t_submit = time.perf_counter_ns()
        with self._prep_cv:
            self.pending.append(req)
            self._prep_cv.notify_all()
        return req

    def _finish(self, slot: int) -> None:
        req = self.slot_req[slot]
        req.done = True
        self.completed.append(req)
        self.slot_req[slot] = None
        # No device work: the freed slot keeps stepping (its writes clamp to
        # its own rows, its output is discarded), and the next join resets
        # its length and rows.

    def _prefill_key(self, req: Request) -> str:
        """The prefix cache's content key: prompt + image pixels + adapter
        (an adapter changes the prompt's K/V)."""
        h = hashlib.sha1()
        h.update(req.prompt.encode())
        h.update(b"||")
        im = req.image
        h.update(f"{getattr(im, 'mode', '')}{getattr(im, 'size', '')}".encode())
        h.update(im.tobytes() if hasattr(im, "tobytes") else np.asarray(im).tobytes())
        h.update(f"|{req.adapter or ''}|".encode())
        return h.hexdigest()

    def _preprocess_one(self, req: Request):
        """Tokenize and resize one request on the host: (ids (t,), t, uint8
        CHW pixels); the rescale and normalize run on the device at the join."""
        with self._proc_lock:
            out = self.processor(text=[req.prompt], images=[req.image], raw_uint8=True)
        ids = np.asarray(out["input_ids"][0], np.int32)
        return ids, len(ids), np.asarray(out["pixel_values"][0], np.uint8)

    def _prefetch_loop(self) -> None:
        while True:
            req = None
            with self._prep_cv:
                if self._prep_stop:
                    return
                ahead = 0
                for r in self.pending:
                    if r.prep is not None or r._claimed:
                        ahead += 1
                        continue
                    if r.cancelled:
                        continue
                    if ahead < self._prep_lookahead:
                        req = r
                        req._claimed = True
                    break
            if req is None:
                self._try_stage()
                with self._prep_cv:
                    if self._prep_stop:
                        return
                    self._prep_cv.wait(timeout=0.05)
                continue
            try:
                prep = self._preprocess_one(req)
            except Exception:
                # A bad image or prompt fails at its join on the engine
                # thread, which owns per-request errors.
                prep = None
            with self._prep_cv:
                req.prep = prep
                req._claimed = False
                self._prep_cv.notify_all()
            self._try_stage()

    def _upload(self, pix: List[np.ndarray], staged: bool):
        """Stacked uint8 pixels on the device. On CUDA through pinned memory:
        on the current stream, or (``staged``, from the prefetch worker) on
        the upload stream under the device lock (never during a capture),
        returned with the (event, pinned host copy) the join waits on."""
        host = torch.from_numpy(np.stack(pix, axis=0))
        if self.device.type != "cuda":
            return host, None
        if not staged:
            return host.pin_memory().to(self.device, non_blocking=True), None
        with self._device_lock, torch.cuda.device(self.device), torch.cuda.stream(self._upload_stream):
            host = host.pin_memory()
            dev = host.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._upload_stream)
        return dev, (event, host)

    def _try_stage(self) -> None:
        """Worker side: upload the next full join waves' stacked pixels ahead
        of their joins, up to ``stage_depth`` waves (the reference's staging
        rules: a wave is n_slots uncancelled pending requests all
        preprocessed; staged entries must match the waves in order)."""
        if self.n_slots < 2:
            return
        uploads = []
        with self._prep_cv:
            if self._prep_stop:
                return
            groups, cur = [], []
            for r in self.pending:
                if r.cancelled:
                    continue
                if r.prep is None:
                    break
                cur.append(r)
                if len(cur) == self.n_slots:
                    groups.append(cur)
                    cur = []
                    if len(groups) >= self.stage_depth:
                        break
            keep = len(self._staged)
            for i, (sids, _, _) in enumerate(self._staged):
                if i >= len(groups) or sids != tuple(r.id for r in groups[i]):
                    keep = i
                    break
            while len(self._staged) > keep:
                self._staged.pop()
            for g in groups[len(self._staged):]:
                uploads.append((tuple(r.id for r in g), [r.prep[2] for r in g]))
        for ids, pix in uploads:
            t0 = time.perf_counter()
            dev, sync = self._upload(pix, staged=True)
            self.host_t["h2d_staged"] += time.perf_counter() - t0
            with self._prep_cv:
                pos = len(self._staged)
                want = []
                for r in self.pending:
                    if r.cancelled:
                        continue
                    want.append(r.id)
                    if len(want) == (pos + 1) * self.n_slots:
                        break
                if (len(want) == (pos + 1) * self.n_slots and tuple(want[pos * self.n_slots:]) == ids
                        and pos < self.stage_depth):
                    self._staged.append((ids, dev, sync))

    def _ensure_prefetch(self) -> None:
        if not self.prefetch or self._prefetch_thread is not None:
            return
        self._prefetch_thread = threading.Thread(target=self._prefetch_loop, daemon=True,
                                                 name="paligemma-prefetch")
        self._prefetch_thread.start()

    def close(self) -> None:
        """Stop the prefetch worker (idempotent)."""
        with self._prep_cv:
            self._prep_stop = True
            self._prep_cv.notify_all()

    def _take_prep(self, req: Request):
        """The worker's result when ready, a short wait while it is in
        flight, else preprocessing inline."""
        with self._prep_cv:
            while req._claimed:
                self._prep_cv.wait(timeout=0.05)
            if req.prep is not None:
                return req.prep
            req._claimed = True
        try:
            prep = self._preprocess_one(req)
        finally:
            with self._prep_cv:
                req._claimed = False
                self._prep_cv.notify_all()
        return prep

    def _join_group(self, joiners: List) -> None:
        """One bucketed prefill and one scatter insert for a join group,
        padded to the smallest group batch of ``join_batches`` that holds it
        (pad rows repeat sample 0, ride the zero adapter and land in the
        trash row). The first tokens stay on the device until the next
        chunk's read (``_pending_first``)."""
        t_join0 = time.perf_counter()
        g = len(joiners)
        g_b = next(b for b in self.join_batches if b >= g)
        reqs = [r for _, r in joiners]
        dev = self.device
        # Pad rows ride the zero adapter.
        grouped = self._group_adapters([r.adapter for r in reqs] + [None] * (g_b - g))
        key_c = self._prefill_key(reqs[0]) if (g_b == 1 and self.prefill_cache_size) else None
        hit = self._prefill_cache.get(key_c) if key_c else None
        if hit is not None:
            valid, logits, temp_kv, ids = hit
            self._prefill_cache.move_to_end(key_c)
            self.prefill_cache_hits += 1
        else:
            t_pp0 = time.perf_counter()
            preps = [self._take_prep(r) for r in reqs]
            self.host_t["preprocess"] += time.perf_counter() - t_pp0
            preps = preps + [preps[0]] * (g_b - g)
            t = max(int(p[0].shape[0]) for p in preps)
            bucket = next((b for b in self.prompt_budgets if b >= t), None)
            if bucket is None:
                raise ValueError(f"prompt of {t} tokens exceeds the largest prompt budget {self.prompt_budget}")
            ids = np.zeros((g_b, bucket), np.int32)
            valid = np.zeros((g_b,), np.int32)
            for i, (row, v, _) in enumerate(preps):
                ids[i, : row.shape[0]] = row
                valid[i] = v
            t_h2d0 = time.perf_counter()
            pix_u8 = None
            if g_b > 1:
                with self._prep_cv:
                    if self._staged:
                        sids, sdev, sync = self._staged[0]
                        if sids[:g] == tuple(r.id for r in reqs):
                            # A wave holds n_slots images; the group's
                            # batch takes its first g_b.
                            pix_u8 = sdev[:g_b]
                            self.staged_hits += 1
                            self._staged.popleft()
                            if g != self.n_slots:
                                self._staged.clear()
                            if sync is not None:
                                torch.cuda.current_stream(dev).wait_event(sync[0])
                                pix_u8.record_stream(torch.cuda.current_stream(dev))
                        else:
                            self.staged_misses += 1
                            self._staged.clear()
            if pix_u8 is None:
                pix_u8 = self._upload([p[2] for p in preps], staged=False)[0]
            if self._pixel_aff is not None:
                pix = processing.apply_pixel_affine(*self._pixel_aff, pix_u8, self.pix_dtype)
            else:
                pix = processing.apply_pixel_lut(self._pixel_lut, pix_u8)
            self.host_t["h2d"] += time.perf_counter() - t_h2d0
            t_pf0 = time.perf_counter()
            logits, temp_kv = self._prefill(ids, pix, valid, grouped)
            self.host_t["prefill_dispatch"] += time.perf_counter() - t_pf0
            self.join_rows += g_b
            self.join_pad_rows += g_b - g
            if key_c is not None:
                # The entry owns copies: the next join overwrites the runner's.
                self._prefill_cache[key_c] = (valid, logits.clone(), tuple(x.clone() for x in temp_kv), ids)
                while len(self._prefill_cache) > self.prefill_cache_size:
                    self._prefill_cache.popitem(last=False)
        req_temps = np.zeros((g_b,), np.float32)
        req_topps = np.full((g_b,), 0.9, np.float32)
        for i, (_, req) in enumerate(joiners):
            req_temps[i] = req.temperature
            req_topps[i] = req.top_p
        t_ins0 = time.perf_counter()
        slots = np.full((g_b,), self.trash_row, np.int64)
        for i, (slot, req) in enumerate(joiners):
            slots[i] = slot
            self.slot_req[slot] = req
        first = _insert_group(
            self.full_cache, temp_kv, self._h2d(slots), self.state, self._h2d(valid), logits, self.generator,
            self._h2d(req_temps), self._h2d(req_topps), bool(np.any(req_temps[:g] > 0)),
            self._h2d(ids) if self.spec_k else None, grouped,
        )
        for i, (slot, _) in enumerate(joiners):
            self.host_lengths[slot] = int(valid[i])
        self._pending_first.append((joiners, first))
        self.host_t["insert_dispatch"] += time.perf_counter() - t_ins0
        self.host_t["join_total"] += time.perf_counter() - t_join0
        t_joined = time.perf_counter_ns()
        for r in reqs:
            r.t_joined = t_joined
        self.join_groups += 1
        self.join_log.append((g_b, tuple(r.id for r in reqs)))

    # -- scheduling ----------------------------------------------------------

    def _min_accept(self, k: int) -> float:
        """Acceptance EMA below which rung ``k`` loses to a plain chunk (the
        reference's flat 2.0 unless ``spec_min_accept`` is given)."""
        return 2.0 if self.spec_min_accept is None else self.spec_min_accept

    def _decide_spec_mode(self, n_occupied: int) -> int:
        """The chunk's draft depth (0: plain), from host state only: the
        reference's ladder, demotion and backed-off probe policy."""
        if not self.spec_k:
            return 0
        if not self.spec_adaptive:
            return self.spec_k
        if self.spec_max_slots is not None and n_occupied > self.spec_max_slots:
            self._chunks_since_spec += 1
            self._probing = False
            return 0
        k = self.spec_ks[self._spec_rung]
        ema = self.spec_accept_ema
        if ema is not None and ema < self._min_accept(k):
            if self._spec_rung > 0:
                self._spec_rung -= 1
                self.spec_accept_ema = None
                return self.spec_ks[self._spec_rung]
            self._chunks_since_spec += 1
            if self._chunks_since_spec >= self._probe_interval:
                self._probing = True
                return k
            return 0
        if ema is not None and self._spec_rung + 1 < len(self.spec_ks) and ema >= 0.85 * k:
            self._spec_rung += 1
            self.spec_accept_ema = None
            return self.spec_ks[self._spec_rung]
        return k

    def _pop_pending(self) -> Optional[Request]:
        with self._prep_cv:
            return self.pending.popleft() if self.pending else None

    def _fill_slots(self) -> None:
        joiners = []
        for slot in range(self.n_slots):
            while self.slot_req[slot] is None:
                req = self._pop_pending()
                if req is None:
                    break
                if req.cancelled:  # cancelled while queued: never joins
                    req.done = True
                    self.completed.append(req)
                    if req.on_tokens is not None:
                        req.on_tokens([], True)
                    continue
                req.t_taken = time.perf_counter_ns()
                joiners.append((slot, req))
                break
        if not joiners:
            return
        try:
            self._join_group(joiners)
        except Exception:
            # One bad request must not fail its groupmates or the engine:
            # retry one by one, and a request that fails alone carries it.
            for slot, req in joiners:
                self.slot_req[slot] = None
                try:
                    self._join_group([(slot, req)])
                except Exception as e:
                    req.error = e
                    req.done = True
                    self.completed.append(req)
                    self.slot_req[slot] = None
                    if req.on_tokens is not None:
                        req.on_tokens([], True)

    def _run_chunk(self, k_chunk: int, sampled: bool) -> torch.Tensor:
        """Dispatch one chunk on the current window: the tokens (B, chunk),
        or for a speculative chunk (B, 1 + spec_chunk x k) with each row's
        count first; nothing is read back."""
        st = self.state
        advance = self.spec_chunk * k_chunk if k_chunk else self.chunk
        occupied = [int(self.host_lengths[i]) for i in range(self.n_slots) if self.slot_req[i] is not None]
        gemma.check_row_room(occupied, advance, self.window)
        st.counts.zero_()  # before a capture too: its warm-up step writes at them
        st.step.zero_()
        runner = self._step_runner(k_chunk, sampled)
        gens = (self.generator, self.noise_generator)
        if k_chunk:
            runner.run(self.spec_chunk, gens)
            return torch.cat([st.counts[:, None], st.out[:, : self.spec_chunk * k_chunk]], dim=1)
        runner.run(self.chunk, gens)
        return st.out[:, : self.chunk]

    def step(self) -> bool:
        """Run one decode chunk, join pending requests while it runs on the
        device, evict finished slots at the chunk boundary (the reference's
        order of work). Returns False when there is nothing left to do."""
        t_step0 = time.perf_counter()
        had_active = any(r is not None for r in self.slot_req)
        if not had_active:
            self._fill_slots()
            if not any(r is not None for r in self.slot_req):
                return bool(self.pending)

        ready_first, self._pending_first = self._pending_first, []
        active: List[Optional[Request]] = list(self.slot_req)
        n_occupied = sum(1 for r in self.slot_req if r is not None)
        # The host's counterpart of the reference's on-device branch: any
        # occupied slot sampling picks the sampled graph.
        sampled = any(r is not None and r.temperature > 0.0 for r in self.slot_req)
        k_chunk = self._decide_spec_mode(n_occupied)
        use_spec = k_chunk > 0
        if self.spec_k:
            self.spec_mode_log.append(use_spec)
            self.spec_k_log.append(k_chunk)
            if len(self.spec_mode_log) > 8192:
                del self.spec_mode_log[:4096]
                del self.spec_k_log[:4096]
        self.chunks_run += 1

        t_disp0 = time.perf_counter()
        if self.window_buckets:
            occ = [int(self.host_lengths[i]) for i in range(self.n_slots) if self.slot_req[i] is not None]
            advance = self.spec_chunk * k_chunk + k_chunk if use_spec else self.chunk
            need = (max(occ) if occ else 0) + advance + 1
            target = next(b for b in self.window_buckets if b >= need)
            if target != self.window:
                self.cache = self._view(target)
                self.window = target
                self.window_resizes += 1
        packed = self._run_chunk(k_chunk, sampled)
        # One host read a chunk: the chunk's tokens and every pending group's
        # first tokens, copied right behind the chunk, before the join.
        flat = torch.cat([packed.reshape(-1)] + [f.reshape(-1) for _, f in ready_first])
        if self.device.type == "cuda":
            fetched_host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            fetched_host.copy_(flat, non_blocking=True)
            fetched_event = torch.cuda.Event()
            fetched_event.record()
        else:
            fetched_host, fetched_event = flat, None
        self.host_t["decode_dispatch"] += time.perf_counter() - t_disp0
        if had_active:
            self._fill_slots()  # overlapped: enqueued behind the chunk
        t_fetch0 = time.perf_counter()
        if fetched_event is not None:
            fetched_event.synchronize()
        fetched = fetched_host.numpy()
        packed_np = fetched[: packed.numel()].reshape(tuple(packed.shape))
        first_np, off = [], packed.numel()
        for _, f in ready_first:
            first_np.append(fetched[off: off + f.numel()])
            off += f.numel()
        self.host_t["fetch"] += time.perf_counter() - t_fetch0
        t_dist0 = time.perf_counter()
        t_held = time.perf_counter_ns()
        if use_spec:
            counts_np, toks_np = packed_np[:, 0], packed_np[:, 1:]
            self.spec_verifies += self.spec_chunk * sum(1 for i in range(self.n_slots) if active[i] is not None)
            occ = [i for i in range(self.n_slots) if active[i] is not None]
            if occ:
                rate = float(np.sum(counts_np[occ])) / (self.spec_chunk * len(occ))
                if self._probing:
                    self._probing = False
                    self._chunks_since_spec = 0
                    self.spec_accept_ema = rate
                    if rate >= self._min_accept(k_chunk):
                        self._probe_interval = self.spec_probe_every
                    else:
                        self._probe_interval = min(self._probe_interval * 2, 8 * self.spec_probe_every)
                else:
                    self._chunks_since_spec = 0
                    self.spec_accept_ema = (rate if self.spec_accept_ema is None
                                            else 0.7 * self.spec_accept_ema + 0.3 * rate)
        else:
            toks_np = packed_np
            counts_np = np.full((toks_np.shape[0],), self.chunk, np.int32)
        for i in range(self.n_slots):
            if active[i] is not None:
                self.host_lengths[i] += int(counts_np[i])
        touched: List[Request] = []

        # First tokens precede the chunk's tokens; a slot its first token
        # finished is freed and its chunk tokens discarded.
        for (joiners, _), vals in zip(ready_first, first_np):
            for (slot, req), val in zip(joiners, vals.tolist()):
                if self.slot_req[slot] is not req:
                    continue  # the join failed and was retried elsewhere
                req.tokens.append(int(val))
                req.t_first = t_held
                self.tokens_delivered += 1
                touched.append(req)
                if int(val) == self.eos_token_id or req.max_new_tokens <= 1:
                    self._finish(slot)

        for slot in range(self.n_slots):
            cur = self.slot_req[slot]
            if cur is not None and cur.cancelled:
                self._finish(slot)
                if cur not in touched:
                    touched.append(cur)
            req = active[slot]
            if req is None or self.slot_req[slot] is not req:
                continue
            if req not in touched:
                touched.append(req)
            vals = toks_np[slot][: counts_np[slot]]
            n_take = min(vals.shape[0], req.max_new_tokens - len(req.tokens))
            eos_idx = np.flatnonzero(vals[:n_take] == self.eos_token_id)
            hit_eos = eos_idx.size > 0
            if hit_eos:
                n_take = int(eos_idx[0]) + 1
            req.tokens.extend(vals[:n_take].tolist())
            self.tokens_delivered += n_take
            if use_spec:
                self.spec_emitted += n_take
            if hit_eos or len(req.tokens) >= req.max_new_tokens:
                self._finish(slot)

        for req in touched:
            if req.on_tokens is not None:
                n = req.notified
                req.notified = len(req.tokens)
                req.on_tokens(req.tokens[n:], req.done)
        self.host_t["distribute"] += time.perf_counter() - t_dist0
        self.host_t["step_total"] += time.perf_counter() - t_step0
        return True

    def run(self) -> List[Request]:
        """Drive until every submitted request completes; returns them in
        completion order."""
        while self.step():
            pass
        return self.completed

    def decode_text(self, req: Request) -> str:
        return self.processor.tokenizer.decode(req.tokens, skip_special_tokens=True)

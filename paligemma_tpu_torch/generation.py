"""Autoregressive generation (port of ``paligemma_tpu/generation.py``:
``make_cache``, prefill, ``decode_steps``, ``generate``,
``generate_chunked[_stream]``, ``generate_scan``, and speculative decoding:
the n-gram and longest-match drafters, ``decode_steps_spec`` and
``generate_spec``), greedy or sampled.

Two functions run on the device, each in place on static buffers and with
the cache length on the device, so neither reads anything back to the
host: the prefill (``models/paligemma.prefill`` with last-position logits;
the reference's ``_prefill_jit``) and the decode step, ``_decode_step``
(the model's step, then the token choice,
``ops.sampling.select_token_traced``; the reference's jitted step). The
choice of the first token stays outside the prefill, as the reference's
``generate`` keeps it outside ``_prefill_jit``.

- On a CUDA cache each is captured in a CUDA graph and replayed: the
  port's counterpart of the reference's compiled programs. There is no
  eager fallback: a failed capture raises. On a CPU cache the same
  functions run eagerly.
- The prefill is captured once per (cache buffers, model, ``fns``,
  ``input_ids`` shape, ``pixel_values`` shape and dtype), as ``jax.jit``
  compiles once per shape: the prompt is never padded. The first call of a
  shape is the eager prefill, run on a side stream as the capture's
  warm-up; its logits and cache rows are that call's answer. Then the
  graph is captured (which runs nothing), and every later call of the
  shape copies its inputs into the graph's static buffers and replays it.
  A cache keeps its ``PREFILL_GRAPHS`` prefill graphs used last.
  ``prepare_prefill`` captures one ahead of a request.
- A ``decode_steps`` chunk of ``n`` steps is ``n`` replays of one step's
  graph with no host sync between them (the reference's one ``lax.scan``
  program), its tokens on the device until the caller reads them;
  ``generate`` replays it once a token. One graph of one step serves every
  chunk length. It is captured once per (cache buffers, model, ``fns``,
  ``do_sample``, EOS freeze).
- Every graph is kept with the cache (``KVCache.graphs``); a cache with
  other buffers, or another model, never replays it.
- A replay adds the kernel launches (and the int8 x int8 calls) captured
  in it to the wrappers' counts (``ops.kernels.add_launch_counts``); the
  capture itself counts nothing, nor does the decode step's warm-up (the
  prefill's warm-up counts: it is a request's prefill).
- Sampling draws from a ``torch.Generator`` (None: the device's default).
  A graph draws from a generator of its own, set from the caller's before
  its replays and copied back after them, so the stream is the one the
  eager step would draw and a seed repeats its tokens.
- ``generate``, ``generate_chunked_stream`` and ``generate_scan`` take
  their cache from a per-model pool. Its length is rounded up to a
  whole number of ``CACHE_LENGTH_STEP`` positions, so prompts of nearby
  lengths share one cache shape; a cache of that shape that its last
  caller has dropped is handed out again, zeroed, with its graphs, so a
  request of a known shape captures nothing. The pool keeps the
  ``POOL_SLOTS`` caches handed out last.
- ``generate`` is the batch-1 loop of the reference's inference script: one
  replay and one host read (the EOS check) per token. ``generate_scan`` is
  one prefill replay, the first token's choice and the decode replays,
  with no host sync until the caller reads the result.
- Speculative decoding (batch 1): one verify iteration (draft from the
  token buffer, ``verify_step`` over ``[token, drafts]``, the model's
  choice at each of the k positions, the longest agreeing prefix accepted)
  is a step on device buffers, captured once as a CUDA graph per (cache
  buffers, model, ``fns``, k, n, drafter, ``do_sample``).
  ``decode_steps_spec`` replays it in groups: ``ceil((n_steps - produced)
  / k)`` replays, then one read of ``produced``, until ``n_steps`` tokens
  are produced. No iteration inside a group can reach ``n_steps`` before
  the last one (an iteration accepts at most k tokens), so the port runs
  exactly the iterations of the reference's ``while_loop``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import time
import weakref
from typing import Callable, Iterator, List, NamedTuple, Optional, Tuple, Union

import torch

from paligemma_tpu_torch import quantization
from paligemma_tpu_torch.models import gemma, paligemma
from paligemma_tpu_torch.models.gemma import KVCache
from paligemma_tpu_torch.models.paligemma import PaliGemma
from paligemma_tpu_torch.ops import kernels
from paligemma_tpu_torch.ops.kernels import KERNELS, KernelFns
from paligemma_tpu_torch.ops.sampling import select_token_traced
from paligemma_tpu_torch.parallel import comm

Scalar = Union[float, torch.Tensor]


class GenerationResult(NamedTuple):
    tokens: torch.Tensor  # (B, max_new) int32, EOS after the stop
    num_valid: torch.Tensor  # (B,) int32: tokens up to and including EOS


def make_cache(
    model: PaliGemma,
    batch: int,
    prompt_len: int,
    max_new_tokens: int,
    cache_dtype: Optional[torch.dtype] = None,
) -> KVCache:
    """A new cache for ``prompt_len + max_new_tokens`` positions on the
    model's device. ``cache_dtype`` None: the decoder's activation dtype (the
    attention kernels take the activations' dtype; an int8 embedding makes
    it bf16); ``torch.int8``: a ``QuantKVCache``."""
    dtype = gemma.activation_dtype(model.llm) if cache_dtype is None else cache_dtype
    return gemma.init_cache(
        model.cfg.text_config, batch, prompt_len + max_new_tokens, dtype,
        model.llm.final_norm.weight.device,
    )


# The pool of the generate functions' caches: a pooled cache's length is a
# whole number of this many positions, and each model keeps at most this
# many caches.
CACHE_LENGTH_STEP = 64
POOL_SLOTS = 4
# Per model (held weakly: a model's caches and their graphs go with it), the
# slots, the one handed out last at the end: [(batch, length, dtype), the
# buffers, a weak reference to the KVCache object last handed out].
_CACHE_POOL: "weakref.WeakKeyDictionary[PaliGemma, List[list]]" = weakref.WeakKeyDictionary()


def _pooled_cache(
    model: PaliGemma, batch: int, prompt_len: int, max_new_tokens: int,
    cache_dtype: Optional[torch.dtype],
) -> KVCache:
    """A cache as ``make_cache`` makes it, its length rounded up to a whole
    number of ``CACHE_LENGTH_STEP`` positions: the buffers of one that no
    caller holds any more (zeroed, with the graphs captured on them), or new
    ones. A slot past the ``POOL_SLOTS`` used last is dropped (its cache
    lives on with its holder, if any)."""
    dtype = gemma.activation_dtype(model.llm) if cache_dtype is None else cache_dtype
    length = -(-(prompt_len + max_new_tokens) // CACHE_LENGTH_STEP) * CACHE_LENGTH_STEP
    key = (batch, length, dtype)
    slots = _CACHE_POOL.setdefault(model, [])
    for i, slot in enumerate(slots):
        if slot[0] == key and slot[2]() is None:
            del slots[i]
            cache = gemma.reset_cache(slot[1])
            break
    else:
        slot = [key, make_cache(model, batch, prompt_len, length - prompt_len, dtype), None]
        cache = dataclasses.replace(slot[1])
        del slots[: max(0, len(slots) + 1 - POOL_SLOTS)]
    slot[2] = weakref.ref(cache)
    slots.append(slot)
    return cache


def graphs_on(model: PaliGemma, device) -> bool:
    """Whether the runners capture CUDA graphs of ``model`` on ``device``:
    on a CUDA device, unless the model is sharded over a group whose
    collectives cannot be captured (gloo; ``parallel.comm.capturable``),
    where they run eagerly."""
    return torch.device(device).type == "cuda" and comm.capturable(model)


def _buffers(cache: KVCache) -> tuple:
    return tuple(getattr(cache, f.name).data_ptr() for f in dataclasses.fields(cache)
                 if isinstance(getattr(cache, f.name), torch.Tensor))


class _Captured:
    """What the graph runners share (the prefill and decode runners here,
    batched serving's step, the ablation's no-cache step, the continuous
    engine's steps, the LoRA train step and eval loss): a function on one
    cache's buffers (or on buffers of its own, ``cache`` None), captured on
    a CUDA device as a CUDA graph, and the counts each replay adds. Holds no
    reference to the cache, and the model only weakly, to tell whether it is
    still the one the graph reads."""

    def __init__(self, model: PaliGemma, cache: Optional[KVCache], fns: KernelFns):
        self.model_ref, self.fns = weakref.ref(model), fns
        self.buffers = () if cache is None else _buffers(cache)
        self.graph, self.counts, self.capture_ms = None, {}, 0.0

    def serves(self, model: PaliGemma, cache: KVCache) -> bool:
        return self.model_ref() is model and self.buffers == _buffers(cache)

    def _capture(self, dev: torch.device, run: Callable, restore: Optional[Callable] = None,
                 generator=None, count_warm_up: bool = False, pool=None):
        """Run ``run()`` once on a side stream (PyTorch's warm-up: lazy
        set-up such as cuBLAS handles, workspaces and first loads happens
        there), call ``restore()``, capture ``run()`` (which runs nothing),
        call ``restore()`` again. The capture's counts are what a replay
        adds; the warm-up's stay counted with ``count_warm_up``. Returns
        (the warm-up's result, the captured run's: the graph's outputs).
        ``generator``: one generator, or a sequence of them, that the graph
        draws from; ``pool``: the memory pool to capture into (None: one of
        the graph's own). The capture is in ``thread_local`` mode, so CUDA
        calls of another thread (a serving engine's staged uploads) cannot
        invalidate it."""
        t0 = time.perf_counter()
        before = kernels.call_counts()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            warm = run()
        torch.cuda.current_stream(dev).wait_stream(side)
        if restore is not None:
            restore()
        mid = kernels.call_counts()
        graph = torch.cuda.CUDAGraph()
        for gen in (generator if isinstance(generator, (tuple, list)) else (generator,)):
            if gen is not None:
                graph.register_generator_state(gen)
        with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            out = run()
        if restore is not None:
            restore()
        after = kernels.call_counts()
        self.counts = {k: after[k] - mid[k] for k in after if after[k] != mid[k]}
        kernels.add_launch_counts({k: (mid if count_warm_up else before)[k] - after[k] for k in after})
        self.graph, self.capture_ms = graph, (time.perf_counter() - t0) * 1e3
        return warm, out

    def _replay(self) -> None:
        self.graph.replay()
        kernels.add_launch_counts(self.counts)

    def upload(self, dev: torch.device) -> None:
        """Upload the captured graph to the device now. Its first replay
        would, and that upload waits behind the stream's pending copies: a
        join's first replay behind its pixels' copy held the host until the
        chunk ahead of it ended."""
        rc = _libcuda().cuGraphUpload(ctypes.c_void_p(self.graph.raw_cuda_graph_exec()),
                                      ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        if rc:
            raise RuntimeError(f"cuGraphUpload failed: CUresult {rc}")


@functools.lru_cache(maxsize=None)
def _libcuda() -> ctypes.CDLL:
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphUpload.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.cuGraphUpload.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# The prefill, eager or as a CUDA graph
# ---------------------------------------------------------------------------


# The prefill graphs a cache keeps (those used last). One graph of the 3B
# model holds 78-168 MiB of device memory (PERF.md), so the POOL_SLOTS
# caches of a model hold at most ~2.7 GiB of them.
PREFILL_GRAPHS = 4


def _prefill(model, input_ids, pixel_values, cache, fns) -> torch.Tensor:
    """The prefill a graph captures: (B, 1, V) fp32 last-position logits;
    the cache holds the prompt's K/V rows after it."""
    return paligemma.prefill(model, input_ids, pixel_values, cache, full_logits=False, fns=fns)[0]


class _PrefillRunner(_Captured):
    """``_prefill`` on one cache's buffers for one input shape: eager on a
    CPU cache; on a CUDA cache, the first call's eager prefill (the
    capture's warm-up, the call's answer), then the graph captured on static
    copies of its inputs, which every later call fills and replays."""

    def __init__(self, model, cache, fns):
        super().__init__(model, cache, fns)
        self.ids = self.pix = self.logits = None

    def run(self, model: PaliGemma, cache: KVCache, input_ids: torch.Tensor,
            pixel_values: torch.Tensor) -> torch.Tensor:
        if not graphs_on(model, cache.k.device):
            return _prefill(model, input_ids, pixel_values, cache, self.fns)
        if cache.host_length:  # the graph writes the rows from 0 on
            raise ValueError("prefill (T > 1) needs an empty cache")
        if self.graph is None:
            self.ids = input_ids.clone(memory_format=torch.contiguous_format)
            self.pix = pixel_values.clone(memory_format=torch.contiguous_format)

            def run():  # capturing a forward advances the host length too
                cache.host_length = 0
                return _prefill(model, self.ids, self.pix, cache, self.fns)

            logits, self.logits = self._capture(cache.k.device, run, count_warm_up=True)
            return logits
        self.ids.copy_(input_ids)
        self.pix.copy_(pixel_values)
        self._replay()
        cache.host_length = input_ids.shape[1]
        return self.logits.clone()


def _prefill_runner(model, cache, fns, ids_shape, pix_shape, pix_dtype) -> _PrefillRunner:
    """The cache's prefill runner of this shape (a new one if it has none
    that reads this model and these buffers), now its most recently used;
    prefill runners past the ``PREFILL_GRAPHS`` used last are dropped."""
    key = ("prefill", id(model), fns, tuple(ids_shape), tuple(pix_shape), pix_dtype)
    runner = cache.graphs.pop(key, None)
    if runner is None or not runner.serves(model, cache):
        runner = _PrefillRunner(model, cache, fns)
    cache.graphs[key] = runner
    for k in [k for k in cache.graphs if k[0] == "prefill"][:-PREFILL_GRAPHS]:
        del cache.graphs[k]
    return runner


@torch.no_grad()
def prefill(
    model: PaliGemma,
    input_ids: torch.Tensor,
    pixel_values: torch.Tensor,
    cache: KVCache,
    fns: KernelFns = KERNELS,
) -> Tuple[torch.Tensor, KVCache]:
    """Prefill into the empty ``cache`` with last-position logits only:
    (B, 1, V) fp32 + the warm cache. On a CUDA cache a replay of the graph
    of this input shape (captured at the first call of the shape, whose
    answer is the eager prefill that warms the capture up)."""
    runner = _prefill_runner(model, cache, fns, input_ids.shape, pixel_values.shape, pixel_values.dtype)
    return runner.run(model, cache, input_ids, pixel_values), cache


@torch.no_grad()
def prepare_prefill(
    model: PaliGemma,
    cache: KVCache,
    input_ids_shape: Tuple[int, int],
    pixel_values_shape: Tuple[int, int, int, int],
    fns: KernelFns = KERNELS,
) -> float:
    """Capture the cache's prefill graph for inputs of these shapes now,
    before a request needs it (pixel values in the vision tower's dtype), on
    zero ids and pixels; the cache is left empty, in place: buffers zeroed,
    ``host_length`` 0. Returns the capture's host ms, warm-up prefill
    included (0.0 when nothing was captured: a CPU cache, or a graph of
    these shapes already)."""
    if not graphs_on(model, cache.k.device):
        return 0.0
    pix_dtype = model.vision.patch_embedding.weight.dtype
    runner = _prefill_runner(model, cache, fns, input_ids_shape, pixel_values_shape, pix_dtype)
    if runner.graph is not None:
        return 0.0
    dev = cache.k.device
    runner.run(model, cache, torch.zeros(input_ids_shape, dtype=torch.int32, device=dev),
               torch.zeros(pixel_values_shape, dtype=pix_dtype, device=dev))
    gemma.reset_cache(cache)
    cache.host_length = 0
    return runner.capture_ms


# ---------------------------------------------------------------------------
# The decode step, eager or as a CUDA graph
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class _StepState:
    """The step's inputs and outputs on the device (a graph's static
    buffers): ``token`` (B, 1) is read and overwritten by the next token,
    which also lands in ``out[:, step]``; ``step`` (1,) advances."""

    token: torch.Tensor  # (B, 1) int32
    out: torch.Tensor  # (B, max_len) int32
    step: torch.Tensor  # (1,) int64
    temperature: torch.Tensor  # (B, 1) fp32
    top_p: torch.Tensor  # (B, 1) fp32
    eos: torch.Tensor  # () int32
    done: torch.Tensor  # (B,) bool, rows past their EOS (the freeze)
    generator: Optional[torch.Generator] = None


def _decode_step(
    model: PaliGemma, cache: KVCache, st: _StepState, fns: KernelFns, do_sample: bool,
    freeze: bool,
) -> None:
    """One decode step, in place: ``st.token`` -> the next token, the cache
    advanced by one. With ``freeze`` a row that has emitted EOS emits EOS
    (and is fed it) from then on, as the reference's ``generate_scan``."""
    logits, _ = paligemma.decode_step(model, st.token, cache, fns)
    nxt = select_token_traced(logits[:, -1, :], st.generator, do_sample, st.temperature, st.top_p)
    if freeze:
        nxt = torch.where(st.done, st.eos, nxt)
        st.done.logical_or_(nxt == st.eos)
    st.token.copy_(nxt[:, None])
    st.out.index_copy_(1, st.step, st.token)
    st.step.add_(1)


class _DecodeRunner(_Captured):
    """``_decode_step`` on one cache's buffers: eager on a CPU cache; on a
    CUDA cache, captured as a CUDA graph that a run replays once a step."""

    def __init__(self, model, cache, fns, do_sample, freeze):
        super().__init__(model, cache, fns)
        b, dev = cache.valid.shape[0], cache.k.device
        self.state = _StepState(
            token=torch.zeros((b, 1), dtype=torch.int32, device=dev),
            out=torch.zeros((b, cache.max_len), dtype=torch.int32, device=dev),
            step=torch.zeros(1, dtype=torch.int64, device=dev),
            temperature=torch.zeros((b, 1), dtype=torch.float32, device=dev),
            top_p=torch.zeros((b, 1), dtype=torch.float32, device=dev),
            eos=torch.zeros((), dtype=torch.int32, device=dev),
            done=torch.zeros(b, dtype=torch.bool, device=dev),
        )
        self.do_sample, self.freeze = do_sample, freeze
        if graphs_on(model, dev):
            if do_sample:  # a generator of the graph's own, registered with it
                self.state.generator = torch.Generator(device=dev)
            # The warm-up step is undone: the cache's length is put back.
            length, valid, host_length = cache.length.clone(), cache.valid.clone(), cache.host_length

            def restore():
                cache.length.copy_(length)
                cache.valid.copy_(valid)
                cache.host_length = host_length

            self._capture(dev, lambda: self._step(model, cache), restore, self.state.generator)

    def _step(self, model, cache) -> None:
        _decode_step(model, cache, self.state, self.fns, self.do_sample, self.freeze)

    def start(self, token: torch.Tensor, temperature: Scalar = 0.0, top_p: Scalar = 1.0,
              eos: Optional[int] = None) -> None:
        """Set the inputs of a run: the (B, 1) token, the sampling values
        (floats, or 0-d or (B, 1) tensors) and, with the freeze, the EOS id
        (rows whose ``token`` is EOS are done)."""
        st = self.state
        st.token.copy_(token)
        st.step.zero_()
        if self.do_sample:
            for buf, x in ((st.temperature, temperature), (st.top_p, top_p)):
                if isinstance(x, torch.Tensor):
                    buf.copy_(x)
                else:
                    buf.fill_(x)
        if self.freeze:
            st.eos.fill_(eos)
            st.done.copy_(st.token[:, 0] == eos)

    def run(self, model: PaliGemma, cache: KVCache, n: int,
            generator: Optional[torch.Generator] = None) -> None:
        """``n`` steps on ``cache`` from ``start``'s inputs (or where the last
        run stopped); the tokens land in ``state.out[:, :n]`` of a run."""
        if cache.host_length + n > cache.max_len:
            raise ValueError(f"cache full: {cache.host_length} + {n} > {cache.max_len}")
        if self.graph is None:
            self.state.generator = generator
            for _ in range(n):
                self._step(model, cache)
            return
        if self.do_sample:
            caller = generator
            if caller is None:
                caller = torch.cuda.default_generators[cache.k.device.index or 0]
            self.state.generator.set_state(caller.get_state())
        for _ in range(n):
            self._replay()
        cache.host_length += n
        if self.do_sample:
            caller.set_state(self.state.generator.get_state())


def _key(model: PaliGemma, fns: KernelFns, do_sample: bool, freeze: bool) -> tuple:
    return id(model), fns, do_sample, freeze


def _runner(
    model: PaliGemma, cache: KVCache, fns: KernelFns, do_sample: bool, freeze: bool = False,
) -> _DecodeRunner:
    """The cache's runner for this step, captured now if it has none that
    reads this model and these buffers."""
    key = _key(model, fns, do_sample, freeze)
    runner = cache.graphs.get(key)
    if runner is None or not runner.serves(model, cache):
        runner = cache.graphs[key] = _DecodeRunner(model, cache, fns, do_sample, freeze)
    return runner


@torch.no_grad()
def prepare_decode(
    model: PaliGemma, cache: KVCache, fns: KernelFns = KERNELS, *, do_sample: bool = False,
) -> float:
    """Capture the cache's decode graph now, before the first step needs it
    (nothing to do on a CPU cache or when it is captured already). Returns
    the capture's host ms, warm-up step included (0.0 when nothing was
    captured)."""
    had = cache.graphs.get(_key(model, fns, do_sample, False))
    runner = _runner(model, cache, fns, do_sample)
    return runner.capture_ms if runner is not had else 0.0


@torch.no_grad()
def decode_steps(
    model: PaliGemma,
    token: torch.Tensor,
    cache: KVCache,
    n_steps: int,
    fns: KernelFns = KERNELS,
    *,
    generator: Optional[torch.Generator] = None,
    do_sample: bool = False,
    temperature: Scalar = 0.0,
    top_p: Scalar = 0.9,
) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """``n_steps`` decode steps from the (B, 1) ``token``, greedy or sampled
    (``temperature`` <= 0 under ``do_sample`` decodes greedily); on a CUDA
    cache ``n_steps`` replays of the captured step.

    Returns (tokens (B, n_steps) int32, last token (B, 1), cache); nothing
    is read back to the host.
    """
    runner = _runner(model, cache, fns, do_sample)
    runner.start(token, temperature, top_p)
    runner.run(model, cache, n_steps, generator)
    st = runner.state
    return st.out[:, :n_steps].clone(), st.token.clone(), cache


def _first_token(model, input_ids, pixel_values, cache, fns, generator, do_sample, temperature,
                 top_p) -> Tuple[torch.Tensor, KVCache]:
    """Prefill, then the first token (B,) chosen on the device."""
    logits, cache = prefill(model, input_ids, pixel_values, cache, fns)
    return select_token_traced(logits[:, -1, :], generator, do_sample, temperature, top_p), cache


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
    *,
    do_sample: bool = False,
    temperature: Scalar = 0.8,
    top_p: Scalar = 0.9,
    generator: Optional[torch.Generator] = None,
    stop_at_eos: bool = True,
) -> Tuple[List[int], KVCache]:
    """Batch-1 generation with a host EOS exit (reference: inference.py:55-78).

    ``step_callback(step)`` runs after each token has reached the host
    (step 0 is the prefill's token). ``cache_dtype``: as ``make_cache``'s
    (``torch.int8`` for the int8 cache). Sampled with ``do_sample`` and
    ``temperature > 0``. Returns (token ids, final cache); the cache is the
    pool's (the next request of its shape takes its buffers once the
    caller drops it).
    """
    b, t = input_ids.shape
    if b != 1:
        raise ValueError(f"generate() is batch-1 (got batch {b})")
    cache = _pooled_cache(model, b, t, max_new_tokens, cache_dtype)
    token, cache = _first_token(model, input_ids, pixel_values, cache, fns, generator, do_sample,
                                temperature, top_p)
    out = [int(token[0])]
    if step_callback is not None:
        step_callback(0)
    if (stop_at_eos and out[-1] == eos_token_id) or max_new_tokens == 1:
        return out, cache
    runner = _runner(model, cache, fns, do_sample)
    runner.start(token[:, None], temperature, top_p)
    for step in range(1, max_new_tokens):
        runner.run(model, cache, 1, generator)
        out.append(int(runner.state.token[0, 0]))  # host sync, like the reference's .item()
        if step_callback is not None:
            step_callback(step)
        if stop_at_eos and out[-1] == eos_token_id:
            break
    return out, cache


@torch.no_grad()
def generate_chunked_stream(
    model: PaliGemma,
    input_ids: torch.Tensor,
    pixel_values: torch.Tensor,
    max_new_tokens: int,
    eos_token_id: int,
    fns: KernelFns = KERNELS,
    cache_dtype: Optional[torch.dtype] = None,
    *,
    do_sample: bool = False,
    temperature: Scalar = 0.8,
    top_p: Scalar = 0.9,
    generator: Optional[torch.Generator] = None,
    chunk: int = 16,
) -> Iterator[List[int]]:
    """Batch-1 streaming generation: yields the prefill's token, then the
    tokens of each ``decode_steps`` chunk (one host read a chunk). The
    cache is allocated to whole chunks, so every chunk replays one graph;
    the last piece is trimmed at ``max_new_tokens``, then at EOS."""
    b, t = input_ids.shape
    if b != 1:
        raise ValueError(f"generate_chunked is batch-1 (got batch {b})")
    alloc = -(-max(max_new_tokens - 1, 1) // chunk) * chunk + 1
    cache = _pooled_cache(model, b, t, alloc, cache_dtype)
    tok, cache = _first_token(model, input_ids, pixel_values, cache, fns, generator, do_sample,
                              temperature, top_p)
    first = int(tok[0])
    yield [first]
    if first == eos_token_id:
        return
    produced, tok = 1, tok[:, None]
    while produced < max_new_tokens:
        toks, tok, cache = decode_steps(model, tok, cache, chunk, fns, generator=generator,
                                        do_sample=do_sample, temperature=temperature, top_p=top_p)
        new = toks[0].tolist()[: max_new_tokens - produced]  # trim past max_new, then at EOS
        if eos_token_id in new:
            yield new[: new.index(eos_token_id) + 1]
            return
        produced += len(new)
        yield new


def generate_chunked(
    model: PaliGemma,
    input_ids: torch.Tensor,
    pixel_values: torch.Tensor,
    max_new_tokens: int,
    eos_token_id: int,
    **kwargs,
) -> List[int]:
    """``generate_chunked_stream``'s pieces joined: ``generate``'s tokens
    with one host read a chunk instead of one a token."""
    out: List[int] = []
    for piece in generate_chunked_stream(model, input_ids, pixel_values, max_new_tokens,
                                         eos_token_id, **kwargs):
        out.extend(piece)
    return out


@torch.no_grad()
def generate_scan(
    model: PaliGemma,
    input_ids: torch.Tensor,
    pixel_values: torch.Tensor,
    max_new_tokens: int,
    eos_token_id: int,
    fns: KernelFns = KERNELS,
    cache_dtype: Optional[torch.dtype] = None,
    *,
    do_sample: bool = False,
    temperature: Scalar = 0.8,
    top_p: Scalar = 0.9,
    generator: Optional[torch.Generator] = None,
) -> GenerationResult:
    """Prefill, then ``max_new_tokens - 1`` decode steps with no host sync
    (on CUDA, replays of the captured step with the EOS freeze: a row's
    tokens after its EOS are EOS). Any batch. ``num_valid`` counts each
    row's tokens up to and including its first EOS; nothing is read back
    until the caller reads the result."""
    b, t = input_ids.shape
    cache = _pooled_cache(model, b, t, max_new_tokens, cache_dtype)
    first, cache = _first_token(model, input_ids, pixel_values, cache, fns, generator, do_sample,
                                temperature, top_p)
    tokens = first[:, None]
    if max_new_tokens > 1:
        runner = _runner(model, cache, fns, do_sample, freeze=True)
        runner.start(tokens, temperature, top_p, eos=eos_token_id)
        runner.run(model, cache, max_new_tokens - 1, generator)
        tokens = torch.cat([tokens, runner.state.out[:, : max_new_tokens - 1]], dim=1)
    is_eos = (tokens == eos_token_id).to(torch.int32)
    done_before = (is_eos.cumsum(dim=1) - is_eos) > 0  # a token is valid unless EOS came before it
    return GenerationResult(tokens.to(torch.int32), (~done_before).sum(dim=1).to(torch.int32))


# ---------------------------------------------------------------------------
# Speculative decoding: the drafters, the verify iteration, generate_spec
# ---------------------------------------------------------------------------
#
# The drafters are device tensor ops only (gathers, cumprod, where, amax,
# argmax): nothing reads a value back, so they sit inside the captured
# verify iteration. Indices are gathered, never sliced: a slice whose
# window crosses the buffer end would have its start clamped and shift
# every proposed token.


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=like.device)


def _ngram_propose_row(ids_row: torch.Tensor, buf_len: torch.Tensor, token: torch.Tensor,
                       k: int, n: int) -> torch.Tensor:
    """Prompt-lookup draft for one row: (k-1,) tokens, those that followed
    the most recent earlier occurrence of the last (n-1)-gram of
    ``ids_row[:buf_len]``; the last token repeated where there is none.
    Continuation positions at or past ``buf_len`` (unwritten, or stale) fall
    back to the repeated token too."""
    L = ids_row.shape[0]
    bl = buf_len.long()
    start = (bl - (n - 1)).clamp(0, L - (n - 1))  # the reference's dynamic_slice start
    gram = ids_row[start + _arange(n - 1, ids_row)]
    idx = _arange(L, ids_row)[:, None] + _arange(n - 1, ids_row)[None, :]
    wins = ids_row[idx.clamp(0, L - 1)]
    starts = _arange(L, ids_row)
    valid = (wins == gram[None, :]).all(dim=-1) & (starts + n - 1 < bl)
    pos = torch.where(valid, starts, -1).amax()
    cont_pos = pos.clamp_min(0) + (n - 1) + _arange(k - 1, ids_row)
    cont = ids_row[cont_pos.clamp_max(L - 1)]
    ok = (pos >= 0) & (cont_pos < bl)
    return torch.where(ok, cont, token)


def _ngram_propose(ids_buf: torch.Tensor, buf_len: torch.Tensor, token: torch.Tensor,
                   k: int, n: int) -> torch.Tensor:
    """(1, k-1) draft for the batch-1 driver (see ``_ngram_propose_row``)."""
    return _ngram_propose_row(ids_buf[0], buf_len, token[0, 0], k, n)[None, :]


# Longest-match drafter: context cap and minimum context to draft from.
LONGEST_NMAX = 16
LONGEST_MIN_MATCH = 1


def _longest_match_propose_row(ids_row: torch.Tensor, buf_len: torch.Tensor, token: torch.Tensor,
                               k: int, n_max: int = LONGEST_NMAX,
                               min_match: int = LONGEST_MIN_MATCH) -> torch.Tensor:
    """Variable-context prompt-lookup draft for one row: (k-1,) tokens from
    the continuation start whose preceding context shares the longest
    suffix with the sequence's end (at most ``n_max``; ties to the most
    recent). With ``n_max = min_match = n-1`` it is the n-gram drafter.
    The n-gram drafter's fallback and validity rules."""
    L = ids_row.shape[0]
    bl = buf_len.long()
    # wins[s]: the n_max tokens ending just before continuation start s.
    idx = _arange(L, ids_row)[:, None] + _arange(n_max, ids_row)[None, :] - n_max
    wins = ids_row[idx.clamp(0, L - 1)]
    sidx = bl - n_max + _arange(n_max, ids_row)
    suf = ids_row[sidx.clamp(0, L - 1)]
    eq = (wins == suf[None, :]) & (idx >= 0) & (sidx >= 0)[None, :]
    # The trailing run of matches, per candidate start.
    run = torch.cumprod(eq.flip(1).to(torch.int64), dim=1).sum(dim=1)
    starts = _arange(L, ids_row)
    cand = (starts < bl) & (run >= min_match)
    # Lexicographic (run, start): longest context first, then most recent.
    score = torch.where(cand, run * L + starts, -1)
    best = score.argmax()
    cont_pos = best + _arange(k - 1, ids_row)
    cont = ids_row[cont_pos.clamp(0, L - 1)]
    ok = (score.amax() >= 0) & (cont_pos < bl)
    return torch.where(ok, cont, token)


def propose_row(drafter: str, ids_row: torch.Tensor, buf_len: torch.Tensor, token: torch.Tensor,
                k: int, n: int) -> torch.Tensor:
    """Draft (k-1,) continuation tokens for one row with the chosen drafter
    (``"ngram"`` or ``"longest"``)."""
    if drafter == "longest":
        return _longest_match_propose_row(ids_row, buf_len, token, k)
    if drafter != "ngram":
        raise ValueError(f"unknown drafter {drafter!r}")
    return _ngram_propose_row(ids_row, buf_len, token, k, n)


@dataclasses.dataclass(eq=False)
class _SpecState:
    """The verify iteration's inputs and outputs on the device (a graph's
    static buffers). ``token`` (1, 1) is the last emitted token, already in
    ``ids`` at ``buf_len - 1``; each iteration writes its k candidates into
    ``out`` at ``produced`` and into ``ids`` at ``buf_len`` and advances
    both by the accepted count."""

    token: torch.Tensor  # (1, 1) int32
    ids: torch.Tensor  # (1, max_len + k) int32: prompt + emitted tokens
    buf_len: torch.Tensor  # () int32
    out: torch.Tensor  # (1, max_len + k) int32
    produced: torch.Tensor  # () int32
    iters: torch.Tensor  # () int32
    temperature: torch.Tensor  # (1, 1) fp32
    top_p: torch.Tensor  # (1, 1) fp32
    generator: Optional[torch.Generator] = None


def _verify_iteration(model: PaliGemma, cache: KVCache, st: _SpecState, fns: KernelFns, k: int,
                      n: int, drafter: str, do_sample: bool) -> None:
    """One speculative iteration, in place (the body of the reference's
    ``decode_steps_spec`` loop): draft, verify ``[token, drafts]``, choose
    at every position (greedy, or one batched sampled choice over the k
    rows), accept the longest prefix of drafts that the choices repeat plus
    one token, and roll the cache length back to it."""
    drafts = propose_row(drafter, st.ids[0], st.buf_len, st.token[0, 0], k, n)
    logits, _ = paligemma.verify_step(model, torch.cat([st.token, drafts[None, :]], dim=1), cache, fns)
    if do_sample:
        a = select_token_traced(logits[0], st.generator, True, st.temperature, st.top_p)
    else:
        a = logits[0].float().argmax(dim=-1).to(torch.int32)
    matched = torch.cumprod((drafts == a[:-1]).to(torch.int32), dim=0).sum()
    accept = (matched + 1).to(torch.int32)  # tokens emitted this iteration
    cache.length.sub_(k - accept)  # the verify advanced it by k
    # Every candidate is written; the columns past ``accept`` are
    # overwritten by the next iteration and never read before. The indices
    # are clamped to the buffers (the driver's bounds checks catch overruns).
    width = st.out.shape[1]
    st.out.index_copy_(1, (st.produced + _arange(k, a)).clamp_max(width - 1), a[None, :])
    st.ids.index_copy_(1, (st.buf_len + _arange(k, a)).clamp_max(width - 1), a[None, :])
    st.token.copy_(a.gather(0, matched.view(1)).view(1, 1))
    st.produced.add_(accept)
    st.iters.add_(1)
    st.buf_len.add_(accept)


class _SpecRunner(_Captured):
    """``_verify_iteration`` on one cache's buffers: eager on a CPU cache;
    on a CUDA cache, captured as a CUDA graph that a run replays once an
    iteration (the warm-up iteration undone)."""

    def __init__(self, model, cache, fns, k, n, drafter, do_sample):
        super().__init__(model, cache, fns)
        dev, width = cache.k.device, cache.max_len + k

        def zeros(shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.state = _SpecState(token=zeros((1, 1)), ids=zeros((1, width)), buf_len=zeros(()),
                                out=zeros((1, width)), produced=zeros(()), iters=zeros(()),
                                temperature=zeros((1, 1), torch.float32),
                                top_p=zeros((1, 1), torch.float32))
        self.k, self.n, self.drafter, self.do_sample = k, n, drafter, do_sample
        if graphs_on(model, dev):
            if cache.host_length + k > cache.max_len:  # the warm-up writes k rows
                raise ValueError(f"cache full: {cache.host_length} + {k} > {cache.max_len}")
            if do_sample:  # a generator of the graph's own, registered with it
                self.state.generator = torch.Generator(device=dev)
            length, valid, host_length = cache.length.clone(), cache.valid.clone(), cache.host_length

            def restore():
                cache.length.copy_(length)
                cache.valid.copy_(valid)
                cache.host_length = host_length

            self._capture(dev, lambda: self._step(model, cache), restore, self.state.generator)

    def _step(self, model, cache) -> None:
        _verify_iteration(model, cache, self.state, self.fns, self.k, self.n, self.drafter,
                          self.do_sample)

    def start(self, token: torch.Tensor, ids_buf: torch.Tensor, buf_len: Union[int, torch.Tensor],
              temperature: Scalar, top_p: Scalar) -> None:
        """Set a run's inputs: the (1, 1) token, the (1, L) id buffer and its
        valid length, and the sampling values; ``produced`` and ``iters``
        start at 0."""
        st = self.state
        width = min(ids_buf.shape[1], st.ids.shape[1])
        st.token.copy_(token)
        st.ids.zero_()
        st.ids[:, :width].copy_(ids_buf[:, :width])
        if isinstance(buf_len, torch.Tensor):
            st.buf_len.copy_(buf_len)
        else:
            st.buf_len.fill_(buf_len)
        st.produced.zero_()
        st.iters.zero_()
        if self.do_sample:
            for buf, x in ((st.temperature, temperature), (st.top_p, top_p)):
                if isinstance(x, torch.Tensor):
                    buf.copy_(x)
                else:
                    buf.fill_(x)

    def run(self, model: PaliGemma, cache: KVCache, n_steps: int,
            generator: Optional[torch.Generator] = None) -> None:
        """Iterations until at least ``n_steps`` tokens are produced, in
        groups of ``ceil((n_steps - produced) / k)`` with one read of
        ``produced`` after each; ``cache.host_length`` is exact after it."""
        st, k, h0 = self.state, self.k, cache.host_length
        caller = generator
        if self.graph is not None and self.do_sample:
            if caller is None:
                caller = torch.cuda.default_generators[cache.k.device.index or 0]
            st.generator.set_state(caller.get_state())
        elif self.graph is None:
            st.generator = generator
        produced = 0
        while produced < n_steps:
            r = -(-(n_steps - produced) // k)
            if h0 + produced + r * k > cache.max_len:  # an iteration writes k rows
                raise ValueError(f"cache full: {h0 + produced} + {r} x {k} > {cache.max_len}")
            for _ in range(r):
                if self.graph is None:
                    self._step(model, cache)
                else:
                    self._replay()
            produced = int(st.produced)  # the group's one host read
            cache.host_length = h0 + produced
        if self.graph is not None and self.do_sample:
            caller.set_state(st.generator.get_state())


def _spec_runner(model: PaliGemma, cache: KVCache, fns: KernelFns, k: int, n: int, drafter: str,
                 do_sample: bool) -> _SpecRunner:
    """The cache's verify-iteration runner for these settings, captured now
    if it has none that reads this model and these buffers."""
    key = ("spec", id(model), fns, k, n, drafter, do_sample)
    runner = cache.graphs.get(key)
    if runner is None or not runner.serves(model, cache):
        runner = cache.graphs[key] = _SpecRunner(model, cache, fns, k, n, drafter, do_sample)
    return runner


def _uses_prefill_a8(model: PaliGemma) -> bool:
    return any(getattr(m, "prefill_a8", False) for m in model.llm.modules())


@torch.no_grad()
def decode_steps_spec(
    model: PaliGemma,
    token: torch.Tensor,
    cache: KVCache,
    ids_buf: torch.Tensor,
    buf_len: Union[int, torch.Tensor],
    n_steps: int,
    fns: KernelFns = KERNELS,
    *,
    k: int = 8,
    n: int = 3,
    do_sample: bool = False,
    temperature: Scalar = 0.0,
    top_p: Scalar = 0.9,
    generator: Optional[torch.Generator] = None,
    drafter: str = "ngram",
):
    """Speculative decode of at least ``n_steps`` tokens (batch 1): drafts
    from ``drafter`` over ``ids_buf[:, :buf_len]`` and k-token verify steps.
    Greedy, the output is the plain greedy stream; sampled (``do_sample``
    and ``temperature`` > 0), each position draws from its own top-p
    distribution, which for these delta drafts is exact speculative
    sampling (the stream differs from plain sampling's only in how the
    generator's draws are used). On a CUDA cache each iteration is a replay
    of its captured graph.

    ``token`` (1, 1) is the last emitted token, already in ``ids_buf`` at
    ``buf_len - 1``; the cache holds the K/V up to the token before it.
    Returns (out_buf (1, n_steps + k), produced, iters, token, cache,
    ids_buf, buf_len), the counts 0-d int32 tensors; the first ``produced``
    columns of ``out_buf`` are valid. The cache and ``ids_buf`` need k
    positions of slack past the last token the caller will consume.
    """
    if _uses_prefill_a8(model) and k + 1 >= quantization.A8_MIN_SEQ:
        # A verify this deep would route its projections through the int8 x
        # int8 product while plain decode steps stay weight-only: the
        # stream would no longer be the plain one.
        raise ValueError(
            f"speculative verify depth k+1={k + 1} >= quantization.A8_MIN_SEQ="
            f"{quantization.A8_MIN_SEQ} with prefill_a8 on; lower k or disable prefill_a8")
    if token.shape != (1, 1):
        raise ValueError(f"decode_steps_spec is batch-1 (token {tuple(token.shape)})")
    runner = _spec_runner(model, cache, fns, k, n, drafter, do_sample)
    runner.start(token, ids_buf, buf_len, temperature, top_p)
    runner.run(model, cache, n_steps, generator)
    st = runner.state
    ids_out = ids_buf.clone()
    width = min(ids_buf.shape[1], st.ids.shape[1])
    ids_out[:, :width].copy_(st.ids[:, :width])
    return (st.out[:, : n_steps + k].clone(), st.produced.clone(), st.iters.clone(), st.token.clone(),
            cache, ids_out, st.buf_len.clone())


@torch.no_grad()
def generate_spec(
    model: PaliGemma,
    input_ids: torch.Tensor,
    pixel_values: torch.Tensor,
    max_new_tokens: int,
    eos_token_id: int,
    fns: KernelFns = KERNELS,
    cache_dtype: Optional[torch.dtype] = None,
    *,
    chunk: int = 64,
    k: int = 8,
    n: int = 3,
    do_sample: bool = False,
    temperature: float = 0.0,
    top_p: float = 0.9,
    generator: Optional[torch.Generator] = None,
    stats: Optional[dict] = None,
    drafter: str = "ngram",
) -> List[int]:
    """Batch-1 generation by speculative decoding (reference:
    ``generation.generate_spec``). Greedy output is ``generate_chunked``'s
    tokens; sampled output (``do_sample`` and ``temperature`` > 0) draws
    the plain sampling distribution. One ``decode_steps_spec`` chunk of at
    least ``chunk`` tokens and one host read of its result at a time; the
    stream is trimmed at ``max_new_tokens``, then at EOS.

    ``stats`` (optional dict) receives {"produced", "verify_steps",
    "tokens_per_verify"}.
    """
    b, t = input_ids.shape
    if b != 1:
        raise ValueError(f"generate_spec is batch-1 (got batch {b})")
    n_chunks = -(-max(max_new_tokens - 1, 1) // chunk)
    # A chunk produces chunk to chunk + k - 1 tokens, and the last verify
    # writes k positions past the accepted length: room for the worst case.
    alloc = n_chunks * (chunk + k) + k
    cache = _pooled_cache(model, b, t, alloc, cache_dtype)
    tok, cache = _first_token(model, input_ids, pixel_values, cache, fns, generator, do_sample,
                              temperature, top_p)
    out = [int(tok[0])]
    if out[-1] == eos_token_id or max_new_tokens == 1:
        return out[:max_new_tokens]
    L = t + alloc
    ids_buf = torch.zeros((1, L), dtype=torch.int32, device=input_ids.device)
    ids_buf[:, :t] = input_ids
    ids_buf[0, t] = tok[0]
    buf_len = torch.tensor(t + 1, dtype=torch.int32, device=input_ids.device)
    token = tok[:, None].to(torch.int32)
    produced_total = verify_total = 0
    while len(out) < max_new_tokens:
        out_buf, produced, iters, token, cache, ids_buf, buf_len = decode_steps_spec(
            model, token, cache, ids_buf, buf_len, chunk, fns, k=k, n=n, do_sample=do_sample,
            temperature=temperature, top_p=top_p, generator=generator, drafter=drafter)
        packed = torch.cat([produced[None], iters[None], buf_len[None], out_buf[0]]).tolist()  # one read
        n_prod, n_iter, blen = packed[:3]
        if n_prod > chunk + k - 1 or blen + k > L:
            raise AssertionError(f"speculative buffer headroom exhausted (produced {n_prod}, "
                                 f"buf_len {blen}, L {L})")
        produced_total += n_prod
        verify_total += n_iter
        new = packed[3 : 3 + n_prod][: max_new_tokens - len(out)]
        if eos_token_id in new:
            out.extend(new[: new.index(eos_token_id) + 1])
            break
        out.extend(new)
    if stats is not None:
        stats.update(produced=produced_total, verify_steps=verify_total,
                     tokens_per_verify=round(produced_total / max(verify_total, 1), 3))
    return out

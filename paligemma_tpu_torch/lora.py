"""LoRA finetuning of the Gemma decoder's q/k/v projections (port of
``paligemma_tpu/lora.py``).

- ``LoraConfig``: r 8, alpha 16, dropout 0.1, targets q, k, v; the update
  is scaled by ``alpha / r``.
- Adapters are a dict of tensors in the reference's layout,
  ``{"layers": {"q"|"k"|"v": {"a": (L, D, r), "b": (L, r, out)}}}``, separate
  from the frozen base model; ``models/gemma.py`` applies them
  (``lora_delta``), and ``merge_lora`` folds them into the base weights.
- The train step (``train_step``) is ``paligemma.loss_fn`` through the
  adapters, ``torch.autograd.grad`` for the adapters only, and one call of
  ``AdapterOptimizer``: the reference's ``optax.MultiSteps(chain(
  clip_by_global_norm, adamw))`` (accumulation over k micro-steps, one
  clipped AdamW step every k-th call). None of it reads the device, so
  ``make_train_step`` returns it compiled, as the reference returns
  ``jax.jit(step)``: on the card each micro-step is the replay of a CUDA
  graph (one per batch shape and flavour: accumulate, or accumulate and
  apply), on the CPU the eager function. ``make_eval_loss`` is the
  finetune CLI's eval loss the same way (one graph per batch shape).
- Checkpoints: ``save_checkpoint_robust`` writes the adapter as
  safetensors (the port's own writer, ``utils/checkpoint.save_file``) with
  ``adapter_config.json``, else npz, else a pickle of numpy arrays, and
  ``checkpoint_info.json``; the files are the reference's, so each package
  reads the other's adapters (``load_adapter`` reads every tier).
  ``save_train_state`` / ``load_train_state`` keep the adapter, the
  optimizer state, the step and the generators' states (``torch.save``),
  so a resumed run gives the adapter of an uninterrupted one.
- Dropout masks are drawn from a ``torch.Generator``, one a layer and
  target in order, where the reference folds its keys.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import pickle
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from paligemma_tpu_torch import generation
from paligemma_tpu_torch.config import PaliGemmaConfig
from paligemma_tpu_torch.models import paligemma
from paligemma_tpu_torch.models.gemma import LORA_TARGETS
from paligemma_tpu_torch.models.paligemma import PaliGemma
from paligemma_tpu_torch.ops.kernels import KERNELS
from paligemma_tpu_torch.utils import checkpoint

Adapter = Dict[str, Any]

ADAPTER_FILES = ("adapter_model.safetensors", "adapter_model.npz", "adapter_model.pkl")
TRAIN_STATE_FILE = "train_state.pt"


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    """The reference finetune's peft ``LoraConfig``."""

    r: int = 8
    alpha: float = 16
    dropout: float = 0.1
    target_modules: Tuple[str, ...] = LORA_TARGETS

    @property
    def scale(self) -> float:
        return self.alpha / self.r


def out_dims(cfg: PaliGemmaConfig) -> Dict[str, int]:
    """Output width of each adapted projection."""
    tc = cfg.text_config
    kv = tc.num_key_value_heads * tc.head_dim
    return {"q": tc.num_attention_heads * tc.head_dim, "k": kv, "v": kv}


def init_lora(cfg: PaliGemmaConfig, lcfg: LoraConfig, generator: torch.Generator, device="cuda",
              dtype: torch.dtype = torch.float32) -> Adapter:
    """A ~ N(0, 1) / r, B = 0 (the initial delta is zero, as peft's init);
    a module that is not targeted gets a zero rank-1 placeholder. A is drawn
    from ``generator`` (on ``device``), q, k, v in turn."""
    tc = cfg.text_config
    l, d = tc.num_hidden_layers, tc.hidden_size
    layers = {}
    for name, out in out_dims(cfg).items():
        if name in lcfg.target_modules:
            a = torch.randn((l, d, lcfg.r), generator=generator, device=device, dtype=torch.float32)
            layers[name] = {"a": (a * (1.0 / lcfg.r)).to(dtype),
                            "b": torch.zeros((l, lcfg.r, out), dtype=dtype, device=device)}
        else:
            layers[name] = {"a": torch.zeros((l, d, 1), dtype=dtype, device=device),
                            "b": torch.zeros((l, 1, out), dtype=dtype, device=device)}
    return {"layers": layers}


def adapter_leaves(lora: Adapter) -> List[torch.Tensor]:
    """The adapter's tensors in one fixed order (by flattened name)."""
    flat = _flatten(lora)
    return [flat[k] for k in sorted(flat)]


def merge_lora(model: PaliGemma, lora: Adapter, lcfg: LoraConfig) -> PaliGemma:
    """A copy of ``model`` whose fused qkv weights hold ``W + scale * A @ B``
    (fp32 sum, rounded to the weight's dtype); it shares every other tensor
    with ``model``. Raises ``TypeError`` on a quantized base: merge into the
    float model, then ``quantize_params`` the result."""
    layers = lora.get("layers", lora)
    shared = {id(t): t for t in model.state_dict(keep_vars=True).values()}
    out = copy.deepcopy(model, memo=shared)
    for li, layer in enumerate(out.llm.layers):
        base = layer.qkv
        if type(base) is not nn.Linear:
            raise TypeError("merge_lora requires unquantized base kernels; merge into the bf16/fp32 "
                            "model first, then quantize_params() the result")
        merged = base.weight.detach().to(torch.float32, copy=True)
        offset = 0
        for name in LORA_TARGETS:
            a, b = layers[name]["a"][li].float(), layers[name]["b"][li].float()
            delta = (a @ b) * lcfg.scale  # (D, out)
            merged[offset: offset + b.shape[-1]] += delta.t().to(merged.device)
            offset += b.shape[-1]
        if offset != merged.shape[0]:
            raise ValueError(f"merge_lora: adapter widths sum to {offset}, qkv has {merged.shape[0]}")
        new = nn.Linear(base.in_features, base.out_features, bias=False, device="meta")
        new.weight = nn.Parameter(merged.to(base.weight.dtype), requires_grad=False)
        layer.qkv = new
    return out


# ---------------------------------------------------------------------------
# Optimizer and train step
# ---------------------------------------------------------------------------


class AdapterOptimizer:
    """The reference's ``default_optimizer``: ``optax.MultiSteps(chain(
    clip_by_global_norm(max_grad_norm), adamw(lr, weight_decay=wd)),
    every_k_schedule=accum_steps)``, on a list of tensors, in place.

    Each call folds the micro-step's gradients into their running mean,
    ``acc += (g - acc) / (n + 1)``; every ``accum_steps``-th call clips the
    mean's global norm, takes one AdamW step (b1 0.9, b2 0.999, eps 1e-8,
    bias-corrected moments, decoupled weight decay) and zeroes the mean; the
    other calls leave the tensors as they are. The state is a dict of
    tensors and host ints (``torch.save`` keeps it).

    A call reads nothing back from the device, so a CUDA graph can capture
    it (``make_train_step``):

    - the clip is a select, ``where(norm < max_norm, g, g / norm *
      max_norm)`` (no epsilon): the bits of either branch, with no branch
      on the norm;
    - the numbers that change from call to call, the divisor ``n + 1`` and
      the bias corrections ``1 - b1**count`` and ``1 - b2**count``, are read
      from a (3,) fp32 device buffer (``scalars``) that ``set_scalars``
      fills from the host before the device work (``apply``). A graph
      captures ``apply`` only, and each replay is preceded by
      ``set_scalars``. Each is a division by the fp32 tensor, never a
      product with a reciprocal;
    - whether a call takes the AdamW step is decided on the host, from the
      state's ``mini_step``.
    """

    def __init__(self, lr: float = 1e-4, accum_steps: int = 16, max_grad_norm: float = 1.0,
                 weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.lr, self.k, self.max_norm, self.wd = lr, accum_steps, max_grad_norm, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self._scalars: Dict[torch.device, torch.Tensor] = {}

    def init(self, lora: Adapter) -> dict:
        leaves = adapter_leaves(lora)
        zeros = lambda: [torch.zeros_like(p) for p in leaves]  # noqa: E731
        return {"mini_step": 0, "count": 0, "acc": zeros(), "mu": zeros(), "nu": zeros()}

    def applies(self, state: dict) -> bool:
        """Whether the next call on ``state`` takes the AdamW step."""
        return state["mini_step"] + 1 >= self.k

    def scalars(self, device) -> torch.Tensor:
        """The (3,) fp32 buffer on ``device`` that ``apply`` reads: ``n +
        1``, ``1 - b1**count``, ``1 - b2**count``."""
        dev = torch.device(device)
        if dev not in self._scalars:
            self._scalars[dev] = torch.zeros(3, dtype=torch.float32, device=dev)
        return self._scalars[dev]

    def set_scalars(self, state: dict, device) -> None:
        """Fill ``scalars(device)`` for the next call on ``state``, each value
        the fp32 rounding of its Python number."""
        n, count = state["mini_step"], state["count"] + 1
        buf = self.scalars(device)
        for i, x in enumerate((n + 1, 1.0 - self.b1**count, 1.0 - self.b2**count)):
            buf[i].fill_(x)

    def advance(self, state: dict) -> dict:
        """The state after one call (its tensors change in place)."""
        if self.applies(state):
            return {**state, "mini_step": 0, "count": state["count"] + 1}
        return {**state, "mini_step": state["mini_step"] + 1}

    @torch.no_grad()
    def apply(self, grads: Sequence[torch.Tensor], state: dict, lora: Adapter) -> None:
        """The device work of one call, on the numbers ``set_scalars``
        wrote: fold ``grads`` (in ``adapter_leaves`` order) into the mean
        and, on the k-th call, clip, step the adapter and zero the mean."""
        n1, c1, c2 = self.scalars(state["acc"][0].device)
        for acc, g in zip(state["acc"], grads):
            acc.add_((g - acc) / n1)
        if not self.applies(state):
            return
        acc = state["acc"]
        norm = torch.sqrt(self.sq_norm(acc))
        keep = norm < self.max_norm
        for p, g, mu, nu in zip(adapter_leaves(lora), acc, state["mu"], state["nu"]):
            g = torch.where(keep, g, (g / norm) * self.max_norm)
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * (g * g))
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.wd:
                u = u + self.wd * p
            p.add_(-self.lr * u)
        for g in acc:
            g.zero_()

    def sq_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The clip's squared global norm of ``grads`` (``adapter_leaves``
        order), a 0-d device tensor (a sharded optimizer sums the squares
        of its shards over the model group, ``parallel/steps.py``)."""
        return sum((g * g).sum() for g in grads)

    def update(self, grads: Sequence[torch.Tensor], state: dict, lora: Adapter) -> dict:
        """One call, eagerly: ``set_scalars``, then ``apply``; returns the
        state after it."""
        self.set_scalars(state, state["acc"][0].device)
        self.apply(grads, state, lora)
        return self.advance(state)


def default_optimizer(lr: float = 1e-4, accum_steps: int = 16, max_grad_norm: float = 1.0,
                      weight_decay: float = 0.0) -> AdapterOptimizer:
    """Clip by global norm, then AdamW, accumulated over ``accum_steps``."""
    return AdapterOptimizer(lr, accum_steps, max_grad_norm, weight_decay)


def _step_on_device(model: PaliGemma, lora: Adapter, opt_state: dict, batch: dict,
                    generator: Optional[torch.Generator], lcfg: LoraConfig, optimizer: AdapterOptimizer,
                    train: bool) -> torch.Tensor:
    """What a graph of the step captures: the loss through the adapters,
    its gradient for the adapters only, ``optimizer.apply``. Returns the
    detached loss."""
    live = _map(lambda t: t.detach().requires_grad_(), lora)  # shares lora's storage
    use_dropout = train and lcfg.dropout > 0
    loss = paligemma.loss_fn(
        model, batch["input_ids"], batch["pixel_values"], batch["labels"],
        valid_len=batch.get("valid_len"), lora=live, lora_scale=lcfg.scale,
        lora_dropout=lcfg.dropout if train else 0.0,
        lora_generator=generator if use_dropout else None)
    grads = torch.autograd.grad(loss, adapter_leaves(live))
    optimizer.apply(grads, opt_state, lora)
    return loss.detach()


def train_step(model: PaliGemma, lora: Adapter, opt_state: dict, batch: dict,
               generator: Optional[torch.Generator], lcfg: LoraConfig, optimizer: AdapterOptimizer,
               train: bool = True):
    """One micro-step, eagerly: (loss, lora, opt_state). The shifted
    cross-entropy through the adapters (dropout from ``generator`` when
    ``train`` and ``lcfg.dropout`` > 0), its gradient for the adapters
    only, one optimizer call (the adapter and the state's tensors change in
    place). ``batch``: tensors on the model's device, ``input_ids``,
    ``pixel_values``, ``labels`` and optionally ``valid_len``."""
    optimizer.set_scalars(opt_state, batch["input_ids"].device)
    loss = _step_on_device(model, lora, opt_state, batch, generator, lcfg, optimizer, train)
    return loss, lora, optimizer.advance(opt_state)


_BATCH_KEYS = ("input_ids", "pixel_values", "labels", "valid_len")


def _batch_key(batch: dict) -> tuple:
    return tuple((k, tuple(batch[k].shape), batch[k].dtype) for k in _BATCH_KEYS if k in batch)


def _ptrs(tensors) -> tuple:
    return tuple(t.data_ptr() for t in tensors)


def _state_tensors(opt_state: dict) -> List[torch.Tensor]:
    return [t for k in ("acc", "mu", "nu") for t in opt_state[k]]


class _Inputs:
    """Static copies of one batch shape's tensors, which every graph of
    that shape reads."""

    def __init__(self, batch: dict):
        self.batch = {k: batch[k].clone(memory_format=torch.contiguous_format)
                      for k in _BATCH_KEYS if k in batch}

    def fill(self, batch: dict) -> dict:
        for k, t in self.batch.items():
            t.copy_(batch[k])
        return self.batch


class _StepGraph(generation._Captured):
    """One flavour of the micro-step for one batch shape, captured on the
    adapter's and the optimizer state's tensors, the shape's static inputs
    and the dropout generator (None: no dropout).

    The capture's warm-up is a whole micro-step on a side stream (PyTorch's
    rule for a capture with a backward). The adapter, the state's tensors
    and the generator are put back after it, so every answer is a replay
    and a capture that fails leaves them as they were."""

    def __init__(self, model: PaliGemma, lora: Adapter, opt_state: dict,
                 generator: Optional[torch.Generator]):
        super().__init__(model, None, KERNELS)
        self.tensors = adapter_leaves(lora) + _state_tensors(opt_state)
        self.ptrs, self.generator = _ptrs(self.tensors), generator
        self.loss, self.mib = None, 0.0

    def serves(self, model: PaliGemma, lora: Adapter, opt_state: dict,
               generator: Optional[torch.Generator]) -> bool:
        return (self.model_ref() is model and self.generator is generator
                and self.ptrs == _ptrs(adapter_leaves(lora) + _state_tensors(opt_state)))

    def capture(self, run: Callable[[], torch.Tensor], dev: torch.device, pool) -> None:
        saved = [t.clone() for t in self.tensors]
        gen_state = None if self.generator is None else self.generator.get_state()

        def restore():
            for t, s in zip(self.tensors, saved):
                t.copy_(s)
            if gen_state is not None:
                self.generator.set_state(gen_state)

        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()  # as the capture does on entry
        before = torch.cuda.memory_reserved(dev)
        _, self.loss = self._capture(dev, run, restore, self.generator, pool=pool)
        torch.cuda.synchronize(dev)
        self.mib = (torch.cuda.memory_reserved(dev) - before) / 2**20


class TrainStep:
    """``make_train_step``'s result, the counterpart of the reference's
    ``jax.jit(step)``: ``step(model, lora, opt_state, batch, generator) ->
    (loss, lora, opt_state)``, ``train_step``'s arithmetic.

    - On a CPU batch it is ``train_step``, run eagerly; so on a CUDA
      batch with a model sharded over gloo (``generation.graphs_on``).
    - On a CUDA batch it replays a CUDA graph: one per (batch shapes and
      dtypes, flavour), the flavours being the micro-step that only
      accumulates and the one that also takes the AdamW step (the host
      picks one from ``opt_state["mini_step"]``). A graph is captured at
      the first call of its key and replayed by every later call with the
      same model, adapter and state tensors and generator (others capture
      anew). Every graph of the step shares one memory pool; ``log`` holds
      each capture's key, host ms and the MiB the reserved memory grew by.
    - Before a replay the batch is copied into the shape's static inputs
      and ``optimizer.set_scalars`` fills the optimizer's numbers. The
      adapter and the state's tensors change in place, and the dropout
      generator, registered with the graph, advances as the eager step
      advances it, so a replay gives the eager step's bits.
    - The loss is the graph's 0-d output, overwritten by the next call:
      read it before then. Nothing else is read back.
    - A capture or a replay that raises propagates; nothing falls back to
      the eager step.
    """

    def __init__(self, lcfg: LoraConfig, optimizer: AdapterOptimizer, train: bool = True,
                 on_device: Optional[Callable[..., torch.Tensor]] = None):
        self.lcfg, self.optimizer, self.train = lcfg, optimizer, train
        # What a micro-step runs on the device (``_step_on_device``'s
        # arguments and result; the sharded step's, parallel/steps.py).
        self.on_device = on_device or _step_on_device
        self.graphs: Dict[tuple, _StepGraph] = {}
        self.inputs: Dict[tuple, _Inputs] = {}
        self.pool = None
        self.log: List[dict] = []

    def __call__(self, model: PaliGemma, lora: Adapter, opt_state: dict, batch: dict,
                 generator: Optional[torch.Generator] = None):
        dev = batch["input_ids"].device
        if not generation.graphs_on(model, dev):
            self.optimizer.set_scalars(opt_state, dev)
            loss = self.on_device(model, lora, opt_state, batch, generator, self.lcfg, self.optimizer, self.train)
            return loss, lora, self.optimizer.advance(opt_state)
        gen = generator if self.train and self.lcfg.dropout > 0 else None
        bkey = _batch_key(batch)
        key = (bkey, self.optimizer.applies(opt_state))
        if bkey not in self.inputs:
            self.inputs[bkey] = _Inputs(batch)
        static = self.inputs[bkey].fill(batch)
        self.optimizer.set_scalars(opt_state, dev)
        graph = self.graphs.get(key)
        if graph is None or not graph.serves(model, lora, opt_state, gen):
            self.graphs.pop(key, None)
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            graph = _StepGraph(model, lora, opt_state, gen)
            graph.capture(lambda: self.on_device(model, lora, opt_state, static, gen, self.lcfg,
                                                 self.optimizer, self.train), dev, self.pool)
            self.graphs[key] = graph
            self.log.append({"key": key, "ms": graph.capture_ms, "mib": graph.mib})
        graph._replay()
        return graph.loss, lora, self.optimizer.advance(opt_state)


def make_train_step(lcfg: LoraConfig, optimizer: AdapterOptimizer, train: bool = True) -> TrainStep:
    """The train step, ``step(model, lora, opt_state, batch, generator) ->
    (loss, lora, opt_state)`` (``TrainStep``): eager on the CPU, CUDA
    graphs on the card."""
    return TrainStep(lcfg, optimizer, train)


def eval_loss(model: PaliGemma, lora: Optional[Adapter], batch: dict, scale: float) -> torch.Tensor:
    """The eval loss, eagerly: ``loss_fn`` under ``no_grad`` through the
    adapter (None: the base model) scaled by ``scale``, no dropout; a 0-d
    fp32 tensor."""
    with torch.no_grad():
        return paligemma.loss_fn(model, batch["input_ids"], batch["pixel_values"], batch["labels"],
                                 valid_len=batch.get("valid_len"), lora=lora, lora_scale=scale)


class _EvalGraph(generation._Captured):
    """``eval_loss`` for one batch shape, on one adapter's tensors."""

    def __init__(self, model: PaliGemma, lora: Optional[Adapter]):
        super().__init__(model, None, KERNELS)
        self.ptrs = None if lora is None else _ptrs(adapter_leaves(lora))
        self.loss = None

    def serves(self, model: PaliGemma, lora: Optional[Adapter]) -> bool:
        return self.model_ref() is model and self.ptrs == (None if lora is None else _ptrs(adapter_leaves(lora)))


class EvalLoss:
    """``make_eval_loss``'s result, the counterpart of the reference CLI's
    jitted ``eval_loss``: ``fn(model, lora, batch) -> 0-d loss``,
    ``eval_loss``'s arithmetic. Eager on a CPU batch. On a CUDA batch, one
    CUDA graph per batch shape (and model and adapter tensors), all in one
    memory pool: the first call of a shape is the eager loss (the capture's
    warm-up, that call's answer); every later one copies the batch into the
    shape's static inputs and replays. A replay's loss is the graph's
    output, overwritten by the next call."""

    def __init__(self, scale: float):
        self.scale = scale
        self.graphs: Dict[tuple, _EvalGraph] = {}
        self.inputs: Dict[tuple, _Inputs] = {}
        self.pool = None

    def __call__(self, model: PaliGemma, lora: Optional[Adapter], batch: dict) -> torch.Tensor:
        dev = batch["input_ids"].device
        if dev.type != "cuda":
            return eval_loss(model, lora, batch, self.scale)
        key = _batch_key(batch)
        if key not in self.inputs:
            self.inputs[key] = _Inputs(batch)
        static = self.inputs[key].fill(batch)
        graph = self.graphs.get(key)
        if graph is None or not graph.serves(model, lora):
            self.graphs.pop(key, None)
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            graph = _EvalGraph(model, lora)
            warm, graph.loss = graph._capture(dev, lambda: eval_loss(model, lora, static, self.scale),
                                              count_warm_up=True, pool=self.pool)
            self.graphs[key] = graph
            return warm
        graph._replay()
        return graph.loss


def make_eval_loss(scale: float) -> EvalLoss:
    """The eval loss through an adapter scaled by ``scale`` (``EvalLoss``):
    eager on the CPU, a CUDA graph per batch shape on the card."""
    return EvalLoss(scale)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _flatten(tree: dict, prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for k, v in tree.items():
        kk = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(_flatten(v, kk))
        else:
            flat[kk] = v
    return flat


def _unflatten(flat: Dict[str, Any]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *parents, leaf = key.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _numpy(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def save_checkpoint_robust(lora: Adapter, lcfg: LoraConfig, output_dir: str, step: int,
                           extra_info: Optional[dict] = None) -> str:
    """Save the adapter (fp32) with the reference's three tiers and a
    ``checkpoint_info.json`` record; returns the tier written.

    1. ``adapter_model.safetensors`` + ``adapter_config.json``;
    2. ``adapter_model.npz``;
    3. ``adapter_model.pkl``, a pickle of the nested dict of numpy arrays.
    """
    os.makedirs(output_dir, exist_ok=True)
    info = {"step": step, "time": time.time(), "errors": []}
    if extra_info:
        info.update(extra_info)
    flat = {k: _numpy(v) for k, v in _flatten(lora).items()}
    try:
        checkpoint.save_file({k: torch.from_numpy(v) for k, v in flat.items()},
                             os.path.join(output_dir, "adapter_model.safetensors"))
        with open(os.path.join(output_dir, "adapter_config.json"), "w") as f:
            json.dump({"r": lcfg.r, "lora_alpha": lcfg.alpha, "lora_dropout": lcfg.dropout, "bias": "none",
                       "target_modules": [f"{m}_proj" for m in lcfg.target_modules],
                       "task_type": "CAUSAL_LM"}, f, indent=2)
        saved = "safetensors"
    except Exception as e:  # the next tier
        info["errors"].append(f"safetensors: {e!r}")
        try:
            np.savez(os.path.join(output_dir, "adapter_model.npz"), **flat)
            saved = "npz"
        except Exception as e2:
            info["errors"].append(f"npz: {e2!r}")
            with open(os.path.join(output_dir, "adapter_model.pkl"), "wb") as f:
                pickle.dump(_unflatten(flat), f)
            saved = "pickle"
    info["format"] = saved
    with open(os.path.join(output_dir, "checkpoint_info.json"), "w") as f:
        json.dump(info, f, indent=2)
    return saved


def load_adapter(output_dir: str, dtype: torch.dtype = torch.float32, device="cuda") -> Adapter:
    """An adapter saved by either package's ``save_checkpoint_robust``
    (safetensors, else npz, else pickle), as tensors on ``device``."""
    st, npz, pkl = (os.path.join(output_dir, f) for f in ADAPTER_FILES)
    if os.path.exists(st):
        flat = checkpoint.load_file(st)
    elif os.path.exists(npz):
        with np.load(npz) as z:
            flat = {k: torch.from_numpy(z[k]) for k in z.files}
    elif os.path.exists(pkl):
        with open(pkl, "rb") as f:  # written by save_checkpoint_robust
            flat = {k: torch.from_numpy(np.asarray(v)) for k, v in _flatten(pickle.load(f)).items()}
    else:
        raise FileNotFoundError(f"no adapter found in {output_dir}")
    return _unflatten({k: v.to(device, dtype) for k, v in flat.items()})


def saved_rank_alpha(output_dir: str, rank: int, default_alpha: Optional[float] = None) -> Tuple[int, float]:
    """(rank, alpha) of a saved adapter: ``adapter_config.json``'s ``r`` and
    ``lora_alpha`` when the file is there, else ``rank`` and
    ``default_alpha`` (``rank`` when None)."""
    alpha = float(rank if default_alpha is None else default_alpha)
    path = os.path.join(output_dir, "adapter_config.json")
    if os.path.exists(path):
        with open(path) as f:
            acfg = json.load(f)
        rank = int(acfg.get("r", rank))
        alpha = float(acfg.get("lora_alpha", alpha))
    return rank, alpha


def save_train_state(output_dir: str, step: int, adapter: Adapter, opt_state: dict,
                     generators: Optional[Dict[str, torch.Generator]] = None) -> None:
    """The whole training state (adapter, optimizer state, step and the
    generators' states) as ``train_state.pt`` for an exact resume."""
    os.makedirs(output_dir, exist_ok=True)
    cpu = lambda x: x.detach().cpu() if isinstance(x, torch.Tensor) else x  # noqa: E731
    state = {"adapter": _map(cpu, adapter),
             "opt_state": {k: [cpu(t) for t in v] if isinstance(v, list) else v for k, v in opt_state.items()},
             "step": int(step),
             "generators": {k: g.get_state() for k, g in (generators or {}).items()}}
    torch.save(state, os.path.join(output_dir, TRAIN_STATE_FILE))


def load_train_state(output_dir: str, device="cuda"):
    """(adapter, opt_state, step, generator states) saved by ``save_train_state``."""
    state = torch.load(os.path.join(output_dir, TRAIN_STATE_FILE), map_location="cpu", weights_only=True)
    dev = lambda x: x.to(device) if isinstance(x, torch.Tensor) else x  # noqa: E731
    opt = {k: [dev(t) for t in v] if isinstance(v, list) else v for k, v in state["opt_state"].items()}
    return _map(dev, state["adapter"]), opt, state["step"], state["generators"]


# ---------------------------------------------------------------------------
# The training loop
# ---------------------------------------------------------------------------


def batch_to(batch: dict, device) -> dict:
    """numpy or tensor batch values as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v).to(device)
            for k, v in batch.items()}


def train(
    model: PaliGemma,
    batches: Union[Iterable[dict], Callable[[int], Iterable[dict]]],
    lcfg: Optional[LoraConfig] = None,
    lr: float = 1e-4,
    accum_steps: int = 16,
    epochs: int = 1,
    save_every_n_steps: int = 50,
    output_dir: str = "paligemma_lora",
    seed: int = 0,
    log_every: int = 10,
    logger=print,
    resume: bool = False,
    save_train_state_too: bool = False,
) -> Tuple[Adapter, list]:
    """The LoRA training loop on the model's device (the reference's
    ``train``). ``batches``: a callable ``epoch -> iterable`` (a fresh
    iterator an epoch), a list, or a one-shot generator of
    ``{"input_ids", "pixel_values", "labels"[, "valid_len"]}`` numpy or
    tensor batches. Each micro-step is ``make_train_step``'s: on the card a
    CUDA graph replay. A step that raises (its capture included) is
    skipped after emptying the CUDA cache; three failures in a row
    re-raise. ``resume`` restores the adapter, optimizer, step and
    generators from ``output_dir``'s ``train_state.pt`` (when there is
    one) before the first step, so the graphs are captured on the restored
    tensors, and skips the steps already trained; saves read those tensors.
    Returns (the adapter, the per-step losses)."""
    lcfg = lcfg or LoraConfig()
    dev = model.llm.final_norm.weight.device
    lora = init_lora(model.cfg, lcfg, torch.Generator(device=dev).manual_seed(seed), dev)
    optimizer = default_optimizer(lr=lr, accum_steps=accum_steps)
    opt_state = optimizer.init(lora)
    step_fn = make_train_step(lcfg, optimizer)
    dropout_gen = torch.Generator(device=dev).manual_seed(seed + 1)

    losses: list = []
    step = start_step = 0
    failures = 0
    if resume and os.path.exists(os.path.join(output_dir, TRAIN_STATE_FILE)):
        lora, opt_state, start_step, gens = load_train_state(output_dir, dev)
        if "dropout" in gens:
            dropout_gen.set_state(gens["dropout"])
        logger(f"resumed from step {start_step}")

    def save(extra=None):
        save_checkpoint_robust(lora, lcfg, output_dir, step, extra)
        if save_train_state_too:
            save_train_state(output_dir, step, lora, opt_state, {"dropout": dropout_gen})

    for epoch in range(epochs):
        for batch in batches(epoch) if callable(batches) else batches:
            if step < start_step:  # resume: replay the schedule without work
                step += 1
                continue
            try:
                loss, lora, opt_state = step_fn(model, lora, opt_state, batch_to(batch, dev), dropout_gen)
            except Exception as e:  # the reference's OOM recovery
                failures += 1
                logger(f"step {step}: error {e!r}; clearing caches and skipping")
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
                if failures >= 3:
                    raise  # persistent failures are not transient: surface them
                continue
            failures = 0
            losses.append(float(loss))
            step += 1
            if log_every and step % log_every == 0:
                logger(f"epoch {epoch} step {step}: loss {losses[-1]:.4f}")
            if save_every_n_steps and step % save_every_n_steps == 0:
                save()
    save({"final": True})
    return lora, losses


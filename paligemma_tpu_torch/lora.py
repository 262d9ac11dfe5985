"""LoRA finetuning of the Gemma decoder's q/k/v projections (port of
``paligemma_tpu/lora.py``).

- ``LoraConfig``: r 8, alpha 16, dropout 0.1, targets q, k, v; the update
  is scaled by ``alpha / r``.
- Adapters are a dict of tensors in the reference's layout,
  ``{"layers": {"q"|"k"|"v": {"a": (L, D, r), "b": (L, r, out)}}}``, separate
  from the frozen base model; ``models/gemma.py`` applies them
  (``lora_delta``), and ``merge_lora`` folds them into the base weights.
- The train step (``make_train_step``) is ``paligemma.loss_fn`` through the
  adapters, ``torch.autograd.grad`` for the adapters only, and one call of
  ``AdapterOptimizer``: the reference's ``optax.MultiSteps(chain(
  clip_by_global_norm, adamw))`` (accumulation over k micro-steps, one
  clipped AdamW step every k-th call).
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

from paligemma_tpu_torch.config import PaliGemmaConfig
from paligemma_tpu_torch.models import paligemma
from paligemma_tpu_torch.models.gemma import LORA_TARGETS
from paligemma_tpu_torch.models.paligemma import PaliGemma
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

    Each call folds the micro-step's gradients into their running mean;
    every ``accum_steps``-th call clips the mean's global norm (``g / norm *
    max_norm`` when ``norm >= max_norm``, no epsilon), takes one AdamW step
    (b1 0.9, b2 0.999, eps 1e-8, bias-corrected moments, decoupled weight
    decay) and zeroes the mean; the other calls leave the tensors as they
    are. The state is a dict of tensors and ints (``torch.save`` keeps it).
    """

    def __init__(self, lr: float = 1e-4, accum_steps: int = 16, max_grad_norm: float = 1.0,
                 weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.lr, self.k, self.max_norm, self.wd = lr, accum_steps, max_grad_norm, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, lora: Adapter) -> dict:
        leaves = adapter_leaves(lora)
        zeros = lambda: [torch.zeros_like(p) for p in leaves]  # noqa: E731
        return {"mini_step": 0, "count": 0, "acc": zeros(), "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: dict, lora: Adapter) -> dict:
        """One micro-step: ``grads`` in ``adapter_leaves`` order; updates
        the adapter in place on every k-th call; returns the state."""
        n = state["mini_step"]
        for acc, g in zip(state["acc"], grads):
            acc.add_((g - acc) / (n + 1))
        if n + 1 < self.k:
            return {**state, "mini_step": n + 1}
        acc = state["acc"]
        norm = torch.sqrt(sum((g * g).sum() for g in acc))
        clip = not bool(norm < self.max_norm)
        count = state["count"] + 1
        c1, c2 = 1.0 - self.b1**count, 1.0 - self.b2**count
        for p, g, mu, nu in zip(adapter_leaves(lora), acc, state["mu"], state["nu"]):
            if clip:
                g = (g / norm) * self.max_norm
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * (g * g))
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.wd:
                u = u + self.wd * p
            p.add_(-self.lr * u)
        for g in acc:
            g.zero_()
        return {**state, "mini_step": 0, "count": count}


def default_optimizer(lr: float = 1e-4, accum_steps: int = 16, max_grad_norm: float = 1.0,
                      weight_decay: float = 0.0) -> AdapterOptimizer:
    """Clip by global norm, then AdamW, accumulated over ``accum_steps``."""
    return AdapterOptimizer(lr, accum_steps, max_grad_norm, weight_decay)


def make_train_step(lcfg: LoraConfig, optimizer: AdapterOptimizer, train: bool = True) -> Callable:
    """``step(model, lora, opt_state, batch, generator) -> (loss, lora,
    opt_state)``: the shifted cross-entropy through the adapters (dropout
    from ``generator`` when ``train`` and ``lcfg.dropout`` > 0), its
    gradient for the adapters only, one optimizer call (the adapter changes
    in place). ``batch``: tensors on the model's device, ``input_ids``,
    ``pixel_values``, ``labels`` and optionally ``valid_len``."""

    def step(model: PaliGemma, lora: Adapter, opt_state: dict, batch: dict,
             generator: Optional[torch.Generator] = None):
        live = _map(lambda t: t.detach().requires_grad_(), lora)  # shares lora's storage
        use_dropout = train and lcfg.dropout > 0
        loss = paligemma.loss_fn(
            model, batch["input_ids"], batch["pixel_values"], batch["labels"],
            valid_len=batch.get("valid_len"), lora=live, lora_scale=lcfg.scale,
            lora_dropout=lcfg.dropout if train else 0.0,
            lora_generator=generator if use_dropout else None)
        grads = torch.autograd.grad(loss, adapter_leaves(live))
        opt_state = optimizer.update(grads, opt_state, lora)
        return loss.detach(), lora, opt_state

    return step


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
    tensor batches. A step that raises is skipped after emptying the CUDA
    cache; three failures in a row re-raise. ``resume`` restores the
    adapter, optimizer, step and generators from ``output_dir``'s
    ``train_state.pt`` (when there is one) and skips the steps already
    trained. Returns (the adapter, the per-step losses)."""
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


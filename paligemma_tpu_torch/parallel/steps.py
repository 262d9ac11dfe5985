"""The sharded steps: prefill, decode and the DP x TP LoRA train step (port
of ``paligemma_tpu/parallel/steps.py``).

The reference jits the single-chip program with shardings on its inputs
and outputs, and GSPMD partitions it. Here every rank runs the single-chip
model functions on its own model (``sharding.shard_params``), its rows
(``sharding.shard_batch``) and its cache (``sharding.shard_cache``), and the
modules' collectives make the logits the same on every rank of a model
group. A step returns this data rank's rows, replicated over the model
group.

CUDA graphs: a sharded step is captured as a CUDA graph only where its
groups' backend is NCCL, whose collectives a graph can capture; over gloo
(whose collectives run on the host) it runs eagerly
(``generation.graphs_on``). A capture that fails raises.

The train step holds three points where per-rank arithmetic would
silently differ from the reference's one global program:

1. the cross-entropy divides by the global count of valid labels (summed
   over the data group), not each data rank's own;
2. the adapter gradients are summed over the data group, after (1);
3. the optimizer's global-norm clip sums the squares of split adapter
   tensors over the model group and counts replicated ones once.

Replicated adapter tensors (every A; k and v B where k and v are
replicated) enter the trunk through ``comm.copy_to_model``, so their
gradient is summed over the model group. With dropout, the ranks of one
model group must draw the same masks: seed their generators alike.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from paligemma_tpu_torch import generation, lora as lora_mod
from paligemma_tpu_torch.config import PaliGemmaConfig
from paligemma_tpu_torch.lora import AdapterOptimizer, LoraConfig
from paligemma_tpu_torch.models import paligemma
from paligemma_tpu_torch.models.gemma import KVCache
from paligemma_tpu_torch.models.paligemma import PaliGemma
from paligemma_tpu_torch.ops.kernels import KERNELS, KernelFns
from paligemma_tpu_torch.parallel import comm, sharding
from paligemma_tpu_torch.parallel.mesh import Mesh


def make_sharded_prefill(cfg: PaliGemmaConfig, mesh: Mesh, sequence_parallel: bool = False,
                         fns: KernelFns = KERNELS) -> Callable:
    """``prefill(model, input_ids, pixel_values, cache, full_logits=True) ->
    (logits, cache)`` on this rank's model, rows and empty cache: fp32
    logits (B / data, T or 1, V), the same on every rank of the model
    group. ``sequence_parallel``: the residual stream between blocks split
    along T over the model group (``gemma.forward``); the same numbers up
    to the order of sums. The last-position prefill without it
    (``full_logits=False``) is ``generation.prefill``: a CUDA graph over
    NCCL, eager over gloo. ``cfg``: the whole model's (the reference's
    signature; the rank's model carries its own)."""

    def prefill(model: PaliGemma, input_ids: torch.Tensor, pixel_values: torch.Tensor, cache: KVCache,
                full_logits: bool = True):
        if not full_logits and not sequence_parallel:
            return generation.prefill(model, input_ids, pixel_values, cache, fns)
        with torch.no_grad():
            return paligemma.prefill(model, input_ids, pixel_values, cache, full_logits, fns,
                                     sequence_parallel=sequence_parallel)

    return prefill


class _DecodeGraph(generation._Captured):
    """``paligemma.decode_step`` on one cache's buffers as a CUDA graph: the
    token is a static input, the logits a static output; the capture's
    warm-up step is undone (the cache's lengths put back; the K/V row it
    wrote is rewritten by the next step)."""

    def __init__(self, model: PaliGemma, cache: KVCache, fns: KernelFns):
        super().__init__(model, cache, fns)
        dev = cache.k.device
        self.token = torch.zeros((cache.valid.shape[0], 1), dtype=torch.int32, device=dev)
        length, valid, host_length = cache.length.clone(), cache.valid.clone(), cache.host_length

        def restore():
            cache.length.copy_(length)
            cache.valid.copy_(valid)
            cache.host_length = host_length

        _, self.logits = self._capture(dev, lambda: paligemma.decode_step(model, self.token, cache, fns)[0],
                                       restore)

    def run(self, cache: KVCache, token: torch.Tensor) -> torch.Tensor:
        if cache.host_length + 1 > cache.max_len:
            raise ValueError(f"cache full: {cache.host_length} + 1 > {cache.max_len}")
        self.token.copy_(token)
        self._replay()
        cache.host_length += 1
        return self.logits.clone()


def make_sharded_decode(cfg: PaliGemmaConfig, mesh: Mesh, fns: KernelFns = KERNELS) -> Callable:
    """``decode(model, token, cache) -> (logits, cache)``: one step of this
    rank's (B / data, 1) tokens, fp32 logits (B / data, 1, V) the same on
    every rank of the model group. Over NCCL a CUDA graph a cache (captured
    at the first step on it, collectives inside); over gloo eager."""

    @torch.no_grad()
    def decode(model: PaliGemma, token: torch.Tensor, cache: KVCache):
        if not generation.graphs_on(model, cache.k.device):
            return paligemma.decode_step(model, token, cache, fns)
        key = ("sharded-decode", id(model), fns)
        runner = cache.graphs.get(key)
        if runner is None or not runner.serves(model, cache):
            runner = cache.graphs[key] = _DecodeGraph(model, cache, fns)
        return runner.run(cache, token), cache

    return decode


class ShardedAdapterOptimizer(AdapterOptimizer):
    """``AdapterOptimizer`` on one rank's adapter tensors: the clip's global
    norm sums the squares of the split tensors (``split``, in
    ``adapter_leaves`` order) over the model group and counts the
    replicated ones once."""

    def __init__(self, base: AdapterOptimizer, split: list, group: comm.Group):
        super().__init__(base.lr, base.k, base.max_norm, base.wd, base.b1, base.b2, base.eps)
        self.split, self.group = split, group

    def sq_norm(self, grads):
        split = [(g * g).sum() for g, s in zip(grads, self.split) if s]
        total = sum((g * g).sum() for g, s in zip(grads, self.split) if not s)
        return total + comm.all_reduce(sum(split), self.group) if split else total


def _sharded_on_device(mesh: Mesh, split: dict):
    """The sharded micro-step's device work (``lora.TrainStep.on_device``)."""
    mg, dg = mesh.model_group, mesh.data_group

    def on_device(model, adapter, opt_state, batch, generator, lcfg, optimizer, train):
        live = lora_mod._map(lambda t: t.detach().requires_grad_(), adapter)
        layers = live["layers"]
        eff = {"layers": {n: {x: t if split[n][x] else comm.copy_to_model(t, mg) for x, t in ad.items()}
                          for n, ad in layers.items()}}
        use_dropout = train and lcfg.dropout > 0
        loss = paligemma.loss_fn(
            model, batch["input_ids"], batch["pixel_values"], batch["labels"],
            valid_len=batch.get("valid_len"), lora=eff, lora_scale=lcfg.scale,
            lora_dropout=lcfg.dropout if train else 0.0,
            lora_generator=generator if use_dropout else None,
            count_reduce=lambda n: comm.all_reduce(n, dg))
        grads = torch.autograd.grad(loss, lora_mod.adapter_leaves(live))
        grads = [comm.all_reduce(g, dg) for g in grads]
        optimizer.apply(grads, opt_state, adapter)
        return comm.all_reduce(loss.detach(), dg)

    return on_device


def make_sharded_train_step(cfg: PaliGemmaConfig, lcfg: LoraConfig, optimizer: AdapterOptimizer,
                            mesh: Mesh) -> Callable:
    """The DP x TP LoRA micro-step: ``step(model, lora, opt_state, batch,
    generator=None) -> (loss, lora, opt_state)`` on this rank's model
    (``shard_params``), adapters (``sharding.shard_lora``; the state from
    ``optimizer.init`` of them) and rows (``shard_batch``). The loss is the
    global one, on every rank; the adapters change in place, each rank its
    slices. ``valid_len`` is filled (every position) when the batch has
    none. A ``lora.TrainStep`` underneath: CUDA graphs over NCCL, eager
    over gloo and on the CPU."""
    split = sharding.lora_split(cfg, mesh)
    flags = [split[n][x] for n in sorted(split) for x in ("a", "b")]  # adapter_leaves order
    step = lora_mod.TrainStep(lcfg, ShardedAdapterOptimizer(optimizer, flags, mesh.model_group),
                              on_device=_sharded_on_device(mesh, split))

    def sharded_step(model: PaliGemma, adapter: dict, opt_state: dict, batch: dict,
                     generator: Optional[torch.Generator] = None):
        if "valid_len" not in batch:
            b, t = batch["input_ids"].shape
            batch = {**batch, "valid_len": torch.full((b,), t, dtype=torch.int32,
                                                      device=batch["input_ids"].device)}
        return step(model, adapter, opt_state, batch, generator)

    sharded_step.optimizer = step.optimizer  # its init makes the state
    return sharded_step

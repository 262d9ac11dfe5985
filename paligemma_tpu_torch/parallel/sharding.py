"""Sharding rules: which slice of each weight a rank of the (data, model)
mesh holds (port of ``paligemma_tpu/parallel/sharding.py``).

The JAX package annotates the parameter tree with ``NamedSharding``s and
GSPMD partitions the program and inserts the collectives. Here
``shard_params`` builds the rank's own model, holding only its slices, and
the modules carry the collectives (``comm.ModelParallel``) that the model
functions call around their products. The rules are Megatron's, as the
reference's:

- Gemma attention: q split by heads; o row-parallel (its input columns
  split alike). k and v split by kv head when ``num_key_value_heads`` divides
  by the model size; otherwise their weights are replicated, and each rank
  keeps, after the product, the kv heads its q heads read (Gemma-2B's one
  kv head: every rank keeps it). JAX shards head_dim there and lets GSPMD
  reduce the split contraction; a rank here cannot attend with part of a
  head, so the port replicates instead. Attention whose kv heads would
  straddle ranks stays whole on every rank.
- Gemma MLP: gate_up column-parallel, each rank its gate half AND the
  matching up half of the fused (gate | up) rows (never a contiguous half
  of the fused rows, which GSPMD reshards around; a rank must hold pairs);
  down row-parallel.
- The embedding is vocab-parallel (rows split; 257152 / 2 = 128576 a rank):
  the lookup masks the ids outside the rank's rows and sums over the
  group; the tied lm_head's per-rank logits are gathered to every rank.
- SigLIP: qkv split by heads, o row-parallel, fc1 column-, fc2
  row-parallel. A column-parallel bias follows its output columns; a
  row-parallel bias is replicated and added once after the reduction.
- Norms, the patch and position embeddings and the projector: replicated.
  So is everything that does not divide by the model size (the
  reference's ``_div``).
- int8 ``QLinear``: per-row scales follow the rows (a row-parallel weight
  keeps every row, so its scales are whole). int4 ``Q4Linear``: packed rows
  split by output row; a row-parallel one by whole packing groups of 8
  input columns.
- w4a8: the ``W4A8Linear`` MLP stacks and ``embed_w4`` are replicated, as
  the reference's (the fused w4a8 MLP runs whole on every rank); the
  ``gate_up_i8`` / ``down_i8`` companions take the base layout.
- LoRA (``shard_lora``): A replicated, B follows its target's output
  split (k and v B replicated where k and v are).
- ``shard_batch``: rows by data rank. ``shard_cache``: rows by data rank,
  kv heads as k and v.

Every module of a sharded model communicates over the mesh's model group,
also a group of one rank (its collectives are then copies): the code path
is the same at every mesh shape. The rank's model carries its own config:
``text_config`` with this rank's query and kv head counts and MLP width,
so caches and adapter widths made from ``model.cfg`` are the rank's.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from paligemma_tpu_torch.config import PaliGemmaConfig
from paligemma_tpu_torch.models.gemma import KVCache, QuantKVCache
from paligemma_tpu_torch.models.paligemma import PaliGemma
from paligemma_tpu_torch.parallel.comm import ModelParallel
from paligemma_tpu_torch.parallel.mesh import Mesh
from paligemma_tpu_torch.quantization import Q4Linear, QLinear, W4A8Linear

Ranges = Sequence[Tuple[int, int]]


@dataclasses.dataclass(frozen=True)
class Plan:
    """What the rules give for one config and one rank of the model group.

    ``attn`` / ``mlp`` / ``vocab`` / ``vis_attn`` / ``vis_mlp``: whether each
    part is split. ``kv_split``: k and v split by kv head (else replicated,
    with ``kv_first`` the first of the ``kv_local`` heads this rank keeps)."""

    size: int
    rank: int
    attn: bool
    kv_split: bool
    kv_local: int
    kv_first: int
    mlp: bool
    vocab: bool
    vis_attn: bool
    vis_mlp: bool


def plan(cfg: PaliGemmaConfig, size: int, rank: int) -> Plan:
    tc, vc = cfg.text_config, cfg.vision_config
    h, hkv = tc.num_attention_heads, tc.num_key_value_heads
    attn, kv_split, kv_local, kv_first = False, False, hkv, 0
    if h % size == 0:
        hl, group = h // size, h // hkv
        if hkv % size == 0:
            attn, kv_split, kv_local, kv_first = True, True, hkv // size, rank * (hkv // size)
        elif group % hl == 0:  # this rank's q heads all read one kv head
            attn, kv_local, kv_first = True, 1, rank * hl // group
    return Plan(size, rank, attn, kv_split, kv_local, kv_first,
                mlp=tc.intermediate_size % size == 0, vocab=tc.vocab_size % size == 0,
                vis_attn=vc.num_attention_heads % size == 0, vis_mlp=vc.intermediate_size % size == 0)


def rank_config(cfg: PaliGemmaConfig, p: Plan) -> PaliGemmaConfig:
    """The rank's config: the text config's head counts and MLP width are
    this rank's."""
    tc = cfg.text_config
    local = {}
    if p.attn:
        local.update(num_attention_heads=tc.num_attention_heads // p.size, num_key_value_heads=p.kv_local)
    if p.mlp:
        local["intermediate_size"] = tc.intermediate_size // p.size
    return dataclasses.replace(cfg, text_config=dataclasses.replace(tc, **local))


# ---------------------------------------------------------------------------
# Row and column ranges of each weight
# ---------------------------------------------------------------------------


def _part(n: int, p: Plan) -> Tuple[int, int]:
    """This rank's (start, stop) of ``n`` split ``p.size`` ways."""
    k = n // p.size
    return p.rank * k, (p.rank + 1) * k


def _gemma_qkv_rows(cfg: PaliGemmaConfig, p: Plan) -> Ranges:
    tc = cfg.text_config
    q_out, kv_out = tc.num_attention_heads * tc.head_dim, tc.num_key_value_heads * tc.head_dim
    q0, q1 = _part(q_out, p)
    if p.kv_split:
        k0, k1 = _part(kv_out, p)
        return [(q0, q1), (q_out + k0, q_out + k1), (q_out + kv_out + k0, q_out + kv_out + k1)]
    return [(q0, q1), (q_out, q_out + 2 * kv_out)]


def _halves_rows(n: int, parts: int, p: Plan) -> Ranges:
    """Rows of a fused weight of ``parts`` blocks of ``n`` rows: this rank's
    slice of each block."""
    a, b = _part(n, p)
    return [(i * n + a, i * n + b) for i in range(parts)]


def _take_rows(t: torch.Tensor, ranges: Ranges, device) -> torch.Tensor:
    return torch.cat([t[a:b] for a, b in ranges]).to(device)


def _take_cols(t: torch.Tensor, a: int, b: int, device) -> torch.Tensor:
    return t[:, a:b].to(device).contiguous()


def _new_param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _column(mod: nn.Module, ranges: Ranges, device) -> None:
    """A column-parallel product keeps the output rows ``ranges`` (its bias
    and per-row scales with them)."""
    if isinstance(mod, nn.Linear):
        mod.weight = _new_param(_take_rows(mod.weight.detach(), ranges, device))
        if mod.bias is not None:
            mod.bias = _new_param(_take_rows(mod.bias.detach(), ranges, device))
        mod.out_features = mod.weight.shape[0]
        return
    if isinstance(mod, (Q4Linear, W4A8Linear)):
        mod.packed = _take_rows(mod.packed, ranges, device)
        mod.scale = _take_rows(mod.scale, ranges, device)
        return
    if isinstance(mod, QLinear):
        mod.weight = _take_rows(mod.weight, ranges, device)
        mod.scale = _take_rows(mod.scale, ranges, device)
        if mod.bias is not None:
            mod.bias = _take_rows(mod.bias, ranges, device)
        return
    raise TypeError(f"no column-parallel rule for {type(mod).__name__}")


def _row(mod: nn.Module, a: int, b: int, device) -> None:
    """A row-parallel product keeps the input columns [a, b); its bias and
    per-row scales stay whole."""
    if isinstance(mod, nn.Linear):
        mod.weight = _new_param(_take_cols(mod.weight.detach(), a, b, device))
        mod.in_features = mod.weight.shape[1]
        return
    if isinstance(mod, Q4Linear):
        if a % 8 or b % 8:
            raise ValueError(f"a row-parallel int4 weight splits by packing groups of 8 columns, not [{a}, {b})")
        mod.packed = _take_cols(mod.packed, a // 2, b // 2, device)
        return
    if isinstance(mod, QLinear):
        mod.weight = _take_cols(mod.weight, a, b, device)
        return
    raise TypeError(f"no row-parallel rule for {type(mod).__name__}")


def _to_device(model: nn.Module, device) -> None:
    """Every parameter and buffer on ``device``, as new Parameter objects
    (``Module.to`` would move the tensors the input model shares)."""
    for mod in model.modules():
        for name, t in list(mod._parameters.items()):
            if t is not None:
                mod._parameters[name] = _new_param(t.detach().to(device))
        for name, t in list(mod._buffers.items()):
            if t is not None:
                mod._buffers[name] = t.to(device)


def shard_params(model: PaliGemma, cfg: PaliGemmaConfig, mesh: Mesh) -> PaliGemma:
    """This rank's model: a new ``PaliGemma`` on ``mesh.device`` holding only
    its slices of ``model``'s weights (float, int8, int4 or w4a8, from
    ``quantization.quantize_params``), with the collectives of the mesh's
    model group in its modules and its own config (``rank_config``).
    ``model`` (on the host or the card) is left as it is."""
    p = plan(cfg, mesh.model, mesh.model_rank)
    tc, vc = cfg.text_config, cfg.vision_config
    dev = mesh.device
    tp = ModelParallel(mesh.model_group)
    cut = p.size > 1  # a group of one holds every slice: nothing to cut
    shared = {id(t): t for t in model.state_dict(keep_vars=True).values()}
    out = copy.deepcopy(model, memo=shared)
    rcfg = rank_config(cfg, p)
    out.cfg, out.llm.cfg = rcfg, rcfg.text_config

    llm = out.llm
    q_in = tc.num_attention_heads * tc.head_dim
    for layer in llm.layers:
        layer.cfg = rcfg.text_config
        layer.attn_tp = layer.mlp_tp = tp
        if p.attn:
            if cut:
                _column(layer.qkv, _gemma_qkv_rows(cfg, p), dev)
                _row(layer.o, *_part(q_in, p), dev)
            layer.kv_weight_heads = p.kv_local if p.kv_split else tc.num_key_value_heads
            layer.kv_first = 0 if p.kv_split else p.kv_first
        else:
            layer.attn_tp = None
        if p.mlp:
            i = tc.intermediate_size
            names = [("gate_up", "down")]
            if hasattr(layer, "gate_up_i8"):
                names.append(("gate_up_i8", "down_i8"))
            for gu, dn in names:
                if isinstance(getattr(layer, gu), W4A8Linear) or not cut:
                    continue  # replicated: the fused MLP runs whole on every rank
                _column(getattr(layer, gu), _halves_rows(i, 2, p), dev)
                _row(getattr(layer, dn), *_part(i, p), dev)
        else:
            layer.mlp_tp = None
    if p.vocab:
        a, b = _part(tc.vocab_size, p)
        if cut and isinstance(llm.embed, QLinear):
            _column(llm.embed, [(a, b)], dev)
        elif cut:
            llm.embed = _new_param(_take_rows(llm.embed.detach(), [(a, b)], dev))
        llm.vocab_tp, llm.vocab_start = tp, a

    d_vis = vc.hidden_size
    for layer in out.vision.layers:
        if p.vis_attn:
            if cut:
                _column(layer.qkv, _halves_rows(d_vis, 3, p), dev)
                _row(layer.o, *_part(d_vis, p), dev)
            layer.attn_tp, layer.n_heads = tp, vc.num_attention_heads // p.size
        if p.vis_mlp:
            if cut:
                _column(layer.fc1, [_part(vc.intermediate_size, p)], dev)
                _row(layer.fc2, *_part(vc.intermediate_size, p), dev)
            layer.mlp_tp = tp
    _to_device(out, dev)
    return out


def rank_bytes(model: PaliGemma, cfg: PaliGemmaConfig, size: int) -> int:
    """The bytes a rank of a model group of ``size`` holds by the rules,
    counted from the full ``model``'s tensors by name (the check of
    ``shard_params``): a split tensor's bytes over ``size``, the rest whole."""
    p = plan(cfg, size, 0)
    tc = cfg.text_config
    total = 0
    for name, t in model.state_dict().items():
        nbytes = t.numel() * t.element_size()
        parts = name.split(".")
        leaf, owner = parts[-1], parts[-2] if len(parts) > 1 else ""
        whole_rows = leaf in ("scale",) and owner in ("o", "down", "down_i8", "fc2")
        if name.startswith("llm.embed_w4"):
            split = False
        elif name.startswith("llm.embed"):
            split = p.vocab
        elif name.startswith("llm.layers."):
            if owner == "qkv" and p.attn:
                if p.kv_split:
                    nbytes //= size
                else:  # q rows split, k and v rows whole
                    q = tc.num_attention_heads * tc.head_dim
                    kv = 2 * tc.num_key_value_heads * tc.head_dim
                    nbytes = nbytes * (q // size + kv) // (q + kv)
                split = False
            elif owner == "o":
                split = p.attn and not whole_rows
            elif owner in ("gate_up", "down", "gate_up_i8", "down_i8"):
                w4 = owner in ("gate_up", "down") and isinstance(
                    getattr(model.llm.layers[int(parts[2])], owner), W4A8Linear)
                split = p.mlp and not w4 and not whole_rows
            else:
                split = False
        elif name.startswith("vision.layers."):
            if owner in ("qkv", "o"):
                split = p.vis_attn and not (owner == "o" and leaf in ("bias", "scale"))
            elif owner in ("fc1", "fc2"):
                split = p.vis_mlp and not (owner == "fc2" and leaf in ("bias", "scale"))
            else:
                split = False
        else:
            split = False
        total += nbytes // size if split else nbytes
    return total


def shard_lora(lora: dict, cfg: PaliGemmaConfig, mesh: Mesh) -> dict:
    """This rank's adapters (the reference's ``lora_shardings``): A
    replicated; B's output columns follow its target's split (k and v B
    whole where k and v are replicated). New tensors on ``mesh.device``."""
    p = plan(cfg, mesh.model, mesh.model_rank)
    layers = lora.get("layers", lora)
    out = {}
    for name, ad in layers.items():
        b = ad["b"]
        split = p.attn and (name == "q" or p.kv_split)
        if split:
            a0, a1 = _part(b.shape[-1], p)
            b = b[..., a0:a1]
        out[name] = {"a": ad["a"].detach().to(mesh.device, copy=True),
                     "b": b.detach().to(mesh.device, copy=True).contiguous()}
    return {"layers": out}


def lora_split(cfg: PaliGemmaConfig, mesh: Mesh) -> Dict[str, Dict[str, bool]]:
    """Which adapter tensors ``shard_lora`` splits over the model group."""
    p = plan(cfg, mesh.model, mesh.model_rank)
    return {name: {"a": False, "b": p.attn and (name == "q" or p.kv_split)} for name in ("q", "k", "v")}


def shard_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This data rank's rows of ``x`` (the reference's ``batch_sharding``)."""
    if x.shape[0] % mesh.data:
        raise ValueError(f"batch of {x.shape[0]} rows does not split {mesh.data} ways")
    n = x.shape[0] // mesh.data
    return x[mesh.data_rank * n:(mesh.data_rank + 1) * n].to(mesh.device)


def cache_heads(cfg: PaliGemmaConfig, mesh: Mesh) -> Tuple[int, int]:
    """(first, count) of the kv heads a rank's cache holds."""
    p = plan(cfg, mesh.model, mesh.model_rank)
    if not p.attn:
        return 0, cfg.text_config.num_key_value_heads
    return p.kv_first, p.kv_local


def shard_cache(cache: KVCache, cfg: PaliGemmaConfig, mesh: Mesh) -> KVCache:
    """This rank's part of a whole-batch cache (the reference's
    ``cache_shardings``): rows by data rank, kv heads as k and v; new
    buffers on ``mesh.device``, the same lengths."""
    first, count = cache_heads(cfg, mesh)

    def cut(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        rows = shard_batch(t.transpose(0, 1), mesh).transpose(0, 1)
        return rows[:, :, :, first:first + count].to(mesh.device).contiguous()

    kw = {f: cut(getattr(cache, f)) for f in ("k", "v")}
    if isinstance(cache, QuantKVCache):
        kw.update(k_scale=cut(cache.k_scale), v_scale=cut(cache.v_scale))
    return dataclasses.replace(cache, **kw, length=cache.length.to(mesh.device, copy=True),
                               valid=shard_batch(cache.valid, mesh).clone(), graphs={})


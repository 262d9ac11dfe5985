"""The collectives of tensor, sequence and pipeline parallelism, with their
gradients (port-only: the JAX package writes sharding annotations and GSPMD
inserts the collectives).

``Group`` wraps one process group: its ranks, this process's place in it
and its backend. A group of one process (``Group(None, [rank])``) runs every
collective as the identity, so a model sharded over a one-process mesh
without a process group still runs.

The autograd ``Function``s are Megatron's:

- ``copy_to_model`` (*f*): identity forward, all-reduce backward. It sits at
  the input of every column-parallel product: each rank's product gives a
  partial gradient of the replicated input.
- ``reduce_from_model`` (*g*): all-reduce forward, identity backward. It
  sits after every row-parallel product.
- ``gather_from_model``: the vocab-parallel logits gathered along the last
  axis to every rank; the backward takes this rank's slice.
- ``gather_seq`` / ``scatter_seq``: the sequence-parallel pair along T (axis
  1): all-gather before a column-parallel product (backward: reduce-scatter)
  and reduce-scatter after a row-parallel one (backward: all-gather).
- ``send_next`` / ``recv_prev``: the pipeline's point-to-point. The
  backward of a send receives the gradient from the next stage; the
  backward of a receive sends the gradient back. ``send_next`` returns a
  0-d token that the caller adds (times zero) to its output, so that the
  backward reaches every send; ``recv_prev`` hangs on a leaf ``anchor``
  that requires a gradient, so ``loss.backward()`` reaches every receive.

Transport is chosen by the group's backend, never by trying one path and
falling to another:

- NCCL: every op is native (``all_reduce``, ``all_gather_into_tensor``,
  ``reduce_scatter_tensor``, ``send``/``recv``).
- gloo: PyTorch's backend table lists only ``broadcast`` and
  ``all_reduce`` for gloo on CUDA tensors (torch 2.11 on an H100 also ran
  ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` there; chip_smoke
  phase 17 prints what runs), so on gloo an all-gather is an all-reduce
  into a zeroed full-width buffer (exact: x + 0 = x) and a reduce-scatter
  is an all-reduce and a slice. Point-to-point of a CUDA tensor on gloo
  copies through host memory; ``Group.host_copies`` counts those copies
  (one a send, one a receive).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


class Group:
    """One process group: ``ranks`` (global, in group order), this
    process's ``rank`` in it, ``size`` and ``backend`` ("gloo", "nccl", or
    "none" for a one-process group without a process group)."""

    def __init__(self, pg, ranks: Sequence[int], rank: Optional[int] = None):
        self.pg = pg
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        me = dist.get_rank() if dist.is_initialized() else self.ranks[0]
        self.rank = self.ranks.index(me) if rank is None else rank
        self.backend = "none" if pg is None else str(dist.get_backend(pg))
        self.host_copies = 0

    @property
    def native(self) -> bool:
        """Whether every collective is native (NCCL), not an all-reduce."""
        return self.backend == "nccl"


# ---------------------------------------------------------------------------
# The collectives (no gradient)
# ---------------------------------------------------------------------------


def all_reduce(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of ``x`` over the group, in a new tensor in x's dtype."""
    y = x.clone(memory_format=torch.contiguous_format)
    if group.pg is not None:
        dist.all_reduce(y, group=group.pg)
    return y


def all_reduce_max(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The elementwise max of ``x`` over the group, in a new tensor."""
    y = x.clone(memory_format=torch.contiguous_format)
    if group.pg is not None:
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group.pg)
    return y


def all_gather(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    if group.pg is None:
        return x.clone(memory_format=torch.contiguous_format)
    dim = dim % x.dim()
    n = x.shape[dim]
    if group.native:
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((group.size * n, *xt.shape[1:]))
        dist.all_gather_into_tensor(out, xt, group=group.pg)
        return out.movedim(0, dim).contiguous()
    shape = list(x.shape)
    shape[dim] = group.size * n
    out = x.new_zeros(shape)
    out.narrow(dim, group.rank * n, n).copy_(x)
    dist.all_reduce(out, group=group.pg)
    return out


def reduce_scatter(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """The group's sum of ``x``, this rank's ``1 / size`` along ``dim``."""
    dim = dim % x.dim()
    if x.shape[dim] % group.size:
        raise ValueError(f"reduce_scatter: axis {dim} of {tuple(x.shape)} does not split {group.size} ways")
    n = x.shape[dim] // group.size
    if group.pg is None:
        return x.clone(memory_format=torch.contiguous_format)
    if group.native:
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((n, *xt.shape[1:]))
        dist.reduce_scatter_tensor(out, xt, group=group.pg)
        return out.movedim(0, dim).contiguous()
    full = all_reduce(x, group)
    return full.narrow(dim, group.rank * n, n).contiguous()


def send(x: torch.Tensor, group: Group, dst: int) -> None:
    """Send ``x`` to group rank ``dst`` (through host memory for a CUDA
    tensor on gloo)."""
    x = x.contiguous()
    if x.is_cuda and not group.native:
        x = x.cpu()
        group.host_copies += 1
    dist.send(x, group.ranks[dst], group=group.pg)


def recv(shape: Sequence[int], dtype: torch.dtype, device: torch.device, group: Group, src: int) -> torch.Tensor:
    """Receive a tensor of ``shape`` and ``dtype`` from group rank ``src``
    onto ``device``."""
    dev = torch.device(device)
    host = dev.type == "cuda" and not group.native
    buf = torch.empty(tuple(shape), dtype=dtype, device="cpu" if host else dev)
    dist.recv(buf, group.ranks[src], group=group.pg)
    if host:
        group.host_copies += 1
        buf = buf.to(dev)
    return buf


# ---------------------------------------------------------------------------
# The Functions (with gradients)
# ---------------------------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        g = grad.narrow(ctx.dim, ctx.group.rank * ctx.n, ctx.n).contiguous()
        return g, None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.group, 1), None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_scatter(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.group, 1), None


def copy_to_model(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Megatron's *f*: identity forward, all-reduce of the gradient."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Megatron's *g*: all-reduce forward, identity backward."""
    return _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, group: Group, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` along ``dim`` on every rank; the backward takes
    this rank's slice of the gradient."""
    return _GatherFromModel.apply(x, group, dim % x.dim())


def gather_seq(x: torch.Tensor, group: Group) -> torch.Tensor:
    """(B, T / size, ...) shards -> (B, T, ...) on every rank."""
    return _GatherSeq.apply(x, group)


def scatter_seq(x: torch.Tensor, group: Group) -> torch.Tensor:
    """(B, T, ...) partial sums -> this rank's (B, T / size, ...) of their sum."""
    return _ScatterSeq.apply(x, group)


def seq_shard(x: torch.Tensor, group: Group) -> torch.Tensor:
    """This rank's ``1 / size`` of ``x`` along T (axis 1), no communication."""
    if x.shape[1] % group.size:
        raise ValueError(f"sequence parallelism: T = {x.shape[1]} does not split {group.size} ways")
    n = x.shape[1] // group.size
    return x[:, group.rank * n:(group.rank + 1) * n]


class _SendNext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dst):
        ctx.group, ctx.dst = group, dst
        ctx.shape, ctx.dtype, ctx.device = x.shape, x.dtype, x.device
        send(x, group, dst)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        return recv(ctx.shape, ctx.dtype, ctx.device, ctx.group, ctx.dst), None, None


class _RecvPrev(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, shape, dtype, group, src):
        ctx.group, ctx.src = group, src
        return recv(shape, dtype, anchor.device, group, src)

    @staticmethod
    def backward(ctx, grad):
        send(grad, ctx.group, ctx.src)
        return torch.zeros((), device=grad.device), None, None, None, None


def send_next(x: torch.Tensor, group: Group, dst: int) -> torch.Tensor:
    """Send ``x`` to group rank ``dst``; returns a 0-d zero token whose
    backward receives x's gradient from ``dst``."""
    return _SendNext.apply(x, group, dst)


def recv_prev(anchor: torch.Tensor, shape: Sequence[int], dtype: torch.dtype, group: Group,
              src: int) -> torch.Tensor:
    """Receive from group rank ``src`` onto ``anchor``'s device; the
    backward sends the gradient back to ``src``. ``anchor``: a 0-d leaf
    that requires a gradient when a backward is to run (``pipeline.py``)."""
    return _RecvPrev.apply(anchor, tuple(shape), dtype, group, src)


# ---------------------------------------------------------------------------
# What the models read
# ---------------------------------------------------------------------------


class ModelParallel:
    """The tensor-parallel side of one sharded module: the model group, and
    the collectives at the entry and exit of its column- and row-parallel
    products (``enter`` / ``leave``), plain TP or, with ``seq``, sequence
    parallel."""

    def __init__(self, group: Group):
        self.group = group

    def enter(self, x: torch.Tensor, seq: bool = False) -> torch.Tensor:
        return gather_seq(x, self.group) if seq else copy_to_model(x, self.group)

    def leave(self, y: torch.Tensor, seq: bool = False) -> torch.Tensor:
        return scatter_seq(y, self.group) if seq else reduce_from_model(y, self.group)


def groups_of(model: torch.nn.Module) -> List[Group]:
    """The distinct groups the modules of ``model`` communicate over."""
    seen = {}
    for mod in model.modules():
        for name in ("attn_tp", "mlp_tp", "vocab_tp"):
            tp = getattr(mod, name, None)
            if tp is not None:
                seen[id(tp.group)] = tp.group
    return list(seen.values())


def capturable(model: torch.nn.Module) -> bool:
    """Whether a CUDA graph may capture ``model``'s steps: it communicates
    over no group, or only over NCCL groups (gloo's collectives run on the
    host and cannot be captured)."""
    return all(g.native or g.pg is None for g in groups_of(model))

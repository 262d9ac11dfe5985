"""Where a row of a batched call stops being the same row of a smaller call.

``first_row_difference(run, small, big)`` runs ``run(fns, batch)`` at batch
``small`` and at batch ``big`` (a multiple of it), whose first ``small``
rows hold the same inputs, and compares those rows op by op: every ATen
operation's outputs (under a ``TorchDispatchMode``) and every call of the
``fns`` bundle's kernels (each wrapped, its own ATen operations not
recorded) in the order they run. An output of the big run is cut to the
small run's rows along the one dimension that is ``big / small`` times
longer (a batch dimension, or a flattened batch-and-position one); an
output of the same shape in both is compared whole. Outputs of
allocations (``empty`` and its kin) are skipped: they hold garbage until
something writes them.

It returns None when every output agrees bit for bit, else the first
operation that disagrees: the earlier ones all agreed, so its inputs did,
and that operation is where the rows part. A ``fns.<name>`` operation is a
kernel of the port; an ATen one is PyTorch's (``mm``, ``addmm`` and
``convolution`` run cuBLAS and cuDNN on the card).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from paligemma_tpu_torch.ops.kernels import KERNELS, KernelFns

_ALLOCATIONS = {
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
    torch.ops.aten.empty_strided.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default,
}


def _tensors(out: Any) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for x in out for t in _tensors(x)]
    return []


def _shapes(args: Any) -> list:
    return [tuple(t.shape) for t in _tensors(list(args))]


class _Recorder(TorchDispatchMode):
    """Hands each operation's tensor outputs to ``emit(op, where, outputs,
    input shapes)`` while no ``fns`` call is running; ``where`` is the
    innermost labelled module the operation runs in."""

    def __init__(self, emit: Callable[[str, str, List[torch.Tensor], list], None]):
        super().__init__()
        self.emit, self.paused, self.where = emit, 0, ["top"]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.paused and func not in _ALLOCATIONS:
            outs = _tensors(out)
            if outs:
                self.emit(f"aten.{func.overloadpacket.__name__}", self.where[-1], outs,
                          _shapes(list(args) + list((kwargs or {}).values())))
        return out

    def label(self, labels: Sequence[Tuple[str, nn.Module]]) -> list:
        """Hooks that name the operations inside each module's forward;
        returns their handles."""
        def enter(name):
            def hook(module, args):
                self.where.append(name)
            return hook

        def leave(module, args, out):
            self.where.pop()

        return [h for name, m in labels
                for h in (m.register_forward_pre_hook(enter(name)), m.register_forward_hook(leave))]

    def wrap(self, fns: KernelFns) -> KernelFns:
        def one(name, f):
            def call(*args, **kwargs):
                self.paused += 1  # neither the call's operations nor emit's are recorded
                try:
                    out = f(*args, **kwargs)
                    self.emit(f"fns.{name}", self.where[-1], _tensors(out),
                              _shapes(list(args) + list(kwargs.values())))
                finally:
                    self.paused -= 1
                return out
            return call
        return KernelFns(*(one(n, f) for n, f in zip(KernelFns._fields, fns)))


def _row_part(ref: torch.Tensor, got: torch.Tensor, ratio: int) -> Optional[torch.Tensor]:
    """The part of ``got`` (big run) that holds ``ref``'s (small run's) rows."""
    if got.shape == ref.shape:
        return got
    if got.dim() != ref.dim():
        return None
    dims = [d for d in range(got.dim()) if got.shape[d] != ref.shape[d]]
    if len(dims) != 1 or got.shape[dims[0]] != ratio * ref.shape[dims[0]]:
        return None
    return got.narrow(dims[0], 0, ref.shape[dims[0]])


def _bits(t: torch.Tensor) -> torch.Tensor:
    flat = torch.empty(t.numel(), dtype=t.dtype, device=t.device)
    return flat.copy_(t.reshape(-1)).view(torch.uint8)


def first_row_difference(
    run: Callable[[KernelFns, int], Any],
    small: int,
    big: int,
    fns: KernelFns = KERNELS,
    labels: Sequence[Tuple[str, nn.Module]] = (),
) -> Optional[dict]:
    """Run ``run(fns, batch)`` at ``small`` and at ``big`` rows and return
    the first operation whose outputs differ in the first ``small`` rows
    (None: none does): ``{"index", "op", "where", "inputs" (the shapes of
    its tensor arguments, the big run's), "shape", "elements", "differing",
    "max_abs_err", "compared"}``, or with ``"sequence"`` set
    when the two runs ran different operations there. ``labels``: (name,
    module) pairs whose forward calls name the operations inside them
    (``where``)."""
    if big % small:
        raise ValueError(f"big ({big}) must be a multiple of small ({small})")
    ref: List[Tuple[str, str, List[torch.Tensor]]] = []
    found: dict = {}
    count = [0]

    def keep(op, where, outs, ins):
        ref.append((op, where, [t.detach().clone() for t in outs]))

    def compare(op, where, outs, ins):
        i = count[0]
        count[0] += 1
        if found:
            return
        if i >= len(ref) or ref[i][0] != op or len(ref[i][2]) != len(outs):
            found.update(index=i, op=op, where=where, inputs=ins,
                         sequence=f"the small run ran {ref[i][0] if i < len(ref) else 'nothing'} here")
            return
        for r, g in zip(ref[i][2], outs):
            part = _row_part(r, g.detach(), big // small)
            if part is None:
                found.update(index=i, op=op, where=where, inputs=ins,
                             sequence=f"shapes {tuple(r.shape)} and {tuple(g.shape)}")
                return
            if r.dtype != part.dtype or not torch.equal(_bits(r), _bits(part)):
                differ = (r != part) & ~(torch.isnan(r) & torch.isnan(part)) if r.is_floating_point() else r != part
                err = float((r.double() - part.double()).abs().nan_to_num(0.0).max()) if r.numel() else 0.0
                found.update(index=i, op=op, where=where, inputs=ins, shape=tuple(r.shape), elements=r.numel(),
                             differing=int(differ.sum()), max_abs_err=err)
                return

    for emit, batch in ((keep, small), (compare, big)):
        rec = _Recorder(emit)
        hooks = rec.label(labels)
        try:
            with torch.no_grad(), rec:
                run(rec.wrap(fns), batch)
        finally:
            for h in hooks:
                h.remove()
    if found:
        found["compared"] = min(found["index"] + 1, len(ref))
        return found
    if count[0] != len(ref):
        return {"index": min(count[0], len(ref)), "op": "end", "where": "top", "inputs": [],
                "compared": min(count[0], len(ref)),
                "sequence": f"the small run ran {len(ref)} operations, the big run {count[0]}"}
    return None


def model_labels(model) -> List[Tuple[str, nn.Module]]:
    """(name, module) of a ``PaliGemma``'s vision and decoder layers and
    its final norms, for ``first_row_difference``'s ``labels``."""
    out = [(f"siglip layer {i}", m) for i, m in enumerate(model.vision.layers)]
    out += [(f"gemma layer {i}", m) for i, m in enumerate(model.llm.layers)]
    for i, layer in enumerate(model.llm.layers):
        out += [(f"gemma layer {i} input_ln", layer.input_ln), (f"gemma layer {i} post_ln", layer.post_ln)]
    out.append(("gemma final_norm", model.llm.final_norm))
    return out

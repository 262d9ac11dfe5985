"""Pipeline parallelism: a GPipe schedule over the decoder's layers (port of
``paligemma_tpu/parallel/pipeline.py``).

The decoder's L layers split into P contiguous stages of L / P layers, one
stage a rank of a pipe group. The forward runs M microbatches: stage s runs
microbatch m at tick s + m, receiving its activations from stage s - 1 and
sending its output to stage s + 1 (``comm.send_next`` / ``comm.recv_prev``).
The last stage's outputs are summed over the group with zeros from every
other stage (the reference's ``psum``), so every stage returns the
final-normed hidden states. RoPE's cos / sin are computed by each stage
from the replicated positions (the reference carries them along the
pipeline).

The backward is the reverse schedule, run by autograd through the
``Function``s of ``comm.py``: the backward of a send receives the gradient
from the next stage, that of a receive sends it back. Drive it with
``loss.backward()``: every stage's backward must run, and
``torch.autograd.grad`` of chosen tensors would prune the receives.
Autograd takes each rank's microbatches in reverse order, so the stages
meet in the same order.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.distributed as dist

from paligemma_tpu_torch.config import GemmaConfig, PaliGemmaConfig
from paligemma_tpu_torch.models import gemma, paligemma
from paligemma_tpu_torch.models.gemma import GemmaLayer, GemmaModel
from paligemma_tpu_torch.models.paligemma import PaliGemma
from paligemma_tpu_torch.ops.kernels import KERNELS, KernelFns
from paligemma_tpu_torch.ops.rope import rope_cos_sin
from paligemma_tpu_torch.parallel import comm
from paligemma_tpu_torch.parallel.mesh import _device


@dataclasses.dataclass(eq=False)
class PipeMesh:
    """This rank's stage of a pipe group of ``stages`` ranks."""

    stages: int
    group: comm.Group
    device: torch.device

    @property
    def stage(self) -> int:
        return self.group.rank


def make_pipe_mesh(n_stages: int, device="cuda") -> PipeMesh:
    """Pipe groups of ``n_stages`` consecutive ranks over the initialized
    default group (each rank runs the pipeline of its own group)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % n_stages:
        raise ValueError(f"{world} ranks do not split into pipelines of {n_stages}")
    mine = None
    for start in range(0, world, n_stages):
        ranks = list(range(start, start + n_stages))
        pg = dist.new_group(ranks)
        if rank in ranks:
            mine = comm.Group(pg, ranks)
    return PipeMesh(n_stages, mine, _device(device))


def stage_params(llm: GemmaModel, n_stages: int) -> List[List[GemmaLayer]]:
    """The decoder's layers as ``n_stages`` contiguous stages of L / P each."""
    n = len(llm.layers)
    if n % n_stages:
        raise ValueError(f"{n} layers do not split into {n_stages} stages")
    per = n // n_stages
    return [list(llm.layers[s * per:(s + 1) * per]) for s in range(n_stages)]


def pipelined_decoder_forward(
    llm: GemmaModel,
    cfg: GemmaConfig,
    inputs_embeds: torch.Tensor,
    positions: torch.Tensor,
    mesh: PipeMesh,
    n_microbatches: int,
    fns: KernelFns = KERNELS,
) -> torch.Tensor:
    """Cache-free decoder forward over the pipe group: ``gemma.forward(...,
    cache=None, mask=None)`` (full bidirectional attention), (B, T, D)
    final-normed hidden states on every stage. B = n_microbatches x mb;
    ``inputs_embeds`` and ``positions`` are the same on every stage."""
    b, t, d = inputs_embeds.shape
    if b % n_microbatches:
        raise ValueError(f"batch {b} does not split into {n_microbatches} microbatches")
    mb, p, s, grp = b // n_microbatches, mesh.stages, mesh.stage, mesh.group
    dtype = inputs_embeds.dtype
    h = inputs_embeds * float(torch.tensor(cfg.hidden_size**0.5, dtype=dtype))
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.max_position_embeddings, dtype)
    layers = stage_params(llm, p)[s]
    anchor = torch.zeros((), device=h.device, requires_grad=torch.is_grad_enabled())
    outs, tokens = [], []
    for m in range(n_microbatches):
        rows = slice(m * mb, (m + 1) * mb)
        x = h[rows] if s == 0 else comm.recv_prev(anchor, (mb, t, d), dtype, grp, s - 1)
        for layer in layers:
            x = layer(x, cos[rows], sin[rows], None, None, 0, fns)
        if s < p - 1:
            tokens.append(comm.send_next(x, grp, s + 1))
        else:
            outs.append(x)
    out = torch.cat(outs) if s == p - 1 else h.new_zeros((b, t, d))
    out = comm.reduce_from_model(out, grp)
    if tokens:  # the sends' backward must run: hang them on the output
        out = out + 0 * torch.stack(tokens).sum()
    return llm.final_norm(out)


def pipelined_loss_fn(
    model: PaliGemma,
    cfg: PaliGemmaConfig,
    input_ids: torch.Tensor,
    pixel_values: torch.Tensor,
    labels: torch.Tensor,
    mesh: PipeMesh,
    n_microbatches: int,
    fns: KernelFns = KERNELS,
) -> torch.Tensor:
    """Shifted cross-entropy with the decoder trunk pipelined over the pipe
    group (``paligemma.loss_fn``'s number). The vision tower, the merge and
    the lm_head run replicated on every stage, as in the reference; the
    tower and the merge without a graph, as ``forward_nocache`` runs them."""
    b, t = input_ids.shape
    with torch.no_grad():
        embeds = paligemma.merge_prefix(model, input_ids, paligemma.encode_image(model, pixel_values, fns))
    positions = torch.arange(t, dtype=torch.int32, device=input_ids.device).expand(b, t)
    hidden = pipelined_decoder_forward(model.llm, cfg.text_config, embeds, positions, mesh, n_microbatches, fns)
    return paligemma.shifted_cross_entropy(gemma.logits(model.llm, hidden, fns), labels, cfg.ignore_index)

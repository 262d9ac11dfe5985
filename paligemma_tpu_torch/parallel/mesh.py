"""The (data, model) mesh over ``torch.distributed`` and the launcher that
starts its processes (port of ``paligemma_tpu/parallel/mesh.py``).

A JAX mesh is an array of devices that sharding annotations name; here a
mesh is this process's view of the world: its place (data rank, model
rank), the process group of its data-parallel peers and that of its
model-parallel peers, and its device. Rank r sits at (r // model, r %
model), so the peers of one model group are adjacent ranks.

``spawn`` runs a function on ``world_size`` new processes (the ``spawn``
start method: CUDA cannot be forked), each with the default process group
initialized over ``tcp://localhost:<free port>``. The function must live in
a module that the children can import without side effects.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import socket
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from paligemma_tpu_torch.parallel.comm import Group

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(eq=False)
class Mesh:
    """This process's place on a (data, model) mesh."""

    data: int
    model: int
    rank: int
    device: torch.device
    data_group: Group
    model_group: Group

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def backend(self) -> str:
        return self.model_group.backend


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(data: int = 1, model: Optional[int] = None, device="cuda") -> Mesh:
    """The (data, model) mesh over the initialized default group. ``model``
    None: every rank left over after ``data``. Every rank creates every
    data and model group, in one order (``new_group`` is collective)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if model is None:
        if world % data:
            raise ValueError(f"{world} ranks do not split into data={data}")
        model = world // data
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} ranks")
    model_groups = [list(range(d * model, (d + 1) * model)) for d in range(data)]
    data_groups = [list(range(m, world, model)) for m in range(model)]
    mine = {}
    for ranks in model_groups + data_groups:
        pg = dist.new_group(ranks)
        if rank in ranks:
            mine[tuple(ranks)] = Group(pg, ranks)
    return Mesh(data, model, rank, _device(device),
                data_group=mine[tuple(data_groups[rank % model])],
                model_group=mine[tuple(model_groups[rank // model])])


def single_device_mesh(device="cuda") -> Mesh:
    """A 1 x 1 mesh: over the initialized default group when it has one
    rank, else over no process group (every collective is the identity)."""
    if dist.is_initialized():
        return make_mesh(1, 1, device)
    return Mesh(1, 1, 0, _device(device), Group(None, [0]), Group(None, [0]))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_rank(rank: int, fn: Callable, world_size: int, backend: str, device: str, port: int,
              out_dir: str, timeout_s: float) -> None:
    args = torch.load(os.path.join(out_dir, "args.pt"), weights_only=False)
    if device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(*args)
    except BaseException:
        # Stamped, so that spawn reports the rank that raised first (its
        # peers then fail in their collectives).
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    else:
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, backend: str, device: str, *args,
          timeout_s: float = 300.0) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` spawned processes, each with the
    default group initialized (``backend``: "gloo" or "nccl"); returns each
    rank's return value (saved with ``torch.save``: keep it on the host).
    ``device`` has no default: "cuda" puts rank r on card r mod the card
    count (every rank on one card when there is one), "cpu" runs each
    process on one CPU thread. A rank that raises fails the run
    (``torch.multiprocessing.ProcessRaisedException``) with the traceback
    of the rank that raised first; a collective that waits longer than
    ``timeout_s`` raises in its rank."""
    import torch.multiprocessing as mp

    out_dir = tempfile.mkdtemp(prefix="pg_spawn_")
    try:
        # The arguments go through a file: a large process object written to
        # a child that died while starting would block the parent.
        torch.save(args, os.path.join(out_dir, "args.pt"))
        try:
            mp.start_processes(_run_rank, args=(fn, world_size, backend, device, free_port(), out_dir,
                                                timeout_s),
                               nprocs=world_size, join=True, start_method="spawn")
        except mp.ProcessRaisedException as e:
            first = _first_error(out_dir)
            if first is None:
                raise
            rank, tb = first
            raise mp.ProcessRaisedException(f"\n\n-- Process {rank} raised first:\n{tb}", rank, e.error_pid) from e
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def _first_error(out_dir: str):
    """(rank, traceback) of the rank that raised first, if any wrote one."""
    errs = []
    for name in os.listdir(out_dir):
        if name.endswith(".err"):
            with open(os.path.join(out_dir, name)) as f:
                stamp, _, tb = f.read().partition("\n")
            errs.append((float(stamp), int(name[4:-4]), tb))
    return min(errs)[1:] if errs else None

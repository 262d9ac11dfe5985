"""The traced stretch of a ``--trace 1`` run, and what is read from it.

``torch.profiler`` (CUPTI) records the device's operations over a bounded
steady stretch that follows the window under the same load, from one step
boundary to another, with the device drained at both ends so that the
trace holds exactly the work of the steps between. Nothing is written to
disk: the events are read from the profiler in memory. Device events are
grouped by kernel-name patterns (``kernels/<group>.json``, first file in
name order that matches). The profiler's mirror of a host annotation on
the device's timeline is not a device operation and is left out.

The profiler drops device records that it times outside its own start
and stop (the device's clock and the host's differ by about a
millisecond), so the traced steps run inside a span (``SPAN``) that opens
``GUARD_S`` after the profiler starts and closes as long before it stops;
the trace's window is that span. A trace that lost records would read
rooflines too high, so ``read`` counts the lost ones from the profiler's
own records: each launch, copy or fill that the host issued to the device
in the span (a CUDA runtime or driver call) shares its correlation id
with the device records of the work it started, a graph launch with those
of all its nodes. A graph launch with none was lost, and so was part of
one that holds a strict part of another's records. The engine's timed
work (the join prefill, the slot steps) runs as graph launches, and so do
all the kernels a roofline reads. The eager launches between them
(copies and fills of a few microseconds) are checked too but counted
apart (``unrecorded``): on an H100 under torch 2.11, 2-4 a trace had no
record while a profiler started before the window stayed attached, with
every graph's records whole.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

from harness import cells

SPAN = "bench.traced"
GUARD_S = 0.05


@dataclasses.dataclass
class Event:
    name: str
    start: int  # ns
    end: int
    group: Optional[str] = None


@dataclasses.dataclass
class Trace:
    device: List[Event]  # sorted by start
    host: List[Event]
    t_start: int  # ns, the traced window in the events' clock
    t_end: int
    window_s: float  # host clock
    launches: int = 0  # the host's calls that start device work
    lost: int = 0  # graph launches with none or part of their device records
    unrecorded: int = 0  # eager launches with no device record

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device events' intervals, clipped to the window."""
        out: List[List[int]] = []
        for e in self.device:
            s, t = max(e.start, self.t_start), min(e.end, self.t_end)
            if t <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return [(s, t) for s, t in out]

    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals()) * 1e-9

    def group_s(self, group: str) -> float:
        return sum(e.end - e.start for e in self.device if e.group == group) * 1e-9

    def count(self, group: str) -> int:
        return sum(1 for e in self.device if e.group == group)

    def gaps(self) -> List[Tuple[int, int]]:
        edges, prev = [], self.t_start
        for s, t in self.busy_intervals():
            if s > prev:
                edges.append((prev, s))
            prev = t
        if self.t_end > prev:
            edges.append((prev, self.t_end))
        return edges

    def host_label(self, at: int) -> str:
        """The innermost host event that spans ``at``."""
        best = None
        for e in self.host:
            if e.start <= at <= e.end and (best is None or e.end - e.start < best.end - best.start):
                best = e
        return "(no host event)" if best is None else best.name[:64]

    def breakdown(self, top: int = 10) -> dict:
        by_name: Dict[str, int] = {}
        for e in self.device:
            by_name[e.name] = by_name.get(e.name, 0) + (e.end - e.start)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:160], d * 1e-9] for n, d in ops],
                "idle_gaps": [[self.host_label((s + t) // 2), (t - s) * 1e-9] for s, t in gaps]}

    def join_segments(self) -> List[List[Event]]:
        """The device events of each join in the trace: a step's chunk ends
        with the copy of its tokens to the host (``token_fetch``), its join
        follows, and the next chunk's first decode-attention launch ends it.
        A stretch counts as a join if it holds an attention launch of the
        prefill (``flash_attention``)."""
        segs, cur = [], None
        for e in self.device:
            if e.group == "token_fetch":
                cur = []
                segs.append(cur)
            elif e.group == "decode_attention":
                cur = None
            elif cur is not None:
                cur.append(e)
        return [s for s in segs if any(e.group == "flash_attention" for e in s)]


def classify(name: str, groups: Dict[str, List[List[str]]]) -> Optional[str]:
    """The first group one of whose patterns matches: a pattern is a list
    of substrings that the name holds all of."""
    for group, patterns in groups.items():
        if any(all(k in name for k in keys) for keys in patterns):
            return group
    return None


class Tracer:
    """Profiles the steps between ``start()`` and ``stop()``, which come
    between steps, for ``length_s`` (``done()``); the events are read after
    the window (``result()``)."""

    def __init__(self, length_s: float, device):
        self.length_s, self.device = length_s, device
        self.prof = None
        self.t_host = (0.0, 0.0)
        self.trace: Optional[Trace] = None

    def _profiler(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm_up(self) -> None:
        """Start and stop the profiler once (its first start loads and
        initialises CUPTI, for seconds)."""
        prof = self._profiler()
        prof.start()
        torch.zeros(1, device=self.device).add_(1)
        self._sync()
        prof.stop()

    def start(self) -> None:
        self._sync()
        self.prof = self._profiler()
        self.prof.start()
        torch.zeros(8, device=self.device).add_(1)
        self._sync()
        time.sleep(GUARD_S)
        self.span = torch.profiler.record_function(SPAN)
        self.span.__enter__()
        self.t_host = (time.perf_counter(), 0.0)

    def done(self) -> bool:
        return time.perf_counter() - self.t_host[0] >= self.length_s

    def stop(self) -> None:
        self._sync()
        self.t_host = (self.t_host[0], time.perf_counter())
        self.span.__exit__(None, None, None)
        time.sleep(GUARD_S)
        self.prof.stop()

    def result(self) -> Optional[Trace]:
        """The trace, read once the window has closed (None if it never
        started)."""
        if self.trace is None and self.prof is not None:
            self.trace = read(self.prof, self.t_host[1] - self.t_host[0])
            self.prof = None
        return self.trace


def read(prof, window_s: float) -> Trace:
    """The trace of ``SPAN`` (``window_s``, the host's seconds of it, where
    the profiler holds no such span)."""
    from torch.autograd import DeviceType

    groups = cells.kernel_groups()
    res = prof.profiler.kineto_results
    dev, host, launches = [], [], []
    by_launch = collections.defaultdict(list)
    for e in res.events():
        start = e.start_ns()
        ev = Event(e.name(), start, start + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():  # a host span mirrored on the device's timeline, no device work
                continue
            ev.group = classify(ev.name, groups)
            dev.append(ev)
            by_launch[e.correlation_id()].append(ev)
        else:
            host.append(ev)
            if is_launch(ev.name) and e.correlation_id():
                launches.append((ev, e.correlation_id()))
    dev.sort(key=lambda e: e.start)
    span = [e for e in host if e.name == SPAN]
    if span:
        t_start, t_end = span[0].start, span[0].end
        window_s = (t_end - t_start) * 1e-9
    else:
        t_start = res.trace_start_ns()
        t_end = t_start + int(window_s * 1e9)
    inside = [(ev, i) for ev, i in launches if t_start <= ev.start <= t_end]
    graphs = [i for ev, i in inside if "Graph" in ev.name]
    replays = [[e.name for e in sorted(by_launch[i], key=lambda e: e.start)] for i in graphs if i in by_launch]
    lost = sum(1 for i in graphs if i not in by_launch) + partial_replays(replays)
    unrecorded = sum(1 for ev, i in inside if i not in by_launch) - sum(1 for i in graphs if i not in by_launch)
    return Trace(dev, host, t_start, t_end, window_s, len(inside), lost, unrecorded)


def partial_replays(replays: List[List[str]]) -> int:
    """Graph launches (each the names of its device records, in order) that
    hold a strict part of another's records and start or end as it does:
    the rest was lost."""
    sigs = {(r[0], r[-1], tuple(sorted(collections.Counter(r).items()))) for r in replays}
    full = [(a, b, collections.Counter(dict(c))) for a, b, c in sigs]

    def part(r: List[str]) -> bool:
        have = collections.Counter(r)
        return any((r[0] == a or r[-1] == b) and sum(c.values()) > len(r) and all(c[k] >= v for k, v in have.items())
                   for a, b, c in full)

    return sum(1 for r in replays if part(r))


def is_launch(name: str) -> bool:
    """A CUDA runtime or driver call that starts device work: a kernel or
    graph launch, a copy or a fill."""
    return (name.startswith("cu") and any(k in name for k in ("Launch", "Memcpy", "Memset"))
            and "HostFunc" not in name)

"""What a metric reader is handed, and how readers are found.

Each metric of ``BENCHMARK.json`` has a reader of its own,
``benchmark/metrics/<name>.py``, with ``read(run) -> float or None``. A
reader that finds nothing to read returns None and the metric is left out
of the line. ``Run`` holds the window's records and counters, the steps'
log and, in a ``--trace 1`` run, the trace.
"""
from __future__ import annotations

import dataclasses
import importlib.util
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np

from harness import cells, work
from harness.serve import Record, StepLog
from harness.trace import Trace


@dataclasses.dataclass
class Run:
    cell: cells.Cell
    window: dict  # serve.LoadRunner.window's result
    records: List[Record]
    steps: List[StepLog]
    trace: Optional[Trace]
    setup_s: float
    peaks: dict

    @property
    def arch(self) -> ModuleType:
        return self.cell.arch

    @property
    def vision(self) -> dict:
        return self.cell.config["vision"]

    @property
    def text(self) -> dict:
        return self.cell.config["text"]

    @property
    def engine(self) -> dict:
        return self.cell.settings["engine"]

    def sent_in_window(self) -> List[Record]:
        return [r for r in self.records if r.in_window]

    def window_steps(self) -> List[StepLog]:
        w = self.window
        return [s for s in self.steps if w["t0"] <= s.t0 < w["t_stop"]]

    def traced_steps(self) -> List[StepLog]:
        return [s for s in self.steps if s.traced]

    def counter(self, key: str) -> float:
        return self.window["stop"][key] - self.window["start"][key]

    def host_t(self, key: str) -> float:
        return self.window["stop"]["host_t"].get(key, 0.0) - self.window["start"]["host_t"].get(key, 0.0)

    def join_rows(self, join: tuple) -> Optional[int]:
        """Prompt positions of a join's real members (pad rows excluded)."""
        by_id = {r.req.id: r for r in self.records}
        members = [by_id.get(i) for i in join[1]]
        if any(m is None for m in members):
            return None
        return sum(m.positions for m in members)

    def ttft_ms(self) -> List[float]:
        return [(r.first_t - r.sent) * 1e3 for r in self.sent_in_window() if r.first_t is not None]

    def roofline(self, bound_s: float, group: str) -> Optional[float]:
        """Percent of the roofline: the least time of the work that the
        traced steps needed (from the shapes) over the device time of the
        group's kernels; None if the trace holds none of them."""
        if self.trace is None or not self.trace.count(group) or not bound_s:
            return None
        return 100.0 * bound_s / self.trace.group_s(group)


def percentile(values: List[float], q: float) -> Optional[float]:
    return float(np.percentile(values, q)) if values else None


def reader(name: str):
    path = cells.BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_all(run: Run, metrics: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


__all__ = ["Run", "percentile", "read_all", "reader", "work"]

"""Finds a cell and everything it names, by name, from data files.

- ``BENCHMARK.json`` at the checkout's root: the cell's configuration and
  traffic names, and which metrics it reports.
- ``benchmark/workloads/<cell>.json``: the engine's settings, the offered
  rate of an open loop, the sample and the limit of the output check.
- ``benchmark/configs/<config>.json``: the model's architecture
  (``"arch"``, a module of ``benchmark/archs/``), sizes and sources, how it
  is served (weight format, dtypes) and its control format.
- ``benchmark/traffic/<mix>.json``: the mix's parameters, read by the one
  generator in ``traffic.py``.
- ``benchmark/metrics/<metric>.py``: one reader a metric (``metrics.py``).
- ``benchmark/kernels/<group>.json``: kernel-name patterns of one group of
  device operations (``trace.py``): a list of patterns, each a list of
  substrings that a name holds all of.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

import archs

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_json() -> dict:
    return _load(ROOT / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict  # the BENCHMARK.json entry
    settings: dict  # workloads/<cell>.json
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<mix>.json
    end_to_end: List[dict]  # the BENCHMARK.json metrics this cell reports
    per_layer: List[dict]

    @property
    def arch(self) -> ModuleType:
        """The configuration's architecture (``archs/<arch>.py``)."""
        return archs.load(self.config)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict = None) -> Cell:
    bench = benchmark_json() if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(entries)})")
    w = entries[name]
    cell = Cell(
        name=name,
        workload=w,
        settings=_load(BENCH_DIR / "workloads" / f"{name}.json"),
        config=_load(BENCH_DIR / "configs" / f"{w['config']}.json"),
        traffic=_load(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )
    archs.load(cell.config)  # no architecture, or a missing one, is refused here
    return cell


def kernel_groups() -> Dict[str, List[List[str]]]:
    """{group: kernel-name patterns} from ``kernels/*.json``, in name order."""
    return {p.stem: _load(p)["match"] for p in sorted((BENCH_DIR / "kernels").glob("*.json"))}


def peaks() -> dict:
    return _load(BENCH_DIR / "peaks.json")

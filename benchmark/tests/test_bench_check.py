"""The output check at tiny widths on the CPU: a whole run (the engine, the
window, the drain, the sample, the reference) comes out correct; the
control (the reference in the configuration's control format in the
program's place) reads well above the program; and each fault planted in
the timed path underneath makes ``correct`` false.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import time

import pytest
import torch

import tiny  # noqa: I001  (puts the harness on the path first)
import run

CELLS = [("mistral7b-int8.docqa-open", "gqa4", "int8"),
         ("mistral7b-int8.extract-backlog", "gqa4", "int8"),
         ("mistral7b-int8.extract-backlog", "mha96", "bf16")]
SEEDS = (21, 2**31 + 77)


def _run(cell, seed: int) -> dict:
    return run.run_cell(cell, seed, 2.0, 0, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("name,layout,fmt", CELLS)
def test_a_sound_run_is_correct(name, layout, fmt):
    out = _run(tiny.tiny_cell(name, layout, fmt), SEEDS[0])
    assert out["correct"], out["checked"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checked"


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name,layout,fmt", CELLS)
def test_the_control_parts_from_the_program(name, layout, fmt, seed):
    """The control (the reference one precision lower in the program's
    place) judged as a run judges the program, at tiny widths: the sound
    program is correct, the control is not, and it reads three times the
    program or more."""
    cell = tiny.tiny_cell(name, layout, fmt)
    out = run.calibrate(cell, seed, 1, 2.0, torch.device("cpu"), time.perf_counter())
    assert (out["program_correct"], out["control_correct"]) == (1, 0), out
    assert out["control_gap_min"] >= max(3 * out["gap_max"], 0.05), out


@pytest.mark.parametrize("name,layout,fmt", CELLS[:2])
def test_the_traced_stretch_follows_the_window(name, layout, fmt):
    """A traced run's window is an untraced run's: no step of it is traced,
    the profiler's steps come after it under the same load, and requests
    sent past it are followed but are not the window's."""
    from harness.trace import Tracer

    cell = tiny.tiny_cell(name, layout, fmt)
    dev = torch.device("cpu")
    model, engine, pool = run.set_up(cell, SEEDS[0], dev, run.Stages(time.perf_counter()))
    load, window = run.serve_window(cell, engine, model, pool, SEEDS[0], 1.5, Tracer(0.5, dev))
    t_stop = window["t_stop"]
    traced = [s for s in load.steps if s.traced]
    assert traced and all(s.t0 > t_stop for s in traced)
    assert not any(s.traced for s in load.steps if s.t0 < t_stop)
    assert all(r.sent <= t_stop for r in load.records if r.in_window)
    assert any(not r.in_window and r.sent > t_stop for r in load.records)
    assert all(r.at_stop == 0 for r in load.records if not r.in_window)
    engine.close()


def _token_plus_one(monkeypatch):
    from paligemma_tpu_torch import continuous

    greedy = continuous.greedy
    monkeypatch.setattr(continuous, "greedy", lambda logits: (greedy(logits) + 1) % logits.shape[-1])


def _step_unchanged(monkeypatch):
    from paligemma_tpu_torch import continuous

    monkeypatch.setattr(continuous, "_slot_decode_step", lambda *a, **k: None)


def _half_the_join_left_out(monkeypatch):
    from paligemma_tpu_torch import continuous

    insert = continuous._insert_group

    def half(full, temp_kv, slots, *args, **kwargs):
        g = temp_kv[0].shape[1]
        kept = [t.clone() for t in temp_kv]
        for t in kept:
            t[:, g // 2:] = 0
        return insert(full, kept, slots, *args, **kwargs)

    monkeypatch.setattr(continuous, "_insert_group", half)


def _cache_writes_dropped(monkeypatch):
    from paligemma_tpu_torch.models import gemma

    monkeypatch.setattr(gemma, "_write", lambda *a, **k: None)


@pytest.mark.parametrize("fault", [_token_plus_one, _step_unchanged, _half_the_join_left_out,
                                   _cache_writes_dropped])
@pytest.mark.parametrize("name,layout,fmt", CELLS[:1] + CELLS[2:])
def test_a_fault_underneath_makes_the_run_incorrect(name, layout, fmt, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(tiny.tiny_cell(name, layout, fmt), SEEDS[1])
    assert not out["correct"], out["checked"]

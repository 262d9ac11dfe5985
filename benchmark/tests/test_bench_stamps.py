"""CPU tests of the readers of the engine's own request stamps
(``harness/stamps.py``) and of cell 1's slot occupancy, on synthetic
records and steps.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import types

import pytest

import tiny  # noqa: F401  (puts the harness on the path)
from harness import cells, metrics, stamps
from harness.serve import Record, StepLog

CELL = "mistral7b-int8.docqa-open"
MS = 1_000_000  # ns


def _record(sent_s, in_window=True, **stamp_ms):
    req = types.SimpleNamespace(**{k: None if v is None else int(v * MS) for k, v in stamp_ms.items()})
    return Record(spec=None, positions=0, sent=sent_s, req=req, in_window=in_window)


def _run(records, t_stop=60.0, steps=()):
    return metrics.Run(cells.load_cell(CELL), {"t0": 0.0, "t_stop": t_stop}, records, list(steps), None, 0.0,
                       cells.peaks())


def _stamped(sent_s, queue, join, hold, **kw):
    t = sent_s * 1e3
    return _record(sent_s, t_submit=t, t_taken=t + queue, t_joined=t + queue + join,
                   t_first=t + queue + join + hold, **kw)


@pytest.mark.parametrize("name, want", [("engine.queue_wait_ms", 450.0), ("engine.first_token_hold_ms", 6000.0)])
def test_request_readers_take_the_window_requests_by_their_send(name, want):
    """The set is the window's requests sent ``MARGIN_S`` or more before
    its close, whatever their outcome: one served after the close (behind
    the profiler's start in a traced run) counts; one sent past the window
    or within the margin does not, however it fared."""
    records = [
        _stamped(1.0, 400, 10, 2000),
        _stamped(30.0, 500, 20, 2000),
        _stamped(54.0, 450, 10, 14000),  # sent 6 s before the close, served 18 s after it
        _stamped(56.0, 100, 10, 500),  # within the margin: left out though served at once
        _stamped(10.0, 1, 1, 1, in_window=False),  # not a request of the window
    ]
    assert metrics.reader(name)(_run(records)) == pytest.approx(want)


def test_queue_join_and_hold_add_up_to_the_time_to_the_first_token():
    records = [_stamped(1.0 + i, 100 * i, 5 + i, 900 + 50 * i) for i in range(20)]
    picked = stamps.requests(_run(records, t_stop=20.0))
    assert len(picked) == 15  # sent at 1..15 s, the margin starts at 15 s
    terms = [stamps.mean(stamps.request_ms(picked, a, b)) for a, b in
             (("t_submit", "t_taken"), ("t_taken", "t_joined"), ("t_joined", "t_first"))]
    assert sum(terms) == pytest.approx(stamps.mean(stamps.request_ms(picked, "t_submit", "t_first")))
    assert stamps.request_ms(picked[:2], "t_taken", "t_joined") == pytest.approx([5.0, 6.0])


@pytest.mark.parametrize("records", [
    [],
    [Record(spec=None, positions=0, sent=1.0, req=types.SimpleNamespace())],  # an engine without stamps
    [_record(1.0, t_submit=0.0, t_taken=None, t_joined=None, t_first=None)],  # never served
], ids=["no_requests", "no_stamps", "no_first_token"])
def test_request_readers_read_none_where_nothing_is_stamped(records):
    run = _run(records)
    assert metrics.reader("engine.queue_wait_ms")(run) is None
    assert metrics.reader("engine.first_token_hold_ms")(run) is None


def test_slot_occupancy_reads_the_window_steps():
    n = cells.load_cell(CELL).settings["engine"]["n_slots"]
    steps = [StepLog(t0, t0 + 1.0, occ, [], []) for t0, occ in ((1.0, n), (2.0, n // 2), (70.0, 0))]
    run = _run([], steps=steps)
    assert metrics.reader("engine.slot_occupancy")(run) == pytest.approx(75.0)
    assert metrics.reader("engine.slot_occupancy")(run) == metrics.reader("engine.occupancy")(run)
    assert metrics.reader("engine.slot_occupancy")(_run([])) is None

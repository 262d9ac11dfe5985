"""CPU tests of cell 1's join readers on a synthetic run:
``engine.join_pad_share`` over the window's joins and ``step.join_ms.open``
against ``step.join_ms`` on one trace.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import pytest

import tiny  # noqa: F401  (puts the harness on the path)
from harness import cells, metrics
from harness.serve import StepLog
from harness.trace import Event, Trace

CELL = "mistral7b-int8.docqa-open"


def _run(steps=(), trace=None):
    return metrics.Run(cells.load_cell(CELL), {"t0": 0.0, "t_stop": 60.0}, [], list(steps), trace, 0.0,
                       cells.peaks())


def test_join_pad_share_reads_the_window_joins():
    steps = [StepLog(1.0, 2.0, 8, [], [(32, tuple(range(8)))]),
             StepLog(2.0, 3.0, 13, [], [(8, tuple(range(8, 13)))]),
             StepLog(3.0, 4.0, 13, [], []),
             StepLog(70.0, 71.0, 2, [], [(32, (20, 21))])]  # after the window's close
    assert metrics.reader("engine.join_pad_share")(_run(steps)) == pytest.approx(100.0 * 27 / 40)
    assert metrics.reader("engine.join_pad_share")(_run(steps[2:])) is None


def test_join_ms_open_is_join_ms_on_the_same_trace():
    dev = [Event("Memcpy DtoH", 0, 2, "token_fetch"), Event("flash", 3, 10, "flash_attention"),
           Event("gemm", 10, 40, "q8_gemm"), Event("dec", 41, 45, "decode_attention"),
           Event("Memcpy DtoH", 50, 51, "token_fetch"), Event("flash", 52, 60, "flash_attention"),
           Event("dec", 61, 62, "decode_attention")]
    run = _run(trace=Trace(dev, [], 0, 70, 70e-9))
    got = metrics.reader("step.join_ms.open")(run)
    assert got == metrics.reader("step.join_ms")(run) == pytest.approx((37 + 8) * 1e-6 / 2)
    assert metrics.reader("step.join_ms.open")(_run()) is None

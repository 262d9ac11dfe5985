"""The engine's own stamps of each request's way to its first token, as
the harness reads them.

``continuous.Request`` stamps ``t_submit`` (``submit()``), ``t_taken``
(taken into a join group), ``t_joined`` (its join's prefill and insert
enqueued) and ``t_first`` (its first token held by the engine's thread),
on ``time.perf_counter_ns``. Over one set of requests the means of queue
(submit to taken), join (taken to joined) and hold (joined to first) add
up to the mean of the program's time to the first token.

The set is chosen by the schedule alone, not by how the program did: the
window's requests sent at least ``MARGIN_S`` before its close
(``requests``). After the close a ``--trace 1`` run starts the profiler for
the first time, which stalls the steps for seconds; a request sent within
the margin would read that stall. One of the set not served by the close
reads it too, and stays in the set.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

MARGIN_S = 5.0  # about five steps of the docqa cell, over its longest time to a first token


def requests(run) -> List:
    """The window's records sent at least ``MARGIN_S`` before its close
    whose request the engine stamped a first token for."""
    until = run.window["t_stop"] - MARGIN_S
    return [r for r in run.sent_in_window()
            if r.sent <= until and getattr(r.req, "t_first", None) is not None]


def request_ms(records: Sequence, start: str, end: str) -> List[float]:
    """Each record's milliseconds from its request's stamp ``start`` to its
    stamp ``end`` (records missing either are left out)."""
    out = []
    for r in records:
        a, b = getattr(r.req, start, None), getattr(r.req, end, None)
        if a is not None and b is not None:
            out.append((b - a) * 1e-6)
    return out


def mean(values: Sequence[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None

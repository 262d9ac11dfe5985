"""The system under test and the window that drives it.

The model is the port's, built by the configuration's architecture
(``archs/<arch>.py``'s ``build_model``) over the benchmark's weights
(``weights.py``) in the configuration's serving format. The engine is the
port's ``ContinuousBatcher``, the engine behind ``server_torch.py
--continuous``, built with the cell's settings; ``prepare()`` runs in
set-up. In the window requests enter
through ``submit()`` from a thread of the harness's own (an open loop's at
their scheduled times, a closed loop's as soon as the driving thread sees a
caller's last request complete) and ``step()`` runs on the driving thread.
A ``--trace 1`` run profiles a stretch after the window, under the same
load, so that everything read on the host clock reads the window exactly
as an untraced run does.

The harness reads only the engine's public state: ``slot_req``,
``host_lengths``, ``pending``, and its counters (``tokens_delivered``,
``chunks_run``, ``join_groups``, ``join_log``, ``host_t``).
"""
from __future__ import annotations

import dataclasses
import gc
import itertools
import math
import queue
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

import archs
from harness import traffic

IDLE_WAIT_S = 0.002
FIRST_TOKEN_WAIT_S = 30.0  # at most, before a traced stretch: see LoadRunner.window


def build_model(config: dict, W: Dict[str, torch.Tensor]):
    """(port model, processor) over the tensors of ``W``: the architecture's."""
    return archs.load(config).build_model(config, W)


def build_engine(model, proc, config: dict, settings: dict, seed: int, n_img: int):
    from paligemma_tpu_torch.continuous import ContinuousBatcher

    e = settings["engine"]
    return ContinuousBatcher(
        model, proc, n_slots=e["n_slots"], chunk=e["chunk"], prompt_budget=[n_img + e["text_bucket"]],
        max_new_tokens=e["max_new_tokens"], kv_window=e["kv_window"], prefetch=e["prefetch"],
        prefill_cache_size=e["prefill_cache"],
        # An id no vocab row has: nothing but a request's budget ends it.
        eos_token_id=config["text"]["vocab_size"], seed=int(seed),
    )


@dataclasses.dataclass(eq=False)
class Record:
    spec: traffic.Spec
    positions: int  # prompt positions: image tokens, BOS, text, "\n"
    sent: float  # the scheduled send (open loop) or the submit (closed)
    req: object = None
    submitted: float = 0.0
    first_t: Optional[float] = None
    last_t: Optional[float] = None
    done_t: Optional[float] = None
    seen: int = 0
    at_start: int = 0  # tokens held when the window opened
    at_stop: Optional[int] = None  # tokens held when the window closed
    in_window: bool = True  # sent while the window was open


@dataclasses.dataclass
class StepLog:
    t0: float
    t1: float
    occupied: int  # slots the step's chunk ran for a request
    lengths: List[int]  # the occupied slots' host lengths before the step
    joins: List[tuple]  # (group batch, member request ids) of the step's joins
    traced: bool = False


def counters(engine) -> dict:
    return {"tokens": engine.tokens_delivered, "chunks": engine.chunks_run, "joins": engine.join_groups,
            "host_t": dict(engine.host_t)}


class LoadRunner:
    """Sends a cell's requests, steps the engine and records each request's
    host times (the times the driving thread holds its tokens)."""

    def __init__(self, engine, mix: dict, specs: List[traffic.Spec], pool: np.ndarray, n_img: int,
                 annotate: Callable = None):
        self.engine, self.mix, self.specs, self.pool, self.n_img = engine, mix, specs, pool, n_img
        self.records: List[Record] = []
        self.active: List[Record] = []
        self.incoming: "queue.SimpleQueue[Record]" = queue.SimpleQueue()
        self.next_spec = 0
        self.issuing = True
        # A closed loop's callers due to send again (the time each saw its
        # last request complete), or None to stop.
        self.due: "queue.SimpleQueue" = queue.SimpleQueue()
        self.steps: List[StepLog] = []
        self.annotate = annotate
        self.late_s: List[float] = []
        self.closed_at = math.inf  # the window's close, once it has closed

    def _submit(self, spec: traffic.Spec, sent: float, in_window: bool = True) -> Record:
        img = traffic.image(self.pool, spec)
        rec = Record(spec, self.n_img + len(spec.prompt.encode()) + 2, sent, in_window=in_window)
        rec.submitted = time.perf_counter()
        rec.req = self.engine.submit(spec.prompt, img, max_new_tokens=spec.max_new)
        self.incoming.put(rec)
        return rec

    def _send_next(self, now: float) -> None:
        spec = self.specs[self.next_spec % len(self.specs)]
        self.next_spec += 1
        # A completion seen before the window closed is a request of the window.
        self._submit(spec, now, in_window=now <= self.closed_at)

    def _send_open(self, t0: float, period: float, t_end: float) -> None:
        """The schedule, from ``t0``, until ``t_end``: past the window (a
        traced stretch) it starts again, ``period`` later each time."""
        for cycle in itertools.count():
            for spec in self.specs:
                due = t0 + cycle * period + spec.arrival
                if due >= t_end or not self.issuing:
                    return
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                if not self.issuing:
                    return
                rec = self._submit(spec, due, in_window=cycle == 0)
                if cycle == 0:
                    self.late_s.append(rec.submitted - due)

    def _send_closed(self) -> None:
        """A closed loop's callers: each completion the driving thread sees
        is its caller sending the next request, from this thread, as a
        server's handler threads would take it."""
        while True:
            now = self.due.get()
            if now is None:
                return
            if self.issuing:
                self._send_next(now)

    def _take_incoming(self) -> None:
        while True:
            try:
                rec = self.incoming.get_nowait()
            except queue.Empty:
                return
            if self.closed_at != math.inf:
                rec.at_stop = rec.seen
            self.records.append(rec)
            self.active.append(rec)

    def _poll(self, now: float) -> int:
        """Take up the requests' new tokens; returns how many finished."""
        still, finished = [], 0
        for rec in self.active:
            n = len(rec.req.tokens)
            if n > rec.seen:
                if rec.first_t is None:
                    rec.first_t = now
                rec.last_t, rec.seen = now, n
            if rec.req.done:
                rec.done_t = now
                finished += 1
                if self.mix["loop"] == "closed" and self.issuing:
                    self.due.put(now)
            else:
                still.append(rec)
        self.active = still
        self._take_incoming()
        return finished

    def _step(self, traced: bool) -> bool:
        eng = self.engine
        occ = [i for i, r in enumerate(eng.slot_req) if r is not None]
        lengths = [int(eng.host_lengths[i]) for i in occ]
        joins_before = eng.join_groups
        t0 = time.perf_counter()
        if traced and self.annotate is not None:
            with self.annotate("engine.step"):
                did = eng.step()
        else:
            did = eng.step()
        t1 = time.perf_counter()
        new = eng.join_groups - joins_before
        joins = list(eng.join_log)[-new:] if new else []
        finished = self._poll(t1)
        if did:
            # A step that starts with every slot free joins first and runs
            # its chunk on the joiners: they are those still in a slot and
            # those the chunk finished.
            n = len(occ) if occ else sum(r is not None for r in eng.slot_req) + finished
            self.steps.append(StepLog(t0, t1, n, lengths, joins, traced))
        return did

    def _serve(self, traced: bool = False) -> None:
        """One step, or a short wait where there is nothing to step."""
        if not self._step(traced):
            time.sleep(IDLE_WAIT_S)
            self._poll(time.perf_counter())

    def window(self, seconds: float, tracer=None) -> dict:
        """Run the window: send, step, record. Returns the window's times and
        counters. With ``tracer`` (``trace.Tracer``) the load goes on past
        the window: through the profiler's first start, untraced until every
        request sent in the window holds its first token (at most
        ``FIRST_TOKEN_WAIT_S``), then for the tracer's stretch with the
        profiler on; requests sent past the window are followed but are not
        the window's."""
        eng = self.engine
        self._take_incoming()
        for rec in self.records:
            rec.in_window = False
        t0 = time.perf_counter()
        t_end = t0 + seconds
        start = counters(eng)
        if self.mix["loop"] == "open":
            sender = threading.Thread(target=self._send_open, args=(t0, seconds, t_end if tracer is None else math.inf),
                                      daemon=True, name="bench-open-loop")
            sender.start()
        else:
            for _ in range(self.mix["clients"]):
                self._send_next(t0)
            sender = threading.Thread(target=self._send_closed, daemon=True, name="bench-closed-loop")
            sender.start()
        self._take_incoming()
        for rec in self.records:
            rec.at_start = rec.seen
        while time.perf_counter() < t_end:
            self._serve()
        t_stop = time.perf_counter()
        stop = counters(eng)
        self.closed_at = t_stop
        for rec in self.records:
            rec.at_stop = rec.seen
        self._take_incoming()
        if tracer is not None:
            # Not in set-up: once the profiler has run in a process that
            # replays CUDA graphs, its callbacks stay (torch keeps CUPTI up)
            # and add host time to every launch after it.
            tracer.warm_up()
            deadline = time.perf_counter() + FIRST_TOKEN_WAIT_S
            while (any(r.in_window and r.first_t is None for r in self.active)
                   and time.perf_counter() < deadline):
                self._serve()
            tracer.start()
            while not tracer.done():
                self._serve(traced=True)
            tracer.stop()
        self.issuing = False
        self.due.put(None)
        sender.join(timeout=60)
        self._take_incoming()
        return {"t0": t0, "t_stop": t_stop, "seconds": t_stop - t0, "start": start, "stop": stop}

    def drain(self, limit_s: float) -> float:
        """Step until every request sent so far is done, for at most
        ``limit_s``; returns the seconds it took."""
        t0 = time.perf_counter()
        while self.active and time.perf_counter() - t0 < limit_s:
            self._serve()
        return time.perf_counter() - t0


def warm_up(engine, mix: dict, seed: int, pool: np.ndarray, n_img: int) -> None:
    """A group join (at ``n_slots``) and a lone join (at 1), each run to
    its end: every graph replayed and every eager path of a join taken once
    before the window."""
    specs = traffic.make_specs(mix, seed, 3)
    for spec in specs:
        spec.max_new = 2
    d = LoadRunner(engine, {"loop": "warm"}, specs, pool, n_img)
    for group in (specs[:2], specs[2:]):
        for spec in group:
            d._submit(spec, time.perf_counter())
        d._take_incoming()
        while d.active:
            d._serve()


def free() -> None:
    """Give back the memory of what the caller has dropped."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

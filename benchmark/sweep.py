#!/usr/bin/env python3
"""Finds an open-loop cell's knee: the highest offered rate at which the
backlog does not grow over a window.

    python3 benchmark/sweep.py --workload <cell> --seed <n> --seconds <s> --rates 10,14,18,...

Sets the cell up once (as ``run.py`` does), then for each rate in turn
runs a window of the cell's traffic at that rate and its drain, and
prints one JSON line a rate: ``ttft_p95_ms``, ``output_tokens_per_s``,
the requests waiting for their first token at the window's end, and the
mean number waiting for it over the window's first and second halves.
Where the second half's is well above the first's, the backlog grows: the
rate is past the knee. The knee, once found, is
written into the cell's file by hand (``rate_per_s`` = 0.8 x knee).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import run  # noqa: I001  (puts the harness and the port on the path)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True, help="comma-separated offered rates, req/s")
    args = p.parse_args(argv)
    import numpy as np
    import torch

    from harness import cells, metrics

    cell = cells.load_cell(args.workload)
    if cell.traffic["loop"] != "open":
        raise SystemExit("a knee is swept on an open loop")
    if not torch.cuda.is_available():
        run.log("needs a CUDA device")
        return 2
    device = torch.device("cuda", 0)
    run.log(f"card: {run.power_limit()}")
    model, engine, pool = run.set_up(cell, args.seed, device, run.Stages(time.perf_counter()))
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        cell.settings["rate_per_s"] = rate
        seed = args.seed + 1 + i
        load, window = run.serve_window(cell, engine, model, pool, seed, args.seconds)
        r = metrics.Run(cell, window, load.records, load.steps, None, 0.0, cells.peaks())
        half = window["t0"] + window["seconds"] / 2
        queue = {True: [], False: []}  # at each step's start: sent, first token not yet held
        for s in r.window_steps():
            waiting = sum(1 for rec in load.records
                          if rec.sent <= s.t0 and (rec.first_t is None or rec.first_t > s.t0))
            queue[s.t0 < half].append(waiting)
        line = {"rate_per_s": rate, "seed": seed,
                "ttft_p95_ms": metrics.reader("ttft_p95_ms")(r),
                "output_tokens_per_s": metrics.reader("output_tokens_per_s")(r),
                "waiting_at_end": sum(1 for rec in load.records if rec.in_window and not rec.at_stop),
                "queue_first_half": float(np.mean(queue[True])) if queue[True] else None,
                "queue_second_half": float(np.mean(queue[False])) if queue[False] else None,
                "drain_s": window["drain_s"], "attempted": run.counts(load.records)[0],
                "failed": run.counts(load.records)[1]}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

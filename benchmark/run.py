#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (``paligemma_tpu_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the CUDA card: the port's
continuous-batching engine (``ContinuousBatcher``, the engine of
``server_torch.py --continuous``) over a model made on the card from the
seed, driven by the cell's traffic for ``--seconds``, then the served
tokens checked against the plain reference in ``benchmark/reference/``.
Prints the set-up's stages and each number compared beside its limit on
standard error, and one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and ``checked`` last. Exits 2 without enough CUDA devices,
3 if JAX or the JAX package was loaded and 4 if the trace lost graph
launches' records,
printing no result in each case.

``--calibrate N`` (not a run of the benchmark): reads the output check's
two readings over N seeds from ``--seed`` on in one process (the weights
made again in place for each seed): the program's widest gap and the
control's, the reference in the configuration's control format put in the
program's place, each judged against the cell's limit as a run judges the
program. Prints one JSON line a seed and a summary.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# The harness's own packages, and the checkout's root, where the port lives.
BENCH_DIR = Path(__file__).resolve().parent
for _p in (BENCH_DIR.parent, BENCH_DIR):
    sys.path.insert(0, str(_p))

BANNED = ("jax", "jaxlib", "flax", "paligemma_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--calibrate", type=int, default=0, help="read the check's readings over N seeds")
    return p.parse_args(argv)


def banned_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(BANNED))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


class Stages:
    """Set-up seconds by stage, on the host clock."""

    def __init__(self, t0: float):
        self.t = t0
        self.stages = {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.stages[name] = now - self.t
        self.t = now


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def set_up(cell, seed: int, device, stages: Stages):
    """The model, the engine (prepared and warmed up) and the noise pool."""
    import torch

    from harness import serve, traffic, weights

    if device.type == "cuda":
        from paligemma_tpu_torch.ops import _build

        _build.load_library()
    stages("kernels")
    cfg = cell.config
    W = weights.make_weights(cfg, seed, device)
    _sync(device)
    stages("weights")
    model, proc = serve.build_model(cfg, W)
    del W
    serve.free()
    stages("model")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    n_img = cell.arch.n_image_tokens(cfg)
    engine = serve.build_engine(model, proc, cfg, cell.settings, seed, n_img)
    stages("engine")
    engine.prepare()
    stages("prepare")
    pool = traffic.noise_pool(seed)
    serve.warm_up(engine, cell.traffic, seed + 7, pool, n_img)
    _sync(device)
    stages("warm_up")
    return model, engine, pool


def make_specs(cell, seed: int, seconds: float):
    from harness import traffic

    mix = cell.traffic
    if mix["loop"] == "open":
        return traffic.open_loop(mix, seed, cell.settings["rate_per_s"], seconds)
    return traffic.closed_loop(mix, seed, cell.settings["engine"]["n_slots"])


def serve_window(cell, engine, model, pool, seed: int, seconds: float, tracer=None):
    """The window and its drain: (the load runner, the window)."""
    from harness import serve

    annotate = None
    if tracer is not None:
        import torch

        annotate = torch.profiler.record_function
    n_img = cell.arch.n_image_tokens(cell.config)
    load = serve.LoadRunner(engine, cell.traffic, make_specs(cell, seed, seconds), pool, n_img, annotate)
    window = load.window(seconds, tracer)
    window["drain_s"] = load.drain(cell.settings["drain_s"])
    if load.late_s:
        window["late_ms_max"] = max(load.late_s) * 1e3
    return load, window


def counts(records) -> tuple:
    sent = [r for r in records if r.in_window]
    failed = sum(1 for r in sent if r.done_t is None or r.req.error is not None)
    return len(sent), failed


def judge(gap, failed: int, limit: float) -> bool:
    """Whether a run is correct: every request of the window done, and the
    widest gap of the sample within the cell's limit."""
    return gap is not None and failed == 0 and gap <= limit


def log_window(run) -> None:
    """The engine's host seconds by part, a chunk, and what the trace holds."""
    chunks = max(1, run.counter("chunks"))
    keys = sorted(run.window["stop"]["host_t"])
    log(f"chunks {run.counter('chunks')}, joins {run.counter('joins')}; host ms a chunk: "
        + ", ".join(f"{k} {1e3 * run.host_t(k) / chunks:.2f}" for k in keys))
    if run.trace is not None:
        groups = sorted({e.group for e in run.trace.device if e.group})
        log("trace: " + ", ".join(f"{g} {run.trace.count(g)} launches {run.trace.group_s(g):.6f} s"
                                  for g in groups)
            + f"; {len(run.traced_steps())} steps (rows, mean length): "
            + str([(len(s.lengths), round(sum(s.lengths) / max(1, len(s.lengths)))) for s in run.traced_steps()])
            + ", joins "
            + str([j[0] for s in run.traced_steps() for j in s.joins])
            + "; join segments ms " + str([round(sum(e.end - e.start for e in seg) * 1e-6, 3)
                                           for seg in run.trace.join_segments()])
            + f"; {run.trace.launches} launches, graph launches lost {run.trace.lost}, eager launches with no"
            f" device record {run.trace.unrecorded}")


def run_cell(cell, seed: int, seconds: float, trace: int, device, t_start: float) -> dict:
    """One run of a cell on ``device``: the result's fields."""
    import torch

    from harness import check, cells, metrics, serve, weights
    from harness.trace import Tracer

    stages = Stages(t_start)
    model, engine, pool = set_up(cell, seed, device, stages)
    tracer = Tracer(cell.settings["trace"]["length_s"], device) if trace else None
    setup_s = time.perf_counter() - t_start
    log("setup_s by stage: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.stages.items())
        + f" (total {setup_s:.3f})")

    load, window = serve_window(cell, engine, model, pool, seed, seconds, tracer)
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    attempted, failed = counts(load.records)
    run = metrics.Run(cell, window, load.records, load.steps, tracer.result() if tracer else None, setup_s,
                      cells.peaks())
    values = metrics.read_all(run, cell.per_layer if trace else cell.end_to_end)
    log(f"window {window['seconds']:.3f} s, drain {window['drain_s']:.3f} s, attempted {attempted}, "
        f"failed {failed}, generator late by at most {window.get('late_ms_max', 0.0):.1f} ms")
    log_window(run)

    picked = check.sample(load.records, seed, cell.settings["check"])
    engine.close()
    load.engine = None
    del engine, model, load
    serve.free()
    t_check = time.perf_counter()
    W = weights.make_weights(cell.config, seed, device)
    verdict = check.verdict(W, cell.config, picked, pool, device) if picked else {"gap": None}
    del W
    log(f"check: {verdict} in {time.perf_counter() - t_check:.3f} s")
    limit = cell.settings["check"]["limit"]
    checked = {
        "widest_gap": {"value": verdict["gap"], "limit": limit},
        "failed_requests": {"value": failed, "limit": 0},
    }
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": judge(verdict["gap"], failed, limit),
           "attempted": attempted, "failed": failed, "metrics": values, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
        out["lost_records"] = run.trace.lost
    out["checked"] = checked
    return out


def calibrate(cell, seed: int, n: int, seconds: float, device, t_start: float) -> dict:
    """The check's readings over ``n`` seeds in one process."""
    import torch

    from harness import check, serve, traffic, weights

    stages = Stages(t_start)
    model, engine, pool = set_up(cell, seed, device, stages)
    cfg = cell.config
    control = cfg["control"]
    limit = cell.settings["check"]["limit"]
    rows = []
    for s in range(seed, seed + n):
        W = weights.make_weights(cfg, s, device)
        fresh, _ = serve.build_model(cfg, dict(W))
        with torch.no_grad():
            mine = model.state_dict()
            for name, t in fresh.state_dict().items():
                if mine[name].data_ptr() != t.data_ptr():
                    mine[name].copy_(t)
        del fresh
        serve.free()
        pool = traffic.noise_pool(s)
        load, window = serve_window(cell, engine, model, pool, s, seconds)
        attempted, failed = counts(load.records)
        picked = check.sample(load.records, s, cell.settings["check"])
        verdict = check.verdict(W, cfg, picked, pool, device, control=control)
        row = {"seed": s, **verdict, "attempted": attempted, "failed": failed,
               "served_max": max((len(r.req.tokens) for r in picked), default=0),
               "correct": judge(verdict["gap"], failed, limit),
               "control_correct": judge(verdict["control_gap"], failed, limit)}
        log(json.dumps(row))
        rows.append(row)
        del W, load
        serve.free()
    gaps = [r["gap"] for r in rows]
    ctl = [r["control_gap"] for r in rows]
    return {"workload": cell.name, "control": control, "seeds": [seed, seed + n - 1], "rows": rows,
            "gap_max": max(gaps), "control_gap_min": min(ctl), "limit": limit,
            "program_correct": sum(r["correct"] for r in rows),
            "control_correct": sum(r["control_correct"] for r in rows),
            "card": power_limit()}


def main(argv=None) -> int:
    args = parse(argv)
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from harness import cells

    cell = cells.load_cell(args.workload)
    need = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"needs {need} CUDA device(s); found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda", 0)
    log(f"card: {power_limit()}")
    if args.calibrate:
        result = calibrate(cell, args.seed, args.calibrate, args.seconds, device, T_START)
    else:
        result = run_cell(cell, args.seed, args.seconds, args.trace, device, T_START)
    found = banned_modules()
    if found:
        log(f"modules of JAX or of the JAX package were loaded: {found}")
        return 3
    lost = result.pop("lost_records", 0)
    if lost:
        log(f"the trace lost the device records of {lost} launches: its readings would count work it does not time")
        return 4
    if not args.calibrate:
        for name, c in result["checked"].items():
            log(f"checked {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

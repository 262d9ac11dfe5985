#!/usr/bin/env python3
"""What the first call of a prompt shape costs in ``generation.prefill``,
and whether capturing its CUDA graph with ``CUDAGraph.capture_begin`` /
``capture_end`` directly costs less than under ``torch.cuda.graph``, timed in
turns on one CUDA card.

    python3 scripts/prefill_capture.py [--turns N] [--out PATH.json]

PaliGemma-3B-224 with seeded random weights made on the card and request 0
of ``chip_smoke.py``, in bf16 and in chip_smoke's int8 and int8 +
prefill_a8 arms, each prefill into a new cache of ``generate``'s shape. Per
turn (host ms, ``torch.cuda.synchronize()`` at the end of each):

- ``eager``: ``models/paligemma.prefill`` issued launch by launch;
- ``port``: ``generation.prepare_prefill``, the port's capture (the eager
  prefill on a side stream, then ``torch.cuda.graph``, which first
  synchronizes and empties the allocator's cache);
- ``direct``: the same warm-up, then the same function captured between
  ``capture_begin`` and ``capture_end`` on a side stream, the allocator's
  cache left as it is; the graph is replayed and must give ``port``'s
  logits bit for bit;
- the cost of ``torch.cuda.empty_cache()`` alone, right after ``eager``.

Turns alternate the order of ``port`` and ``direct``. Prints one line per
arm and the whole result as one JSON line. Needs a CUDA device; exits 2
without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

ARMS = ("bf16", "int8", "int8+prefill_a8")


def direct_capture(torch, model, ids, pix, cache):
    """``generation._prefill`` on static copies of the inputs: warm-up on a
    side stream, then captured with ``capture_begin`` / ``capture_end``
    directly; (graph, static logits, host ms)."""
    from paligemma_tpu_torch import generation
    from paligemma_tpu_torch.ops.kernels import KERNELS

    t0 = time.perf_counter()
    ids_s, pix_s = ids.clone(), pix.clone()

    def run():
        cache.host_length = 0
        return generation._prefill(model, ids_s, pix_s, cache, KERNELS)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        try:
            logits = run()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    return graph, logits, (time.perf_counter() - t0) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--out", default=None, help="also write the JSON result to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("prefill_capture: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from paligemma_tpu_torch import generation, quantization
    from paligemma_tpu_torch.models import gemma, paligemma

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cfg, _, proc, model = chip_smoke.build_model(torch)
    ids, pix = chip_smoke._request(torch, proc, 0)
    t = ids.shape[1]
    length = -(-(t + chip_smoke.MAX_NEW_TOKENS) // generation.CACHE_LENGTH_STEP) * generation.CACHE_LENGTH_STEP
    arms = {name: (qargs, kv) for name, qargs, kv in [("bf16", None, False)] + chip_smoke.QUANT_ARMS}
    result = {"device": smi, "prompt_len": int(t), "cache_len": length, "arms": {}}
    for name in ARMS:
        qargs, kv_int8 = arms[name]
        m = model if qargs is None else quantization.quantize_params(model, llm_only=True, **qargs)
        cache_dtype = torch.int8 if kv_int8 else None

        def fresh():
            return generation.make_cache(m, 1, t, length - t, cache_dtype)

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        timed(lambda: paligemma.prefill(m, ids, pix, fresh(), full_logits=False))  # first loads
        rows = []
        for turn in range(args.turns):
            row = {}
            (ref, _), row["eager"] = timed(lambda: paligemma.prefill(m, ids, pix, fresh(), full_logits=False))
            _, row["empty_cache"] = timed(torch.cuda.empty_cache)
            order = ("port", "direct") if turn % 2 == 0 else ("direct", "port")
            for way in order:
                cache = fresh()
                if way == "port":
                    row["port"] = generation.prepare_prefill(m, cache, ids.shape, pix.shape)
                    logits, _ = generation.prefill(m, ids, pix, cache)
                else:
                    graph, static, row["direct"] = direct_capture(torch, m, ids, pix, cache)
                    gemma.reset_cache(cache)
                    graph.replay()
                    logits = static.clone()
                torch.cuda.synchronize()
                if not torch.equal(logits, ref):
                    raise RuntimeError(f"{name}: the {way} capture's replay differs from the eager prefill")
                del cache
            rows.append(row)
        best = {k: min(r[k] for r in rows) for k in rows[0]}
        result["arms"][name] = {"turns": rows, "best": best}
        print(f"[{name}] host ms, best of {args.turns} turns: eager prefill {best['eager']:.2f} | first call "
              f"through the port (warm-up prefill + torch.cuda.graph capture) {best['port']:.2f} | warm-up + "
              f"capture_begin/capture_end {best['direct']:.2f} | empty_cache alone {best['empty_cache']:.2f} | "
              f"turns {rows}", flush=True)
        if m is not model:
            del m
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

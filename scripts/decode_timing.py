#!/usr/bin/env python3
"""Device ms per call of decode attention at the rows ``chip_smoke.phase_timing``
times, for one checkout of the repo, on one CUDA card.

    python3 scripts/decode_timing.py [--tree DIR] [--out PATH.json]

The checkout at ``DIR`` (default: this one) is imported (its
``paligemma_tpu_torch`` and ``chip_smoke``), its kernels are built, and
``decode_attention`` is timed by its ``chip_smoke._time_ms`` (CUDA events
around CUDA-graph replays) at the main path's length, S = 308 with 292
visible positions, and at S = 1100 and 4128 with every position visible,
over a bf16 and an int8 cache (a layer of an 18-layer cache). The same
seed gives both checkouts the same inputs. To compare two checkouts, run
the script in turns in one call on one card: parent, this, this, parent.
Prints one JSON line. Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROWS = ((308, 292), (1100, 1100), (4128, 4128))  # (S, valid)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent),
                    help="the checkout of the repo whose kernel is timed")
    ap.add_argument("--out", default=None, help="also write the JSON result to this file")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch

    if not torch.cuda.is_available():
        print("decode_timing: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from paligemma_tpu_torch.models.gemma import quantize_kv_rows
    from paligemma_tpu_torch.ops import _build
    from paligemma_tpu_torch.ops import cuda_attention as ca

    if not Path(ca.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {ca.__file__}, not the checkout at {tree}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    _build.build()
    _build.load_library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 1)
    ms = {}
    for kv in ("bf16", "int8"):
        for s_len, valid in ROWS:
            q = chip_smoke._rand(torch, gen, (1, 1, 8, 256), dev)
            k, v = (chip_smoke._rand(torch, gen, (18, 1, s_len, 1, 256), dev) for _ in range(2))
            kw = {"scale": 256**-0.5}
            if kv == "int8":
                (k, ks), (v, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
                kw.update(k_scale=ks[9], v_scale=vs[9])
            call = (q, k[9], v[9], torch.tensor([valid], dtype=torch.int32, device=dev))
            ms[f"{kv} cache S={s_len} valid={valid}"] = chip_smoke._time_ms(
                torch, lambda i, a=call, kw=kw: ca.decode_attention(*a, **kw))
    result = {"tree": str(tree), "device": smi, "ms_per_call": ms}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

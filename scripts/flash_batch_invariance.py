#!/usr/bin/env python3
"""Whether a row of a batched flash call gives the bits of the batch-1 call
on that row, for builds of ``csrc/flash_attention.cu`` side by side, and the
device time of each build's batched call.

    python3 scripts/flash_batch_invariance.py --variant tree=paligemma_tpu_torch/csrc/flash_attention.cu \\
        --variant parent=DIR/flash_attention.cu [--out PATH.json]

A source that is not the port's needs its ``common.cuh`` beside it (for
example ``git show <commit>:paligemma_tpu_torch/csrc/...`` into a gitignored
directory of the checkout). Each build is held to the plain
version (chip_smoke's bar), then each row of a batch-4 call to the batch-1
call of that row, bit for bit; the batch-4 calls are timed in turns across
the builds (CUDA-graph replays, chip_smoke's ``_time_ms``). Prints the
card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

# (label, t, h, hkv, d, per-row valid lengths of the batch-4 call or None)
CASES = [
    ("gemma prefill 224-px prompts T=S=276 H=8 Hkv=1 D=256", 276, 8, 1, 256, [276, 250, 263, 200]),
    ("ablation bucket T=S=512 valid 276 H=8 Hkv=1 D=256", 512, 8, 1, 256, [276] * 4),
    ("no-cache pass T=S=640 H=8 Hkv=1 D=256", 640, 8, 1, 256, [400] * 4),
    ("siglip-224 T=S=256 H=16 D=72", 256, 16, 16, 72, None),
    ("siglip-448 T=S=1024 H=16 D=72", 1024, 16, 16, 72, None),
]
BATCH = 4


def main() -> int:
    import torch

    from chip_smoke import _close, _rand, _time_ms
    from flash_variants import build
    from paligemma_tpu_torch.ops import _build
    from paligemma_tpu_torch.ops import cuda_attention as ca

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", required=True, help="NAME=SOURCE")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_batch_invariance: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    nvcc = _build.find_nvcc()
    specs = dict(v.split("=", 1) for v in args.variant)
    with ThreadPoolExecutor(len(specs)) as pool:
        futures = {n: pool.submit(build, n, s, _build.BUILD_DIR / "variants", nvcc) for n, s in specs.items()}
    libs = {n: _build.load(f.result()[0], ["pg_flash_attention"]) for n, f in futures.items()}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    result = {"device": smi, "batch": BATCH, "cases": []}
    for label, t, h, hkv, d, valid in CASES:
        q, k, v = _rand(torch, gen, (BATCH, t, h, d), dev), _rand(torch, gen, (BATCH, t, hkv, d), dev), \
            _rand(torch, gen, (BATCH, t, hkv, d), dev)
        vl = None if valid is None else torch.tensor(valid, dtype=torch.int32, device=dev)
        ref = ca.flash_attention_plain(q, k, v, vl)
        rec = {"case": label, "variants": {}}
        for name, lib in libs.items():
            out = ca.launch_flash(q, k, v, vl, lib=lib)
            rows = [ca.launch_flash(q[i:i + 1], k[i:i + 1], v[i:i + 1], None if vl is None else vl[i:i + 1], lib=lib)
                    for i in range(BATCH)]
            torch.cuda.synchronize()
            err, ok = _close(torch, out, ref)
            same = [bool(torch.equal(out[i:i + 1], rows[i])) for i in range(BATCH)]
            diff = max(float((out[i:i + 1].float() - rows[i].float()).abs().max()) for i in range(BATCH))
            rec["variants"][name] = {"max_abs_err": err, "within_bar": ok, "rows_bit_identical": same,
                                     "max_abs_row_diff": diff}
        # The batched call's device time, in turns across the builds.
        order = list(libs) + list(libs)[::-1]
        times = {n: [] for n in libs}
        for name in order:
            times[name].append(_time_ms(torch, lambda i, lib=libs[name]: ca.launch_flash(q, k, v, vl, lib=lib)))
        for name, ts in times.items():
            r = rec["variants"][name]
            r["batch_ms"] = sum(ts) / len(ts)
            print(f"[batch] {label:52s} {name:8s} max_abs_err {r['max_abs_err']:.3e} within bar {r['within_bar']} | "
                  f"rows bit-identical to batch 1: {r['rows_bit_identical']} (max diff {r['max_abs_row_diff']:.3e}) | "
                  f"batch-{BATCH} device ms {r['batch_ms']:.4f} (turns {', '.join(f'{x:.4f}' for x in ts)})",
                  flush=True)
        result["cases"].append(rec)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    ok = all(r["within_bar"] for c in result["cases"] for r in c["variants"].values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

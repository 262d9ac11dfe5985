#!/usr/bin/env python3
"""Builds of the flash attention kernel side by side, checked and timed in turns on one CUDA card.

    python3 scripts/flash_variants.py --variant NAME=SOURCE[:MACRO=VALUE,...] ... \\
        [--sass NAME] [--quick] [--out PATH.json]

Each SOURCE is a ``flash_attention.cu``: the port's own, or another version
of it with the ``common.cuh`` it includes beside it (for example the file of
an older commit, ``git show COMMIT:paligemma_tpu_torch/csrc/...``, unpacked
into a directory that ``.gitignore`` lists), compiled by ``nvcc`` with the
port's flags, the given macros and ``-Xptxas -v`` into a library of its own
under the gitignored build directory. For each build the script prints the
registers and spill bytes of every kernel instantiation, then holds it to
``flash_attention_plain`` on ``chip_smoke.FLASH_CASES`` at chip_smoke's bars
(poisoned invisible K/V rows bit-equal), through the port's launch
(``cuda_attention.launch_flash``). Every build that agrees is then timed in
turns (the builds in order, then in reverse) at the main-path shapes and the
448- and 896-px lengths, beside ``F.scaled_dot_product_attention`` and the
bound: device ms per call from CUDA-graph replays (``chip_smoke._time_ms``).

- ``--sass NAME``: the instructions of the kv loop of that build's head_dim
  80 and 256 kernels, by opcode, and per ``mma`` (the SASS is written
  beside ``--out``).
- ``--quick``: no timing. ``--out``: the whole result as JSON.

Needs a CUDA device and ``nvcc``; exits 1 if a build fails or disagrees.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# (label, t, h, hkv, d), batch 1, T = S: the main path first, then the long presets.
TIMED = [
    ("siglip T=S=256 H=16 D=72", 256, 16, 16, 72),
    ("gemma T=S=276 H=8 Hkv=1 D=256", 276, 8, 1, 256),
    ("448-px siglip T=S=1024 H=16 D=72", 1024, 16, 16, 72),
    ("448-px gemma T=S=1044 H=8 Hkv=1 D=256", 1044, 8, 1, 256),
    ("896-px siglip T=S=4096 H=16 D=72", 4096, 16, 16, 72),
    ("896-px gemma T=S=4110 H=8 Hkv=1 D=256", 4110, 8, 1, 256),
]


def build(name, spec, out_dir, nvcc):
    """(library path, ptxas output) of one build; raises on a failed build."""
    from paligemma_tpu_torch.ops import _build

    src, _, macros = spec.partition(":")
    lib = out_dir / name / "libflash.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas=-v", *(f"-D{m}" for m in macros.split(",") if m),
           "-shared", "-o", str(lib), str(ROOT / src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def registers(ptxas: str):
    """{kernel instantiation: [registers, spill store bytes]} from ``-Xptxas -v``."""
    out, current = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line) or re.search(r"Function properties for (\w+)", line)
        if m:
            current = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and current:
            out.setdefault(current, [0, 0])[1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            out.setdefault(current, [0, 0])[0] = int(m.group(1))
    return out


def loop_counts(sass: str):
    """(instructions, {opcode: count}) of the largest backward-branch loop
    of one kernel's SASS that holds HMMA."""
    ins = []
    for line in sass.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if m:
            ins.append((int(m.group(1), 16), m.group(3), m.group(4)))
    best = []
    for addr, op, rest in ins:
        t = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
            body = [o for a, o, _ in ins if int(t.group(1), 16) <= a <= addr]
            if any(o.startswith("HMMA") for o in body) and len(body) > len(best):
                best = body
    counts = {}
    for o in best:
        counts[o.split(".")[0]] = counts.get(o.split(".")[0], 0) + 1
    return len(best), counts


def main() -> int:
    import torch
    import torch.nn.functional as F

    from chip_smoke import FLASH_CASES, _attention_cost, _bound, _close, _rand, _time_ms
    from paligemma_tpu_torch.ops import _build
    from paligemma_tpu_torch.ops import cuda_attention as ca

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", required=True, help="NAME=SOURCE[:MACRO=VALUE,...]")
    ap.add_argument("--sass", action="append", default=[])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    nvcc = _build.find_nvcc()
    specs = dict(v.split("=", 1) for v in args.variant)
    with ThreadPoolExecutor(len(specs)) as pool:
        futures = {n: pool.submit(build, n, s, _build.BUILD_DIR / "variants", nvcc) for n, s in specs.items()}
    result = {"device": smi, "variants": {n: {"spec": s} for n, s in specs.items()}}
    libs = {}
    for name, fut in futures.items():
        rec = result["variants"][name]
        try:
            path, ptxas = fut.result()
        except RuntimeError as e:
            print(f"[build] {name}: FAILED\n{e}", flush=True)
            rec["build"] = "failed"
            continue
        rec["registers"] = regs = registers(ptxas)
        for kname, (r, spill) in regs.items():
            print(f"[build] {name} {kname}: {r} registers, {spill} B spill stores", flush=True)
        libs[name] = _build.load(path, ["pg_flash_attention"])
        if name in args.sass:
            dump = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(path)],
                                  capture_output=True, text=True, check=True).stdout
            if args.out:
                args.out.parent.mkdir(parents=True, exist_ok=True)
                args.out.with_name(f"flash_sass_{name}.txt").write_text(dump)
            for fn in re.split(r"\n\s*Function : ", dump)[1:]:
                kname = fn.split("\n", 1)[0].strip()
                if re.search(r"ILi(80|256)E", kname):
                    n, counts = loop_counts(fn)
                    hmma = counts.get("HMMA", 0)
                    rec.setdefault("sass", {})[kname] = {"loop_instructions": n, "counts": counts}
                    print(f"[sass] {name} {kname}: loop {n} instructions, {hmma} HMMA "
                          f"({n / max(hmma, 1):.2f} an mma) {counts}", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def views(b, t, h, hkv, d):
        fused = _rand(torch, gen, (b, t, (h + 2 * hkv) * d), dev)
        q, k, v = fused.split([h * d, hkv * d, hkv * d], dim=-1)
        return q.view(b, t, h, d), k.view(b, t, hkv, d), v.view(b, t, hkv, d)

    for label, (b, t, h, hkv, d), kw, poison in FLASH_CASES:
        q, k, v = views(b, t, h, hkv, d)
        if "valid_len" in kw:
            kw = dict(kw, valid_len=torch.tensor(kw["valid_len"], dtype=torch.int32, device=dev))
        ref = ca.flash_attention_plain(q, k, v, **kw)
        if poison is not None:
            k2, v2 = k.clone(), v.clone()
            k2[:, poison:], v2[:, poison:] = 1e4, 1e4
        for name, lib in list(libs.items()):
            got = ca.launch_flash(q, k, v, **kw, lib=lib)
            torch.cuda.synchronize()
            err, ok = _close(torch, got, ref)
            if poison is not None:
                ok = ok and torch.equal(ca.launch_flash(q, k2, v2, **kw, lib=lib), got)
            print(f"[check] {name:8s} {label:64s} max_abs_err {err:.3e} ok {ok}", flush=True)
            result["variants"][name].setdefault("max_abs_err", {})[label] = err
            if not ok:
                result["variants"][name]["check"] = "failed"
                del libs[name]
    for label, t, h, hkv, d in [] if args.quick or not libs else TIMED:
        q, k, v = views(1, t, h, hkv, d)
        if hkv == 1:  # the query heads of one kv head as more query rows of one head
            lib_args = [q.reshape(1, 1, t * h, d), k.reshape(1, 1, t, d), v.reshape(1, 1, t, d)]
        else:
            lib_args = [x.transpose(1, 2).contiguous() for x in (q, k, v)]
        times = {n: [] for n in libs}
        for order in (list(libs), list(libs)[::-1]):
            for n in order:
                times[n].append(_time_ms(torch, lambda i, lib=libs[n]: ca.launch_flash(q, k, v, lib=lib)))
        sdpa_ms = _time_ms(torch, lambda i: F.scaled_dot_product_attention(*lib_args, scale=d**-0.5))
        bound, bound_by = _bound(*_attention_cost(1, t, t, h, hkv, d), "bf16")
        row = {n: sum(ts) / len(ts) for n, ts in times.items()}
        print(f"[time] {label:40s} " + " | ".join(f"{n} {ms:.4f}" for n, ms in row.items())
              + f" | SDPA {sdpa_ms:.4f} | bound {bound:.4g} ({bound_by})", flush=True)
        result.setdefault("times", {})[label] = {"ms": row, "turns": times, "sdpa_ms": sdpa_ms,
                                                  "bound_ms": bound, "bound_by": bound_by}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0 if len(libs) == len(specs) else 1


if __name__ == "__main__":
    sys.exit(main())

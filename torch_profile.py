#!/usr/bin/env python3
"""Device time of the PyTorch port's serving path, by kernel, on one CUDA card.

    python3 torch_profile.py [--out PATH]
    python3 torch_profile.py --train [--out PATH]

PaliGemma-3B-224 with seeded random weights made on the card and the first
request of ``chip_smoke.py`` (its ``build_model`` and ``_request``). For each
serving arm (the bf16 model, and each of chip_smoke's ``QUANT_ARMS``: the
model quantized on the card by ``quantization.quantize_params``, with the
arm's cache), after a warm-up:

- host-clock ms of one eager prefill (``models/paligemma.prefill`` issued
  launch by launch from Python) and of one ``generation.prefill`` (a
  replay of the prefill's CUDA graph, captured at the warm-up), and
  ms/token of one eager decode chunk of ``STEPS`` tokens
  (``chip_smoke.eager_chunk``: the decode step issued launch by launch),
  unprofiled; and ms/token of the same chunk through
  ``generation.decode_steps`` (replays of the captured CUDA graph). All on
  one cache of the arm, emptied before each prefill;
- the eager prefill, the graph prefill, the eager chunk and the graph
  chunk under ``torch.profiler`` (CUPTI): device time = the sum of the
  CUDA kernels' own time, by kernel name and by group (the port's kernels,
  cuBLAS, PyTorch's elementwise and reductions), per prefill and per decode
  token, with the launches of each, and the busy share (device time over
  the unprofiled host ms). A trace that holds fewer records
  of a port kernel than its wrapper's launch count says were launched has
  lost records: the call is profiled again, up to ``TRIES`` times, and the
  arm's ``records`` entry keeps the tries and what the last trace lacked.

``--train`` profiles a LoRA training micro-step instead (chip_smoke's
phase 15 batch: B = 2, T = 320, r 8, alpha 16, dropout 0.1, B seeded
non-zero; an accumulating call, no optimizer step): unprofiled host ms,
then under the profiler the forward (the loss with its autograd graph)
alone, the whole micro-step eager (``lora.train_step``) and as a CUDA
graph replay (``lora.make_train_step``), and the eval loss's forward
(``no_grad``) eager and as a replay (``lora.make_eval_loss``): device ms by
group and kernel, launches, the busy share, and the host's PyTorch op
calls (a replay's are its input copies).

Prints one summary line per arm and group, and the whole result as one JSON
line (also written to ``--out`` when given). Needs a CUDA device; exits 2
without one.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

from chip_smoke import KERNEL_SYMBOLS

STEPS = 15  # decode tokens per profiled chunk
TRIES = 3  # profiles of a call whose trace lost kernel records
# Kernel-name substrings of each group, first match wins: the port's
# kernels, then cuBLAS.
GROUPS = [*KERNEL_SYMBOLS, ("cublas", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitK"))]


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "elementwise_and_reductions"


def device_kernels(prof):
    """{kernel name: (device us, launches)} of the CUDA kernels in a trace."""
    from torch.autograd import DeviceType

    out = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            out[evt.key] = (evt.self_device_time_total, evt.count)
    return out


def profiled(torch, fn, setup=lambda: None):
    """(device kernels, tries, missing): ``fn(setup())`` with
    only ``fn`` under torch.profiler, again while the trace holds fewer
    records of a port kernel than the wrappers launched; ``missing`` is
    {group: records the last trace lacked}, empty when it was whole."""
    from paligemma_tpu_torch.ops import kernels

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for tries in range(1, TRIES + 1):
        arg = setup()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with torch.profiler.profile(activities=acts) as prof:
            fn(arg)
            torch.cuda.synchronize()
        launched = kernels.launch_counts()
        found = device_kernels(prof)
        seen = collections.Counter()
        for name, (_, n) in found.items():
            seen[group_of(name)] += n
        # Every wrapper launch is one kernel.
        missing = {g: n - seen[g] for g, n in launched.items() if seen[g] < n}
        if not missing:
            break
        print(f"[records] try {tries}: the trace lacks {missing} kernel records", flush=True)
    return found, tries, missing


def summarize(kernels, per: int):
    groups = collections.defaultdict(lambda: [0.0, 0])
    for name, (us, n) in kernels.items():
        g = groups[group_of(name)]
        g[0] += us / 1e3 / per
        g[1] += n / per
    total = sum(g[0] for g in groups.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "device_ms": total,
        "launches": sum(g[1] for g in groups.values()),
        "groups": {k: {"device_ms": v[0], "launches": v[1]} for k, v in sorted(groups.items())},
        "top_kernels": [{"name": k[:120], "device_ms": us / 1e3 / per, "launches": n / per}
                        for k, (us, n) in top],
    }


def profile_train(torch, model, proc, cfg, smi):
    """One LoRA micro-step (forward and backward, the accumulation only)
    and its forward alone, eager and as CUDA graph replays
    (``lora.make_train_step``, ``lora.make_eval_loss``): host ms, device
    time by group, busy share, op calls."""
    import chip_smoke
    from paligemma_tpu_torch import lora
    from paligemma_tpu_torch.models import paligemma

    dev = torch.device("cuda")
    batch = lora.batch_to(chip_smoke._lora_batch(torch, proc, cfg), dev)
    lcfg = lora.LoraConfig(r=chip_smoke.LORA_R, alpha=chip_smoke.LORA_ALPHA, dropout=chip_smoke.LORA_DROPOUT)
    ad = lora.init_lora(cfg, lcfg, torch.Generator(device=dev).manual_seed(0), dev)
    for mod in ad["layers"].values():
        mod["b"].normal_(0.0, 0.01, generator=torch.Generator(device=dev).manual_seed(1))
    opt = lora.AdapterOptimizer(accum_steps=10**9)  # accumulates only: the micro-step without its update
    state = opt.init(ad)
    step = lora.make_train_step(lcfg, opt)
    eval_graph = lora.make_eval_loss(lcfg.scale)
    gen = torch.Generator(device=dev).manual_seed(2)

    def micro(_=None):
        nonlocal state
        _, _, state = lora.train_step(model, ad, state, batch, gen, lcfg, opt)

    def micro_graph(_=None):
        nonlocal state
        _, _, state = step(model, ad, state, batch, gen)

    def forward(_=None):
        live = lora._map(lambda t: t.detach().requires_grad_(), ad)
        paligemma.loss_fn(model, batch["input_ids"], batch["pixel_values"], batch["labels"],
                          valid_len=batch["valid_len"], lora=live, lora_scale=lcfg.scale,
                          lora_dropout=lcfg.dropout, lora_generator=gen)

    def eval_forward(_=None):
        lora.eval_loss(model, ad, batch, lcfg.scale)

    def eval_forward_graph(_=None):
        eval_graph(model, ad, batch)

    result = {"device": smi, "shape": f"B=2 T={chip_smoke.LORA_VALID[0]} valid {list(chip_smoke.LORA_VALID)}"}
    for name, fn in (("forward", forward), ("micro_step", micro), ("micro_step_graph", micro_graph),
                     ("eval_forward", eval_forward), ("eval_forward_graph", eval_forward_graph)):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        hosts = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            hosts.append((time.perf_counter() - t0) * 1e3)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        ops = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU and e.key.startswith("aten::"))
        rec = summarize(device_kernels(prof), 1)
        host = sorted(hosts)[len(hosts) // 2]
        rec.update(host_ms=hosts, median_host_ms=host, busy_share_of_host_ms=rec["device_ms"] / host,
                   aten_op_calls=ops)
        result[name] = rec
        groups = " ".join(f"{k} {v['device_ms']:.4f} ({v['launches']:.0f})" for k, v in rec["groups"].items())
        print(f"[train {name}] host {host:.3f} ms (of {[round(h, 2) for h in hosts]}) | device {rec['device_ms']:.4f}"
              f" ms, {rec['launches']:.0f} launches, busy {rec['busy_share_of_host_ms']:.1%}, {ops} aten op calls"
              f" | {groups}", flush=True)
        for k in rec["top_kernels"][:8]:
            print(f"[train {name}]   {k['device_ms']:.4f} ms x{k['launches']:.0f} {k['name'][:100]}", flush=True)
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON result to this file")
    ap.add_argument("--train", action="store_true", help="profile a LoRA training micro-step instead")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from paligemma_tpu_torch import generation, quantization
    from paligemma_tpu_torch.models import gemma, paligemma

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cfg, _, proc, model = chip_smoke.build_model(torch)
    if args.train:
        result = profile_train(torch, model, proc, cfg, smi)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(result, indent=1))
        print(json.dumps(result), flush=True)
        return 0
    ids, pix = chip_smoke._request(torch, proc, 0)
    n = STEPS

    result = {"device": smi, "prompt_len": int(ids.shape[1]), "steps": n, "arms": {}}
    for arm, qargs, kv_int8 in [("bf16", None, False)] + chip_smoke.QUANT_ARMS:
        m = model if qargs is None else quantization.quantize_params(model, **qargs)
        cache_dtype = torch.int8 if kv_int8 else None
        # One cache: its prefill graph and decode graph serve every call.
        arm_cache = generation.make_cache(m, 1, ids.shape[1], n + 1, cache_dtype)

        def prefill(replay=True):
            cache = gemma.reset_cache(arm_cache)
            if replay:
                logits, cache = generation.prefill(m, ids, pix, cache)
            else:
                logits, cache = paligemma.prefill(m, ids, pix, cache, full_logits=False)
            return logits[:, -1].argmax(-1).to(torch.int32)[:, None], cache

        def eager(tok, cache):
            return chip_smoke.eager_chunk(torch, m, tok, cache, n)[0].tolist()

        def graph(tok, cache):
            return generation.decode_steps(m, tok, cache, n)[0].tolist()

        def host_ms(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        _, prefill_capture_ms = host_ms(prefill)  # warm-up: the prefill graph's capture
        tok0, cache = prefill(replay=False)
        eager(tok0, cache)
        _, prefill_ms = host_ms(lambda: prefill(replay=False))
        (tok0, cache), graph_prefill_ms = host_ms(prefill)
        t0 = time.perf_counter()
        eager(tok0, cache)
        decode_ms = (time.perf_counter() - t0) * 1e3 / n
        tok0, cache = prefill()
        capture_ms = generation.prepare_decode(m, cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph(tok0, cache)
        graph_ms = (time.perf_counter() - t0) * 1e3 / n

        kern_p, tries_p, missing_p = profiled(torch, lambda _: prefill(replay=False))
        kern_gp, tries_gp, missing_gp = profiled(torch, lambda _: prefill())
        kern_d, tries_d, missing_d = profiled(  # each try from a new prefill
            torch, lambda pre: eager(*pre), prefill)
        kern_g, tries_g, missing_g = profiled(torch, lambda pre: graph(*pre), prefill)
        rec = {
            "prefill_host_ms": prefill_ms, "graph_prefill_host_ms": graph_prefill_ms,
            "graph_prefill_capture_host_ms": prefill_capture_ms, "decode_host_ms_per_token": decode_ms,
            "graph_decode_host_ms_per_token": graph_ms, "graph_capture_ms": capture_ms,
            "prefill": summarize(kern_p, 1),
            "graph_prefill": summarize(kern_gp, 1),
            "decode_per_token": summarize(kern_d, n),
            "graph_decode_per_token": summarize(kern_g, n),
            "records": {"prefill": {"tries": tries_p, "missing": missing_p},
                        "graph_prefill": {"tries": tries_gp, "missing": missing_gp},
                        "decode": {"tries": tries_d, "missing": missing_d},
                        "graph_decode": {"tries": tries_g, "missing": missing_g}},
        }
        hosts = (("prefill", prefill_ms), ("graph_prefill", graph_prefill_ms), ("decode_per_token", decode_ms),
                 ("graph_decode_per_token", graph_ms))
        for phase, host in hosts:
            rec[phase]["busy_share_of_host_ms"] = rec[phase]["device_ms"] / host
        result["arms"][arm] = rec
        for phase, host in hosts:
            s = rec[phase]
            groups = " ".join(f"{k} {v['device_ms']:.4f} ({v['launches']:.0f})" for k, v in s["groups"].items())
            print(f"[{arm}] {phase}: host {host:.3f} ms | device {s['device_ms']:.4f} ms, "
                  f"{s['launches']:.0f} launches, busy {s['busy_share_of_host_ms']:.1%} | {groups}", flush=True)
        print(f"[{arm}] graph_prefill: first call (eager warm-up + capture) {prefill_capture_ms:.2f} ms | "
              f"graph_decode_per_token: captured in {capture_ms:.2f} ms", flush=True)
        del arm_cache, cache
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

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``paligemma_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each reported on its own lines; any failure raises and exits
non-zero, and without a CUDA device the script exits 2 before doing anything:

1. Device: the card's name and power limit (nvidia-smi), device count.
2. Build: compiles the CUDA kernels from ``paligemma_tpu_torch/csrc``.
3. Kernels vs plain: each kernel against its plain PyTorch version on the
   card, in bf16, at the main-path shapes, at the 896-px preset's lengths
   (SigLIP T=S=4096, prefill T=S=4110, a 4128-position cache), and at edge
   cases (batch 2 with per-row valid lengths and a window, ragged T/S, fully
   masked tiles, poisoned K/V past the valid length, head_dim 72).
4. Main path at full width: PaliGemma-3B-224 in bf16 with seeded random
   weights made on the card, the byte-tokenizer processor, and three
   requests answered by ``generation.generate`` (32 new tokens each), with
   the kernels' launch counts, prefill ms and decode ms/token per request;
   then the first request's decode again as one ``decode_steps`` chunk,
   which must give the same tokens; and the peak device memory.
5. Kernel path vs plain path: the first request again with the plain
   attention functions; the prefill's last-position logits must agree within
   the stated tolerance and the first greedy token must be identical.
6. Timing: the device time per call of each kernel and its plain version at
   the main-path shapes (CUDA events around CUDA-graph replays, so host
   dispatch is not timed).

The second-to-last line is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

SEED = 0
MAX_NEW_TOKENS = 32
REQUESTS = [
    ("describe the chart", (180, 240)),
    ("what is the revenue trend?", (224, 224)),
    ("caption en", (300, 200)),
]
# Kernel vs plain version, both bf16 out with fp32 accumulation. They differ
# in summation order and, for flash, in the running maximum each bf16-rounded
# probability is taken against; each can move an output across one bf16
# rounding boundary, i.e. 2^-8 relative. Two ulps plus a small absolute
# floor for outputs near zero:
KERNEL_RTOL, KERNEL_ATOL = 2.0**-7, 2e-3
# Whole-model logits, kernel path vs plain path: 45 attention calls of small
# per-call differences pass through 45 residual layers in bf16; the bar is
# 2% of the largest logit magnitude (a bf16 value carries 2^-8 = 0.4%).
LOGIT_REL_TOL = 0.02


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(smi.splitlines()[0])
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} | {name} x{count}")
    return name, count


def phase_build():
    from paligemma_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    log(f"[build] {time.perf_counter() - t0:.2f} s -> {path.relative_to(_build.PACKAGE_DIR.parent)}")


def _rand(torch, gen, shape, dev):
    return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)


def _close(torch, got, ref):
    """(max abs error, within tolerance) in fp32."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    ok = bool((err <= KERNEL_ATOL + KERNEL_RTOL * ref.abs()).all()) and bool(torch.isfinite(got).all())
    return float(err.max()), ok


def phase_kernels(torch):
    """Each kernel against its plain version; returns max errors per kernel."""
    from paligemma_tpu_torch.ops import cuda_attention as ca

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_err = {"flash_attention": 0.0, "decode_attention": 0.0}

    def run_case(kind, name, fn, plain, args, kwargs, poison_from=None):
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        err, ok = _close(torch, out, plain(*args, **kwargs))
        msg = f"[kernel] {kind:16s} {name:44s} max_abs_err {err:.3e}"
        if poison_from is not None:
            q, k, v = args[:3]
            k2, v2 = k.clone(), v.clone()
            k2[:, poison_from:] = 1e4
            v2[:, poison_from:] = 1e4
            out2 = fn(q, k2, v2, *args[3:], **kwargs)
            torch.cuda.synchronize()
            same = torch.equal(out2, out)
            msg += f" | poisoned tail unchanged: {same}"
            ok = ok and same
        log(msg)
        check(ok, f"{kind} {name}: kernel disagrees with its plain version")
        max_err[kind] = max(max_err[kind], err)

    def qkv_views(b, t, h, hkv, d):
        """q, k, v as slices of one fused projection output, as the models make them."""
        fused = _rand(torch, gen, (b, t, (h + 2 * hkv) * d), dev)
        q, k, v = fused.split([h * d, hkv * d, hkv * d], dim=-1)
        return q.view(b, t, h, d), k.view(b, t, hkv, d), v.view(b, t, hkv, d)

    flash_cases = [
        # name, (b, t, h, hkv, d), kwargs, poison_from
        ("siglip-224 T=S=256 H=16 D=72 (fused views)", (1, 256, 16, 16, 72), {}, None),
        ("gemma prefill T=S=276 H=8 Hkv=1 D=256", (1, 276, 8, 1, 256), {}, None),
        ("896-px siglip T=S=4096 H=16 D=72", (1, 4096, 16, 16, 72), {}, None),
        ("896-px gemma prefill T=S=4110 H=8 Hkv=1 D=256", (1, 4110, 8, 1, 256), {}, None),
        ("B=2 valid=[37,200] window=[150,170) D=64", (2, 200, 4, 2, 64),
         {"valid_len": [37, 200], "gen_start": 150, "gen_end": 170}, None),
        ("ragged T=S=45 H=2 Hkv=1 D=128", (1, 45, 2, 1, 128), {}, None),
        ("masked tiles + poison valid=20 of 200 D=72", (1, 200, 4, 4, 72), {"valid_len": 20}, 20),
        ("head_dim 40 GQA 3:1", (2, 70, 6, 2, 40), {"valid_len": [70, 33]}, None),
    ]
    for name, (b, t, h, hkv, d), kw, poison in flash_cases:
        q, k, v = qkv_views(b, t, h, hkv, d)
        if "valid_len" in kw:
            kw = dict(kw, valid_len=torch.tensor(kw["valid_len"], dtype=torch.int32, device=dev))
        run_case("flash_attention", name, ca.flash_attention, ca.flash_attention_plain,
                 (q, k, v), dict(kw, scale=d**-0.5), poison)

    decode_cases = [
        # name, (b, s, h, hkv, d), valid, kwargs, poison_from
        ("gemma S=1100 valid=700 layer view of 5-d cache", (1, 1100, 8, 1, 256), [700], {}, None),
        ("896-px length S=4128 valid=4100", (1, 4128, 8, 1, 256), [4100], {}, None),
        ("B=2 valid=[5,300] window=[400,420) D=64", (2, 500, 4, 2, 64), [5, 300],
         {"gen_start": 400, "gen_end": 420}, None),
        ("ragged S=77 valid=77 D=128", (1, 77, 8, 1, 128), [77], {}, None),
        ("masked chunks + poison valid=40 of 300", (1, 300, 8, 1, 256), [40], {}, 40),
        ("head_dim 72 H=Hkv=16", (1, 257, 16, 16, 72), [250], {}, None),
    ]
    for name, (b, s, h, hkv, d), valid, kw, poison in decode_cases:
        kc = _rand(torch, gen, (3, b, s, hkv, d), dev)[1]  # a layer of a stacked cache
        vc = _rand(torch, gen, (3, b, s, hkv, d), dev)[1]
        q = _rand(torch, gen, (b, 1, h, d), dev)
        vt = torch.tensor(valid, dtype=torch.int32, device=dev)
        run_case("decode_attention", name, ca.decode_attention, ca.decode_attention_plain,
                 (q, kc, vc, vt), dict(kw, scale=d**-0.5), poison)
    return max_err


def _time_ms(torch, fn, iters=20, replays=5):
    """Device ms per call: ``iters`` calls captured in one CUDA graph, the
    graph replayed ``replays`` times between two CUDA events. Host dispatch
    is outside the window (a loop of eager calls would time the host for a
    call that runs in microseconds)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # warm-up outside the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def phase_timing(torch, prompt_len):
    """Device ms per call of kernel and plain version at the main-path
    shapes, in turns (plain, kernel, kernel, plain); returns {kernel: {...}}."""
    from paligemma_tpu_torch.ops import cuda_attention as ca

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    fused_sig = _rand(torch, gen, (1, 256, 3 * 1152), dev)
    q_s, k_s, v_s = (x.view(1, 256, 16, 72) for x in fused_sig.split(1152, dim=-1))
    fused_gem = _rand(torch, gen, (1, prompt_len, 2560), dev)
    q_g, k_g, v_g = fused_gem.split([2048, 256, 256], dim=-1)
    q_g, k_g, v_g = q_g.view(1, prompt_len, 8, 256), k_g.view(1, prompt_len, 1, 256), v_g.view(1, prompt_len, 1, 256)
    s_main = prompt_len + MAX_NEW_TOKENS
    shapes = {
        "flash_attention": [
            ("siglip T=S=256 H=16 D=72", 27, ca.flash_attention, ca.flash_attention_plain,
             (q_s, k_s, v_s), {"scale": 72**-0.5}),
            (f"gemma prefill T=S={prompt_len} H=8 Hkv=1 D=256", 18, ca.flash_attention,
             ca.flash_attention_plain, (q_g, k_g, v_g), {"scale": 256**-0.5}),
        ],
        "decode_attention": [],
    }
    # The main path's length, then about the 448-px and 896-px presets' lengths.
    for s_len, valid in ((s_main, prompt_len + MAX_NEW_TOKENS // 2), (1100, 1100), (4128, 4128)):
        kc = _rand(torch, gen, (18, 1, s_len, 1, 256), dev)[9]
        vc = _rand(torch, gen, (18, 1, s_len, 1, 256), dev)[9]
        q = _rand(torch, gen, (1, 1, 8, 256), dev)
        vt = torch.tensor([valid], dtype=torch.int32, device=dev)
        # Only the first (main-path) shape counts in the per-launch mean.
        shapes["decode_attention"].append(
            (f"decode S={s_len} valid={valid} H=8 Hkv=1 D=256", 18 if s_len == s_main else 0,
             ca.decode_attention, ca.decode_attention_plain, (q, kc, vc, vt), {"scale": 256**-0.5}))
    result = {}
    for kind, rows in shapes.items():
        by_shape, tot_k, tot_p, n = [], 0.0, 0.0, 0
        for label, weight, kfn, pfn, args, kw in rows:
            p1 = _time_ms(torch, lambda: pfn(*args, **kw))
            k1 = _time_ms(torch, lambda: kfn(*args, **kw))
            k2 = _time_ms(torch, lambda: kfn(*args, **kw))
            p2 = _time_ms(torch, lambda: pfn(*args, **kw))
            km, pm = (k1 + k2) / 2, (p1 + p2) / 2
            log(f"[time] {kind:16s} {label:44s} device ms/call: kernel {km:.4f} | plain {pm:.4f} "
                f"(turns: plain {p1:.4f}, kernel {k1:.4f}, kernel {k2:.4f}, plain {p2:.4f})")
            by_shape.append({"shape": label, "ms": km, "plain_ms": pm, "calls_per_request": weight})
            tot_k, tot_p, n = tot_k + weight * km, tot_p + weight * pm, n + weight
        result[kind] = {"ms": tot_k / n, "plain_ms": tot_p / n, "by_shape": by_shape}
    return result


def phase_main_path(torch, model, proc, tok, cfg):
    """Three requests through generate(); returns per-request records."""
    import numpy as np
    from PIL import Image

    from paligemma_tpu_torch import generation
    from paligemma_tpu_torch.ops import cuda_attention as ca

    dev = torch.device("cuda")
    n_layers_llm = cfg.text_config.num_hidden_layers
    n_layers_vis = cfg.vision_config.num_hidden_layers
    records = []
    ca.reset_launch_counts()  # counts from here on are the main path's
    for i, (prompt, (w, h)) in enumerate(REQUESTS):
        rng = np.random.RandomState(SEED + i)
        img = Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
        inputs = proc([prompt], [img])
        ids = torch.from_numpy(inputs["input_ids"]).to(dev)
        pix = torch.from_numpy(inputs["pixel_values"]).to(dev, torch.bfloat16)
        before = ca.launch_counts()
        stamps = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, cache = generation.generate(
            model, ids, pix, MAX_NEW_TOKENS, tok.eos_token_id,
            step_callback=lambda step: stamps.append(time.perf_counter()),
        )
        torch.cuda.synchronize()
        after = ca.launch_counts()
        flash = after["flash_attention"] - before["flash_attention"]
        decode = after["decode_attention"] - before["decode_attention"]
        n_dec = len(toks) - 1
        prefill_ms = (stamps[0] - t0) * 1e3
        decode_ms = (stamps[-1] - stamps[0]) * 1e3 / max(n_dec, 1)
        text = tok.decode(toks)
        log(f"[request {i}] prompt_len {ids.shape[1]} | {len(toks)} tokens | text {text!r}")
        log(f"[request {i}] launches flash {flash} (expect {n_layers_vis + n_layers_llm}) "
            f"decode {decode} (expect {n_layers_llm} x {n_dec}) | prefill {prefill_ms:.2f} ms | "
            f"decode {decode_ms:.3f} ms/token (host clock, per-token sync)")
        check(all(0 <= t < cfg.text_config.vocab_size for t in toks), "token id out of range")
        check(cache.length == ids.shape[1] + n_dec, "cache length does not match the tokens")
        check(flash == n_layers_vis + n_layers_llm, f"flash launches {flash} per prefill")
        check(decode == n_layers_llm * n_dec, f"decode launches {decode} for {n_dec} steps")
        records.append({"ids": ids, "pix": pix, "tokens": toks, "prefill_ms": prefill_ms,
                        "decode_ms_per_token": decode_ms})

    # The chunked decoder (bench.py's decode loop): the same greedy stream
    # with one host sync per chunk instead of one per token.
    rec = records[0]
    cache = generation.make_cache(model, 1, rec["ids"].shape[1], MAX_NEW_TOKENS)
    logits, cache = generation.prefill(model, rec["ids"], rec["pix"], cache)
    first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, _, cache = generation.decode_steps(model, first, cache, len(rec["tokens"]) - 1)
    chunk = toks[0].tolist()  # the one host sync
    dt = time.perf_counter() - t0
    log(f"[decode_steps] {len(chunk)} steps in one chunk: {dt * 1e3 / len(chunk):.3f} ms/token "
        f"(host clock, one sync) | same tokens as generate: {[int(first)] + chunk == rec['tokens']}")
    check([int(first)] + chunk == rec["tokens"], "decode_steps and generate disagree")
    return records


def phase_plain_path(torch, model, rec, tok):
    """Request 0 again through the plain attention functions."""
    from paligemma_tpu_torch import generation
    from paligemma_tpu_torch.ops import cuda_attention as ca

    ids, pix = rec["ids"], rec["pix"]

    def last_logits(attn):
        cache = generation.make_cache(model, 1, ids.shape[1], MAX_NEW_TOKENS)
        lg, _ = generation.prefill(model, ids, pix, cache, attn)
        return lg[0, -1].float()

    before = ca.launch_counts()
    lg_k = last_logits(ca.KERNELS)
    mid = ca.launch_counts()
    lg_p = last_logits(ca.PLAIN)
    toks_p, _ = generation.generate(model, ids, pix, MAX_NEW_TOKENS, tok.eos_token_id, attn=ca.PLAIN)
    after = ca.launch_counts()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(lg_k).all() and torch.isfinite(lg_p).all()), "non-finite logits")
    err = float((lg_k - lg_p).abs().max())
    bar = LOGIT_REL_TOL * float(lg_p.abs().max())
    first_k, first_p = int(lg_k.argmax()), int(lg_p.argmax())
    agree = sum(a == b for a, b in zip(rec["tokens"], toks_p))
    log(f"[plain] prefill last-position logits max|kernel - plain| {err:.4e} (bar {bar:.4e}, "
        f"max|logit| {float(lg_p.abs().max()):.3f}) | first token kernel {first_k} plain {first_p}")
    log(f"[plain] launches: kernel prefill {mid['flash_attention'] - before['flash_attention']} flash; "
        f"plain run {after['flash_attention'] - mid['flash_attention']} flash, "
        f"{after['decode_attention'] - mid['decode_attention']} decode")
    log(f"[plain] greedy token agreement over {len(toks_p)} tokens: {agree}/{min(len(toks_p), len(rec['tokens']))}"
        " (reported, not gated: near-ties can flip a bf16 argmax)")
    check(err <= bar, "kernel-path and plain-path logits disagree")
    check(first_k == first_p == rec["tokens"][0], "first greedy token differs")
    check(mid["flash_attention"] - before["flash_attention"] == 45, "kernel prefill did not launch")
    check(after == mid, "the plain path launched a kernel")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU", file=sys.stderr)
        return 2
    # Hold both paths to full fp32 products and fp32 reductions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    from paligemma_tpu_torch import paligemma_3b_pt_224
    from paligemma_tpu_torch.models import paligemma
    from paligemma_tpu_torch.ops import cuda_attention as ca
    from paligemma_tpu_torch.processing import (
        ByteTokenizer, PaliGemmaProcessor, align_config, assert_aligned,
    )

    name, count = phase_device(torch)
    phase_build()
    max_err = phase_kernels(torch)

    cfg0 = paligemma_3b_pt_224()
    tok = ByteTokenizer()
    proc = PaliGemmaProcessor(tok, cfg0.vision_config.num_image_tokens, cfg0.vision_config.image_size)
    cfg = align_config(cfg0, proc)
    assert_aligned(proc, cfg)
    t0 = time.perf_counter()
    model = paligemma.init_params(cfg, SEED, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"[model] paligemma_3b_pt_224 bf16, {sum(p.numel() for p in model.parameters()) / 1e9:.3f} B "
        f"params, random init on the card in {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    records = phase_main_path(torch, model, proc, tok, cfg)
    counts = ca.launch_counts()
    log(f"[memory] max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    phase_plain_path(torch, model, records[0], tok)
    times = phase_timing(torch, records[0]["ids"].shape[1])

    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "paligemma_tpu_torch/csrc/flash_attention.cu",
         "replaces": "paligemma_tpu/ops/pallas_attention.py:100"},
        {"name": "decode_attention", "route": "cuda",
         "source": "paligemma_tpu_torch/csrc/decode_attention.cu",
         "replaces": "paligemma_tpu/ops/pallas_attention.py:242"},
    ]
    for k in kernels:
        check(counts[k["name"]] > 0, f"{k['name']} was never launched on the main path")
        k.update(launches=counts[k["name"]], max_abs_err=max_err[k["name"]], **times[k["name"]])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

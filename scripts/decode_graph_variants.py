#!/usr/bin/env python3
"""Two ways to replay a decode chunk as CUDA graphs, timed in turns on one
CUDA card, beside the eager chunk.

    python3 scripts/decode_graph_variants.py [--steps N] [--out PATH.json]

PaliGemma-3B-224 with seeded random weights made on the card and request 0
of ``chip_smoke.py``, in bf16 and in each of chip_smoke's ``QUANT_ARMS``.
For a chunk of ``--steps`` greedy tokens after the prefill:

- ``one_step``: ``generation.decode_steps``, ``N`` replays of one captured
  step (the port's design: one graph also serves ``generate``'s per-token
  loop and every chunk length);
- ``whole``: the ``N`` steps captured as one graph on the same step
  function and buffers (``whole_chunk_graph``, here only: the port
  captures one step), one replay;
- ``eager``: the step issued launch by launch (``chip_smoke.eager_chunk``).

Each graph's capture ms (host clock, warm-up step included), then the
chunks in turns (one_step, whole, whole, one_step, then eager twice), each
from a fresh prefill into the same cache: host ms/token to the one read of
the tokens and device-event ms/token. Every chunk must give the eager
chunk's tokens. Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def whole_chunk_graph(torch, model, cache, n):
    """``n`` greedy steps of ``generation._decode_step`` captured as one CUDA
    graph on the buffers of ``decode_steps``' runner for ``cache``, after a
    warm-up step on a side stream whose effect on the length is undone (as
    the runner's own capture does): (run(token, cache) -> tokens, capture
    ms, warm-up step included)."""
    from paligemma_tpu_torch import generation
    from paligemma_tpu_torch.ops.kernels import KERNELS

    st = generation._runner(model, cache, KERNELS, False).state

    def steps(k):
        for _ in range(k):
            generation._decode_step(model, cache, st, KERNELS, False, False)

    t0 = time.perf_counter()
    length, valid, host_length = cache.length.clone(), cache.valid.clone(), cache.host_length
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        steps(1)
    torch.cuda.current_stream().wait_stream(side)
    cache.length.copy_(length)
    cache.valid.copy_(valid)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        steps(n)
    cache.host_length = host_length
    capture_ms = (time.perf_counter() - t0) * 1e3

    def run(token, c):
        st.token.copy_(token)
        st.step.zero_()
        graph.replay()
        c.host_length += n
        return st.out[:, :n]

    return run, capture_ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=31, help="decode steps a chunk")
    ap.add_argument("--out", default=None, help="also write the JSON result to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("decode_graph_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from paligemma_tpu_torch import generation, quantization
    from paligemma_tpu_torch.models import gemma

    name, _ = chip_smoke.phase_device(torch)
    _, _, proc, model = chip_smoke.build_model(torch)
    ids, pix = chip_smoke._request(torch, proc, 0)
    n = args.steps
    result = {"device": name, "prompt_len": int(ids.shape[1]), "steps": n, "arms": {}}
    for arm, qargs, kv_int8 in [("bf16", None, False)] + chip_smoke.QUANT_ARMS:
        m = model if qargs is None else quantization.quantize_params(model, llm_only=True, **qargs)
        cache = generation.make_cache(m, 1, ids.shape[1], n + 1, torch.int8 if kv_int8 else None)

        def prefilled():
            c = gemma.reset_cache(cache)
            logits, c = generation.prefill(m, ids, pix, c)
            return logits[:, -1].argmax(-1).to(torch.int32)[:, None], c

        tok, c = prefilled()
        one_ms = generation.prepare_decode(m, c)
        run_whole, whole_ms = whole_chunk_graph(torch, m, c, n)
        runs = {
            "one_step": lambda tok, c: generation.decode_steps(m, tok, c, n)[0],
            "whole": run_whole,
            "eager": lambda tok, c: chip_smoke.eager_chunk(torch, m, tok, c, n)[0],
        }
        times = {k: [] for k in runs}
        tokens = {}
        for kind in ("one_step", "whole", "whole", "one_step", "eager", "eager"):
            tok, c = prefilled()
            toks, host, dev = chip_smoke._chunk_times(torch, lambda: runs[kind](tok, c))
            times[kind].append((host / n, dev / n))
            tokens.setdefault(kind, toks)
        chip_smoke.check(tokens["one_step"] == tokens["whole"] == tokens["eager"],
                         f"{arm}: the chunks' tokens differ")
        rec = {"capture_ms": {"one_step": one_ms, "whole": whole_ms}, "ms_per_token": times}
        result["arms"][arm] = rec
        print(f"[{arm}] capture ms: one_step {one_ms:.2f}, whole {whole_ms:.2f} | ms/token host / "
              "device-event: " + " | ".join(
                  f"{k} " + ", ".join(f"{h:.4f} / {d:.4f}" for h, d in v) for k, v in times.items()),
              flush=True)
        del run_whole, cache, c, m
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

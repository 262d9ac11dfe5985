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
   masked tiles, poisoned K/V past the valid length, head_dim 72, and the
   flash kernel's tile edges in both of its tilings: T=S at 63, 64, 65 and
   129, whole kv tiles masked, head_dim 8 and 256, GQA 8:1 with a window); decode
   attention at the cluster's edges (S = 1, 17, the main path's 308, one
   past each cluster size the host picks, 4128 with one visible position,
   blocks with no visible position under a poisoned tail, the longest
   cache its shared memory holds) and over an int8 cache at S = 308, 1100
   and 4128 with a poisoned tail, bit-identical to the bf16 kernel over the
   dequantized cache; one q and one set of visible rows (292, then 1000)
   poisoned past them in caches of each length from 308 (1024) to 4128
   give one output bit for bit, bf16 and int8 cache; a 30000-position
   cache raises ValueError before any launch. Decode attention's verify
   shape (T in 2, 4, 8, 13, 16 queries a row, query i seeing valid + i
   positions; bf16 and int8 cache; S = 308, 1100, 4128; batch 1 and batch
   2 with per-row valid lengths; poisoned past the last query's positions):
   each query row bit for bit the one-query kernel at valid + i, the whole
   within the plain version's bar; T = 17 raises ValueError before any
   launch. The quant kernels
   (q8_matmul, q4_matmul, w4a8_gemv, w4a8_geglu, quant_rows and the
   mlp_w4a8 they make up) at every decode shape of the 3B model, at 64 and
   276 rows, at the flat q4a8_matmul shapes, at ragged rows and widths, at
   the q8/q4 GEMV's edges (M in 1, 2, 3, 8, 9, 33, 64 by O in 200, 201,
   2560 by D in 2048, 16416, bf16 and fp32 out), at the GEMM's edges (65
   rows, O not a multiple of 128, strided rows, split K with D not a
   multiple of the split, fp32 out, 1044 rows), at the w4a8 GEMV's edges
   (M in 1, 2, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64 by O in 520, 1000
   by D in 64, 96, 2048, 16384, bf16 and fp32 out; bit-identical), with
   its quantizing prologue at 1 to 8 strided rows (bit-identical), and
   the MLP on both of its routes with a repeated call bit for bit the
   first; the int8 x int8 projection (torch._int_mm) against its exact
   plain version.
4. Main path at full width: PaliGemma-3B-224 in bf16 with seeded random
   weights made on the card, the byte-tokenizer processor, and three
   requests answered by ``generation.generate`` (32 new tokens each; one
   replay of the prefill graph of the request's shape, then one replay of
   the captured decode step a token, after one untimed request of each
   shape, which captures both), with the kernels' launch counts, prefill
   ms (a replayed prefill, to the first token) and decode ms/token per
   request; then the first request's decode again as one
   ``decode_steps`` chunk, which must give the same tokens; and the peak
   device memory. Then the
   model is quantized on the card in each serving arm (``QUANT_ARMS``: int8,
   w4a8, w4a8 with the 4-bit lm_head, int4, int8 with the int8 KV cache,
   int8 with the int8 x int8 prefill) and the first request is answered
   again in each, with every kernel's launch count (and the int8 x int8
   calls) held to the count the code implies.
5. Kernel path vs plain path: the first request again with the plain
   kernel functions, in bf16 and in each quantized arm; the prefill's
   last-position logits and those of the next few decode steps (fed the
   kernel path's greedy tokens) must agree within the stated tolerance and
   the first greedy token must be identical.
6. Timing: the device time per call of each kernel and its plain version at
   the main-path shapes (CUDA events around CUDA-graph replays, so host
   dispatch is not timed), beside its bound (the larger of its bytes over
   the card's memory rate and its operations over the peak rate of their
   type) and the time of one PyTorch call that computes the same function,
   where there is one (never called by the port); flash also at the 448-
   and 896-px presets' lengths; decode attention also in the verify shape
   (T = 8 at S = 308 and 1100, SDPA with the boolean threshold mask beside).
7. Decode as a CUDA graph (run after phase 5, before the timing), with the
   final norm's scale redrawn so that greedy streams change token
   (``phase_graph``): in bf16 and in each quantized arm, request 0:
   ``generate``'s launch counts held to the code's; ``decode_steps`` (31
   replays of the captured step) and the eager step (issued launch by
   launch) must give ``generate``'s 31 decode tokens, with the graph
   chunk's launches the code's, greedy, and sampled under one seed (graph
   chunk against eager chunk); the capture ms, and the host and
   device-event ms/token of both chunks (best of two); one graph chunk
   under torch.profiler, whose CUPTI kernel records of each port kernel
   must equal the launches its replays added; ``generate_chunked`` (chunk
   8) and ``generate_scan`` must give ``generate``'s tokens, greedy and
   sampled, with no EOS and with an EOS inside the stream (trimmed, and
   frozen in the scan), each with its prefill a replay of its graph. Then
   sampled decode through the graph
   (bf16, temperature 0.8, top_p 0.9): one seed repeats its stream (also
   through ``generate_chunked``), another seed differs, every id is in the
   vocab, and temperature 0 is greedy; and the phase's peak memory
   (``utils.memory.peak_memory_mb``).
8. Prefill as a CUDA graph (run after phase 5, before phase 7 and the
   timing; ``phase_prefill_graph``): in bf16 and in each quantized arm,
   request 0, on caches of ``generate``'s shape: the first call of the
   shape (the eager prefill as the capture's warm-up) and three replays
   must equal the eager prefill (``models/paligemma.prefill`` launched
   from Python) bit for bit: last-position logits, first token, the K/V
   rows (and the int8 cache's scales), length and valid. Each replay's
   launches (and int8 x int8 calls) equal ``_expected_launches(cfg,
   qargs, T, 0)``, and one replay under torch.profiler holds each port
   kernel's CUPTI records to the launches it added. Reported: graph and
   eager prefill host ms (to the first token's read) and device-event ms,
   best of 3; the first call's host ms and the capture ms (warm-up
   included); ``prepare_prefill``'s ms; the device memory one graph holds
   (its pool, released when it goes; and ``memory_allocated`` after its
   capture).

9. Checkpoint (after phase 5): the seeded bf16 model written as HF-layout
   safetensors shards with a config.json by the port's writer
   (``utils/checkpoint.save_hf_checkpoint``) to a temporary directory,
   loaded back on the card by ``load_model``, whole and streaming: every
   tensor bit for bit, request 0's greedy tokens unchanged; the write and
   load seconds, the GB written and the process's peak host RSS; the
   directory removed.
10. Batched serving (after phase 7; the final norm redrawn as there):
    ``serving.batch_generate`` of phase 4's three requests and a repeat at
    batch 4, bf16 and int8: launch counts the code's; each row's first
    token its batch-1 first token, its last-position prefill logits within
    phase 5's 2% bar of batch 1's; the tokens agreeing with batch 1 and the
    decode ms a step of 4 rows.
11. Ablation (the final norm redrawn): ``ablation_study_torch``'s grid cut
    to one length (128), one image and one run, both arms, bf16 at full
    width, launches the code's; the first token identical across arms and
    the first uncached step's logits within 2% of the cached prefill's;
    the match count, ms/token and peak memory per arm.
12. CLI: ``inference_torch.py --demo`` as a subprocess, plain and with
    ``--speculative``, exit 0 on cuda.
13. Speculative decoding (after phase 7; ``phase_speculative``): request 0
    through ``generate_spec`` (k = 8, n = 3, the n-gram and the
    longest-match drafter) in bf16 on the seeded model (a stream that
    repeats one token: acceptance), then with the final norm redrawn as in
    phase 7, in bf16 and in every quantized arm: ``verify_step``'s k logits
    rows within phase 5's bar of k sequential ``decode_step`` calls; the
    spec tokens ``generate``'s up to the first position where the two
    paths' argmaxes differ, where the sequential step's top two logits lie
    within that bar of each other; launches the code's (each verify
    iteration one forward of k rows); ``tokens_per_verify`` and host
    ms/token of a ``decode_steps_spec`` chunk against a ``decode_steps``
    chunk; sampled, one seed one stream and temperature 0 the greedy one.

14. Continuous serving (after phase 12; ``phase_continuous``; the final
    norm redrawn as in phase 7). First, one request's join prefill
    (``serving.batched_prefill``) at group batch 1 and at group batch 32,
    the request at row 0 in both: row 0 compared op by op
    (``utils/rowdiff``, every ATen op and every kernel call), the first op
    at which it parts printed; gated: that op is not a kernel of the port.
    Then twelve requests (phase 4's three and nine
    more over two prompt buckets, 8-48 new tokens) through 4-slot engines
    with chunk 8: bf16 plain, int8 with the int8 KV cache
    (``kv_quant``), bf16 speculative (k = 8, adaptive, the cache window)
    with each drafter, and bf16 with greedy and sampled requests mixed
    (the sampled streams repeat under one seed). Every greedy request
    gives its batch-1 ``generate`` tokens in that arm, or its first
    difference falls where batch 1's top two logits lie within phase 5's
    2% bar; every request ends without an error; launches per engine.
    Then the throughput cell at ``server.py``'s shipped configuration (32
    slots, chunk 32, the adaptive k = 8 ladder at spec_chunk 16, the
    window on, one bucket of the image tokens + 64, 64 new tokens; 64
    requests submitted at once) in bf16 and int8: every graph captured by
    ``prepare`` (ms and MiB each), an untimed run, a timed run in which no
    graph may be captured (delivered tokens/s of wall time, chunks, join
    groups, the ``host_t`` split, window resizes, staged upload hits and
    misses, peak MiB), and a run under torch.profiler for the device-busy
    share. Then ``server_torch.build_server`` serves the in-memory bf16
    model on localhost (continuous, 4 slots, chunk 8): four concurrent
    /generate requests and one /generate_stream give the tokens an engine
    of the same settings gives in-process, and /metrics answers.
15. LoRA training (after phase 14; ``phase_lora_train``): on the seeded
    bf16 model, r 8, alpha 16, dropout 0.1, one batch of B = 2 rows at T =
    320 (256 image tokens + 64 text, the second right-padded to 300,
    labels as ``data.py`` builds them). Gated: the flash Function's forward
    at that shape bit for bit the no-grad kernel and its dq, dk, dv
    those of autograd of the plain version; the lm_head's d hidden against
    autograd of the widened fp32 product; one step's adapter gradients
    through the kernels against the plain versions (B seeded non-zero);
    then 8 micro-steps with accumulation 2: the loss finite and falling,
    45 flash launches a micro-step and no other kernel. Reported: each
    micro-step's host and device-event ms, the optimizer step's, peak MiB,
    the flash forward / backward / plain / SDPA forward + backward ms
    beside the bounds; the adapter saved with ``save_checkpoint_robust``
    and read back bit for bit. The eager run is ``lora.train_step``; then
    ``lora.make_train_step``'s compiled step (CUDA graph replays) runs the
    same 8 micro-steps from the same adapter, optimizer state and dropout
    generator state. Gated: each loss, the final adapter, the optimizer
    state and the generator bit for bit the eager run's; one capture a
    flavour (accumulate, apply), at its first micro-step, none after; the
    same launches. Reported: capture ms and pool MiB a flavour, peak MiB,
    the compiled micro-step's host and device-event ms, both steps' kernel
    ms and busy share under torch.profiler. Then ``lora.make_eval_loss``
    (the finetune CLI's ``--eval_only`` loss): the first call and a replay
    bit for bit the eager ``no_grad`` loss; graph and eager host and
    kernel ms.
16. LoRA serving (``phase_lora_serving``; the final norm redrawn as in
    phase 7): a lora_rank 8 engine (4 slots, chunk 8) in bf16 and int8
    serves a base request, the trained adapter, a seeded rank-4 adapter
    (padded) and a base request: base requests give the base engine's
    tokens exactly, adapted ones differ from base, no capture after
    ``prepare``; in bf16 each adapted request against ``merge_lora``'s
    batch-1 ``generate`` and alone in a 1-slot engine (phase 10's
    near-tie rule), and the slot step and verify ms at 4 rows with and
    without ``lora_rank``. Then ``server_torch.build_server`` with
    ``--continuous --adapter trained=DIR`` lists it in /healthz and answers
    a request naming it with the in-process engine's tokens.
17. Parallelism (``phase_parallel``; the final norm redrawn as in phase 7):
    two ranks spawned on the one card over gloo (NCCL refuses two ranks on
    one device), each making the seeded 3B model on the card and taking
    its slices with ``parallel.sharding.shard_params``. Gated: each rank's
    parameter bytes equal the rules' count, in bf16 and int8; phase 4's
    three requests through the tensor-parallel model, bf16 and int8:
    ``generate``'s 32 greedy tokens equal the unsharded model's or part at
    a near tie (phase 10's rule), the sharded prefill's last-position logits
    within phase 5's bar, each rank's launches those the code implies
    (flash 27 + 18 a prefill, decode 18 a token, q8 73 a token in int8); a
    (2, 1) data-parallel prefill's rows within the bar of the unsharded
    batch's; one DP x TP LoRA micro-step (1, 2) at B = 2, T = 320 against
    the unsharded step within phase 15's gradient bars; a 2-stage pipelined
    loss within 0.5% of the unsharded loss; a 2-rank tensor-parallel
    continuous engine (4 slots, chunk 8, phase 14's identity traffic, no
    graph over gloo) against the unsharded engine (near-tie rule where they
    part). Then a world-size-1 NCCL group in this process: the sharded
    decode captured as a CUDA graph with its collectives inside, its replay
    bit for bit the eager step. Reported, not gated: which collectives
    gloo runs on CUDA tensors, per-rank host ms of a prefill and a decode
    token over gloo (not a tensor-parallel speed), the host copies of the
    pipeline's gloo point-to-point, per-rank peak MiB. Sequence parallelism
    at an odd length (``[parallel sp]`` lines): request 0's image with a
    277-token prompt (padded to 278 over the two ranks), in bf16 and in
    int8 with ``prefill_a8``: the last-position logits bit for bit the
    rank's tensor-parallel prefill without sequence parallelism, and within
    phase 5's bar of the unsharded prefill's (bf16; the a8 arm holds its
    argmax: the TP a8 prefill sits 3.1% from the unsharded one, ROADMAP
    Queue 3); nothing written to the cache past T; flash once a layer (and
    the int8 x int8 products 4 a layer); layer 0's down product under
    sequence parallelism bit for bit the whole a8 product's rows; each
    rank's host ms over gloo.
18. Surfaces (``phase_surfaces``, ``[surfaces ...]`` lines; its seconds on
    a line of their own): ``scripts/validate_checkpoint_torch.py``'s
    ``run_checks`` on the seeded bf16 model written as HF-layout shards,
    with the byte-tokenizer processor passed in and 16 tokens, every
    check's status and details printed. config, tokenizer (source
    "given"), load and lora_smoke pass; logit_parity passes against HF
    transformers in fp32 on the CPU where transformers is installed, and
    is skipped for its absence where it is not; int8_identity,
    w4a8_agreement and lm_head_w4_agreement pass or part from the bf16
    stream at a near tie (phase 10's rule; the parting and the top-two gap
    printed); a8_prefill_agreement is recorded; flash, decode attention,
    q8, the w4a8 GEMV and GeGLU are launched by the run. Then
    ``app_torch.py --demo`` under ``_StubStreamlit`` (bf16 on the card):
    its answer equal to a direct ``inference_torch.test_inference`` call,
    a second ``get_model()`` a cache hit, flash and decode attention
    launched. Then ``paligemma_tpu_torch.native`` built with g++ from the
    checkout's ``native/preproc.cpp``, on a 480 x 640 image within
    tests/test_native.py's bars of the PIL processor path.

Phase 3 also holds batched serving's decode (batch 4, per-row valid, the
window's end read on the device: bit for bit the host end's, also from a
replayed graph), each row of batch-4 flash calls bit for bit its batch-1
call, flash at the ablation's buffers (T = S = 512 with 276 valid, 640,
768, 1024), the q8 GEMV at M = 4, the GEMM at 4 x 276 and 640 / 1024 rows,
and the w4a8 MLP at 4 rows; phase 6 times them beside the rest, and the
continuous engine's shapes: decode attention at 33 rows (per-row valid)
at each window width of the throughput cell and its k = 8 verify, q8 at
33 and 264 rows, the w4a8 MLP at 33 rows; and a tensor-parallel rank's
shapes at model = 2 (phase 17): flash with half the heads (SigLIP H=8, the
prefill and the training batch at H=4 Hkv=1), decode and the engine's
verify at 4 query heads a kv head, q8 at the rank's qkv, o, gate_up, down
and lm_head widths (o and down with fp32 out) at 1, 33, 264 and 276 rows.

The second-to-last line is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
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
DECODE_CHECK_STEPS = 3  # decode steps held to the plain path after the prefill
# Phase 7: generate_chunked's chunk, and the sampled decode's settings.
GRAPH_CHUNK = 8
SAMPLE_TEMPERATURE, SAMPLE_TOP_P = 0.8, 0.9
# The quantized serving arms: (name, quantize_params arguments, int8 KV cache).
QUANT_ARMS = [
    ("int8", {"mode": "int8"}, False),
    ("w4a8", {"mode": "w4a8"}, False),
    ("w4a8+lm_head_w4", {"mode": "w4a8", "lm_head_w4": True}, False),
    ("int4", {"mode": "int4"}, False),
    ("int8+kv_int8", {"mode": "int8"}, True),
    ("int8+prefill_a8", {"mode": "int8", "prefill_a8": True}, False),
]
# The card's published peaks (H100 SXM data sheet, dense, at 700 W) for the
# bound of each timed call.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
# A timed call whose weights would fit in the 50 MB L2 cycles through enough
# copies of them to stream this many bytes, as a decode step streams every
# layer's weights in turn.
L2_FLUSH_BYTES = 100e6

# Substrings of the CUDA kernel names of each counted wrapper's kernels in
# a CUPTI trace, first match wins (phase 7; torch_profile.py's groups).
KERNEL_SYMBOLS = [
    ("q4_matmul", ("Int4Rows",)),
    ("q8_matmul", ("Int8Rows",)),
    ("w4a8_gemv", ("w4a8_gemv_kernel",)),
    ("w4a8_geglu", ("w4a8_geglu_kernel",)),
    ("quant_rows", ("quant_rows_kernel",)),
    ("flash_attention", ("flash_attention_kernel",)),
    ("decode_attention", ("decode_",)),
]
TRACE_TRIES = 3  # traces of a chunk whose records fall short of its launches
# Phase 7's final-norm scale (1 + w) is redrawn from this seed; see phase_graph.
GREEDY_NORM_SEED = SEED + 3

# flash_attention against its plain version (phase 3): name, (b, t, h, hkv, d),
# keyword arguments, and the kv position from which K and V are poisoned.
FLASH_CASES = [
    ("siglip-224 T=S=256 H=16 D=72 (fused views)", (1, 256, 16, 16, 72), {}, None),
    ("gemma prefill T=S=276 H=8 Hkv=1 D=256", (1, 276, 8, 1, 256), {}, None),
    ("896-px siglip T=S=4096 H=16 D=72", (1, 4096, 16, 16, 72), {}, None),
    ("896-px gemma prefill T=S=4110 H=8 Hkv=1 D=256", (1, 4110, 8, 1, 256), {}, None),
    ("B=2 valid=[37,200] window=[150,170) D=64", (2, 200, 4, 2, 64),
     {"valid_len": [37, 200], "gen_start": 150, "gen_end": 170}, None),
    ("ragged T=S=45 H=2 Hkv=1 D=128", (1, 45, 2, 1, 128), {}, None),
    ("masked tiles + poison valid=20 of 200 D=72", (1, 200, 4, 4, 72), {"valid_len": 20}, 20),
    ("head_dim 40 GQA 3:1", (2, 70, 6, 2, 40), {"valid_len": [70, 33]}, None),
    # The kernel's tile edges: 32-row query blocks with 64-row kv tiles
    # split over warp pairs while one batch row's grid is small, 64-row
    # query blocks with 32-row kv tiles once it fills the card (T x H
    # raise it; the batch never chooses the tiling).
    ("T=S=63 H=16 D=72", (1, 63, 16, 16, 72), {}, None),
    ("T=S=64 H=8 Hkv=1 D=256", (1, 64, 8, 1, 256), {}, None),
    ("T=S=65 H=8 Hkv=1 D=256", (1, 65, 8, 1, 256), {}, None),
    ("T=S=129 H=16 D=8", (1, 129, 16, 16, 8), {}, None),
    ("T=S=129 B=4 H=16 D=72 (32-row blocks at B=4)", (4, 129, 16, 16, 72), {}, None),
    ("T=S=129 B=2 H=48 D=72 (64-row blocks)", (2, 129, 48, 48, 72), {}, None),
    ("T=S=65 B=9 H=8 Hkv=1 D=256", (9, 65, 8, 1, 256), {}, None),
    ("T=S=65 B=3 H=72 Hkv=9 D=256 (64-row blocks)", (3, 65, 72, 9, 256), {}, None),
    ("masked kv tiles + poison valid=70 of 300 D=256", (1, 300, 8, 1, 256), {"valid_len": 70}, 70),
    ("masked kv tiles B=4 valid=[70,300,5,129] D=256", (4, 300, 8, 1, 256),
     {"valid_len": [70, 300, 5, 129]}, None),
    ("masked kv tiles B=4 valid=[70,300,5,129] H=32 Hkv=4 D=256 (64-row blocks)", (4, 300, 32, 4, 256),
     {"valid_len": [70, 300, 5, 129]}, None),
    ("GQA 8:1 valid=200 window=[230,250) D=256", (1, 276, 8, 1, 256),
     {"valid_len": 200, "gen_start": 230, "gen_end": 250}, None),
    # A tensor-parallel rank's shapes at model = 2 (phase 17): half the heads.
    ("TP rank siglip T=S=256 H=8 D=72", (1, 256, 8, 8, 72), {}, None),
    ("TP rank gemma prefill T=S=276 H=4 Hkv=1 D=256", (1, 276, 4, 1, 256), {}, None),
    ("TP rank training B=2 T=S=320 valid=[320,300] H=4 Hkv=1 D=256", (2, 320, 4, 1, 256),
     {"valid_len": [320, 300]}, None),
]
# Decode attention over one set of visible rows in caches of each length
# (phase 3): valid, the cache lengths (clusters of 8 and 16 blocks, one and
# more tiles a block).
DECODE_LENGTH_CASES = [(292, (308, 320, 384, 512, 1100, 4128)), (1000, (1024, 1100, 4128))]
# The decode kernel's verify shape (phase 3): queries a row, cache lengths.
VERIFY_QUERIES = (2, 4, 8, 13, 16)
VERIFY_LENGTHS = (308, 1100, 4128)
# The q8/q4 GEMV's edge cases (phase 3): rows of x, output rows, depth.
GEMV_EDGE_ROWS = (1, 2, 3, 8, 9, 33, 64)
GEMV_EDGE_OUT = (200, 201, 2560)
GEMV_EDGE_DEPTH = (2048, 16416)
# The w4a8 GEMV's edge cases (phase 3): each count of n8 tiles of x rows and
# one row on either side, O with a ragged last 16-row tile, D of one to 64
# ring steps.
W4A8_EDGE_ROWS = (1, 2, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64)
W4A8_EDGE_OUT = (520, 1000)
W4A8_EDGE_DEPTH = (64, 96, 2048, 16384)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


@functools.lru_cache(maxsize=None)
def _smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def phase_device(torch):
    log(_smi())
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
        msg = f"[kernel] {kind:16s} {name:60s} max_abs_err {err:.3e}"
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

    for name, (b, t, h, hkv, d), kw, poison in FLASH_CASES:
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
        # The cluster's edges: one position, the main path's length, one past
        # each cluster size the host picks (1, 2, 4, 8, 16 blocks), one
        # visible position, blocks with no visible position.
        ("S=1 valid=1", (1, 1, 8, 1, 256), [1], {}, None),
        ("S=17 D=64", (1, 17, 8, 1, 64), [17], {}, None),
        ("main path S=308 valid=292", (1, 308, 8, 1, 256), [292], {}, None),
        ("cluster edge S=65", (1, 65, 8, 1, 256), [65], {}, None),
        ("cluster edge S=129", (1, 129, 8, 1, 256), [129], {}, None),
        ("cluster edge S=257", (1, 257, 8, 1, 256), [257], {}, None),
        ("cluster edge S=513", (1, 513, 8, 1, 256), [513], {}, None),
        ("S=4128 valid=1 + poison", (1, 4128, 8, 1, 256), [1], {}, 1),
        ("masked blocks + poison valid=40 of 1100", (1, 1100, 8, 1, 256), [40], {}, 40),
        # The longest cache the kernel's shared memory holds.
        (f"longest S={ca.decode_max_len(8, 256)} + poison", (1, ca.decode_max_len(8, 256), 8, 1, 256),
         [ca.decode_max_len(8, 256) - 5], {}, ca.decode_max_len(8, 256) - 5),
        # A tensor-parallel rank at model = 2 (phase 17): 4 query heads a kv head.
        ("TP rank main path S=308 valid=292 H=4 Hkv=1", (1, 308, 4, 1, 256), [292], {}, None),
        ("TP rank cluster edge S=513 H=4 Hkv=1 + poison", (1, 513, 4, 1, 256), [400], {}, 400),
    ]
    for name, (b, s, h, hkv, d), valid, kw, poison in decode_cases:
        kc = _rand(torch, gen, (3, b, s, hkv, d), dev)[1]  # a layer of a stacked cache
        vc = _rand(torch, gen, (3, b, s, hkv, d), dev)[1]
        q = _rand(torch, gen, (b, 1, h, d), dev)
        vt = torch.tensor(valid, dtype=torch.int32, device=dev)
        run_case("decode_attention", name, ca.decode_attention, ca.decode_attention_plain,
                 (q, kc, vc, vt), dict(kw, scale=d**-0.5), poison)

    # The int8 cache: bit for bit the bf16 kernel over the cache dequantized
    # as the reference reads it, within the bar of the plain version, and
    # blind to a poisoned tail (values and scales) past the valid length.
    from paligemma_tpu_torch.models.gemma import quantize_kv_rows

    for s_len, valid in ((308, 292), (1100, 700), (4128, 4100)):
        q = _rand(torch, gen, (1, 1, 8, 256), dev)
        (kq, ks), (vq, vs) = (quantize_kv_rows(_rand(torch, gen, (3, 1, s_len, 1, 256), dev)) for _ in range(2))
        kq, ks, vq, vs = kq[1], ks[1], vq[1], vs[1]  # a layer of a stacked cache
        vt = torch.tensor([valid], dtype=torch.int32, device=dev)
        kw = dict(scale=256**-0.5, k_scale=ks, v_scale=vs)
        out = ca.decode_attention(q, kq, vq, vt, **kw)
        deq = [ca.dequantize_cache(c, c_s, torch.bfloat16) for c, c_s in ((kq, ks), (vq, vs))]
        same_as_bf16 = torch.equal(out, ca.decode_attention(q, *deq, vt, scale=256**-0.5))
        err, ok = _close(torch, out, ca.decode_attention_plain(q, kq, vq, vt, **kw))
        for c, c_s in ((kq, ks), (vq, vs)):
            c[:, valid:], c_s[:, valid:] = 127, 1e4
        same_poisoned = torch.equal(ca.decode_attention(q, kq, vq, vt, **kw), out)
        torch.cuda.synchronize()
        log(f"[kernel] {'decode_attention':16s} {f'int8 cache S={s_len} valid={valid} + poison':44s} "
            f"max_abs_err {err:.3e} | bit-identical to the dequantized bf16 cache: {same_as_bf16} "
            f"| poisoned tail unchanged: {same_poisoned}")
        check(ok and same_as_bf16 and same_poisoned, f"int8-cache decode S={s_len}: kernel disagrees")
        max_err["decode_attention"] = max(max_err["decode_attention"], err)

    # The result depends on the visible rows, never on the buffer's length:
    # one q and one set of visible rows, poisoned past them, in caches of
    # each length give one output bit for bit, bf16 and int8 cache.
    for valid, lengths in DECODE_LENGTH_CASES:
        q = _rand(torch, gen, (1, 1, 8, 256), dev)
        rows = [_rand(torch, gen, (1, valid, 1, 256), dev) for _ in range(2)]
        vt = torch.tensor([valid], dtype=torch.int32, device=dev)
        for kv in ("bf16", "int8"):
            outs, worst, all_ok = [], 0.0, True
            for s_len in lengths:
                k, v = (torch.full((3, 1, s_len, 1, 256), 1e4, dtype=torch.bfloat16, device=dev) for _ in range(2))
                k[1, :, :valid], v[1, :, :valid] = rows
                kw = dict(scale=256**-0.5)
                if kv == "int8":
                    (k, ks), (v, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
                    kw.update(k_scale=ks[1], v_scale=vs[1])
                outs.append(ca.decode_attention(q, k[1], v[1], vt, **kw))  # a layer of a stacked cache
                err, ok = _close(torch, outs[-1], ca.decode_attention_plain(q, k[1], v[1], vt, **kw))
                worst, all_ok = max(worst, err), all_ok and ok
            torch.cuda.synchronize()
            same = all(torch.equal(out, outs[0]) for out in outs[1:])
            log(f"[kernel] {'decode_attention':16s} {f'{kv} cache valid={valid} poisoned past it, S in {lengths}':60s} "
                f"max_abs_err {worst:.3e} | bit-identical at every S: {same}")
            check(all_ok and same, f"{kv}-cache decode valid={valid}: the output depends on the cache length")
            max_err["decode_attention"] = max(max_err["decode_attention"], worst)

    # Batched serving's decode: per-row valid lengths and a shared window
    # whose end is read on the device, bit for bit the host int's result
    # (also from a graph replayed as the end moves), within the bar of the
    # plain version, blind to rows poisoned past the end; bf16 and int8.
    for kv in ("bf16", "int8"):
        b, s_len, w0 = 4, 340, 276
        valid = torch.tensor([276, 250, 263, 276], dtype=torch.int32, device=dev)
        q = _rand(torch, gen, (b, 1, 8, 256), dev)
        k, v = _rand(torch, gen, (2, b, s_len, 1, 256), dev), _rand(torch, gen, (2, b, s_len, 1, 256), dev)
        kw = dict(scale=256**-0.5)
        if kv == "int8":
            (k, ks), (v, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
            kw.update(k_scale=ks[1], v_scale=vs[1])
        k, v = k[1], v[1]  # a layer of a stacked cache
        end = torch.zeros((), dtype=torch.int32, device=dev)
        ca.decode_attention(q, k, v, valid, gen_start=w0, gen_end=end, **kw)  # warm-up
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = ca.decode_attention(q, k, v, valid, gen_start=w0, gen_end=end, **kw)
        all_same, worst, all_ok = True, 0.0, True
        for w1 in (277, 290, 308):
            end.fill_(w1)
            dev_out = ca.decode_attention(q, k, v, valid, gen_start=w0, gen_end=end, **kw)
            host_out = ca.decode_attention(q, k, v, valid, gen_start=w0, gen_end=w1, **kw)
            graph.replay()
            kp, vp = k.clone(), v.clone()
            kp[:, w1:], vp[:, w1:] = (1e4, 1e4) if kv == "bf16" else (127, 127)
            poisoned = ca.decode_attention(q, kp, vp, valid, gen_start=w0, gen_end=end, **kw)
            torch.cuda.synchronize()
            all_same = all_same and all(torch.equal(x, host_out) for x in (dev_out, replayed, poisoned))
            err, ok = _close(torch, dev_out, ca.decode_attention_plain(q, k, v, valid, gen_start=w0, gen_end=end, **kw))
            worst, all_ok = max(worst, err), all_ok and ok
        log(f"[kernel] {'decode_attention':16s} {f'{kv} B=4 S=340 valid=[276,250,263,276] window [276, end) end on the device':60s} "
            f"max_abs_err {worst:.3e} | bit-identical to the host end, in a replayed graph and poisoned past "
            f"the end (end 277, 290, 308): {all_same}")
        check(all_ok and all_same, f"{kv} decode with the window end on the device disagrees")
        max_err["decode_attention"] = max(max_err["decode_attention"], worst)

    # Flash at the slice's shapes: each row of a batch-4 call bit for bit the
    # batch-1 call of that row (the tiling never reads the batch), and the
    # ablation's buffers (a 512-position bucket with 276 valid, the no-cache
    # pass over 640 / 768 / 1024 positions), within the plain version's bar.
    for name, (b, t, h, hkv, d), valid in (
        ("batched prefill B=4 T=S=276 H=8 Hkv=1 D=256", (4, 276, 8, 1, 256), [276, 250, 263, 276]),
        ("ablation bucket B=4 T=S=512 valid=276 D=256", (4, 512, 8, 1, 256), [276] * 4),
        ("siglip-224 B=4 T=S=256 H=16 D=72", (4, 256, 16, 16, 72), None),
        ("no-cache T=S=640 valid=400 D=256", (1, 640, 8, 1, 256), [400]),
        ("no-cache T=S=768 valid=600 D=256", (1, 768, 8, 1, 256), [600]),
        ("no-cache T=S=1024 valid=1000 D=256", (1, 1024, 8, 1, 256), [1000]),
    ):
        q, k, v = qkv_views(b, t, h, hkv, d)
        vl = None if valid is None else torch.tensor(valid, dtype=torch.int32, device=dev)
        out = ca.flash_attention(q, k, v, vl, scale=d**-0.5)
        rows = [ca.flash_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1], None if vl is None else vl[i:i + 1],
                                   scale=d**-0.5) for i in range(b)]
        torch.cuda.synchronize()
        same = all(torch.equal(out[i:i + 1], rows[i]) for i in range(b))
        err, ok = _close(torch, out, ca.flash_attention_plain(q, k, v, vl, scale=d**-0.5))
        log(f"[kernel] {'flash_attention':16s} {name:60s} max_abs_err {err:.3e} | each row bit-identical "
            f"to its batch-1 call: {same}")
        check(ok and same, f"flash {name}: kernel disagrees or a row depends on the batch")
        max_err["flash_attention"] = max(max_err["flash_attention"], err)

    # The verify shape: T queries a row, query i seeing valid + i
    # positions. Each query row bit for bit the one-query kernel at valid + i,
    # the whole within the plain version's bar and blind to a poisoned tail
    # past the last query's positions; bf16 and int8 cache, batch 1 and
    # batch 2 with per-row valid lengths (batch 1's last queries reach S).
    for kv in ("bf16", "int8"):
        for s_len in VERIFY_LENGTHS:
            for valid in ([s_len - 8], [s_len - 40, s_len // 2]):
                b = len(valid)
                q_all = _rand(torch, gen, (b, max(VERIFY_QUERIES), 8, 256), dev)
                k, v = (_rand(torch, gen, (3, b, s_len, 1, 256), dev) for _ in range(2))
                kw = dict(scale=256**-0.5)
                if kv == "int8":
                    (k, ks), (v, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
                    kw.update(k_scale=ks[1], v_scale=vs[1])
                k, v = k[1], v[1]  # a layer of a stacked cache
                vt = torch.tensor(valid, dtype=torch.int32, device=dev)
                worst, all_ok, rows_same, poison_same = 0.0, True, True, True
                for t in VERIFY_QUERIES:
                    q = q_all[:, :t]
                    out = ca.decode_attention(q, k, v, vt, **kw)
                    rows_same = rows_same and all(
                        torch.equal(out[:, i:i + 1], ca.decode_attention(q[:, i:i + 1], k, v, vt + i, **kw))
                        for i in range(t))
                    err, ok = _close(torch, out, ca.decode_attention_plain(q, k, v, vt, **kw))
                    worst, all_ok = max(worst, err), all_ok and ok
                    pk, pv = k.clone(), v.clone()
                    pkw = dict(kw)
                    if kv == "int8":
                        pkw.update(k_scale=kw["k_scale"].clone(), v_scale=kw["v_scale"].clone())
                    for r, n_vis in enumerate(valid):
                        end = n_vis + t - 1  # the last query's visible length
                        pk[r, end:], pv[r, end:] = (1e4, 1e4) if kv == "bf16" else (127, 127)
                        if kv == "int8":
                            pkw["k_scale"][r, end:], pkw["v_scale"][r, end:] = 1e4, 1e4
                    poison_same = poison_same and torch.equal(ca.decode_attention(q, pk, pv, vt, **pkw), out)
                torch.cuda.synchronize()
                log(f"[kernel] {'decode_attention':16s} {f'verify {kv} S={s_len} valid={valid} T in {VERIFY_QUERIES}':60s} "
                    f"max_abs_err {worst:.3e} | each query row bit-identical to the one-query kernel at valid + i: "
                    f"{rows_same} | poisoned tail unchanged: {poison_same}")
                check(all_ok and rows_same and poison_same,
                      f"verify-shape decode {kv} S={s_len} valid={valid}: kernel disagrees")
                max_err["decode_attention"] = max(max_err["decode_attention"], worst)
    # A tensor-parallel rank's verify in the continuous engine (phase 17):
    # 33 rows, k = 8 queries a row, 4 query heads a kv head.
    b, t, s_len = THROUGHPUT["n_slots"] + 1, 8, 384
    q = _rand(torch, gen, (b, t, 4, 256), dev)
    k, v = (_rand(torch, gen, (3, b, s_len, 1, 256), dev)[1] for _ in range(2))
    vt = torch.randint(200, s_len - t, (b,), generator=gen, device=dev).to(torch.int32)
    run_case("decode_attention", f"TP rank verify B={b} T={t} S={s_len} per-row valid H=4 Hkv=1",
             ca.decode_attention, ca.decode_attention_plain, (q, k, v, vt), dict(scale=256**-0.5))
    kc, vc = _rand(torch, gen, (1, 308, 1, 256), dev), _rand(torch, gen, (1, 308, 1, 256), dev)
    before = ca.launch_counts()["decode_attention"]
    try:
        ca.decode_attention(_rand(torch, gen, (1, 17, 8, 256), dev), kc, vc,
                            torch.tensor([290], dtype=torch.int32, device=dev))
        raised = None
    except ValueError as e:
        raised = str(e)
    launched = ca.launch_counts()["decode_attention"] - before
    log(f"[kernel] {'decode_attention':16s} T=17 raises ValueError before any launch ({launched} launches): "
        f"{raised!r}")
    check(raised is not None and launched == 0, "decode T=17: no ValueError before the launch")

    # A cache longer than the kernel's shared memory holds raises on the
    # host, before any launch.
    s_len = 30000
    kc, vc = _rand(torch, gen, (1, s_len, 1, 256), dev), _rand(torch, gen, (1, s_len, 1, 256), dev)
    before = ca.launch_counts()["decode_attention"]
    try:
        ca.decode_attention(_rand(torch, gen, (1, 1, 8, 256), dev), kc, vc,
                            torch.tensor([s_len], dtype=torch.int32, device=dev))
        raised = None
    except ValueError as e:
        raised = str(e)
    launched = ca.launch_counts()["decode_attention"] - before
    log(f"[kernel] {'decode_attention':16s} S={s_len} raises ValueError before any launch "
        f"({launched} launches): {raised!r}")
    check(raised is not None and launched == 0, f"decode S={s_len}: no ValueError before the launch")
    return max_err


def phase_quant_kernels(torch):
    """The int8 and w4a8 kernels against their plain versions; returns max
    errors per kernel (quant_rows: in quantization steps)."""
    from paligemma_tpu_torch.ops import quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    max_err = {"q8_matmul": 0.0, "q4_matmul": 0.0, "w4a8_gemv": 0.0, "w4a8_geglu": 0.0, "quant_rows": 0.0,
               "mlp_w4a8": 0.0}

    def ints(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32).to(torch.int8)

    def scales(o, d, q_std):
        """Per-row scales that give outputs of about unit size."""
        return (torch.rand(o, generator=gen, device=dev) + 0.5) / (q_std * math.sqrt(d))

    def held(kind, name, got, ref):
        torch.cuda.synchronize()
        err, ok = _close(torch, got, ref)
        log(f"[kernel] {kind:16s} {name:44s} max_abs_err {err:.3e} | bit-identical {torch.equal(got, ref)}")
        check(ok, f"{kind} {name}: kernel disagrees with its plain version")
        max_err[kind] = max(max_err[kind], err)

    q8_cases = [
        # name, m, o, d, fp32 out
        ("decode qkv M=1 O=2560 D=2048", 1, 2560, 2048, False),
        ("decode o M=1 O=2048 D=2048", 1, 2048, 2048, False),
        ("decode gate_up M=1 O=32768 D=2048", 1, 32768, 2048, False),
        ("decode down M=1 O=2048 D=16384", 1, 2048, 16384, False),
        ("decode lm_head M=1 O=257152 D=2048 fp32", 1, 257152, 2048, True),
        ("GEMV M=64 O=2560 D=2048", 64, 2560, 2048, False),
        ("GEMV M=9 O=2048 D=16384 (passes over D)", 9, 2048, 16384, False),
        ("prefill GEMM M=276 O=32768 D=2048", 276, 32768, 2048, False),
        ("prefill GEMM M=276 O=2048 D=16384", 276, 2048, 16384, False),
        ("GEMM M=276 O=2560 D=2048 fp32", 276, 2560, 2048, True),
        ("siglip fc1 GEMM M=256 O=4304 D=1152", 256, 4304, 1152, False),
        ("ragged GEMV M=3 O=1000 D=336", 3, 1000, 336, False),
        ("ragged GEMM M=130 O=200 D=48", 130, 200, 48, False),
        # The GEMM's edges: the first row count it takes, O not a multiple
        # of its 128-column blocks, D not a multiple of splits x 64 (split
        # K), and fp32 out with split K.
        ("GEMM M=65 O=2560 D=2048", 65, 2560, 2048, False),
        ("GEMM M=276 O=200 D=2048", 276, 200, 2048, False),
        ("split-K GEMM M=276 O=2048 D=16400", 276, 2048, 16400, False),
        ("split-K GEMM M=276 O=2048 D=16384 fp32", 276, 2048, 16384, True),
        ("448-px GEMM M=1044 O=2048 D=16384", 1044, 2048, 16384, False),
        # Batched serving (batch 4) and the no-cache pass.
        ("batch-4 decode qkv GEMV M=4 O=2560 D=2048", 4, 2560, 2048, False),
        ("batch-4 decode gate_up GEMV M=4 O=32768 D=2048", 4, 32768, 2048, False),
        ("batch-4 decode down GEMV M=4 O=2048 D=16384", 4, 2048, 16384, False),
        ("batch-4 lm_head GEMV M=4 O=257152 D=2048 fp32", 4, 257152, 2048, True),
        ("batch-4 prefill GEMM M=4x276 O=32768 D=2048", 1104, 32768, 2048, False),
        ("no-cache GEMM M=640 O=2560 D=2048", 640, 2560, 2048, False),
        ("no-cache GEMM M=1024 O=2048 D=16384", 1024, 2048, 16384, False),
        # A tensor-parallel rank at model = 2 (phase 17): qkv with half the
        # query heads and the kv head, gate_up halves and the vocab half
        # column-parallel; o and down row-parallel with fp32 out (their
        # partial sums are reduced before one rounding); decode, prefill and
        # the engine's slot step (33 rows) and k = 8 verify (264 rows).
        *((f"TP rank {what} M={m} O={o} D={d}{' fp32' if f32 else ''}", m, o, d, f32)
          for m, what in ((1, "decode"), (276, "prefill"), (33, "slot step"), (264, "verify k=8"))
          for o, d, f32 in ((1536, 2048, False), (2048, 1024, True), (16384, 2048, False), (2048, 8192, True))),
        ("TP rank decode lm_head M=1 O=128576 D=2048 fp32", 1, 128576, 2048, True),
        ("TP rank slot step lm_head M=33 O=128576 D=2048 fp32", 33, 128576, 2048, True),
    ]
    for name, m, o, d, f32 in q8_cases:
        x, q = _rand(torch, gen, (m, d), dev), ints((o, d), -127, 128)
        s = scales(o, d, 73.0)
        out_dtype = torch.float32 if f32 else torch.bfloat16
        held("q8_matmul", name, quant.q8_matmul(x, q, s, out_dtype), quant.q8_matmul_plain(x, q, s, out_dtype))
    # Rows with a stride (a column slice of a wider tensor, as a last-position
    # slice of the hidden states is).
    wide = _rand(torch, gen, (5, 512), dev)
    q, s = ints((300, 256), -127, 128), scales(300, 256, 73.0)
    held("q8_matmul", "strided rows M=5 O=300 D=256 (stride 512)",
         quant.q8_matmul(wide[:, 128:384], q, s), quant.q8_matmul_plain(wide[:, 128:384], q, s))
    wide_gemm = _rand(torch, gen, (130, 4096), dev)
    q, s = ints((520, 2048), -127, 128), scales(520, 2048, 73.0)
    held("q8_matmul", "strided GEMM rows M=130 O=520 D=2048 (stride 4096)",
         quant.q8_matmul(wide_gemm[:, 1024:3072], q, s), quant.q8_matmul_plain(wide_gemm[:, 1024:3072], q, s))

    q4_cases = [
        # name, m, o, d, fp32 out
        ("decode qkv M=1 O=2560 D=2048", 1, 2560, 2048, False),
        ("decode o M=1 O=2048 D=2048", 1, 2048, 2048, False),
        ("decode gate_up M=1 O=32768 D=2048", 1, 32768, 2048, False),
        ("decode down M=1 O=2048 D=16384", 1, 2048, 16384, False),
        ("GEMV M=64 O=2560 D=2048", 64, 2560, 2048, False),
        ("GEMV M=9 O=2048 D=16384 (passes over D)", 9, 2048, 16384, False),
        ("prefill GEMM M=276 O=2560 D=2048", 276, 2560, 2048, False),
        ("prefill GEMM M=276 O=32768 D=2048", 276, 32768, 2048, False),
        ("prefill GEMM M=276 O=2048 D=16384", 276, 2048, 16384, False),
        ("GEMM M=276 O=2048 D=2048 fp32", 276, 2048, 2048, True),
        ("ragged GEMV M=3 O=1000 D=352", 3, 1000, 352, False),
        ("ragged GEMM M=130 O=200 D=64", 130, 200, 64, False),
        ("GEMM M=65 O=2560 D=2048", 65, 2560, 2048, False),
        ("GEMM M=276 O=200 D=2048", 276, 200, 2048, False),
        ("siglip fc1 GEMM M=256 O=4304 D=1152", 256, 4304, 1152, False),
        ("split-K GEMM M=276 O=2048 D=16416", 276, 2048, 16416, False),
        ("split-K GEMM M=276 O=2048 D=16384 fp32", 276, 2048, 16384, True),
        ("448-px GEMM M=1044 O=2048 D=16384", 1044, 2048, 16384, False),
    ]
    for name, m, o, d, f32 in q4_cases:
        x, packed = _rand(torch, gen, (m, d), dev), quant.pack_int4(ints((o, d), -7, 8))
        s = scales(o, d, 4.3)
        out_dtype = torch.float32 if f32 else torch.bfloat16
        held("q4_matmul", name, quant.q4_matmul(x, packed, s, out_dtype),
             quant.q4_matmul_plain(x, packed, s, out_dtype))
    packed, s = quant.pack_int4(ints((300, 256), -7, 8)), scales(300, 256, 4.3)
    held("q4_matmul", "strided rows M=5 O=300 D=256 (stride 512)",
         quant.q4_matmul(wide[:, 128:384], packed, s), quant.q4_matmul_plain(wide[:, 128:384], packed, s))
    packed, s = quant.pack_int4(ints((520, 2048), -7, 8)), scales(520, 2048, 4.3)
    held("q4_matmul", "strided GEMM rows M=130 O=520 D=2048 (stride 4096)",
         quant.q4_matmul(wide_gemm[:, 1024:3072], packed, s),
         quant.q4_matmul_plain(wide_gemm[:, 1024:3072], packed, s))

    # The GEMV's edges in both formats: each count of n8 tiles of x rows,
    # O with a ragged last 16-row tile, D with a ragged last chunk of K, bf16
    # and fp32 out.
    for m in GEMV_EDGE_ROWS:
        worst = {"q8_matmul": 0.0, "q4_matmul": 0.0}
        for o in GEMV_EDGE_OUT:
            for d in GEMV_EDGE_DEPTH:
                x = _rand(torch, gen, (m, d), dev)
                q8, q4 = ints((o, d), -127, 128), quant.pack_int4(ints((o, d), -7, 8))
                s8, s4 = scales(o, d, 73.0), scales(o, d, 4.3)
                for out_dtype in (torch.bfloat16, torch.float32):
                    for kind, got, ref in (
                        ("q8_matmul", quant.q8_matmul(x, q8, s8, out_dtype), quant.q8_matmul_plain(x, q8, s8, out_dtype)),
                        ("q4_matmul", quant.q4_matmul(x, q4, s4, out_dtype), quant.q4_matmul_plain(x, q4, s4, out_dtype)),
                    ):
                        torch.cuda.synchronize()
                        err, ok = _close(torch, got, ref)
                        check(ok, f"{kind} GEMV edge M={m} O={o} D={d} {out_dtype}: kernel disagrees")
                        worst[kind] = max(worst[kind], err)
                        max_err[kind] = max(max_err[kind], err)
        log(f"[kernel] GEMV edges M={m:<2d} O in {GEMV_EDGE_OUT} D in {GEMV_EDGE_DEPTH}, bf16 and fp32 out: "
            f"max_abs_err q8 {worst['q8_matmul']:.3e} q4 {worst['q4_matmul']:.3e}")

    # The int8 x int8 projection (prefill_a8): torch._int_mm, not a kernel of
    # the port; exact integer sums and the same epilogue as its plain version.
    for name, m, o, d in (("a8 prefill qkv M=276 O=2560 D=2048", 276, 2560, 2048),
                          ("a8 prefill down M=276 O=2048 D=16384", 276, 2048, 16384)):
        x, q = _rand(torch, gen, (1, m, d), dev), ints((o, d), -127, 128)
        s = scales(o, d, 73.0)
        got, ref = quant.a8_matmul(x, q, s), quant.a8_matmul_plain(x, q, s)
        torch.cuda.synchronize()
        log(f"[library] {'a8_matmul':15s} {name:44s} bit-identical to the exact plain version: "
            f"{torch.equal(got, ref)}")
        check(torch.equal(got, ref), f"a8_matmul {name}: torch._int_mm route disagrees with plain")

    rows_cases = [
        # name, m, width, GeGLU prologue
        ("decode mlp input M=1 D=2048", 1, 2048, False),
        ("decode GeGLU M=1 2I=32768", 1, 32768, True),
        ("GeGLU M=64 2I=32768", 64, 32768, True),
        ("prefill rows M=276 D=2048", 276, 2048, False),
        ("ragged M=70 D=200", 70, 200, False),
        ("ragged GeGLU M=3 2I=80", 3, 80, True),
    ]
    for name, m, width, geglu in rows_cases:
        x = _rand(torch, gen, (m, width), dev)
        x[0, :4] = torch.tensor([127.0, 0.5, 1.5, -2.5], device=dev)  # exact ties at xs = 1
        xq, xs = quant.quant_rows(x, geglu)
        pq, ps = quant.quant_rows_plain(x, geglu)
        torch.cuda.synchronize()
        steps = int((xq.int() - pq.int()).abs().max())
        # Exact integer stages: the same scales to the bit and the same int8
        # values, but for the GeGLU prologue, whose fp32 tanh may differ from
        # PyTorch's by an ulp and move one value across a rounding step.
        ok = torch.equal(xs, ps) and steps <= (1 if geglu else 0)
        log(f"[kernel] {'quant_rows':16s} {name:44s} max step diff {steps} | scales identical "
            f"{torch.equal(xs, ps)}")
        check(ok, f"quant_rows {name}: kernel disagrees with its plain version")
        max_err["quant_rows"] = max(max_err["quant_rows"], steps)

    # The w4a8 GEMV: exact integer sums and the plain version's fp32
    # epilogue, so bit-identical in every case. The main-path shapes, then
    # the tiling's edges: each count of n8 tiles of x rows and one row on
    # either side, O with a ragged last 16-row tile, D of one to 64 ring
    # steps (a ragged last one), more than 64 rows (row groups over the
    # grid), bf16 and fp32 out.
    def exact(kind, name, got, ref):
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        same = torch.equal(got, ref)
        log(f"[kernel] {kind:16s} {name:44s} max_abs_err {err:.3e} | bit-identical {same}")
        check(same, f"{kind} {name}: kernel is not bit-identical to its plain version")
        max_err[kind] = max(max_err[kind], err)

    def w4_weight(o, d, x_std):
        return quant.pack_int4(ints((o, d), -7, 8)), scales(o, d, 4.3 * x_std)

    w4_cases = [
        # name, m, o, d, fp32 out
        ("decode gate_up M=1 O=32768 D=2048", 1, 32768, 2048, False),
        ("decode down M=1 O=2048 D=16384", 1, 2048, 16384, False),
        ("decode lm_head M=1 O=257152 D=2048 fp32", 1, 257152, 2048, True),
        ("GEMV M=64 O=32768 D=2048", 64, 32768, 2048, False),
        ("GEMV M=13 O=2048 D=16384 (split K)", 13, 2048, 16384, False),
        ("ragged M=7 O=1000 D=96", 7, 1000, 96, False),
        ("M=100 O=520 D=64 (two row groups)", 100, 520, 64, False),
    ]
    for name, m, o, d, f32 in w4_cases:
        xq, xs = ints((m, d), -127, 128), torch.rand(m, generator=gen, device=dev) * 0.02 + 1e-3
        packed, s = w4_weight(o, d, 73.0 * 0.02)
        out_dtype = torch.float32 if f32 else torch.bfloat16
        exact("w4a8_gemv", name, quant.w4a8_gemv(xq, xs, packed, s, out_dtype),
              quant.w4a8_gemv_plain(xq, xs, packed, s, out_dtype))
    for m in W4A8_EDGE_ROWS:
        worst, cases = 0.0, 0
        for o in W4A8_EDGE_OUT:
            for d in W4A8_EDGE_DEPTH:
                xq, xs = ints((m, d), -127, 128), torch.rand(m, generator=gen, device=dev) * 0.02 + 1e-3
                packed, s = quant.pack_int4(ints((o, d), -8, 8)), scales(o, d, 4.3 * 73.0 * 0.02)
                for out_dtype in (torch.bfloat16, torch.float32):
                    got, ref = quant.w4a8_gemv(xq, xs, packed, s, out_dtype), quant.w4a8_gemv_plain(
                        xq, xs, packed, s, out_dtype)
                    torch.cuda.synchronize()
                    check(torch.equal(got, ref), f"w4a8_gemv edge M={m} O={o} D={d} {out_dtype}: not bit-identical")
                    worst = max(worst, float((got.float() - ref.float()).abs().max()))
                    cases += 1
        log(f"[kernel] w4a8_gemv edges M={m:<2d} O in {W4A8_EDGE_OUT} D in {W4A8_EDGE_DEPTH}, bf16 and fp32 "
            f"out: {cases} cases bit-identical (max_abs_err {worst:.3e})")

    # The quantizing prologue (q4a8_matmul up to W4A8_PROLOGUE_MAX_ROWS
    # rows: one launch), bit-identical to quant_rows + the GEMV in plain:
    # the lm_head and the flat TPU layout's benchmark shapes, the routed
    # rows, strided rows and the first row count above them; then the
    # prologue up to the 8 rows the kernel takes (the routing rule raised
    # for these cases only).
    max_rows = quant.W4A8_PROLOGUE_MAX_ROWS
    q4a8_cases = [
        ("lm_head M=1 O=257152 D=2048 fp32", 1, 257152, 2048, True, max_rows),
        ("q4a8 flat qkv M=1 O=2560 D=2048", 1, 2560, 2048, False, max_rows),
        ("q4a8 flat gate_up M=1 O=32768 D=2048", 1, 32768, 2048, False, max_rows),
        (f"down M={max_rows} O=2048 D=16384", max_rows, 2048, 16384, False, max_rows),
        (f"M={max_rows + 1} O=2048 D=2048 (quant_rows first)", max_rows + 1, 2048, 2048, False, max_rows),
        *((f"prologue rows M={m} O=1000 D=96", m, 1000, 96, m % 2 == 0, 8) for m in range(2, 9)),
        ("prologue rows M=8 O=2048 D=16384 (the largest)", 8, 2048, 16384, False, 8),
    ]
    for name, m, o, d, f32, routed in q4a8_cases:
        wide = _rand(torch, gen, (m, d + 64), dev)  # rows with a stride
        x = wide[:, 32:32 + d]
        x[0, :4] = torch.tensor([127.0, 0.5, 1.5, -2.5], device=dev)  # exact ties at xs = 1
        packed, s = w4_weight(o, d, 1.0)
        out_dtype = torch.float32 if f32 else torch.bfloat16
        quant.W4A8_PROLOGUE_MAX_ROWS = routed
        try:
            got = quant.q4a8_matmul(x, packed, s, out_dtype)
        finally:
            quant.W4A8_PROLOGUE_MAX_ROWS = max_rows
        exact("w4a8_gemv", f"{name} strided", got, quant.q4a8_matmul_plain(x, packed, s, out_dtype))

    # w4a8_geglu (the gate_up GEMV with the GeGLU epilogue): h within the
    # kernel bar of the plain version, and h quantized as the down GEMV's
    # prologue quantizes it gives the plain h's scales to the bit and its
    # int8 values within one step (the fp32 tanh's ulp, as quant_rows').
    for name, m, d, inter in (("decode gate_up M=1 D=2048 I=16384", 1, 2048, 16384),
                              ("M=8 D=2048 I=16384 (the prologue's limit)", 8, 2048, 16384),
                              ("ragged M=3 D=96 I=40", 3, 96, 40)):
        x = _rand(torch, gen, (1, m, d), dev)
        gu, gs = w4_weight(2 * inter, d, 1.0)
        h, ref = quant.w4a8_geglu(x, gu, gs), quant.w4a8_geglu_plain(x, gu, gs)
        (hq, hs), (pq, ps) = quant.quantize_rows_s8(h), quant.quantize_rows_s8(ref)
        torch.cuda.synchronize()
        err, ok = _close(torch, h, ref)
        steps = int((hq.int() - pq.int()).abs().max())
        log(f"[kernel] {'w4a8_geglu':16s} {name:44s} max_abs_err {err:.3e} | h quantized: scales identical "
            f"{torch.equal(hs, ps)}, max step diff {steps}")
        check(ok and torch.equal(hs, ps) and steps <= 1, f"w4a8_geglu {name}: kernel disagrees with its plain version")
        max_err["w4a8_geglu"] = max(max_err["w4a8_geglu"], err)

    # The whole MLP: two launches up to W4A8_PROLOGUE_MAX_ROWS rows, four
    # above; a call leaves no state behind (the same input after another
    # gives the same output, bit for bit).
    d, inter = 2048, 16384
    gu, gs = quant.pack_int4(ints((2 * inter, d), -7, 8)), scales(2 * inter, d, 4.3)
    dn, ds = quant.pack_int4(ints((d, inter), -7, 8)), scales(d, inter, 4.3 * 0.7)
    for m in sorted({1, 4, 5, 13, 64, max_rows, max_rows + 1}):  # 4: batched serving's decode
        x = _rand(torch, gen, (1, m, d), dev)
        got = quant.mlp_w4a8(x, gu, gs, dn, ds)
        held("mlp_w4a8", f"3B MLP M={m} D=2048 I=16384", got, quant.mlp_w4a8_plain(x, gu, gs, dn, ds))
        quant.mlp_w4a8(_rand(torch, gen, (1, m, d), dev) * 4, gu, gs, dn, ds)
        again = quant.mlp_w4a8(x, gu, gs, dn, ds)
        torch.cuda.synchronize()
        check(torch.equal(again, got), f"mlp_w4a8 M={m}: a repeated call gives another output")
    return max_err


def _time_ms(torch, fn, iters=20, replays=5):
    """Device ms per call: ``fn(0) .. fn(iters - 1)`` captured in one CUDA
    graph, the graph replayed ``replays`` times between two CUDA events. Host
    dispatch is outside the window (a loop of eager calls would time the host
    for a call that runs in microseconds). ``fn(i)`` may pick the i-th of
    several weight copies, so that a call finds its weights outside L2."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):  # warm-up outside the capture
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def _bound(nbytes: float, ops: float, kind: str):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _copies(make, nbytes):
    """Enough copies of the tensors ``make()`` returns to stream L2_FLUSH_BYTES."""
    return [make() for _ in range(min(20, max(1, math.ceil(L2_FLUSH_BYTES / nbytes))))]


def _time_rows(torch, kind, rows, library=None):
    """Times each row in turns (plain, kernel, kernel, plain) and the
    library call (named by ``library``); returns the kernel's record for the
    kernels line: means per launch weighted by the main path's calls per
    token (or request)."""
    log(f"[time] {kind:16s} library call: {library or 'none'}")
    by_shape, tot = [], collections.Counter()
    # Rows none of which the main path runs are averaged with equal weights.
    means = [row[1] for row in rows] if any(row[1] for row in rows) else [1] * len(rows)
    for (label, weight, kfn, pfn, lfn, (nbytes, ops, op_kind)), mean_w in zip(rows, means):
        p1, k1, k2, p2 = (_time_ms(torch, f) for f in (pfn, kfn, kfn, pfn))
        km, pm = (k1 + k2) / 2, (p1 + p2) / 2
        lm = None if lfn is None else _time_ms(torch, lfn)
        bound, bound_by = _bound(nbytes, ops, op_kind)
        lib = "none" if lm is None else f"{lm:.4f}"
        log(f"[time] {kind:16s} {label:52s} device ms/call: kernel {km:.4f} | plain {pm:.4f} | "
            f"library {lib} | bound {bound:.4g} ({bound_by}) "
            f"(turns: plain {p1:.4f}, kernel {k1:.4f}, kernel {k2:.4f}, plain {p2:.4f})")
        by_shape.append({"shape": label, "ms": km, "plain_ms": pm, "library_ms": lm, "bound_ms": bound,
                         "bound_by": bound_by, "calls_per_main_path_unit": weight})
        if mean_w:
            tot["n"] += mean_w
            tot["ms"] += mean_w * km
            tot["plain_ms"] += mean_w * pm
            tot["bytes"] += mean_w * nbytes / HBM_BYTES_PER_S * 1e3
            tot["ops"] += mean_w * ops / PEAK_OPS_PER_S[op_kind] * 1e3
            tot["bound_ms"] += mean_w * bound
            tot["lib_missing"] += lm is None
            tot["library_ms"] += mean_w * (lm or 0.0)
    n = tot["n"]
    return {
        "ms": tot["ms"] / n, "plain_ms": tot["plain_ms"] / n, "bound_ms": tot["bound_ms"] / n,
        "bound_by": "bytes" if tot["bytes"] >= tot["ops"] else "operations",
        "library_ms": None if tot["lib_missing"] else tot["library_ms"] / n,
        "library": library, "by_shape": by_shape,
    }


def _attention_cost(b, t, s_len, h, hkv, d):
    """(bytes, ops) of attention: q and out of T rows, K and V of S rows."""
    return 2 * 2 * b * t * h * d + 2 * 2 * b * s_len * hkv * d, 4 * b * h * t * s_len * d


def _slot_decode_rows(torch, gen, dev, prompt_len):
    """Phase 6's rows of the continuous engine's shapes at the throughput
    cell (33 rows: 32 slots and the trash row, each at its own length): one
    decode step at each window width, and the per-row verify of k = 8 (18
    launches a slot step or verify; not in the per-launch mean)."""
    import torch.nn.functional as F

    from paligemma_tpu_torch.ops import cuda_attention as ca

    rows, b = [], THROUGHPUT["n_slots"] + 1
    for s_len in _throughput_windows():
        kc, vc = (_rand(torch, gen, (b, s_len, 1, 256), dev) for _ in range(2))
        lens = torch.randint(prompt_len - 20, s_len - 2 * 8 - 1, (b,), generator=gen, device=dev).to(torch.int32)
        for t in (1, 8):
            q = _rand(torch, gen, (b, t, 8, 256), dev)
            vis = lens[:, None] + 1 + torch.arange(t, device=dev)[None, :]  # query i sees valid + i
            seen = torch.arange(s_len, device=dev)[None, None, :] < vis[:, :, None]  # (B, T, S)
            lib = [q.reshape(b, 1, t * 8, 256), kc.reshape(b, 1, s_len, 256), vc.reshape(b, 1, s_len, 256)]
            mask = seen.repeat_interleave(8, dim=1)[:, None]
            n_vis = int((lens + t).sum())  # K/V rows visible to the last query, once
            args = (q, kc, vc, lens + 1)
            rows.append((f"slot {'verify T=8' if t == 8 else 'step T=1'} B={b} S={s_len} per-row valid "
                         f"H=8 Hkv=1 D=256 (18 launches a {'verify' if t == 8 else 'slot step'})", 0,
                         lambda i, a=args: ca.decode_attention(*a, scale=256**-0.5),
                         lambda i, a=args: ca.decode_attention_plain(*a, scale=256**-0.5),
                         lambda i, a=lib, m=mask: F.scaled_dot_product_attention(*a, attn_mask=m, scale=256**-0.5),
                         (2 * 2 * b * t * 8 * 256 + 2 * 2 * n_vis * 256, 4 * 8 * int(vis.sum()) * 256, "bf16")))
    return rows


def phase_timing(torch, prompt_len):
    """Device ms per call of kernel and plain version at the main-path
    shapes, in turns (plain, kernel, kernel, plain), with each call's bound
    and library time; returns {kernel: record}."""
    import torch.nn.functional as F

    from paligemma_tpu_torch.models.gemma import quantize_kv_rows
    from paligemma_tpu_torch.ops import cuda_attention as ca
    from paligemma_tpu_torch.ops import quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    sdpa = F.scaled_dot_product_attention
    result = {}

    # --- attention (K/V resident in L2, as in every earlier run) ---
    fused_sig = _rand(torch, gen, (1, 256, 3 * 1152), dev)
    q_s, k_s, v_s = (x.view(1, 256, 16, 72) for x in fused_sig.split(1152, dim=-1))
    sig_lib = [x.transpose(1, 2).contiguous() for x in (q_s, k_s, v_s)]
    fused_gem = _rand(torch, gen, (1, prompt_len, 2560), dev)
    q_g, k_g, v_g = fused_gem.split([2048, 256, 256], dim=-1)
    q_g, k_g, v_g = q_g.view(1, prompt_len, 8, 256), k_g.view(1, prompt_len, 1, 256), v_g.view(1, prompt_len, 1, 256)
    # One KV head: the 8 query heads of a position are 8 more query rows of
    # one head, so one SDPA call of one head computes the same function.
    gem_lib = [q_g.reshape(1, 1, prompt_len * 8, 256), k_g.reshape(1, 1, prompt_len, 256),
               v_g.reshape(1, 1, prompt_len, 256)]
    flash_rows = [
        ("siglip T=S=256 H=16 D=72", 27,
         lambda i: ca.flash_attention(q_s, k_s, v_s, scale=72**-0.5),
         lambda i: ca.flash_attention_plain(q_s, k_s, v_s, scale=72**-0.5),
         lambda i: sdpa(*sig_lib, scale=72**-0.5), (*_attention_cost(1, 256, 256, 16, 16, 72), "bf16")),
        (f"gemma prefill T=S={prompt_len} H=8 Hkv=1 D=256", 18,
         lambda i: ca.flash_attention(q_g, k_g, v_g, scale=256**-0.5),
         lambda i: ca.flash_attention_plain(q_g, k_g, v_g, scale=256**-0.5),
         lambda i: sdpa(*gem_lib, scale=256**-0.5),
         (*_attention_cost(1, prompt_len, prompt_len, 8, 1, 256), "bf16")),
    ]
    # A tensor-parallel rank at model = 2 (phase 17): half the heads; not
    # in the per-launch mean.
    fused = _rand(torch, gen, (1, 256, 3 * 576), dev)
    tp_sig = [x.view(1, 256, 8, 72) for x in fused.split(576, dim=-1)]
    tp_sig_lib = [x.transpose(1, 2).contiguous() for x in tp_sig]
    fused = _rand(torch, gen, (1, prompt_len, 1536), dev)
    tp_gem = [x.view(1, prompt_len, -1, 256) for x in fused.split([1024, 256, 256], dim=-1)]
    tp_gem_lib = [tp_gem[0].reshape(1, 1, prompt_len * 4, 256), tp_gem[1].reshape(1, 1, prompt_len, 256),
                  tp_gem[2].reshape(1, 1, prompt_len, 256)]
    flash_rows += [
        ("TP rank siglip T=S=256 H=8 D=72", 0,
         lambda i: ca.flash_attention(*tp_sig, scale=72**-0.5),
         lambda i: ca.flash_attention_plain(*tp_sig, scale=72**-0.5),
         lambda i: sdpa(*tp_sig_lib, scale=72**-0.5), (*_attention_cost(1, 256, 256, 8, 8, 72), "bf16")),
        (f"TP rank gemma prefill T=S={prompt_len} H=4 Hkv=1 D=256", 0,
         lambda i: ca.flash_attention(*tp_gem, scale=256**-0.5),
         lambda i: ca.flash_attention_plain(*tp_gem, scale=256**-0.5),
         lambda i: sdpa(*tp_gem_lib, scale=256**-0.5),
         (*_attention_cost(1, prompt_len, prompt_len, 4, 1, 256), "bf16")),
    ]
    # The 448- and 896-px presets' lengths (1024 and 4096 image tokens, and
    # a 20-token prompt in the decoder); not in the per-launch mean.
    for label, t, h, hkv, d in (("448-px siglip", 1024, 16, 16, 72), ("448-px gemma prefill", 1044, 8, 1, 256),
                                ("896-px siglip", 4096, 16, 16, 72), ("896-px gemma prefill", 4110, 8, 1, 256)):
        fused = _rand(torch, gen, (1, t, (h + 2 * hkv) * d), dev)
        qkv = [x.view(1, t, -1, d) for x in fused.split([h * d, hkv * d, hkv * d], dim=-1)]
        lib = ([qkv[0].reshape(1, 1, t * h, d), qkv[1].reshape(1, 1, t, d), qkv[2].reshape(1, 1, t, d)] if hkv == 1
               else [x.transpose(1, 2).contiguous() for x in qkv])
        flash_rows.append((f"{label} T=S={t} H={h} Hkv={hkv} D={d}", 0,
                           lambda i, a=qkv, d=d: ca.flash_attention(*a, scale=d**-0.5),
                           lambda i, a=qkv, d=d: ca.flash_attention_plain(*a, scale=d**-0.5),
                           lambda i, a=lib, d=d: sdpa(*a, scale=d**-0.5),
                           (*_attention_cost(1, t, t, h, hkv, d), "bf16")))
    # Batched serving's prefill (batch 4, right-padded rows, the valid
    # lengths through SDPA's boolean mask), the ablation's 512-position
    # bucket with 276 valid, and its no-cache pass over 640 / 768 / 1024
    # positions (T = S = the buffer, the prompt's 276 + the tokens so far
    # visible); not in the per-launch mean.
    q4, k4, v4 = qkv_batch = [x.view(4, prompt_len, -1, 256) for x in _rand(
        torch, gen, (4, prompt_len, 2560), dev).split([2048, 256, 256], dim=-1)]
    valid4 = torch.tensor([prompt_len, prompt_len - 26, prompt_len - 13, prompt_len], dtype=torch.int32, device=dev)
    mask4 = (torch.arange(prompt_len, device=dev)[None, :] < valid4[:, None])[:, None, None, :]
    lib4 = [q4.reshape(4, 1, prompt_len * 8, 256), k4.reshape(4, 1, prompt_len, 256),
            v4.reshape(4, 1, prompt_len, 256)]
    flash_rows.append((f"batched prefill B=4 T=S={prompt_len} per-row valid H=8 Hkv=1 D=256", 0,
                       lambda i: ca.flash_attention(*qkv_batch, valid4, scale=256**-0.5),
                       lambda i: ca.flash_attention_plain(*qkv_batch, valid4, scale=256**-0.5),
                       lambda i: sdpa(*lib4, attn_mask=mask4, scale=256**-0.5),
                       (2 * 2 * 4 * prompt_len * 8 * 256 + 2 * 2 * int(valid4.sum()) * 256,
                        4 * 8 * prompt_len * int(valid4.sum()) * 256, "bf16")))
    for t, valid in ((512, prompt_len), (640, prompt_len + 128), (768, prompt_len + 256), (1024, prompt_len + 512)):
        fused = _rand(torch, gen, (1, t, 2560), dev)
        qkv = [x.view(1, t, -1, 256) for x in fused.split([2048, 256, 256], dim=-1)]
        vt = torch.tensor([valid], dtype=torch.int32, device=dev)
        lib = [qkv[0].reshape(1, 1, t * 8, 256), qkv[1][:, :valid].reshape(1, 1, valid, 256),
               qkv[2][:, :valid].reshape(1, 1, valid, 256)]
        flash_rows.append((f"{'ablation bucket' if t == 512 else 'no-cache pass'} T=S={t} valid={valid} H=8 Hkv=1 D=256", 0,
                           lambda i, a=qkv, vt=vt: ca.flash_attention(*a, vt, scale=256**-0.5),
                           lambda i, a=qkv, vt=vt: ca.flash_attention_plain(*a, vt, scale=256**-0.5),
                           lambda i, a=lib: sdpa(*a, scale=256**-0.5),
                           (*_attention_cost(1, t, valid, 8, 1, 256), "bf16")))
    result["flash_attention"] = _time_rows(torch, "flash_attention", flash_rows,
                                           library="F.scaled_dot_product_attention")
    s_main = prompt_len + MAX_NEW_TOKENS
    rows = []
    # The main path's length, then about the 448-px and 896-px presets' lengths.
    for s_len, valid in ((s_main, prompt_len + MAX_NEW_TOKENS // 2), (1100, 1100), (4128, 4128)):
        kc = _rand(torch, gen, (18, 1, s_len, 1, 256), dev)[9]
        vc = _rand(torch, gen, (18, 1, s_len, 1, 256), dev)[9]
        q = _rand(torch, gen, (1, 1, 8, 256), dev)
        vt = torch.tensor([valid], dtype=torch.int32, device=dev)
        lib = [q.reshape(1, 1, 8, 256), kc[:, :valid].reshape(1, 1, valid, 256).contiguous(),
               vc[:, :valid].reshape(1, 1, valid, 256).contiguous()]
        # Only the first (main-path) shape counts in the per-launch mean.
        rows.append((f"decode S={s_len} valid={valid} H=8 Hkv=1 D=256", 18 if s_len == s_main else 0,
                     lambda i, a=(q, kc, vc, vt): ca.decode_attention(*a, scale=256**-0.5),
                     lambda i, a=(q, kc, vc, vt): ca.decode_attention_plain(*a, scale=256**-0.5),
                     lambda i, a=lib: sdpa(*a, scale=256**-0.5),
                     (*_attention_cost(1, 1, valid, 8, 1, 256), "bf16")))
    # The int8 cache at the same lengths (the int8+kv_int8 arm's decode; not
    # in the per-launch mean). No PyTorch call reads an int8 cache: none.
    for s_len, valid in ((s_main, prompt_len + MAX_NEW_TOKENS // 2), (1100, 1100), (4128, 4128)):
        (kq, ks), (vq, vs) = (quantize_kv_rows(_rand(torch, gen, (18, 1, s_len, 1, 256), dev)) for _ in range(2))
        args = (_rand(torch, gen, (1, 1, 8, 256), dev), kq[9], vq[9], torch.tensor([valid], dtype=torch.int32, device=dev))
        kw = dict(scale=256**-0.5, k_scale=ks[9], v_scale=vs[9])
        # Bytes: q and out, and the visible int8 K and V rows with their scales.
        nbytes = 2 * 2 * 8 * 256 + 2 * valid * (256 + 4)
        rows.append((f"int8 cache decode S={s_len} valid={valid} H=8 Hkv=1 D=256", 0,
                     lambda i, a=args, k=kw: ca.decode_attention(*a, **k),
                     lambda i, a=args, k=kw: ca.decode_attention_plain(*a, **k), None,
                     (nbytes, 4 * 8 * valid * 256, "bf16")))
    # Batched serving's decode step: batch 4, each row its prompt and the
    # shared window [T, T + 16) whose end the kernel reads on the device (not
    # in the per-launch mean); SDPA with the same visibility as a boolean mask.
    s_len = prompt_len + 64
    kc, vc = (_rand(torch, gen, (18, 4, s_len, 1, 256), dev)[9] for _ in range(2))
    q = _rand(torch, gen, (4, 1, 8, 256), dev)
    valid4 = torch.tensor([prompt_len, prompt_len - 26, prompt_len - 13, prompt_len], dtype=torch.int32, device=dev)
    end = torch.tensor(prompt_len + 16, dtype=torch.int32, device=dev)
    pos = torch.arange(s_len, device=dev)[None, :]
    seen = (pos < valid4[:, None]) | ((pos >= prompt_len) & (pos < prompt_len + 16))
    lib = [q.reshape(4, 1, 8, 256), kc.reshape(4, 1, s_len, 256), vc.reshape(4, 1, s_len, 256)]
    n_seen = int(seen.sum())
    rows.append((f"batch-4 decode S={s_len} per-row valid, window end on the device H=8 Hkv=1 D=256", 0,
                 lambda i: ca.decode_attention(q, kc, vc, valid4, 256**-0.5, prompt_len, end),
                 lambda i: ca.decode_attention_plain(q, kc, vc, valid4, 256**-0.5, prompt_len, end),
                 lambda i: sdpa(*lib, attn_mask=seen[:, None, None, :], scale=256**-0.5),
                 (2 * 2 * 4 * 8 * 256 + 2 * 2 * n_seen * 256, 4 * 8 * n_seen * 256, "bf16")))
    # The verify shape (a speculative verify step of k = 8 tokens: query i
    # sees valid + i positions) at the main path's length and about the
    # 448-px preset's; not in the per-launch mean. SDPA takes the same
    # visibility as a boolean threshold mask over the visible rows (the
    # port never calls it). Bytes: q and out, and the K/V rows visible to
    # the last query, once.
    t = 8
    for s_len, valid in ((s_main, prompt_len + MAX_NEW_TOKENS // 2), (1100, 1100 - t)):
        v_args = (_rand(torch, gen, (1, t, 8, 256), dev), *(_rand(torch, gen, (18, 1, s_len, 1, 256), dev)[9]
                                                          for _ in range(2)),
                  torch.tensor([valid], dtype=torch.int32, device=dev))
        n_vis = valid + t - 1
        v_seen = (torch.arange(n_vis, device=dev)[None, :]
                  < (valid + torch.arange(t, device=dev)).repeat_interleave(8)[:, None])
        v_lib = [v_args[0].reshape(1, 1, t * 8, 256), v_args[1][:, :n_vis].reshape(1, 1, n_vis, 256).contiguous(),
                 v_args[2][:, :n_vis].reshape(1, 1, n_vis, 256).contiguous()]
        seen_rows = int(v_seen.sum()) // 8  # query-row visible positions, summed over the T queries
        rows.append((f"verify T={t} S={s_len} valid={valid} H=8 Hkv=1 D=256", 0,
                     lambda i, a=v_args: ca.decode_attention(*a, scale=256**-0.5),
                     lambda i, a=v_args: ca.decode_attention_plain(*a, scale=256**-0.5),
                     lambda i, a=v_lib, m=v_seen: sdpa(*a, attn_mask=m[None, None], scale=256**-0.5),
                     (2 * 2 * t * 8 * 256 + 2 * 2 * n_vis * 256, 4 * 8 * seen_rows * 256, "bf16")))
    rows += _slot_decode_rows(torch, gen, dev, prompt_len)
    # A tensor-parallel rank at model = 2 (phase 17): 4 query heads a kv
    # head, batch-1 decode at the main path's length and the engine's k = 8
    # verify of 33 rows; not in the per-launch mean. (Names of their own:
    # the rows above read theirs when they are timed.)
    tp_valid = prompt_len + MAX_NEW_TOKENS // 2
    tp_kc, tp_vc = (_rand(torch, gen, (18, 1, s_main, 1, 256), dev)[9] for _ in range(2))
    tp_args = (_rand(torch, gen, (1, 1, 4, 256), dev), tp_kc, tp_vc,
               torch.tensor([tp_valid], dtype=torch.int32, device=dev))
    tp_lib = [tp_args[0].reshape(1, 1, 4, 256), tp_kc[:, :tp_valid].reshape(1, 1, tp_valid, 256).contiguous(),
              tp_vc[:, :tp_valid].reshape(1, 1, tp_valid, 256).contiguous()]
    rows.append((f"TP rank decode S={s_main} valid={tp_valid} H=4 Hkv=1 D=256", 0,
                 lambda i, a=tp_args: ca.decode_attention(*a, scale=256**-0.5),
                 lambda i, a=tp_args: ca.decode_attention_plain(*a, scale=256**-0.5),
                 lambda i, a=tp_lib: sdpa(*a, scale=256**-0.5),
                 (*_attention_cost(1, 1, tp_valid, 4, 1, 256), "bf16")))
    tp_b, tp_t, tp_s = THROUGHPUT["n_slots"] + 1, 8, 384
    tp_kc, tp_vc = (_rand(torch, gen, (tp_b, tp_s, 1, 256), dev) for _ in range(2))
    tp_lens = torch.randint(prompt_len - 20, tp_s - 2 * tp_t - 1, (tp_b,), generator=gen,
                            device=dev).to(torch.int32)
    tp_args = (_rand(torch, gen, (tp_b, tp_t, 4, 256), dev), tp_kc, tp_vc, tp_lens + 1)
    tp_vis = tp_lens[:, None] + 1 + torch.arange(tp_t, device=dev)[None, :]
    tp_mask = (torch.arange(tp_s, device=dev)[None, None, :] < tp_vis[:, :, None]).repeat_interleave(
        4, dim=1)[:, None]
    tp_lib = [tp_args[0].reshape(tp_b, 1, tp_t * 4, 256), tp_kc.reshape(tp_b, 1, tp_s, 256),
              tp_vc.reshape(tp_b, 1, tp_s, 256)]
    tp_n_vis = int((tp_lens + tp_t).sum())
    rows.append((f"TP rank slot verify T={tp_t} B={tp_b} S={tp_s} per-row valid H=4 Hkv=1 D=256", 0,
                 lambda i, a=tp_args: ca.decode_attention(*a, scale=256**-0.5),
                 lambda i, a=tp_args: ca.decode_attention_plain(*a, scale=256**-0.5),
                 lambda i, a=tp_lib, m=tp_mask: sdpa(*a, attn_mask=m, scale=256**-0.5),
                 (2 * 2 * tp_b * tp_t * 4 * 256 + 2 * 2 * tp_n_vis * 256, 4 * 4 * int(tp_vis.sum()) * 256,
                  "bf16")))
    result["decode_attention"] = _time_rows(torch, "decode_attention", rows,
                                            library="F.scaled_dot_product_attention (bf16 cache only)")

    # --- q8_matmul: weights cycled through copies that overflow L2 ---
    def q8_row(label, weight, m, o, d, f32=False):
        out_dtype = torch.float32 if f32 else torch.bfloat16
        x = _rand(torch, gen, (m, d), dev)
        ws = _copies(lambda: (
            torch.randint(-127, 128, (o, d), generator=gen, device=dev, dtype=torch.int32).to(torch.int8),
            torch.rand(o, generator=gen, device=dev) / (73 * math.sqrt(d))), o * d)
        # The library yardstick: F.linear on the weight dequantized to bf16
        # ahead of time (twice the weight bytes; bf16 out).
        deq = [(q.float() * s[:, None]).to(torch.bfloat16) for q, s in ws]
        n = len(ws)
        nbytes = 2 * m * d + o * d + 4 * o + (4 if f32 else 2) * m * o
        return (label, weight,
                lambda i: quant.q8_matmul(x, *ws[i % n], out_dtype),
                lambda i: quant.q8_matmul_plain(x, *ws[i % n], out_dtype),
                lambda i: F.linear(x, deq[i % n]), (nbytes, 2 * m * o * d, "bf16"))

    # Per decode token of the int8 arm: 18 layers x (qkv, o, gate_up, down)
    # and the lm_head row; prefill and SigLIP shapes are reported beside.
    result["q8_matmul"] = _time_rows(torch, "q8_matmul", [
        q8_row("decode qkv M=1 O=2560 D=2048", 18, 1, 2560, 2048),
        q8_row("decode o M=1 O=2048 D=2048", 18, 1, 2048, 2048),
        q8_row("decode gate_up M=1 O=32768 D=2048", 18, 1, 32768, 2048),
        q8_row("decode down M=1 O=2048 D=16384", 18, 1, 2048, 16384),
        q8_row("decode lm_head M=1 O=257152 D=2048 fp32", 1, 1, 257152, 2048, f32=True),
        q8_row("GEMV M=64 O=32768 D=2048", 0, 64, 32768, 2048),
        q8_row(f"prefill qkv M={prompt_len} O=2560 D=2048", 0, prompt_len, 2560, 2048),
        q8_row(f"prefill gate_up M={prompt_len} O=32768 D=2048", 0, prompt_len, 32768, 2048),
        q8_row(f"prefill down M={prompt_len} O=2048 D=16384", 0, prompt_len, 2048, 16384),
        q8_row("siglip fc1 M=256 O=4304 D=1152", 0, 256, 4304, 1152),
        q8_row(f"prefill qkv M={prompt_len} O=2560 D=2048 fp32", 0, prompt_len, 2560, 2048, f32=True),
        # The 448-px preset's decoder rows (1024 image tokens and a prompt).
        q8_row("448-px prefill gate_up M=1044 O=32768 D=2048", 0, 1044, 32768, 2048),
        q8_row("448-px prefill down M=1044 O=2048 D=16384", 0, 1044, 2048, 16384),
        # Batched serving's decode (batch 4; int8 arm).
        q8_row("batch-4 decode qkv M=4 O=2560 D=2048", 0, 4, 2560, 2048),
        q8_row("batch-4 decode o M=4 O=2048 D=2048", 0, 4, 2048, 2048),
        q8_row("batch-4 decode gate_up M=4 O=32768 D=2048", 0, 4, 32768, 2048),
        q8_row("batch-4 decode down M=4 O=2048 D=16384", 0, 4, 2048, 16384),
        q8_row("batch-4 lm_head M=4 O=257152 D=2048 fp32", 0, 4, 257152, 2048, f32=True),
        # The continuous engine's int8 arm: a slot step of 33 rows (GEMV)
        # and a k = 8 verify of 264 rows (GEMM).
        *(q8_row(f"slot {what} M={m} O={o} D={d}", 0, m, o, d)
          for m, what in ((33, "step"), (264, "verify k=8"))
          for o, d in ((2560, 2048), (2048, 2048), (32768, 2048), (2048, 16384))),
        q8_row("slot step lm_head M=33 O=257152 D=2048 fp32", 0, 33, 257152, 2048, f32=True),
        # A tensor-parallel rank at model = 2 (phase 17), the int8 arm: qkv,
        # gate_up and the vocab half column-parallel, o and down
        # row-parallel with fp32 out.
        *(q8_row(f"TP rank {what} M={m} O={o} D={d}{' fp32' if f32 else ''}", 0, m, o, d, f32=f32)
          for m, what in ((1, "decode"), (prompt_len, "prefill"), (33, "slot step"), (264, "verify k=8"))
          for o, d, f32 in ((1536, 2048, False), (2048, 1024, True), (16384, 2048, False), (2048, 8192, True))),
        q8_row("TP rank decode lm_head M=1 O=128576 D=2048 fp32", 0, 1, 128576, 2048, f32=True),
    ], library="F.linear on the weight dequantized to bf16 ahead of time (bf16 out)")
    del q8_row

    # --- q4_matmul ---
    def q4_row(label, weight, m, o, d):
        x = _rand(torch, gen, (m, d), dev)
        qs = _copies(lambda: torch.randint(-7, 8, (o, d), generator=gen, device=dev, dtype=torch.int32),
                     o * d // 2)
        ws = [(quant.pack_int4(q.to(torch.int8)), torch.rand(o, generator=gen, device=dev) / (4.3 * math.sqrt(d)))
              for q in qs]
        # The library yardstick: torch._weight_int4pack_mm (tinygemm) given
        # the same int4 values, unsigned (q + 8, its zero point 8), every
        # 128-column group of a row with the row's scale (rounded to bf16:
        # it takes bf16 scales) and a zero offset.
        lib_ws = []
        for q, (_, sc) in zip(qs, ws):
            u = q + 8
            w_tiny = torch._convert_weight_to_int4pack((u[:, ::2] << 4 | u[:, 1::2]).to(torch.uint8), 8)
            sz = torch.stack([sc.to(torch.bfloat16)[None].expand(d // 128, o),
                              torch.zeros(d // 128, o, dtype=torch.bfloat16, device=dev)], dim=-1)
            lib_ws.append((w_tiny, sz.contiguous()))
        del qs
        n = len(ws)
        want = quant.q4_matmul_plain(x, *ws[0])
        got = torch._weight_int4pack_mm(x, lib_ws[0][0], 128, lib_ws[0][1])
        torch.cuda.synchronize()
        check(float((got.float() - want.float()).abs().max()) <= LOGIT_REL_TOL * float(want.float().abs().max()),
              f"q4 {label}: the library yardstick computes another function")
        nbytes = 2 * m * d + o * d // 2 + 4 * o + 2 * m * o
        return (label, weight,
                lambda i: quant.q4_matmul(x, *ws[i % n]),
                lambda i: quant.q4_matmul_plain(x, *ws[i % n]),
                lambda i: torch._weight_int4pack_mm(x, lib_ws[i % n][0], 128, lib_ws[i % n][1]),
                (nbytes, 2 * m * o * d, "bf16"))

    # Per decode token of the int4 arm: 18 layers x (qkv, o, gate_up, down);
    # the 64-row GEMV and the prefill GEMMs are reported beside.
    result["q4_matmul"] = _time_rows(torch, "q4_matmul", [
        q4_row("decode qkv M=1 O=2560 D=2048", 18, 1, 2560, 2048),
        q4_row("decode o M=1 O=2048 D=2048", 18, 1, 2048, 2048),
        q4_row("decode gate_up M=1 O=32768 D=2048", 18, 1, 32768, 2048),
        q4_row("decode down M=1 O=2048 D=16384", 18, 1, 2048, 16384),
        q4_row("GEMV M=64 O=32768 D=2048", 0, 64, 32768, 2048),
        q4_row(f"prefill qkv M={prompt_len} O=2560 D=2048", 0, prompt_len, 2560, 2048),
        q4_row(f"prefill gate_up M={prompt_len} O=32768 D=2048", 0, prompt_len, 32768, 2048),
        q4_row(f"prefill down M={prompt_len} O=2048 D=16384", 0, prompt_len, 2048, 16384),
        q4_row("448-px prefill gate_up M=1044 O=32768 D=2048", 0, 1044, 32768, 2048),
        q4_row("448-px prefill down M=1044 O=2048 D=16384", 0, 1044, 2048, 16384),
    ], library="torch._weight_int4pack_mm (tinygemm; the same int4 values, the row scales in bf16)")
    del q4_row

    # --- w4a8_gemv, w4a8_geglu, and the mlp_w4a8 and quant_rows around them ---
    def w4_weights(o, d):
        return _copies(lambda: (
            quant.pack_int4(torch.randint(-7, 8, (o, d), generator=gen, device=dev,
                                          dtype=torch.int32).to(torch.int8)),
            torch.rand(o, generator=gen, device=dev) / (4.3 * math.sqrt(d))), o * d // 2)

    def int_mm(m, o, d, n):
        """The library yardstick: torch._int_mm (int8 x int8 -> int32, no
        quantization, no epilogue) on the weights unpacked to int8 (twice
        the packed bytes), with x padded to 17 rows where it has fewer (the
        call takes more than 16)."""
        xq = torch.randint(-127, 128, (max(m, 17), d), generator=gen, device=dev, dtype=torch.int32).to(torch.int8)
        unpacked = _copies(lambda: torch.randint(-7, 8, (o, d), generator=gen, device=dev,
                                                 dtype=torch.int32).to(torch.int8), o * d)
        k = len(unpacked)
        return lambda i: torch._int_mm(xq, unpacked[i % k].t())

    def w4_row(label, weight, m, o, d, f32=False, prologue=False):
        """The GEMV on int8 rows (``w4a8_gemv``), or with the quantizing
        prologue on bf16 rows (``q4a8_matmul`` of up to
        W4A8_PROLOGUE_MAX_ROWS rows: the lm_head and the MLP's down)."""
        out_dtype = torch.float32 if f32 else torch.bfloat16
        x = _rand(torch, gen, (m, d), dev)
        xq, xs = quant.quant_rows(x)
        ws = w4_weights(o, d)
        n = len(ws)
        nbytes = (2 if prologue else 1) * m * d + 4 * m + o * d // 2 + 4 * o + (4 if f32 else 2) * m * o
        if prologue:
            kfn = lambda i: quant.q4a8_matmul(x, *ws[i % n], out_dtype)  # noqa: E731
            pfn = lambda i: quant.q4a8_matmul_plain(x, *ws[i % n], out_dtype)  # noqa: E731
        else:
            kfn = lambda i: quant.w4a8_gemv(xq, xs, *ws[i % n], out_dtype)  # noqa: E731
            pfn = lambda i: quant.w4a8_gemv_plain(xq, xs, *ws[i % n], out_dtype)  # noqa: E731
        return (label, weight, kfn, pfn, int_mm(m, o, d, n) if o % 8 == 0 else None,
                (nbytes, 2 * m * o * d, "int8"))

    # Per decode token of the w4a8 + lm_head_w4 arm: 18 down GEMVs and the
    # 4-bit lm_head row, both with the quantizing prologue; the GEMV on int8
    # rows (w4a8_gemv itself) is off the batch-1 path, reported beside.
    result["w4a8_gemv"] = _time_rows(torch, "w4a8_gemv", [
        w4_row("decode down M=1 O=2048 D=16384 (prologue)", 18, 1, 2048, 16384, prologue=True),
        w4_row("decode lm_head M=1 O=257152 D=2048 fp32 (prologue)", 1, 1, 257152, 2048, f32=True,
               prologue=True),
        w4_row("q4a8_matmul flat qkv M=1 O=2560 D=2048 (prologue)", 0, 1, 2560, 2048, prologue=True),
        w4_row("q4a8_matmul flat gate_up M=1 O=32768 D=2048 (prologue)", 0, 1, 32768, 2048, prologue=True),
        w4_row("int8 rows gate_up M=1 O=32768 D=2048", 0, 1, 32768, 2048),
        w4_row("int8 rows down M=1 O=2048 D=16384", 0, 1, 2048, 16384),
        w4_row("int8 rows lm_head M=1 O=257152 D=2048 fp32", 0, 1, 257152, 2048, f32=True),
        *(w4_row(f"int8 rows GEMV M={m} O=32768 D=2048", 0, m, 32768, 2048) for m in (8, 16, 32, 64)),
    ], library="torch._int_mm on the weights unpacked to int8 (int32 out, no quantization or epilogue; "
               "x padded to 17 rows below 17)")
    del w4_row

    d, inter = 2048, 16384
    gu_ws = w4_weights(2 * inter, d)
    n_gu = len(gu_ws)
    x1 = _rand(torch, gen, (1, 1, d), dev)
    # Bytes: x, the packed [gate | up] weight and its scales, h.
    result["w4a8_geglu"] = _time_rows(torch, "w4a8_geglu", [
        ("decode gate_up + GeGLU M=1 D=2048 I=16384", 18,
         lambda i: quant.w4a8_geglu(x1, *gu_ws[i % n_gu]), lambda i: quant.w4a8_geglu_plain(x1, *gu_ws[i % n_gu]),
         int_mm(1, 2 * inter, d, n_gu), (2 * d + inter * d + 8 * inter + 2 * inter, 2 * 2 * inter * d, "int8")),
    ], library="torch._int_mm on the [gate | up] weight unpacked to int8, x padded to 17 rows "
               "(the product only)")
    del gu_ws

    mlp_ws = _copies(lambda: (
        quant.pack_int4(torch.randint(-7, 8, (2 * inter, d), generator=gen, device=dev,
                                      dtype=torch.int32).to(torch.int8)),
        torch.rand(2 * inter, generator=gen, device=dev) / (4.3 * math.sqrt(d)),
        quant.pack_int4(torch.randint(-7, 8, (d, inter), generator=gen, device=dev,
                                      dtype=torch.int32).to(torch.int8)),
        torch.rand(d, generator=gen, device=dev) / (3 * math.sqrt(inter))), 3 * d * inter // 2)
    n = len(mlp_ws)

    def mlp_row(label, weight, m):
        x = _rand(torch, gen, (1, m, d), dev)
        # Bytes: x, both packed weights and their scales, the output; the
        # scratch between the launches is the kernels' own traffic.
        nbytes = 2 * m * d + 3 * d * inter // 2 + 4 * (2 * inter + d) + 2 * m * d
        return (label, weight, lambda i: quant.mlp_w4a8(x, *mlp_ws[i % n]),
                lambda i: quant.mlp_w4a8_plain(x, *mlp_ws[i % n]), None, (nbytes, 2 * 3 * m * d * inter, "int8"))

    result["w4a8_geglu"]["mlp_w4a8"] = _time_rows(torch, "mlp_w4a8", [
        mlp_row("decode MLP M=1 D=2048 I=16384 (2 launches)", 18, 1),
        mlp_row("MLP M=64 D=2048 I=16384 (4 launches)", 0, 64),
        mlp_row("slot step MLP M=33 D=2048 I=16384 (4 launches)", 0, 33),
    ])
    del mlp_ws

    def rows_row(label, m, width, geglu):
        x = _rand(torch, gen, (m, width), dev)
        d = width // 2 if geglu else width
        return (label, 0, lambda i: quant.quant_rows(x, geglu),
                lambda i: quant.quant_rows_plain(x, geglu), None,
                (2 * m * width + m * d + 4 * m, (12 if geglu else 3) * m * d, "fp32"))

    # quant_rows runs above W4A8_PROLOGUE_MAX_ROWS rows only: off the batch-1 path.
    result["w4a8_geglu"]["quant_rows"] = _time_rows(torch, "quant_rows", [
        rows_row("mlp input M=1 D=2048", 1, 2048, False),
        rows_row("GeGLU M=1 2I=32768", 1, 32768, True),
        rows_row("GeGLU M=64 2I=32768", 64, 32768, True),
    ])
    return result


def _expected_launches(cfg, qargs, prompt_len, n_dec, batch=1, verify=(0, 0)):
    """The launches the code implies for one request (and the a8_matmul
    calls): the attention kernels only for the bf16 model (``qargs`` None);
    else per forward of R rows, in every layer, int4: qkv, o, gate_up and
    down through q4; else qkv and o through q8, or through a8_matmul with
    prefill_a8 and R >= A8_MIN_SEQ; the MLP through mlp_w4a8 when w4a8 and
    R <= the fused row limit (w4a8_geglu and a w4a8_gemv launch up to the
    prologue's rows, else two quant_rows and two w4a8_gemv launches), else
    two more such int8 projections; the lm_head on one row a batch row per
    forward (a verify step: on its k rows), 4-bit with lm_head_w4 (one
    w4a8_gemv launch, with the quantizing prologue up to its rows, else a
    quant_rows launch first), else q8 on the int8 embedding. The int8 cache
    changes no count. ``batch`` rows: a forward of R rows a row is one of
    batch x R rows (batched serving's prefill takes its lm_head on the rows'
    last positions, one call). ``verify`` = (iterations, k): that many
    speculative verify forwards of k rows, each one decode_attention launch
    a layer (its k queries in one launch)."""
    from paligemma_tpu_torch.ops.quant import MLP_FUSED_MAX_ROWS, W4A8_PROLOGUE_MAX_ROWS
    from paligemma_tpu_torch.quantization import A8_MIN_SEQ

    n_layers = cfg.text_config.num_hidden_layers
    n_verify, k = verify
    want = collections.Counter(flash_attention=cfg.vision_config.num_hidden_layers + n_layers,
                               decode_attention=n_layers * (n_dec + n_verify))
    if qargs is None:
        return want
    mode, lm_head_w4 = qargs["mode"], qargs.get("lm_head_w4", False)
    forwards = [(batch * prompt_len, batch)] + [(batch, batch)] * n_dec + [(batch * k, batch * k)] * n_verify
    for rows, lm_rows in forwards:
        int8_proj = "a8_matmul" if qargs.get("prefill_a8") and rows >= A8_MIN_SEQ else "q8_matmul"
        if mode == "int4":
            want["q4_matmul"] += 4 * n_layers
        elif mode == "w4a8" and rows <= MLP_FUSED_MAX_ROWS:
            want[int8_proj] += 2 * n_layers
            if rows <= W4A8_PROLOGUE_MAX_ROWS:
                want["w4a8_geglu"] += n_layers
                want["w4a8_gemv"] += n_layers
            else:
                want["quant_rows"] += 2 * n_layers
                want["w4a8_gemv"] += 2 * n_layers
        else:
            want[int8_proj] += 4 * n_layers
        if lm_head_w4 and lm_rows <= MLP_FUSED_MAX_ROWS:
            want["w4a8_gemv"] += 1
            want["quant_rows"] += lm_rows > W4A8_PROLOGUE_MAX_ROWS
        else:
            want["q8_matmul"] += 1
    return want


def build_model(torch):
    """PaliGemma-3B-224 in bf16 with seeded random weights made on the card,
    and the byte-tokenizer processor: (cfg, tokenizer, processor, model)."""
    from paligemma_tpu_torch import paligemma_3b_pt_224
    from paligemma_tpu_torch.models import paligemma
    from paligemma_tpu_torch.processing import (
        ByteTokenizer, PaliGemmaProcessor, align_config, assert_aligned,
    )

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
    return cfg, tok, proc, model


def _request(torch, proc, i):
    import numpy as np
    from PIL import Image

    prompt, (w, h) = REQUESTS[i]
    rng = np.random.RandomState(SEED + i)
    img = Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
    inputs = proc([prompt], [img])
    dev = torch.device("cuda")
    return (torch.from_numpy(inputs["input_ids"]).to(dev),
            torch.from_numpy(inputs["pixel_values"]).to(dev, torch.bfloat16))


def _timed_generate(torch, model, ids, pix, tok, cache_dtype=None):
    """generate() with host stamps: (tokens, cache, prefill ms, decode ms/token)."""
    from paligemma_tpu_torch import generation

    stamps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, cache = generation.generate(
        model, ids, pix, MAX_NEW_TOKENS, tok.eos_token_id,
        step_callback=lambda step: stamps.append(time.perf_counter()), cache_dtype=cache_dtype,
    )
    torch.cuda.synchronize()
    n_dec = len(toks) - 1
    return toks, cache, (stamps[0] - t0) * 1e3, (stamps[-1] - stamps[0]) * 1e3 / max(n_dec, 1)


def phase_main_path(torch, model, proc, tok, cfg, main_counts):
    """Three requests through generate(); returns per-request records. The
    launch counts of the run are added to ``main_counts``."""
    from paligemma_tpu_torch import generation
    from paligemma_tpu_torch.ops import kernels

    n_layers_llm = cfg.text_config.num_hidden_layers
    n_layers_vis = cfg.vision_config.num_hidden_layers
    records = []
    # One untimed request of each shape first: generate's cache of that
    # shape (its length rounded up to the pool's bucket) and the decode
    # graph captured on it are then reused. Each timed request drops its
    # cache before the next: a cache still held is not handed out again.
    for i in range(len(REQUESTS)):
        generation.generate(model, *_request(torch, proc, i), MAX_NEW_TOKENS, tok.eos_token_id)
    kernels.reset_launch_counts()  # counts from here on are the main path's
    for i in range(len(REQUESTS)):
        ids, pix = _request(torch, proc, i)
        before = kernels.launch_counts()
        toks, cache, prefill_ms, decode_ms = _timed_generate(torch, model, ids, pix, tok)
        after = kernels.launch_counts()
        flash = after["flash_attention"] - before["flash_attention"]
        decode = after["decode_attention"] - before["decode_attention"]
        n_dec = len(toks) - 1
        text = tok.decode(toks)
        log(f"[request {i}] prompt_len {ids.shape[1]} | {len(toks)} tokens | text {text!r}")
        log(f"[request {i}] launches flash {flash} (expect {n_layers_vis + n_layers_llm}) "
            f"decode {decode} (expect {n_layers_llm} x {n_dec}) | prefill {prefill_ms:.2f} ms (a replay of "
            f"the prefill graph, to the first token) | decode {decode_ms:.3f} ms/token (host clock, "
            f"per-token sync)")
        check(all(0 <= t < cfg.text_config.vocab_size for t in toks), "token id out of range")
        check(cache.length == ids.shape[1] + n_dec, "cache length does not match the tokens")
        check(flash == n_layers_vis + n_layers_llm, f"flash launches {flash} per prefill")
        check(decode == n_layers_llm * n_dec, f"decode launches {decode} for {n_dec} steps")
        check(all(after[k] == before[k] for k in after if "attention" not in k),
              "the bf16 path launched a quant kernel")
        records.append({"ids": ids, "pix": pix, "tokens": toks, "cache_len": cache.max_len,
                        "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms})
        del cache
    main_counts.update(kernels.launch_counts())

    # The chunked decoder (bench.py's decode loop): the same greedy stream
    # with one host sync per chunk instead of one per token.
    rec = records[0]
    # The cache's shape is generate's (its pool rounds the length up): the
    # decode kernel splits the cache by its length, so another length can
    # round differently and flip a near-tie argmax.
    cache = generation.make_cache(model, 1, rec["ids"].shape[1], rec["cache_len"] - rec["ids"].shape[1])
    logits, cache = generation.prefill(model, rec["ids"], rec["pix"], cache)
    first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    capture_ms = generation.prepare_decode(model, cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, _, cache = generation.decode_steps(model, first, cache, len(rec["tokens"]) - 1)
    chunk = toks[0].tolist()  # the one host sync
    dt = time.perf_counter() - t0
    log(f"[decode_steps] {len(chunk)} steps in one chunk (CUDA graph, captured in {capture_ms:.2f} ms "
        f"before): {dt * 1e3 / len(chunk):.3f} ms/token (host clock, one sync) | same tokens as "
        f"generate: {[int(first)] + chunk == rec['tokens']}")
    check([int(first)] + chunk == rec["tokens"], "decode_steps and generate disagree")
    return records


def phase_quant_arm(torch, model, proc, tok, cfg, arm, bf16_rec, main_counts):
    """One serving arm: quantize the bf16 model on the card, answer request 0
    with the kernels (launch counts held to the code's), then hold its
    prefill logits to the plain path's. Returns the arm's record."""
    from paligemma_tpu_torch import generation, quantization
    from paligemma_tpu_torch.models import gemma
    from paligemma_tpu_torch.ops import kernels, quant

    name, qargs, kv_int8 = arm
    cache_dtype = torch.int8 if kv_int8 else None
    ids, pix = bf16_rec["ids"], bf16_rec["pix"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qmodel = quantization.quantize_params(model, llm_only=True, **qargs)
    torch.cuda.synchronize()
    llm_gb = quantization.params_bytes(qmodel.llm) / 1e9
    log(f"[{name}] quantized on the card in {time.perf_counter() - t0:.2f} s | decoder + embeddings "
        f"{llm_gb:.3f} GB (bf16 {quantization.params_bytes(model.llm) / 1e9:.3f} GB)")
    # Warm-up at the timed request's shape: first loads, and the decode
    # graph of generate's cache of that shape.
    generation.generate(qmodel, ids, pix, MAX_NEW_TOKENS, -1, cache_dtype=cache_dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launch_counts()  # the arm's main path, read right after it
    toks, cache, prefill_ms, decode_ms = _timed_generate(torch, qmodel, ids, pix, tok, cache_dtype)
    counts = {**kernels.launch_counts(), "a8_matmul": quant.a8_matmul.calls}
    main_counts.update(counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_dec = len(toks) - 1
    want = _expected_launches(cfg, qargs, ids.shape[1], n_dec)
    agree = sum(a == b for a, b in zip(toks, bf16_rec["tokens"]))
    log(f"[{name}] prompt_len {ids.shape[1]} | {len(toks)} tokens | text {tok.decode(toks)!r} | "
        f"cache {type(cache).__name__} {cache.k.dtype}")
    log(f"[{name}] launches {dict(counts)} | expected {dict(want)} | a8_matmul calls "
        f"{counts['a8_matmul']} (torch._int_mm, not a kernel of the port)")
    log(f"[{name}] prefill {prefill_ms:.2f} ms (a replay of the prefill graph, to the first token) | "
        f"decode {decode_ms:.3f} ms/token (host clock, per-token sync) | peak {peak:.3f} GiB (the bf16 model stays resident) | greedy tokens equal to the "
        f"bf16 arm's: {agree}/{min(len(toks), len(bf16_rec['tokens']))} (reported, not gated: random "
        "weights)")
    check(all(0 <= t < cfg.text_config.vocab_size for t in toks), "token id out of range")
    check(cache.length == ids.shape[1] + n_dec, "cache length does not match the tokens")
    check(all(counts.get(k, 0) == want[k] for k in set(counts) | set(want)),
          f"{name}: launch counts differ from the code's")
    check(counts["q8_matmul"] > 0, f"{name}: q8_matmul never launched")
    check(isinstance(cache, gemma.QuantKVCache) == kv_int8, f"{name}: the wrong cache")
    if qargs["mode"] == "w4a8":
        check(counts["w4a8_gemv"] > 0 and counts["w4a8_geglu"] > 0,
              f"{name}: the w4a8 kernels never launched")
    if qargs["mode"] == "int4":
        check(counts["q4_matmul"] > 0, f"{name}: q4_matmul never launched")
    if qargs.get("prefill_a8"):
        check(counts["a8_matmul"] > 0, f"{name}: the int8 x int8 prefill never ran")

    errs, bars, first_k, first_p = _kernel_vs_plain_logits(torch, qmodel, ids, pix, cache_dtype)
    log(f"[{name}] [plain] last-position logits max|kernel - plain| prefill {errs[0]:.4e} (bar "
        f"{bars[0]:.4e}), decode steps {max(errs[1:]):.4e} (bar {min(bars[1:]):.4e}) | first token "
        f"kernel {first_k} plain {first_p}")
    check(all(e <= b for e, b in zip(errs, bars)), f"{name}: kernel-path and plain-path logits disagree")
    check(first_k == first_p == toks[0], f"{name}: first greedy token differs")
    del qmodel
    torch.cuda.empty_cache()
    return {"arm": name, "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms, "peak_gib": peak,
            "llm_gb": llm_gb, "agree_with_bf16": agree, "max_abs_logit_err": max(errs),
            "a8_matmul_calls": counts["a8_matmul"]}


def _kernel_vs_plain_logits(torch, model, ids, pix, cache_dtype=None):
    """The last-position logits of the prefill and of DECODE_CHECK_STEPS
    decode steps (fed the kernel path's greedy tokens) through the kernels
    and through the plain versions: (max abs difference per forward, bar
    per forward, first token kernel, plain). The plain run must launch no
    kernel and run no int8 x int8 product."""
    from paligemma_tpu_torch import generation
    from paligemma_tpu_torch.models import paligemma
    from paligemma_tpu_torch.ops import kernels, quant

    def run(fns, feed=None):
        cache = generation.make_cache(model, 1, ids.shape[1], MAX_NEW_TOKENS, cache_dtype)
        lg, cache = generation.prefill(model, ids, pix, cache, fns)
        out, toks = [lg[0, -1].float()], []
        for i in range(DECODE_CHECK_STEPS):
            toks.append(int(out[-1].argmax()) if feed is None else feed[i])
            token = torch.tensor([[toks[-1]]], dtype=torch.int32, device=ids.device)
            lg, cache = paligemma.decode_step(model, token, cache, fns)
            out.append(lg[0, -1].float())
        return out, toks

    lg_k, toks = run(kernels.KERNELS)
    mid = (kernels.launch_counts(), quant.a8_matmul.calls)
    lg_p, _ = run(kernels.PLAIN, toks)
    torch.cuda.synchronize()
    check((kernels.launch_counts(), quant.a8_matmul.calls) == mid, "the plain path launched a kernel")
    check(all(bool(torch.isfinite(x).all()) for x in lg_k + lg_p), "non-finite logits")
    errs = [float((k - p).abs().max()) for k, p in zip(lg_k, lg_p)]
    bars = [LOGIT_REL_TOL * float(p.abs().max()) for p in lg_p]
    return errs, bars, int(lg_k[0].argmax()), int(lg_p[0].argmax())


def phase_plain_path(torch, model, rec, tok):
    """Request 0 again through the plain kernel functions (bf16 model)."""
    from paligemma_tpu_torch import generation
    from paligemma_tpu_torch.ops import kernels

    ids, pix = rec["ids"], rec["pix"]
    before = kernels.launch_counts()
    errs, bars, first_k, first_p = _kernel_vs_plain_logits(torch, model, ids, pix)
    mid = kernels.launch_counts()
    toks_p, _ = generation.generate(model, ids, pix, MAX_NEW_TOKENS, tok.eos_token_id, fns=kernels.PLAIN)
    after = kernels.launch_counts()
    agree = sum(a == b for a, b in zip(rec["tokens"], toks_p))
    log(f"[plain] last-position logits max|kernel - plain| prefill {errs[0]:.4e} (bar {bars[0]:.4e}), "
        f"decode steps {max(errs[1:]):.4e} (bar {min(bars[1:]):.4e}) | first token kernel {first_k} "
        f"plain {first_p}")
    log(f"[plain] launches: kernel prefill {mid['flash_attention'] - before['flash_attention']} flash; "
        f"plain generate {after['flash_attention'] - mid['flash_attention']} flash, "
        f"{after['decode_attention'] - mid['decode_attention']} decode")
    log(f"[plain] greedy token agreement over {len(toks_p)} tokens: {agree}/{min(len(toks_p), len(rec['tokens']))}"
        " (reported, not gated: near-ties can flip a bf16 argmax)")
    check(all(e <= b for e, b in zip(errs, bars)), "kernel-path and plain-path logits disagree")
    check(first_k == first_p == rec["tokens"][0], "first greedy token differs")
    check(mid["flash_attention"] - before["flash_attention"] == 45, "kernel prefill did not launch")
    check(after == mid, "the plain path launched a kernel")


def eager_chunk(torch, model, token, cache, n_steps, sample=None):
    """``n_steps`` decode steps issued from the host launch by launch (the
    eager step, no CUDA graph): (tokens (B, n_steps), cache). Greedy, or
    with ``sample`` = (generator, temperature, top_p) the sampled choice
    that ``generation.decode_steps`` makes (the values as (B, 1) tensors, as
    its graph holds them)."""
    from paligemma_tpu_torch.models import paligemma
    from paligemma_tpu_torch.ops.sampling import greedy, select_token_traced

    toks = []
    for _ in range(n_steps):
        logits, cache = paligemma.decode_step(model, token, cache)
        last = logits[:, -1, :]
        token = (greedy(last) if sample is None else select_token_traced(last, sample[0], True, *sample[1:]))[:, None]
        toks.append(token)
    return torch.cat(toks, dim=1), cache


def _chunk_times(torch, run):
    """(tokens, host ms, device-event ms) of ``run()``, which queues a decode
    chunk and returns its tokens on the device: the host clock runs to the
    one read of them, the CUDA events bracket the chunk's queued work."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    toks = run()
    end.record()
    toks = toks[0].tolist()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return toks, host_ms, start.elapsed_time(end)


def _eos_inside(toks):
    """A token of the stream after its first that is not repeated by the
    step after it, and did not come before: an EOS there stops generate,
    is trimmed by generate_chunked and frozen by generate_scan while the
    model would have gone on with another token: of these the one nearest
    the middle of the stream. None if the stream has no such token."""
    for i in sorted(range(1, len(toks) - 1), key=lambda i: abs(i - len(toks) // 2)):
        if toks[i] not in toks[:i] and toks[i + 1] != toks[i]:
            return toks[i]
    return None


def _kernel_of(name: str):
    """The counted wrapper whose kernel a CUDA kernel name is, or None."""
    for kname, keys in KERNEL_SYMBOLS:
        if any(k in name for k in keys):
            return kname
    return None


def _traced_launches(torch, setup, run):
    """Launches the wrappers' counts gained over ``run(setup())`` against the
    kernel records of a torch.profiler (CUPTI) trace of it, by wrapper:
    (gained, traced, tries). A trace with fewer records than launches has
    lost some (CUPTI's buffers) and is taken again, up to ``TRACE_TRIES``
    times."""
    from torch.autograd import DeviceType

    from paligemma_tpu_torch.ops import kernels

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for tries in range(1, TRACE_TRIES + 1):
        arg = setup()
        torch.cuda.synchronize()
        before = kernels.launch_counts()
        with torch.profiler.profile(activities=acts) as prof:
            run(arg)
            torch.cuda.synchronize()
        gained = {k: v - before[k] for k, v in kernels.launch_counts().items() if v != before[k]}
        traced = collections.Counter()
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA and _kernel_of(evt.key):
                traced[_kernel_of(evt.key)] += evt.count
        if all(traced[k] >= n for k, n in gained.items()):
            break
    return gained, dict(traced), tries


def _graph_arm(torch, model, cfg, name, qargs, cache_dtype, rec, main_counts):
    """One arm of phase 7 on request 0: launch counts of generate, graph vs
    eager chunks, generate_chunked and generate_scan; returns the arm's record."""
    from paligemma_tpu_torch import generation
    from paligemma_tpu_torch.models import gemma
    from paligemma_tpu_torch.ops import kernels, quant

    ids, pix = rec["ids"], rec["pix"]
    n_dec = MAX_NEW_TOKENS - 1
    generation.generate(model, ids, pix, MAX_NEW_TOKENS, -1, cache_dtype=cache_dtype)  # capture
    kernels.reset_launch_counts()  # this arm's graph path, read right after it
    toks, gen_cache = generation.generate(model, ids, pix, MAX_NEW_TOKENS, -1, cache_dtype=cache_dtype)
    cache_len = gen_cache.max_len
    del gen_cache
    counts = {**kernels.launch_counts(), "a8_matmul": quant.a8_matmul.calls}
    main_counts.update(counts)
    want = _expected_launches(cfg, qargs, ids.shape[1], n_dec)
    check(all(counts.get(k, 0) == want[k] for k in set(counts) | set(want)),
          f"[graph {name}] launch counts {counts} differ from the code's {dict(want)}")
    check(all(0 <= t < cfg.text_config.vocab_size for t in toks), "token id out of range")

    # generate's cache shape (see phase_main_path), so the chunks below
    # must give generate's tokens bit for bit.
    cache = generation.make_cache(model, 1, ids.shape[1], cache_len - ids.shape[1], cache_dtype)

    def prefilled():  # the same cache's buffers (and graph), empty again
        c = gemma.reset_cache(cache)
        logits, c = generation.prefill(model, ids, pix, c)
        return logits[:, -1].argmax(-1).to(torch.int32)[:, None], c

    first, c = prefilled()
    capture_ms = generation.prepare_decode(model, c)
    chunk_want = dict(want - _expected_launches(cfg, qargs, ids.shape[1], 0))  # the decode steps'
    times = collections.defaultdict(list)
    for _ in range(2):
        first, c = prefilled()
        toks_e, host, dev = _chunk_times(torch, lambda: eager_chunk(torch, model, first, c, n_dec)[0])
        times["eager"].append((host, dev))
        first, c = prefilled()
        before = kernels.launch_counts()
        toks_g, host, dev = _chunk_times(torch, lambda: generation.decode_steps(model, first, c, n_dec)[0])
        times["graph"].append((host, dev))
        chunk_counts = {k: v - before[k] for k, v in kernels.launch_counts().items()}
        check([int(first)] + toks_g == [int(first)] + toks_e == toks,
              f"[graph {name}] graph, eager and generate tokens differ: {[int(first)] + toks_g}, "
              f"{[int(first)] + toks_e}, {toks}")
        check(all(chunk_counts.get(k, 0) == chunk_want.get(k, 0) for k in set(chunk_counts) | set(chunk_want)),
              f"[graph {name}] the graph chunk's launches {chunk_counts} differ from the code's {chunk_want}")
    host_g, dev_g = (min(x[i] for x in times["graph"]) / n_dec for i in (0, 1))
    host_e, dev_e = (min(x[i] for x in times["eager"]) / n_dec for i in (0, 1))
    log(f"[graph {name}] capture {capture_ms:.2f} ms (host, warm-up step included) | decode ms/token "
        f"(best of 2 chunks of {n_dec}): graph host {host_g:.4f}, device-event {dev_g:.4f} | eager host "
        f"{host_e:.4f}, device-event {dev_e:.4f} | launches {counts} = expected | graph tokens == eager == "
        f"generate's {len(toks)}")

    # The counts the replays add against the kernels that ran: one graph
    # chunk under torch.profiler (CUPTI records each kernel a replay runs).
    gained, traced, tries = _traced_launches(
        torch, prefilled, lambda pre: generation.decode_steps(model, *pre, n_dec)[0].tolist())
    log(f"[graph {name}] one traced graph chunk of {n_dec} (trace {tries} of {TRACE_TRIES}): launches "
        f"added {gained} | kernel records {traced}")
    check(gained == traced == {k: v for k, v in chunk_want.items() if v},
          f"[graph {name}] the traced chunk's kernel records {traced} differ from the launches its "
          f"replays added {gained} or the code's {chunk_want}")

    # Sampled, the graph chunk against the eager chunk: one seed, one stream.
    values = [torch.full((1, 1), x, device="cuda") for x in (SAMPLE_TEMPERATURE, SAMPLE_TOP_P)]
    chunks = []
    for graph in (False, True):
        first, c = prefilled()
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        chunks.append(generation.decode_steps(model, first, c, n_dec, generator=gen, do_sample=True,
                                              temperature=values[0], top_p=values[1])[0][0].tolist() if graph
                      else eager_chunk(torch, model, first, c, n_dec, (gen, *values))[0][0].tolist())
    check(chunks[0] == chunks[1], f"[graph {name}] sampled graph and eager chunks differ under one seed")

    # generate, generate_chunked and generate_scan, greedy and sampled (one
    # seed, so one stream through each), with no EOS and with one inside the
    # stream: generate stops there, generate_chunked trims its chunk there,
    # generate_scan freezes there.
    eos_used = {}
    for mode in ("greedy", "sampled"):
        def kw():
            if mode == "greedy":
                return {"cache_dtype": cache_dtype}
            return {"cache_dtype": cache_dtype, "do_sample": True, "temperature": SAMPLE_TEMPERATURE,
                    "top_p": SAMPLE_TOP_P, "generator": torch.Generator(device="cuda").manual_seed(SEED + 1)}

        stream, _ = generation.generate(model, ids, pix, MAX_NEW_TOKENS, -1, **kw())
        eos = eos_used[mode] = _eos_inside(stream)
        check(eos is not None, f"[graph {name}] the {mode} stream {stream} holds no token to serve as an "
                               "EOS inside it")
        for e in (eos, -1):
            ref, _ = generation.generate(model, ids, pix, MAX_NEW_TOKENS, e, **kw())
            chunked = generation.generate_chunked(model, ids, pix, MAX_NEW_TOKENS, e, chunk=GRAPH_CHUNK, **kw())
            scan = generation.generate_scan(model, ids, pix, MAX_NEW_TOKENS, e, **kw())
            n_valid, scanned = int(scan.num_valid[0]), scan.tokens[0].tolist()
            check(ref == (stream[: stream.index(e) + 1] if e in stream else stream),
                  f"[graph {name}] {mode} generate's EOS stop")
            check(chunked == ref, f"[graph {name}] {mode} generate_chunked (eos {e}) differs from generate")
            check(n_valid == len(ref) and scanned[:n_valid] == ref and all(t == e for t in scanned[n_valid:]),
                  f"[graph {name}] {mode} generate_scan (eos {e}) differs from generate")
            log(f"[graph {name}] {mode} eos {e}: generate {len(ref)} tokens == generate_chunked (chunk "
                f"{GRAPH_CHUNK}) == generate_scan (num_valid {n_valid}, then {MAX_NEW_TOKENS - n_valid} frozen)")
    return {"arm": name, "capture_ms": capture_ms, "graph_host_ms_per_token": host_g,
            "graph_device_event_ms_per_token": dev_g, "eager_host_ms_per_token": host_e,
            "eager_device_event_ms_per_token": dev_e, "eos_inside": eos_used,
            "chunks": {k: [list(x) for x in v] for k, v in times.items()}}


def phase_graph(torch, model, cfg, rec, main_counts):
    """Phase 7: decode as a CUDA graph, in bf16 and in each quantized arm
    (request 0), then sampled decode through the graph (bf16).

    With random weights a greedy stream repeats the prompt's last token:
    the residual stream is mostly the input token's embedding, which the
    tied lm_head scores above every other. No EOS inside such a stream
    changes what follows it, so for this phase the final norm's scale
    (1 + w) is redrawn as N(0, 1) from ``GREEDY_NORM_SEED`` (the quantized
    arms share the tensor): a token no longer scores itself highest, and the
    greedy streams change token. It is put back after the phase."""
    with _tokens_that_change(torch, model):
        return _phase_graph(torch, model, cfg, rec, main_counts)


@contextlib.contextmanager
def _tokens_that_change(torch, model):
    """The final norm's scale (1 + w) redrawn as N(0, 1) from
    ``GREEDY_NORM_SEED`` for the phase (see ``phase_graph``), then put back."""
    norm = model.llm.final_norm.weight
    saved = norm.detach().clone()
    gen = torch.Generator(device=norm.device).manual_seed(GREEDY_NORM_SEED)
    with torch.no_grad():
        norm.copy_(torch.randn(norm.shape, generator=gen, device=norm.device, dtype=torch.float32) - 1)
    try:
        yield
    finally:
        with torch.no_grad():
            norm.copy_(saved)


def _phase_graph(torch, model, cfg, rec, main_counts):
    from paligemma_tpu_torch import generation, quantization
    from paligemma_tpu_torch.utils import memory

    torch.cuda.reset_peak_memory_stats()
    arms = [_graph_arm(torch, model, cfg, "bf16", None, None, rec, main_counts)]
    for name, qargs, kv_int8 in QUANT_ARMS:
        qmodel = quantization.quantize_params(model, llm_only=True, **qargs)
        arms.append(_graph_arm(torch, qmodel, cfg, name, qargs, torch.int8 if kv_int8 else None, rec, main_counts))
        del qmodel  # with it go its pooled caches and their graphs
        gc.collect()
        torch.cuda.empty_cache()

    ids, pix = rec["ids"], rec["pix"]
    greedy_toks = generation.generate(model, ids, pix, MAX_NEW_TOKENS, -1)[0]

    def sampled(seed, temperature=SAMPLE_TEMPERATURE, chunked=False):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        kw = dict(do_sample=True, temperature=temperature, top_p=SAMPLE_TOP_P, generator=gen)
        if chunked:
            return generation.generate_chunked(model, ids, pix, MAX_NEW_TOKENS, -1, chunk=GRAPH_CHUNK, **kw)
        return generation.generate(model, ids, pix, MAX_NEW_TOKENS, -1, **kw)[0]

    a, b, other = sampled(SEED + 1), sampled(SEED + 1), sampled(SEED + 2)
    chunked, t0 = sampled(SEED + 1, chunked=True), sampled(SEED + 1, temperature=0.0)
    vocab = cfg.text_config.vocab_size
    log(f"[graph sampled] temperature {SAMPLE_TEMPERATURE} top_p {SAMPLE_TOP_P}: seed {SEED + 1} twice equal: "
        f"{a == b} | seed {SEED + 2} differs: {a != other} | generate_chunked (chunk {GRAPH_CHUNK}) with seed "
        f"{SEED + 1} equal: {chunked == a} | temperature 0 == greedy: {t0 == greedy_toks} | "
        f"distinct ids {len(set(a))} of {len(a)}")
    check(a == b, "sampled decode with one seed gave two streams")
    check(a != other, "two seeds gave one sampled stream")
    check(chunked == a, "generate_chunked and generate drew different streams from one seed")
    check(all(0 <= t < vocab for t in a + other), "sampled token id out of range")
    check(t0 == greedy_toks, "do_sample at temperature 0 is not greedy")
    peak = memory.peak_memory_mb("cuda")
    log(f"[graph] peak memory over the phase {peak:.1f} MiB (utils.memory.peak_memory_mb)")
    log(f"[graph] {json.dumps(arms)}")
    return arms


# The speculative phase: (drafter, k, n) of each generate_spec run, and the
# chunk (one chunk covers the request's decode tokens).
SPEC_RUNS = (("ngram", 8, 3), ("longest", 8, 3))
SPEC_CHUNK = MAX_NEW_TOKENS - 1


def phase_speculative(torch, model, cfg, rec, main_counts):
    """Speculative decoding (after phase 7): request 0 through
    ``generate_spec`` (k = 8, n = 3, the n-gram and the longest-match
    drafter) in bf16 on the model as it is (its greedy stream repeats one
    token: acceptance), then with the final norm redrawn as in phase 7 in
    bf16 and in every quantized arm (streams that change token: drafts
    accepted and rejected). See ``_spec_arm`` for what each arm holds."""
    from paligemma_tpu_torch import quantization

    out = {"undrawn": [_spec_arm(torch, model, cfg, "bf16 seeded norm", None, None, rec, main_counts)]}
    with _tokens_that_change(torch, model):
        arms = [_spec_arm(torch, model, cfg, "bf16", None, None, rec, main_counts)]
        for name, qargs, kv_int8 in QUANT_ARMS:
            qmodel = quantization.quantize_params(model, llm_only=True, **qargs)
            arms.append(_spec_arm(torch, qmodel, cfg, name, qargs, torch.int8 if kv_int8 else None, rec,
                                  main_counts))
            del qmodel  # with it go its pooled caches and their graphs
            gc.collect()
            torch.cuda.empty_cache()
    out["redrawn"] = arms
    log(f"[spec] {json.dumps(out)}")
    return out


def _top_two_gap(torch, model, ids, pix, prefix, cache_dtype):
    """(top-1 minus top-2 logit, the 2% bar) of the plain sequential step
    that chooses the token after ``prefix`` (the prefill, then one eager
    ``decode_step`` a token of it)."""
    from paligemma_tpu_torch import generation
    from paligemma_tpu_torch.models import paligemma

    cache = generation.make_cache(model, 1, ids.shape[1], len(prefix) + 1, cache_dtype)
    lg, cache = paligemma.prefill(model, ids, pix, cache, full_logits=False)
    for t in prefix:
        lg, cache = paligemma.decode_step(model, torch.tensor([[t]], dtype=torch.int32, device=ids.device), cache)
    last = lg[0, -1].float()
    top = last.topk(2).values
    return float(top[0] - top[1]), LOGIT_REL_TOL * float(last.abs().max())


def _spec_arm(torch, model, cfg, name, qargs, cache_dtype, rec, main_counts):
    """One arm of the speculative phase on request 0:
    1. ``verify_step``'s k logits rows against k sequential ``decode_step``
       calls on generate's first k tokens, within phase 5's 2% bar;
    2. each drafter's ``generate_spec`` tokens against ``generate``'s:
       identical up to the first position where the two paths' argmaxes
       differ, where the sequential step's top two logits must lie within
       that bar of each other (the position is reported);
    3. its launches (and int8 x int8 calls) the code's: the prefill, then
       per verify iteration one forward of k rows;
    4. ``tokens_per_verify``, and the host ms a decode token of a
       ``decode_steps_spec`` chunk against a ``decode_steps`` chunk of the
       same 31 tokens from the same prefilled cache (best of two);
    5. sampled (temperature 0.8, top_p 0.9): one seed repeats its stream,
       and temperature 0 is the greedy stream."""
    from paligemma_tpu_torch import generation
    from paligemma_tpu_torch.models import gemma, paligemma
    from paligemma_tpu_torch.ops import kernels, quant

    ids, pix = rec["ids"], rec["pix"]
    dev, t = ids.device, ids.shape[1]
    n_dec = MAX_NEW_TOKENS - 1
    tag = f"[spec {name}]"
    ref, _ = generation.generate(model, ids, pix, MAX_NEW_TOKENS, -1, cache_dtype=cache_dtype)

    k0 = SPEC_RUNS[0][1]
    toks = torch.tensor([ref[:k0]], dtype=torch.int32, device=dev)

    def prefilled(extra):
        cache = generation.make_cache(model, 1, t, extra, cache_dtype)
        return paligemma.prefill(model, ids, pix, cache, full_logits=False)[1]

    ver, _ = paligemma.verify_step(model, toks, prefilled(k0))
    c, seq = prefilled(k0), []
    for i in range(k0):
        lg, c = paligemma.decode_step(model, toks[:, i:i + 1], c)
        seq.append(lg[0, 0].float())
    errs = [float((ver[0, i] - seq[i]).abs().max()) for i in range(k0)]
    bars = [LOGIT_REL_TOL * float(x.abs().max()) for x in seq]
    log(f"{tag} verify_step k={k0} logits max|verify - sequential decode_step| per row "
        f"{[f'{e:.3e}' for e in errs]} (bars from {min(bars):.3e})")
    check(all(e <= b for e, b in zip(errs, bars)), f"{tag} verify_step's rows are off the sequential steps'")

    record = {"arm": name, "verify_max_logit_err": max(errs), "runs": []}
    for drafter, k, n in SPEC_RUNS:
        kw = dict(cache_dtype=cache_dtype, chunk=SPEC_CHUNK, k=k, n=n, drafter=drafter)
        generation.generate_spec(model, ids, pix, MAX_NEW_TOKENS, -1, **kw)  # the captures
        kernels.reset_launch_counts()  # this run's path, read right after it
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spec = generation.generate_spec(model, ids, pix, MAX_NEW_TOKENS, -1, stats=stats, **kw)
        request_ms = (time.perf_counter() - t0) * 1e3
        counts = {**kernels.launch_counts(), "a8_matmul": quant.a8_matmul.calls}
        main_counts.update(counts)
        want = _expected_launches(cfg, qargs, t, 0, verify=(stats["verify_steps"], k))
        check(all(counts.get(x, 0) == want[x] for x in set(counts) | set(want)),
              f"{tag} {drafter}: launch counts {counts} differ from the code's {dict(want)}")
        div = next((i for i, (a, b) in enumerate(zip(spec, ref)) if a != b), None)
        check(len(spec) == len(ref) == MAX_NEW_TOKENS, f"{tag} {drafter}: {len(spec)} tokens")
        gap = bar = None
        if div is not None:
            gap, bar = _top_two_gap(torch, model, ids, pix, ref[:div], cache_dtype)
            check(gap <= bar, f"{tag} {drafter}: spec and generate differ at {div} where the sequential "
                              f"step's top two logits are {gap:.4e} apart (bar {bar:.4e})")

        # Host ms a decode token: a decode_steps_spec chunk against a
        # decode_steps chunk of the same tokens, from one prefilled cache.
        cache = generation.make_cache(model, 1, t, n_dec + 2 * k, cache_dtype)

        def first_token():
            c = gemma.reset_cache(cache)
            logits, c = generation.prefill(model, ids, pix, c)
            return logits[:, -1].argmax(-1).to(torch.int32)[:, None], c

        def spec_chunk():
            first, c = first_token()
            ids_buf = torch.zeros((1, t + n_dec + 2 * k), dtype=torch.int32, device=dev)
            ids_buf[:, :t], ids_buf[0, t] = ids, first[0, 0]
            buf_len = torch.tensor(t + 1, dtype=torch.int32, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out_buf, produced, *_ = generation.decode_steps_spec(model, first, c, ids_buf, buf_len, n_dec,
                                                                 k=k, n=n, drafter=drafter)
            out_buf[0, :n_dec].tolist()
            return (time.perf_counter() - t0) * 1e3 / n_dec, int(produced)

        def plain_chunk():
            first, c = first_token()
            generation.prepare_decode(model, c)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            generation.decode_steps(model, first, c, n_dec)[0].tolist()
            return (time.perf_counter() - t0) * 1e3 / n_dec

        spec_chunk()  # the capture on this cache
        spec_ms, plain_ms = min(spec_chunk()[0] for _ in range(2)), min(plain_chunk() for _ in range(2))
        del cache
        log(f"{tag} {drafter} k={k} n={n}: {len(spec)} tokens, first difference from generate at "
            f"{div if div is not None else 'none'}"
            + (f" (sequential top two {gap:.4e} apart, bar {bar:.4e})" if div is not None else "")
            + f" | tokens_per_verify {stats['tokens_per_verify']} ({stats['produced']} produced in "
            f"{stats['verify_steps']} verify steps) | launches {counts} = expected | host ms/token of a "
            f"{n_dec}-token chunk: decode_steps_spec {spec_ms:.4f}, decode_steps {plain_ms:.4f} "
            f"(best of 2) | generate_spec request {request_ms:.2f} ms")
        record["runs"].append({"drafter": drafter, "k": k, "n": n, "first_difference": div,
                               "tokens_per_verify": stats["tokens_per_verify"],
                               "verify_steps": stats["verify_steps"], "produced": stats["produced"],
                               "spec_host_ms_per_token": spec_ms, "decode_steps_host_ms_per_token": plain_ms,
                               "request_ms": request_ms})

    # Sampled: one seed, one stream; temperature 0 is the greedy stream.
    drafter, k, n = SPEC_RUNS[0]
    greedy = generation.generate_spec(model, ids, pix, MAX_NEW_TOKENS, -1, cache_dtype=cache_dtype,
                                      chunk=SPEC_CHUNK, k=k, n=n, drafter=drafter)

    def sampled(seed, temperature=SAMPLE_TEMPERATURE):
        return generation.generate_spec(model, ids, pix, MAX_NEW_TOKENS, -1, cache_dtype=cache_dtype,
                                        chunk=SPEC_CHUNK, k=k, n=n, drafter=drafter, do_sample=True,
                                        temperature=temperature, top_p=SAMPLE_TOP_P,
                                        generator=torch.Generator(device=dev).manual_seed(seed))

    a, b, t0_toks = sampled(SEED + 1), sampled(SEED + 1), sampled(SEED + 1, 0.0)
    log(f"{tag} sampled temperature {SAMPLE_TEMPERATURE} top_p {SAMPLE_TOP_P}: seed {SEED + 1} twice equal: "
        f"{a == b} | temperature 0 == greedy spec: {t0_toks == greedy} | distinct ids {len(set(a))} of {len(a)}")
    check(a == b, f"{tag} sampled spec with one seed gave two streams")
    check(t0_toks == greedy, f"{tag} sampled spec at temperature 0 is not greedy")
    check(all(0 <= x < cfg.text_config.vocab_size for x in a), f"{tag} sampled token id out of range")
    return record


def _cache_tensors(cache):
    """{field: tensor} of a cache: K/V (and the int8 cache's scales), the
    device length and the valid lengths."""
    return {f.name: getattr(cache, f.name) for f in dataclasses.fields(cache)
            if hasattr(getattr(cache, f.name), "data_ptr")}


def _prefill_times(torch, run):
    """((logits, cache), first token, host ms, device-event ms) of
    ``run()``, which queues a prefill: the host clock runs to the read of
    the first greedy token, the CUDA events bracket the queued work."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = run()
    end.record()
    first = int(out[0][0, -1].argmax())
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return out, first, host_ms, start.elapsed_time(end)


def _prefill_arm(torch, model, cfg, name, qargs, cache_dtype, rec, main_counts):
    """One arm of the prefill-graph phase on request 0: the graph prefill
    (first call, then replays) against the eager prefill, bit for bit, with
    launch counts, CUPTI records, times and the memory of one graph;
    returns the arm's record."""
    from paligemma_tpu_torch import generation
    from paligemma_tpu_torch.models import gemma, paligemma
    from paligemma_tpu_torch.ops import kernels

    ids, pix = rec["ids"], rec["pix"]
    t = ids.shape[1]
    want = _expected_launches(cfg, qargs, t, 0)

    def fresh():  # generate's cache shape for the request
        return generation.make_cache(model, 1, t, rec["cache_len"] - t, cache_dtype)

    # The eager prefill (models/paligemma.prefill launched from Python): the
    # bits every graph prefill below must give, and its host ms (best of 3).
    eager = fresh()
    (ref_logits, eager), ref_first, _, _ = _prefill_times(
        torch, lambda: paligemma.prefill(model, ids, pix, eager, full_logits=False))
    ref = {k: v.clone() for k, v in _cache_tensors(eager).items()}

    def same(logits, first, cache):
        got = _cache_tensors(cache)
        return (torch.equal(logits, ref_logits) and first == ref_first and cache.host_length == t
                and all(torch.equal(got[k], ref[k]) for k in ref))

    eager_times = []
    for _ in range(3):
        c = gemma.reset_cache(eager)
        (logits, c), first, host, dev = _prefill_times(
            torch, lambda: paligemma.prefill(model, ids, pix, c, full_logits=False))
        check(same(logits, first, c), f"[prefill {name}] the eager prefill is not deterministic")
        eager_times.append((host, dev))

    # The first call of the shape: the eager prefill on a side stream (the
    # capture's warm-up, this call's answer), then the capture.
    cache = fresh()
    (logits, cache), first, first_ms, _ = _prefill_times(torch, lambda: generation.prefill(model, ids, pix, cache))
    runners = [r for key, r in cache.graphs.items() if key[0] == "prefill"]
    check(len(runners) == 1 and runners[0].graph is not None, f"[prefill {name}] no prefill graph captured")
    capture_ms = runners[0].capture_ms
    check(same(logits, first, cache), f"[prefill {name}] the first call differs from the eager prefill")

    # Replays: each gives the eager bits and the code's launches; the counts
    # are set to 0 just before and read just after.
    kernels.reset_launch_counts()
    graph_times = []
    for _ in range(3):
        cache = gemma.reset_cache(cache)
        before = kernels.call_counts()
        (logits, cache), first, host, dev = _prefill_times(torch, lambda: generation.prefill(model, ids, pix, cache))
        counts = {k: v - before[k] for k, v in kernels.call_counts().items()}
        check(same(logits, first, cache), f"[prefill {name}] a replay differs from the eager prefill")
        check(all(counts.get(k, 0) == want[k] for k in set(counts) | set(want)),
              f"[prefill {name}] a replay's launches {counts} differ from the code's {dict(want)}")
        graph_times.append((host, dev))
    main_counts.update(kernels.call_counts())

    # One replay under torch.profiler: its CUPTI kernel records against the
    # launches it added.
    gained, traced, tries = _traced_launches(
        torch, lambda: gemma.reset_cache(cache), lambda c: int(generation.prefill(model, ids, pix, c)[0].argmax()))
    check(gained == traced == {k: v for k, v in want.items() if v and k != "a8_matmul"},
          f"[prefill {name}] the traced replay's kernel records {traced} differ from the launches it added "
          f"{gained} or the code's {dict(want)}")

    # The device memory one graph holds: its pool, released when the graph
    # goes; prepare_prefill captures ahead and leaves the cache empty.
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    c = fresh()
    alloc0 = torch.cuda.memory_allocated()
    prepare_ms = generation.prepare_prefill(model, c, ids.shape, pix.shape)
    torch.cuda.synchronize()
    alloc1 = torch.cuda.memory_allocated()
    check(c.host_length == 0 and not any(bool(x.any()) for x in _cache_tensors(c).values()),
          f"[prefill {name}] prepare_prefill left the cache written")
    (logits, c), first, _, _ = _prefill_times(torch, lambda: generation.prefill(model, ids, pix, c))
    check(same(logits, first, c), f"[prefill {name}] a replay after prepare_prefill differs")
    del logits
    torch.cuda.empty_cache()
    reserved1 = torch.cuda.memory_reserved()
    c.graphs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    pool_mib = (reserved1 - torch.cuda.memory_reserved()) / 2**20

    host_g, dev_g = (min(x[i] for x in graph_times) for i in (0, 1))
    host_e, dev_e = (min(x[i] for x in eager_times) for i in (0, 1))
    log(f"[prefill {name}] prompt_len {t} | graph == eager prefill bit for bit (logits, first token "
        f"{ref_first}, K/V rows, length, valid) on the first call and 3 replays | launches a replay "
        f"{dict((k, v) for k, v in want.items() if v)} = expected | CUPTI records of one replay (trace {tries} of "
        f"{TRACE_TRIES}) {traced}")
    log(f"[prefill {name}] ms (best of 3; host clock to the first token's read, device events): graph host "
        f"{host_g:.3f} device-event {dev_g:.3f} | eager host {host_e:.3f} device-event {dev_e:.3f} | first call "
        f"of the shape {first_ms:.2f} (capture {capture_ms:.2f}, warm-up prefill included; prepare_prefill "
        f"{prepare_ms:.2f}) | one graph holds {pool_mib:.1f} MiB of pool (memory_allocated +"
        f"{(alloc1 - alloc0) / 2**20:.2f} MiB after its capture)")
    return {"arm": name, "prompt_len": t, "graph_host_ms": host_g, "graph_device_event_ms": dev_g,
            "eager_host_ms": host_e, "eager_device_event_ms": dev_e, "first_call_ms": first_ms,
            "capture_ms": capture_ms, "prepare_prefill_ms": prepare_ms, "graph_pool_mib": pool_mib,
            "graph_allocated_mib": (alloc1 - alloc0) / 2**20,
            "times": {"graph": graph_times, "eager": eager_times}}


def phase_prefill_graph(torch, model, cfg, rec, main_counts):
    """The prefill as a CUDA graph, in bf16 and in each quantized arm
    (request 0); returns the arms' records."""
    from paligemma_tpu_torch import quantization

    arms = [_prefill_arm(torch, model, cfg, "bf16", None, None, rec, main_counts)]
    for name, qargs, kv_int8 in QUANT_ARMS:
        qmodel = quantization.quantize_params(model, llm_only=True, **qargs)
        arms.append(_prefill_arm(torch, qmodel, cfg, name, qargs, torch.int8 if kv_int8 else None, rec,
                                 main_counts))
        del qmodel
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[prefill] {json.dumps(arms)}")
    return arms


def _host_peak_rss_gb() -> float:
    """The process's peak resident set so far (``getrusage``; KiB on Linux)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def phase_checkpoint(torch, model, rec, tok):
    """The seeded bf16 model written as HF-layout safetensors shards with a
    config.json (the port's writer) to a temporary directory, loaded back on
    the card whole and streaming: every tensor bit for bit, request 0's
    greedy tokens unchanged; the load seconds, GB written and peak host RSS;
    the directory removed."""
    import shutil
    import tempfile

    from paligemma_tpu_torch import generation
    from paligemma_tpu_torch.utils import checkpoint

    tmp = tempfile.mkdtemp(prefix="pg_ckpt_")
    try:
        t0 = time.perf_counter()
        written = checkpoint.save_hf_checkpoint(model, tmp)
        write_s = time.perf_counter() - t0
        shards = len([f for f in os.listdir(tmp) if f.endswith(".safetensors")])
        log(f"[checkpoint] wrote {written / 1e9:.3f} GB in {shards} shards + config.json in {write_s:.2f} s")
        want = model.state_dict()
        record = {"gb_written": written / 1e9, "write_s": write_s}
        for streaming in (False, True):
            rss0 = _host_peak_rss_gb()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loaded, cfg = checkpoint.load_model(tmp, dtype=model.llm.embed.dtype, streaming=streaming,
                                                device=model.llm.embed.device)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            rss = _host_peak_rss_gb()
            got = loaded.state_dict()
            same = got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
            toks, _ = generation.generate(loaded, rec["ids"], rec["pix"], MAX_NEW_TOKENS, tok.eos_token_id)
            kind = "streaming" if streaming else "whole"
            log(f"[checkpoint] load_model {kind}: {load_s:.2f} s | the process's peak host RSS {rss0:.2f} GB "
                f"before the load, {rss:.2f} GB after | every tensor bit for bit: {same} | request 0's "
                f"{len(toks)} greedy tokens unchanged: {toks == rec['tokens']}")
            check(cfg == model.cfg and same, f"checkpoint {kind}: the loaded model differs")
            check(toks == rec["tokens"], f"checkpoint {kind}: request 0's tokens changed")
            record[f"{kind}_load_s"], record[f"{kind}_peak_rss_gb"] = load_s, (rss0, rss)
            del loaded, got
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return record


def _request_image(i):
    import numpy as np
    from PIL import Image

    _, (w, h) = REQUESTS[i]
    rng = np.random.RandomState(SEED + i)
    return Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8))


BATCH_REQUESTS = [0, 1, 2, 0]  # phase 4's three requests and a repeat


def phase_batched(torch, model, proc, tok, cfg, records, main_counts):
    """``serving.batch_generate`` of phase 4's requests and a repeat at batch
    4, in bf16 and int8: launches the code's; each row's first token its
    batch-1 first token and its last-position prefill logits within the 2%
    bar of the batch-1 prefill's; the tokens that agree with batch 1 and the
    decode ms a step (31 replays of the captured batched step). The final
    norm is redrawn as in phase 7, so that greedy streams change token."""
    with _tokens_that_change(torch, model):
        return _phase_batched(torch, model, proc, tok, cfg, records, main_counts)


def _phase_batched(torch, model, proc, tok, cfg, records, main_counts):
    from paligemma_tpu_torch import generation, quantization, serving
    from paligemma_tpu_torch.ops import kernels, quant

    prompts = [REQUESTS[i][0] for i in BATCH_REQUESTS]
    images = [_request_image(i) for i in BATCH_REQUESTS]
    out = []
    for arm, qargs in (("bf16", None), ("int8", {"mode": "int8"})):
        m = model if qargs is None else quantization.quantize_params(model, llm_only=True, **qargs)
        # Batch 1: each request's prefill logits and greedy tokens.
        ref_logits, ref_toks = [], []
        for i in BATCH_REQUESTS:
            ids, pix = records[i]["ids"], records[i]["pix"]
            cache = generation.make_cache(m, 1, ids.shape[1], 1)
            lg, _ = generation.prefill(m, ids, pix, cache)
            ref_logits.append(lg[0, -1].float())
            ref_toks.append(generation.generate(m, ids, pix, MAX_NEW_TOKENS, -1)[0])
        serving.batch_generate(m, proc, prompts, images, MAX_NEW_TOKENS, eos_token_id=-1)  # capture
        kernels.reset_launch_counts()  # the batched path, read right after it
        _, rows = serving.batch_generate(m, proc, prompts, images, MAX_NEW_TOKENS, eos_token_id=-1,
                                         return_tokens=True)
        counts = {**kernels.launch_counts(), "a8_matmul": quant.a8_matmul.calls}
        main_counts.update(counts)
        ids_np, valid_np, pix_np, _ = serving.pad_batch(proc, prompts, images)
        t_pad = ids_np.shape[1]
        n_dec = -(-(MAX_NEW_TOKENS - 1) // serving.CHUNK) * serving.CHUNK  # whole chunks, no EOS
        want = _expected_launches(cfg, qargs, t_pad, n_dec, batch=len(prompts))
        check(all(counts.get(k, 0) == want[k] for k in set(counts) | set(want)),
              f"[batched {arm}] launch counts {counts} differ from the code's {dict(want)}")

        # The batched prefill's last-position logits against batch 1's, and
        # the decode step's time (the captured step replayed 31 times).
        dev = m.llm.final_norm.weight.device
        ids, valid = torch.from_numpy(ids_np).to(dev), torch.from_numpy(valid_np).to(dev)
        pix = torch.from_numpy(pix_np).to(dev, m.vision.patch_embedding.weight.dtype)
        cache = generation._pooled_cache(m, len(prompts), t_pad, MAX_NEW_TOKENS, None)
        logits, cache = serving.batched_prefill(m, ids, pix, valid, cache)
        first = logits.argmax(-1).to(torch.int32)[:, None]
        serving.prepare_batched_decode(m, cache, t_pad)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, _, cache = serving.batched_decode_steps(m, first, cache, valid, MAX_NEW_TOKENS - 1, t_pad)
        toks = toks.tolist()
        step_ms = (time.perf_counter() - t0) * 1e3 / (MAX_NEW_TOKENS - 1)
        del cache
        errs = [float((logits[r].float() - ref_logits[r]).abs().max()) for r in range(len(prompts))]
        bars = [LOGIT_REL_TOL * float(x.abs().max()) for x in ref_logits]
        firsts = [row[0] for row in rows]
        agree = [sum(a == b for a, b in zip(row, ref)) for row, ref in zip(rows, ref_toks)]
        same_steps = all([int(first[r])] + toks[r] == rows[r] for r in range(len(prompts)))
        log(f"[batched {arm}] batch {len(prompts)} T_pad {t_pad} valid {valid_np.tolist()} | launches {counts} "
            f"(expected {dict(want)})")
        log(f"[batched {arm}] first tokens {firsts} | batch 1 {[r[0] for r in ref_toks]} | prefill logits "
            f"max|batched - batch 1| {[f'{e:.4e}' for e in errs]} (bars {[f'{b:.4e}' for b in bars]}) | tokens "
            f"agreeing with batch 1 of {MAX_NEW_TOKENS}: {agree} | decode {step_ms:.3f} ms a step of "
            f"{len(prompts)} rows (host clock, one sync; batch 1: {records[0]['decode_ms_per_token']:.3f} ms/token "
            f"through generate) | batch_generate = prefill + decode_steps: {same_steps}")
        check(firsts == [r[0] for r in ref_toks] == logits.argmax(-1).tolist(),
              f"[batched {arm}] a row's first token differs from batch 1")
        check(all(e <= b for e, b in zip(errs, bars)), f"[batched {arm}] batched prefill logits off the bar")
        check(rows[0] == rows[3], f"[batched {arm}] the repeated request gave other tokens")
        check(same_steps, f"[batched {arm}] batch_generate and prefill + batched_decode_steps disagree")
        out.append({"arm": arm, "decode_ms_per_step": step_ms, "agree": agree, "max_logit_err": max(errs)})
        del m
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[batched] {json.dumps(out)}")
    return out


ABLATION_LENGTH = 128


def phase_ablation(torch, model, proc, main_counts):
    """``ablation_study_torch``'s grid at full width, cut to one length (128),
    one image and one run, both arms, bf16: each arm's discarded warm-up run
    (the graphs' captures), then its measured run with its launches the
    code's; the first token identical across arms, the first uncached step's
    logits within 2% of the cached prefill's; the match count and ms/token
    per arm. The final norm is redrawn as in phase 7, so that greedy
    streams change token."""
    import tempfile

    import ablation_study_torch as abl
    from paligemma_tpu_torch import generation, serving
    from paligemma_tpu_torch.models import paligemma
    from paligemma_tpu_torch.ops import kernels

    with tempfile.TemporaryDirectory(prefix="pg_ablation_") as tmp, _tokens_that_change(torch, model):
        item = dict(abl.COCO_BENCHMARK[0])
        _, item["image_path"] = abl.get_image(item, tmp)
        runner = abl.Runner(model, proc, max_new_tokens=ABLATION_LENGTH)
        res, counts = {}, {}
        for cached in (True, False):
            config = {"kv_cache": cached, "temperature": 0.0, "max_tokens": ABLATION_LENGTH}
            abl.run_inference(runner, proc, item["image_path"], item["prompt"], config)  # warm-up, discarded
            kernels.reset_launch_counts()  # this arm's measured run, read right after it
            res[cached] = abl.run_inference(runner, proc, item["image_path"], item["prompt"], config,
                                            return_tokens=True)
            counts[cached] = kernels.launch_counts()
            main_counts.update(counts[cached])
        # The first uncached step's logits against the cached prefill's.
        from PIL import Image

        ids, pix = runner.inputs(Image.open(item["image_path"]).convert("RGB"), item["prompt"])
        ids_p, valid, bucket = runner.bucket(ids)
        cache = generation.make_cache(model, 1, bucket, 1)
        cached_lg, _ = serving.batched_prefill(model, ids_p, pix, valid, cache)
        buf = torch.cat([ids_p, torch.zeros((1, ABLATION_LENGTH), dtype=torch.int32, device=ids.device)], dim=1)
        nocache_lg = paligemma.forward_nocache(model, buf, pix, valid)[0, ids.shape[1] - 1]
    cached_lg = cached_lg[0].float()
    err = float((nocache_lg - cached_lg).abs().max())
    bar = LOGIT_REL_TOL * float(cached_lg.abs().max())
    tk, tn = res[True]["token_ids"], res[False]["token_ids"]
    match = sum(a == b for a, b in zip(tk, tn))
    n_layers = model.cfg.text_config.num_hidden_layers
    want_cached = {"flash_attention": model.cfg.vision_config.num_hidden_layers + n_layers,
                   "decode_attention": n_layers * (ABLATION_LENGTH - 1)}
    # The uncached arm: its untimed throwaway step, then one step a token.
    want_nocache = {"flash_attention": (model.cfg.vision_config.num_hidden_layers + n_layers) * (ABLATION_LENGTH + 1)}
    for cached, want in ((True, want_cached), (False, want_nocache)):
        r = res[cached]
        log(f"[ablation] {'kv_cache' if cached else 'no_kv_cache'}_{ABLATION_LENGTH}: "
            f"{r['steady_state_ms_per_token']:.3f} ms/token steady state ({r['steady_state_tps']:.1f} tok/s), "
            f"{r['total_ms_per_token']:.3f} ms/token overall, peak {r['peak_memory_mb']:.1f} MiB over decode | "
            f"launches {dict((k, v) for k, v in counts[cached].items() if v)} (expected {want})")
        check(all(counts[cached][k] == want.get(k, 0) for k in counts[cached]),
              f"[ablation] {'cached' if cached else 'uncached'} launches differ from the code's")
    log(f"[ablation] prompt bucket {bucket}, prompt {ids.shape[1]} | first token cached {tk[0]} uncached {tn[0]} | "
        f"tokens matching of {ABLATION_LENGTH}: {match} | first uncached step's logits max|nocache - cached "
        f"prefill| {err:.4e} (bar {bar:.4e}) | speedup "
        f"{res[False]['steady_state_ms_per_token'] / res[True]['steady_state_ms_per_token']:.2f}x")
    check(tk[0] == tn[0], "[ablation] the first token differs across arms")
    check(err <= bar, "[ablation] the first uncached step's logits are off the cached prefill's")
    check(len(tk) == len(tn) == ABLATION_LENGTH, "[ablation] an arm gave the wrong number of tokens")
    return {"cached_ms_per_token": res[True]["steady_state_ms_per_token"],
            "uncached_ms_per_token": res[False]["steady_state_ms_per_token"],
            "cached_peak_mib": res[True]["peak_memory_mb"], "uncached_peak_mib": res[False]["peak_memory_mb"],
            "match": match, "max_logit_err": err}


def phase_cli(torch):
    """``inference_torch.py --demo`` as a subprocess, and with
    ``--speculative``: exit 0 on the card."""
    import tempfile

    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="pg_cli_") as tmp:
        img = os.path.join(tmp, "img.png")
        _request_image(0).save(img)
        for extra in ([], ["--speculative"]):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.join(repo, "inference_torch.py"), "--demo", "--prompt", "describe",
                 "--image_file_path", img, "--max_tokens_to_generate", "12", *extra],
                capture_output=True, text=True, timeout=300, cwd=repo,
            )
            lines = proc.stdout.splitlines()
            device = next((line for line in lines if line.startswith("Device in use:")), "")
            log(f"[cli] inference_torch.py --demo {' '.join(extra)}: exit {proc.returncode} in "
                f"{time.perf_counter() - t0:.1f} s | {device!r} | output {lines[-1] if lines else ''!r}")
            check(proc.returncode == 0, f"[cli] exit {proc.returncode}: {proc.stderr[-2000:]}")
            check("cuda" in device, "[cli] the CLI did not run on cuda")


# Phase 14: the identity engines' traffic (phase 4's three requests and
# nine more over two prompt buckets), 4 slots, chunk 8; the throughput cell
# at server.py's shipped configuration.
CONT_PROMPTS = [
    "what is shown?", "total?", "read the title of this document please",
    "list every number that appears in the second column of the table, in order, and their units",
    "caption en", "describe the image in one short sentence",
    "is there a chart on this page and what does its vertical axis measure over the period",
    "who signed it?", "extract the invoice date, the due date and the amount due from this scanned page",
]
CONT_BUDGETS = [8, 12, 16, 20, 24, 28, 36, 40, 48]
CONT_SLOTS, CONT_CHUNK, CONT_MAX_NEW = 4, 8, 48
CONT_EXTRA_BUCKETS = (32, 96)  # text tokens on top of the image tokens
THROUGHPUT = dict(n_slots=32, chunk=32, spec_ks=(8,), spec_adaptive=True, spec_chunk=16, kv_window=True,
                  max_new_tokens=64)
THROUGHPUT_REQUESTS, THROUGHPUT_EXTRA = 64, 64


def _throughput_windows():
    """The cache window's widths of the throughput cell."""
    from paligemma_tpu_torch import continuous

    cfg_budget = 256 + THROUGHPUT_EXTRA  # 3B-224: 256 image tokens
    k = max(THROUGHPUT["spec_ks"])
    slack = max(THROUGHPUT["chunk"], THROUGHPUT["spec_chunk"] * k) + k
    s_len = cfg_budget + THROUGHPUT["max_new_tokens"] + slack
    return continuous.window_buckets(cfg_budget, THROUGHPUT["chunk"], slack, s_len)


def _cont_traffic():
    """(prompt, image, max_new_tokens) of the identity engines' 12 requests."""
    import numpy as np
    from PIL import Image

    out = [(REQUESTS[i][0], _request_image(i), MAX_NEW_TOKENS) for i in range(len(REQUESTS))]
    rng = np.random.RandomState(SEED + 14)
    for prompt, budget in zip(CONT_PROMPTS, CONT_BUDGETS):
        w, h = int(rng.randint(120, 400)), int(rng.randint(120, 400))
        out.append((prompt, Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)), budget))
    return out


def _inputs_of(torch, model, proc, prompt, image):
    out = proc([prompt], [image])
    dev = model.llm.final_norm.weight.device
    return (torch.from_numpy(out["input_ids"]).to(dev),
            torch.from_numpy(out["pixel_values"]).to(dev, model.vision.patch_embedding.weight.dtype))


def _first_difference(a, b):
    div = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    return div if div is not None or len(a) == len(b) else min(len(a), len(b))


def _held_to_batch1(torch, model, proc, tag, prompt, image, got, ref, cache_dtype):
    """Phase 10's rule: the tokens are batch 1's, or their first difference
    falls where batch 1's top two logits lie within phase 5's 2% bar.
    Returns the first difference (None: equal)."""
    div = _first_difference(got, ref)
    if div is not None:
        ids, pix = _inputs_of(torch, model, proc, prompt, image)
        gap, bar = _top_two_gap(torch, model, ids, pix, ref[:div], cache_dtype)
        log(f"{tag} {prompt[:24]!r}: first difference from batch 1 at {div} of {len(ref)}, batch 1's top two "
            f"{gap:.4e} apart (bar {bar:.4e})")
        check(gap <= bar, f"{tag} {prompt[:24]!r}: tokens differ from batch 1 at {div} off a near tie")
    return div


def _run_engine(torch, eng, traffic, sampled=()):
    """Submit the traffic at once and run it: the requests, with the kernel
    launches of the run (counts zeroed just before it, read just after)."""
    from paligemma_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    reqs = [eng.submit(p, im, m, **({"do_sample": True, "temperature": SAMPLE_TEMPERATURE,
                                      "top_p": SAMPLE_TOP_P} if i in sampled else {}))
            for i, (p, im, m) in enumerate(traffic)]
    eng.run()
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    check(all(r.done and r.error is None for r in reqs),
          f"a request ended with an error: {[repr(r.error) for r in reqs if r.error is not None]}")
    return reqs, counts


def phase_continuous(torch, model, proc, tok, cfg, main_counts):
    """Continuous serving (``continuous.ContinuousBatcher``) on the seeded
    3B model, the final norm redrawn as in phase 7: identity engines against
    batch 1, the throughput cell at server.py's shipped configuration in
    bf16 and int8, and ``server_torch.py``'s builder over HTTP."""
    with _tokens_that_change(torch, model):
        return _phase_continuous(torch, model, proc, tok, cfg, main_counts)


ISOLATION_GROUP = 32  # the group batch a join prefill's row 0 is held to batch 1 at


def _join_isolation(torch, model, proc, cfg):
    """One request's join prefill (``serving.batched_prefill``, what
    ``continuous._JoinPrefill`` captures) at group batch 1 and at
    ISOLATION_GROUP from the same weights, the request at row 0 in both and
    the identity traffic's requests in the other rows; row 0 compared op by
    op, every ATen operation and every kernel call (``utils/rowdiff``).
    Prints the first op that parts it and fails if that op is a kernel of
    the port."""
    from paligemma_tpu_torch import serving
    from paligemma_tpu_torch.models import gemma
    from paligemma_tpu_torch.utils import rowdiff

    dev = torch.device("cuda")
    rows = [_inputs_of(torch, model, proc, p, im) for p, im, _ in _cont_traffic()]
    bucket = max(ids.shape[1] for ids, _ in rows)
    g = ISOLATION_GROUP
    size = cfg.vision_config.image_size
    ids = torch.zeros((g, bucket), dtype=torch.int32, device=dev)
    pix = torch.zeros((g, 3, size, size), dtype=rows[0][1].dtype, device=dev)
    valid = torch.zeros(g, dtype=torch.int32, device=dev)
    for r in range(g):
        i, p = rows[r % len(rows)]
        ids[r, : i.shape[1]], pix[r], valid[r] = i[0], p[0], i.shape[1]

    def run(fns, b):
        cache = gemma.init_cache(cfg.text_config, b, bucket, gemma.activation_dtype(model.llm), dev)
        return serving.batched_prefill(model, ids[:b], pix[:b], valid[:b], cache, fns)[0]

    t0 = time.perf_counter()
    diff = rowdiff.first_row_difference(run, 1, g, labels=rowdiff.model_labels(model))
    torch.cuda.synchronize()
    tag = "[continuous isolation]"
    head = (f"{tag} request 0's join prefill (valid {int(valid[0])}, bucket {bucket}) at group batch 1 and "
            f"{g}, row 0 op by op ({time.perf_counter() - t0:.1f} s):")
    if diff is None:
        log(f"{head} every op's row 0 is the same bits")
    else:
        log(f"{head} first op whose row 0 differs: #{diff['index']} {diff['op']} in {diff['where']} (inputs "
            f"{diff['inputs']}), "
            + (diff["sequence"] if "sequence" in diff else
               f"output {diff['shape']}, {diff['differing']} of {diff['elements']} elements differ, max abs err "
               f"{diff['max_abs_err']:.3e}")
            + f" ({diff['compared'] - 1} ops before it agree)")
    check(diff is None or not diff["op"].startswith("fns."),
          f"{tag} a kernel of the port parts row 0 across group batches: {diff}")
    return diff


def _phase_continuous(torch, model, proc, tok, cfg, main_counts):
    from paligemma_tpu_torch import generation, quantization
    from paligemma_tpu_torch.continuous import ContinuousBatcher

    n_img = cfg.vision_config.num_image_tokens
    traffic = _cont_traffic()
    record = {"identity": [], "throughput": [], "http": None,
              "isolation": _join_isolation(torch, model, proc, cfg)}
    gc.collect()
    torch.cuda.empty_cache()
    int8 = quantization.quantize_params(model, llm_only=True, mode="int8")
    engines = [
        ("bf16 plain", model, {}, None, ()),
        ("int8+kv_int8 kv_quant", int8, {"kv_quant": True}, torch.int8, ()),
        ("bf16 spec k=8 adaptive kv_window ngram", model,
         {"spec_ks": (8,), "spec_adaptive": True, "spec_chunk": CONT_CHUNK // 2, "kv_window": True}, None, ()),
        ("bf16 spec k=8 adaptive kv_window longest", model,
         {"spec_ks": (8,), "spec_adaptive": True, "spec_chunk": CONT_CHUNK // 2, "kv_window": True,
          "spec_drafter": "longest"}, None, ()),
        ("bf16 mixed greedy/sampled", model, {}, None, (1, 4, 7, 10)),
    ]
    refs = {}
    for name, m, kw, cache_dtype, sampled in engines:
        tag = f"[continuous {name}]"
        key = (id(m), cache_dtype)
        if key not in refs:
            refs[key] = [generation.generate(m, *_inputs_of(torch, m, proc, p, im), n, tok.eos_token_id,
                                             cache_dtype=cache_dtype)[0] for p, im, n in traffic]
        ref = refs[key]

        def engine():
            return ContinuousBatcher(m, proc, n_slots=CONT_SLOTS, chunk=CONT_CHUNK, max_new_tokens=CONT_MAX_NEW,
                                     prompt_budget=[n_img + e for e in CONT_EXTRA_BUCKETS], seed=SEED, **kw)

        eng = engine()
        t0 = time.perf_counter()
        reqs, counts = _run_engine(torch, eng, traffic, sampled)
        wall = time.perf_counter() - t0
        eng.close()
        main_counts.update(counts)
        check(counts.get("decode_attention", 0) > 0 and counts.get("flash_attention", 0) > 0,
              f"{tag} the engine launched no attention kernel")
        divs = [None if i in sampled else
                _held_to_batch1(torch, m, proc, tag, p, im, r.tokens, ref[i], cache_dtype)
                for i, ((p, im, _), r) in enumerate(zip(traffic, reqs))]
        extra = ""
        if sampled:
            again, _ = _run_engine(torch, engine(), traffic, sampled)
            same = all(a.tokens == b.tokens for a, b in zip(reqs, again))
            check(same, f"{tag} one seed gave two sampled streams")
            check(all(0 <= x < cfg.text_config.vocab_size for i in sampled for x in reqs[i].tokens),
                  f"{tag} sampled token out of range")
            extra = f" | sampled rows {list(sampled)} repeat under one seed: {same}"
        if eng.spec_k:
            extra += (f" | spec chunks {sum(eng.spec_mode_log)} of {len(eng.spec_mode_log)}, tokens/verify "
                      f"{eng.spec_emitted / max(eng.spec_verifies, 1):.3f}, window resizes {eng.window_resizes} "
                      f"(buckets {list(eng.window_buckets)})")
        equal = sum(d is None for i, d in enumerate(divs) if i not in sampled)
        log(f"{tag} {len(traffic)} requests, {sum(len(r.tokens) for r in reqs)} tokens in {wall:.2f} s "
            f"(captures included), {eng.chunks_run} chunks, {eng.join_groups} join groups | greedy requests "
            f"equal to batch 1: {equal} of {len(traffic) - len(sampled)}, first differences {divs} | launches "
            f"{counts} | pixel path: {'affine' if eng.pixel_affine else 'gather'}{extra}")
        record["identity"].append({"engine": name, "first_differences": divs, "launches": counts,
                                   "wall_s": wall, "pixel_affine": eng.pixel_affine})
        del eng
    refs.clear()

    for name, m in (("bf16", model), ("int8", int8)):
        record["throughput"].append(_throughput_arm(torch, name, m, proc, cfg, main_counts))
        gc.collect()
        torch.cuda.empty_cache()
    del int8
    record["http"] = _http_arm(torch, model, proc, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    return record


def _throughput_traffic(n):
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(SEED + 64)
    # The prompts that fit the cell's one bucket (BOS + text + newline).
    prompts = [p for p in [r[0] for r in REQUESTS] + CONT_PROMPTS if len(p) + 2 <= THROUGHPUT_EXTRA]
    return [(prompts[i % len(prompts)],
             Image.fromarray(rng.randint(0, 256, (int(rng.randint(150, 400)), int(rng.randint(150, 400)), 3),
                                         dtype=np.uint8)),
             THROUGHPUT["max_new_tokens"]) for i in range(n)]


def _throughput_arm(torch, name, model, proc, cfg, main_counts):
    """The shipped configuration (32 slots, chunk 32, the adaptive k = 8
    ladder at spec_chunk 16, the cache window, one prompt bucket of the
    image tokens + 64, 64 new tokens) under 64 requests submitted at once:
    every graph captured ahead (``prepare``), one untimed run, one timed
    run (no capture allowed in it), one run under torch.profiler for the
    device-busy share."""
    from paligemma_tpu_torch.continuous import ContinuousBatcher
    from paligemma_tpu_torch.ops import kernels

    tag = f"[continuous throughput {name}]"
    traffic = _throughput_traffic(THROUGHPUT_REQUESTS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ContinuousBatcher(model, proc, prompt_budget=cfg.vision_config.num_image_tokens + THROUGHPUT_EXTRA,
                            seed=SEED, **THROUGHPUT)
    prep_ms = eng.prepare()
    _run_engine(torch, eng, traffic)  # untimed
    n_graphs = len(eng.graph_log)
    before = {k: getattr(eng, k) for k in ("tokens_delivered", "chunks_run", "join_groups", "window_resizes",
                                          "staged_hits", "staged_misses", "spec_emitted", "spec_verifies")}
    host0 = dict(eng.host_t)
    spec0 = len(eng.spec_mode_log), sum(eng.spec_mode_log)
    t0 = time.perf_counter()
    reqs, counts = _run_engine(torch, eng, traffic)
    wall = time.perf_counter() - t0
    main_counts.update(counts)
    delta = {k: getattr(eng, k) - v for k, v in before.items()}
    host = {k: round(v - host0.get(k, 0.0), 4) for k, v in eng.host_t.items()}
    check(len(eng.graph_log) == n_graphs, f"{tag} a graph was captured inside the timed run")
    check(delta["tokens_delivered"] == sum(len(r.tokens) for r in reqs), f"{tag} tokens_delivered is off")
    tok_s = delta["tokens_delivered"] / wall
    spec_chunks = sum(eng.spec_mode_log) - spec0[1], len(eng.spec_mode_log) - spec0[0]
    # The device-busy share: the kernels' device time over the wall time of
    # a run under the profiler (CUDA activity only).
    prof_acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=prof_acts) as prof:
        t1 = time.perf_counter()
        _run_engine(torch, eng, traffic)
        prof_wall = time.perf_counter() - t1
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    busy = busy_us / 1e6 / prof_wall
    peak = torch.cuda.max_memory_allocated() / 2**20
    eng.close()
    graphs = eng.graph_log
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    step_ms = _slot_step_ms(torch, model, proc, cfg, traffic)
    log(f"{tag} {THROUGHPUT_REQUESTS} requests at once, {delta['tokens_delivered']} tokens delivered in "
        f"{wall:.3f} s: {tok_s:.1f} tokens/s of wall time | chunks {delta['chunks_run']} (speculative "
        f"{spec_chunks[0]} of {spec_chunks[1]}, tokens/verify "
        f"{delta['spec_emitted'] / max(delta['spec_verifies'], 1):.3f}) | join groups {delta['join_groups']}")
    log(f"{tag} host_t seconds {json.dumps(host)}")
    log(f"{tag} window resizes {delta['window_resizes']} (buckets {list(_throughput_windows())}) | staged "
        f"uploads: hits {delta['staged_hits']}, misses {delta['staged_misses']}")
    log(f"{tag} graphs captured {len(graphs)} by prepare() in {prep_ms:.1f} ms: "
        + "; ".join(f"{g['key']} {g['ms']:.1f} ms {g['mib']:.1f} MiB" for g in graphs))
    log(f"{tag} {THROUGHPUT['n_slots']} occupied slots ({THROUGHPUT['n_slots'] + 1} rows), CUDA events over "
        f"replays from one state: plain slot step "
        f"{step_ms['plain']:.4f} ms (window {step_ms['plain_window']}), k = 8 verify "
        f"{step_ms['verify']:.4f} ms (window {step_ms['verify_window']})")
    log(f"{tag} peak {peak:.1f} MiB (max_memory_allocated over the arm) | device busy {busy:.4f} of the wall "
        f"time ({busy_us / 1e3:.1f} ms of kernels in a {prof_wall * 1e3:.1f} ms profiled run)")
    check(delta["chunks_run"] > 0 and tok_s > 0, f"{tag} nothing ran")
    out = {"arm": name, "tokens_per_s": tok_s, "wall_s": wall, "tokens": delta["tokens_delivered"],
           "chunks": delta["chunks_run"], "spec_chunks": spec_chunks[0], "join_groups": delta["join_groups"],
           "host_t": host, "window_resizes": delta["window_resizes"], "staged_hits": delta["staged_hits"],
           "staged_misses": delta["staged_misses"], "graphs": graphs, "peak_mib": peak,
           "device_busy": busy, "launches": counts, "slot_step_ms": step_ms}
    return out


def _slot_step_ms(torch, model, proc, cfg, traffic, settings=THROUGHPUT, lora_rank=None, adapters=()):
    """Device ms of one plain slot step and one k = 8 verify with the
    engine's slots occupied (just joined; by default the throughput cell's
    32): each flavour's graph (captured untimed) replayed 16 times from the
    same saved state between CUDA events, best of 3. With ``adapters``
    ((name, adapter, scale), ...) the slots take them in turn with base
    requests between."""
    from paligemma_tpu_torch.continuous import ContinuousBatcher

    eng = ContinuousBatcher(model, proc, prompt_budget=cfg.vision_config.num_image_tokens + THROUGHPUT_EXTRA,
                            seed=SEED, prefetch=False, lora_rank=lora_rank, **settings)
    names = [None]
    for name, tree, scale in adapters:
        eng.register_adapter(name, tree, scale)
        names.append(name)
    for i, (p, im, m) in enumerate(traffic[: eng.n_slots]):
        eng.submit(p, im, m, adapter=names[i % len(names)])
    eng._fill_slots()  # one group joins: every slot at its prompt's length
    c = eng.full_cache
    tensors = eng.state.tensors() + [c.k, c.v]
    saved = [x.clone() for x in tensors]
    top = int(max(eng.host_lengths))
    out, reps = {}, 16
    for name, k, advance in (("plain", 0, settings["chunk"]), ("verify", 8, reps * 8 + 8)):
        width = next(b for b in eng.window_buckets if b >= top + advance + 1)
        eng.window, eng.cache = width, eng._view(width)
        runner = eng._step_runner(k, False)
        times = []
        for _ in range(3):
            for dst, src in zip(tensors, saved):
                dst.copy_(src)
            eng.state.step.zero_()
            eng.state.counts.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            runner.run(reps, (None, None))
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / reps)
        out[name], out[f"{name}_window"] = min(times), width
    eng.close()
    del eng, saved
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _http_arm(torch, model, proc, cfg):
    """``server_torch.build_server`` serving the in-memory bf16 model on
    localhost in continuous mode (4 slots, chunk 8, plain chunks): four
    concurrent /generate requests and one /generate_stream give exactly the
    tokens an engine of the same settings gives them in-process, and
    /metrics answers. The in-process engine joins the requests in the
    server's join groups (its ``join_log``), at the same group batches: a
    prefill at another group batch may round a near tie apart."""
    import base64
    import io
    import socket
    import threading
    import urllib.request

    import server_torch
    from paligemma_tpu_torch.continuous import ContinuousBatcher

    with socket.socket() as sck:
        sck.bind(("127.0.0.1", 0))
        port = sck.getsockname()[1]
    args = server_torch.parser().parse_args(
        ["--continuous", "--n_slots", "4", "--chunk", "8", "--max_new_cap", "32", "--spec_k", "0",
         "--kv_window", "off", "--port", str(port)])
    t0 = time.perf_counter()
    server, _, runner = server_torch.build_server(model, proc, args, "paligemma_3b_pt_224 seeded bf16")
    build_s = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{port}"
    traffic = _cont_traffic()[:5]
    blobs = []
    for _, im, _ in traffic:
        buf = io.BytesIO()
        im.save(buf, "PNG")
        blobs.append(base64.b64encode(buf.getvalue()).decode())

    def post(path, body):
        req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        return urllib.request.urlopen(req, timeout=300)

    got = {}
    try:
        def worker(i):
            with post("/generate", {"prompt": traffic[i][0], "image_b64": blobs[i], "max_tokens": 24}) as r:
                got[i] = json.loads(r.read())["tokens"]

        def streamer(i):
            toks = []
            with post("/generate_stream", {"prompt": traffic[i][0], "image_b64": blobs[i], "max_tokens": 24}) as r:
                for line in r:
                    line = line.decode().strip()
                    if line.startswith("data: "):
                        ev = json.loads(line[6:])
                        check("error" not in ev, f"[http] stream error {ev}")
                        toks.extend(ev.get("tokens", []))
            got[i] = toks

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        threads.append(threading.Thread(target=streamer, args=(4,)))
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        http_s = time.perf_counter() - t1
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            metrics = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
    check(sorted(got) == list(range(5)), f"[http] only {sorted(got)} of 5 requests answered")
    check(metrics.get("mode") == "continuous" and metrics.get("tokens_delivered", 0) > 0, "[http] /metrics is off")
    srv = runner.batcher
    index = {traffic[i][0]: i for i in range(5)}
    prompt_of = {r.id: r.prompt for r in srv.completed}
    srv_groups = [(g_b, [index[prompt_of[m]] for m in members]) for g_b, members in srv.join_log
                  if all(prompt_of.get(m) in index for m in members)]
    check(sorted(i for _, ms in srv_groups for i in ms) == list(range(5)),
          f"[http] the server's join groups {srv_groups} do not hold the 5 requests once each")
    images = [_image_from_blob(b) for b in blobs]
    eng = ContinuousBatcher(model, proc, n_slots=4, chunk=8, max_new_tokens=32,
                            prompt_budget=[cfg.vision_config.num_image_tokens + 64])
    reqs = _replay_groups(eng, srv_groups, [(traffic[i][0], images[i], 24) for i in range(5)])
    eng.close()
    pos = {r.id: i for i, r in reqs.items()}
    eng_groups = [(g_b, [pos[m] for m in members]) for g_b, members in eng.join_log]
    log(f"[http] join groups (group batch, requests): server {srv_groups} | in-process {eng_groups}")
    check(eng_groups == srv_groups, "[http] the in-process engine did not join in the server's groups")
    same = [got[i] == reqs[i].tokens for i in range(5)]
    for i in range(5):
        if not same[i]:
            log(f"[http] request {i} ({traffic[i][0]!r}): first difference from the in-process engine at "
                f"{_first_difference(got[i], reqs[i].tokens)} | http {got[i]} | in-process {reqs[i].tokens}")
    check(all(same), "[http] the server's tokens are not the in-process engine's")
    log(f"[http] server_torch.build_server (continuous, 4 slots, chunk 8) built and warmed in {build_s:.1f} s | "
        f"4 concurrent /generate + 1 /generate_stream answered in {http_s:.2f} s | tokens equal to the "
        f"in-process engine's: {same} | /metrics mode {metrics['mode']}, tokens_delivered "
        f"{metrics['tokens_delivered']}, chunks_run {metrics['chunks_run']}, graphs_captured "
        f"{metrics['graphs_captured']}")
    return {"build_s": build_s, "http_s": http_s, "join_groups": srv_groups, "same_as_in_process": same,
            "metrics": metrics}


def _replay_groups(eng, groups, items):
    """Run ``items`` (prompt, image, max_new_tokens) through ``eng`` joined in
    ``groups`` (group batch, item indices), in order: each group is submitted
    once the engine has as many free slots, so it joins whole. Returns the
    requests by index."""
    reqs = {}
    for _, members in groups:
        while sum(r is None for r in eng.slot_req) < len(members):
            eng.step()
        for i in members:
            reqs[i] = eng.submit(*items[i])
        eng.step()
    eng.run()
    check(all(r.done and r.error is None for r in reqs.values()),
          f"a request ended with an error: {[repr(r.error) for r in reqs.values() if r.error is not None]}")
    return reqs


def _image_from_blob(blob):
    import base64
    import io

    from PIL import Image

    return Image.open(io.BytesIO(base64.b64decode(blob))).convert("RGB")


# ---------------------------------------------------------------------------
# LoRA: training (phase 15) and serving (phase 16)
# ---------------------------------------------------------------------------

LORA_R, LORA_ALPHA, LORA_DROPOUT = 8, 16, 0.1
LORA_STEPS, LORA_ACCUM, LORA_LR = 8, 2, 1e-3
# The training batch: T = 320 (256 image tokens + 64 text), the second row
# right-padded to 300.
LORA_VALID = (320, 300)
# Bars, stated before the first run (PERF.md, PR 15), and why:
# - The adapter gradients of one step through the kernels against the plain
#   versions: the two differ only in the flash forward (a bf16 rounding of
#   some outputs apart in each of 45 calls), which moves the bf16 residual
#   stream by well under 1%: cosine >= 0.999 and a norm within 1%.
LORA_GRAD_COS, LORA_GRAD_GAP = 0.999, 0.01
# - The flash Function's dq, dk, dv against autograd of the plain version:
#   the same computation run twice, so within 1e-5 of the largest element.
FLASH_GRAD_RTOL = 1e-5
# - d hidden of the fp32 lm_head against autograd of the widened product:
#   d logits rounded to bf16 (2^-9 relative) summed over 257152 rows in
#   fp32, so cosine >= 0.9999 and within 2^-6 of the largest element.
LOGITS_GRAD_COS, LOGITS_GRAD_MAX = 0.9999, 2.0**-6
# - Phase 16: tokens as phase 10's rule (LOGIT_REL_TOL).
LORA_SERVE_NEW = 24


def _cos_gap(torch, got, ref):
    got, ref = got.double().flatten(), ref.double().flatten()
    return float(got @ ref / (got.norm() * ref.norm())), abs(float(got.norm() / ref.norm()) - 1.0)


def _lora_batch(torch, proc, cfg):
    """Two rows built as ``data.py`` builds a sample (the template, padding
    with the pad id to T, labels on the text positions), valid LORA_VALID."""
    import numpy as np

    n_img, t = cfg.vision_config.num_image_tokens, LORA_VALID[0]
    text = "what is the total revenue, the operating margin and the net income reported on this page? "
    pad = getattr(proc.tokenizer, "pad_token_id", 0) or 0
    ids = np.full((2, t), pad, np.int32)
    labels = np.full((2, t), cfg.ignore_index, np.int32)
    pix = []
    for i, valid in enumerate(LORA_VALID):
        out = proc([text[: valid - n_img - 2]], [_request_image(i)])
        row = np.asarray(out["input_ids"][0], np.int32)
        check(len(row) == valid, f"[lora train] row {i} templated to {len(row)} tokens, not {valid}")
        ids[i, :valid] = row
        labels[i, n_img:valid] = row[n_img:]
        pix.append(out["pixel_values"][0])
    return {"input_ids": ids, "pixel_values": np.stack(pix).astype(np.float32), "labels": labels,
            "valid_len": np.asarray(LORA_VALID, np.int32)}


def _device_ms(torch, fn, iters=10, skip=()):
    """(device ms, host ms) per call of ``fn``: the CUDA kernels' time under
    torch.profiler (kernels whose name holds one of ``skip`` left out) and
    the host clock to a synchronize, averaged over ``iters`` calls after
    two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / iters
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and not any(k in e.key for k in skip))
    return us / 1e3 / iters, host


def _flash_training(torch):
    """The flash Function at the Gemma training shape (2 x 320, H 8, Hkv 1,
    D 256, valid 320 and 300): the forward bit for bit the no-grad kernel;
    dq, dk, dv against autograd of the plain version; forward, backward,
    plain and SDPA forward + backward times beside the bounds."""
    import torch.nn.functional as F

    from paligemma_tpu_torch.ops import cuda_attention as ca

    dev = torch.device("cuda")
    b, t, h, hkv, d = 2, LORA_VALID[0], 8, 1, 256
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    q, k, v = (_rand(torch, gen, (b, t, n, d), dev).requires_grad_() for n in (h, hkv, hkv))
    valid = torch.tensor(LORA_VALID, dtype=torch.int32, device=dev)
    w = _rand(torch, gen, (b, t, h, d), dev)
    out = ca.flash_attention(q, k, v, valid)
    with torch.no_grad():
        same = torch.equal(out, ca.flash_attention(q, k, v, valid))
    check(out.grad_fn is not None and same, "[lora flash] the Function's forward is not the kernel's bits")
    grads = torch.autograd.grad(out, (q, k, v), w)
    ref = torch.autograd.grad(ca.flash_attention_plain(q, k, v, valid), (q, k, v), w)
    errs = []
    for name, g, r in zip("qkv", grads, ref):
        err = float((g.float() - r.float()).abs().max())
        errs.append(err)
        check(err <= FLASH_GRAD_RTOL * float(r.float().abs().max()),
              f"[lora flash] d{name} is {err:.3e} off autograd of the plain version")

    def fwd():
        with torch.no_grad():
            ca.flash_attention(q, k, v, valid)

    def fwd_bwd(fn):
        def run():
            torch.autograd.grad(fn(q, k, v, valid), (q, k, v), w)
        return run

    mask = (torch.arange(t, device=dev)[None, :] < valid[:, None])[:, None, None, :]  # (B, 1, 1, S)

    def sdpa(q, k, v, valid):
        o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                           attn_mask=mask, enable_gqa=True)
        return o.transpose(1, 2)

    fwd_ms = _time_ms(torch, lambda i: fwd())
    bwd_ms, bwd_host = _device_ms(torch, fwd_bwd(ca.flash_attention), skip=("flash_attention_kernel",))
    plain_ms, _ = _device_ms(torch, fwd_bwd(ca.flash_attention_plain))
    sdpa_ms, _ = _device_ms(torch, fwd_bwd(sdpa))
    nbytes, ops = _attention_cost(b, t, t, h, hkv, d)
    bound_f, by_f = _bound(nbytes, ops, "bf16")
    # The backward reads q, k, v, out's gradient and writes dq, dk, dv; it
    # takes five products of the forward's size where the forward takes two.
    bound_b, by_b = _bound(2 * nbytes, 2.5 * ops, "bf16")
    rec = {"shape": f"train B={b} T=S={t} H={h} Hkv={hkv} D={d} valid {list(LORA_VALID)}",
           "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "bwd_host_ms": bwd_host, "fwd_bound_ms": bound_f,
           "fwd_bound_by": by_f, "bwd_bound_ms": bound_b, "bwd_bound_by": by_b,
           "plain_fwd_bwd_ms": plain_ms, "sdpa_fwd_bwd_ms": sdpa_ms, "grad_max_abs_err": max(errs),
           "launches_per_micro_step": None}
    log(f"[lora flash] {rec['shape']}: Function forward bit for bit the kernel: {same} | dq dk dv max abs err "
        f"{errs} vs autograd of the plain version | device ms: forward (kernel) {fwd_ms:.4f} (bound "
        f"{bound_f:.4g}, {by_f}), backward {bwd_ms:.4f} (bound {bound_b:.4g}, {by_b}; host {bwd_host:.4f}), "
        f"plain forward + backward {plain_ms:.4f}, SDPA forward + backward {sdpa_ms:.4f}")
    return rec


def _logits_grad(torch, model):
    """d hidden of ``gemma.logits`` at the training shape against autograd
    of the widened fp32 product."""
    from paligemma_tpu_torch.models import gemma

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    h = _rand(torch, gen, (2, LORA_VALID[0], model.cfg.text_config.hidden_size), dev).requires_grad_()
    emb = model.llm.embed
    g = torch.randn((2, LORA_VALID[0], emb.shape[0]), generator=gen, device=dev)
    (dh,) = torch.autograd.grad(gemma.logits(model.llm, h), h, g)
    (ref,) = torch.autograd.grad(h.float() @ emb.float().t(), h, g)
    cos, gap = _cos_gap(torch, dh, ref)
    err = float((dh.float() - ref.float()).abs().max())
    rel = err / float(ref.float().abs().max())
    log(f"[lora logits] d hidden of the fp32 lm_head (2 x {LORA_VALID[0]} x {emb.shape[0]}) against autograd of "
        f"the widened product: cosine {cos:.7f}, norm gap {gap:.2e}, max abs err {err:.3e} ({rel:.2e} of the "
        f"largest)")
    check(cos >= LOGITS_GRAD_COS and rel <= LOGITS_GRAD_MAX, "[lora logits] the lm_head gradient is off")
    del g, dh, ref
    return {"cos": cos, "norm_gap": gap, "max_rel_err": rel}


def phase_lora_train(torch, model, proc, cfg, main_counts, out_dir):
    """LoRA training at full width on the seeded bf16 model (phase 15):
    gradients through the kernels against the plain versions, the flash
    Function and the lm_head gradient, then LORA_STEPS micro-steps with
    accumulation LORA_ACCUM on one batch, the adapter saved and read back."""
    import copy

    from paligemma_tpu_torch import lora
    from paligemma_tpu_torch.models import paligemma
    from paligemma_tpu_torch.ops import kernels
    from paligemma_tpu_torch.ops.kernels import PLAIN

    dev = torch.device("cuda")
    tag = "[lora train]"
    batch = lora.batch_to(_lora_batch(torch, proc, cfg), dev)
    lcfg = lora.LoraConfig(r=LORA_R, alpha=LORA_ALPHA, dropout=LORA_DROPOUT)
    flash = _flash_training(torch)
    logits_rec = _logits_grad(torch, model)

    # One step's adapter gradients through KERNELS and PLAIN (same masks),
    # B seeded non-zero: at B = 0 the gradient of A is zero.
    probe = lora.init_lora(cfg, lcfg, torch.Generator(device=dev).manual_seed(SEED + 2), dev)
    bgen = torch.Generator(device=dev).manual_seed(SEED + 3)
    for mod in probe["layers"].values():
        mod["b"].normal_(0.0, 0.01, generator=bgen)

    def grads(fns):
        live = lora._map(lambda x: x.detach().requires_grad_(), probe)
        loss = paligemma.loss_fn(model, batch["input_ids"], batch["pixel_values"], batch["labels"],
                                 valid_len=batch["valid_len"], lora=live, lora_scale=lcfg.scale,
                                 lora_dropout=lcfg.dropout,
                                 lora_generator=torch.Generator(device=dev).manual_seed(SEED + 4), fns=fns)
        return float(loss), [g.float() for g in torch.autograd.grad(loss, lora.adapter_leaves(live))]

    loss_k, gk = grads(kernels.KERNELS)
    loss_p, gp = grads(PLAIN)
    cos, gap = _cos_gap(torch, torch.cat([g.flatten() for g in gk]), torch.cat([g.flatten() for g in gp]))
    leaf_cos = [round(_cos_gap(torch, a, b)[0], 6) for a, b in zip(gk, gp)]
    log(f"{tag} one step's adapter gradients (B seeded non-zero), kernels against plain versions: loss "
        f"{loss_k:.6f} vs {loss_p:.6f}, cosine {cos:.7f} (bar {LORA_GRAD_COS}), norm gap {gap:.2e} (bar "
        f"{LORA_GRAD_GAP}), per tensor cosines {leaf_cos}")
    check(cos >= LORA_GRAD_COS and gap <= LORA_GRAD_GAP, f"{tag} the kernel path's gradients are off")
    del gk, gp, probe

    ad = lora.init_lora(cfg, lcfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    opt = lora.default_optimizer(lr=LORA_LR, accum_steps=LORA_ACCUM)
    state = opt.init(ad)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    # The compiled run starts from these copies of the eager run's start.
    start_ad, start_state, start_gen = lora._map(lambda x: x.clone(), ad), copy.deepcopy(state), gen.get_state()

    def eager(model, ad, state, batch, gen):
        return lora.train_step(model, ad, state, batch, gen, lcfg, opt)

    def run_steps(step, ad, state, gen):
        """LORA_STEPS micro-steps: losses, host and device-event ms, the
        captures each made, launches, peak MiB, the final adapter and state."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        losses, host_ms, dev_ms, captured = [], [], [], []
        for i in range(LORA_STEPS):
            before = len(getattr(step, "log", ()))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            loss, ad, state = step(model, ad, state, batch, gen)
            end.record()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            dev_ms.append(start.elapsed_time(end))
            losses.append(float(loss))
            captured.append(len(getattr(step, "log", ())) - before)
        counts = {k: v for k, v in kernels.call_counts().items() if v}
        return (losses, host_ms, dev_ms, captured, counts, torch.cuda.max_memory_allocated() / 2**20,
                ad, state)

    losses, host_ms, dev_ms, _, counts, peak, ad, state = run_steps(eager, ad, state, gen)
    n_layers = cfg.vision_config.num_hidden_layers + cfg.text_config.num_hidden_layers
    flash["launches_per_micro_step"] = counts.get("flash_attention", 0) / LORA_STEPS
    main_counts.update(counts)
    log(f"{tag} {LORA_STEPS} eager micro-steps (lora.train_step), accumulation {LORA_ACCUM}, lr {LORA_LR}, r "
        f"{LORA_R} alpha {LORA_ALPHA} dropout {LORA_DROPOUT}, B=2 T={LORA_VALID[0]} valid {list(LORA_VALID)}: "
        f"losses {losses} | launches {counts} ({n_layers} flash a micro-step expected) | micro-step host ms "
        f"{[round(x, 2) for x in host_ms]} | device-event ms {[round(x, 2) for x in dev_ms]} | peak {peak:.1f} MiB")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], f"{tag} the loss did not fall")
    check(counts == {"flash_attention": LORA_STEPS * n_layers}, f"{tag} launches {counts} are not the code's")
    compiled = _compiled_training(torch, model, batch, lcfg, opt, run_steps, eager, n_layers,
                                  (start_ad, start_state, start_gen), (losses, ad, state, gen), main_counts)

    # The optimizer step alone (the k-th call), on copies.
    g = [torch.randn_like(p) for p in lora.adapter_leaves(ad)]
    ad2, st2 = lora._map(lambda x: x.clone(), ad), copy.deepcopy(state)
    opt_ms = []
    for _ in range(5):
        st2["mini_step"] = LORA_ACCUM - 1
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        st2 = opt.update(g, st2, ad2)
        end.record()
        torch.cuda.synchronize()
        opt_ms.append(((time.perf_counter() - t0) * 1e3, start.elapsed_time(end)))
    log(f"{tag} optimizer step (clip + AdamW over {sum(p.numel() for p in g)} values) host / device-event ms "
        f"{[(round(a, 3), round(b, 3)) for a, b in opt_ms]}")

    t0 = time.perf_counter()
    fmt = lora.save_checkpoint_robust(ad, lcfg, out_dir, LORA_STEPS, {"final": True})
    back = lora.load_adapter(out_dir, device=dev)
    same = all(torch.equal(a, b) for a, b in zip(lora.adapter_leaves(ad), lora.adapter_leaves(back)))
    log(f"{tag} save_checkpoint_robust -> {fmt} in {out_dir}, read back bit for bit: {same} "
        f"({(time.perf_counter() - t0) * 1e3:.1f} ms)")
    check(fmt == "safetensors" and same, f"{tag} the saved adapter does not read back")
    steady = host_ms[LORA_ACCUM:]
    compiled["eval"] = _compiled_eval(torch, model, batch, lcfg, ad)
    return ad, lcfg, {"losses": losses, "launches": counts, "host_ms": host_ms, "device_event_ms": dev_ms,
                      "steady_host_ms": sum(steady) / len(steady), "optimizer_ms": opt_ms, "peak_mib": peak,
                      "grad_cos": cos, "grad_norm_gap": gap, "flash": flash, "logits": logits_rec,
                      "compiled": compiled}


def _compiled_training(torch, model, batch, lcfg, opt, run_steps, eager, n_layers, start, eager_end,
                       main_counts):
    """Phase 15's compiled step (``lora.make_train_step``: CUDA graph
    replays) over the eager run's LORA_STEPS micro-steps from the same
    adapter, optimizer state and dropout-generator state: each loss, the
    final adapter, the optimizer state and the generator bit for bit the
    eager run's; one capture a flavour, at its first micro-step; then
    profiled beside the eager step (device ms, busy share)."""
    import copy

    from paligemma_tpu_torch import lora

    dev = torch.device("cuda")
    tag = "[lora compiled]"
    losses, ad, state, gen = eager_end
    cgen = torch.Generator(device=dev)
    cgen.set_state(start[2])
    step = lora.make_train_step(lcfg, opt)
    closses, host_ms, dev_ms, captured, counts, peak, cad, cstate = run_steps(step, start[0], start[1], cgen)
    main_counts.update(counts)
    same_ad = all(torch.equal(a, b) for a, b in zip(lora.adapter_leaves(ad), lora.adapter_leaves(cad)))
    same_state = all(torch.equal(a, b) for k in ("acc", "mu", "nu") for a, b in zip(state[k], cstate[k]))
    same_gen = torch.equal(gen.get_state(), cgen.get_state())
    flavours = [e["key"][1] for e in step.log]
    steady = [i for i, c in enumerate(captured) if not c]
    host = sum(host_ms[i] for i in steady) / len(steady)
    event = sum(dev_ms[i] for i in steady) / len(steady)
    log(f"{tag} the same {LORA_STEPS} micro-steps as CUDA graph replays from the same start: losses {closses} | "
        f"bit for bit the eager run's: losses {closses == losses}, adapter {same_ad}, optimizer state "
        f"{same_state}, dropout generator {same_gen} | captures per micro-step {captured} (flavours "
        f"{['apply' if f else 'accumulate' for f in flavours]}, ms {[round(e['ms'], 1) for e in step.log]}, pool "
        f"MiB {[round(e['mib'], 1) for e in step.log]}) | launches {counts} | micro-step host ms "
        f"{[round(x, 2) for x in host_ms]} | device-event ms {[round(x, 2) for x in dev_ms]} | peak {peak:.1f} MiB")
    check(closses == losses and same_ad and same_state and same_gen,
          f"{tag} the compiled micro-steps are not the eager run's bits")
    check(captured == [1] * LORA_ACCUM + [0] * (LORA_STEPS - LORA_ACCUM) and flavours == [False] * (LORA_ACCUM - 1)
          + [True], f"{tag} captures {captured} (flavours {flavours}): one a flavour, at its first micro-step")
    check(counts == {"flash_attention": LORA_STEPS * n_layers}, f"{tag} launches {counts} are not the code's")

    # Device time and busy share, both steps over the same calls (both
    # flavours in turn), on copies that nothing reads after.
    prof = {}
    for name, fn in (("eager", eager), ("compiled", step)):
        if name == "compiled":
            ad_p, box = cad, [cstate]
        else:
            ad_p, box = lora._map(lambda x: x.clone(), ad), [copy.deepcopy(state)]

        def one(fn=fn, ad_p=ad_p, box=box):
            box[0] = fn(model, ad_p, box[0], batch, cgen)[2]

        device, host_p = _device_ms(torch, one, iters=2 * LORA_ACCUM)
        prof[name] = {"device_ms": device, "host_ms": host_p, "busy_share": device / host_p}
    log(f"{tag} profiled micro-step (mean of the two flavours), eager: host {prof['eager']['host_ms']:.3f} ms, "
        f"kernels {prof['eager']['device_ms']:.3f} ms, busy {prof['eager']['busy_share']:.1%} | compiled: host "
        f"{prof['compiled']['host_ms']:.3f} ms, kernels {prof['compiled']['device_ms']:.3f} ms, busy "
        f"{prof['compiled']['busy_share']:.1%} | steady compiled micro-step host {host:.3f} ms, device-event "
        f"{event:.3f} ms | {_smi()}")
    return {"losses": closses, "bit_for_bit": {"losses": closses == losses, "adapter": same_ad,
                                               "optimizer_state": same_state, "generator": same_gen},
            "captures_per_micro_step": captured, "captures": [{"apply": e["key"][1], "ms": e["ms"], "mib": e["mib"]}
                                                              for e in step.log],
            "pool_mib": sum(e["mib"] for e in step.log), "peak_mib": peak, "launches": counts,
            "host_ms": host_ms, "device_event_ms": dev_ms, "steady_host_ms": host, "steady_device_event_ms": event,
            "profiled": prof, "device": _smi()}


def _compiled_eval(torch, model, batch, lcfg, ad):
    """The finetune CLI's eval loss (``lora.make_eval_loss``): the first
    call (the capture's warm-up) and a replay bit for bit the eager
    ``no_grad`` ``loss_fn`` on the same batch and adapter; host and kernel ms
    of both."""
    from paligemma_tpu_torch import lora

    tag = "[lora eval]"
    fn = lora.make_eval_loss(lcfg.scale)
    ref = lora.eval_loss(model, ad, batch, lcfg.scale)
    t0 = time.perf_counter()
    first = fn(model, ad, batch).clone()
    torch.cuda.synchronize()
    capture_ms = (time.perf_counter() - t0) * 1e3
    replay = fn(model, ad, batch).clone()
    same = torch.equal(first, ref) and torch.equal(replay, ref)
    graph_dev, graph_host = _device_ms(torch, lambda: fn(model, ad, batch))
    eager_dev, eager_host = _device_ms(torch, lambda: lora.eval_loss(model, ad, batch, lcfg.scale))
    log(f"{tag} eval loss B=2 T={LORA_VALID[0]} through the adapter: eager {float(ref):.6f}, first call "
        f"{float(first):.6f}, replay {float(replay):.6f}, bit for bit: {same} | first call (eager warm-up + "
        f"capture) {capture_ms:.1f} ms | graph: host {graph_host:.3f} ms, kernels {graph_dev:.3f} ms | eager: host "
        f"{eager_host:.3f} ms, kernels {eager_dev:.3f} ms | {_smi()}")
    check(same, f"{tag} the compiled eval loss is not the eager loss's bits")
    return {"loss": float(ref), "bit_for_bit": same, "first_call_ms": capture_ms, "graph_host_ms": graph_host,
            "graph_device_ms": graph_dev, "eager_host_ms": eager_host, "eager_device_ms": eager_dev,
            "device": _smi()}


def phase_lora_serving(torch, model, proc, cfg, trained, lcfg, adapter_dir, main_counts):
    """Multi-tenant LoRA serving on the 3B model, the final norm redrawn as
    in phase 7 (phase 16)."""
    with _tokens_that_change(torch, model):
        return _phase_lora_serving(torch, model, proc, cfg, trained, lcfg, adapter_dir, main_counts)


def _lora_engine_run(torch, model, proc, cfg, traffic, names, lora_rank, adapters, n_slots=CONT_SLOTS):
    """Tokens and launches of ``traffic`` (with adapter ``names``) through one
    engine; every graph captured by ``prepare`` (none in the run)."""
    from paligemma_tpu_torch.continuous import ContinuousBatcher
    from paligemma_tpu_torch.ops import kernels

    eng = ContinuousBatcher(model, proc, n_slots=n_slots, chunk=CONT_CHUNK, max_new_tokens=CONT_MAX_NEW,
                            prompt_budget=[cfg.vision_config.num_image_tokens + e for e in CONT_EXTRA_BUCKETS],
                            seed=SEED, lora_rank=lora_rank)
    for name, tree, scale in adapters if lora_rank else ():
        eng.register_adapter(name, tree, scale)
    eng.prepare()
    n_graphs = len(eng.graph_log)
    kernels.reset_launch_counts()
    reqs = [eng.submit(p, im, m, adapter=a) for (p, im, m), a in zip(traffic, names)]
    eng.run()
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    eng.close()
    check(all(r.done and r.error is None for r in reqs), f"a request ended with an error: "
          f"{[repr(r.error) for r in reqs if r.error is not None]}")
    check(len(eng.graph_log) == n_graphs, "a graph was captured inside the run, after prepare")
    return [r.tokens for r in reqs], counts


def _phase_lora_serving(torch, model, proc, cfg, trained, lcfg, adapter_dir, main_counts):
    from paligemma_tpu_torch import generation, lora, quantization

    dev = torch.device("cuda")
    second_cfg = lora.LoraConfig(r=4, alpha=8, dropout=0.0)
    second = lora.init_lora(cfg, second_cfg, torch.Generator(device=dev).manual_seed(SEED + 5), dev)
    bgen = torch.Generator(device=dev).manual_seed(SEED + 6)
    for mod in second["layers"].values():
        mod["b"].normal_(0.0, 0.02, generator=bgen)
    adapters = [("trained", trained, lcfg.scale), ("second", second, second_cfg.scale)]
    traffic = [(p, im, LORA_SERVE_NEW) for p, im, _ in _cont_traffic()[:CONT_SLOTS]]
    names = [None, "trained", "second", None]
    record = {}
    int8 = quantization.quantize_params(model, llm_only=True, mode="int8")
    for arm, m in (("bf16", model), ("int8", int8)):
        tag = f"[lora serving {arm}]"
        t0 = time.perf_counter()
        got, counts = _lora_engine_run(torch, m, proc, cfg, traffic, names, LORA_R, adapters)
        wall = time.perf_counter() - t0
        main_counts.update(counts)
        base, _ = _lora_engine_run(torch, m, proc, cfg, traffic, [None] * len(traffic), None, ())
        same_base = [got[i] == base[i] for i, n in enumerate(names) if n is None]
        differs = [got[i] != base[i] for i, n in enumerate(names) if n is not None]
        log(f"{tag} lora_rank {LORA_R}, {CONT_SLOTS} slots, chunk {CONT_CHUNK}: requests {names} | base requests "
            f"equal to the base engine's: {same_base} | adapted requests differ from base: {differs} | launches "
            f"{counts} | {wall:.2f} s (captures included)")
        check(all(same_base), f"{tag} a base request is not the base engine's")
        check(all(differs), f"{tag} an adapter did not change its request's tokens")
        rec = {"same_base": same_base, "adapted_differ": differs, "launches": counts, "wall_s": wall}
        if arm == "bf16":
            iso, held = [], []
            for i, name in enumerate(names):
                if name is None:
                    continue
                alone, _ = _lora_engine_run(torch, m, proc, cfg, traffic[i:i + 1], [name], LORA_R, adapters,
                                            n_slots=1)
                tree, acfg = {"trained": (trained, lcfg), "second": (second, second_cfg)}[name]
                merged = lora.merge_lora(m, tree, acfg)
                p, im, n = traffic[i]
                ref, _ = generation.generate(merged, *_inputs_of(torch, merged, proc, p, im), n,
                                             proc.tokenizer.eos_token_id)
                held.append(_held_to_batch1(torch, merged, proc, f"{tag} {name} vs merge_lora batch 1", p, im,
                                            got[i], ref, None))
                iso.append(_held_to_batch1(torch, merged, proc, f"{tag} {name} alone in a 1-slot engine", p, im,
                                           got[i], alone[0], None))
                del merged
            log(f"{tag} adapted requests against merge_lora's batch-1 generate: first differences {held} | alone "
                f"in a 1-slot engine against beside the others: first differences {iso}")
            rec.update(first_difference_vs_merged=held, first_difference_alone=iso)
            no_lora = _slot_step_ms(torch, m, proc, cfg, _throughput_traffic(CONT_SLOTS),
                                    dict(THROUGHPUT, n_slots=CONT_SLOTS))
            with_lora = _slot_step_ms(torch, m, proc, cfg, _throughput_traffic(CONT_SLOTS),
                                      dict(THROUGHPUT, n_slots=CONT_SLOTS), LORA_R, adapters)
            log(f"{tag} {CONT_SLOTS} occupied slots, CUDA events over replays: plain slot step "
                f"{no_lora['plain']:.4f} ms without lora_rank, {with_lora['plain']:.4f} ms with lora_rank {LORA_R} | "
                f"k = 8 verify {no_lora['verify']:.4f} ms without, {with_lora['verify']:.4f} ms with")
            rec.update(slot_step_ms={"no_lora": no_lora, "lora": with_lora})
        record[arm] = rec
    del int8
    gc.collect()
    torch.cuda.empty_cache()
    record["http"] = _lora_http(torch, model, proc, cfg, trained, lcfg, adapter_dir)
    return record


def _lora_http(torch, model, proc, cfg, trained, lcfg, adapter_dir):
    """``server_torch.build_server`` with ``--continuous --adapter
    trained=DIR`` (the saved adapter): /healthz lists it, and a request that
    names it answers with the tokens an in-process engine of the same
    settings gives it."""
    import base64
    import io
    import socket
    import threading
    import urllib.request

    import server_torch
    from paligemma_tpu_torch.continuous import ContinuousBatcher

    with socket.socket() as sck:
        sck.bind(("127.0.0.1", 0))
        port = sck.getsockname()[1]
    args = server_torch.parser().parse_args(
        ["--continuous", "--n_slots", "4", "--chunk", "8", "--max_new_cap", "32", "--spec_k", "0",
         "--kv_window", "off", "--adapter", f"trained={adapter_dir}", "--port", str(port)])
    server, _, _ = server_torch.build_server(model, proc, args, "paligemma_3b_pt_224 seeded bf16")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{port}"
    prompt, image, _ = _cont_traffic()[1]
    buf = io.BytesIO()
    image.save(buf, "PNG")
    blob = base64.b64encode(buf.getvalue()).decode()
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        req = urllib.request.Request(base + "/generate", data=json.dumps(
            {"prompt": prompt, "image_b64": blob, "max_tokens": LORA_SERVE_NEW, "adapter": "trained"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            got = json.loads(r.read())["tokens"]
    finally:
        server.shutdown()
        server.server_close()
    eng = ContinuousBatcher(model, proc, n_slots=4, chunk=8, max_new_tokens=32,
                            prompt_budget=[cfg.vision_config.num_image_tokens + 64], lora_rank=LORA_R)
    eng.register_adapter("trained", trained, lcfg.scale)
    ref = eng.submit(prompt, _image_from_blob(blob), LORA_SERVE_NEW, adapter="trained")
    eng.run()
    eng.close()
    log(f"[lora http] build_server --continuous --adapter trained=DIR: /healthz adapters {health.get('adapters')} | "
        f"a request naming it gave the in-process engine's tokens: {got == ref.tokens}")
    check(health.get("adapters") == ["trained"], "[lora http] /healthz does not list the adapter")
    check(got == ref.tokens, "[lora http] the server's adapter tokens are not the in-process engine's")
    return {"adapters": health.get("adapters"), "same_as_in_process": got == ref.tokens}


# Phase 17: tensor, data, sequence and pipeline parallelism on the one card.
# Two ranks (processes) share the H100 over gloo: NCCL refuses two ranks on
# one device. gloo runs its collectives on the host, so these times are not
# a tensor-parallel speed; they show that the sharded code runs the kernels
# at the per-rank shapes and agrees with the unsharded model.
TP_RANKS = 2
TP_DECODE_TIMED = 8  # sharded decode steps timed a request (host ms a token)
TP_PIPE_MICRO = 2
# Bars, stated before the first run (PERF.md, section 6), and why:
# - logits of the sharded prefill against the unsharded one: row-parallel
#   products reduced in fp32 and rounded once, other sums in another order;
#   phase 5's bar (LOGIT_REL_TOL of the largest logit).
# - one LoRA micro-step's adapter gradients against the unsharded step's:
#   phase 15's bars (LORA_GRAD_COS, LORA_GRAD_GAP).
# - the pipelined loss against the unsharded loss: the same bf16 programs
#   on half the rows each (GEMMs of another M): within 0.5% of the loss.
TP_PIPE_LOSS_RTOL = 5e-3


def _tp_records(torch, model, proc, tok, cfg):
    """The unsharded references of phase 17 in this process (the final norm
    redrawn as in phase 7): per arm and request, the greedy tokens of
    ``generate`` and the prefill's last-position logits."""
    from paligemma_tpu_torch import generation, quantization
    from paligemma_tpu_torch.models import paligemma

    arms = {"bf16": model, "int8": quantization.quantize_params(model, llm_only=True, mode="int8")}
    refs = {}
    for arm, m in arms.items():
        refs[arm] = []
        for i in range(len(REQUESTS)):
            ids, pix = _request(torch, proc, i)
            toks, _ = generation.generate(m, ids, pix, MAX_NEW_TOKENS, tok.eos_token_id)
            cache = generation.make_cache(m, 1, ids.shape[1], 1)
            with torch.no_grad():
                lg, _ = paligemma.prefill(m, ids, pix, cache, full_logits=False)
            refs[arm].append({"tokens": toks, "logits": lg[0, -1].float().cpu()})
    return arms, refs


def _tp_rank(cfg, batch, dp_rows, traffic, n_img):
    """One rank of phase 17 (spawned; the card is shared): the seeded 3B
    model made on the card (the final norm redrawn as in phase 7), then
    each sharded path. Returns host-side results for the parent."""
    import torch

    from paligemma_tpu_torch import generation, lora, quantization
    from paligemma_tpu_torch.continuous import ContinuousBatcher
    from paligemma_tpu_torch.models import paligemma
    from paligemma_tpu_torch.ops import _build, kernels
    from paligemma_tpu_torch.parallel import pipeline, sharding, steps
    from paligemma_tpu_torch.parallel.mesh import make_mesh
    from paligemma_tpu_torch.processing import ByteTokenizer, PaliGemmaProcessor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    _build.load_library()  # built by phase 2 before any rank started
    dev = torch.device("cuda", torch.cuda.current_device())
    tok = ByteTokenizer()
    proc = PaliGemmaProcessor(tok, cfg.vision_config.num_image_tokens, cfg.vision_config.image_size)
    full = paligemma.init_params(cfg, SEED, device="cuda", dtype=torch.bfloat16)
    norm = full.llm.final_norm.weight
    gen = torch.Generator(device=dev).manual_seed(GREEDY_NORM_SEED)
    with torch.no_grad():
        norm.copy_(torch.randn(norm.shape, generator=gen, device=dev, dtype=torch.float32) - 1)
    mesh = make_mesh(1, TP_RANKS, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    out = {"rank": mesh.rank, "backend": mesh.backend, "arms": {}, "gloo_cuda": _gloo_cuda_table(torch, mesh)}

    def counted(fn):
        kernels.reset_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        return res, {k: v for k, v in kernels.call_counts().items() if v}

    # The sharded models: bf16 and int8, each rank's slices of the full one.
    models = {"bf16": sharding.shard_params(full, cfg, mesh)}
    out["bytes"] = {"bf16": (quantization.params_bytes(models["bf16"]), sharding.rank_bytes(full, cfg, TP_RANKS),
                             quantization.params_bytes(full))}
    q8 = quantization.quantize_params(full, llm_only=True, mode="int8")
    models["int8"] = sharding.shard_params(q8, cfg, mesh)
    out["bytes"]["int8"] = (quantization.params_bytes(models["int8"]), sharding.rank_bytes(q8, cfg, TP_RANKS),
                            quantization.params_bytes(q8))
    del q8
    torch.cuda.empty_cache()
    prefill, decode = steps.make_sharded_prefill(cfg, mesh), steps.make_sharded_decode(cfg, mesh)
    for arm, m in models.items():
        recs = []
        for i in range(len(REQUESTS)):
            ids, pix = _request(torch, proc, i)
            (toks, _), gen_counts = counted(lambda: generation.generate(m, ids, pix, MAX_NEW_TOKENS, tok.eos_token_id))
            cache = generation.make_cache(m, 1, ids.shape[1], TP_DECODE_TIMED)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (lg, cache), pre_counts = counted(lambda: prefill(m, ids, pix, cache, full_logits=False))
            prefill_ms = (time.perf_counter() - t0) * 1e3
            step = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
            t0 = time.perf_counter()
            for _ in range(TP_DECODE_TIMED):
                dl, cache = decode(m, step, cache)
                step = dl[:, -1].argmax(-1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            decode_ms = (time.perf_counter() - t0) * 1e3 / TP_DECODE_TIMED
            recs.append({"tokens": toks, "logits": lg[0, -1].float().cpu(), "generate_counts": gen_counts,
                         "prefill_counts": pre_counts, "prefill_ms": prefill_ms, "decode_ms": decode_ms})
        out["arms"][arm] = recs
    del models["int8"]
    tp = models["bf16"]
    torch.cuda.empty_cache()
    out["sp"] = _tp_sequence_parallel(torch, full, tp, cfg, mesh, proc, counted)
    torch.cuda.empty_cache()

    # (2, 1): data parallel, one row a rank.
    dp_mesh = make_mesh(TP_RANKS, 1, device="cuda")
    dp = sharding.shard_params(full, cfg, dp_mesh)
    ids, pix = (sharding.shard_batch(x.to(dev), dp_mesh) for x in dp_rows)
    cache = generation.make_cache(dp, ids.shape[0], ids.shape[1], 1)
    lg, _ = steps.make_sharded_prefill(cfg, dp_mesh)(dp, ids, pix, cache, full_logits=False)
    out["dp"] = {"data_rank": dp_mesh.data_rank, "logits": lg[:, -1].float().cpu()}
    del dp

    # One DP x TP LoRA micro-step at (1, 2) that only accumulates: the
    # optimizer state's mean is the step's gradient.
    lcfg = lora.LoraConfig(r=LORA_R, alpha=LORA_ALPHA, dropout=0.0)
    probe = _lora_probe(torch, cfg, lcfg, dev)
    ad = sharding.shard_lora(probe, cfg, mesh)
    train = steps.make_sharded_train_step(cfg, lcfg, lora.default_optimizer(lr=LORA_LR, accum_steps=2), mesh)
    state = train.optimizer.init(ad)
    rows = lora.batch_to(batch, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (loss, ad, state), train_counts = counted(lambda: train(tp, ad, state, rows))
    out["train"] = {"loss": float(loss), "acc": [g.float().cpu() for g in state["acc"]],
                    "counts": train_counts, "ms": (time.perf_counter() - t0) * 1e3}
    del probe, ad, state

    # A 2-stage pipeline of the full model's layers: the loss on the LoRA batch.
    pmesh = pipeline.make_pipe_mesh(TP_RANKS, device="cuda")
    with torch.no_grad():
        t0 = time.perf_counter()
        ploss, pipe_counts = counted(lambda: pipeline.pipelined_loss_fn(
            full, cfg, rows["input_ids"], rows["pixel_values"], rows["labels"], pmesh, TP_PIPE_MICRO))
    out["pipe"] = {"stage": pmesh.stage, "loss": float(ploss), "host_copies": pmesh.group.host_copies,
                   "counts": pipe_counts, "ms": (time.perf_counter() - t0) * 1e3}

    # The continuous engine over the TP model (phase 14's identity traffic).
    eng = ContinuousBatcher(tp, proc, n_slots=CONT_SLOTS, chunk=CONT_CHUNK, max_new_tokens=CONT_MAX_NEW,
                            prompt_budget=[n_img + e for e in CONT_EXTRA_BUCKETS], seed=SEED)
    t0 = time.perf_counter()
    reqs, eng_counts = _run_engine(torch, eng, traffic)
    eng.close()
    out["engine"] = {"tokens": [r.tokens for r in reqs], "counts": eng_counts,
                     "graphs": len(eng.graph_log), "ms": (time.perf_counter() - t0) * 1e3}
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    return out


def _odd_request(torch, proc):
    """Request 0's image and prompt with one more character: T = 277, which
    does not split over TP_RANKS ranks."""
    dev = torch.device("cuda")
    inputs = proc([REQUESTS[0][0] + "?"], [_request_image(0)])
    return (torch.from_numpy(inputs["input_ids"]).to(dev),
            torch.from_numpy(inputs["pixel_values"]).to(dev, torch.bfloat16))


def _tp_sequence_parallel(torch, full, tp, cfg, mesh, proc, counted):
    """A rank's sequence-parallel prefills of the odd-length prompt (T
    padded to a multiple of the ranks), in bf16 and in int8 with
    ``prefill_a8``: the last-position logits, launches, host ms and whether
    the cache past T stayed empty; and layer 0's down product under
    sequence parallelism (the a8 route) against the whole a8 product's rows
    of this rank."""
    from paligemma_tpu_torch import generation, quantization
    from paligemma_tpu_torch.models import gemma, paligemma
    from paligemma_tpu_torch.ops import kernels
    from paligemma_tpu_torch.parallel import comm, sharding, steps

    ids, pix = _odd_request(torch, proc)
    t = ids.shape[1]
    prefill = steps.make_sharded_prefill(cfg, mesh, sequence_parallel=True)
    whole_a8 = quantization.quantize_params(full, llm_only=True, mode="int8", prefill_a8=True)
    a8 = sharding.shard_params(whole_a8, cfg, mesh)
    res = {"t": t}
    for arm, m in (("bf16", tp), ("a8", a8)):
        cache = generation.make_cache(m, 1, t, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (lg, cache), counts = counted(lambda: prefill(m, ids, pix, cache, full_logits=False))
        ms = (time.perf_counter() - t0) * 1e3
        # The same rank's tensor-parallel prefill without sequence
        # parallelism: the same SigLIP and the same products.
        with torch.no_grad():
            tp_lg, _ = paligemma.prefill(m, ids, pix, generation.make_cache(m, 1, t, 1), full_logits=False)
        res[arm] = {"logits": lg[0, -1].float().cpu(), "tp_logits": tp_lg[0, -1].float().cpu(), "counts": counts,
                    "ms": ms, "empty_past_t": cache.host_length == t and not bool(cache.k[:, :, t:].any())}
    whole, rank = whole_a8.llm.layers[0].down, a8.llm.layers[0].down
    n, m = rank.weight.shape[1], mesh.model_rank
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    x = torch.randn((1, t, whole.weight.shape[1]), generator=gen, device="cuda").to(torch.bfloat16)
    got = gemma.row_parallel(x[..., m * n:(m + 1) * n], rank, kernels.KERNELS, a8.llm.layers[0].mlp_tp, seq=t)
    want = comm.seq_shard(kernels.KERNELS.a8(x, whole.weight, whole.scale), mesh.model_group)
    res["a8_rows"] = {"shape": tuple(got.shape), "bit_identical": torch.equal(got, want),
                      "max_abs_err": float((got.float() - want.float()).abs().max())}
    return res


def _gloo_cuda_table(torch, mesh):
    """What PyTorch's gloo backend does with CUDA tensors (its backend table
    lists only broadcast and all_reduce): each collective the sharded code
    could use, tried once on the model group. Every rank takes the same
    branch, so a collective that raises raises on every rank before any
    message. ``comm.py`` routes by the backend, never by these tries."""
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.full((4,), float(mesh.rank + 1), device=dev)
    tries = {
        "all_reduce": lambda: dist.all_reduce(x.clone(), group=mesh.model_group.pg),
        "broadcast": lambda: dist.broadcast(x.clone(), mesh.model_group.ranks[0], group=mesh.model_group.pg),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            x.new_empty(4 * TP_RANKS), x, group=mesh.model_group.pg),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            x.new_empty(4 // TP_RANKS), x, group=mesh.model_group.pg),
    }
    table = {}
    for name, run in tries.items():
        try:
            run()
            torch.cuda.synchronize()
            table[name] = "runs"
        except (RuntimeError, ValueError, NotImplementedError) as e:
            table[name] = f"raises {type(e).__name__}: {str(e).splitlines()[0][:100]}"
    return table


def _lora_probe(torch, cfg, lcfg, dev):
    """Phase 15's probe adapter: seeded A, B seeded non-zero (at B = 0 the
    gradient of A is zero)."""
    from paligemma_tpu_torch import lora

    probe = lora.init_lora(cfg, lcfg, torch.Generator(device=dev).manual_seed(SEED + 2), dev)
    bgen = torch.Generator(device=dev).manual_seed(SEED + 3)
    for mod in probe["layers"].values():
        mod["b"].normal_(0.0, 0.01, generator=bgen)
    return probe


def phase_parallel(torch, model, proc, tok, cfg, main_counts):
    """Phase 17 (the final norm redrawn as in phase 7): the sharded paths on
    TP_RANKS ranks over gloo, held to the unsharded model in this process;
    then a world-size-1 NCCL group's sharded decode as a CUDA graph."""
    with _tokens_that_change(torch, model):
        return _phase_parallel(torch, model, proc, tok, cfg, main_counts)


def _phase_parallel(torch, model, proc, tok, cfg, main_counts):
    from paligemma_tpu_torch import generation, lora
    from paligemma_tpu_torch.continuous import ContinuousBatcher
    from paligemma_tpu_torch.models import paligemma
    from paligemma_tpu_torch.parallel import comm, sharding
    from paligemma_tpu_torch.parallel.mesh import Mesh, spawn

    tag = "[parallel]"
    dev = torch.device("cuda")
    n_img = cfg.vision_config.num_image_tokens
    t0 = time.perf_counter()
    arms, refs = _tp_records(torch, model, proc, tok, cfg)
    batch = _lora_batch(torch, proc, cfg)
    traffic = _cont_traffic()
    (ids0, pix0), (_, pix1) = _request(torch, proc, 0), _request(torch, proc, 1)
    dp_rows = (torch.cat([ids0, ids0]).cpu(), torch.cat([pix0, pix1]).cpu())
    log(f"{tag} unsharded references in {time.perf_counter() - t0:.1f} s; spawning {TP_RANKS} ranks on the "
        f"one card over gloo (NCCL refuses two ranks on one device)")
    t0 = time.perf_counter()
    ranks = spawn(_tp_rank, TP_RANKS, "gloo", "cuda", cfg, batch, dp_rows, traffic, n_img, timeout_s=300)
    log(f"{tag} ranks done in {time.perf_counter() - t0:.1f} s (process start, model init on the card, every "
        f"path below)")
    record = {"ranks": TP_RANKS, "backend": ranks[0]["backend"], "gloo_cuda": ranks[0]["gloo_cuda"]}
    check(all(r["backend"] == "gloo" for r in ranks), f"{tag} the ranks' groups are not gloo")
    log(f"{tag} gloo with CUDA tensors (rank 0; comm.py routes gathers and scatters through all_reduce and "
        f"point-to-point through host copies whatever this says): {ranks[0]['gloo_cuda']}")

    # Bytes a rank holds: the rules' count.
    for arm in ("bf16", "int8"):
        for r in ranks:
            got, want, whole = r["bytes"][arm]
            log(f"{tag} rank {r['rank']} {arm} parameter bytes {got} (the rules' count {want}; the whole model "
                f"{whole}, {got / whole:.3f} of it)")
            check(got == want, f"{tag} rank {r['rank']} {arm}: {got} bytes, the rules give {want}")
    record["bytes"] = {arm: ranks[0]["bytes"][arm] for arm in ("bf16", "int8")}

    # Prefill logits and greedy tokens, each arm and request, each rank.
    n_l, n_v = cfg.text_config.num_hidden_layers, cfg.vision_config.num_hidden_layers
    record["arms"] = {}
    for arm, m in arms.items():
        cache_dtype = None
        for i, ref in enumerate(refs[arm]):
            for r in ranks:
                got = r["arms"][arm][i]
                err = float((got["logits"] - ref["logits"]).abs().max())
                bar = LOGIT_REL_TOL * float(ref["logits"].abs().max())
                div = _held_to_batch1(torch, m, proc, f"{tag} {arm} rank {r['rank']}", REQUESTS[i][0],
                                      _request_image(i), got["tokens"], ref["tokens"], cache_dtype)
                n_tok = len(got["tokens"])
                gc_, pc = got["generate_counts"], got["prefill_counts"]
                want_gen = {"flash_attention": n_v + n_l, "decode_attention": n_l * (n_tok - 1)}
                want_pre = {"flash_attention": n_v + n_l}
                if arm == "int8":
                    want_gen["q8_matmul"] = (4 * n_l + 1) * n_tok
                    want_pre["q8_matmul"] = 4 * n_l + 1
                log(f"{tag} {arm} rank {r['rank']} request {i}: prefill last logits max_abs_err {err:.3e} (bar "
                    f"{bar:.3e}) | {n_tok} tokens, first difference from the unsharded model "
                    f"{'none' if div is None else div} | launches generate {gc_} (expect {want_gen}) prefill "
                    f"{pc} | host ms: prefill {got['prefill_ms']:.1f}, decode {got['decode_ms']:.2f} a token "
                    f"(gloo on one card, not a TP speed)")
                check(err <= bar, f"{tag} {arm} rank {r['rank']} request {i}: sharded logits off the bar")
                check(gc_ == want_gen and pc == want_pre,
                      f"{tag} {arm} rank {r['rank']} request {i}: launches {gc_} / {pc}, expected "
                      f"{want_gen} / {want_pre}")
                for k, v in gc_.items():
                    main_counts[k] += v
        record["arms"][arm] = {
            "prefill_host_ms": [[r["arms"][arm][i]["prefill_ms"] for i in range(len(REQUESTS))] for r in ranks],
            "decode_host_ms_per_token": [[r["arms"][arm][i]["decode_ms"] for i in range(len(REQUESTS))]
                                         for r in ranks]}
    del arms
    gc.collect()
    torch.cuda.empty_cache()

    record["sequence_parallel"] = _held_sequence_parallel(torch, model, proc, ranks, n_v, n_l, main_counts)

    # (2, 1): each data rank's row against the unsharded batch's.
    ids2, pix2 = dp_rows[0].to(dev), dp_rows[1].to(dev)
    with torch.no_grad():
        whole, _ = paligemma.prefill(model, ids2, pix2, generation.make_cache(model, 2, ids2.shape[1], 1),
                                     full_logits=False)
    whole = whole[:, -1].float().cpu()
    for r in ranks:
        row = whole[r["dp"]["data_rank"]:r["dp"]["data_rank"] + 1]
        err = float((r["dp"]["logits"] - row).abs().max())
        bar = LOGIT_REL_TOL * float(row.abs().max())
        log(f"{tag} (2, 1) data rank {r['dp']['data_rank']}: its row's last logits against the unsharded batch's "
            f"max_abs_err {err:.3e} (bar {bar:.3e}), bit-identical {torch.equal(r['dp']['logits'], row)}, "
            f"argmax equal {int(r['dp']['logits'].argmax()) == int(row.argmax())}")
        check(err <= bar, f"{tag} (2, 1) data rank {r['dp']['data_rank']}: row off the unsharded batch's")

    # The LoRA micro-step's gradients against the unsharded step's.
    lcfg = lora.LoraConfig(r=LORA_R, alpha=LORA_ALPHA, dropout=0.0)
    probe = _lora_probe(torch, cfg, lcfg, dev)
    opt = lora.default_optimizer(lr=LORA_LR, accum_steps=2)
    state = opt.init(probe)
    rows = lora.batch_to(batch, dev)
    loss, probe, state = lora.train_step(model, probe, state, rows, None, lcfg, opt)
    full_acc = dict(zip(("k.a", "k.b", "q.a", "q.b", "v.a", "v.b"), state["acc"]))
    g = comm.Group(None, [0])
    for r in ranks:
        mesh = Mesh(1, TP_RANKS, r["rank"], dev, g, g)
        want = sharding.shard_lora({"layers": {n: {x: full_acc[f"{n}.{x}"] for x in "ab"} for n in "qkv"}},
                                   cfg, mesh)
        want = [want["layers"][n][x].float().cpu() for n in "kqv" for x in "ab"]
        cos, gap = _cos_gap(torch, torch.cat([x.flatten() for x in r["train"]["acc"]]),
                            torch.cat([x.flatten() for x in want]))
        counts = r["train"]["counts"]
        log(f"{tag} LoRA micro-step (1, 2) B=2 T=320 rank {r['rank']}: loss {r['train']['loss']:.6f} vs "
            f"unsharded {float(loss):.6f} | gradients cosine {cos:.7f} (bar {LORA_GRAD_COS}), norm gap {gap:.2e} "
            f"(bar {LORA_GRAD_GAP}) | launches {counts} | host {r['train']['ms']:.1f} ms")
        check(cos >= LORA_GRAD_COS and gap <= LORA_GRAD_GAP, f"{tag} rank {r['rank']}: sharded gradients are off")
        check(abs(r["train"]["loss"] - float(loss)) <= TP_PIPE_LOSS_RTOL * abs(float(loss)),
              f"{tag} rank {r['rank']}: sharded loss is off")
        check(counts.get("flash_attention") == n_v + n_l and set(counts) == {"flash_attention"},
              f"{tag} rank {r['rank']}: a micro-step launched {counts}")
        main_counts["flash_attention"] += counts["flash_attention"]
    record["train"] = {"loss": [r["train"]["loss"] for r in ranks], "unsharded_loss": float(loss),
                       "host_ms": [r["train"]["ms"] for r in ranks]}
    del probe, state, full_acc

    # The pipelined loss against the unsharded one.
    with torch.no_grad():
        ref_loss = float(paligemma.loss_fn(model, rows["input_ids"], rows["pixel_values"], rows["labels"]))
    for r in ranks:
        p = r["pipe"]
        log(f"{tag} pipeline stage {p['stage']} of {TP_RANKS} ({TP_PIPE_MICRO} microbatches of the LoRA batch): "
            f"loss {p['loss']:.6f} vs unsharded {ref_loss:.6f} | host copies of the gloo point-to-point "
            f"{p['host_copies']} | launches {p['counts']} | host {p['ms']:.1f} ms")
        check(abs(p["loss"] - ref_loss) <= TP_PIPE_LOSS_RTOL * abs(ref_loss), f"{tag} pipelined loss is off")
        main_counts["flash_attention"] += p["counts"].get("flash_attention", 0)
    record["pipe"] = {"loss": [r["pipe"]["loss"] for r in ranks], "unsharded_loss": ref_loss,
                      "host_copies": [r["pipe"]["host_copies"] for r in ranks]}

    # The TP engine against the unsharded engine (phase 10's near-tie rule
    # where they part).
    eng = ContinuousBatcher(model, proc, n_slots=CONT_SLOTS, chunk=CONT_CHUNK, max_new_tokens=CONT_MAX_NEW,
                            prompt_budget=[n_img + e for e in CONT_EXTRA_BUCKETS], seed=SEED)
    base, _ = _run_engine(torch, eng, traffic)
    eng.close()
    base = [q.tokens for q in base]
    same = 0
    for r in ranks:
        for (p, im, n), got, ref in zip(traffic, r["engine"]["tokens"], base):
            if got == ref:
                same += 1
                continue
            b1 = generation.generate(model, *_inputs_of(torch, model, proc, p, im), n, tok.eos_token_id)[0]
            _held_to_batch1(torch, model, proc, f"{tag} engine rank {r['rank']}", p, im, got, b1, None)
        log(f"{tag} engine rank {r['rank']} ({CONT_SLOTS} slots, chunk {CONT_CHUNK}, {len(traffic)} requests, "
            f"eager over gloo, {r['engine']['graphs']} graphs): launches {r['engine']['counts']} | host "
            f"{r['engine']['ms']:.0f} ms")
        check(r["engine"]["graphs"] == 0, f"{tag} the engine captured a graph over gloo")
        for k, v in r["engine"]["counts"].items():
            main_counts[k] += v
    log(f"{tag} engine: {same} of {len(traffic) * TP_RANKS} requests token-identical to the unsharded engine")
    record["engine_identical"] = same
    record["peak_mib"] = [r["peak_mib"] for r in ranks]
    log(f"{tag} peak device MiB a rank {record['peak_mib']}")
    record["nccl_graph"] = _nccl_graph(torch, model, proc, cfg)
    return record


def _held_sequence_parallel(torch, model, proc, ranks, n_v, n_l, main_counts):
    """The ranks' sequence-parallel prefills of the odd-length prompt: bit
    for bit the rank's TP prefill without sequence parallelism; the
    last-position logits within phase 5's bar of the unsharded model's
    (bf16) or with its argmax (the int8 ``prefill_a8`` copy); the cache
    written up to T only; flash launched once a layer; the a8 rows bit for
    bit."""
    from paligemma_tpu_torch import generation, quantization
    from paligemma_tpu_torch.models import paligemma

    tag = "[parallel sp]"
    ids, pix = _odd_request(torch, proc)
    t = ids.shape[1]
    refs = {"bf16": model, "a8": quantization.quantize_params(model, llm_only=True, mode="int8", prefill_a8=True)}
    record = {"t": t, "host_ms": {}}
    for arm, m in refs.items():
        with torch.no_grad():
            lg, _ = paligemma.prefill(m, ids, pix, generation.make_cache(m, 1, t, 1), full_logits=False)
        ref = lg[0, -1].float().cpu()
        bar = LOGIT_REL_TOL * float(ref.abs().max())
        record["host_ms"][arm] = [r["sp"][arm]["ms"] for r in ranks]
        for r in ranks:
            got = r["sp"][arm]
            err = float((got["logits"] - ref).abs().max())
            tp_err = float((got["tp_logits"] - ref).abs().max())
            sp_tp = float((got["logits"] - got["tp_logits"]).abs().max())
            counts = got["counts"]
            log(f"{tag} {arm} rank {r['rank']}: T = {t} over {TP_RANKS} ranks (padded to "
                f"{-(-t // TP_RANKS) * TP_RANKS}) | last logits max_abs_err {err:.3e} (bar {bar:.3e}) vs the "
                f"unsharded prefill, the rank's TP prefill without SP {tp_err:.3e} from it, SP vs that TP "
                f"{sp_tp:.3e} (bit for bit {torch.equal(got['logits'], got['tp_logits'])}) | argmax equal "
                f"{int(got['logits'].argmax()) == int(ref.argmax())} | cache empty "
                f"past T {got['empty_past_t']} | launches {counts} | host {got['ms']:.1f} ms (gloo on one card, "
                f"not a TP speed)")
            # Sequence parallelism moves no bit of the rank's TP prefill. The
            # TP a8 prefill itself sits 3.1% from the unsharded one (PERF.md,
            # ROADMAP Queue 3), past phase 5's bar: a8 is held to the
            # unsharded argmax there, bf16 to the bar.
            check(torch.equal(got["logits"], got["tp_logits"]),
                  f"{tag} {arm} rank {r['rank']}: sequence parallelism changed the TP prefill's logits")
            check(int(got["logits"].argmax()) == int(ref.argmax()) and (arm == "a8" or err <= bar),
                  f"{tag} {arm} rank {r['rank']}: logits off the unsharded prefill's")
            check(got["empty_past_t"], f"{tag} {arm} rank {r['rank']}: the cache was written past T")
            check(counts.get("flash_attention") == n_v + n_l, f"{tag} {arm} rank {r['rank']}: flash {counts}")
            if arm == "a8":
                check(counts.get("a8_matmul") == 4 * n_l, f"{tag} rank {r['rank']}: a8 products {counts}")
            main_counts["flash_attention"] += counts["flash_attention"]
    for r in ranks:
        rows = r["sp"]["a8_rows"]
        log(f"{tag} rank {r['rank']}: layer 0's down product under sequence parallelism (int32 sums "
            f"reduce-scattered along T), rows {rows['shape']}: bit for bit the whole a8 product's rows "
            f"{rows['bit_identical']} (max_abs_err {rows['max_abs_err']:.3e})")
        check(rows["bit_identical"], f"{tag} rank {r['rank']}: the a8 rows differ from the whole product's")
    del refs
    return record


def _nccl_graph(torch, model, proc, cfg):
    """A world-size-1 NCCL group in this process: the sharded decode of the
    1 x 1 model (its collectives inside) captured as a CUDA graph, whose
    replay is bit for bit the eager step from the same cache."""
    import torch.distributed as dist

    from paligemma_tpu_torch import generation
    from paligemma_tpu_torch.models import paligemma
    from paligemma_tpu_torch.parallel import comm, sharding, steps
    from paligemma_tpu_torch.parallel.mesh import free_port, make_mesh

    tag = "[parallel nccl]"
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1, device="cuda")
        one = sharding.shard_params(model, cfg, mesh)
        check(mesh.backend == "nccl" and comm.capturable(one), f"{tag} the group is not a capturable NCCL group")
        ids, pix = _request(torch, proc, 0)
        cache = generation.make_cache(one, 1, ids.shape[1], 4)
        lg, cache = steps.make_sharded_prefill(cfg, mesh)(one, ids, pix, cache, full_logits=False)
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        saved = {f: getattr(cache, f).clone() for f in ("k", "v", "length", "valid")}
        host = cache.host_length

        def restore():
            for f, t in saved.items():
                getattr(cache, f).copy_(t)
            cache.host_length = host

        with torch.no_grad():
            eager = paligemma.decode_step(one, tok, cache)[0].clone()
        restore()
        decode = steps.make_sharded_decode(cfg, mesh)
        first = decode(one, tok, cache)[0]  # captures, then replays
        restore()
        again = decode(one, tok, cache)[0]
        torch.cuda.synchronize()
        graphs = [k for k in cache.graphs if k[0] == "sharded-decode"]
        same = torch.equal(first, eager) and torch.equal(again, eager)
        log(f"{tag} world size 1, backend {mesh.backend}: the sharded decode captured as a CUDA graph "
            f"({len(graphs)} graph, its all-reduces and the logits' all-gather inside) | replay bit for bit the "
            f"eager step: {same} (twice)")
        check(len(graphs) == 1 and same, f"{tag} the captured sharded decode is not the eager step")
        return {"captured": len(graphs), "bit_identical": same}
    finally:
        dist.destroy_process_group()


# Phase 18: the surfaces. The harness's greedy tokens (its CLI default), the
# kernels its checks must launch, and the native preprocessor's image and
# bars (tests/test_native.py's: PIL runs the same cubic in 8-bit fixed
# point, one quantization step of slack a pixel).
HARNESS_TOKENS = 16
HARNESS_KERNELS = ("flash_attention", "decode_attention", "q8_matmul", "w4a8_gemv", "w4a8_geglu")
# Token checks held to the bf16 stream under phase 10's near-tie rule.
HARNESS_TOKEN_CHECKS = ("int8_identity", "w4a8_agreement", "lm_head_w4_agreement")
NATIVE_HW = (480, 640)
NATIVE_MAX_ERR, NATIVE_MEAN_ERR = 2.5 / 255.0 + 1e-6, 0.5 / 255.0


class _StubStreamlit:
    """Just enough of streamlit for app_torch.py's widget flow, modelled on
    tests/test_app.py's ``FakeStreamlit``: every widget returns its default,
    the upload is the given file, Analyze is pressed."""

    def __init__(self, upload):
        self.upload, self.calls, self.written, self.cache_hits = upload, [], [], 0

    def cache_resource(self, fn):
        cache = {}

        def wrapper(*a, **k):
            if "v" in cache:
                self.cache_hits += 1
            else:
                cache["v"] = fn(*a, **k)
            return cache["v"]

        return wrapper

    def title(self, t):
        self.calls.append(("title", t))

    def file_uploader(self, label, type=None):
        self.calls.append(("file_uploader", tuple(type or ())))
        return self.upload

    def image(self, im, caption=None):
        self.calls.append(("image", caption))

    def text_input(self, label, value=""):
        return value

    def number_input(self, label, value=0, step=1):
        return value

    def slider(self, label, lo, hi, value):
        return value

    def checkbox(self, label, value=False):
        return value

    def button(self, label):
        self.calls.append(("button", label))
        return True

    def spinner(self, msg):
        self.calls.append(("spinner", msg))
        return contextlib.nullcontext()

    def subheader(self, t):
        self.calls.append(("subheader", t))

    def write(self, r):
        self.written.append(r)


def _harness_module():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", "validate_checkpoint_torch.py")
    spec = importlib.util.spec_from_file_location("validate_checkpoint_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _harness(torch, model, proc, cfg, main_counts):
    """scripts/validate_checkpoint_torch.py's ``run_checks`` on the seeded
    bf16 model written as HF-layout shards (the port's writer), with the
    byte-tokenizer processor passed in; the launches of the run."""
    import shutil

    from paligemma_tpu_torch.ops import kernels
    from paligemma_tpu_torch.utils import checkpoint

    tag = "[surfaces harness]"
    vc = _harness_module()
    tmp = tempfile.mkdtemp(prefix="pg_harness_")
    try:
        t0 = time.perf_counter()
        written = checkpoint.save_hf_checkpoint(model, tmp)
        log(f"{tag} wrote {written / 1e9:.3f} GB in {time.perf_counter() - t0:.2f} s")
        rss0 = _host_peak_rss_gb()
        kernels.reset_launch_counts()  # the harness's run, read right after it
        t0 = time.perf_counter()
        report = vc.run_checks(tmp, HARNESS_TOKENS, hf_mode="on", device="cuda", processor=proc)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = {k: v for k, v in kernels.call_counts().items() if v}
        rss = _host_peak_rss_gb()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    checks = report["checks"]
    for name, c in checks.items():
        log(f"{tag} {name}: {c['status']} {json.dumps({k: v for k, v in c.items() if k not in ('status', 'trace')})}")
    for name in ("config", "tokenizer", "load", "lora_smoke"):
        check(checks[name]["status"] == "pass", f"{tag} {name}: {checks[name]}")
    check(checks["tokenizer"]["source"] == "given", f"{tag} the processor was not the one given")
    parity = checks["logit_parity"]
    try:
        import transformers

        log(f"{tag} transformers {transformers.__version__}: logit_parity runs (the fp32 CPU oracle)")
        check(parity["status"] == "pass", f"{tag} logit_parity: {parity}")
    except ImportError:
        check(parity["status"] == "skipped" and "transformers" in parity["reason"],
              f"{tag} logit_parity is not skipped for the absent transformers: {parity}")
    w = model.llm.final_norm.weight
    ids, pix = vc.harness_inputs(proc, cfg, w.device, w.dtype)
    partings = {}
    for name in HARNESS_TOKEN_CHECKS:
        c = checks[name]
        if c["status"] == "pass":
            continue
        check(c["status"] == "fail" and "first_difference" in c, f"{tag} {name}: {c}")
        div = c["first_difference"]
        gap, bar = _top_two_gap(torch, model, ids, pix, c["base_tokens"][:div], None)
        partings[name] = {"first_difference": div, "top_two_gap": gap, "bar": bar}
        log(f"{tag} {name}: parts from the bf16 stream at token {div} of {len(c['base_tokens'])}, where bf16's "
            f"top two logits are {gap:.4e} apart (bar {bar:.4e}, phase 10's rule)")
        check(gap <= bar, f"{tag} {name}: the stream parts off a near tie")
    check("agreement" in checks["a8_prefill_agreement"], f"{tag} a8_prefill_agreement: {checks['a8_prefill_agreement']}")
    log(f"{tag} run_checks {run_s:.1f} s | the process's peak host RSS {rss0:.2f} GB before it, {rss:.2f} GB "
        f"after | launches {counts} | {report['summary']}")
    for k in HARNESS_KERNELS:
        check(counts.get(k, 0) >= 1, f"{tag} {k} was never launched")
        main_counts[k] += counts[k]
    return {"seconds": run_s, "summary": report["summary"], "statuses": {k: c["status"] for k, c in checks.items()},
            "load_s": checks["load"]["seconds"], "host_rss_delta_mb": checks["load"]["host_rss_delta_mb"],
            "peak_rss_gb": (rss0, rss),
            "streaming": checks["load"]["streaming"], "partings": partings, "launches": counts}


def _app(torch, main_counts):
    """app_torch.py --demo under ``_StubStreamlit`` on the card: the written
    answer equal to a direct ``inference_torch.test_inference`` call with the
    widgets' values; a second ``get_model()`` a cache hit; flash and decode
    attention launched by the Analyze click."""
    import io
    import runpy

    from paligemma_tpu_torch.ops import kernels

    tag = "[surfaces app]"
    repo = os.path.dirname(os.path.abspath(__file__))
    buf = io.BytesIO()
    _request_image(1).save(buf, "PNG")
    buf.seek(0)
    buf.name = "upload.png"
    stub = _StubStreamlit(buf)
    saved = sys.modules.get("streamlit"), sys.argv
    sys.modules["streamlit"], sys.argv = stub, ["app_torch.py", "--demo"]
    try:
        kernels.reset_launch_counts()  # the click, read right after it
        t0 = time.perf_counter()
        glb = runpy.run_path(os.path.join(repo, "app_torch.py"), run_name="app_torch_on_the_card")
        torch.cuda.synchronize()
        click_s = time.perf_counter() - t0
        counts = {k: v for k, v in kernels.call_counts().items() if v}
        model, processor = glb["get_model"]()
    finally:
        if saved[0] is None:
            sys.modules.pop("streamlit", None)
        else:
            sys.modules["streamlit"] = saved[0]
        sys.argv = saved[1]
    import inference_torch

    with tempfile.TemporaryDirectory(prefix="pg_app_") as tmp:
        path = os.path.join(tmp, "upload.png")
        _request_image(1).convert("RGB").save(path)
        want = inference_torch.test_inference(model, processor, "Describe the image", path, 100, 0.8, 0.9, False)
    dev = model.llm.final_norm.weight
    log(f"{tag} app_torch.py --demo: {[c[0] for c in stub.calls]} | title {stub.calls[0][1]!r} | model "
        f"{dev.device} {dev.dtype} | Analyze in {click_s:.1f} s (model load included) | answer {stub.written!r} | "
        f"equal to test_inference: {stub.written == [want]} | cache hits {stub.cache_hits} | launches {counts}")
    check(dev.device.type == "cuda" and dev.dtype == torch.bfloat16, f"{tag} the demo model is not bf16 on the card")
    check(stub.written == [want], f"{tag} the app's answer differs from test_inference's")
    check(stub.cache_hits == 1, f"{tag} get_model was not cached")
    check("TPU" not in stub.calls[0][1] and all("TPU" not in c[1] for c in stub.calls if c[0] == "spinner"),
          f"{tag} the app names a TPU")
    for k in ("flash_attention", "decode_attention"):
        check(counts.get(k, 0) >= 1, f"{tag} {k} was never launched")
        main_counts[k] += counts[k]
    return {"seconds": click_s, "launches": counts, "answer_equal": True}


def _native(torch, cfg):
    """paligemma_tpu_torch.native built from the checkout's source on this
    machine, on a 480 x 640 image, within tests/test_native.py's bars of the
    port's PIL processor path at the model's image size."""
    import numpy as np
    from PIL import Image

    from paligemma_tpu_torch import native
    from paligemma_tpu_torch.processing import process_images

    tag = "[surfaces native]"
    t0 = time.perf_counter()
    lib = native.build()
    native.load()
    build_s = time.perf_counter() - t0
    size = cfg.vision_config.image_size
    raw = np.random.RandomState(SEED).randint(0, 256, (*NATIVE_HW, 3), np.uint8)
    t0 = time.perf_counter()
    got = native.preprocess_images_native(raw, size)[0]
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    host = torch.from_numpy(process_images([Image.fromarray(raw)], size=(size, size))[0])
    pil_ms = (time.perf_counter() - t0) * 1e3
    diff = (got - host).abs()
    err, mean = float(diff.max()), float(diff.mean())
    log(f"{tag} g++ build {build_s:.2f} s -> {os.path.relpath(lib, os.path.dirname(os.path.abspath(__file__)))} | "
        f"{NATIVE_HW[0]}x{NATIVE_HW[1]} -> {size}x{size}: {tuple(got.shape)} {got.dtype} {got.device} | max_abs_err "
        f"{err:.4e} (bar {NATIVE_MAX_ERR:.4e}), mean {mean:.4e} (bar {NATIVE_MEAN_ERR:.4e}) against the PIL path | "
        f"host ms: native {native_ms:.2f}, PIL {pil_ms:.2f}")
    check(got.shape == host.shape == (3, size, size) and got.dtype == torch.float32, f"{tag} wrong output")
    check(err <= NATIVE_MAX_ERR and mean < NATIVE_MEAN_ERR, f"{tag} off the PIL path's bars")
    return {"build_s": build_s, "max_abs_err": err, "mean_abs_err": mean, "native_ms": native_ms, "pil_ms": pil_ms}


def phase_surfaces(torch, model, proc, cfg, main_counts):
    """Phase 18: the validation harness on the 3B checkpoint, the Streamlit
    app under a stub streamlit, the native preprocessor."""
    t0 = time.perf_counter()
    record = {"harness": _harness(torch, model, proc, cfg, main_counts), "app": _app(torch, main_counts),
              "native": _native(torch, cfg)}
    record["seconds"] = time.perf_counter() - t0
    log(f"[surfaces] phase 18 took {record['seconds']:.1f} s")
    return record


KERNEL_TABLE = [
    # name, source, the TPU kernel it replaces
    ("flash_attention", "paligemma_tpu_torch/csrc/flash_attention.cu", "paligemma_tpu/ops/pallas_attention.py:100"),
    ("decode_attention", "paligemma_tpu_torch/csrc/decode_attention.cu", "paligemma_tpu/ops/pallas_attention.py:242"),
    ("q8_matmul", "paligemma_tpu_torch/csrc/quant_matmul.cu", "paligemma_tpu/ops/pallas_quant.py:185"),
    ("q4_matmul", "paligemma_tpu_torch/csrc/quant_matmul.cu", "paligemma_tpu/ops/pallas_quant.py:120"),
    ("w4a8_gemv", "paligemma_tpu_torch/csrc/w4a8.cu", "paligemma_tpu/ops/pallas_quant.py:497"),
    # mlp_w4a8 at batch 1 is two launches: w4a8_geglu (gate_up with the
    # GeGLU epilogue), then w4a8_gemv with the quantizing prologue (down).
    ("w4a8_geglu", "paligemma_tpu_torch/csrc/w4a8.cu", "paligemma_tpu/ops/pallas_quant.py:678"),
]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU", file=sys.stderr)
        return 2
    # Hold both paths to full fp32 products and fp32 reductions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    name, count = phase_device(torch)
    phase_build()
    max_err = {**phase_kernels(torch), **phase_quant_kernels(torch)}

    cfg, tok, proc, model = build_model(torch)
    torch.cuda.reset_peak_memory_stats()
    main_counts = collections.Counter()
    records = phase_main_path(torch, model, proc, tok, cfg, main_counts)
    log(f"[memory] max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    phase_plain_path(torch, model, records[0], tok)
    log(f"[checkpoint] {json.dumps(phase_checkpoint(torch, model, records[0], tok))}")
    arms = [phase_quant_arm(torch, model, proc, tok, cfg, arm, records[0], main_counts) for arm in QUANT_ARMS]
    log(f"[arms] {json.dumps(arms)}")
    phase_prefill_graph(torch, model, cfg, records[0], main_counts)
    phase_graph(torch, model, cfg, records[0], main_counts)
    phase_speculative(torch, model, cfg, records[0], main_counts)
    phase_batched(torch, model, proc, tok, cfg, records, main_counts)
    log(f"[ablation] {json.dumps(phase_ablation(torch, model, proc, main_counts))}")
    phase_cli(torch)
    log(f"[continuous] {json.dumps(phase_continuous(torch, model, proc, tok, cfg, main_counts), default=str)}")
    with tempfile.TemporaryDirectory(prefix="pg_lora_") as adapter_dir:
        trained, lcfg, train_rec = phase_lora_train(torch, model, proc, cfg, main_counts, adapter_dir)
        log(f"[lora train] {json.dumps(train_rec)}")
        serve_rec = phase_lora_serving(torch, model, proc, cfg, trained, lcfg, adapter_dir, main_counts)
        log(f"[lora serving] {json.dumps(serve_rec, default=str)}")
    log(f"[parallel] {json.dumps(phase_parallel(torch, model, proc, tok, cfg, main_counts), default=str)}")
    log(f"[surfaces] {json.dumps(phase_surfaces(torch, model, proc, cfg, main_counts), default=str)}")
    times = phase_timing(torch, records[0]["ids"].shape[1])

    kernels = []
    for kname, source, replaces in KERNEL_TABLE:
        check(main_counts[kname] > 0, f"{kname} was never launched on the main path")
        kernels.append({"name": kname, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": main_counts[kname], "max_abs_err": max_err[kname], **times[kname]})
    kernels[0]["training"] = train_rec["flash"]  # flash at the LoRA training shape, with its backward
    kernels[-1]["mlp_w4a8"]["max_abs_err"] = max_err["mlp_w4a8"]
    kernels[-1]["quant_rows"]["max_abs_err"] = max_err["quant_rows"]  # in quantization steps
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

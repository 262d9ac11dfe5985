#!/usr/bin/env python3
"""The w4a8 kernels of ``csrc/w4a8.cu`` timed in turns on one CUDA card:
against an older tree, across the quantizing prologue's row threshold, and
against variant builds of the source.

    python3 scripts/w4a8_variants.py [--parent DIR] [--out PATH.json]

- Turns: the w4a8 calls of ``TIMED`` in this tree and in ``--parent``
  (another checkout of the repo, for example ``git archive COMMIT`` unpacked
  into a directory that ``.gitignore`` lists), each side in a process of its
  own, in turns parent, this, this, parent. The calls go through each tree's
  own ``ops.quant`` wrappers (``w4a8_gemv``, ``q4a8_matmul``, ``mlp_w4a8``,
  ``quant_rows``), so the route a tree takes for a shape is timed with it.
- Threshold: the 3B MLP at 1 to 8 rows and the 4-bit lm_head and a gate_up
  shape at 1, 2, 4 and 8 rows, with the quantizing prologue
  (``ops.quant.W4A8_PROLOGUE_MAX_ROWS`` raised to 8) and with ``quant_rows``
  first (0); and ``torch._int_mm`` with x padded to 17 rows.
- Variants: copies of ``csrc/w4a8.cu`` with the edits of ``VARIANTS``, each
  built by ``nvcc`` into a library of its own (registers and spill bytes
  printed), held bit for bit to the plain versions, then timed in turns (in
  order, then in reverse) through the port's wrappers pointed at it. The
  ``one_launch`` variant adds the TPU kernel's shape, the whole MLP as one
  persistent cooperative launch with a grid-wide barrier between the two
  GEMVs, timed through its own entry point.

Every time is device ms per call from CUDA-graph replays
(``chip_smoke._time_ms``), with weights cycled past the 50 MB L2. Needs a
CUDA device and ``nvcc``; exits 1 if a build fails or disagrees.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
D, INTER = 2048, 16384

# (label, kind, m, o, d, fp32 out): kind "gemv" is w4a8_gemv on int8 rows,
# "q4a8" q4a8_matmul on bf16 rows, "mlp" the 3B MLP (o, d unused), "rows"
# quant_rows of an (m, o) row (GeGLU when d).
TIMED = [
    ("w4a8_gemv gate_up 1x32768x2048", "gemv", 1, 32768, 2048, False),
    ("w4a8_gemv down 1x2048x16384", "gemv", 1, 2048, 16384, False),
    ("w4a8_gemv lm_head 1x257152x2048 fp32", "gemv", 1, 257152, 2048, True),
    ("w4a8_gemv 8x32768x2048", "gemv", 8, 32768, 2048, False),
    ("w4a8_gemv 16x32768x2048", "gemv", 16, 32768, 2048, False),
    ("w4a8_gemv 32x32768x2048", "gemv", 32, 32768, 2048, False),
    ("w4a8_gemv 64x32768x2048", "gemv", 64, 32768, 2048, False),
    ("w4a8_gemv 64x2048x16384", "gemv", 64, 2048, 16384, False),
    ("q4a8_matmul lm_head 1x257152x2048 fp32", "q4a8", 1, 257152, 2048, True),
    ("q4a8_matmul flat qkv 1x2560x2048", "q4a8", 1, 2560, 2048, False),
    ("q4a8_matmul flat gate_up 1x32768x2048", "q4a8", 1, 32768, 2048, False),
    ("mlp_w4a8 M=1", "mlp", 1, 0, 0, False),
    ("mlp_w4a8 M=5", "mlp", 5, 0, 0, False),
    ("mlp_w4a8 M=64", "mlp", 64, 0, 0, False),
    ("quant_rows 1x2048", "rows", 1, 2048, 0, False),
    ("quant_rows GeGLU 1x32768", "rows", 1, 32768, 1, False),
]

# The variants' edits of csrc/w4a8.cu: (old text, new text), each of which
# must occur in the source.
_BODY_VB = [
    ("__device__ __forceinline__ void w4a8_body(const void* __restrict__ x,",
     "__device__ __forceinline__ void w4a8_body(int vb, const void* __restrict__ x,"),
    ("  const int row0 = ((blockIdx.x * kWarps + warp) >> ks_log2) * 16;",
     "  const int row0 = ((vb * kWarps + warp) >> ks_log2) * 16;"),
    ("  w4a8_body<NT, QUANT, false, F32OUT>(x,", "  w4a8_body<NT, QUANT, false, F32OUT>(blockIdx.x, x,"),
    ("  w4a8_body<1, true, true, false>(x,", "  w4a8_body<1, true, true, false>(blockIdx.x, x,"),
]
_ONE_LAUNCH_KERNEL = r'''
// All blocks of the grid (co-resident: a cooperative launch) meet here;
// bar[0] counts the arrivals, bar[1] is the generation.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen_p = bar + 1;
    const unsigned gen = *gen_p;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen_p == gen) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 2)
    w4a8_mlp_kernel(const bf16* __restrict__ x, long long x_stride, const uint8_t* __restrict__ gu,
                    const float* __restrict__ gs, const uint8_t* __restrict__ dn, const float* __restrict__ ds,
                    bf16* __restrict__ h, bf16* __restrict__ out, int m, int inter, int d, int lg_a, int nb_a,
                    int lg_b, int nb_b, unsigned* bar) {
  for (int vb = blockIdx.x; vb < nb_a; vb += gridDim.x) {
    w4a8_body<1, true, true, false>(vb, x, x_stride, nullptr, gu, gs, h, m, 2 * inter, d, lg_a);
    __syncthreads();
  }
  __threadfence();
  grid_barrier(bar);
  for (int vb = blockIdx.x; vb < nb_b; vb += gridDim.x) {
    w4a8_body<1, true, false, false>(vb, h, inter, nullptr, dn, ds, out, m, d, inter, lg_b);
    __syncthreads();
  }
}
'''
_ONE_LAUNCH_ENTRY = r'''
extern "C" int pg_w4a8_mlp(const void* x, long long x_stride, const void* gu, const void* gs, const void* dn,
                           const void* ds, void* h, void* out, int m, int inter, int d, void* bar, void* stream) {
  if (m < 1 || m > kQuantMaxRows || inter < 32 || inter % 32 || d < 32 || d % 32 || x_stride % 8)
    return cudaErrorInvalidValue;
  const size_t smem_a = gemv_smem<2, true>(m, d), smem_b = gemv_smem<1, true>(m, inter);
  const size_t smem = smem_a > smem_b ? smem_a : smem_b;
  static const cudaError_t attr = allow_smem(w4a8_mlp_kernel);
  if (attr != cudaSuccess) return attr;
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, w4a8_mlp_kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles_a = (inter + 15) / 16, lg_a = split_log2(tiles_a, d);
  const int nb_a = (tiles_a + (kWarps >> lg_a) - 1) / (kWarps >> lg_a);
  const int tiles_b = (d + 15) / 16, lg_b = split_log2(tiles_b, inter);
  const int nb_b = (tiles_b + (kWarps >> lg_b) - 1) / (kWarps >> lg_b);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(min(max(nb_a, nb_b), per_sm * sm_count()));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute coop;
  coop.id = cudaLaunchAttributeCooperative;
  coop.val.cooperative = 1;
  cfg.attrs = &coop;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, w4a8_mlp_kernel, static_cast<const bf16*>(x), x_stride,
                           static_cast<const uint8_t*>(gu), static_cast<const float*>(gs),
                           static_cast<const uint8_t*>(dn), static_cast<const float*>(ds), static_cast<bf16*>(h),
                           static_cast<bf16*>(out), m, inter, d, lg_a, nb_a, lg_b, nb_b, static_cast<unsigned*>(bar));
  return err != cudaSuccess ? err : cudaGetLastError();
}
'''
VARIANTS = {
    "base": [],
    # Three ring stages behind the prologue too.
    "ring3": [("return PAIR == 1 && QUANT ? 4 : 3;", "return 3;")],
    # The split of K: two warps a tile at least, for every call; split on
    # while the grid gives fewer than 16 warps an SM (gate_up and the GeGLU
    # GEMV split); two warps a tile where the tiles make many waves of
    # blocks (the 257152-row lm_head: 2009 blocks of 8 tiles).
    "split_min2": [("  int lg = 0;\n  while ((1 << lg) < kWarps", "  int lg = steps >= 4 ? 1 : 0;\n  while ((1 << lg) < kWarps")],
    "split_x2": [("(long long)tiles << lg < (long long)sm_count() * kWarps",
                  "(long long)tiles << lg < 2LL * sm_count() * kWarps")],
    "split_lm2": [("  int lg = 0;\n  while ((1 << lg) < kWarps",
                   "  int lg = (long long)tiles >= 8LL * sm_count() * kWarps && steps >= 2 ? 1 : 0;\n"
                   "  while ((1 << lg) < kWarps")],
    # One block an SM (up to 255 registers) at four and eight n8 tiles.
    "lb1": [("__launch_bounds__(kThreads, NT == 1 ? 3 : 2)", "__launch_bounds__(kThreads, NT == 1 ? 3 : NT >= 4 ? 1 : 2)")],
    # The quantizing GEMV as a programmatic dependent of the kernel before it
    # (it streams its first weight stages, then waits before it reads x);
    # the GeGLU kernel lets it be scheduled at once.
    "dependent": [
        ("    quantize_prologue(static_cast<const bf16*>(x),",
         "    asm volatile(\"griddepcontrol.wait;\\n\" ::: \"memory\");\n    quantize_prologue(static_cast<const bf16*>(x),"),
        ("  w4a8_body<1, true, true, false>(x,",
         "  asm volatile(\"griddepcontrol.launch_dependents;\\n\" ::);\n  w4a8_body<1, true, true, false>(x,"),
        ("  w4a8_gemv_kernel<NT, QUANT, F32OUT><<<grid, kThreads, gemv_smem<1, QUANT>(m, d), st>>>(\n"
         "      x, x_stride, xs, w, scale, out, m, o, d, lg);\n  return cudaGetLastError();",
         "  cudaLaunchConfig_t cfg = {};\n  cfg.gridDim = grid;\n  cfg.blockDim = dim3(kThreads);\n"
         "  cfg.dynamicSmemBytes = gemv_smem<1, QUANT>(m, d);\n  cfg.stream = st;\n  cudaLaunchAttribute pdl;\n"
         "  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;\n"
         "  pdl.val.programmaticStreamSerializationAllowed = 1;\n  cfg.attrs = &pdl;\n  cfg.numAttrs = QUANT ? 1 : 0;\n"
         "  const cudaError_t err = cudaLaunchKernelEx(&cfg, w4a8_gemv_kernel<NT, QUANT, F32OUT>, x, x_stride, xs,"
         " w, scale, out, m, o, d, lg);\n  return err != cudaSuccess ? err : cudaGetLastError();"),
    ],
    # The whole MLP in one persistent launch (h, written by the same
    # launch, read past L1).
    "one_launch": [
        *_BODY_VB,
        ("      raw[u] = c < d ? __ldg(reinterpret_cast<const uint4*>(xr + c)) : make_uint4(0u, 0u, 0u, 0u);",
         "      raw[u] = c < d ? __ldcg(reinterpret_cast<const uint4*>(xr + c)) : make_uint4(0u, 0u, 0u, 0u);"),
        ("}  // namespace\n", None),
    ],
}
_W4A8_NAMES = ("pg_quant_rows", "pg_w4a8_gemv", "pg_q4a8_gemv", "pg_w4a8_geglu")


def variant_source(name: str) -> str:
    src = (ROOT / "paligemma_tpu_torch/csrc/w4a8.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"{name}: the source no longer holds {old[:60]!r}")
        if new is None:  # the one-launch kernel goes in at the end of the namespace
            src = src.replace(old, _ONE_LAUNCH_KERNEL + "\n" + old, 1)
        else:
            src = src.replace(old, new, 1)
    if name == "one_launch":
        src += _ONE_LAUNCH_ENTRY
    return src


class _Lib:
    """A variant's library as the wrappers use it (it has no error strings)."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def pg_error_string(self, code):
        return f"CUDA error {code}".encode()


def build_variants(out_dir: Path):
    """{name: (library, {kernel: [registers, spill bytes]})}, built side by side."""
    from paligemma_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    procs = {}
    for name in VARIANTS:
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "common.cuh").write_text((ROOT / "paligemma_tpu_torch/csrc/common.cuh").read_text())
        (d / "w4a8.cu").write_text(variant_source(name))
        cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas=-v", "-shared", "-o", str(d / "lib.so"), str(d / "w4a8.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(out_dir / name / "lib.so"))
        for fn in _W4A8_NAMES:
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        if name == "one_launch":
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.pg_w4a8_mlp.argtypes = [p, ll] + [p] * 6 + [i] * 3 + [p, p]
            lib.pg_w4a8_mlp.restype = i
        regs, current = {}, None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                current = m.group(1)
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and current:
                regs.setdefault(current, [0, 0])[1] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and current:
                regs.setdefault(current, [0, 0])[0] = int(m.group(1))
        out[name] = (_Lib(lib), regs)
    return out


def _setup(torch):
    """(chip_smoke, device, generator, weights): ``weights(o, d)`` makes
    enough copies of a packed int4 (o, d) weight and its scales to stream
    past the L2."""
    import chip_smoke
    from paligemma_tpu_torch.ops import quant

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def weights(o, d, sc=4.3):
        return chip_smoke._copies(lambda: (
            quant.pack_int4(torch.randint(-7, 8, (o, d), generator=gen, device=dev, dtype=torch.int32).to(torch.int8)),
            torch.rand(o, generator=gen, device=dev) / (sc * math.sqrt(d))), o * d // 2)

    return chip_smoke, dev, gen, weights


def time_calls(torch, calls):
    import chip_smoke

    return {label: chip_smoke._time_ms(torch, fn) for label, fn in calls}


def tree_calls(torch):
    """(label, fn) of TIMED through the ops.quant of the tree on sys.path."""
    from paligemma_tpu_torch.ops import quant

    chip_smoke, dev, gen, weights = _setup(torch)
    cache, calls = {}, []

    def w(o, d, sc=4.3):
        if (o, d) not in cache:
            cache[(o, d)] = weights(o, d, sc)
        return cache[(o, d)]

    for label, kind, m, o, d, f32 in TIMED:
        dt = torch.float32 if f32 else torch.bfloat16
        if kind == "gemv":
            xq, xs = quant.quant_rows(chip_smoke._rand(torch, gen, (m, d), dev))
            ws = w(o, d)
            calls.append((label, lambda i, xq=xq, xs=xs, ws=ws, dt=dt: quant.w4a8_gemv(xq, xs, *ws[i % len(ws)], dt)))
        elif kind == "q4a8":
            x, ws = chip_smoke._rand(torch, gen, (m, d), dev), w(o, d)
            calls.append((label, lambda i, x=x, ws=ws, dt=dt: quant.q4a8_matmul(x, *ws[i % len(ws)], dt)))
        elif kind == "mlp":
            x, gus, dns = chip_smoke._rand(torch, gen, (1, m, D), dev), w(2 * INTER, D), w(D, INTER, 3.0)
            n = min(len(gus), len(dns))
            calls.append((label, lambda i, x=x, gus=gus, dns=dns, n=n: quant.mlp_w4a8(x, *gus[i % n], *dns[i % n])))
        else:
            x = chip_smoke._rand(torch, gen, (m, o), dev)
            calls.append((label, lambda i, x=x, g=bool(d): quant.quant_rows(x, g)))
    return calls


def threshold(torch):
    """The prologue (rows <= 8) against quant_rows first (rows <= 0)."""
    from paligemma_tpu_torch.ops import quant

    chip_smoke, dev, gen, weights = _setup(torch)
    gus, dns, lm, gu = weights(2 * INTER, D), weights(D, INTER, 3.0), weights(257152, D), weights(2 * INTER, D)
    n = min(len(gus), len(dns))
    keep, res = quant.W4A8_PROLOGUE_MAX_ROWS, {}
    try:
        for rows in (8, 0):
            quant.W4A8_PROLOGUE_MAX_ROWS = rows
            route = "prologue" if rows else "quant_rows first"
            for m in range(1, 9):
                x = chip_smoke._rand(torch, gen, (1, m, D), dev)
                res[f"mlp_w4a8 M={m} {route}"] = chip_smoke._time_ms(
                    torch, lambda i: quant.mlp_w4a8(x, *gus[i % n], *dns[i % n]))
            for m in (1, 2, 4, 8):
                x = chip_smoke._rand(torch, gen, (m, D), dev)
                res[f"q4a8_matmul lm_head {m}x257152x2048 fp32 {route}"] = chip_smoke._time_ms(
                    torch, lambda i: quant.q4a8_matmul(x, *lm[i % len(lm)], torch.float32))
                res[f"q4a8_matmul {m}x32768x2048 {route}"] = chip_smoke._time_ms(
                    torch, lambda i: quant.q4a8_matmul(x, *gu[i % len(gu)]))
    finally:
        quant.W4A8_PROLOGUE_MAX_ROWS = keep
    for o, d in ((32768, 2048), (2048, 16384), (257152, 2048), (2560, 2048)):
        xq = torch.randint(-127, 128, (17, d), generator=gen, device=dev, dtype=torch.int32).to(torch.int8)
        ws = chip_smoke._copies(lambda: torch.randint(-7, 8, (o, d), generator=gen, device=dev,
                                                     dtype=torch.int32).to(torch.int8), o * d)
        res[f"_int_mm 17x{o}x{d}"] = chip_smoke._time_ms(torch, lambda i: torch._int_mm(xq, ws[i % len(ws)].t()))
    return res


def variants(torch, out_dir: Path):
    """Each variant checked bit for bit, then its calls timed in turns."""
    from paligemma_tpu_torch.ops import _build, quant

    built = build_variants(out_dir)
    chip_smoke, dev, gen, weights = _setup(torch)
    bar = torch.zeros(2, dtype=torch.int32, device=dev)

    def one_launch(lib, x, gu, gs, dn, ds):
        x2 = x.reshape(-1, x.shape[-1])
        m, d = x2.shape
        h = torch.empty(m, gu.shape[0] // 2, dtype=torch.bfloat16, device=dev)
        out = torch.empty(m, d, dtype=torch.bfloat16, device=dev)
        rc = lib.pg_w4a8_mlp(x2.data_ptr(), x2.stride(0), gu.data_ptr(), gs.data_ptr(), dn.data_ptr(),
                             ds.data_ptr(), h.data_ptr(), out.data_ptr(), m, gu.shape[0] // 2, d,
                             bar.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"pg_w4a8_mlp: CUDA error {rc}")
        return out.reshape(x.shape)

    gus, dns, lm = weights(2 * INTER, D), weights(D, INTER, 3.0), weights(257152, D)
    n = min(len(gus), len(dns))
    x1, x2 = chip_smoke._rand(torch, gen, (1, 1, D), dev), chip_smoke._rand(torch, gen, (1, 2, D), dev)
    xq64, xs64 = quant.quant_rows_plain(chip_smoke._rand(torch, gen, (64, D), dev))
    xq1, xs1 = quant.quant_rows_plain(chip_smoke._rand(torch, gen, (1, D), dev))
    h1 = chip_smoke._rand(torch, gen, (1, INTER), dev)

    def calls(name, lib):
        mlp = ((lambda i, x: one_launch(lib, x, *gus[i % n], *dns[i % n])) if name == "one_launch"
               else (lambda i, x: quant.mlp_w4a8(x, *gus[i % n], *dns[i % n])))
        return [
            ("w4a8_gemv gate_up 1x32768x2048", lambda i: quant.w4a8_gemv(xq1, xs1, *gus[i % n], torch.bfloat16)),
            ("w4a8_gemv lm_head 1x257152x2048 fp32",
             lambda i: quant.w4a8_gemv(xq1, xs1, *lm[i % len(lm)], torch.float32)),
            ("w4a8_gemv 64x32768x2048", lambda i: quant.w4a8_gemv(xq64, xs64, *gus[i % n], torch.bfloat16)),
            ("prologue lm_head 1x257152x2048 fp32",
             lambda i: quant.q4a8_matmul(x1[0], *lm[i % len(lm)], torch.float32)),
            ("prologue down 1x2048x16384", lambda i: quant.q4a8_matmul(h1, *dns[i % n])),
            ("w4a8_geglu M=1", lambda i: quant.w4a8_geglu(x1, *gus[i % n])),
            ("mlp_w4a8 M=1", lambda i: mlp(i, x1)),
            ("mlp_w4a8 M=2", lambda i: mlp(i, x2)),
        ]

    keep = _build.load_library
    res, regs = {}, {name: r for name, (_, r) in built.items()}
    try:
        for name, (lib, _) in built.items():  # bit for bit first
            _build.load_library = lambda lib=lib: lib
            for x in (x1, x2):
                want = quant.mlp_w4a8_plain(x, *gus[0], *dns[0])
                fn = (lambda x: one_launch(lib, x, *gus[0], *dns[0])) if name == "one_launch" else (
                    lambda x: quant.mlp_w4a8(x, *gus[0], *dns[0]))
                got, _, again = fn(x), fn(x * 3), fn(x)
                torch.cuda.synchronize()
                if not (torch.equal(got, want) and torch.equal(again, got)):
                    raise RuntimeError(f"{name}: the MLP of {x.shape[1]} rows is not its plain version bit for bit")
            got = quant.w4a8_gemv(xq64, xs64, *gus[0], torch.bfloat16)
            if not torch.equal(got, quant.w4a8_gemv_plain(xq64, xs64, *gus[0], torch.bfloat16)):
                raise RuntimeError(f"{name}: the 64-row GEMV is not its plain version bit for bit")
            print(f"[variant] {name}: bit-identical | registers/spill {regs[name]}", flush=True)
        for name in list(built) + list(reversed(built)):
            lib = built[name][0]
            _build.load_library = lambda lib=lib: lib
            for label, fn in calls(name, lib):
                res.setdefault(label, {}).setdefault(name, []).append(chip_smoke._time_ms(torch, fn))
    finally:
        _build.load_library = keep
    return res, regs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None, help="another checkout of the repo to time in turns with this one")
    ap.add_argument("--out", default=None, help="write the whole result as JSON here")
    ap.add_argument("--tree-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.tree_only:  # one side of the turns, in the tree of the working directory
        sys.path.insert(0, os.getcwd())
        import torch

        print(json.dumps(time_calls(torch, tree_calls(torch))), flush=True)
        return 0
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("w4a8_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    result = {"device": smi, "turns": {}, "threshold": {}, "variants": {}}

    sides = [("parent", Path(args.parent).resolve()), ("this", ROOT)] if args.parent else [("this", ROOT)]
    for label, tree in sides + list(reversed(sides)):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--tree-only"], cwd=tree,
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return 1
        for k, v in json.loads(proc.stdout.strip().splitlines()[-1]).items():
            result["turns"].setdefault(k, {}).setdefault(label, []).append(v)
    for k, by in result["turns"].items():
        print(f"[turns] {k:45s} " + " | ".join(f"{s} {sum(v) / len(v):.5f} ({', '.join(f'{t:.5f}' for t in v)})"
                                               for s, v in by.items()), flush=True)

    result["threshold"] = threshold(torch)
    for k, v in result["threshold"].items():
        print(f"[threshold] {k:55s} {v:.5f}", flush=True)

    try:
        res, regs = variants(torch, ROOT / "paligemma_tpu_torch/_build/w4a8_variants")
    except RuntimeError as e:
        print(f"w4a8_variants: {e}", file=sys.stderr)
        return 1
    result["variants"] = {"ms": res, "registers": regs}
    for k, by in res.items():
        print(f"[variants] {k:40s} " + " | ".join(f"{s} {sum(v) / len(v):.5f} ({', '.join(f'{t:.5f}' for t in v)})"
                                                  for s, v in by.items()), flush=True)
    print(smi, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

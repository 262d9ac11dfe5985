// w4a8: per-row int8 activations x packed int4 weights on the int8 tensor
// cores, the per-row int8 quantization that feeds them (optionally behind
// the GeGLU gate), and the w4a8 GeGLU MLP in two launches.
//
// Replaces:
//   - paligemma_tpu/ops/pallas_quant.py::q4a8_matmul_tiled (and
//     q4a8_matmul, the same math over another TPU layout) -> w4a8_gemv_kernel,
//     which takes int8 rows of x with their scales, or bf16 rows that it
//     quantizes in its prologue (up to kQuantMaxRows rows);
//   - pallas_quant.py::mlp_w4a8 / mlp_w4a8_stacked -> two launches:
//     w4a8_geglu_kernel (x quantized in the prologue, the fused [gate | up]
//     GEMV, and the GeGLU in the epilogue, h = (M, I) bf16), then
//     w4a8_gemv_kernel on h with the quantizing prologue (down);
//   - pallas_quant.py::quantize_rows_s8 and the gelu-gate-requant middle of
//     mlp_w4a8 (_gate_and_quantize) -> quant_rows_kernel, which runs where
//     the rows are too many for the prologue (ops/quant.py routes by
//     W4A8_PROLOGUE_MAX_ROWS).
//
// Layout (the port's own): packed (O, D/2) uint8, one output row's values
// in each row; within each group of 8 columns 8i..8i+7, byte 4i + k holds
// column 8i + k in its low nibble and 8i + 4 + k in its high nibble (two's
// complement, values in [-7, 7]). A 32-bit word w of packed bytes then
// gives, exactly in int8 lanes,
//   (w << 4) & 0xF0F0F0F0 = 16 * (columns 8i .. 8i+3)
//   w & 0xF0F0F0F0        = 16 * (columns 8i+4 .. 8i+7)
// which are the s8 operands of the product as they stand: two logic
// operations per 8 weights, no conversion. The x16 is taken off the exact
// int32 sum at the end (|sum| <= 16 * 127 * 8 * D < 2^31 for D <= 16384).
// The epilogue is (float(acc) * xs) * s, which is bit for bit the
// reference's lo/hi-nibble route (its scalings are powers of two).
//
// quant_rows and the prologue, per row: fp32 absmax, xs = max(amax, 1e-8) /
// 127, xq = rint(x / xs) (IEEE division, round half to even). The GeGLU is
// h = bf16(bf16(gelu_tanh_fp32(gate)) * up) in the reference's order
// (pallas_quant.py:622-641).
//
// What bounds them on the H100:
//   - the GEMV at decode (M = 1): the packed weight bytes, half a byte per
//     weight at 3.35 TB/s: 10.0 us for gate_up (32768 x 2048), 5.0 us for
//     down (2048 x 16384), 78.6 us for the 4-bit lm_head (257152 x 2048).
//     At 64 rows the products (2 * 64 * O * D int8 operations) come close
//     behind the bytes.
//   - quant_rows: bytes too, but a decode row is far below a launch's
//     fixed cost; that is why the GEMVs quantize their own rows.
//
// The design of the GEMV (one tiling for every M; more than 64 rows are
// taken 64 at a time over blockIdx.y):
//   - mma.sync m16n8k32 s8 x s8 -> s32, computed as W x^T: a warp owns 16
//     output rows (the A operand; 32 with the GeGLU epilogue: gate rows
//     i..i+15 and up rows I+i..I+i+15, two A tiles against the same B) and
//     the rows of x are 1, 2, 4 or 8 n8 tiles (B), so each weight byte is
//     read once for all the rows of x.
//   - k order: one permutation of the columns, the same for W and x, so
//     that a masked word is an A register as it stands. Quarter q of a
//     ring step holds 128 columns (64 packed bytes a row); thread (g =
//     lane / 4, t4 = lane % 4) reads chunk t4 (16 bytes, 4 words) of rows
//     g and g + 8, and product e (0..3) of the quarter takes word e of the
//     chunk: its low-nibble mask is k 4 t4 .. + 3, its high-nibble mask k
//     16 + 4 t4 .. + 3. The B registers of that product are then x's 8
//     bytes at the word's 8 columns, so a thread reads x's 32 bytes at
//     columns 2 (64 q + 16 t4) of the step in two 16-byte loads.
//   - Weights: each warp streams its rows through its own cp.async ring
//     (128 bytes a row a stage; 3 stages, 4 behind the prologue), no block
//     barrier; 16-byte chunk c of row r lands at chunk c ^ 4 (r & 1), so the
//     fragment loads are free of bank conflicts.
//   - x: int8 rows read through L1 (w4a8_gemv), or, with the prologue, bf16
//     rows that every block quantizes into shared memory (each row padded
//     by 16 bytes, so the B loads are free of bank conflicts) while the
//     first weight stages are in flight: the scale from the row's absmax
//     (a block reduction), then the int8 row. Every block of the down GEMV
//     reads all of h (32 KB a row at I = 16384) from L2 and computes its
//     absmax itself; no global word, counter or barrier ties the two
//     launches of the MLP together beyond stream order.
//   - Two launches, not one: the TPU kernel's single launch, built as one
//     persistent cooperative grid with a grid-wide barrier between the two
//     GEMVs (the down GEMV's blocks taken by half of the grid), took 0.0286
//     ms for the 3B MLP at one row against 0.0250 for the two launches, and
//     the down GEMV launched as a programmatic dependent of the first
//     (griddepcontrol) 0.0252; measured in turns in one call on the H100
//     (scripts/w4a8_variants.py builds both; PERF.md section 6).
//   - Split K: while the 16-row tiles give fewer than 8 warps an SM (down,
//     and gate_up with the GeGLU pair), K is split over 2, 4 or 8 warps of
//     a block (the rule of quant_matmul.cu's GEMV), and the s32 partial
//     tiles are added in shared memory (in each warp's own ring).
//   - Rows of the prologue: at most kQuantMaxRows (8; down's 8 x 16400
//     staged bytes are the largest). ops/quant.py takes the prologue up to
//     W4A8_PROLOGUE_MAX_ROWS = 2 rows and quant_rows above: every block of
//     the down GEMV quantizes all of h (64 IEEE divisions a thread a row),
//     so the 3B MLP is faster with the prologue at 1 and 2 rows and slower
//     from 3 on (measured; PERF.md section 6).
//
// What bounds them now (measured on the H100, PERF.md section 6): at M = 1 the
// int8-row GEMV reaches 75% of its byte floor on gate_up, 58% on down and
// 87-89% on the lm_head; what is left is a launch's fixed cost and the first
// round trip of each warp's ring (down streams 16 KB a warp), and the
// lm_head's last, partial wave of blocks. The prologue adds ~2.5 us to the
// down GEMV (each of its 128 blocks quantizes all 16384 values of h). At 64
// rows the GEMV is 1.1x torch._int_mm on the unpacked int8 weight: x is
// re-read from L1 by every 16-row warp tile, and 8 n8 tiles spill.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// quant_rows
// ---------------------------------------------------------------------------

// tanh-GELU in fp32, written as PyTorch's CUDA kernel writes it, so that the
// plain version on the card rounds the same way.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float x_cube = x * x * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  return 0.5f * x * (1.f + tanhf(inner));
}

// Eight values of the row at column c, as the quantizer sees them.
template <bool GEGLU>
__device__ __forceinline__ void row_values(const bf16* __restrict__ xr, int c, int d, float* h) {
  float a[8];
  bf16x8_to_float(*reinterpret_cast<const uint4*>(xr + c), a);
  if (!GEGLU) {
#pragma unroll
    for (int e = 0; e < 8; ++e) h[e] = a[e];
    return;
  }
  float up[8];
  bf16x8_to_float(*reinterpret_cast<const uint4*>(xr + d + c), up);
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = round_bf16(round_bf16(gelu_tanh(a[e])) * up[e]);
}

// Eight values quantized with the row scale s, as int8 bytes in order.
__device__ __forceinline__ uint2 quantize8(const float* h, float s) {
  uint32_t q[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const uint32_t b = (uint32_t)(__float2int_rn(__fdiv_rn(h[e], s)) & 0xff);
    q[e >> 2] |= b << (8 * (e & 3));
  }
  return make_uint2(q[0], q[1]);
}

template <bool GEGLU>
__global__ void __launch_bounds__(1024)
    quant_rows_kernel(const bf16* __restrict__ x, long long x_stride, int8_t* __restrict__ xq,
                      float* __restrict__ xs, int d) {
  __shared__ float red[32];
  const int row = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* xr = x + (long long)row * x_stride;

  float amax = 0.f;
  for (int c = threadIdx.x * 8; c < d; c += blockDim.x * 8) {
    float h[8];
    row_values<GEGLU>(xr, c, d, h);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(h[e]));
  }
  amax = warp_max(amax);
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  if (warp == 0) {
    float v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    v = warp_max(v);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float s = __fdiv_rn(fmaxf(red[0], 1e-8f), 127.f);
  if (threadIdx.x == 0) xs[row] = s;

  int8_t* qr = xq + (long long)row * d;
  for (int c = threadIdx.x * 8; c < d; c += blockDim.x * 8) {
    float h[8];
    row_values<GEGLU>(xr, c, d, h);
    *reinterpret_cast<uint2*>(qr + c) = quantize8(h, s);
  }
}

// ---------------------------------------------------------------------------
// The w4a8 GEMV on mma.sync m16n8k32 s8
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStep = 128;          // packed bytes of each weight row a ring stage holds
constexpr int kMaxRows = 64;        // rows of x a block takes (8 n8 tiles)
constexpr int kQuantMaxRows = 8;    // rows of x the quantizing prologue takes (one n8 tile)
constexpr int kXPad = 16;           // bytes after each staged int8 row of x
constexpr int kSmemOptin = 232448;  // the H100's dynamic shared memory a block can opt in to
constexpr uint32_t kHiNibbles = 0xF0F0F0F0u;
// Shared memory between the rings and the staged rows of x (prologue): the
// row scales and each warp's row maxima.
constexpr int kQuantHead = 4 * kQuantMaxRows * (1 + kWarps);

// A warp's ring: 3 stages of its 16 weight rows (4 behind the prologue, so
// that more of the stream is in flight while the block quantizes x), or 3
// of the GeGLU pair's 32.
template <int PAIR, bool QUANT>
__host__ __device__ constexpr int ring_stages() {
  return PAIR == 1 && QUANT ? 4 : 3;
}
template <int PAIR, bool QUANT>
__host__ __device__ constexpr int warp_ring_bytes() {
  return ring_stages<PAIR, QUANT>() * PAIR * 16 * kStep;
}

template <int PAIR, bool QUANT>
size_t gemv_smem(int m, int d) {
  const size_t ring = (size_t)kWarps * warp_ring_bytes<PAIR, QUANT>();
  return QUANT ? ring + kQuantHead + (size_t)m * (d + kXPad) : ring;
}

// The block's m <= kQuantMaxRows bf16 rows of x quantized as quant_rows
// quantizes them: the scales into xs_s, the int8 rows (ld bytes apart) into
// x_s. A thread takes 8 columns in each kThreads * 8 of a row, and reads
// kPrologueLoads of its 16-byte pieces at a time, so that a row of up to
// kThreads * 8 * kPrologueLoads columns (16384) costs one round trip to L2
// a pass. The rows are read twice (absmax, then quantize; the second read
// hits L1 or L2).
constexpr int kPrologueLoads = 8;

__device__ __forceinline__ void quantize_prologue(const bf16* __restrict__ x, long long x_stride, int m,
                                                  int d, float* xs_s, float* red, int8_t* x_s, int ld) {
  constexpr int kSpan = kThreads * 8 * kPrologueLoads;  // columns of one batch of loads
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // The 16-byte pieces of row xr in this thread's batch at c0, zeros past d.
  auto load = [&](const bf16* xr, int c0, uint4* raw) {
#pragma unroll
    for (int u = 0; u < kPrologueLoads; ++u) {
      const int c = c0 + u * kThreads * 8;
      raw[u] = c < d ? __ldg(reinterpret_cast<const uint4*>(xr + c)) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
#pragma unroll 1
  for (int r = 0; r < m; ++r) {
    const bf16* xr = x + (long long)r * x_stride;
    float amax = 0.f;
    for (int c0 = threadIdx.x * 8; c0 < d; c0 += kSpan) {
      uint4 raw[kPrologueLoads];
      load(xr, c0, raw);
#pragma unroll
      for (int u = 0; u < kPrologueLoads; ++u) {
        float v[8];
        bf16x8_to_float(raw[u], v);
#pragma unroll
        for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
      }
    }
    amax = warp_max(amax);
    if (lane == 0) red[warp * kQuantMaxRows + r] = amax;
  }
  __syncthreads();
  if (threadIdx.x < m) {
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) amax = fmaxf(amax, red[i * kQuantMaxRows + threadIdx.x]);
    xs_s[threadIdx.x] = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
  }
  __syncthreads();
#pragma unroll 1
  for (int r = 0; r < m; ++r) {
    const bf16* xr = x + (long long)r * x_stride;
    const float s = xs_s[r];
    for (int c0 = threadIdx.x * 8; c0 < d; c0 += kSpan) {
      uint4 raw[kPrologueLoads];
      load(xr, c0, raw);
#pragma unroll
      for (int u = 0; u < kPrologueLoads; ++u) {
        const int c = c0 + u * kThreads * 8;
        float v[8];
        bf16x8_to_float(raw[u], v);
        if (c < d) *reinterpret_cast<uint2*>(x_s + r * ld + c) = quantize8(v, s);
      }
    }
  }
  __syncthreads();
}

// y = (x W^T) * scale for the rows of x this block takes (see the file's
// header). QUANT: x is (m, d) bf16 with row stride x_stride, quantized in
// the prologue (m <= kQuantMaxRows, NT = 1); else x is (m, d) int8,
// contiguous, with row scales xs. GEGLU: W is the fused [gate | up] (o =
// 2I rows), each warp takes gate and up rows of one 16-row tile, and out is
// h (m, I) bf16; else out is (m, o), fp32 if F32OUT else bf16.
template <int NT, bool QUANT, bool GEGLU, bool F32OUT>
__device__ __forceinline__ void w4a8_body(const void* __restrict__ x, long long x_stride,
                                          const float* __restrict__ xs, const uint8_t* __restrict__ w,
                                          const float* __restrict__ scale, void* __restrict__ out,
                                          int m, int o, int d, int ks_log2) {
  constexpr int PAIR = GEGLU ? 2 : 1;
  constexpr int kStages = ring_stages<PAIR, QUANT>();
  constexpr int kRows = 16 * PAIR;                // weight rows in a warp's ring
  constexpr int kChunks = kStep / 16;             // 16-byte chunks of a row a step
  constexpr int kCopies = kRows * kChunks / 32;   // copies of a lane a step
  static_assert(!QUANT || NT == 1, "the prologue takes one n8 tile");
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int ksplit = 1 << ks_log2, ks = warp & (ksplit - 1);
  const int o_t = GEGLU ? o / 2 : o;  // rows of each A tile's weight (I for gate and for up)
  const int row0 = ((blockIdx.x * kWarps + warp) >> ks_log2) * 16;
  const int m0 = blockIdx.y * kMaxRows;
  const int rows = min(m - m0, 8 * NT);
  const int row_bytes = d / 2;
  const int steps = (row_bytes + kStep - 1) / kStep;
  const int per = (steps + ksplit - 1) >> ks_log2;
  const int s0 = ks * per, n = max(0, min(steps, s0 + per) - s0);  // this warp's steps
  const unsigned smem0 = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned ring = smem0 + warp * warp_ring_bytes<PAIR, QUANT>();

  // The copies: copy j of lane l moves chunk (32 j + l) % kChunks of ring
  // row (32 j + l) / kChunks (rows 16.. are the up rows of the pair). Rows
  // past the weight are read as its last row (their outputs are not stored).
  const uint8_t* src[kCopies];
  unsigned dst[kCopies];
  int col_byte[kCopies];
#pragma unroll
  for (int j = 0; j < kCopies; ++j) {
    const int r = (32 * j + lane) / kChunks, c = (32 * j + lane) % kChunks;
    const int wr = min(row0 + (r & 15), o_t - 1) + (r >= 16 ? o_t : 0);
    src[j] = w + (long long)wr * row_bytes + 16 * c;
    dst[j] = r * kStep + 16 * (c ^ 4 * (r & 1));
    col_byte[j] = 16 * c;
  }
  auto issue = [&](int i) {  // step i of this warp into its stage
    if (i < n) {
      const int at = (s0 + i) * kStep;
      const unsigned stage = ring + (i % kStages) * kRows * kStep;
#pragma unroll
      for (int j = 0; j < kCopies; ++j) {
        const bool ok = at + col_byte[j] < row_bytes;  // chunks past D are zero-filled
        cp_async16(stage + dst[j], ok ? src[j] + at : src[j], ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  // The scales of this thread's output rows, read ahead of the epilogue.
  float sc[PAIR][2];
#pragma unroll
  for (int p = 0; p < PAIR; ++p)
#pragma unroll
    for (int h = 0; h < 2; ++h) sc[p][h] = scale[min(row0 + g + 8 * h, o_t - 1) + p * o_t];

  // The prologue (while the first weight stages are in flight).
  unsigned char* head = smem + kWarps * warp_ring_bytes<PAIR, QUANT>();
  float* xs_s = reinterpret_cast<float*>(head);
  const int ld = d + kXPad;
  const unsigned x_s = smem0 + kWarps * warp_ring_bytes<PAIR, QUANT>() + kQuantHead;
  if (QUANT) {
    quantize_prologue(static_cast<const bf16*>(x), x_stride, rows, d, xs_s, xs_s + kQuantMaxRows,
                      reinterpret_cast<int8_t*>(head + kQuantHead), ld);
  }

  // x's 32 bytes at this thread's columns of quarter q of step i, row
  // 8 nt + g (zeros past M, D or this warp's steps), as the B registers of
  // the quarter's four products.
  auto load_x = [&](int i, int q, int nt, uint32_t* xv) {
    const int r = 8 * nt + g;
    const int col = 2 * ((s0 + i) * kStep + 64 * q + 16 * t4);
    uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
    if (i < n && r < rows && col < d) {
      if (QUANT) {
        const unsigned at = x_s + r * ld + col;
        a = ld_shared128(at);
        b = ld_shared128(at + 16);
      } else {
        const uint4* at =
            reinterpret_cast<const uint4*>(static_cast<const int8_t*>(x) + (long long)(m0 + r) * d + col);
        a = __ldg(at);
        b = __ldg(at + 1);
      }
    }
    xv[0] = a.x, xv[1] = a.y, xv[2] = a.z, xv[3] = a.w;
    xv[4] = b.x, xv[5] = b.y, xv[6] = b.z, xv[7] = b.w;
  };

  // With one n8 tile, the products alternate between two accumulators
  // (added at the end), which halves their dependent chain.
  constexpr int kAcc = NT == 1 ? 2 : 1;
  int acc[PAIR][NT][4], acc2[PAIR][4];
#pragma unroll
  for (int p = 0; p < PAIR; ++p) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc2[p][e] = 0;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][nt][e] = 0;
  }
  for (int i = 0; i < n; ++i) {
    // With one n8 tile, x of the whole step is read before the wait.
    uint32_t x_step[2][8];
    if (NT == 1) {
      load_x(i, 0, 0, x_step[0]);
      load_x(i, 1, 0, x_step[1]);
    }
    cp_async_wait<kStages - 2>();  // step i has landed (this lane's copies)
    __syncwarp();                  // ... every lane's; and the stage read last step is free
    issue(i + kStages - 1);
    const unsigned stage = ring + (i % kStages) * kRows * kStep;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = (4 * q + t4) ^ 4 * (g & 1);
      // lo / hi: 16 x the low / high nibbles of this thread's 4 words of
      // rows g (h = 0) and g + 8 (h = 1) of each A tile.
      uint32_t lo[PAIR][2][4], hi[PAIR][2][4];
#pragma unroll
      for (int p = 0; p < PAIR; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint4 v = ld_shared128(stage + (16 * p + 8 * h + g) * kStep + 16 * c);
          const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            lo[p][h][e] = (wd[e] << 4) & kHiNibbles;
            hi[p][h][e] = wd[e] & kHiNibbles;
          }
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t xv[8];
        if (NT == 1) {
#pragma unroll
          for (int e = 0; e < 8; ++e) xv[e] = x_step[q][e];
        } else {
          load_x(i, q, nt, xv);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int p = 0; p < PAIR; ++p) {
            const uint32_t a[4] = {lo[p][0][e], lo[p][1][e], hi[p][0][e], hi[p][1][e]};
            mma_s8(kAcc == 2 && (e & 1) ? acc2[p] : acc[p][nt], a, xv[2 * e], xv[2 * e + 1]);
          }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the loop (the tail groups are empty)
  if (kAcc == 2) {
#pragma unroll
    for (int p = 0; p < PAIR; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][0][e] += acc2[p][e];
  }

  if (ksplit > 1) {
    // Each warp's partial tiles go into its own ring, [PAIR][NT][4][lane].
    __syncwarp();  // every lane of this warp is done with its ring
    int* red = reinterpret_cast<int*>(smem + warp * warp_ring_bytes<PAIR, QUANT>());
#pragma unroll
    for (int p = 0; p < PAIR; ++p)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[((p * NT + nt) * 4 + e) * 32 + lane] = acc[p][nt][e];
    __syncthreads();
    if (ks != 0) return;
#pragma unroll
    for (int s = 1; s < kWarps; ++s) {
      if (s >= ksplit) break;
      const int* part = reinterpret_cast<const int*>(smem + (warp + s) * warp_ring_bytes<PAIR, QUANT>());
#pragma unroll
      for (int p = 0; p < PAIR; ++p)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[p][nt][e] += part[((p * NT + nt) * 4 + e) * 32 + lane];
    }
  }
  // acc[p][nt]: output rows row0 + g (+ 8), rows of x 8 nt + 2 t4 (+ 1).
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= o_t) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * nt + 2 * t4 + e;
        if (r >= rows) continue;
        const float xsr = QUANT ? xs_s[r] : xs[m0 + r];
        // Exact: every term of the sums is a multiple of 16.
        const float v = ((float)(acc[0][nt][2 * h + e] >> 4) * xsr) * sc[0][h];
        if (GEGLU) {
          const float up = round_bf16(((float)(acc[PAIR - 1][nt][2 * h + e] >> 4) * xsr) * sc[PAIR - 1][h]);
          const float hv = round_bf16(gelu_tanh(round_bf16(v))) * up;
          static_cast<bf16*>(out)[(long long)r * o_t + row] = __float2bfloat16_rn(hv);
        } else {
          store_out<F32OUT>(out, (long long)(m0 + r) * o + row, v);
        }
      }
  }
}

template <int NT, bool QUANT, bool F32OUT>
__global__ void __launch_bounds__(kThreads, NT == 1 ? 3 : 2)
    w4a8_gemv_kernel(const void* __restrict__ x, long long x_stride, const float* __restrict__ xs,
                     const uint8_t* __restrict__ w, const float* __restrict__ scale, void* __restrict__ out,
                     int m, int o, int d, int ks_log2) {
  w4a8_body<NT, QUANT, false, F32OUT>(x, x_stride, xs, w, scale, out, m, o, d, ks_log2);
}

__global__ void __launch_bounds__(kThreads, 2)
    w4a8_geglu_kernel(const bf16* __restrict__ x, long long x_stride, const uint8_t* __restrict__ w,
                      const float* __restrict__ scale, bf16* __restrict__ h, int m, int o, int d,
                      int ks_log2) {
  w4a8_body<1, true, true, false>(x, x_stride, nullptr, w, scale, h, m, o, d, ks_log2);
}

// Warps of a block on one output tile, as a power of two: the smallest (at
// most kWarps) that gives every SM kWarps warps, while each warp keeps at
// least one step of K.
int split_log2(int tiles, int d) {
  const int steps = (d / 2 + kStep - 1) / kStep;
  int lg = 0;
  while ((1 << lg) < kWarps && (long long)tiles << lg < (long long)sm_count() * kWarps && steps >= 2 << lg) ++lg;
  return lg;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptin);
}

template <int NT, bool QUANT, bool F32OUT>
cudaError_t launch_gemv(const void* x, long long x_stride, const float* xs, const uint8_t* w,
                        const float* scale, void* out, int m, int o, int d, cudaStream_t st) {
  static const cudaError_t attr = allow_smem(w4a8_gemv_kernel<NT, QUANT, F32OUT>);
  if (attr != cudaSuccess) return attr;
  const int tiles = (o + 15) / 16;
  const int lg = split_log2(tiles, d);
  const int per_block = kWarps >> lg;
  const dim3 grid((tiles + per_block - 1) / per_block, (m + kMaxRows - 1) / kMaxRows);
  w4a8_gemv_kernel<NT, QUANT, F32OUT><<<grid, kThreads, gemv_smem<1, QUANT>(m, d), st>>>(
      x, x_stride, xs, w, scale, out, m, o, d, lg);
  return cudaGetLastError();
}

template <bool F32OUT>
cudaError_t dispatch(const int8_t* xq, const float* xs, const uint8_t* w, const float* scale, void* out,
                     int m, int o, int d, cudaStream_t st) {
  const int rows = min(m, kMaxRows);
  if (rows <= 8) return launch_gemv<1, false, F32OUT>(xq, d, xs, w, scale, out, m, o, d, st);
  if (rows <= 16) return launch_gemv<2, false, F32OUT>(xq, d, xs, w, scale, out, m, o, d, st);
  if (rows <= 32) return launch_gemv<4, false, F32OUT>(xq, d, xs, w, scale, out, m, o, d, st);
  return launch_gemv<8, false, F32OUT>(xq, d, xs, w, scale, out, m, o, d, st);
}

}  // namespace

// x (M, width) bf16 with row stride x_stride (elements; rows 16-byte
// aligned), width = d, or 2d with geglu (a fused [gate | up] row); xq (M, d)
// int8 and xs (M,) fp32, contiguous. d is a multiple of 8.
extern "C" int pg_quant_rows(const void* x, void* xq, void* xs, int m, int d, long long x_stride,
                             int geglu, void* stream) {
  if (m < 1 || d < 8 || d % 8) return cudaErrorInvalidValue;
  const int threads = d >= 8192 ? 1024 : 256;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  int8_t* qp = static_cast<int8_t*>(xq);
  float* sp = static_cast<float*>(xs);
  if (geglu) {
    quant_rows_kernel<true><<<m, threads, 0, st>>>(xp, x_stride, qp, sp, d);
  } else {
    quant_rows_kernel<false><<<m, threads, 0, st>>>(xp, x_stride, qp, sp, d);
  }
  return cudaGetLastError();
}

// xq (M, D) int8 and xs (M,) fp32, w (O, D/2) packed uint8 and scale (O,)
// fp32, all contiguous; out (M, O) contiguous, fp32 if out_f32 else bf16.
// M >= 1 (taken 64 rows at a time over blockIdx.y); D is a multiple of 32.
extern "C" int pg_w4a8_gemv(const void* xq, const void* xs, const void* w, const void* scale,
                            void* out, int m, int o, int d, int out_f32, void* stream) {
  if (m < 1 || (m + kMaxRows - 1) / kMaxRows > 65535 || o < 1 || d < 32 || d % 32) return cudaErrorInvalidValue;
  const int8_t* xp = static_cast<const int8_t*>(xq);
  const float* xsp = static_cast<const float*>(xs);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_f32 ? dispatch<true>(xp, xsp, wp, sp, out, m, o, d, st)
                 : dispatch<false>(xp, xsp, wp, sp, out, m, o, d, st);
}

// x (M, D) bf16 with row stride x_stride (elements; a multiple of 8, rows
// 16-byte aligned), quantized per row in the prologue; w (O, D/2) packed
// and scale (O,) fp32 contiguous; out (M, O) contiguous, fp32 if out_f32
// else bf16. 1 <= M <= 8; D is a multiple of 32.
extern "C" int pg_q4a8_gemv(const void* x, long long x_stride, const void* w, const void* scale, void* out,
                            int m, int o, int d, int out_f32, void* stream) {
  if (m < 1 || m > kQuantMaxRows || o < 1 || d < 32 || d % 32 || x_stride % 8 ||
      gemv_smem<1, true>(m, d) > (size_t)kSmemOptin)
    return cudaErrorInvalidValue;
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch_gemv<1, true, true>(x, x_stride, nullptr, wp, sp, out, m, o, d, st)
                 : launch_gemv<1, true, false>(x, x_stride, nullptr, wp, sp, out, m, o, d, st);
}

// h = geglu(quantize_rows(x) @ w^T * scale): x (M, D) bf16 with row stride
// x_stride (as pg_q4a8_gemv), w the fused [gate | up] (2I, D/2) packed and
// scale (2I,) fp32 contiguous, h (M, I) bf16 contiguous. 1 <= M <= 8; D is
// a multiple of 32.
extern "C" int pg_w4a8_geglu(const void* x, long long x_stride, const void* w, const void* scale, void* h,
                             int m, int inter, int d, void* stream) {
  if (m < 1 || m > kQuantMaxRows || inter < 1 || d < 32 || d % 32 || x_stride % 8 ||
      gemv_smem<2, true>(m, d) > (size_t)kSmemOptin)
    return cudaErrorInvalidValue;
  static const cudaError_t attr = allow_smem(w4a8_geglu_kernel);
  if (attr != cudaSuccess) return attr;
  const int tiles = (inter + 15) / 16;
  const int lg = split_log2(tiles, d);
  const int per_block = kWarps >> lg;
  w4a8_geglu_kernel<<<(tiles + per_block - 1) / per_block, kThreads, gemv_smem<2, true>(m, d),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), x_stride, static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
      static_cast<bf16*>(h), m, 2 * inter, d, lg);
  return cudaGetLastError();
}


// int8 weight-only matmul: y = (x @ Wq^T) * s, x bf16 (M, D) with a row
// stride, Wq int8 (O, D) contiguous, s fp32 (O,), y (M, O) contiguous in
// bf16 or fp32. The product is accumulated in fp32, multiplied by the scale
// in fp32 and rounded once to the output type (the reference's qproj and
// q8_matmul numerics). D is a multiple of 16.
//
// Replaces: paligemma_tpu/ops/pallas_quant.py::q8_matmul (kernel body
// _q8_kernel), and with it the XLA einsum of quantization.py::qproj, which
// the reference serves its int8 projections with. On the port it carries
// every int8 projection (qkv, o, gate_up, down), the w4a8 mode's int8
// companions, the int8 tied lm_head (V = 257152, D = 2048, fp32 out) and,
// with llm_only=False, the SigLIP linears and the projector.
//
// What bounds it on the H100:
//   - decode (M = 1): the weight bytes. One byte per weight at 3.35 TB/s,
//     e.g. 20.0 us for gate_up (32768 x 2048) and 157 us for the lm_head;
//     the arithmetic is 2 flop per byte, far below the card's ridge.
//   - prefill (M ~ 276, and SigLIP's 256 rows): the tensor cores, at
//     2 * M * O * D flop (1.09 TFLOP over the 18 decoder layers, 1.1 ms at
//     989 TFLOP/s bf16).
// The design:
//   - GEMV tiling for M <= 64: one warp per output row, 16-byte weight
//     loads with four in flight per lane, each int8 widened to fp32 by a
//     byte permute and a subtraction (no int-to-float conversions, which
//     would otherwise be the issue limit at this byte rate); the rows of x
//     are staged once per block in shared memory (up to 32 KB, in passes
//     over D), fp32 accumulators per row of x, a warp reduction and the
//     scale in the epilogue. More than 8 rows of x are taken 8 at a time
//     (blockIdx.y), so the weights are read once per 8 rows.
//   - GEMM tiling for M > 64: mma.sync m16n8k16 bf16 with fp32
//     accumulators, 64 x 64 output tiles, 4 warps of 16 rows each; the int8
//     tile is widened to bf16 on its way into shared memory (exact for
//     |q| <= 127); the next k-tile is loaded into registers while the
//     current one is multiplied. It is right, not fast (about 10% of the
//     bf16 tensor rate at 276 rows); wgmma/TMA are later work.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// GEMV tiling (M <= 64)
// ---------------------------------------------------------------------------

constexpr int kGemvMaxRows = 64;
constexpr int kGemvWarps = 8;
constexpr int kGemvThreads = 32 * kGemvWarps;
constexpr int kGemvSmemBytes = 32768;  // staged rows of x per pass
constexpr int kGemvUnroll = 4;         // 16-byte weight loads in flight per lane

template <int MT, bool F32OUT>
__global__ void __launch_bounds__(kGemvThreads)
    q8_gemv_kernel(const bf16* __restrict__ x, long long x_stride, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, void* __restrict__ out, int m, int o, int d) {
  constexpr int kChunk = kGemvSmemBytes / (2 * MT);  // columns of x per pass
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* x_s = reinterpret_cast<bf16*>(smem);  // MT rows of ld columns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * MT;
  const int rows = min(MT, m - m0);
  const int row = blockIdx.x * kGemvWarps + warp;  // this warp's output row
  const int ld = min(d, kChunk);
  // A warp past O walks a valid row and stores nothing.
  const int8_t* wrow = w + (long long)min(row, o - 1) * d;

  float acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0.f;

  for (int d0 = 0; d0 < d; d0 += kChunk) {
    const int dc = min(kChunk, d - d0);  // a multiple of 16
    const int vecs = dc / 8;
    __syncthreads();  // the previous pass no longer reads x_s
    for (int i = threadIdx.x; i < MT * vecs; i += kGemvThreads) {
      const int r = i / vecs, c = (i - r * vecs) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < rows) v = *reinterpret_cast<const uint4*>(x + (long long)(m0 + r) * x_stride + d0 + c);
      *reinterpret_cast<uint4*>(x_s + r * ld + c) = v;
    }
    __syncthreads();
    // Lane l takes the 16 columns at 16 * (l + 32 * j) of the pass.
    for (int c0 = lane * 16; c0 < dc; c0 += 512 * kGemvUnroll) {
      uint4 wv[kGemvUnroll];
#pragma unroll
      for (int u = 0; u < kGemvUnroll; ++u) {
        const int c = c0 + 512 * u;
        wv[u] = c < dc ? __ldg(reinterpret_cast<const uint4*>(wrow + d0 + c)) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kGemvUnroll; ++u) {
        const int c = c0 + 512 * u;
        if (c < dc) {
          float wf[16];
          s8x4_to_float(wv[u].x, wf);
          s8x4_to_float(wv[u].y, wf + 4);
          s8x4_to_float(wv[u].z, wf + 8);
          s8x4_to_float(wv[u].w, wf + 12);
#pragma unroll
          for (int r = 0; r < MT; ++r) {
            const uint4* xp = reinterpret_cast<const uint4*>(x_s + r * ld + c);
            float xf[16];
            bf16x8_to_float(xp[0], xf);
            bf16x8_to_float(xp[1], xf + 8);
#pragma unroll
            for (int e = 0; e < 16; ++e) acc[r] = fmaf(wf[e], xf[e], acc[r]);
          }
        }
      }
    }
  }
  if (row >= o) return;  // after the last barrier
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    const float v = warp_sum(acc[r]);
    if (lane == 0 && r < rows) store_out<F32OUT>(out, (long long)(m0 + r) * o + row, v * scale[row]);
  }
}

template <int MT, bool F32OUT>
cudaError_t launch_gemv(const bf16* x, long long x_stride, const int8_t* w, const float* scale,
                        void* out, int m, int o, int d, cudaStream_t stream) {
  constexpr int kChunk = kGemvSmemBytes / (2 * MT);
  const dim3 grid((o + kGemvWarps - 1) / kGemvWarps, (m + MT - 1) / MT);
  const size_t smem = sizeof(bf16) * MT * (size_t)min(d, kChunk);
  q8_gemv_kernel<MT, F32OUT><<<grid, kGemvThreads, smem, stream>>>(x, x_stride, w, scale, out, m, o, d);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// GEMM tiling (M > 64), tensor cores
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 64;
constexpr int kGemmThreads = 128;  // 4 warps x 16 rows
constexpr int kLdk = kBK + 8;      // shared row stride (bf16): 8 fragment rows hit 32 banks

// The (k0) tiles into registers: A 64 x 64 bf16 (4 vectors a thread), B
// 64 x 64 int8 (2 vectors a thread); zeros past M, O and D.
__device__ __forceinline__ void gemm_load(uint4* a_reg, uint4* b_reg, const bf16* __restrict__ x,
                                          long long x_stride, const int8_t* __restrict__ w, int m,
                                          int o, int d, int m0, int n0, int k0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = threadIdx.x + kGemmThreads * i;
    const int r = idx >> 3, c = (idx & 7) * 8;
    a_reg[i] = make_uint4(0, 0, 0, 0);
    if (m0 + r < m && k0 + c < d)
      a_reg[i] = __ldg(reinterpret_cast<const uint4*>(x + (long long)(m0 + r) * x_stride + k0 + c));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + kGemmThreads * i;
    const int r = idx >> 2, c = (idx & 3) * 16;
    b_reg[i] = make_uint4(0, 0, 0, 0);
    if (n0 + r < o && k0 + c < d)
      b_reg[i] = __ldg(reinterpret_cast<const uint4*>(w + (long long)(n0 + r) * d + k0 + c));
  }
}

// Sixteen int8 values widened to bf16 (exact), stored as two 16-byte vectors.
__device__ __forceinline__ void store_s8x16_as_bf16(bf16* dst, const uint4& v) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
  uint32_t packed[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
    s8x4_to_float(words[i], f);
    packed[2 * i] = pack_bf16(f[0], f[1]);
    packed[2 * i + 1] = pack_bf16(f[2], f[3]);
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
}

template <bool F32OUT>
__global__ void __launch_bounds__(kGemmThreads)
    q8_gemm_kernel(const bf16* __restrict__ x, long long x_stride, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, void* __restrict__ out, int m, int o, int d) {
  __shared__ __align__(16) bf16 a_s[kBM * kLdk];
  __shared__ __align__(16) bf16 b_s[kBN * kLdk];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  float acc[kBN / 8][4];
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  uint4 a_reg[4], b_reg[2];
  gemm_load(a_reg, b_reg, x, x_stride, w, m, o, d, m0, n0, 0);
  for (int k0 = 0; k0 < d; k0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = threadIdx.x + kGemmThreads * i;
      *reinterpret_cast<uint4*>(a_s + (idx >> 3) * kLdk + (idx & 7) * 8) = a_reg[i];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = threadIdx.x + kGemmThreads * i;
      store_s8x16_as_bf16(b_s + (idx >> 2) * kLdk + (idx & 3) * 16, b_reg[i]);
    }
    __syncthreads();
    if (k0 + kBK < d) gemm_load(a_reg, b_reg, x, x_stride, w, m, o, d, m0, n0, k0 + kBK);

    const bf16* a_w = a_s + warp * 16 * kLdk;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      const int c = ks * 16 + 2 * t4;
      uint32_t a[4];
      a[0] = ld32(a_w + g * kLdk + c);
      a[1] = ld32(a_w + (g + 8) * kLdk + c);
      a[2] = ld32(a_w + g * kLdk + c + 8);
      a[3] = ld32(a_w + (g + 8) * kLdk + c + 8);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const bf16* brow = b_s + (8 * j + g) * kLdk + c;
        mma_16816(acc[j], a, ld32(brow), ld32(brow + 8));
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + warp * 16 + g + 8 * (e >> 1);
      const int col = n0 + 8 * j + 2 * t4 + (e & 1);
      if (row < m && col < o) store_out<F32OUT>(out, (long long)row * o + col, acc[j][e] * scale[col]);
    }
  }
}

template <bool F32OUT>
cudaError_t launch_gemm(const bf16* x, long long x_stride, const int8_t* w, const float* scale,
                        void* out, int m, int o, int d, cudaStream_t stream) {
  const dim3 grid((o + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  q8_gemm_kernel<F32OUT><<<grid, kGemmThreads, 0, stream>>>(x, x_stride, w, scale, out, m, o, d);
  return cudaGetLastError();
}

template <bool F32OUT>
cudaError_t dispatch(const bf16* x, long long x_stride, const int8_t* w, const float* scale,
                     void* out, int m, int o, int d, cudaStream_t st) {
  if (m > kGemvMaxRows) return launch_gemm<F32OUT>(x, x_stride, w, scale, out, m, o, d, st);
  if (m == 1) return launch_gemv<1, F32OUT>(x, x_stride, w, scale, out, m, o, d, st);
  if (m == 2) return launch_gemv<2, F32OUT>(x, x_stride, w, scale, out, m, o, d, st);
  if (m <= 4) return launch_gemv<4, F32OUT>(x, x_stride, w, scale, out, m, o, d, st);
  return launch_gemv<8, F32OUT>(x, x_stride, w, scale, out, m, o, d, st);
}

}  // namespace

// x (M, D) bf16 with row stride x_stride (elements, a multiple of 8, rows
// 16-byte aligned); w (O, D) int8 and scale (O,) fp32, contiguous; out (M, O)
// contiguous, fp32 if out_f32 else bf16. D is a multiple of 16. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int pg_q8_matmul(const void* x, const void* w, const void* scale, void* out, int m, int o,
                            int d, long long x_stride, int out_f32, void* stream) {
  if (m < 1 || o < 1 || d < 16 || d % 16) return cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_f32 ? dispatch<true>(xp, x_stride, wp, sp, out, m, o, d, st)
                 : dispatch<false>(xp, x_stride, wp, sp, out, m, o, d, st);
}

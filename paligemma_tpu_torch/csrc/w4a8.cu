// w4a8: per-row int8 activations x packed int4 weights, and the per-row
// int8 quantization that feeds them (optionally behind the GeGLU gate).
//
// Replaces:
//   - paligemma_tpu/ops/pallas_quant.py::q4a8_matmul_tiled (and
//     q4a8_matmul, the same math over another TPU layout) -> w4a8_gemv;
//   - pallas_quant.py::quantize_rows_s8 and the gelu-gate-requant middle
//     of mlp_w4a8 / mlp_w4a8_stacked (_gate_and_quantize) -> quant_rows.
//   The fused MLP itself is four launches on one stream (ops/quant.py
//   mlp_w4a8): quant_rows(x), w4a8_gemv(gate_up) into a (M, 2I) bf16
//   scratch, quant_rows with the GeGLU prologue, w4a8_gemv(down). One
//   launch would need a grid-wide barrier between the two GEMVs.
//
// Layout (the port's own): packed (O, D/2) uint8, one output row's values
// in each row; within each group of 8 columns 8i..8i+7, byte 4i + k holds
// column 8i + k in its low nibble and 8i + 4 + k in its high nibble (two's
// complement, values in [-7, 7]). A 32-bit word w of packed bytes then
// gives, exactly in int8 lanes,
//   (w << 4) & 0xF0F0F0F0 = 16 * (columns 8i .. 8i+3)
//   w & 0xF0F0F0F0        = 16 * (columns 8i+4 .. 8i+7)
// and each feeds __dp4a against one word of int8 activations; the x16 is
// taken off the exact int32 sum at the end. The epilogue is
// (float(acc) * xs) * s, which is bit for bit the reference's
// lo/hi-nibble route (its scalings are powers of two).
//
// quant_rows, per row: fp32 absmax, xs = max(amax, 1e-8) / 127,
// xq = rint(x / xs) (IEEE division, round half to even). With the GeGLU
// prologue the row is h = bf16(bf16(gelu_tanh_fp32(gate)) * up), widened to
// fp32, in the reference's order (pallas_quant.py:622-641).
//
// What bounds them on the H100:
//   - w4a8_gemv at decode (M = 1): the packed weight bytes, half a byte per
//     weight at 3.35 TB/s: 10.0 us for gate_up (32768 x 2048), 5.0 us for
//     down (2048 x 16384), 78.6 us for the 4-bit lm_head (257152 x 2048).
//     The design: one warp per output row, 16-byte weight loads with four in
//     flight per lane; the int8 rows of x staged once per block in shared
//     memory (up to 32 KB, in passes over D); two mask ops and two dp4a per
//     packed word, exact int32 accumulators per row of x, a warp reduction;
//     more than 8 rows of x are taken 8 at a time (blockIdx.y).
//   - quant_rows: bytes too (2 bytes in, 1 out per value, 4 in with the
//     prologue), but at decode a row of 2048 or 16384 values is far below
//     the launch latency; one block per row reads the row twice (absmax,
//     then quantize; the second read hits L2).
#include "common.cuh"

namespace {

__device__ __forceinline__ int warp_sum_int(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

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
    uint32_t q[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t b = (uint32_t)(__float2int_rn(__fdiv_rn(h[e], s)) & 0xff);
      q[e >> 2] |= b << (8 * (e & 3));
    }
    *reinterpret_cast<uint2*>(qr + c) = make_uint2(q[0], q[1]);
  }
}

// ---------------------------------------------------------------------------
// w4a8_gemv
// ---------------------------------------------------------------------------

constexpr int kW4Warps = 8;
constexpr int kW4Threads = 32 * kW4Warps;
constexpr int kW4SmemBytes = 32768;  // staged int8 rows of x per pass
constexpr int kW4Unroll = 4;         // 16-byte weight loads in flight per lane
constexpr uint32_t kHiNibbles = 0xF0F0F0F0u;

template <int MT, bool F32OUT>
__global__ void __launch_bounds__(kW4Threads)
    w4a8_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                     const uint8_t* __restrict__ w, const float* __restrict__ scale,
                     void* __restrict__ out, int m, int o, int d) {
  constexpr int kChunk = kW4SmemBytes / MT;  // columns of x per pass
  extern __shared__ __align__(16) unsigned char smem[];
  const int8_t* x_s = reinterpret_cast<const int8_t*>(smem);  // MT rows of ld columns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * MT;
  const int rows = min(MT, m - m0);
  const int row = blockIdx.x * kW4Warps + warp;  // this warp's output row
  const int ld = min(d, kChunk);
  // A warp past O walks a valid row and stores nothing.
  const uint8_t* wrow = w + (long long)min(row, o - 1) * (d / 2);

  int acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0;

  for (int d0 = 0; d0 < d; d0 += kChunk) {
    const int dc = min(kChunk, d - d0);  // a multiple of 32
    const int vecs = dc / 16;
    __syncthreads();  // the previous pass no longer reads x_s
    for (int i = threadIdx.x; i < MT * vecs; i += kW4Threads) {
      const int r = i / vecs, c = (i - r * vecs) * 16;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < rows) v = *reinterpret_cast<const uint4*>(xq + (long long)(m0 + r) * d + d0 + c);
      *reinterpret_cast<uint4*>(smem + r * ld + c) = v;
    }
    __syncthreads();
    // Lane l takes the 32 columns (16 packed bytes) at 32 * (l + 32 * j).
    for (int c0 = lane * 32; c0 < dc; c0 += 1024 * kW4Unroll) {
      uint4 wv[kW4Unroll];
#pragma unroll
      for (int u = 0; u < kW4Unroll; ++u) {
        const int c = c0 + 1024 * u;
        wv[u] = c < dc ? __ldg(reinterpret_cast<const uint4*>(wrow + (d0 + c) / 2))
                       : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kW4Unroll; ++u) {
        const int c = c0 + 1024 * u;
        if (c < dc) {
          const uint32_t wd[4] = {wv[u].x, wv[u].y, wv[u].z, wv[u].w};
          int lo16[4], hi16[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            lo16[t] = (int)((wd[t] << 4) & kHiNibbles);
            hi16[t] = (int)(wd[t] & kHiNibbles);
          }
#pragma unroll
          for (int r = 0; r < MT; ++r) {
            const uint4* xp = reinterpret_cast<const uint4*>(x_s + r * ld + c);
            const uint4 xa = xp[0], xb = xp[1];
            const int xw[8] = {(int)xa.x, (int)xa.y, (int)xa.z, (int)xa.w,
                               (int)xb.x, (int)xb.y, (int)xb.z, (int)xb.w};
            int a = acc[r];
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              a = __dp4a(lo16[t], xw[2 * t], a);
              a = __dp4a(hi16[t], xw[2 * t + 1], a);
            }
            acc[r] = a;
          }
        }
      }
    }
  }
  if (row >= o) return;  // after the last barrier
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    const int v = warp_sum_int(acc[r]) >> 4;  // exact: every term is a multiple of 16
    if (lane == 0 && r < rows)
      store_out<F32OUT>(out, (long long)(m0 + r) * o + row, ((float)v * xs[m0 + r]) * scale[row]);
  }
}

template <int MT, bool F32OUT>
cudaError_t launch_gemv(const int8_t* xq, const float* xs, const uint8_t* w, const float* scale,
                        void* out, int m, int o, int d, cudaStream_t stream) {
  constexpr int kChunk = kW4SmemBytes / MT;
  const dim3 grid((o + kW4Warps - 1) / kW4Warps, (m + MT - 1) / MT);
  const size_t smem = (size_t)MT * min(d, kChunk);
  w4a8_gemv_kernel<MT, F32OUT><<<grid, kW4Threads, smem, stream>>>(xq, xs, w, scale, out, m, o, d);
  return cudaGetLastError();
}

template <bool F32OUT>
cudaError_t dispatch(const int8_t* xq, const float* xs, const uint8_t* w, const float* scale,
                     void* out, int m, int o, int d, cudaStream_t st) {
  if (m == 1) return launch_gemv<1, F32OUT>(xq, xs, w, scale, out, m, o, d, st);
  if (m == 2) return launch_gemv<2, F32OUT>(xq, xs, w, scale, out, m, o, d, st);
  if (m <= 4) return launch_gemv<4, F32OUT>(xq, xs, w, scale, out, m, o, d, st);
  return launch_gemv<8, F32OUT>(xq, xs, w, scale, out, m, o, d, st);
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
// M >= 1 (taken 8 rows at a time over blockIdx.y); D is a multiple of 32.
extern "C" int pg_w4a8_gemv(const void* xq, const void* xs, const void* w, const void* scale,
                            void* out, int m, int o, int d, int out_f32, void* stream) {
  if (m < 1 || (m + 7) / 8 > 65535 || o < 1 || d < 32 || d % 32) return cudaErrorInvalidValue;
  const int8_t* xp = static_cast<const int8_t*>(xq);
  const float* xsp = static_cast<const float*>(xs);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_f32 ? dispatch<true>(xp, xsp, wp, sp, out, m, o, d, st)
                 : dispatch<false>(xp, xsp, wp, sp, out, m, o, d, st);
}

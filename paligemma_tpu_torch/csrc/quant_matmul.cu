// Weight-only quantized matmul: y = (x @ Wq^T) * s, x bf16 (M, D) with a row
// stride, Wq (O, D) int8 or packed int4 (O, D/2) contiguous, s fp32 (O,),
// y (M, O) contiguous in bf16 or fp32. The product is accumulated in fp32,
// multiplied by the scale in fp32 and rounded once to the output type (the
// reference's qproj, q8_matmul and q4_matmul numerics). D is a multiple of
// 16 (int8) or 32 (int4).
//
// Replaces:
//   - paligemma_tpu/ops/pallas_quant.py::q8_matmul (kernel body _q8_kernel),
//     and with it the XLA einsum of quantization.py::qproj, which the
//     reference serves its int8 projections with. On the port it carries
//     every int8 projection (qkv, o, gate_up, down), the w4a8 mode's int8
//     companions, the int8 tied lm_head (V = 257152, D = 2048, fp32 out)
//     and, with llm_only=False, the SigLIP linears and the projector;
//   - pallas_quant.py::q4_matmul (kernel body _q4_kernel): the int4
//     weight-only mode's qkv, o, gate_up and down, prefill and decode.
// The two are one design with two weight formats (Int8Rows, Int4Rows): a
// 16-byte weight vector holds 16 int8 or 32 int4 columns, widened to fp32
// (GEMV) or bf16 (GEMM) on the way in. The int4 layout is the port's
// (ops/quant.py::pack_int4): within each group of 8 columns, byte 4i + k
// holds column 8i + k in its low nibble and 8i + 4 + k in its high nibble,
// so for a 32-bit word w, (w << 4) & 0xF0F0F0F0 and w & 0xF0F0F0F0 are 16
// times four consecutive columns each, exact in int8 lanes; the widened
// values are 16 q, and the sums are multiplied by 1/16 (exact) before the
// scale.
//
// What bounds it on the H100:
//   - decode (M = 1): the weight bytes. One byte per weight at 3.35 TB/s
//     for int8, e.g. 20.0 us for gate_up (32768 x 2048) and 157 us for the
//     lm_head; half a byte for int4 (gate_up 10.0 us). The arithmetic is 2
//     flop per int8 byte (4 per int4 byte), far below the card's ridge;
//     int4 doubles the widening work per byte.
//   - prefill (M ~ 276, and SigLIP's 256 rows): the tensor cores, at
//     2 * M * O * D flop (1.09 TFLOP over the 18 decoder layers, 1.1 ms at
//     989 TFLOP/s bf16).
// The design:
//   - GEMV tiling for M <= 64: one warp per int8 output row (two per int4
//     row, so a warp streams the same bytes), 16-byte weight loads with
//     four per row in flight per lane, each int8 widened to fp32 by a
//     byte permute and a subtraction (no int-to-float conversions, which
//     would otherwise be the issue limit at this byte rate); the rows of x
//     are staged once per block in shared memory (up to 32 KB, in passes
//     over D) and each lane reads its 16-byte pieces of them in a rotated
//     order, free of bank conflicts; fp32 accumulators per row of x, a warp
//     reduction and the scale in the epilogue. More than 8 rows of x are taken 8 at a time
//     (blockIdx.y), so the weights are read once per 8 rows.
//   - GEMM tiling for M > 64: mma.sync m16n8k16 bf16 with fp32
//     accumulators, 64 x 64 output tiles, 4 warps of 16 rows each; the
//     weight tile is widened to bf16 on its way into shared memory (exact
//     for |q| <= 127, and for 16 q with |q| <= 7); the next k-tile is loaded
//     into registers while the current one is multiplied. It is right, not
//     fast (about 10% of the bf16 tensor rate at 276 rows); wgmma/TMA are
//     later work.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Weight formats
// ---------------------------------------------------------------------------

// int8, one byte per weight.
struct Int8Rows {
  static constexpr int kColsPerVec = 16;  // columns of one 16-byte vector
  static constexpr float kUnit = 1.f;     // the widened values are q
  // The eight columns 8j .. 8j+7 of the vector (j = 0, 1) widened to fp32.
  static __device__ __forceinline__ void widen8(const uint4& v, int j, float* f) {
    s8x4_to_float(j ? v.z : v.x, f);
    s8x4_to_float(j ? v.w : v.y, f + 4);
  }
};

// int4, two per byte in the port's packing.
struct Int4Rows {
  static constexpr int kColsPerVec = 32;
  static constexpr float kUnit = 0.0625f;  // the widened values are 16 q
  // Columns 8j .. 8j+7 (j = 0 .. 3) are the nibbles of word j.
  static __device__ __forceinline__ void widen8(const uint4& v, int j, float* f) {
    const uint32_t w = j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
    s8x4_to_float((w << 4) & 0xF0F0F0F0u, f);
    s8x4_to_float(w & 0xF0F0F0F0u, f + 4);
  }
};

// The weight row `row` of a (O, D) matrix in format W, as bytes.
template <class W>
__device__ __forceinline__ const uint8_t* weight_row(const uint8_t* w, int row, int d) {
  return w + (long long)row * (d / (W::kColsPerVec / 16));
}

// ---------------------------------------------------------------------------
// GEMV tiling (M <= 64)
// ---------------------------------------------------------------------------

constexpr int kGemvMaxRows = 64;
constexpr int kGemvWarps = 8;
constexpr int kGemvThreads = 32 * kGemvWarps;
constexpr int kGemvSmemBytes = 32768;  // staged rows of x per pass
constexpr int kGemvUnroll = 4;         // 16-byte weight vectors per lane and row in flight

// Output rows per warp: one int8 row, two int4 rows, so that a warp streams
// the same bytes per pass in both formats (one int4 row of D = 2048 is only
// two vectors a lane, too little work to amortize the block's staging of x).
template <class W>
__host__ __device__ constexpr int gemv_rows() {
  return W::kColsPerVec / 16;
}

template <class W, int MT, bool F32OUT>
__global__ void __launch_bounds__(kGemvThreads)
    gemv_kernel(const bf16* __restrict__ x, long long x_stride, const uint8_t* __restrict__ w,
                const float* __restrict__ scale, void* __restrict__ out, int m, int o, int d) {
  constexpr int kChunk = kGemvSmemBytes / (2 * MT);  // columns of x per pass
  constexpr int kCols = W::kColsPerVec;
  constexpr int kParts = kCols / 8;  // 16-byte pieces of x per weight vector
  constexpr int kRows = gemv_rows<W>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* x_s = reinterpret_cast<bf16*>(smem);  // MT rows of ld columns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // A lane's x columns are kCols * 2 bytes from its neighbour's, so the
  // lanes of a quarter-warp would read their 16-byte pieces from the same
  // banks (2-way for int8, 4-way for int4). With more than one row of x,
  // where those reads are the limit, each lane takes its pieces in a
  // rotated order, so that one instruction's eight reads hit eight
  // different 16-byte bank groups. (At M = 1 the rotation's selects cost
  // more than the conflicts: measured.)
  const int rot = MT == 1 ? 0 : (lane / (8 / kParts)) % kParts;
  const int m0 = blockIdx.y * MT;
  const int rows = min(MT, m - m0);
  const int row0 = (blockIdx.x * kGemvWarps + warp) * kRows;  // this warp's output rows
  const int ld = min(d, kChunk);
  // A warp past O walks a valid row and stores nothing.
  const uint8_t* wrow[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) wrow[k] = weight_row<W>(w, min(row0 + k, o - 1), d);

  float acc[MT][kRows];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int k = 0; k < kRows; ++k) acc[r][k] = 0.f;

  for (int d0 = 0; d0 < d; d0 += kChunk) {
    const int dc = min(kChunk, d - d0);  // a multiple of kCols
    const int vecs = dc / 8;
    __syncthreads();  // the previous pass no longer reads x_s
    for (int i = threadIdx.x; i < MT * vecs; i += kGemvThreads) {
      const int r = i / vecs, c = (i - r * vecs) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < rows) v = *reinterpret_cast<const uint4*>(x + (long long)(m0 + r) * x_stride + d0 + c);
      *reinterpret_cast<uint4*>(x_s + r * ld + c) = v;
    }
    __syncthreads();
    // Lane l takes the kCols columns at kCols * (l + 32 * j) of the pass.
    for (int c0 = lane * kCols; c0 < dc; c0 += 32 * kCols * kGemvUnroll) {
      uint4 wv[kGemvUnroll][kRows];
#pragma unroll
      for (int u = 0; u < kGemvUnroll; ++u) {
        const int c = c0 + 32 * kCols * u;
#pragma unroll
        for (int k = 0; k < kRows; ++k)
          wv[u][k] = c < dc ? __ldg(reinterpret_cast<const uint4*>(wrow[k] + (d0 + c) / (kCols / 16)))
                            : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kGemvUnroll; ++u) {
        const int c = c0 + 32 * kCols * u;
        if (c < dc) {
#pragma unroll
          for (int j = 0; j < kParts; ++j) {
            const int part = (j + rot) % kParts;
            float wf[kRows][8];
#pragma unroll
            for (int k = 0; k < kRows; ++k) W::widen8(wv[u][k], part, wf[k]);
#pragma unroll
            for (int r = 0; r < MT; ++r) {
              float xf[8];
              bf16x8_to_float(*reinterpret_cast<const uint4*>(x_s + r * ld + c + 8 * part), xf);
#pragma unroll
              for (int k = 0; k < kRows; ++k)
#pragma unroll
                for (int e = 0; e < 8; ++e) acc[r][k] = fmaf(wf[k][e], xf[e], acc[r][k]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int row = row0 + k;
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      const float v = warp_sum(acc[r][k]);
      if (lane == 0 && r < rows && row < o)
        store_out<F32OUT>(out, (long long)(m0 + r) * o + row, v * W::kUnit * scale[row]);
    }
  }
}

template <class W, int MT, bool F32OUT>
cudaError_t launch_gemv(const bf16* x, long long x_stride, const uint8_t* w, const float* scale,
                        void* out, int m, int o, int d, cudaStream_t stream) {
  constexpr int kChunk = kGemvSmemBytes / (2 * MT);
  constexpr int kBlockRows = kGemvWarps * gemv_rows<W>();
  const dim3 grid((o + kBlockRows - 1) / kBlockRows, (m + MT - 1) / MT);
  const size_t smem = sizeof(bf16) * MT * (size_t)min(d, kChunk);
  gemv_kernel<W, MT, F32OUT><<<grid, kGemvThreads, smem, stream>>>(x, x_stride, w, scale, out, m, o, d);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// GEMM tiling (M > 64), tensor cores
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 64;
constexpr int kGemmThreads = 128;  // 4 warps x 16 rows
constexpr int kLdk = kBK + 8;      // shared row stride (bf16): 8 fragment rows hit 32 banks

// The weight vectors of one 64 x 64 tile a thread loads: 2 for int8, 1 for int4.
template <class W>
__host__ __device__ constexpr int b_vecs() {
  return kBN * kBK / W::kColsPerVec / kGemmThreads;
}

// The (k0) tiles into registers: A 64 x 64 bf16 (4 vectors a thread), B
// 64 x 64 weights; zeros past M, O and D.
template <class W>
__device__ __forceinline__ void gemm_load(uint4* a_reg, uint4* b_reg, const bf16* __restrict__ x,
                                          long long x_stride, const uint8_t* __restrict__ w, int m,
                                          int o, int d, int m0, int n0, int k0) {
  constexpr int kVecsPerRow = kBK / W::kColsPerVec;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = threadIdx.x + kGemmThreads * i;
    const int r = idx >> 3, c = (idx & 7) * 8;
    a_reg[i] = make_uint4(0, 0, 0, 0);
    if (m0 + r < m && k0 + c < d)
      a_reg[i] = __ldg(reinterpret_cast<const uint4*>(x + (long long)(m0 + r) * x_stride + k0 + c));
  }
#pragma unroll
  for (int i = 0; i < b_vecs<W>(); ++i) {
    const int idx = threadIdx.x + kGemmThreads * i;
    const int r = idx / kVecsPerRow, c = (idx % kVecsPerRow) * W::kColsPerVec;
    b_reg[i] = make_uint4(0, 0, 0, 0);
    if (n0 + r < o && k0 + c < d)
      b_reg[i] = __ldg(reinterpret_cast<const uint4*>(weight_row<W>(w, n0 + r, d) +
                                                      (k0 + c) / (W::kColsPerVec / 16)));
  }
}

// One weight vector widened to bf16 (exact), stored as kColsPerVec / 8
// 16-byte vectors.
template <class W>
__device__ __forceinline__ void store_as_bf16(bf16* dst, const uint4& v) {
#pragma unroll
  for (int j = 0; j < W::kColsPerVec / 8; ++j) {
    float f[8];
    W::widen8(v, j, f);
    *reinterpret_cast<uint4*>(dst + 8 * j) =
        make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
  }
}

template <class W, bool F32OUT>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_kernel(const bf16* __restrict__ x, long long x_stride, const uint8_t* __restrict__ w,
                const float* __restrict__ scale, void* __restrict__ out, int m, int o, int d) {
  __shared__ __align__(16) bf16 a_s[kBM * kLdk];
  __shared__ __align__(16) bf16 b_s[kBN * kLdk];
  constexpr int kVecsPerRow = kBK / W::kColsPerVec;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  float acc[kBN / 8][4];
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  uint4 a_reg[4], b_reg[b_vecs<W>()];
  gemm_load<W>(a_reg, b_reg, x, x_stride, w, m, o, d, m0, n0, 0);
  for (int k0 = 0; k0 < d; k0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = threadIdx.x + kGemmThreads * i;
      *reinterpret_cast<uint4*>(a_s + (idx >> 3) * kLdk + (idx & 7) * 8) = a_reg[i];
    }
#pragma unroll
    for (int i = 0; i < b_vecs<W>(); ++i) {
      const int idx = threadIdx.x + kGemmThreads * i;
      store_as_bf16<W>(b_s + (idx / kVecsPerRow) * kLdk + (idx % kVecsPerRow) * W::kColsPerVec, b_reg[i]);
    }
    __syncthreads();
    if (k0 + kBK < d) gemm_load<W>(a_reg, b_reg, x, x_stride, w, m, o, d, m0, n0, k0 + kBK);

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
      if (row < m && col < o)
        store_out<F32OUT>(out, (long long)row * o + col, acc[j][e] * W::kUnit * scale[col]);
    }
  }
}

template <class W, bool F32OUT>
cudaError_t launch_gemm(const bf16* x, long long x_stride, const uint8_t* w, const float* scale,
                        void* out, int m, int o, int d, cudaStream_t stream) {
  const dim3 grid((o + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  gemm_kernel<W, F32OUT><<<grid, kGemmThreads, 0, stream>>>(x, x_stride, w, scale, out, m, o, d);
  return cudaGetLastError();
}

template <class W, bool F32OUT>
cudaError_t dispatch(const bf16* x, long long x_stride, const uint8_t* w, const float* scale,
                     void* out, int m, int o, int d, cudaStream_t st) {
  if (m > kGemvMaxRows) return launch_gemm<W, F32OUT>(x, x_stride, w, scale, out, m, o, d, st);
  if (m == 1) return launch_gemv<W, 1, F32OUT>(x, x_stride, w, scale, out, m, o, d, st);
  if (m == 2) return launch_gemv<W, 2, F32OUT>(x, x_stride, w, scale, out, m, o, d, st);
  if (m <= 4) return launch_gemv<W, 4, F32OUT>(x, x_stride, w, scale, out, m, o, d, st);
  return launch_gemv<W, 8, F32OUT>(x, x_stride, w, scale, out, m, o, d, st);
}

template <class W>
int run(const void* x, const void* w, const void* scale, void* out, int m, int o, int d,
        long long x_stride, int out_f32, void* stream) {
  if (m < 1 || o < 1 || d < W::kColsPerVec || d % W::kColsPerVec) return cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_f32 ? dispatch<W, true>(xp, x_stride, wp, sp, out, m, o, d, st)
                 : dispatch<W, false>(xp, x_stride, wp, sp, out, m, o, d, st);
}

}  // namespace

// x (M, D) bf16 with row stride x_stride (elements, a multiple of 8, rows
// 16-byte aligned); w (O, D) int8 and scale (O,) fp32, contiguous; out (M, O)
// contiguous, fp32 if out_f32 else bf16. D is a multiple of 16. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int pg_q8_matmul(const void* x, const void* w, const void* scale, void* out, int m, int o,
                            int d, long long x_stride, int out_f32, void* stream) {
  return run<Int8Rows>(x, w, scale, out, m, o, d, x_stride, out_f32, stream);
}

// As pg_q8_matmul with w (O, D/2) packed int4 (ops/quant.py::pack_int4); D
// is a multiple of 32.
extern "C" int pg_q4_matmul(const void* x, const void* w, const void* scale, void* out, int m, int o,
                            int d, long long x_stride, int out_f32, void* stream) {
  return run<Int4Rows>(x, w, scale, out, m, o, d, x_stride, out_f32, stream);
}

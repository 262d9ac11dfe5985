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
// times four consecutive columns each, exact in int8 lanes; the GEMV's
// widened values are 16 q, and its sums are multiplied by 1/16 (exact)
// before the scale. The GEMM widens q itself.
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
//     accumulators, computed as W x^T: the widened weights are the mma's A
//     operand, built in registers in the order it takes them, and x its B
//     operand. Blocks of 96 rows by 128 columns, 4 warps of 96 x 32: each
//     widened weight fragment feeds twelve products.
//   - Grid order: M fastest, so the M blocks that share a weight slab run
//     together and each weight byte comes from device memory once.
//   - Pipeline: a 4-stage cp.async ring of 64-deep k-tiles holding the bf16
//     x tile and the raw int8/int4 weight bytes (16-byte copies whose row
//     pointers are set up once a block; rows past M or O are read as the
//     last row, whose products land in outputs never stored, and columns
//     past D are zero-filled; 16-byte chunks XOR-swizzled within a row, so
//     the copies and the fragment loads are free of bank conflicts), one
//     barrier per k-tile.
//     The weights are widened in registers, exactly (int8 by a byte
//     permute and an fp32 subtraction, int4 by a mask and a bf16
//     subtraction), while the next stages' copies are in flight; the
//     products of 4 row tiles are interleaved, so that the two into one
//     accumulator are 8 apart. Each k32
//     step sums its columns in a permuted order, the same for x and W, so
//     that a thread's operands are contiguous: one 16-byte shared load per
//     row of x, one 8-byte (int8) or 4-byte (int4) load per weight row. No
//     ldmatrix: its fixed order would scatter a thread's weight bytes.
//   - Split K: when the output tiles would leave SMs idle (the o, qkv and
//     down projections at a few hundred rows), K is split into the number
//     of splits s (k-tiles of at least 4 each, s <= 16) that minimizes
//     waves(tiles * s) * (k-tiles per split + 4) + (s - 1). The reduction
//     is a fix-up in the same launch: every block writes its fp32 partial
//     tile to a workspace, and the last block of an output tile to arrive
//     (a counter per tile, which that block resets to zero) adds the
//     partials in split order and applies the scale. The sums do not
//     depend on the order the blocks ran in; no float atomics.
//   - What bounds it now (measured on the H100): latency more than issue.
//     The loop runs ~4 instructions an mma (the widening and the copies
//     beside it) at ~12 clocks an mma on each scheduler, with 2 warps a
//     scheduler (180-184 registers): gate_up at 276 rows is about 2x
//     F.linear on a bf16 copy. 989 TFLOP/s is the wgmma rate; wgmma and
//     TMA copies are later work.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Weight formats
// ---------------------------------------------------------------------------

// Four int8 values of a word as two bf16 pairs, exactly: widened to fp32
// (s8x4_to_float), whose small integers keep their value in the upper 16
// bits.
__device__ __forceinline__ void s8x4_to_bf16x2(uint32_t w, uint32_t* b) {
  float f[4];
  s8x4_to_float(w, f);
  b[0] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  b[1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// The signed nibbles in bits 0-3 and 16-19 of t as a bf16 pair, exactly:
// 0x4300 | (u ^ 8) is the bf16 128 + (q + 8) for a nibble u = q mod 16,
// and 136 is subtracted in bf16.
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t t) {
  const uint32_t v = (t & 0x000F000Fu) ^ 0x43084308u;
  const uint32_t c = 0x43084308u;  // bf16 136, twice
  const bf162 r = __hsub2(*reinterpret_cast<const bf162*>(&v), *reinterpret_cast<const bf162*>(&c));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// int8, one byte per weight.
struct Int8Rows {
  static constexpr int kColsPerVec = 16;  // columns of one 16-byte vector
  static constexpr int kColsPerByte = 1;
  static constexpr float kUnit = 1.f;     // the widened values are q
  // The eight columns 8j .. 8j+7 of the vector (j = 0, 1) widened to fp32.
  static __device__ __forceinline__ void widen8(const uint4& v, int j, float* f) {
    s8x4_to_float(j ? v.z : v.x, f);
    s8x4_to_float(j ? v.w : v.y, f + 4);
  }
  // GEMM: eight consecutive columns as the bf16 pairs (0,1) (2,3) (4,5) (6,7).
  using Frag = uint2;
  static __device__ __forceinline__ void widen_bf16(const Frag& v, uint32_t* b) {
    s8x4_to_bf16x2(v.x, b);
    s8x4_to_bf16x2(v.y, b + 2);
  }
};

// int4, two per byte in the port's packing.
struct Int4Rows {
  static constexpr int kColsPerVec = 32;
  static constexpr int kColsPerByte = 2;
  static constexpr float kUnit = 0.0625f;  // the widened values are 16 q
  // Columns 8j .. 8j+7 (j = 0 .. 3) are the nibbles of word j.
  static __device__ __forceinline__ void widen8(const uint4& v, int j, float* f) {
    const uint32_t w = j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
    s8x4_to_float((w << 4) & 0xF0F0F0F0u, f);
    s8x4_to_float(w & 0xF0F0F0F0u, f + 4);
  }
  // GEMM: the eight columns of one word as the bf16 pairs (0,1) (2,3)
  // (4,5) (6,7) of q itself (not 16 q): columns k and 4 + k are the low
  // and high nibble of byte k.
  using Frag = uint32_t;
  static __device__ __forceinline__ void widen_bf16(const Frag& w, uint32_t* b) {
    const uint32_t hi = w >> 4;
    b[0] = nibbles_to_bf16x2(__byte_perm(w, 0u, 0x4140));
    b[1] = nibbles_to_bf16x2(__byte_perm(w, 0u, 0x4342));
    b[2] = nibbles_to_bf16x2(__byte_perm(hi, 0u, 0x4140));
    b[3] = nibbles_to_bf16x2(__byte_perm(hi, 0u, 0x4342));
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

constexpr int kBM = 96, kBN = 128, kBK = 64, kStages = 4;  // block tile, k-tile depth, ring stages
constexpr int kGemmWarps = 4;  // side by side along N
constexpr int kGemmThreads = 32 * kGemmWarps;
constexpr int kWarpN = kBN / kGemmWarps;  // 32 columns a warp
constexpr int kFT = kWarpN / 16;          // its output columns as m16 tiles of the mma
constexpr int kTT = kBM / 8;              // its rows as n8 tiles of the mma
constexpr int kTG = 4;                    // row tiles whose products are interleaved
constexpr int kARow = kBK * 2;  // bytes of one x row of a stage
constexpr int kMaxSplits = 16;        // split-K: at most this many splits,
constexpr int kMinSplitKTiles = 4;    // of at least this many k-tiles each,
constexpr int kMaxSplitTiles = 4096;  // over at most this many output tiles (the counters)
constexpr int kBlockCost = 4;         // a block's fixed cost (fill, epilogue), in k-tiles

// Bytes of one weight row of a stage, and of one ring stage (the x tile in
// bf16 and the raw weight tile).
template <class W>
__host__ __device__ constexpr int gemm_b_row() {
  return kBK / W::kColsPerByte;
}
template <class W>
__host__ __device__ constexpr int gemm_stage_bytes() {
  return kBM * kARow + kBN * gemm_b_row<W>();
}

// The 16-byte chunk `chunk` of shared row `row` (rows of kRowBytes <= 128)
// is stored at this chunk index: the rows that one shared load instruction
// reads from the same bank offset get disjoint halves of the row, so the
// fragment loads below and the cp.async stores are free of bank conflicts.
template <int kRowBytes>
__host__ __device__ constexpr int swz(int row, int chunk) {
  return chunk ^ (((row * kRowBytes / 128) & 1) * (kRowBytes / 32));
}

// mma_16816 without `volatile`: the compiler may schedule the products
// among the next fragments' loads and widening.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The copies of one operand tile (kRows rows of kRowBytes bytes a stage)
// that one thread issues every k-tile: kN 16-byte chunks of one column
// position, kRowsApart rows apart. Set up once a block. A row past the
// matrix is read as its last row: its products land in outputs that are
// never stored. Only columns past D are zero-filled.
template <int kRows, int kRowBytes>
struct TileCopies {
  static constexpr int kPerRow = kRowBytes / 16;
  static constexpr int kN = kRows * kPerRow / kGemmThreads;
  static constexpr int kRowsApart = kGemmThreads / kPerRow;
  static_assert(kRows * kPerRow % kGemmThreads == 0, "whole chunks a thread");
  const uint8_t* row[kN];  // the start of chunk i's row
  int col;                 // the chunks' byte offset within a row of the tile
  int dst;                 // shared offset of chunk 0 in a stage

  __device__ __forceinline__ TileCopies(const uint8_t* base, long long row_bytes, int row0, int rows) {
    const int r = threadIdx.x / kPerRow, c = threadIdx.x % kPerRow;
    col = 16 * c;
    dst = r * kRowBytes + swz<kRowBytes>(r, c) * 16;  // chunk i: + i * kRowsApart * kRowBytes
#pragma unroll
    for (int i = 0; i < kN; ++i) row[i] = base + min(row0 + r + i * kRowsApart, rows - 1) * row_bytes;
  }

  // The chunks of the k-tile at byte offset `k_bytes` of each row, whose
  // rows end at byte `row_end`, into the stage at shared address `stage`.
  __device__ __forceinline__ void issue(unsigned stage, int k_bytes, int row_end) const {
    const int at = k_bytes + col;
    if (k_bytes + kRowBytes <= row_end) {  // the whole k-tile lies inside the rows
#pragma unroll
      for (int i = 0; i < kN; ++i) cp_async16(stage + dst + i * kRowsApart * kRowBytes, row[i] + at, 16);
    } else {
      const bool ok = at < row_end;
#pragma unroll
      for (int i = 0; i < kN; ++i)
        cp_async16(stage + dst + i * kRowsApart * kRowBytes, row[i] + (ok ? at : 0), ok ? 16 : 0);
    }
  }
};

// y[m0.., n0..] of x (M, D) @ W (O, D)^T * scale on mma.sync m16n8k16 (bf16
// in, fp32 sums), computed as its transpose W x^T: the widened weights are
// the mma's A operand (16 output columns by 16 k), built in registers in the
// order the mma takes them, and x is its B operand (16 k by 8 rows), two
// consecutive registers of one shared load. Block: 96 x 128 outputs, 4 warps
// side by side along N, each 96 rows x 32 columns (twelve n8 by two m16
// tiles). Grid: (M blocks, N blocks, K splits), M fastest, so the blocks
// that share a weight slab run together and the slab comes from device
// memory once.
//
// k order: the sums run over the 32 columns of a k32 step in a permuted
// order, the same for x and W, so that a thread's operands are contiguous.
// Thread (g = lane / 4, t4 = lane % 4) takes the columns 8 t4 .. 8 t4 + 7 of
// the step: 8 weight bytes (int8) or 4 (int4) of each of its weight rows,
// widened to bf16 and used by twelve products, and one 16-byte shared load
// per row of x. Columns 8 t4 + 0..3 feed the first mma of the step as its k
// 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9; columns 8 t4 + 4..7 the second.
//
// With gridDim.z > 1, split z covers k-tiles [z k_per, (z + 1) k_per): each
// block writes its fp32 partial tile to `partial`, and the last block of an
// output tile to arrive (a counter per tile, reset by that block) adds the
// partials in split order 0, 1, .. and applies the scale: the sums do not
// depend on the order the blocks ran in.
template <class W, bool F32OUT>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_kernel(const bf16* __restrict__ x, long long x_stride, const uint8_t* __restrict__ w,
                const float* __restrict__ scale, void* __restrict__ out, int m, int o, int d,
                int k_per, float* __restrict__ partial, int* __restrict__ counters) {
  constexpr int kBRow = gemm_b_row<W>();
  constexpr int kStage = gemm_stage_bytes<W>();
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last;  // split-K: this block is the tile's last to arrive
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int kt0 = blockIdx.z * k_per;
  const int nk = min(k_per, (d + kBK - 1) / kBK - kt0);
  const unsigned smem0 = static_cast<unsigned>(__cvta_generic_to_shared(smem));

  const TileCopies<kBM, kARow> a_copies(reinterpret_cast<const uint8_t*>(x), 2 * x_stride, m0, m);
  const TileCopies<kBN, kBRow> b_copies(w, d / W::kColsPerByte, n0, o);
  auto issue = [&](int stage, int kt) {
    const unsigned st = smem0 + stage * kStage;
    a_copies.issue(st, 2 * kt * kBK, 2 * d);
    b_copies.issue(st + kBM * kARow, kt * kBK / W::kColsPerByte, d / W::kColsPerByte);
  };
  // This thread's fragment offsets within a stage, for each k32 step s.
  int a_off[kBK / 32], b_off[kBK / 32];
#pragma unroll
  for (int s = 0; s < kBK / 32; ++s) {
    const int ra = g, rb = warp * kWarpN + g, byte = (32 * s + 8 * t4) / W::kColsPerByte;
    a_off[s] = ra * kARow + swz<kARow>(ra, 4 * s + t4) * 16;  // row parity fixes the swizzle
    b_off[s] = kBM * kARow + rb * kBRow + swz<kBRow>(rb, byte / 16) * 16 + byte % 16;
  }

  // acc[f][t]: output columns 16 f + g (+ 8), rows 8 t + 2 t4 (+ 1) of the warp.
  float acc[kFT][kTT][4];
#pragma unroll
  for (int f = 0; f < kFT; ++f)
#pragma unroll
    for (int t = 0; t < kTT; ++t) acc[f][t][0] = acc[f][t][1] = acc[f][t][2] = acc[f][t][3] = 0.f;

  // The ring: k-tile i lives in stage i % kStages; kStages - 1 tiles are
  // in flight while one is multiplied.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) issue(s, kt0 + s);
    cp_async_commit();
  }
  int rd = 0, wr = kStages - 1;  // the stages read and written this iteration
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kStages - 2>();  // tile i has landed (this thread's copies)
    __syncthreads();               // ... everyone's; and stage wr (read last iteration) is free
    if (i + kStages - 1 < nk) issue(wr, kt0 + i + kStages - 1);
    cp_async_commit();

    const unsigned char* st = smem + rd * kStage;
#pragma unroll
    for (int s = 0; s < kBK / 32; ++s) {
      uint32_t a[kFT][2][4];  // [m16 tile][first, second mma of the step]
#pragma unroll
      for (int f = 0; f < kFT; ++f) {
        uint32_t lo[4], hi[4];  // weight rows g and g + 8 of the tile
        W::widen_bf16(*reinterpret_cast<const typename W::Frag*>(st + b_off[s] + 16 * f * kBRow), lo);
        W::widen_bf16(*reinterpret_cast<const typename W::Frag*>(st + b_off[s] + (16 * f + 8) * kBRow), hi);
        a[f][0][0] = lo[0], a[f][0][1] = hi[0], a[f][0][2] = lo[1], a[f][0][3] = hi[1];  // columns 8 t4 + 0..3
        a[f][1][0] = lo[2], a[f][1][1] = hi[2], a[f][1][2] = lo[3], a[f][1][3] = hi[3];  // columns 8 t4 + 4..7
      }
      // kTG row tiles at a time, both halves of the step across them: the
      // two products into one accumulator are kTG * kFT products apart.
#pragma unroll
      for (int t0 = 0; t0 < kTT; t0 += kTG) {
        uint4 xv[kTG];
#pragma unroll
        for (int u = 0; u < kTG; ++u) xv[u] = *reinterpret_cast<const uint4*>(st + a_off[s] + 8 * (t0 + u) * kARow);
#pragma unroll
        for (int u = 0; u < kTG; ++u)
#pragma unroll
          for (int f = 0; f < kFT; ++f) mma_bf16(acc[f][t0 + u], a[f][0], xv[u].x, xv[u].y);
#pragma unroll
        for (int u = 0; u < kTG; ++u)
#pragma unroll
          for (int f = 0; f < kFT; ++f) mma_bf16(acc[f][t0 + u], a[f][1], xv[u].z, xv[u].w);
      }
    }
    rd = rd == kStages - 1 ? 0 : rd + 1;
    wr = wr == kStages - 1 ? 0 : wr + 1;
  }
  cp_async_wait<0>();  // no copy outlives the block (the tail groups are empty)

  if (gridDim.z > 1) {
    constexpr int kTile = kBM * kBN;
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    // Partial tiles in fragment order: element e of thread t at e * threads + t.
    float* mine = partial + ((long long)blockIdx.z * gridDim.x * gridDim.y + tile) * kTile;
#pragma unroll
    for (int f = 0; f < kFT; ++f)
#pragma unroll
      for (int t = 0; t < kTT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) __stcg(mine + ((f * kTT + t) * 4 + e) * kGemmThreads + threadIdx.x, acc[f][t][e]);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      last = atomicAdd(counters + tile, 1) == (int)gridDim.z - 1;
      if (last) counters[tile] = 0;  // ready for the next launch
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    // Sum the partials (this block's too, back from L2) in split order.
#pragma unroll
    for (int f = 0; f < kFT; ++f)
#pragma unroll
      for (int t = 0; t < kTT; ++t) acc[f][t][0] = acc[f][t][1] = acc[f][t][2] = acc[f][t][3] = 0.f;
    for (int z = 0; z < (int)gridDim.z; ++z) {
      const float* pz = partial + ((long long)z * gridDim.x * gridDim.y + tile) * kTile + threadIdx.x;
#pragma unroll
      for (int f = 0; f < kFT; ++f)
#pragma unroll
        for (int t = 0; t < kTT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[f][t][e] += __ldcg(pz + ((f * kTT + t) * 4 + e) * kGemmThreads);
    }
  }

#pragma unroll
  for (int f = 0; f < kFT; ++f)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + warp * kWarpN + 16 * f + g + 8 * h;
      if (col >= o) continue;
      const float sc = scale[col];
#pragma unroll
      for (int t = 0; t < kTT; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = m0 + 8 * t + 2 * t4 + e;
          if (row < m) store_out<F32OUT>(out, (long long)row * o + col, acc[f][t][2 * h + e] * sc);
        }
    }
}

// The launch of one call: grid and K splits.
struct GemmPlan {
  dim3 grid;     // (M blocks, N blocks, splits)
  int k_per;     // k-tiles a split
  long long ws;  // bytes of fp32 partial tiles (0 without a split)
};

// Resident blocks per SM of one instantiation; raises its shared-memory
// limit first (once).
template <class W, bool F32OUT>
int gemm_blocks_per_sm() {
  static const int n = [] {
    constexpr int smem = kStages * gemm_stage_bytes<W>();
    cudaFuncSetAttribute(gemm_kernel<W, F32OUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gemm_kernel<W, F32OUT>, kGemmThreads, smem);
    return max(blocks, 1);
  }();
  return n;
}

// K is split only when the output tiles leave SMs idle: into the number of
// splits s that minimizes waves(tiles * s) * (k-tiles per split +
// kBlockCost) + (s - 1), the last term the last block's extra reads of
// partial tiles (about one k-tile's time each).
template <class W, bool F32OUT>
GemmPlan gemm_plan(int m, int o, int d) {
  const int mb = (m + kBM - 1) / kBM, nb = (o + kBN - 1) / kBN;
  const int tiles = mb * nb, k_tiles = (d + kBK - 1) / kBK;
  const int slots = sm_count() * gemm_blocks_per_sm<W, F32OUT>();
  auto cost = [&](int s, int per) {
    return (long long)((tiles * s + slots - 1) / slots) * (per + kBlockCost) + (s - 1);
  };
  int splits = 1, k_per = k_tiles;
  if (tiles < slots && tiles <= kMaxSplitTiles) {
    long long best = cost(1, k_tiles);
    for (int s = 2; s <= min(kMaxSplits, k_tiles / kMinSplitKTiles); ++s) {
      const int per = (k_tiles + s - 1) / s, used = (k_tiles + per - 1) / per;
      if (cost(used, per) < best) best = cost(used, per), splits = used, k_per = per;
    }
  }
  const long long ws = splits > 1 ? (long long)splits * tiles * kBM * kBN * 4 : 0;
  return {dim3(mb, nb, splits), k_per, ws};
}

template <class W, bool F32OUT>
cudaError_t launch_gemm(const bf16* x, long long x_stride, const uint8_t* w, const float* scale,
                        void* out, int m, int o, int d, void* workspace, int* counters, cudaStream_t stream) {
  const GemmPlan p = gemm_plan<W, F32OUT>(m, o, d);  // also raises the shared-memory limit
  if (p.ws && (!workspace || !counters)) return cudaErrorInvalidValue;
  gemm_kernel<W, F32OUT><<<p.grid, kGemmThreads, kStages * gemm_stage_bytes<W>(), stream>>>(
      x, x_stride, w, scale, out, m, o, d, p.k_per, static_cast<float*>(workspace), counters);
  return cudaGetLastError();
}

template <class W, bool F32OUT>
cudaError_t dispatch(const bf16* x, long long x_stride, const uint8_t* w, const float* scale,
                     void* out, int m, int o, int d, void* ws, int* counters, cudaStream_t st) {
  if (m > kGemvMaxRows) return launch_gemm<W, F32OUT>(x, x_stride, w, scale, out, m, o, d, ws, counters, st);
  if (m == 1) return launch_gemv<W, 1, F32OUT>(x, x_stride, w, scale, out, m, o, d, st);
  if (m == 2) return launch_gemv<W, 2, F32OUT>(x, x_stride, w, scale, out, m, o, d, st);
  if (m <= 4) return launch_gemv<W, 4, F32OUT>(x, x_stride, w, scale, out, m, o, d, st);
  return launch_gemv<W, 8, F32OUT>(x, x_stride, w, scale, out, m, o, d, st);
}

template <class W>
int run(const void* x, const void* w, const void* scale, void* out, int m, int o, int d,
        long long x_stride, int out_f32, void* ws, void* counters, void* stream) {
  if (m < 1 || o < 1 || d < W::kColsPerVec || d % W::kColsPerVec) return cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  int* cp = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_f32 ? dispatch<W, true>(xp, x_stride, wp, sp, out, m, o, d, ws, cp, st)
                 : dispatch<W, false>(xp, x_stride, wp, sp, out, m, o, d, ws, cp, st);
}

template <class W>
long long workspace_bytes(int m, int o, int d, int out_f32) {
  if (m <= kGemvMaxRows || o < 1 || d < W::kColsPerVec) return 0;
  return out_f32 ? gemm_plan<W, true>(m, o, d).ws : gemm_plan<W, false>(m, o, d).ws;
}

}  // namespace

// x (M, D) bf16 with row stride x_stride (elements, a multiple of 8, rows
// 16-byte aligned); w (O, D) int8 and scale (O,) fp32, contiguous; out (M, O)
// contiguous, fp32 if out_f32 else bf16. D is a multiple of 16. A call that
// splits K (pg_quant_matmul_workspace > 0) also takes `workspace`, of that
// many bytes, and `counters`, kMaxSplitTiles (4096) ints that are zero
// before the first such call and that every call leaves at zero; calls that
// share the counters must not run at the same time. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int pg_q8_matmul(const void* x, const void* w, const void* scale, void* out, int m, int o,
                            int d, long long x_stride, int out_f32, void* workspace, void* counters,
                            void* stream) {
  return run<Int8Rows>(x, w, scale, out, m, o, d, x_stride, out_f32, workspace, counters, stream);
}

// As pg_q8_matmul with w (O, D/2) packed int4 (ops/quant.py::pack_int4); D
// is a multiple of 32.
extern "C" int pg_q4_matmul(const void* x, const void* w, const void* scale, void* out, int m, int o,
                            int d, long long x_stride, int out_f32, void* workspace, void* counters,
                            void* stream) {
  return run<Int4Rows>(x, w, scale, out, m, o, d, x_stride, out_f32, workspace, counters, stream);
}

// Bytes of the split-K workspace that pg_q8_matmul (int4 = 0) or
// pg_q4_matmul (int4 = 1) needs for this call on the current device; 0 if
// it does not split K.
extern "C" long long pg_quant_matmul_workspace(int m, int o, int d, int int4, int out_f32) {
  return int4 ? workspace_bytes<Int4Rows>(m, o, d, out_f32) : workspace_bytes<Int8Rows>(m, o, d, out_f32);
}

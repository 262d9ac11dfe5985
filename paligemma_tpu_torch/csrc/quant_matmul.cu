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
// 16-byte weight vector holds 16 int8 or 32 int4 columns, widened exactly
// to bf16 on the way in, and both tilings run on mma.sync as W x^T. The
// int4 layout is the port's (ops/quant.py::pack_int4): within each group of
// 8 columns, byte 4i + k holds column 8i + k in its low nibble and
// 8i + 4 + k in its high nibble.
//
// What bounds it on the H100:
//   - decode (M = 1): the weight bytes. One byte per weight at 3.35 TB/s
//     for int8, e.g. 20.0 us for gate_up (32768 x 2048) and 157 us for the
//     lm_head; half a byte for int4 (gate_up 10.0 us). The arithmetic is 2
//     flop per int8 byte (4 per int4 byte), far below the card's ridge,
//     but the widening is several instructions per 4 weights, so the issue
//     rate is close behind the byte rate. The small projections (qkv, o:
//     1-5 MB) are bound by a launch's fixed cost and one memory latency.
//   - prefill (M ~ 276, and SigLIP's 256 rows): the tensor cores, at
//     2 * M * O * D flop (1.09 TFLOP over the 18 decoder layers, 1.1 ms at
//     989 TFLOP/s bf16).
// The design:
//   - GEMV tiling for M <= 64 (gemv_kernel): a warp owns 16 output rows,
//     the mma's A operand, and the rows of x are its B operand in 1, 2, 4
//     or 8 n8 tiles, so each weight byte is read and widened once for all
//     rows of x. The weights stream through a per-warp cp.async ring (4
//     stages of 128 bytes a row) with no block barrier; x is read through
//     L1 (at M <= 8, a step's x before its weights are waited for). While
//     the 16-row tiles give fewer than 8 warps an SM (qkv, o, down at
//     decode), K is split over the warps of a block (ksplit = 2, 4 or 8,
//     chosen on the host from O and D) and the partial tiles are added in
//     shared memory in split order.
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
//   - What bounds the GEMM now (measured on the H100): latency more than
//     issue. The loop runs ~4 instructions an mma (the widening and the
//     copies beside it) at ~12 clocks an mma on each scheduler, with 2
//     warps a scheduler (180-188 registers): gate_up at 276 rows is about
//     2x F.linear on a bf16 copy. 989 TFLOP/s is the wgmma rate; wgmma and
//     TMA copies are later work.
//   - What bounds the GEMV now (measured on the H100, M = 1): gate_up and
//     down reach 63-80% of their byte floors, the lm_head 90%; the int8
//     widening (~10 instructions per 4 weights) runs after each stage
//     lands, so the small projections (qkv, o: 1-2 steps a warp) end in a
//     chain of widening, products and the split's sum after the last
//     bytes arrive. At 64 rows the products and x's reads through L1 (x
//     re-read by every 16-row warp tile) bound it.
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
  // Eight consecutive columns as the bf16 pairs (0,1) (2,3) (4,5) (6,7).
  using Frag = uint2;
  static __device__ __forceinline__ void widen_bf16(const Frag& v, uint32_t* b) {
    s8x4_to_bf16x2(v.x, b);
    s8x4_to_bf16x2(v.y, b + 2);
  }
  // GEMV: a 16-byte vector as the bf16 pairs of its columns, in order.
  static constexpr int kPieceRegs = 8;
  static __device__ __forceinline__ void widen_piece(const uint4& v, uint32_t* b) {
    widen_bf16(make_uint2(v.x, v.y), b);
    widen_bf16(make_uint2(v.z, v.w), b + 4);
  }
};

// int4, two per byte in the port's packing.
struct Int4Rows {
  static constexpr int kColsPerVec = 32;
  static constexpr int kColsPerByte = 2;
  // The eight columns of one word as the bf16 pairs (0,1) (2,3) (4,5) (6,7)
  // of q: columns k and 4 + k are the low and high nibble of byte k.
  using Frag = uint32_t;
  static __device__ __forceinline__ void widen_bf16(const Frag& w, uint32_t* b) {
    const uint32_t hi = w >> 4;
    b[0] = nibbles_to_bf16x2(__byte_perm(w, 0u, 0x4140));
    b[1] = nibbles_to_bf16x2(__byte_perm(w, 0u, 0x4342));
    b[2] = nibbles_to_bf16x2(__byte_perm(hi, 0u, 0x4140));
    b[3] = nibbles_to_bf16x2(__byte_perm(hi, 0u, 0x4342));
  }
  static constexpr int kPieceRegs = 16;
  static __device__ __forceinline__ void widen_piece(const uint4& v, uint32_t* b) {
    widen_bf16(v.x, b);
    widen_bf16(v.y, b + 4);
    widen_bf16(v.z, b + 8);
    widen_bf16(v.w, b + 12);
  }
};

// ---------------------------------------------------------------------------
// GEMV tiling (M <= 64), tensor cores
// ---------------------------------------------------------------------------

constexpr int kGemvMaxRows = 64;
constexpr int kGemvWarps = 8;
constexpr int kGemvThreads = 32 * kGemvWarps;
constexpr int kGemvStep = 128;   // bytes of each weight row a ring stage holds

// A warp's ring: 3 stages of int8 rows, 2 of int4 rows (a step holds twice
// the columns, so twice the widening and products a stage).
template <class W>
__host__ __device__ constexpr int gemv_stages() {
  return W::kColsPerByte == 1 ? 3 : 2;
}
template <class W>
__host__ __device__ constexpr int gemv_warp_bytes() {
  return gemv_stages<W>() * 16 * kGemvStep;
}

// y[0..m, rows] of x (M, D) @ W (O, D)^T * scale on mma.sync m16n8k16,
// computed as W x^T: the widened weights are the A operand (16 output rows
// a warp) and the rows of x the B operand, NT n8 tiles (8 NT >= M). Each
// weight byte is read and widened once for all the rows of x.
//
// Weights: each warp streams its 16 rows through its own cp.async ring in
// shared memory, gemv_stages<W>() steps of kGemvStep bytes a row deep; a copy
// instruction moves 512 contiguous bytes of rows (whole 128-byte lines),
// and the warp waits only on its own copies (no block barrier). A step's
// 16-byte chunk c of row r is stored at chunk c ^ 4 (r & 1), so that the
// fragment loads are free of bank conflicts.
//
// k order: a step is a run of quarters of 4 chunks (64 int8 or 128 int4
// columns each); in each, thread (g = lane / 4, t4 = lane % 4) takes chunk
// t4 of rows g and g + 8, widened in column order to kPieceRegs bf16 pairs,
// and the same columns of x row 8 nt + g (32 or 64 bytes, read through L1;
// with one n8 tile, a step's x before its weights are waited for). The
// pairs 2t, 2t + 1 are the thread's k 2t4 (+1), 2t4 + 8 (+1) of the
// quarter's product t: the same permutation for W and x.
//
// Split K: a block holds kGemvWarps / ksplit output tiles of 16 rows, each
// taken by ksplit = 1 << ks_log2 warps over consecutive ranges of steps;
// the ksplit partial tiles are added in shared memory (beside the rings)
// in split order. Blocks an SM: 3 with one n8 tile (at most 85 registers),
// else 2.
template <class W, int NT, bool F32OUT>
__global__ void __launch_bounds__(kGemvThreads, NT == 1 ? 3 : 2)
    gemv_kernel(const bf16* __restrict__ x, long long x_stride, const uint8_t* __restrict__ w,
                const float* __restrict__ scale, void* __restrict__ out, int m, int o, int d, int ks_log2) {
  constexpr int kR = W::kPieceRegs;  // 32-bit registers of a widened chunk, and of x's columns
  constexpr int kPieceCols = W::kColsPerVec;
  constexpr int kChunks = kGemvStep / 16;    // 16-byte chunks of a row a step
  constexpr int kQuarters = kGemvStep / 64;  // runs of 4 chunks a step
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int ksplit = 1 << ks_log2, ks = warp & (ksplit - 1);
  const int row0 = ((blockIdx.x * kGemvWarps + warp) >> ks_log2) * 16;
  const int row_bytes = d / W::kColsPerByte;
  const int steps = (row_bytes + kGemvStep - 1) / kGemvStep;
  const int per = (steps + ksplit - 1) >> ks_log2;
  const int s0 = ks * per, n = max(0, min(steps, s0 + per) - s0);  // this warp's steps
  constexpr int kStagesW = gemv_stages<W>();
  const unsigned ring = static_cast<unsigned>(__cvta_generic_to_shared(smem)) + warp * gemv_warp_bytes<W>();

  // The copies: copy j of lane l moves chunk (32 j + l) % kChunks of row
  // (32 j + l) / kChunks of each step. Rows past O are read as the last row
  // (their outputs are not stored).
  constexpr int kCopies = 16 * kChunks / 32;
  const uint8_t* src[kCopies];
  unsigned dst[kCopies];
  int col_byte[kCopies];
#pragma unroll
  for (int j = 0; j < kCopies; ++j) {
    const int r = (32 * j + lane) / kChunks, c = (32 * j + lane) % kChunks;
    src[j] = w + (long long)min(row0 + r, o - 1) * row_bytes + 16 * c;
    dst[j] = r * kGemvStep + 16 * (c ^ 4 * (r & 1));
    col_byte[j] = 16 * c;
  }
  auto issue = [&](int i) {  // step i of this warp into its stage
    if (i < n) {
      const int at = (s0 + i) * kGemvStep;
      const unsigned stage = ring + (i % kStagesW) * 16 * kGemvStep;
#pragma unroll
      for (int j = 0; j < kCopies; ++j) {
        const bool ok = at + col_byte[j] < row_bytes;  // chunks past D are zero-filled
        cp_async16(stage + dst[j], ok ? src[j] + at : src[j], ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStagesW - 1; ++i) issue(i);
  // The scales of this thread's output rows, read ahead of the epilogue.
  const float sc[2] = {scale[min(row0 + g, o - 1)], scale[min(row0 + g + 8, o - 1)]};

  // x's 16-byte pieces of this thread's columns of quarter q of step i,
  // row 8 nt + g (zeros past M or D, or past this warp's steps).
  auto load_x = [&](int i, int q, int nt, uint32_t* xv) {
    const int r = 8 * nt + g;
    const int col = ((s0 + i) * kGemvStep + 64 * q) * W::kColsPerByte + t4 * kPieceCols;
    if (i < n && r < m && col < d) {
      const uint4* xp = reinterpret_cast<const uint4*>(x + (long long)r * x_stride + col);
#pragma unroll
      for (int e = 0; e < kR / 4; ++e) reinterpret_cast<uint4*>(xv)[e] = __ldg(xp + e);
    } else {
#pragma unroll
      for (int e = 0; e < kR; ++e) xv[e] = 0;
    }
  };

  // With one n8 tile, the products of a quarter alternate between two
  // accumulators (added at the end), which halves their dependent chain.
  constexpr int kAcc = NT == 1 ? 2 : 1;
  float acc[NT][4], acc2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int i = 0; i < n; ++i) {
    // With one n8 tile, x of the whole step is read before the wait.
    uint32_t x_step[kQuarters][kR];
    if (NT == 1) {
#pragma unroll
      for (int q = 0; q < kQuarters; ++q) load_x(i, q, 0, x_step[q]);
    }
    cp_async_wait<kStagesW - 2>();  // step i has landed (this lane's copies)
    __syncwarp();                      // ... every lane's; and the stage read last step is free
    issue(i + kStagesW - 1);
    const unsigned stage = ring + (i % kStagesW) * 16 * kGemvStep;
#pragma unroll
    for (int q = 0; q < kQuarters; ++q) {
      const int c = (4 * q + t4) ^ 4 * (g & 1);
      const uint4 lo_raw = ld_shared128(stage + g * kGemvStep + 16 * c);
      const uint4 hi_raw = ld_shared128(stage + (g + 8) * kGemvStep + 16 * c);
      uint32_t lo[kR], hi[kR];
      W::widen_piece(lo_raw, lo);
      W::widen_piece(hi_raw, hi);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t xv[kR];
        if (NT == 1) {
#pragma unroll
          for (int e = 0; e < kR; ++e) xv[e] = x_step[q][e];
        } else {
          load_x(i, q, nt, xv);
        }
#pragma unroll
        for (int t = 0; t < kR / 2; ++t) {
          const uint32_t a[4] = {lo[2 * t], hi[2 * t], lo[2 * t + 1], hi[2 * t + 1]};
          mma_bf16(kAcc == 2 && (t & 1) ? acc2 : acc[nt], a, xv[2 * t], xv[2 * t + 1]);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the loop (the tail groups are empty)
  if (kAcc == 2) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][e] += acc2[e];
  }

  if (ksplit > 1) {
    float* red = reinterpret_cast<float*>(smem + kGemvWarps * gemv_warp_bytes<W>());  // [warp][NT * 4][lane]
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[((warp * NT + nt) * 4 + e) * 32 + lane] = acc[nt][e];
    __syncthreads();
    if (ks != 0) return;
#pragma unroll
    for (int s = 1; s < kGemvWarps; ++s) {
      if (s >= ksplit) break;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] += red[(((warp + s) * NT + nt) * 4 + e) * 32 + lane];
    }
  }
  // acc[nt]: output rows row0 + g (+ 8), rows of x 8 nt + 2 t4 (+ 1).
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= o) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * nt + 2 * t4 + e;
        if (r < m) store_out<F32OUT>(out, (long long)r * o + row, acc[nt][2 * h + e] * sc[h]);
      }
  }
}

// Warps of a block on one output tile, as a power of two: the smallest (at
// most kGemvWarps) that gives every SM kGemvWarps warps, while each warp
// keeps at least one step of K.
template <class W>
int gemv_split_log2(int o, int d) {
  const long long tiles = (o + 15) / 16;
  const int steps = (d / W::kColsPerByte + kGemvStep - 1) / kGemvStep;
  int lg = 0;
  while ((1 << lg) < kGemvWarps && tiles << lg < (long long)sm_count() * kGemvWarps && steps >= 2 << lg) ++lg;
  return lg;
}

template <class W, int NT, bool F32OUT>
cudaError_t launch_gemv(const bf16* x, long long x_stride, const uint8_t* w, const float* scale,
                        void* out, int m, int o, int d, cudaStream_t stream) {
  // The rings, then the split's partial tiles (fp32, a warp's NT x 4 x 32).
  constexpr int kSmem = kGemvWarps * (gemv_warp_bytes<W>() + NT * 4 * 32 * 4);
  static const cudaError_t attr =
      cudaFuncSetAttribute(gemv_kernel<W, NT, F32OUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  const int lg = gemv_split_log2<W>(o, d);
  const int tiles_per_block = kGemvWarps >> lg;
  const int tiles = (o + 15) / 16;
  gemv_kernel<W, NT, F32OUT><<<(tiles + tiles_per_block - 1) / tiles_per_block, kGemvThreads, kSmem, stream>>>(
      x, x_stride, w, scale, out, m, o, d, lg);
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
  if (m <= 8) return launch_gemv<W, 1, F32OUT>(x, x_stride, w, scale, out, m, o, d, st);
  if (m <= 16) return launch_gemv<W, 2, F32OUT>(x, x_stride, w, scale, out, m, o, d, st);
  if (m <= 32) return launch_gemv<W, 4, F32OUT>(x, x_stride, w, scale, out, m, o, d, st);
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

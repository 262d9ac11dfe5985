// Bidirectional flash attention with GQA and LengthMask visibility, bf16 in
// and out, fp32 accumulation, on the tensor cores (mma.sync m16n8k16).
//
// Replaces: paligemma_tpu/ops/pallas_attention.py::flash_attention (kernel
// body _flash_kernel). Same arithmetic: scores = (q . k) * scale in fp32,
// masked scores set to NEG_INF, online softmax per query row with the
// masked probabilities zeroed (a fully masked kv tile adds nothing, not
// exp(0) = 1s), unnormalized P rounded to bf16 before the PV product, fp32
// accumulator, output = acc / l (as acc times 1 / l). The exponentials are
// taken in base 2, with log2(e) folded into the scale.
//
// Shapes on the main path (PaliGemma-3B-224): SigLIP T = S = 256, H = Hkv =
// 16, D = 72 (27 calls per prefill); Gemma prefill T = S ~ 276, H = 8,
// Hkv = 1, D = 256 (18 calls). The 448- and 896-px presets make the same
// calls at T = S ~ 1024 and ~ 4096.
//
// What bounds it on the H100: at the main-path sizes K/V of one head is at
// most 140 KB and stays in L2, and a call is 0.3-0.6 GFLOP, so the kernel is
// bound by latency (the first copies, barriers, the softmax between the two
// products, the epilogue) and by shared-memory reads (every warp reads all
// of K and V for its 16 rows), not by bytes or tensor-core rate. The design:
//   - blocks of 4 warps; each warp owns 16 query rows: their scores, softmax
//     statistics and output accumulators live in its registers, in the mma
//     fragment layouts, so the softmax needs only shuffles within a lane
//     quad and P goes from the score accumulators straight into the A
//     operand of the PV product;
//   - two tilings, chosen per call from T and the heads (never the batch,
//     so a row gives the same bits at every batch size). While blocks of
//     64 query rows of one batch row would leave SMs idle (the main path:
//     64 blocks for SigLIP, 40 for Gemma, on 132 SMs), a block takes 32
//     query rows (128 and 72 blocks a batch row) and 64-row kv tiles, and
//     the two warps of a row pair each take 32 of a tile's columns: they
//     exchange each tile's row maxima through shared memory and keep one
//     running maximum, each its own row sums and accumulators, and at the
//     end one adds the other's (l, acc) to its own, through shared memory
//     (one launch, no workspace). With one running maximum every P is
//     rounded against the maximum of every column so far, as a single warp
//     over the tile would round it. Once one batch row's blocks fill
//     the card (the long presets), a block takes 64 query rows and 32-row
//     kv tiles, and as many blocks share an SM as fit;
//   - the TPU kernel's sequential k-block grid axis becomes a loop over kv
//     tiles that arrive through a 2-stage cp.async ring: the copies of tile
//     i + 1 are issued before tile i's products, K and V in separate commit
//     groups, so a warp waits for K before Q K^T and for V only before the
//     PV product (V lands during the softmax);
//   - operands come from shared memory by ldmatrix: x4 for Q (the A
//     operand, held in registers across kv tiles up to D = 128) and for K
//     (the B operand of Q K^T), x4.trans for V (the B operand of P V);
//   - head_dim is padded inside the tiles to DP, the next multiple of 16
//     (SigLIP's 72 -> 80); the copies zero-fill the padded columns and the
//     rows past S themselves (a source size of 0), so the padding adds
//     nothing to the scores and is never stored; one instantiation per DP
//     keeps every accumulator index static (registers, no spills);
//   - shared-memory rows are DP + 8 bf16 long, which puts the 8 rows that
//     one ldmatrix phase reads on disjoint banks;
//   - ragged T and S edges are masked in the kernel (rows past T are not
//     stored, kv columns past S are invisible); nothing is padded in
//     memory. A tile whose every column is visible skips the mask;
//   - the output goes through the block's Q rows in shared memory and out
//     in 16-byte stores by a rolled loop: the unrolled 4-byte stores and
//     divisions it replaces took a third of a Gemma call.
// wgmma/TMA and warp specialisation are later work.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;  // K/V ring depth
constexpr int kWarpCols = 32;  // kv columns a warp takes of each tile
constexpr int kNT = kWarpCols / 8;  // its score n-tiles
constexpr float kLog2e = 1.4426950408889634f;

struct FlashParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const int* valid;  // (B,) or null (all S visible)
  int t, s, h, hkv, d;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int win0, win1;
  float scale;
};

// kRowWarps warps of 16 query rows each, times kSplit warps that share
// those rows and take kWarpCols kv columns each of every kBlockK-row tile.
template <int DP, int kRowWarps>
struct Tiles {
  static constexpr int kSplit = kWarps / kRowWarps;
  static constexpr int kBlockQ = 16 * kRowWarps;  // query rows a block
  static constexpr int kBlockK = kWarpCols * kSplit;  // kv rows a tile
  static constexpr int kLds = DP + 8;               // shared row stride (bf16)
  static constexpr int kQBytes = kBlockQ * kLds * 2;
  static constexpr int kKVBytes = kBlockK * kLds * 2;  // one K or V tile
  // The tile maxima the split warps exchange: per warp, per lane, 2 rows.
  static constexpr int kMaxBytes = kSplit > 1 ? kWarps * 2 * 32 * 4 : 0;
  static constexpr int kSmem = kQBytes + 2 * kStages * kKVBytes + kMaxBytes;
  // Blocks an SM must hold: 4 for the long-sequence tiling up to D = 80
  // (at most 128 registers, so that the long presets' SigLIP calls keep 16
  // warps an SM); else as many as registers and shared memory allow.
  static constexpr int kMinBlocks = kRowWarps == 4 && DP <= 80 ? 4 : 1;
  // The merge of the split warps' partial results (over the K/V stages).
  static_assert((kSplit - 1) * kRowWarps * (DP / 2 + 4) * 32 * 4 <= 2 * kStages * kKVBytes, "merge space");
};

// The cp.async copies of a tile of kRows rows (head_dim d, padded to DP) into
// shared rows of DP + 8 bf16: thread i copies the 16-byte chunk i % kC of
// rows i / kC + j * kRowsPer, j = 0, 1, ..; threads past kRowsPer * kC idle.
// Chunks at or past d, and rows at or past `rows`, are zero-filled by the
// copy itself (a source size of 0).
template <int DP, int kRows>
struct TileCopies {
  static constexpr int kC = DP / 8;  // chunks a row
  static constexpr int kRowsPer = kThreads / kC;
  static constexpr int kPasses = (kRows + kRowsPer - 1) / kRowsPer;
  static_assert(kRowsPer >= 1, "a block copies at least one row a pass");
  int r0;        // this thread's first row, kRows if it idles
  int col;       // its chunk's column (bf16), 0 for a padding chunk
  int bytes;     // 16, or 0 for a padding chunk
  unsigned dst;  // shared byte offset of its first chunk within a tile

  __device__ __forceinline__ explicit TileCopies(int d) {
    const int i = threadIdx.x, c = (i % kC) * 8;
    r0 = i < kRowsPer * kC ? i / kC : kRows;
    col = c < d ? c : 0;
    bytes = c < d ? 16 : 0;
    dst = (r0 * (DP + 8) + c) * 2;
  }

  // Rows [0, rows) of `src` (row stride `stride`) into the tile at shared
  // address `tile`.
  __device__ __forceinline__ void issue(unsigned tile, const bf16* src, long long stride, int rows) const {
    if (r0 >= kRows) return;
    const bf16* at = src + r0 * stride + col;
    const long long step = kRowsPer * stride;
    if (rows >= kRows) {  // every row inside
#pragma unroll
      for (int j = 0; j < kPasses; ++j, at += step) {
        if ((j + 1) * kRowsPer <= kRows || r0 + j * kRowsPer < kRows)
          cp_async16(tile + dst + j * kRowsPer * (DP + 8) * 2, at, bytes);
      }
    } else {
      const int left = rows - r0;
#pragma unroll
      for (int j = 0; j < kPasses; ++j, at += step) {
        if ((j + 1) * kRowsPer <= kRows || r0 + j * kRowsPer < kRows) {
          const bool ok = j * kRowsPer < left;
          cp_async16(tile + dst + j * kRowsPer * (DP + 8) * 2, ok ? at : src, ok ? bytes : 0);
        }
      }
    }
  }
};

template <int DP, int kRowWarps>
__global__ void __launch_bounds__(kThreads, (Tiles<DP, kRowWarps>::kMinBlocks))
    flash_attention_kernel(FlashParams p) {
  using T = Tiles<DP, kRowWarps>;
  constexpr int kLds = T::kLds, kBlockK = T::kBlockK;
  constexpr int kKSteps = DP / 16;
  constexpr int kDTiles = DP / 8;
  constexpr bool kQInRegs = DP <= 128;  // Q fragments held across kv tiles
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned q_s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned kv_s = q_s + T::kQBytes;  // stage i: K at + 2i kKVBytes, V after it

  const int qt = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int hk = hi / (p.h / p.hkv);
  const int q0 = qt * T::kBlockQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = warp % kRowWarps, sp = warp / kRowWarps;  // query rows rw, kv columns sp of a tile
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group, thread in group
  const int valid = p.valid ? p.valid[bi] : p.s;
  const int n_tiles = (p.s + kBlockK - 1) / kBlockK;
  const int full_end = min(valid, p.s);  // the columns below are visible

  const bf16* kb = p.k + bi * p.k_sb + hk * p.k_sh;
  const bf16* vb = p.v + bi * p.v_sb + hk * p.v_sh;
  const TileCopies<DP, kBlockK> kv_copies(p.d);

  // Prologue: Q, then the first kStages - 1 tiles; Q, each K and each V a
  // commit group (empty past the last tile, so the counts of pending groups
  // below hold at every tile).
  TileCopies<DP, T::kBlockQ>(p.d).issue(q_s, p.q + bi * p.q_sb + hi * p.q_sh + q0 * p.q_st, p.q_st,
                                         p.t - q0);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) kv_copies.issue(kv_s + 2 * i * T::kKVBytes, kb + i * kBlockK * p.k_ss, p.k_ss,
                                     p.s - i * kBlockK);
    cp_async_commit();
    if (i < n_tiles) kv_copies.issue(kv_s + (2 * i + 1) * T::kKVBytes, vb + i * kBlockK * p.v_ss,
                                     p.v_ss, p.s - i * kBlockK);
    cp_async_commit();
  }

  // ldmatrix row addresses of this lane. A (Q, 16 rows x 16 k): matrices
  // (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15,
  // k 8-15) = a[0..3]. K (B of Q K^T): (kv 0-7, d 0-7), (kv 0-7, d 8-15),
  // (kv 8-15, d 0-7), (kv 8-15, d 8-15) = b0, b1 of n-tiles 2jj and 2jj + 1.
  // V (B of P V, transposed): (kv 0-7, d 0-7), (kv 8-15, d 0-7), (kv 0-7,
  // d 8-15), (kv 8-15, d 8-15) = b0, b1 of d-tiles 2jj and 2jj + 1. K and V
  // from this warp's kv columns of the tile.
  const int mi = lane >> 3, r8 = lane & 7;
  const unsigned q_addr = q_s + ((rw * 16 + (mi & 1) * 8 + r8) * kLds + (mi >> 1) * 8) * 2;
  const unsigned k_off = ((sp * kWarpCols + (mi >> 1) * 8 + r8) * kLds + (mi & 1) * 8) * 2;
  const unsigned v_off = ((sp * kWarpCols + (mi & 1) * 8 + r8) * kLds + (mi >> 1) * 8) * 2;

  uint32_t qf[kQInRegs ? kKSteps : 1][4];
  if constexpr (kQInRegs) {
    cp_async_wait<2 * (kStages - 1)>();  // Q has landed
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) ldmatrix_x4(qf[ks], q_addr + ks * 32);
  }
  float o_acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) o_acc[j][0] = o_acc[j][1] = o_acc[j][2] = o_acc[j][3] = 0.f;
  // Rows g and g + 8: running maximum (base 2) and this thread's share of
  // the row sum (its columns only; the quad's shares are added at the end).
  float m_i[2] = {PG_NEG_INF, PG_NEG_INF}, l_i[2] = {0.f, 0.f};
  const float scale2 = p.scale * kLog2e;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    const unsigned k_tile = kv_s + 2 * (kt % kStages) * T::kKVBytes, v_tile = k_tile + T::kKVBytes;
    cp_async_wait<2 * kStages - 3>();  // K of tile kt has landed (this thread's copies)
    __syncthreads();                   // ... every thread's; tile kt - 1 is no longer read
    {
      const int nt = kt + kStages - 1;  // into the stage tile kt - 1 used
      const unsigned nk = kv_s + 2 * (nt % kStages) * T::kKVBytes;
      if (nt < n_tiles) kv_copies.issue(nk, kb + nt * kBlockK * p.k_ss, p.k_ss, p.s - nt * kBlockK);
      cp_async_commit();
      if (nt < n_tiles) kv_copies.issue(nk + T::kKVBytes, vb + nt * kBlockK * p.v_ss, p.v_ss, p.s - nt * kBlockK);
      cp_async_commit();
    }

    // S = Q K^T for this warp's 16 rows and kWarpCols kv columns.
    float s_acc[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s_acc[j][0] = s_acc[j][1] = s_acc[j][2] = s_acc[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      uint32_t a[4];
      if constexpr (kQInRegs) {
        a[0] = qf[ks][0], a[1] = qf[ks][1], a[2] = qf[ks][2], a[3] = qf[ks][3];
      } else {
        ldmatrix_x4(a, q_addr + ks * 32);
      }
#pragma unroll
      for (int jj = 0; jj < kNT / 2; ++jj) {
        uint32_t b[4];
        ldmatrix_x4(b, k_tile + k_off + (jj * 16 * kLds + ks * 16) * 2);
        mma_16816(s_acc[2 * jj], a, b[0], b[1]);
        mma_16816(s_acc[2 * jj + 1], a, b[2], b[3]);
      }
    }

    // Online softmax in base 2. Element e of n-tile j sits at row g (e < 2)
    // or g + 8 (e >= 2) and kv column 8j + 2 t4 + (e & 1) of the warp's
    // columns; a row's columns are spread over the 4 lanes of a quad. A
    // tile with an invisible column sets it to NEG_INF.
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[j][e] *= scale2;
    }
    if (k0 + kBlockK > full_end) {
      const int c0 = k0 + sp * kWarpCols + 2 * t4;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!kv_visible(c0 + 8 * j + (e & 1), p.s, valid, p.win0, p.win1)) s_acc[j][e] = PG_NEG_INF;
        }
      }
    }
    float mx[2] = {PG_NEG_INF, PG_NEG_INF};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s_acc[j][0], s_acc[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s_acc[j][2], s_acc[j][3]));
    }
    // The masked probabilities are zeroed: exp2(NEG_INF - m) is exactly 0
    // for any real row maximum m, and a row with no visible column yet (m =
    // NEG_INF) takes its exponentials against 0 instead, never exp2(0) = 1.
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    if constexpr (T::kSplit > 1) {
      // The warps that split a tile's columns for the same rows take one
      // running maximum: the tile's over all its columns, as one warp over
      // the whole tile would. So every warp rounds its P against the same
      // maximum, and the merge below rescales nothing. (The slots are free
      // again: every read of the last tile's came before its V barrier.)
      float* xs = reinterpret_cast<float*>(smem + T::kQBytes + 2 * kStages * T::kKVBytes);
      xs[(warp * 2) * 32 + lane] = mx[0];
      xs[(warp * 2 + 1) * 32 + lane] = mx[1];
      __syncthreads();
#pragma unroll
      for (int o = 0; o < T::kSplit; ++o) {
        const int w = rw + o * kRowWarps;
        mx[0] = fmaxf(mx[0], xs[(w * 2) * 32 + lane]);
        mx[1] = fmaxf(mx[1], xs[(w * 2 + 1) * 32 + lane]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_i[r], mx[r]);
      alpha[r] = exp2f(m_i[r] - m_new);
      m_i[r] = m_new;
      m_use[r] = m_new == PG_NEG_INF ? 0.f : m_new;
      l_i[r] *= alpha[r];
    }
    uint32_t pf[kNT / 2][4];  // bf16(P) as the A operand of P V, 16 kv columns each
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pv[e] = exp2f(s_acc[j][e] - m_use[e >> 1]);
        l_i[e >> 1] += pv[e];
      }
      pf[j >> 1][(j & 1) * 2] = pack_bf16(pv[0], pv[1]);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
    }
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      o_acc[j][0] *= alpha[0];
      o_acc[j][1] *= alpha[0];
      o_acc[j][2] *= alpha[1];
      o_acc[j][3] *= alpha[1];
    }

    cp_async_wait<2 * kStages - 2>();  // V of tile kt has landed
    __syncthreads();
    // O += bf16(P) V.
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
#pragma unroll
      for (int jj = 0; jj < kDTiles / 2; ++jj) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, v_tile + v_off + (kk * 16 * kLds + jj * 16) * 2);
        mma_16816(o_acc[2 * jj], pf[kk], b[0], b[1]);
        mma_16816(o_acc[2 * jj + 1], pf[kk], b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (the tail groups are empty)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
  }
  if constexpr (T::kSplit > 1) {
    // Merge: the warps of kv columns sp > 0 leave (m, l, acc) in shared
    // memory (over the K/V stages, lane-major: conflict-free), and warp sp
    // = 0 of the same rows, whose lanes hold the same fragment positions,
    // adds them in order (each part rescaled to the larger maximum: the
    // maxima are equal, the shared running maximum's, so by exactly 1).
    constexpr int kPart = (DP / 2 + 4) * 32;  // floats a warp leaves
    float* parts = reinterpret_cast<float*>(smem + T::kQBytes);
    __syncthreads();  // every warp is done with the last tile
    if (sp > 0) {
      float* mine = parts + ((sp - 1) * kRowWarps + rw) * kPart + lane;
#pragma unroll
      for (int j = 0; j < kDTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(4 * j + e) * 32] = o_acc[j][e];
      }
      mine[(4 * kDTiles) * 32] = m_i[0], mine[(4 * kDTiles + 1) * 32] = m_i[1];
      mine[(4 * kDTiles + 2) * 32] = l_i[0], mine[(4 * kDTiles + 3) * 32] = l_i[1];
    }
    __syncthreads();
    if (sp > 0) return;
#pragma unroll
    for (int part = 1; part < T::kSplit; ++part) {
      const float* other = parts + ((part - 1) * kRowWarps + rw) * kPart + lane;
      float a_me[2], a_other[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_o = other[(4 * kDTiles + r) * 32], l_o = other[(4 * kDTiles + 2 + r) * 32];
        const float m_new = fmaxf(m_i[r], m_o);
        a_me[r] = exp2f(m_i[r] - m_new);
        a_other[r] = exp2f(m_o - m_new);
        m_i[r] = m_new;
        l_i[r] = l_i[r] * a_me[r] + l_o * a_other[r];
      }
#pragma unroll
      for (int j = 0; j < kDTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o_acc[j][e] = o_acc[j][e] * a_me[e >> 1] + other[(4 * j + e) * 32] * a_other[e >> 1];
      }
    }
  }

  // The output: each warp's 16 rows of acc / l, rounded to bf16, into its
  // rows of the Q tile (no longer read), then out in 16-byte stores.
  const unsigned o_s = q_s + rw * 16 * kLds * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv_l = 1.f / l_i[r];
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      st_shared32(o_s + ((g + 8 * r) * kLds + 8 * j + 2 * t4) * 2,
                  pack_bf16(o_acc[j][2 * r] * inv_l, o_acc[j][2 * r + 1] * inv_l));
    }
  }
  __syncwarp();
  constexpr int kC = DP / 8;  // 16-byte chunks a padded row
#pragma unroll 1
  for (int i = lane; i < 16 * kC; i += 32) {
    const int r = i / kC, c = (i % kC) * 8, row = q0 + rw * 16 + r;
    if (row < p.t && c < p.d) {
      *reinterpret_cast<uint4*>(p.o + (((long long)bi * p.t + row) * p.h + hi) * p.d + c) =
          ld_shared128(o_s + (r * kLds + c) * 2);
    }
  }
}

template <int DP, int kRowWarps>
cudaError_t launch(const FlashParams& p, int b, cudaStream_t stream) {
  using T = Tiles<DP, kRowWarps>;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<DP, kRowWarps>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.t + T::kBlockQ - 1) / T::kBlockQ, p.h, b);
  flash_attention_kernel<DP, kRowWarps><<<grid, kThreads, T::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// 64 query rows a block (4 warps of rows, 32-row kv tiles) once the
// blocks of one batch row fill every SM; else 32 (2 warps of rows, each
// pair splitting 64-row kv tiles), which doubles the blocks while the grid
// leaves SMs idle. The two tilings sum a row's kv tiles in different
// orders, so the choice reads T and H only, never the batch: a row's
// output is the same bits at every batch size.
template <int DP>
cudaError_t launch_rows(const FlashParams& p, int b, cudaStream_t stream) {
  return (long long)((p.t + 63) / 64) * p.h >= sm_count() ? launch<DP, 4>(p, b, stream)
                                                            : launch<DP, 2>(p, b, stream);
}

}  // namespace

// q (B,T,H,D), k/v (B,S,Hkv,D): bf16 with unit stride on D and the other
// strides (in elements) given; o (B,T,H,D) contiguous bf16. D is a multiple
// of 8 in [8, 256]. Returns the cudaError_t of the launch (0 on success).
extern "C" int pg_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  const int* valid, int b, int t, int s, int h, int hkv, int d,
                                  long long q_sb, long long q_st, long long q_sh, long long k_sb,
                                  long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                                  long long v_sh, int win0, int win1, float scale, void* stream) {
  const FlashParams p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v), static_cast<bf16*>(o), valid, t, s, h, hkv, d,
                      q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, win0, win1, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
    case 1: return launch_rows<16>(p, b, st);
    case 2: return launch_rows<32>(p, b, st);
    case 3: return launch_rows<48>(p, b, st);
    case 4: return launch_rows<64>(p, b, st);
    case 5: return launch_rows<80>(p, b, st);
    case 6: return launch_rows<96>(p, b, st);
    case 7: return launch_rows<112>(p, b, st);
    case 8: return launch_rows<128>(p, b, st);
    case 9: return launch_rows<144>(p, b, st);
    case 10: return launch_rows<160>(p, b, st);
    case 11: return launch_rows<176>(p, b, st);
    case 12: return launch_rows<192>(p, b, st);
    case 13: return launch_rows<208>(p, b, st);
    case 14: return launch_rows<224>(p, b, st);
    case 15: return launch_rows<240>(p, b, st);
    case 16: return launch_rows<256>(p, b, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* pg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

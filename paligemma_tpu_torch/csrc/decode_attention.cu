// GQA attention of T <= 16 queries a batch row against the preallocated KV
// cache, bf16 in and out, fp32 accumulation; the cache is bf16, or int8 with
// one fp32 scale per cached row (the int8 KV cache,
// models/gemma.py::QuantKVCache). T = 1 is a decode step; T > 1 is the
// speculative verify step, whose query i sees the positions [0, valid[b] + i)
// (and the window): the reference's per-query threshold mask
// (paligemma_tpu/models/gemma.py, forward with multi_token_decode).
//
// Replaces: paligemma_tpu/ops/pallas_attention.py::decode_attention (kernel
// body _decode_kernel). Same arithmetic: scores = (q . k) * scale in fp32,
// positions outside [0, valid[b]) ∪ [win0, win1) set to NEG_INF, softmax
// over the whole cache row, P NORMALIZED and then rounded to bf16, PV
// accumulated in fp32 (both products on the tensor cores, bf16 in, fp32
// sums, in a fixed order).
//
// Shape on the main path (PaliGemma-3B-224, batch 1): q (1,1,8,256), cache
// (1,S,1,256) with S = prompt + max_new_tokens, 18 calls per decoded token;
// a verify step of k drafts calls it with q (1,k,8,256).
//
// The verify shape puts the query index in the grid: one cluster per (batch
// row, query i, kv head), each running exactly the one-query arithmetic below
// with valid[b] + i as its visible length. So query row i is bit for bit the
// T = 1 call at visible length valid[b] + i; K/V are read T times, from L2
// at the main path's lengths. (Widening the mma's n side to G T query rows
// would not fit the scores of T = 13 in shared memory.)
//
// The int8 cache is read as the reference reads it (gemma.py, the decode
// branch of _attention): each value is multiplied by its row's scale
// rounded to bf16, and the product is rounded to bf16, bf16(float(q) *
// bf16(s)) -- exactly the reference's dequantized element (the product of
// a 7-bit integer and an 8-bit mantissa is exact, so the bf16 product
// rounds it once).
// From there the arithmetic is the bf16 cache's, so the result is bit for
// bit that of dequantizing the cache and running the bf16 kernel.
//
// What bounds it on the H100: bytes, and at the main path's lengths the
// fixed cost of a call. Each call reads the visible K and V rows once (2 x
// 512 B per position in bf16, 2 x (256 + 4) B in int8) and does 2 x 8 x
// 256 FMAs per position, far below the compute roof; at S = 308 that is
// 315 KB, 0.09 us at 3.35 TB/s, so the launch, the memory latency and the
// barriers are what a call costs. With batch 1 and one KV head the TPU
// kernel's (B, Hkv) grid would be one block on one of 132 SMs, so the
// design splits S over the blocks of a thread-block cluster, and the whole
// call is one launch:
//   - one cluster per (batch row, kv head), of C blocks (the host picks
//     the smallest power of two with 64 C >= S, at most 16: 8 at S = 308).
//     The cache is cut into 64-row tiles by position, tile i holding the
//     positions [64 i, 64 i + 64), and tile i belongs to block i mod C,
//     which takes its tiles in ascending order.
//   - So the result depends on q, the visible rows, valid[b] and the
//     window, never on S itself: up to S = 1024 every block holds at most
//     one tile, tile i always in block i, and from there on C = 16 for
//     every S. A tile with no visible position adds an exact zero to every
//     sum (its l_j is 0 once the row max is real, its partial output 0),
//     and V rows that are not visible are read as zeros, so a longer buffer
//     only appends zeros to sums of a fixed order.
//   - the K tiles and then the V tiles of a block stream through a 4-stage
//     ring of bf16 tiles in shared memory: a bf16 cache by cp.async, issued
//     before anything waits (V lands while the scores and the softmax
//     statistics are formed); an int8 cache read into registers one tile
//     ahead and dequantized into the ring by the block's 16 warps, each
//     value as the reference reads it. Rows that are not visible are not
//     read (zeros in V); a tile with no visible position reads no K or V.
//   - scores: S^T = K q^T on mma.sync m16n8k16 (tile rows the m side, the
//     G = 8 query heads the n side), four k parts on four warps added in a
//     fixed order, times the scale, NEG_INF where not visible. Each block
//     writes its statistics per query head to its own shared memory: its
//     max m_j and l_j = sum of exp(s - m_j).
//   - cluster barrier; every block reads all C blocks' statistics through
//     distributed shared memory and merges them by fixed-order warp
//     reductions into the row max m and sum l (the same numbers in every
//     block), then rounds its normalized probabilities bf16(exp(s - m) / l).
//   - P.V: O^T = V^T P^T on the mma (head_dim the m side, through
//     ldmatrix.trans; the heads the n side), accumulated over the block's
//     tiles in registers.
//   - cluster barrier; block r sums the r-th share of the (G, D) partial
//     outputs over the C blocks in rank order and stores it in bf16; a last
//     cluster barrier keeps every block's shared memory alive until then.
// No global scratch: the call allocates only its output. Every sum runs in
// a fixed order, so the result does not depend on block timing, and the
// int8 cache, dequantized to the same bf16 values, gives bit for bit the
// bf16 kernel's result. The cache is read through its strides straight
// from the per-layer (B, S, Hkv, D) view: no transposed copy. At most 8
// query heads share a kv head (Gemma: 8).
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 64;    // cache rows a tile (and a ring stage); the cluster rule: 64 C >= S
constexpr int kStages = 4;       // the ring of K and V tiles
constexpr int kMaxCluster = 16;  // non-portable cluster size on the H100
constexpr int kMaxQueries = 16;  // queries a batch row (the verify step's drafts)

struct DecodeParams {
  const bf16* q;
  const void* k;        // bf16, or int8 with k_scale / v_scale
  const void* v;
  bf16* o;           // (B, T, H, D)
  const int* valid;  // (B,) or null (all S visible)
  int b, t, s, h, hkv, d;
  int tiles;         // tiles of the block that holds the most (host)
  long long q_sb, q_st, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  const float* k_scale;  // (B, S, Hkv) per-row scales of the int8 cache, or null
  const float* v_scale;
  long long ks_sb, ks_ss, ks_sh;
  long long vs_sb, vs_ss, vs_sh;
  int win0, win1;
  const int* win1_dev;  // the window's end read on the device, or null (win1)
  float scale;
};

// The signed bytes 0 and 2 of w as a bf16 pair, exactly: for a byte with
// low 7 bits u and sign bit s, 0x4300 | u is the bf16 128 + u and
// 0x4300 | (s << 7) is 128 or 256, and their difference is the value.
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t w) {
  const uint32_t a = (w & 0x007F007Fu) | 0x43004300u, b = (w & 0x00800080u) | 0x43004300u;
  const bf162 r = __hsub2(*reinterpret_cast<const bf162*>(&a), *reinterpret_cast<const bf162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

// The shared-memory layout of a block (host and device agree on it, and
// so does ops/cuda_attention.py::_decode_shared_bytes). All offsets are in
// bytes and multiples of 16.
struct Layout {
  int gp;      // query heads padded to the mma's n8 tile (G <= 8)
  int dp;      // head_dim padded to the k16 steps of the mma
  int qs;      // bf16 elements of a query row (dp + 8: rows 16 bytes apart in banks)
  int pl;      // positions of the block's score and probability rows: `tiles` tiles
  int ps;      // bf16 elements of a probability row (pl + 8)
  int rs;      // bytes of a tile row (dp bf16 + 16 bytes: rows 16 bytes apart in banks)
  int stage;   // bytes of a stage: a tile
  int q, part, red, stats, scores, probs, ring, total;

  __host__ __device__ Layout(int g, int d, int tiles) {
    gp = 8;
    dp = round_up(d, 16);
    qs = dp + 8;
    pl = kTileRows * tiles;
    ps = pl + 8;
    rs = 2 * dp + 16;
    stage = kTileRows * rs;
    q = 0;
    part = q + round_up(2 * gp * qs, 16);         // fp32 (G, D): the block's partial outputs
    red = part + round_up(4 * g * d, 16);         // fp32 (kWarps - 4, 4, 32): the upper k parts' score sums
    stats = red + 4 * (kWarps - 4) * 4 * 32;      // float2 (G): (m_j, l_j); float2 (G): the row's (m, l)
    scores = stats + round_up(16 * g, 16);        // fp32 (G, pl)
    probs = scores + round_up(4 * g * pl, 16);    // bf16 (gp, ps)
    ring = probs + round_up(2 * gp * ps, 16);
    total = ring + kStages * stage;
  }
};

template <bool KV8>
__global__ void __launch_bounds__(kThreads) decode_kernel(DecodeParams p) {
  typedef typename std::conditional<KV8, int8_t, bf16>::type KvT;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char sm[];
  const int g = p.h / p.hkv, d = p.d;
  const Layout L(g, d, p.tiles);
  const int pl = L.pl;
  bf16* q_s = reinterpret_cast<bf16*>(sm + L.q);          // (gp, qs): the queries, zero-padded
  float* part_s = reinterpret_cast<float*>(sm + L.part);  // (G, D)
  float* red_s = reinterpret_cast<float*>(sm + L.red);    // the upper k half's score sums
  float2* st_s = reinterpret_cast<float2*>(sm + L.stats); // G: this block's (m_j, l_j)
  float2* row_s = st_s + g;                               // G: the row's (m, l)
  float* s_s = reinterpret_cast<float*>(sm + L.scores);   // (G, pl)
  bf16* p_s = reinterpret_cast<bf16*>(sm + L.probs);      // (gp, ps): probabilities in bf16
  unsigned char* ring = sm + L.ring;
  const unsigned ring_s = static_cast<unsigned>(__cvta_generic_to_shared(ring));
  const int rank = (int)cluster.block_rank(), n_ranks = (int)cluster.num_blocks();
  // blockIdx.y enumerates (batch row, query, kv head), the kv head fastest.
  const int bi = blockIdx.y / (p.t * p.hkv), qi = blockIdx.y / p.hkv % p.t, hk = blockIdx.y % p.hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;  // the mma fragments' row and column group

  // Query qi sees one position more than query qi - 1 (past S: nothing more).
  const int valid = (p.valid ? p.valid[bi] : p.s) + qi;
  // The window's end: a host int, or read once from the device (batched
  // serving's decode step moves it every step inside one CUDA graph).
  const int win1 = p.win1_dev ? *p.win1_dev : p.win1;
  // The block's tiles: its t-th is tile rank + C t of the cache, positions
  // [tile_c0(t), tile_c0(t) + tile_rows(t)); only the cache's last tile is
  // cut by S, so the block's positions, local j = 64 t + row, are j < n.
  const int n_tiles = (p.s + kTileRows - 1) / kTileRows;
  const int tiles = rank < n_tiles ? (n_tiles - rank + n_ranks - 1) / n_ranks : 0;
  auto tile_c0 = [&](int t) { return kTileRows * (rank + n_ranks * t); };
  auto tile_rows = [&](int t) { return min(kTileRows, p.s - tile_c0(t)); };
  const int n = tiles ? kTileRows * (tiles - 1) + tile_rows(tiles - 1) : 0;
  auto tile_visible = [&](int t) {
    return kv_range_visible(tile_c0(t), tile_c0(t) + tile_rows(t), valid, p.win0, win1);
  };
  // A row with no visible position takes the mean of all V rows (the
  // reference's softmax over NEG_INF scores): then every V row is read.
  const bool row_masked = !kv_range_visible(0, p.s, valid, p.win0, win1);
  auto v_read = [&](int t) { return row_masked || tile_visible(t); };
  auto row_read = [&](int c, bool is_k) {
    return kv_visible(c, p.s, valid, p.win0, win1) || (!is_k && row_masked);
  };

  // The ring's jobs: K tiles 0 .. tiles - 1, then V tiles 0 .. tiles - 1,
  // job j in stage j % kStages as bf16 rows. Thread (warp, lane) moves the
  // lane's 8 values of rows warp + kWarps i of a job. A bf16 cache is
  // copied with cp.async, one commit group a job (empty where nothing is
  // read); an int8 cache is read into registers one job ahead and
  // dequantized into its stage by the threads. K rows that are not visible
  // are not read (their scores are NEG_INF); V rows that are not visible,
  // or past S, are zeros.
  const KvT* kb = static_cast<const KvT*>(p.k) + bi * p.k_sb + hk * p.k_sh;
  const KvT* vb = static_cast<const KvT*>(p.v) + bi * p.v_sb + hk * p.v_sh;
  const float* ksb = KV8 ? p.k_scale + bi * p.ks_sb + hk * p.ks_sh : nullptr;
  const float* vsb = KV8 ? p.v_scale + bi * p.vs_sb + hk * p.vs_sh : nullptr;
  auto reads = [&](int j) {
    return j < 2 * tiles && (j < tiles ? tile_visible(j) : v_read(j - tiles)) && lane * 8 < d;
  };
  auto issue = [&](int j) {  // bf16
    const bool is_k = j < tiles;
    if (reads(j)) {
      const long long rs = is_k ? p.k_ss : p.v_ss;
      const KvT* row0 = is_k ? kb : vb;
      const int t = is_k ? j : j - tiles, c1 = tile_c0(t) + tile_rows(t);
      const int cw = tile_c0(t) + warp;
      const KvT* src = row0 + cw * rs + lane * 8;
      unsigned dst = ring_s + (j % kStages) * L.stage + warp * L.rs + lane * 16;
      for (int c = cw; c < cw - warp + kTileRows; c += kWarps) {
        const bool in = c < c1 && row_read(c, is_k);
        if (in || !is_k) cp_async16(dst, in ? src : row0, in ? 16 : 0);
        src += kWarps * rs;
        dst += kWarps * L.rs;
      }
    }
    cp_async_commit();
  };
  constexpr int kRowsPerThread = kTileRows / kWarps;
  uint2 raw[kRowsPerThread];
  float raw_scale[kRowsPerThread];
  auto load = [&](int j) {  // int8: job j into registers
    const bool is_k = j < tiles, go = reads(j);
    const long long rs = is_k ? p.k_ss : p.v_ss, ss = is_k ? p.ks_ss : p.vs_ss;
    const int t = is_k ? j : j - tiles, c1 = tile_c0(t) + tile_rows(t);
    const int cw = tile_c0(t) + warp;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int c = cw + kWarps * i;
      const bool in = go && c < c1 && row_read(c, is_k);
      raw[i] = in ? *reinterpret_cast<const uint2*>((is_k ? kb : vb) + c * rs + lane * 8) : make_uint2(0, 0);
      raw_scale[i] = in ? (is_k ? ksb : vsb)[c * ss] : 0.f;
    }
  };
  // int8: the registers of job j into its stage, each value as the
  // reference reads it: q is exact in bf16 and q * bf16(scale) exact in
  // fp32, so the bf16 product rounds it once, bf16(float(q) * bf16(scale)).
  auto store = [&](int j) {
    if (!reads(j)) return;
    unsigned char* st = ring + (j % kStages) * L.stage;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = warp + kWarps * i;
      const bf162 sc = __bfloat162bfloat162(__float2bfloat16_rn(raw_scale[i]));
      uint32_t v[4] = {__byte_perm(raw[i].x, 0u, 0x4140), __byte_perm(raw[i].x, 0u, 0x4342),
                       __byte_perm(raw[i].y, 0u, 0x4140), __byte_perm(raw[i].y, 0u, 0x4342)};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t qv = s8x2_to_bf16x2(v[u]);
        const bf162 prod = __hmul2(*reinterpret_cast<const bf162*>(&qv), sc);
        v[u] = *reinterpret_cast<const uint32_t*>(&prod);
      }
      *reinterpret_cast<uint4*>(st + r * L.rs + lane * 16) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  };
  if (KV8) {
    load(0);
  } else {
#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) issue(j);
  }

  // The queries in bf16, zero past G and D; and, where D is not a multiple
  // of 16, zeros in every stage's padding columns (the score products run
  // over them). The copies never write there.
  for (int gi = warp; gi < L.gp; gi += kWarps) {  // 16-byte pieces (qs is a multiple of 8)
    for (int e = 8 * lane; e < L.qs; e += 256) {
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gi < g && e < d)
        v = *reinterpret_cast<const uint4*>(p.q + bi * p.q_sb + qi * p.q_st + (hk * g + gi) * p.q_sh + e);
      *reinterpret_cast<uint4*>(q_s + gi * L.qs + e) = v;
    }
  }
  if (L.dp != d) {
    const int pad = 2 * (L.dp - d);
    for (int i = tid; i < kStages * kTileRows * pad; i += kThreads) {
      const int r = i / pad, e = i % pad;
      ring[(r / kTileRows) * L.stage + (r % kTileRows) * L.rs + 2 * d + e] = 0;
    }
  }
  if (KV8) {
    store(0);
    load(1);
  }

  // The bf16 tile of ring job j, once it has landed (shared address); then
  // the next copies: for a bf16 cache the job kStages - 1 ahead, for an
  // int8 cache the next job's registers into its stage and the job after
  // into the registers.
  auto landed = [&](int j) -> unsigned {
    if (!KV8) cp_async_wait<kStages - 2>();  // job j has landed (this thread's copies)
    __syncthreads();  // ... everyone's; the stage read last is free
    if (KV8) {
      store(j + 1);
      load(j + 2);
    } else {
      issue(j + kStages - 1);
    }
    return ring_s + (j % kStages) * L.stage;
  };

  // Scores, a tile at a time, as S^T = K q^T on the mma: rows of the tile
  // (16 a warp) are the m side, the query heads the n side, head_dim k.
  const int ksteps = L.dp / 16;
  for (int t = 0; t < tiles; ++t) {
    const unsigned kt = landed(t);
    const int base = t * kTileRows, rows = tile_rows(t);
    const bool visible = tile_visible(t);
    // Warp w takes rows 16 (w % 4) .. + 15 of the tile (at most 64 rows)
    // and the k part w / 4 of kParts; the upper parts' sums go through
    // red_s to part 0, which adds them in part order and stores the scores.
    constexpr int kParts = kWarps / 4;
    const int r0 = 16 * (warp & 3), part = warp >> 2;
    const int k_per = (ksteps + kParts - 1) / kParts;
    const int k_lo = min(part * k_per, ksteps), k_hi = min(k_lo + k_per, ksteps);
    float acc[2][4] = {};
    const bool active = r0 < rows && visible;
    if (active) {
      const int mi = lane >> 3, rr = r0 + (lane & 7) + 8 * (mi & 1);
      // Fragments of four k steps are loaded before their products; two
      // accumulators (even and odd steps) halve the chain of products.
      for (int kk = k_lo; kk < k_hi; kk += 4) {
        uint32_t a[4][4], b[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (kk + u >= k_hi) break;
          const int k0 = 16 * (kk + u);
          ldmatrix_x4(a[u], kt + rr * L.rs + 2 * (k0 + 8 * (mi >> 1)));
          const bf16* qrow = q_s + gq * L.qs + k0 + 2 * t4;
          b[u][0] = *reinterpret_cast<const uint32_t*>(qrow);
          b[u][1] = *reinterpret_cast<const uint32_t*>(qrow + 8);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (kk + u >= k_hi) break;
          mma_bf16(acc[u & 1], a[u], b[u][0], b[u][1]);
        }
      }
      if (part) {
#pragma unroll
        for (int e = 0; e < 4; ++e) red_s[((warp - 4) * 4 + e) * 32 + lane] = acc[0][e] + acc[1][e];
      }
    }
    __syncthreads();
    if (active && !part) {
      // acc: rows r0 + gq (+ 8), heads 2 t4 (+ 1).
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + gq + 8 * (e >> 1), hd = 2 * t4 + (e & 1), c = tile_c0(t) + r;
        float sum = acc[0][e] + acc[1][e];
#pragma unroll
        for (int u = 1; u < kParts; ++u) sum += red_s[((warp + 4 * (u - 1)) * 4 + e) * 32 + lane];
        if (r < rows && hd < g)
          s_s[hd * pl + base + r] = kv_visible(c, p.s, valid, p.win0, win1) ? sum * p.scale : PG_NEG_INF;
      }
    }
    if (!visible) {
      for (int i = tid; i < g * rows; i += kThreads) s_s[(i / rows) * pl + base + i % rows] = PG_NEG_INF;
    }
  }
  __syncthreads();  // s_s is complete

  // This block's statistics per query head. Every score is >= NEG_INF, so
  // a fully masked block gets max NEG_INF and a sum equal to its length, as
  // a fully masked row does in the reference (and weighs exp(NEG_INF - m)
  // = 0 in a row with a visible position); a block with no positions gets
  // (NEG_INF, 0).
  for (int gi = warp; gi < g; gi += kWarps) {
    float mx = PG_NEG_INF;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, s_s[gi * pl + j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) sum += expf(s_s[gi * pl + j] - mx);
    sum = warp_sum(sum);
    if (lane == 0) st_s[gi] = make_float2(mx, sum);
  }
  cluster.sync();  // every block's statistics are complete

  // The row's statistics: lane r reads block r's, merged by warp
  // reductions of a fixed order (the same numbers in every block).
  for (int gi = warp; gi < g; gi += kWarps) {
    const float2 mj = lane < n_ranks ? cluster.map_shared_rank(st_s, lane)[gi] : make_float2(PG_NEG_INF, 0.f);
    const float mx = warp_max(mj.x);
    const float sum = warp_sum(mj.y * expf(mj.x - mx));
    if (lane == 0) row_s[gi] = make_float2(mx, sum);
  }
  __syncthreads();

  // The probabilities, normalized and then rounded to bf16; zero past the
  // block's positions and past G.
  int nonzero = 0;
  for (int gi = warp; gi < L.gp; gi += kWarps) {
    const float2 ml = gi < g ? row_s[gi] : make_float2(0.f, 1.f);
    for (int j = lane; j < L.pl; j += 32) {
      const float pr = gi < g && j < n ? expf(s_s[gi * pl + j] - ml.x) / ml.y : 0.f;
      const bf16 pb = __float2bfloat16_rn(pr);
      p_s[gi * L.ps + j] = pb;
      nonzero |= __bfloat162float(pb) != 0.f;
    }
  }
  const bool any = __syncthreads_or(nonzero);

  // P.V, a tile at a time, as O^T = V^T P^T on the mma: head_dim (16 a
  // tile) is the m side, the query heads the n side, the tile's rows k.
  // Warp w keeps the m tiles w, w + kWarps, .. in registers across tiles;
  // a tile whose V was not read has probabilities 0 and is skipped.
  constexpr int kMaxMTiles = 256 / 16 / kWarps;
  float acc[kMaxMTiles][4] = {};
  const int mtiles = L.dp / 16;
  for (int t = 0; t < tiles; ++t) {
    const unsigned vt = landed(tiles + t);
    if (!any || !v_read(t)) continue;
    const int base = t * kTileRows;
    for (int kk = 0; kk < kTileRows / 16; ++kk) {
      const int k0 = 16 * kk;
      const bf16* prow = p_s + gq * L.ps + base + k0 + 2 * t4;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(prow);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(prow + 8);
      const int q4 = lane >> 3, rr = k0 + (lane & 7) + 8 * (q4 >> 1);
#pragma unroll
      for (int mi = 0; mi < kMaxMTiles; ++mi) {
        const int m0 = 16 * (warp + kWarps * mi);
        if (m0 >= 16 * mtiles) break;
        uint32_t a[4];
        ldmatrix_x4_trans(a, vt + rr * L.rs + 2 * (m0 + 8 * (q4 & 1)));
        mma_bf16(acc[mi], a, b0, b1);
      }
    }
  }
  // acc[mi]: head_dim m0 + gq (+ 8), heads 2 t4 (+ 1).
#pragma unroll
  for (int mi = 0; mi < kMaxMTiles; ++mi) {
    const int m0 = 16 * (warp + kWarps * mi);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dd = m0 + gq + 8 * (e >> 1), hd = 2 * t4 + (e & 1);
      if (dd < d && hd < g) part_s[hd * d + dd] = acc[mi][e];
    }
  }
  cp_async_wait<0>();
  cluster.sync();  // every block's partial outputs are complete

  // Block r stores the r-th share of the outputs, summed in rank order.
  const int total = g * d, share = (total + n_ranks - 1) / n_ranks;
  bf16* ob = p.o + (((long long)bi * p.t + qi) * p.h + hk * g) * d;
  for (int i = rank * share + tid; i < min(total, (rank + 1) * share); i += kThreads) {
    float part[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) part[r] = r < n_ranks ? cluster.map_shared_rank(part_s, r)[i] : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) sum += part[r];
    ob[i] = __float2bfloat16_rn(sum);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// Blocks of a cluster: the smallest power of two C with kTileRows C >= S,
// at most kMaxCluster.
inline int cluster_size(int s) {
  int c = 1;
  while (c < kMaxCluster && c * kTileRows < s) c *= 2;
  return c;
}

template <bool KV8>
cudaError_t launch(DecodeParams p, cudaStream_t st) {
  const int c = cluster_size(p.s);
  p.tiles = ((p.s + kTileRows - 1) / kTileRows + c - 1) / c;
  const size_t smem = Layout(p.h / p.hkv, p.d, p.tiles).total;
  // The attributes: clusters of up to 16 blocks, and (once a larger one is
  // needed) the dynamic shared memory limit.
  static int smem_limit = [] {
    cudaFuncSetAttribute(decode_kernel<KV8>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return 48 * 1024;
  }();
  if (smem > (size_t)smem_limit) {
    const cudaError_t err = cudaFuncSetAttribute(decode_kernel<KV8>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_limit = (int)smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, p.b * p.t * p.hkv);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, decode_kernel<KV8>, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// q (B,T,H,D) with 1 <= T <= 16; k/v cache (B,S,Hkv,D) with unit stride on
// D and the other strides (in elements) given: bf16, or int8 when k_scale
// and v_scale (the (B,S,Hkv) fp32 row scales, strides given) are not null.
// o (B,T,H,D) contiguous bf16. Query i of row b sees [0, valid[b] + i) and
// the window [win0, win1), or [win0, *win1_dev) when win1_dev (a device
// int32) is not null. One launch; returns its cudaError_t (0 on success).
extern "C" int pg_decode_attention(const void* q, const void* k, const void* v, void* o,
                                   const int* valid, int b, int t, int s, int h, int hkv, int d,
                                   long long q_sb, long long q_st, long long q_sh, long long k_sb, long long k_ss,
                                   long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                                   const void* k_scale, const void* v_scale, long long ks_sb,
                                   long long ks_ss, long long ks_sh, long long vs_sb,
                                   long long vs_ss, long long vs_sh, int win0,
                                   int win1, const int* win1_dev, float scale, void* stream) {
  if ((k_scale == nullptr) != (v_scale == nullptr) || b < 1 || t < 1 || t > kMaxQueries || s < 1 || hkv < 1 ||
      h % hkv || h / hkv > 8 || (long long)b * t * hkv > 65535)
    return cudaErrorInvalidValue;
  DecodeParams p{static_cast<const bf16*>(q), k, v, static_cast<bf16*>(o), valid, b, t, s, h, hkv, d, 0,
                 q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                 ks_sb, ks_ss, ks_sh, vs_sb, vs_ss, vs_sh, win0, win1, win1_dev, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return k_scale ? launch<true>(p, st) : launch<false>(p, st);
}

// Single-query GQA attention against the preallocated KV cache, bf16 in and
// out, fp32 accumulation; the cache is bf16, or int8 with one fp32 scale per
// cached row (the int8 KV cache, models/gemma.py::QuantKVCache).
//
// Replaces: paligemma_tpu/ops/pallas_attention.py::decode_attention (kernel
// body _decode_kernel). Same arithmetic and the same order: scores =
// (q . k) * scale in fp32, positions outside [0, valid[b]) ∪ [win0, win1)
// set to NEG_INF, softmax over the whole cache row, P NORMALIZED and then
// rounded to bf16, PV accumulated in fp32.
//
// Shape on the main path (PaliGemma-3B-224, batch 1): q (1,1,8,256), cache
// (1,S,1,256) with S = prompt + max_new_tokens, 18 calls per decoded token.
//
// The int8 cache is read as the reference reads it (gemma.py, the decode
// branch of _attention): each value is widened and multiplied by its row's
// scale rounded to bf16, and the product is rounded to bf16,
// bf16(float(q) * bf16(s)) -- exactly the reference's dequantized element
// (the product of a 7-bit integer and an 8-bit mantissa is exact in fp32).
// From there the arithmetic is the bf16 cache's, so the result is bit for
// bit that of dequantizing the cache and running the bf16 kernel.
//
// What bounds it on the H100: bytes. Each call reads the visible K and V
// rows once (2 x 512 B per position in bf16, 2 x (256 + 4) B in int8) and
// does 2 x 8 x 256 FMAs per position, far below the compute roof. With batch 1 and one KV head the
// TPU kernel's (B, Hkv) grid would be a single block on one of 132 SMs, so
// the design splits S instead:
//   1. decode_scores: one block per (32-position chunk, batch row, kv head).
//      A warp reads a K row with one 16-byte load per lane and forms the dot
//      products of all G query heads of the group, so the G = 8 heads share
//      one read of K; each warp starts the loads of its 4 rows before using
//      any, so their latencies overlap. Chunks with no visible position are
//      not read. Each block also writes its chunk's softmax statistics per
//      query head: the chunk max m_j and l_j = sum of exp(s - m_j).
//   2. decode_pv: one block per (chunk, batch row, kv head). It merges the
//      ceil(S/32) chunk statistics into the row max m = max m_j and sum
//      l = sum of l_j exp(m_j - m) (a log-sum-exp merge, so no block rereads
//      the whole score row and the work per block grows as S/32, not S),
//      writes the chunk's normalized bf16 probabilities to shared memory,
//      and each warp (one query head) forms the chunk's partial P.V with
//      16-byte V loads, 8 rows in flight; the warps of a block read the same
//      V rows, so all but the first read hit L1. A chunk whose probabilities
//      are all exactly zero reads no V.
//   3. decode_reduce: sums the per-chunk partial outputs in chunk order.
// Three launches instead of one keep the reference's normalize-then-round
// order (each chunk needs the global max and sum before it can round P) and
// keep every sum deterministic. The cache is read through its strides
// straight from the per-layer (B, S, Hkv, D) view: no transposed copy.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;                       // cache positions per block
constexpr int kRowsPerWarp = kChunk / kWarps;    // score rows per warp
constexpr int kUnroll = 8;                       // V rows in flight per lane
static_assert(kChunk == 32, "the chunk statistics give one lane per position");

struct DecodeParams {
  const bf16* q;
  const void* k;        // bf16, or int8 with k_scale / v_scale
  const void* v;
  bf16* o;
  const int* valid;  // (B,) or null (all S visible)
  float* scores;     // (B, H, S) scratch
  float2* stats;     // (n_chunks, B, H) scratch: chunk max, chunk sum
  float* partial;    // (n_chunks, B, H, D) scratch
  int b, s, h, hkv, d, n_chunks;
  long long q_sb, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  const float* k_scale;  // (B, S, Hkv) per-row scales of the int8 cache, or null
  const float* v_scale;
  long long ks_sb, ks_ss, ks_sh;
  long long vs_sb, vs_ss, vs_sh;
  int win0, win1;
  float scale;
};

// One lane's eight values of a cache row, as loaded (16 bytes of bf16, or 8
// bytes of int8 and the row's scale), widened to fp32 when used.
template <bool KV8>
struct CacheVec;

template <>
struct CacheVec<false> {
  typedef bf16 T;
  uint4 raw;
  __device__ __forceinline__ void load(const T* row, const float*) {
    raw = *reinterpret_cast<const uint4*>(row);
  }
  __device__ __forceinline__ void widen(float* out) const { bf16x8_to_float(raw, out); }
};

template <>
struct CacheVec<true> {
  typedef int8_t T;
  uint2 raw;
  float scale;
  __device__ __forceinline__ void load(const T* row, const float* row_scale) {
    raw = *reinterpret_cast<const uint2*>(row);
    scale = *row_scale;
  }
  // The reference's dequantized element: bf16(float(q) * bf16(scale)).
  __device__ __forceinline__ void widen(float* out) const {
    const float s = round_bf16(scale);
    s8x4_to_float(raw.x, out);
    s8x4_to_float(raw.y, out + 4);
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = round_bf16(out[e] * s);
  }
};

template <bool KV8>
__global__ void __launch_bounds__(kThreads) decode_scores_kernel(DecodeParams p) {
  typedef typename CacheVec<KV8>::T KvT;
  extern __shared__ __align__(16) float q_s[];  // G x D, fp32
  const int g = p.h / p.hkv;
  float* s_s = q_s + g * p.d;                   // G x kChunk scores
  const int bi = blockIdx.y / p.hkv, hk = blockIdx.y % p.hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d = p.d;

  for (int i = tid; i < g * d; i += kThreads) {
    const int gi = i / d, e = i % d;
    q_s[i] = __bfloat162float(p.q[bi * p.q_sb + (hk * g + gi) * p.q_sh + e]);
  }

  const int valid = p.valid ? p.valid[bi] : p.s;
  const int c0 = blockIdx.x * kChunk, c1 = min(c0 + kChunk, p.s);
  const bool any_visible = kv_range_visible(c0, c1, valid, p.win0, p.win1);
  float* srow = p.scores + ((long long)bi * p.h + hk * g) * p.s;
  const KvT* kb = static_cast<const KvT*>(p.k) + bi * p.k_sb + hk * p.k_sh;
  const float* ksb = KV8 ? p.k_scale + bi * p.ks_sb + hk * p.ks_sh : nullptr;
  const bool lane_active = lane * 8 < d;

  // This warp's cache rows c0 + warp + kWarps * i: all their K loads are
  // started before any is used, so their latencies overlap.
  float kf[kRowsPerWarp][8];
  bool vis[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int c = c0 + warp + kWarps * i;
    vis[i] = any_visible && c < c1 && kv_visible(c, p.s, valid, p.win0, p.win1);
    if (vis[i] && lane_active) {
      CacheVec<KV8> kv;
      kv.load(kb + c * p.k_ss + lane * 8, KV8 ? ksb + c * p.ks_ss : nullptr);
      kv.widen(kf[i]);
    }
  }
  __syncthreads();  // q_s is complete

  for (int gi = 0; gi < g; ++gi) {
    float qf[8];
    if (lane_active) {
      const float4 qa = *reinterpret_cast<const float4*>(q_s + gi * d + lane * 8);
      const float4 qb = *reinterpret_cast<const float4*>(q_s + gi * d + lane * 8 + 4);
      qf[0] = qa.x; qf[1] = qa.y; qf[2] = qa.z; qf[3] = qa.w;
      qf[4] = qb.x; qf[5] = qb.y; qf[6] = qb.z; qf[7] = qb.w;
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int c = c0 + warp + kWarps * i;
      if (c >= c1) continue;  // uniform across the warp
      float part = 0.f;
      if (vis[i] && lane_active) {
        part = qf[0] * kf[i][0];
#pragma unroll
        for (int e = 1; e < 8; ++e) part = fmaf(qf[e], kf[i][e], part);
      }
      part = warp_sum(part);
      if (lane == 0) {
        const float sc = vis[i] ? part * p.scale : PG_NEG_INF;
        srow[(long long)gi * p.s + c] = sc;
        s_s[gi * kChunk + (c - c0)] = sc;
      }
    }
  }
  __syncthreads();  // s_s is complete

  // The chunk's statistics; kChunk == 32, so lane = position in the chunk.
  // Every score is >= NEG_INF, so a fully masked chunk gets max NEG_INF and
  // a sum equal to its length, as a fully masked row does in the reference.
  for (int gi = warp; gi < g; gi += kWarps) {
    const bool in = c0 + lane < c1;
    const float sc = in ? s_s[gi * kChunk + lane] : PG_NEG_INF;
    const float mx = warp_max(sc);
    const float sum = warp_sum(in ? expf(sc - mx) : 0.f);
    if (lane == 0) p.stats[((long long)blockIdx.x * p.b + bi) * p.h + hk * g + gi] = make_float2(mx, sum);
  }
}

template <bool KV8>
__global__ void __launch_bounds__(kThreads) decode_pv_kernel(DecodeParams p) {
  typedef typename CacheVec<KV8>::T KvT;
  extern __shared__ __align__(16) float sm[];
  const int g = p.h / p.hkv;
  float* p_s = sm;                 // G x kChunk normalized probabilities
  float* m_s = p_s + g * kChunk;   // G row maxima
  float* l_s = m_s + g;            // G row sums
  const int bi = blockIdx.y / p.hkv, hk = blockIdx.y % p.hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d = p.d;
  const float* srow = p.scores + ((long long)bi * p.h + hk * g) * p.s;

  // Softmax statistics of the whole row, merged from the chunks' (m_j, l_j).
  const long long chunk_stride = (long long)p.b * p.h;
  for (int gi = warp; gi < g; gi += kWarps) {
    const float2* st = p.stats + (long long)bi * p.h + hk * g + gi;
    float mx = PG_NEG_INF;  // every chunk max is >= NEG_INF
    for (int j = lane; j < p.n_chunks; j += 32) mx = fmaxf(mx, st[j * chunk_stride].x);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < p.n_chunks; j += 32) {
      const float2 mj = st[j * chunk_stride];
      sum += mj.y * expf(mj.x - mx);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[gi] = mx;
      l_s[gi] = sum;
    }
  }
  __syncthreads();

  const int c0 = blockIdx.x * kChunk, c1 = min(c0 + kChunk, p.s);
  int nonzero = 0;
  for (int i = tid; i < g * kChunk; i += kThreads) {
    const int gi = i / kChunk, c = c0 + i % kChunk;
    float pr = 0.f;
    if (c < c1) pr = round_bf16(expf(srow[(long long)gi * p.s + c] - m_s[gi]) / l_s[gi]);
    p_s[i] = pr;
    nonzero |= pr != 0.f;
  }
  const bool any = __syncthreads_or(nonzero);

  // P.V for the chunk: warp gi is query head gi; lane owns the 8 output
  // columns lane*8 .. lane*8+7 and reads them with one 16-byte load per
  // row, kUnroll rows in flight at a time. The sum over rows runs in order.
  float* out = p.partial + (((long long)blockIdx.x * p.b + bi) * p.h + hk * g) * d;
  const KvT* vb = static_cast<const KvT*>(p.v) + bi * p.v_sb + hk * p.v_sh;
  const float* vsb = KV8 ? p.v_scale + bi * p.vs_sb + hk * p.vs_sh : nullptr;
  const bool lane_active = lane * 8 < d;
  for (int gi = warp; gi < g; gi += kWarps) {
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    if (any && lane_active) {
      const float* prow = p_s + gi * kChunk;
      for (int cb = c0; cb < c1; cb += kUnroll) {
        CacheVec<KV8> raw[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (cb + u < c1) raw[u].load(vb + (cb + u) * p.v_ss + lane * 8, KV8 ? vsb + (cb + u) * p.vs_ss : nullptr);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (cb + u < c1) {
            float vf[8];
            raw[u].widen(vf);
            const float pc = prow[cb + u - c0];
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[e] = fmaf(pc, vf[e], acc[e]);
          }
        }
      }
    }
    if (lane_active) {
      float4* o4 = reinterpret_cast<float4*>(out + gi * d + lane * 8);
      o4[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      o4[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
  }
}

__global__ void decode_reduce_kernel(DecodeParams p) {
  const int e = threadIdx.x;
  if (e >= p.d) return;
  const long long bh = blockIdx.x;  // b * H + h
  const long long stride = (long long)p.b * p.h * p.d;
  const float* src = p.partial + bh * p.d + e;
  float sum = 0.f;
#pragma unroll 8
  for (int j = 0; j < p.n_chunks; ++j) sum += src[j * stride];
  p.o[bh * p.d + e] = __float2bfloat16_rn(sum);
}

template <bool KV8>
cudaError_t launch(const DecodeParams& p, cudaStream_t st) {
  const int g = p.h / p.hkv;
  const dim3 grid(p.n_chunks, p.b * p.hkv);
  decode_scores_kernel<KV8><<<grid, kThreads, sizeof(float) * g * (p.d + kChunk), st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_pv_kernel<KV8><<<grid, kThreads, sizeof(float) * (g * kChunk + 2 * g), st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_reduce_kernel<<<p.b * p.h, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q (B,1,H,D); k/v cache (B,S,Hkv,D) with unit stride on D and the other
// strides (in elements) given: bf16, or int8 when k_scale and v_scale (the
// (B,S,Hkv) fp32 row scales, strides given) are not null. o (B,1,H,D)
// contiguous bf16; scores (B,H,S), stats (ceil(S/chunk),B,H,2) and partial
// (ceil(S/chunk),B,H,D) fp32 scratch; ``chunk`` must be the kernels' kChunk
// (the caller sizes ``stats`` and ``partial`` with it). Returns the first
// cudaError_t of the three launches (0 on success).
extern "C" int pg_decode_attention(const void* q, const void* k, const void* v, void* o,
                                   const int* valid, float* scores, float* stats,
                                   float* partial, int b, int s,
                                   int h, int hkv, int d, int chunk, long long q_sb,
                                   long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss, long long v_sh,
                                   const void* k_scale, const void* v_scale, long long ks_sb,
                                   long long ks_ss, long long ks_sh, long long vs_sb,
                                   long long vs_ss, long long vs_sh, int win0,
                                   int win1, float scale, void* stream) {
  if (chunk != kChunk || (k_scale == nullptr) != (v_scale == nullptr)) return cudaErrorInvalidValue;
  const int n_chunks = (s + kChunk - 1) / kChunk;
  DecodeParams p{static_cast<const bf16*>(q), k, v, static_cast<bf16*>(o), valid, scores,
                 reinterpret_cast<float2*>(stats), partial, b, s, h, hkv, d, n_chunks, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                 ks_sb, ks_ss, ks_sh, vs_sb, vs_ss, vs_sh, win0, win1, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return k_scale ? launch<true>(p, st) : launch<false>(p, st);
}

// Bidirectional flash attention with GQA and LengthMask visibility, bf16 in
// and out, fp32 accumulation, on the tensor cores (mma.sync m16n8k16).
//
// Replaces: paligemma_tpu/ops/pallas_attention.py::flash_attention (kernel
// body _flash_kernel). Same arithmetic: scores = (q . k) * scale in fp32,
// masked scores set to NEG_INF, online softmax per query row with the
// masked probabilities zeroed explicitly (a fully masked kv tile must add
// nothing, not exp(0) = 1s), unnormalized P rounded to bf16 before the PV
// product, fp32 accumulator, output = acc / l.
//
// Shapes on the main path (PaliGemma-3B-224): SigLIP T = S = 256, H = Hkv =
// 16, D = 72 (27 calls per prefill); Gemma prefill T = S ~ 270, H = 8,
// Hkv = 1, D = 256 (18 calls).
//
// What bounds it on the H100: at these sizes K/V of one head is at most
// 140 KB and stays in L2, and the two products are ~40 MFLOP per call, so
// the kernel is bound by latency (loads, syncs, the softmax between the two
// products) rather than by bytes or tensor-core rate. The design:
//   - one block of 4 warps per (batch, head, 64-row query tile); each warp
//     owns 16 query rows outright: their scores, softmax statistics and
//     output accumulators live in its registers, in the mma fragment
//     layouts, so the softmax needs only shuffles within a lane quad and P
//     goes from the score accumulators straight into the A operand of the
//     PV product without touching shared memory;
//   - the TPU kernel's sequential k-block grid axis becomes a loop over
//     32-row K/V tiles staged in shared memory;
//   - head_dim is padded inside the tiles to DP, the next multiple of 16
//     (SigLIP's 72 -> 80), with zeros in Q, K and V, so the padded columns
//     add nothing to the scores and are never stored; one instantiation per
//     DP keeps every accumulator index static (registers, no spills);
//   - shared-memory rows are DP + 8 bf16 long, which spreads the 8 rows a
//     fragment load touches over all 32 banks;
//   - ragged T and S edges are masked in the kernel (rows past T are not
//     stored, kv columns past S are invisible); nothing is padded in memory.
// wgmma/TMA and a persistent schedule are later work.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 16 * kWarps;  // query rows per block
constexpr int kBlockK = 32;           // kv rows per shared-memory tile
constexpr int kNT = kBlockK / 8;      // score n-tiles per kv tile

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

// Copy `rows` rows of head_dim `d` (16-byte vectors) into a shared tile of
// row stride `lds`, zero-filling rows past `valid_rows` and columns d..DP-1.
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, int lds, const bf16* src, long long stride,
                                          int rows, int valid_rows, int d) {
  constexpr int kVecs = DP / 8;
  for (int i = threadIdx.x; i < rows * kVecs; i += kThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid_rows && c < d) val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * lds + c) = val;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(FlashParams p) {
  constexpr int kLds = DP + 8;  // shared row stride (bf16)
  constexpr int kKSteps = DP / 16;
  constexpr int kDTiles = DP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // kBlockQ x kLds
  bf16* k_s = q_s + kBlockQ * kLds;           // kBlockK x kLds
  bf16* v_s = k_s + kBlockK * kLds;           // kBlockK x kLds

  const int qt = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int hk = hi / (p.h / p.hkv);
  const int q0 = qt * kBlockQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group, thread in group
  const int valid = p.valid ? p.valid[bi] : p.s;

  load_tile<DP>(q_s, kLds, p.q + bi * p.q_sb + hi * p.q_sh + q0 * p.q_st, p.q_st, kBlockQ,
                p.t - q0, p.d);

  float o_acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) o_acc[j][0] = o_acc[j][1] = o_acc[j][2] = o_acc[j][3] = 0.f;
  float m_i[2] = {PG_NEG_INF, PG_NEG_INF}, l_i[2] = {0.f, 0.f};  // rows g and g + 8

  const bf16* kb = p.k + bi * p.k_sb + hk * p.k_sh;
  const bf16* vb = p.v + bi * p.v_sb + hk * p.v_sh;
  const bf16* q_w = q_s + warp * 16 * kLds;
  const int n_tiles = (p.s + kBlockK - 1) / kBlockK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile is no longer read (and q_s is complete)
    load_tile<DP>(k_s, kLds, kb + k0 * p.k_ss, p.k_ss, kBlockK, p.s - k0, p.d);
    load_tile<DP>(v_s, kLds, vb + k0 * p.v_ss, p.v_ss, kBlockK, p.s - k0, p.d);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 32 kv columns.
    float s_acc[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s_acc[j][0] = s_acc[j][1] = s_acc[j][2] = s_acc[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const int c = ks * 16 + 2 * t4;
      uint32_t a[4];
      a[0] = ld32(q_w + g * kLds + c);
      a[1] = ld32(q_w + (g + 8) * kLds + c);
      a[2] = ld32(q_w + g * kLds + c + 8);
      a[3] = ld32(q_w + (g + 8) * kLds + c + 8);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const bf16* krow = k_s + (8 * j + g) * kLds + c;
        mma_16816(s_acc[j], a, ld32(krow), ld32(krow + 8));
      }
    }

    // Online softmax. Element e of n-tile j sits at row g (e < 2) or g + 8
    // (e >= 2) and kv column 8j + 2*t4 + (e & 1); a row's 32 columns are
    // spread over the 4 lanes of a quad.
    float mx[2] = {PG_NEG_INF, PG_NEG_INF};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t4 + (e & 1);
        const float sv = kv_visible(col, p.s, valid, p.win0, p.win1) ? s_acc[j][e] * p.scale
                                                                       : PG_NEG_INF;
        s_acc[j][e] = sv;
        mx[e >> 1] = fmaxf(mx[e >> 1], sv);
      }
    }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r]);
      alpha[r] = expf(m_i[r] - m_new);
      m_i[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sv = s_acc[j][e];
        const float pv = sv > PG_NEG_INF * 0.5f ? expf(sv - m_i[e >> 1]) : 0.f;
        s_acc[j][e] = pv;
        rsum[e >> 1] += pv;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l_i[r] = l_i[r] * alpha[r] + rsum[r];
    }
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      o_acc[j][0] *= alpha[0];
      o_acc[j][1] *= alpha[0];
      o_acc[j][2] *= alpha[1];
      o_acc[j][3] *= alpha[1];
    }

    // O += bf16(P) V. Two score n-tiles form one 16-column A fragment.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s_acc[2 * kk][0], s_acc[2 * kk][1]);
      a[1] = pack_bf16(s_acc[2 * kk][2], s_acc[2 * kk][3]);
      a[2] = pack_bf16(s_acc[2 * kk + 1][0], s_acc[2 * kk + 1][1]);
      a[3] = pack_bf16(s_acc[2 * kk + 1][2], s_acc[2 * kk + 1][3]);
      const bf16* v0 = v_s + (kk * 16 + 2 * t4) * kLds + g;
#pragma unroll
      for (int j = 0; j < kDTiles; ++j) {
        const bf16* vc = v0 + 8 * j;
        const uint32_t b0 = pack_bf16(vc[0], vc[kLds]);
        const uint32_t b1 = pack_bf16(vc[8 * kLds], vc[9 * kLds]);
        mma_16816(o_acc[j], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= p.t) continue;
    bf16* orow = p.o + (((long long)bi * p.t + row) * p.h + hi) * p.d;
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col < p.d) {
        *reinterpret_cast<bf162*>(orow + col) =
            __floats2bfloat162_rn(o_acc[j][2 * r] / l_i[r], o_acc[j][2 * r + 1] / l_i[r]);
      }
    }
  }
}

template <int DP>
cudaError_t launch(const FlashParams& p, int b, cudaStream_t stream) {
  const int smem = (int)(sizeof(bf16) * (kBlockQ + 2 * kBlockK) * (DP + 8));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.t + kBlockQ - 1) / kBlockQ, p.h, b);
  flash_attention_kernel<DP><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
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
    case 1: return launch<16>(p, b, st);
    case 2: return launch<32>(p, b, st);
    case 3: return launch<48>(p, b, st);
    case 4: return launch<64>(p, b, st);
    case 5: return launch<80>(p, b, st);
    case 6: return launch<96>(p, b, st);
    case 7: return launch<112>(p, b, st);
    case 8: return launch<128>(p, b, st);
    case 9: return launch<144>(p, b, st);
    case 10: return launch<160>(p, b, st);
    case 11: return launch<176>(p, b, st);
    case 12: return launch<192>(p, b, st);
    case 13: return launch<208>(p, b, st);
    case 14: return launch<224>(p, b, st);
    case 15: return launch<240>(p, b, st);
    case 16: return launch<256>(p, b, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* pg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

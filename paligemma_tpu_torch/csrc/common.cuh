// Shared helpers for the attention kernels: bf16 conversion, warp
// reductions, and the LengthMask visibility rule of the reference
// (paligemma_tpu/ops/attention.py::LengthMask): batch row b sees kv
// positions [0, valid[b]) and the shared window [win0, win1).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

// The reference kernels' mask value: -0.7 * FLT_MAX. Large enough that
// exp(NEG_INF - m) is exactly 0 for any real row maximum m, small enough
// that NEG_INF - NEG_INF stays finite (0), so a fully masked row never
// produces inf - inf.
#define PG_NEG_INF (-0.7f * 3.402823466e+38f)

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Round an fp32 value to bf16 (nearest even) and back: the reference casts
// the probabilities to the value dtype before the PV product.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ bool kv_visible(int c, int s_len, int valid, int win0, int win1) {
  return c < s_len && (c < valid || (c >= win0 && c < win1));
}

// True if any position of [c0, c1) is visible.
__device__ __forceinline__ bool kv_range_visible(int c0, int c1, int valid, int win0, int win1) {
  return c0 < valid || (c0 < win1 && c1 > win0 && win0 < win1);
}

// Eight bf16 values (one 16-byte load) widened to fp32.
__device__ __forceinline__ void bf16x8_to_float(const uint4& raw, float* out) {
  const bf162* h = reinterpret_cast<const bf162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

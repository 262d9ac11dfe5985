// Shared helpers of the kernels: bf16 conversion, warp reductions, the
// mma.sync m16n8k16 products (mma_16816, and mma_bf16 that the compiler may
// reorder), the s8 product m16n8k32 (mma_s8), cp.async copies, ldmatrix and shared loads and stores, the SM
// count (host), and the LengthMask visibility rule of the reference
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

// D (16x8 fp32) += A (16x16 bf16, row) * B (16x8 bf16, col). Fragments as
// in the PTX ISA: with g = lane / 4 and t4 = lane % 4, a[0..3] hold A rows
// g, g+8 at columns 2*t4 (+1) and 2*t4+8 (+1); b0/b1 hold B column g at rows
// 2*t4 (+1) and 2*t4+8 (+1); c[0..3] hold D rows g, g+8 at columns 2*t4 (+1).
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mma_16816 without `volatile`: the compiler may schedule the products
// among the fragment loads.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D (16x8 s32) += A (16x32 s8, row) * B (32x8 s8, col), exact. Fragments
// as in the PTX ISA: with g = lane / 4 and t4 = lane % 4, a[0] / a[1] hold
// A rows g / g + 8 at columns 4 t4 .. 4 t4 + 3 (one byte each, the lowest
// byte first) and a[2] / a[3] the same rows at columns 16 + 4 t4 .. + 3;
// b0 / b1 hold B column g at rows 4 t4 .. + 3 and 16 + 4 t4 .. + 3; c[0..3]
// hold D rows g, g + 8 at columns 2 t4 (+1). Not volatile: the compiler may
// schedule the products among the fragment loads.
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  bf162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 bytes from global to shared memory (shared address `dst`), bypassing
// L1; `bytes` of them read (16 or 0), the rest zeros.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices from shared memory: lanes 8i .. 8i + 7 give the
// row addresses (16 bytes each) of matrix i, and r[i] receives its fragment
// (row lane / 4, columns 2 (lane % 4) and + 1). With .trans, matrix i is
// read transposed: r[i] holds rows 2 (lane % 4) and + 1 of column lane / 4.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void st_shared32(unsigned addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v));
}

__device__ __forceinline__ uint4 ld_shared128(unsigned addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0,%1,%2,%3}, [%4];\n" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}

// The SM count of the current device (host), read once per device: the
// launches that size their grids by it call this every time.
inline int sm_count() {
  constexpr int kMaxDevices = 64;
  static int counts[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) dev = 0;
  if (counts[dev] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = sms > 1 ? sms : 1;
  }
  return counts[dev];
}

// One output value of the quant matmuls, fp32 or rounded once to bf16.
template <bool F32OUT>
__device__ __forceinline__ void store_out(void* out, long long idx, float v) {
  if (F32OUT) {
    static_cast<float*>(out)[idx] = v;
  } else {
    static_cast<bf16*>(out)[idx] = __float2bfloat16_rn(v);
  }
}

// Four signed int8 values of a 32-bit word widened to fp32, exactly, with a
// byte permute and a subtraction per value (no int-to-float conversions):
// 0x4B000000 | u is the float 2^23 + u for a byte u, and u = q + 128.
__device__ __forceinline__ void s8x4_to_float(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | k)) - 8388736.f;
  }
}

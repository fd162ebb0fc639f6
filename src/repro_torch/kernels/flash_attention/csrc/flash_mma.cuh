// The warp-level mma.sync, ldmatrix, cp.async and TF32 / bf16 splitting
// helpers of the flash-attention kernels for Hopper (sm_90a), shared by
// flash_attention.cu and flash_attention_bwd.cu (each includes it; the
// kernel build hashes it into both libraries' names).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes = 0 writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a·b, a 16x8 (row), b 8x8 (col), TF32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a·b, a 16x16 (row), b 16x8 (col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x (f32 bits) = hi + lo + O(2^-22 |x|), both rounded to TF32 to nearest, ties
// away from zero, as cvt.rna.tf32.f32 rounds (which lowers to ~6 instructions
// on sm_90a): hi adds half of its last kept bit and clears the 13 dropped
// bits; lo = x - hi is exact and only gets the half bit added, since the
// tensor core ignores an operand's 13 low bits. Inf gives hi = Inf (lo =
// (Inf - Inf) + 0x1000 wraps CUDA's NaN 0x7fffffff to -0); a NaN must be
// quiet_nan's first, since the rounding wraps 0x7fffffff to -0 and rounds a
// NaN with only low payload bits to Inf. P (in [0, 1], or NaN where a score
// is) needs no such care: a NaN p also makes l NaN, and the floor keeps it.
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(__uint_as_float(x), __uint_as_float(hi))) + 0x1000u;
}
template <int N>
__device__ __forceinline__ void split_tf32(const uint32_t (&x)[N], uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    split_tf32(x[i], hi[i], lo[i]);
  }
}
// any NaN as 0x7fc00000, which split_tf32 keeps a NaN in hi
__device__ __forceinline__ float quiet_nan(float x) {
  return x != x ? __uint_as_float(0x7fc00000u) : x;
}
// 3xTF32: d += a_lo·b_hi + a_hi·b_lo + a_hi·b_hi (small terms first).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], uint32_t b0_hi,
                                           uint32_t b1_hi, uint32_t b0_lo, uint32_t b1_lo) {
  mma_tf32(d, a_lo, b0_hi, b1_hi);
  mma_tf32(d, a_hi, b0_lo, b1_lo);
  mma_tf32(d, a_hi, b0_hi, b1_hi);
}

// 2^x by the SFU (ex2.approx.ftz: ~2 ulp; results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 as a bf16 pair, the first in the low half (the mma operand order)
__device__ __forceinline__ uint32_t pack_bf16(float lo_half, float hi_half) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo_half, hi_half);
  return *reinterpret_cast<uint32_t*>(&p);
}
__device__ __forceinline__ float bf16_low(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float bf16_high(uint32_t p) { return __uint_as_float(p & 0xffff0000u); }

__device__ __forceinline__ void load16(uint32_t (&r)[4], const float* p) {
  *reinterpret_cast<uint4*>(r) = *reinterpret_cast<const uint4*>(p);
}

}  // namespace

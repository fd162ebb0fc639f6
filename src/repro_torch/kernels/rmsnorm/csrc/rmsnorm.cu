// Fused RMSNorm for Hopper (sm_90a).
//
//   out[r, :] = x[r, :] * (1 / sqrt(sum(x[r, :]^2) / D + eps)) * scale[:]
//
// with the sum in f32 and the output in x's dtype. Replaces the TPU kernel
// src/repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas.
//
// Bound: memory. A row of D values is read once and written once, with
// about three operations an element and no tensor-core work, so the least
// time is the bytes over the card's memory rate: at the long prefill's
// [16384, 896] f32 that is 117 MB, 35 us at 3.35 TB/s. What the design does
// about it: one block a row, so every row is read from device memory once:
// the first pass loads it (coalesced, neighbouring threads on neighbouring
// columns) into shared memory in f32 while each thread sums its squares;
// warp shuffles and one shared-memory step reduce the sum; the second pass
// scales from shared memory and writes the row once. At decode's [8, 896]
// the launch itself dominates.
//
// The inverse root is 1.0f / sqrtf(.): both IEEE round-to-nearest without
// fast math (nvcc's default -prec-sqrt=true -prec-div=true), so it is
// within one ulp of the exact 1/sqrt; the plain version's torch.rsqrt is
// within a few. With the summation order that differs too, the kernel
// agrees with the plain version to a few f32 ulps of the output (and to one
// bf16 ulp after rounding to bf16).
//
// x is f32 or bf16; scale is f32 or x's dtype; D <= 8192 (the row in f32
// fits the default 48 KB of shared memory).
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with a
// plain C interface.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMaxD = 8192;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, int d, float eps) {
  extern __shared__ float row_s[];   // the row in f32
  __shared__ float warp_sums[kWarps];
  const int64_t r = blockIdx.x;
  const T* xr = x + r * d;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_float(xr[i]);
    row_s[i] = v;
    acc = fmaf(v, v, acc);
  }
  acc = warp_sum(acc);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    warp_sums[warp] = acc;
  }
  __syncthreads();
  if (warp == 0) {
    acc = warp_sum(lane < kWarps ? warp_sums[lane] : 0.0f);
    if (lane == 0) {
      warp_sums[0] = acc;
    }
  }
  __syncthreads();
  const float inv = 1.0f / sqrtf(warp_sums[0] / static_cast<float>(d) + eps);
  T* outr = out + r * d;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    // (x * inv) * scale, in the plain version's order
    store(outr + i, row_s[i] * inv * to_float(scale[i]));
  }
}

template <typename T, typename S>
void launch(const void* x, const void* scale, void* out, int64_t rows, int64_t d,
            float eps, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  rmsnorm_kernel<T, S><<<static_cast<unsigned int>(rows), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(out),
      static_cast<int>(d), eps);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success). Does not
// synchronise. x and out are [rows, d] row-major; scale is [d], f32 or x's dtype.
int rmsnorm_launch(const void* x, int x_is_bf16, const void* scale, int scale_is_bf16,
                   void* out, int64_t rows, int64_t d, float eps, void* stream) {
  if (rows <= 0 || rows > 2147483647LL || d <= 0 || d > kMaxD ||
      (scale_is_bf16 && !x_is_bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!x_is_bf16) {
    launch<float, float>(x, scale, out, rows, d, eps, s);
  } else if (scale_is_bf16) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, d, eps, s);
  } else {
    launch<__nv_bfloat16, float>(x, scale, out, rows, d, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

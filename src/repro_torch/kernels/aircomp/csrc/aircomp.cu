// Fused AirComp aggregation, eq. (10) of the CA-AFL paper, for Hopper (sm_90a).
//
//   y[m] = (sum_i w[i] * float(x[i, m]) + sigma * z[m]) * inv_k
//
// Replaces the TPU kernel src/repro/kernels/aircomp/kernel.py::aircomp_pallas.
// The work is a weighted column reduction over a row-major [K, M] buffer: K·M
// multiply-adds against K·M·sizeof(x) + 2·M·4 + K·4 bytes moved, so the card's
// memory rate bounds it and there is no tensor-core work. Design, simplest that
// is right: one thread per column, so a warp reads 32 neighbouring columns of a
// row (one coalesced 128-byte line for f32); each thread walks the K rows in
// order with an f32 accumulator; the K weights are read once per block into
// shared memory. sigma and inv_k are read from device pointers, like the
// reference's SMEM scalars, so neither forces a host sync nor a rebuild.
// x is f32 or bf16 (converted exactly to f32); w, z and y are f32.
//
// Built by kernel.py with nvcc into a shared library with a plain C interface.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
aircomp_kernel(const T* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ z, const float* __restrict__ sigma,
               const float* __restrict__ inv_k, float* __restrict__ y,
               int64_t rows, int64_t m) {
  extern __shared__ float w_s[];
  for (int64_t i = threadIdx.x; i < rows; i += blockDim.x) {
    w_s[i] = w[i];
  }
  __syncthreads();
  const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= m) {
    return;
  }
  const T* xc = x + col;
  float acc = 0.0f;
#pragma unroll 8
  for (int64_t i = 0; i < rows; ++i) {
    acc = fmaf(w_s[i], to_float(xc[i * m]), acc);
  }
  y[col] = fmaf(sigma[0], z[col], acc) * inv_k[0];
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success). Does not
// synchronise. `rows` weights must fit the default 48 KB of shared memory.
int aircomp_launch(const void* x, int x_is_bf16, const void* w, const void* z,
                   const void* sigma, const void* inv_k, void* y, int64_t rows,
                   int64_t m, void* stream) {
  const int64_t blocks = (m + kThreads - 1) / kThreads;
  if (rows <= 0 || m <= 0 || blocks > 2147483647LL ||
      rows * static_cast<int64_t>(sizeof(float)) > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(rows) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned int>(blocks));
  if (x_is_bf16) {
    aircomp_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
        static_cast<const float*>(z), static_cast<const float*>(sigma),
        static_cast<const float*>(inv_k), static_cast<float*>(y), rows, m);
  } else {
    aircomp_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(z), static_cast<const float*>(sigma),
        static_cast<const float*>(inv_k), static_cast<float*>(y), rows, m);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* aircomp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Fused compress-aggregate AirComp pass, the sparse transport's eq. (10),
// for Hopper (sm_90a).
//
//   c[r, m] = |x[r, m]| >= thr[r] ? x[r, m] : 0
//   y[m]    = (sum_r w[r] * c[r, m] + sigma * z[m]) * inv_k
//
// Replaces the TPU kernel
// src/repro/kernels/aircomp/kernel.py::sparse_aircomp_pallas. The per-row
// threshold (the top-k separator) comes from transport.sparse_thresholds,
// outside the kernel; inside it is one compare and one FMA per element
// against 4 bytes read, so the card's memory rate bounds it: at the main
// path's [40, 7850] f32 it must move C·M·4 + 2·M·4 + 2·C·4 = 1,319,120 bytes,
// 0.394 us at 3.35 TB/s. What the design does about that bound: every byte
// is read once; one thread per column, so a warp reads one coalesced 128-byte
// line of a row; each thread walks the rows in order with an f32
// accumulator; the per-row weight and threshold are read once per block into
// shared memory (2·C floats, so C <= 6144 in the default 48 KB); sigma and
// inv_k are read from device pointers, so a round needs no host sync and a
// new sigma no rebuild. The compare is fabsf(x) >= thr in f32, the very mask
// the error-feedback residual recomputes in PyTorch; the kernel returns only
// the aggregate, as the TPU kernel does.
//
// Built by kernel.py with nvcc into a shared library with a plain C interface.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sparse_aircomp_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ thr,
                      const float* __restrict__ z,
                      const float* __restrict__ sigma,
                      const float* __restrict__ inv_k, float* __restrict__ y,
                      int64_t rows, int64_t m) {
  extern __shared__ float smem[];
  float* w_s = smem;
  float* t_s = smem + rows;
  for (int64_t i = threadIdx.x; i < rows; i += blockDim.x) {
    w_s[i] = w[i];
    t_s[i] = thr[i];
  }
  __syncthreads();
  const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= m) {
    return;
  }
  const float* xc = x + col;
  float acc = 0.0f;
#pragma unroll 8
  for (int64_t i = 0; i < rows; ++i) {
    const float xv = xc[i * m];
    const float c = fabsf(xv) >= t_s[i] ? xv : 0.0f;
    acc = fmaf(w_s[i], c, acc);
  }
  y[col] = fmaf(sigma[0], z[col], acc) * inv_k[0];
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success). Does not
// synchronise. The `rows` weights and thresholds must fit the default 48 KB of
// shared memory.
int sparse_aircomp_launch(const void* x, const void* w, const void* thr,
                          const void* z, const void* sigma, const void* inv_k,
                          void* y, int64_t rows, int64_t m, void* stream) {
  const int64_t blocks = (m + kThreads - 1) / kThreads;
  if (rows <= 0 || m <= 0 || blocks > 2147483647LL ||
      2 * rows * static_cast<int64_t>(sizeof(float)) > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * static_cast<size_t>(rows) * sizeof(float);
  sparse_aircomp_kernel<<<dim3(static_cast<unsigned int>(blocks)), kThreads,
                          smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(thr), static_cast<const float*>(z),
      static_cast<const float*>(sigma), static_cast<const float*>(inv_k),
      static_cast<float*>(y), rows, m);
  return static_cast<int>(cudaGetLastError());
}

const char* sparse_aircomp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

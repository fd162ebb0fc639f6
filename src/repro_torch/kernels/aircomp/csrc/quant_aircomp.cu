// Fused quantize-aggregate AirComp pass, the quantized transport's eq. (10),
// for Hopper (sm_90a).
//
//   q[c, m] = d[c] > 0 ? floor(x[c, m] / d[c] + u[c, m]) * d[c] : x[c, m]
//   y[m]    = (sum_c w[c] * q[c, m] + sigma * z[m]) * inv_k
//
// Replaces the TPU kernel
// src/repro/kernels/aircomp/kernel.py::quant_aircomp_pallas. Per element it
// does one division, one add, one floor, one multiply and one FMA, against
// 8 bytes read (x and u), so the card's memory rate bounds it: at the main
// path's [40, 7850] f32 it must move 2·C·M·4 + 2·M·4 + 2·C·4 = 2,575,120
// bytes, 0.769 us at 3.35 TB/s. What the design does about that bound: every
// byte is read once; one thread per column, so a warp reads one coalesced
// 128-byte line of a row of x and of u; each thread walks the C rows in
// order with an f32 accumulator; the per-row weight and step are read once
// per block into shared memory (2·C floats, so C <= 6144 in the default
// 48 KB); sigma and inv_k are read from device pointers, so a round needs no
// host sync and a new sigma no rebuild.
//
// The rounding must land on the same grid point as the plain version, so
// each step is pinned to IEEE round-to-nearest: __fdiv_rn, __fadd_rn and
// __fmul_rn keep nvcc from contracting x/d + u into an FMA or replacing the
// division by a reciprocal before the floor. Never build with
// --use_fast_math.
//
// Built by kernel.py with nvcc into a shared library with a plain C interface.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
quant_aircomp_kernel(const float* __restrict__ x, const float* __restrict__ u,
                     const float* __restrict__ w, const float* __restrict__ d,
                     const float* __restrict__ z,
                     const float* __restrict__ sigma,
                     const float* __restrict__ inv_k, float* __restrict__ y,
                     int64_t rows, int64_t m) {
  extern __shared__ float smem[];
  float* w_s = smem;
  float* d_s = smem + rows;
  for (int64_t i = threadIdx.x; i < rows; i += blockDim.x) {
    w_s[i] = w[i];
    d_s[i] = d[i];
  }
  __syncthreads();
  const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= m) {
    return;
  }
  const float* xc = x + col;
  const float* uc = u + col;
  float acc = 0.0f;
#pragma unroll 4
  for (int64_t i = 0; i < rows; ++i) {
    const float xv = xc[i * m];
    const float dv = d_s[i];
    float q = xv;
    if (dv > 0.0f) {
      q = __fmul_rn(floorf(__fadd_rn(__fdiv_rn(xv, dv), uc[i * m])), dv);
    }
    acc = fmaf(w_s[i], q, acc);
  }
  y[col] = fmaf(sigma[0], z[col], acc) * inv_k[0];
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success). Does not
// synchronise. The `rows` weights and steps must fit the default 48 KB of
// shared memory.
int quant_aircomp_launch(const void* x, const void* u, const void* w,
                         const void* d, const void* z, const void* sigma,
                         const void* inv_k, void* y, int64_t rows, int64_t m,
                         void* stream) {
  const int64_t blocks = (m + kThreads - 1) / kThreads;
  if (rows <= 0 || m <= 0 || blocks > 2147483647LL ||
      2 * rows * static_cast<int64_t>(sizeof(float)) > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * static_cast<size_t>(rows) * sizeof(float);
  quant_aircomp_kernel<<<dim3(static_cast<unsigned int>(blocks)), kThreads,
                         smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(u),
      static_cast<const float*>(w), static_cast<const float*>(d),
      static_cast<const float*>(z), static_cast<const float*>(sigma),
      static_cast<const float*>(inv_k), static_cast<float*>(y), rows, m);
  return static_cast<int>(cudaGetLastError());
}

const char* quant_aircomp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

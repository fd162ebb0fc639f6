// RMSNorm backward for Hopper (sm_90a): the gradient of rmsnorm.cu's
//
//   y[r, :] = x[r, :] * rstd[r] * scale[:],  rstd[r] = 1 / sqrt(sum(x[r, :]^2) / D + eps),
//
// given dy, in f32 accumulation:
//
//   g        = dy[r, :] * scale[:]
//   dx[r, :] = rstd[r] * g - x[r, :] * (rstd[r]^3 * sum(g * x[r, :]) / D)   (in x's dtype)
//   dscale   = sum over rows of (dy[r, :] * x[r, :]) * rstd[r]              (in scale's dtype)
//
// It replaces no TPU kernel: the JAX package differentiates its pure-JAX
// RMSNorm (src/repro/models/layers.py::rms_norm) and has no backward of
// src/repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas. It is here because
// the port's forward runs rmsnorm.cu, whose output autograd cannot see
// through; the plain version of the same formula is
// repro_torch/kernels/rmsnorm/ref.py::rmsnorm_bwd_ref.
//
// Bound: memory. x and dy are read and dx and dscale written, with a few
// operations an element: at the training shapes (qwen2-0.5b's gather round,
// [1024, 896] f32) 11 MB, 3.3 us at 3.35 TB/s, so the launches dominate.
//
// Design, three launches on the stream, no atomics, so the result is the same
// bit for bit on every run (the seeded server repeats on the card):
//   1. rows: one warp a row, 8 rows a block; the lanes read x and dy in
//      strided scalar loads (a warp's 32 loads are one 128-byte line), sum
//      x^2 and g.x, reduce them by xor shuffles (a fixed order), recompute
//      rstd as the forward does (1.0f / sqrtf(.), IEEE), read the row again
//      (from L1/L2) to write dx, and store rstd for pass 2;
//   2. dscale partials: a block of 8 x 32 threads owns 32 columns of one
//      chunk of rows; thread (ty, tx) sums rows ty, ty + 8, ... of the chunk
//      in order, the 8 sums are added in order through shared memory, and
//      the block writes partial[chunk, columns];
//   3. finish: one thread a column adds the chunks' partials in order.
//
// x and dy are f32 or bf16 (one dtype), scale f32 or x's dtype; D <= 8192.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with a
// plain C interface.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 32;   // columns a dscale-partial block
constexpr int64_t kMaxD = 8192;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float& p, float v) { p = v; }
__device__ __forceinline__ void from_float(__nv_bfloat16& p, float v) { p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads) rmsnorm_bwd_rows(
    const T* __restrict__ x, const T* __restrict__ dy, const S* __restrict__ scale,
    T* __restrict__ dx, float* __restrict__ rstd_out, int64_t rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t r = int64_t(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= rows) {
    return;
  }
  const T* xr = x + r * d;
  const T* gr = dy + r * d;
  float ss = 0.0f, dot = 0.0f;
  for (int c = lane; c < d; c += 32) {
    const float xv = to_float(xr[c]);
    const float g = to_float(gr[c]) * to_float(scale[c]);
    ss = fmaf(xv, xv, ss);
    dot = fmaf(g, xv, dot);
  }
  ss = warp_sum(ss);
  dot = warp_sum(dot);
  const float rstd = 1.0f / sqrtf(ss / float(d) + eps);
  const float coef = rstd * rstd * rstd * dot / float(d);
  T* dxr = dx + r * d;
  for (int c = lane; c < d; c += 32) {
    const float xv = to_float(xr[c]);
    const float g = to_float(gr[c]) * to_float(scale[c]);
    from_float(dxr[c], rstd * g - xv * coef);
  }
  if (lane == 0) {
    rstd_out[r] = rstd;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rmsnorm_bwd_dscale_partial(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ rstd,
    float* __restrict__ partial, int64_t rows, int d, int64_t rows_per_chunk) {
  __shared__ float red[kWarps][kCols];
  const int tx = threadIdx.x & (kCols - 1), ty = threadIdx.x / kCols;
  const int col = blockIdx.x * kCols + tx;
  const int64_t r0 = int64_t(blockIdx.y) * rows_per_chunk;
  const int64_t r1 = r0 + rows_per_chunk < rows ? r0 + rows_per_chunk : rows;
  float acc = 0.0f;
  if (col < d) {
    for (int64_t r = r0 + ty; r < r1; r += kWarps) {
      acc += to_float(dy[r * d + col]) * to_float(x[r * d + col]) * rstd[r];
    }
  }
  red[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && col < d) {
    float sum = red[0][tx];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      sum += red[w][tx];
    }
    partial[int64_t(blockIdx.y) * d + col] = sum;
  }
}

template <typename S>
__global__ void rmsnorm_bwd_dscale_finish(const float* __restrict__ partial,
                                          S* __restrict__ dscale, int chunks, int d) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= d) {
    return;
  }
  float sum = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    sum += partial[int64_t(c) * d + col];
  }
  from_float(dscale[col], sum);
}

template <typename T, typename S>
cudaError_t launch(const void* x, const void* dy, const void* scale, void* dx, void* dscale,
                   float* scratch, int64_t rows, int d, int chunks, float eps,
                   cudaStream_t stream) {
  float* rstd = scratch;
  float* partial = scratch + rows;
  const int64_t row_blocks = (rows + kWarps - 1) / kWarps;
  rmsnorm_bwd_rows<T, S><<<static_cast<unsigned>(row_blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const S*>(scale),
      static_cast<T*>(dx), rstd, rows, d, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t rpc = (rows + chunks - 1) / chunks;
  const dim3 grid((d + kCols - 1) / kCols, chunks);
  rmsnorm_bwd_dscale_partial<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), rstd, partial, rows, d, rpc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_dscale_finish<S><<<(d + 255) / 256, 256, 0, stream>>>(
      partial, static_cast<S*>(dscale), chunks, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns a CUDA error code (0 on success). Does not
// synchronise. x, dy and dx are [rows, d] row-major in one dtype; scale and
// dscale are [d], f32 or x's dtype; scratch holds rows + chunks * d f32
// (rstd, then the dscale partials), 1 <= chunks <= rows.
int rmsnorm_bwd_launch(const void* x, const void* dy, int x_is_bf16, const void* scale,
                       int scale_is_bf16, void* dx, void* dscale, void* scratch, int64_t rows,
                       int64_t d, int64_t chunks, float eps, void* stream) {
  if (rows <= 0 || rows > 2147483647LL * kWarps || d <= 0 || d > kMaxD || chunks < 1 ||
      chunks > rows || chunks > 65535 || (scale_is_bf16 && !x_is_bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  const int di = static_cast<int>(d), ci = static_cast<int>(chunks);
  cudaError_t err;
  if (!x_is_bf16) {
    err = launch<float, float>(x, dy, scale, dx, dscale, sc, rows, di, ci, eps, s);
  } else if (scale_is_bf16) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, dy, scale, dx, dscale, sc, rows, di, ci, eps, s);
  } else {
    err = launch<__nv_bfloat16, float>(x, dy, scale, dx, dscale, sc, rows, di, ci, eps, s);
  }
  return static_cast<int>(err);
}

const char* rmsnorm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

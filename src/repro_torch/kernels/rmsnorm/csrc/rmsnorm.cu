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
// [16384, 896] f32 that is 117 MB, 35 us at 3.35 TB/s ([16384, 2048]:
// 268 MB, 80 us). What the design does about it: one warp a row and 8 rows
// a block (fewer when there are too few rows to give every SM a block), so
// a row costs no block-wide barrier and no shared memory; each lane reads
// its part of the row in 16-byte vectors (4 f32 or 8 bf16, lane l taking
// vectors l, l + 32, ...), all of them in flight at once, and keeps them in
// registers (NV vectors a lane, a compile-time count: 7 of 8 slots at D =
// 896 f32, 16 at D = 2048, 32 at xLSTM's inner 4096) between the sum of
// squares and the scaling, so every row is read from device memory once;
// the sum is reduced by warp shuffles alone; each lane reads its vectors of
// scale once and writes the scaled row in 16-byte vectors. A row wider than
// 32 vectors a lane (D > 4096 f32) is summed and then scaled in a strided
// loop, 8 vectors in flight, that reads it twice (the second read from L2).
// With fewer rows than SMs (decode: 4 or 8 rows) one warp a row would leave
// a whole row's latency to one warp, so there a block of 8 warps takes a
// row and adds its 8 warp sums in order through shared memory. Where D is
// not a whole number of vectors or a pointer is not 16-byte aligned, the
// same kernel runs with one element a vector. At decode the launch itself
// dominates.
//
// The inverse root is 1.0f / sqrtf(.): both IEEE round-to-nearest without
// fast math (nvcc's default -prec-sqrt=true -prec-div=true), so it is
// within one ulp of the exact 1/sqrt; the plain version's torch.rsqrt is
// within a few. The output is (x * inv) * scale, in the plain version's
// order. With the summation order that differs too, the kernel agrees with
// the plain version to a few f32 ulps of the output (and to one bf16 ulp
// after rounding to bf16).
//
// x is f32 or bf16; scale is f32 or x's dtype; D <= 8192.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with a
// plain C interface.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // rows a block at most, one a warp
constexpr int kThreads = 32 * kWarps;
constexpr int64_t kMaxD = 8192;

// W values of T as one load: 16 bytes, or a single element
template <typename T, int W>
struct Vec;
template <>
struct Vec<float, 4> {
  float4 v;
};
template <>
struct Vec<__nv_bfloat16, 8> {
  uint4 v;
};
template <typename T>
struct Vec<T, 1> {
  T v;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float& p, float v) { p = v; }
__device__ __forceinline__ void from_float(__nv_bfloat16& p, float v) { p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void unpack(const Vec<float, 4>& v, float (&f)[4]) {
  f[0] = v.v.x;
  f[1] = v.v.y;
  f[2] = v.v.z;
  f[3] = v.v.w;
}
__device__ __forceinline__ void unpack(const Vec<__nv_bfloat16, 8>& v, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v.v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
template <typename T>
__device__ __forceinline__ void unpack(const Vec<T, 1>& v, float (&f)[1]) {
  f[0] = to_float(v.v);
}

__device__ __forceinline__ void pack(const float (&f)[4], Vec<float, 4>& v) {
  v.v = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void pack(const float (&f)[8], Vec<__nv_bfloat16, 8>& v) {
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v.v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  }
}
template <typename T>
__device__ __forceinline__ void pack(const float (&f)[1], Vec<T, 1>& v) {
  from_float(v.v, f[0]);
}

// W values of scale, in f32
__device__ __forceinline__ void load_scale(const float* p, float (&f)[4]) {
  Vec<float, 4> v;
  v.v = *reinterpret_cast<const float4*>(p);
  unpack(v, f);
}
__device__ __forceinline__ void load_scale(const float* p, float (&f)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  f[0] = lo.x;
  f[1] = lo.y;
  f[2] = lo.z;
  f[3] = lo.w;
  f[4] = hi.x;
  f[5] = hi.y;
  f[6] = hi.z;
  f[7] = hi.w;
}
__device__ __forceinline__ void load_scale(const __nv_bfloat16* p, float (&f)[8]) {
  Vec<__nv_bfloat16, 8> v;
  v.v = *reinterpret_cast<const uint4*>(p);
  unpack(v, f);
}
template <typename S>
__device__ __forceinline__ void load_scale(const S* p, float (&f)[1]) {
  f[0] = to_float(*p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

template <typename T, int W>
__device__ __forceinline__ float sum_squares(const Vec<T, W>& v, float acc) {
  float f[W];
  unpack(v, f);
#pragma unroll
  for (int e = 0; e < W; ++e) {
    acc = fmaf(f[e], f[e], acc);
  }
  return acc;
}

// (x * inv) * scale of one vector, stored
template <typename T, typename S, int W>
__device__ __forceinline__ void scale_store(const Vec<T, W>& v, const S* scale, float inv,
                                            Vec<T, W>* out) {
  float f[W], s[W];
  unpack(v, f);
  load_scale(scale, s);
#pragma unroll
  for (int e = 0; e < W; ++e) {
    f[e] = f[e] * inv * s[e];
  }
  Vec<T, W> o;
  pack(f, o);
  *out = o;
}

// The row's sum of squares over its G warps: shuffles within a warp, then
// (G > 1) the G warp sums in order through shared memory
template <int G>
__device__ __forceinline__ float row_sum(float acc) {
  acc = warp_sum(acc);
  if constexpr (G > 1) {
    __shared__ float warp_sums[G];
    if ((threadIdx.x & 31) == 0) {
      warp_sums[threadIdx.x >> 5] = acc;
    }
    __syncthreads();
    acc = 0.0f;
#pragma unroll
    for (int w = 0; w < G; ++w) {
      acc += warp_sums[w];
    }
  }
  return acc;
}

// G warps a row (1, or 8: one row a block); NV > 0: a thread keeps its NV
// vectors in registers; NV == 0: a strided loop that reads the row twice
template <typename T, typename S, int W, int G, int NV>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ out,
               int64_t rows, int d, float eps) {
  constexpr int L = 32 * G;   // threads a row
  const int t = threadIdx.x % L;
  const int64_t row = int64_t(blockIdx.x) * (blockDim.x / L) + threadIdx.x / L;
  if (row >= rows) {   // whole rows only: a block of G = 8 holds one row
    return;
  }
  const Vec<T, W>* xv = reinterpret_cast<const Vec<T, W>*>(x + row * d);
  Vec<T, W>* ov = reinterpret_cast<Vec<T, W>*>(out + row * d);
  const int nvec = d / W;
  float acc = 0.0f;
  if constexpr (NV > 0) {
    Vec<T, W> v[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (t + L * i < nvec) {
        v[i] = xv[t + L * i];
      }
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (t + L * i < nvec) {
        acc = sum_squares(v[i], acc);
      }
    }
    const float inv = 1.0f / sqrtf(row_sum<G>(acc) / static_cast<float>(d) + eps);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = t + L * i;
      if (j < nvec) {
        scale_store(v[i], scale + j * W, inv, ov + j);
      }
    }
  } else {
#pragma unroll 8
    for (int j = t; j < nvec; j += L) {
      acc = sum_squares(xv[j], acc);
    }
    const float inv = 1.0f / sqrtf(row_sum<G>(acc) / static_cast<float>(d) + eps);
#pragma unroll 8
    for (int j = t; j < nvec; j += L) {
      scale_store(xv[j], scale + j * W, inv, ov + j);
    }
  }
}

template <typename T, typename S, int W, int G>
void launch_g(const T* x, const S* scale, T* out, int64_t rows, int d, float eps,
              unsigned int grid, int threads, cudaStream_t stream) {
  const int64_t need = (d / W + 32 * G - 1) / (32 * G);   // vectors a thread
  if (need <= 1) {
    rmsnorm_kernel<T, S, W, G, 1><<<grid, threads, 0, stream>>>(x, scale, out, rows, d, eps);
  } else if (need <= 2) {
    rmsnorm_kernel<T, S, W, G, 2><<<grid, threads, 0, stream>>>(x, scale, out, rows, d, eps);
  } else if (need <= 4) {
    rmsnorm_kernel<T, S, W, G, 4><<<grid, threads, 0, stream>>>(x, scale, out, rows, d, eps);
  } else if (need <= 8) {
    rmsnorm_kernel<T, S, W, G, 8><<<grid, threads, 0, stream>>>(x, scale, out, rows, d, eps);
  } else if (need <= 16) {
    rmsnorm_kernel<T, S, W, G, 16><<<grid, threads, 0, stream>>>(x, scale, out, rows, d, eps);
  } else if (need <= 32) {
    rmsnorm_kernel<T, S, W, G, 32><<<grid, threads, 0, stream>>>(x, scale, out, rows, d, eps);
  } else {
    rmsnorm_kernel<T, S, W, G, 0><<<grid, threads, 0, stream>>>(x, scale, out, rows, d, eps);
  }
}

// fewer rows than SMs (decode): a block of 8 warps a row, so the row's loads
// spread over 8 warps and the rows over as many SMs; else one warp a row,
// 8 rows a block, fewer when that would leave SMs without a block
template <typename T, typename S, int W>
void launch_w(const void* x, const void* scale, void* out, int64_t rows, int64_t d,
              float eps, int sms, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const S* sp = static_cast<const S*>(scale);
  T* op = static_cast<T*>(out);
  const int di = static_cast<int>(d);
  if (rows < sms) {
    launch_g<T, S, W, kWarps>(xp, sp, op, rows, di, eps, static_cast<unsigned int>(rows),
                              kThreads, stream);
    return;
  }
  const int64_t per_sm = rows / sms;
  const int warps = per_sm >= kWarps ? kWarps : static_cast<int>(per_sm);
  launch_g<T, S, W, 1>(xp, sp, op, rows, di, eps,
                       static_cast<unsigned int>((rows + warps - 1) / warps), 32 * warps,
                       stream);
}

// 16-byte vectors where D is a whole number of them and every pointer is
// 16-byte aligned, else one element a vector
template <typename T, typename S>
void launch(const void* x, const void* scale, void* out, int64_t rows, int64_t d,
            float eps, int sms, cudaStream_t stream) {
  constexpr int W = 16 / sizeof(T);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(scale) |
                         reinterpret_cast<uintptr_t>(out);
  if (d % W == 0 && ptrs % 16 == 0) {
    launch_w<T, S, W>(x, scale, out, rows, d, eps, sms, stream);
  } else {
    launch_w<T, S, 1>(x, scale, out, rows, d, eps, sms, stream);
  }
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
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!x_is_bf16) {
    launch<float, float>(x, scale, out, rows, d, eps, sms, s);
  } else if (scale_is_bf16) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, d, eps, sms, s);
  } else {
    launch<__nv_bfloat16, float>(x, scale, out, rows, d, eps, sms, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

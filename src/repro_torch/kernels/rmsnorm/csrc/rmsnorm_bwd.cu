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
// Bound: memory. x and dy are read once and dx written once, with a few
// operations an element: at qwen2-0.5b's training shape, [1024, 896] f32,
// 11 MB, 3.3 us at 3.35 TB/s; at xlstm-1.3b's [1024, 4096] 50 MB, 15 us.
//
// Design: one launch, one pass over the rows, no atomic in any sum, so the
// result is the same bit for bit on every run (the seeded server repeats
// on the card):
//   1. rows. A block of 8 warps owns a contiguous band of rows; G warps
//      take a row (G = 1, 2, 4, 8: the least power of two with G * 1024 >=
//      D), so a block holds 8 / G rows at once, one a slot, and a slot
//      walks rows band_start + slot, + 8 / G, ... Each lane loads all of
//      its part of the row's x and dy at once in 16-byte vectors (4 f32 or
//      8 bf16; lane l of the slot's 32 G threads takes vectors l, l + 32 G,
//      ...: at most 8 f32 or 4 bf16 vectors of each a lane, a compile-time
//      count) and keeps them in registers between the two row sums and the
//      dx store, so every row of x and dy is read from device memory once
//      at every D <= 8192 (none falls back to a second read). The sums,
//      sum(x^2) and sum(g * x), are reduced by xor shuffles and, for G > 1,
//      the G warp sums added in order through shared memory behind a named
//      barrier of the slot's warps. rstd is 1.0f / sqrtf(.), as the
//      forward computes it. dx is stored in 16-byte vectors. The same
//      registers give (dy * x) * rstd of the lane's columns, added into
//      per-thread column accumulators over the slot's rows in order.
//   2. dscale partials. The slots' accumulators go to shared memory, are
//      added in slot order, and the block writes its column partial to
//      partial[block, :] in device memory.
//   3. finish. A grid barrier (the grid is resident at once: a cooperative
//      launch, two blocks an SM at most): each block's first thread
//      releases the block's partial with a fence and adds one to an int32
//      count, then waits until the count reaches the number of blocks. Two
//      counts alternate by the parity of a generation word, which the last
//      block to arrive steps for the next call; block 0 zeroes the other
//      count, the previous call's, for the call after. Then each
//      block adds the partials of its slice of ceil(D / blocks) columns
//      into dscale, its loads staged in shared memory, all in flight at
//      once: a warp a column, lane l adding blocks l, l + 32, ...
//      in order, the lane sums reduced by xor shuffles. The atomic only
//      counts arrivals; the order of every sum is fixed by the shape (the
//      blocks come from kernel.py::bwd_blocks).
// Deviation from the last block finishing alone: at 1,024 rows and D = 896
// the 128 blocks' partials are 128 x 896 floats, too many for one SM to add
// in a few microseconds; a first build reduced them in clusters of 8 through
// distributed shared memory before the last cluster finished, and its chain
// of three cluster barriers, the fence, the counter and the finish cost 4.7
// us of its 9.9 at [1024, 896] on an H100 SXM at 700 W (the rows alone 5.2,
// the empty launch 1.9). The grid barrier keeps one fence, one atomic and
// one wait, and spreads the finish over every block (8.0 us); waiting on
// the count itself rather than on a generation the last block releases
// took 0.6 us more off (7.5 us).
//
// Where D is not a whole number of vectors or a pointer is not 16-byte
// aligned, the same kernel runs with one element a vector (32 a lane at
// most). x and dy are f32 or bf16 (one dtype), scale f32 or x's dtype;
// D <= 8192; at most 512 blocks, and no more than the card holds at once
// (the launch is refused otherwise). The three barrier words must be 0
// before the first call; calls on one device must not overlap (they share
// them).
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with a
// plain C interface.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;         // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpCols = 1024;   // columns a warp holds at most
constexpr int64_t kMaxD = 8192;
constexpr int kMaxBlocks = 512;
// the finish stages blocks x ceil(D / blocks) < D + blocks partials
constexpr int kRedFloats = kWarps * kWarpCols + kMaxBlocks;

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
  for (int o = 16; o > 0; o >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

// named barrier 1 + slot of the `count` threads of one slot (ids fixed at
// compile time, so a block reserves only the ones it uses)
template <int kSlots>
__device__ __forceinline__ void slot_barrier(int slot, int count) {
  if constexpr (kSlots == 1) {
    asm volatile("bar.sync 1, %0;" ::"r"(count) : "memory");
  } else if constexpr (kSlots == 2) {
    if (slot == 0) {
      asm volatile("bar.sync 1, %0;" ::"r"(count) : "memory");
    } else {
      asm volatile("bar.sync 2, %0;" ::"r"(count) : "memory");
    }
  } else {
    switch (slot) {
      case 0: asm volatile("bar.sync 1, %0;" ::"r"(count) : "memory"); break;
      case 1: asm volatile("bar.sync 2, %0;" ::"r"(count) : "memory"); break;
      case 2: asm volatile("bar.sync 3, %0;" ::"r"(count) : "memory"); break;
      default: asm volatile("bar.sync 4, %0;" ::"r"(count) : "memory"); break;
    }
  }
}

// The grid barrier over every block of the (resident) grid; thread 0 calls
// it after a __syncthreads that follows the writes it publishes. words[2]
// is a generation g: the call counts arrivals in words[g & 1] and waits for
// that count to reach the number of blocks. Block 0 zeroes the other count
// (the previous call's, finished by stream order) for the next call, and
// the last block to arrive steps the generation.
__device__ __forceinline__ void grid_barrier(unsigned* words) {
  unsigned gen;
  asm volatile("ld.global.relaxed.gpu.b32 %0, [%1];" : "=r"(gen) : "l"(words + 2) : "memory");
  if (blockIdx.x == 0) {
    words[(gen & 1) ^ 1] = 0;
  }
  // releases the writes of every thread of the block made before the
  // __syncthreads that precedes this call
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
  const unsigned arrived = atomicAdd(words + (gen & 1), 1u);
  if (arrived == gridDim.x - 1) {
    words[2] = gen + 1;
  }
  unsigned seen;
  do {
    asm volatile("ld.global.acquire.gpu.b32 %0, [%1];" : "=r"(seen) : "l"(words + (gen & 1))
                 : "memory");
  } while (seen < gridDim.x);
}

// G warps a row, W values a vector, NV vectors a lane at most
template <typename T, typename S, int W, int G>
__global__ void __launch_bounds__(kThreads, 2)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const S* __restrict__ scale, T* __restrict__ dx, S* __restrict__ dscale,
                   float* __restrict__ partial, unsigned* __restrict__ count, int64_t rows, int d,
                   int64_t rows_per_block, float eps) {
  constexpr int L = 32 * G;                   // threads a row
  constexpr int kSlots = kWarps / G;          // rows a block holds at once
  constexpr int NV = kWarpCols / (32 * W);    // vectors a lane at most
  __shared__ float red[kRedFloats];   // [slot][d] column partials (slots * d <= 8192), then the finish's
  __shared__ float warp_sums[kSlots][2][G][2];  // [slot][parity][warp][sum(x^2), sum(g.x)]
  const int t = threadIdx.x % L, slot = threadIdx.x / L;
  const int nvec = d / W;
  const int64_t r0 = int64_t(blockIdx.x) * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;

  float acc[NV][W];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int e = 0; e < W; ++e) {
      acc[i][e] = 0.0f;
    }
  }
  int parity = 0;
  for (int64_t r = r0 + slot; r < r1; r += kSlots) {
    const Vec<T, W>* xv = reinterpret_cast<const Vec<T, W>*>(x + r * d);
    const Vec<T, W>* gv = reinterpret_cast<const Vec<T, W>*>(dy + r * d);
    Vec<T, W> xr[NV], gr[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {   // every load of the row in flight at once
      if (t + L * i < nvec) {
        xr[i] = xv[t + L * i];
        gr[i] = gv[t + L * i];
      }
    }
    float ss = 0.0f, dot = 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = t + L * i;
      if (j < nvec) {
        float xf[W], gf[W], sf[W];
        unpack(xr[i], xf);
        unpack(gr[i], gf);
        load_scale(scale + j * W, sf);
#pragma unroll
        for (int e = 0; e < W; ++e) {
          ss = fmaf(xf[e], xf[e], ss);
          dot = fmaf(gf[e] * sf[e], xf[e], dot);
        }
      }
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    if constexpr (G > 1) {   // the row's G warp sums in order
      const int warp = t >> 5;
      if ((t & 31) == 0) {
        warp_sums[slot][parity][warp][0] = ss;
        warp_sums[slot][parity][warp][1] = dot;
      }
      slot_barrier<kSlots>(slot, L);
      ss = warp_sums[slot][parity][0][0];
      dot = warp_sums[slot][parity][0][1];
#pragma unroll
      for (int w = 1; w < G; ++w) {
        ss += warp_sums[slot][parity][w][0];
        dot += warp_sums[slot][parity][w][1];
      }
      parity ^= 1;   // a slot's next row writes the other half
    }
    const float rstd = 1.0f / sqrtf(ss / float(d) + eps);
    const float coef = rstd * rstd * rstd * dot / float(d);
    Vec<T, W>* ov = reinterpret_cast<Vec<T, W>*>(dx + r * d);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = t + L * i;
      if (j < nvec) {
        float xf[W], gf[W], sf[W], o[W];
        unpack(xr[i], xf);
        unpack(gr[i], gf);
        load_scale(scale + j * W, sf);
#pragma unroll
        for (int e = 0; e < W; ++e) {
          o[e] = rstd * (gf[e] * sf[e]) - xf[e] * coef;
          acc[i][e] = fmaf(gf[e] * xf[e], rstd, acc[i][e]);
        }
        Vec<T, W> out;
        pack(o, out);
        ov[j] = out;
      }
    }
  }

  // the block's column partial: its slots' accumulators in slot order
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = t + L * i;
    if (j < nvec) {
#pragma unroll
      for (int e = 0; e < W; ++e) {
        red[slot * d + j * W + e] = acc[i][e];
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float sum = red[c];
#pragma unroll
    for (int q = 1; q < kSlots; ++q) {
      sum += red[q * d + c];
    }
    partial[int64_t(blockIdx.x) * d + c] = sum;
  }

  __syncthreads();
  if (threadIdx.x == 0) {
    grid_barrier(count);
  }
  __syncthreads();

  // the finish: this block's columns [c0, c0 + w) of every block's partial,
  // staged in shared memory with all loads in flight; a warp a column, lane
  // l adding blocks l, l + 32, ... in order, the 32 lane sums reduced by xor
  // shuffles
  const int blocks = static_cast<int>(gridDim.x);
  const int per = (d + blocks - 1) / blocks;
  const int c0 = static_cast<int>(blockIdx.x) * per;
  const int w = c0 + per < d ? per : d - c0;
  if (w <= 0) {
    return;
  }
  const int n = blocks * w;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int k = i / w;
    red[i] = __ldcg(partial + int64_t(k) * d + c0 + (i - k * w));
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x >> 5; c < w; c += kWarps) {
    float sum = 0.0f;
    for (int k = lane; k < blocks; k += 32) {
      sum += red[k * w + c];
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      from_float(dscale[c0 + c], sum);
    }
  }
}

// a cooperative launch: the grid barrier needs every block resident at once
template <typename T, typename S, int W, int G>
cudaError_t launch_g(const T* x, const T* dy, const S* scale, T* dx, S* dscale,
                     float* partial, unsigned* count, int64_t rows, int d, int blocks,
                     float eps, cudaStream_t stream) {
  int64_t rpb = (rows + blocks - 1) / blocks;
  void* params[] = {&x, &dy, &scale, &dx, &dscale, &partial, &count, &rows, &d, &rpb, &eps};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(rmsnorm_bwd_kernel<T, S, W, G>), dim3(blocks),
      dim3(kThreads), params, 0, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();   // not reported again by the next launch
  }
  return err;
}

template <typename T, typename S, int W>
cudaError_t launch_w(const void* x, const void* dy, const void* scale, void* dx, void* dscale,
                     float* partial, unsigned* count, int64_t rows, int d, int blocks,
                     float eps, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(dy);
  const S* sp = static_cast<const S*>(scale);
  T* op = static_cast<T*>(dx);
  S* dp = static_cast<S*>(dscale);
  if (d <= kWarpCols) {
    return launch_g<T, S, W, 1>(xp, gp, sp, op, dp, partial, count, rows, d, blocks, eps, stream);
  } else if (d <= 2 * kWarpCols) {
    return launch_g<T, S, W, 2>(xp, gp, sp, op, dp, partial, count, rows, d, blocks, eps, stream);
  } else if (d <= 4 * kWarpCols) {
    return launch_g<T, S, W, 4>(xp, gp, sp, op, dp, partial, count, rows, d, blocks, eps, stream);
  }
  return launch_g<T, S, W, 8>(xp, gp, sp, op, dp, partial, count, rows, d, blocks, eps, stream);
}

// 16-byte vectors where D is a whole number of them and x, dy, dx and
// scale are 16-byte aligned, else one element a vector
template <typename T, typename S>
cudaError_t launch(const void* x, const void* dy, const void* scale, void* dx, void* dscale,
                   float* partial, unsigned* count, int64_t rows, int d, int blocks,
                   float eps, cudaStream_t stream) {
  constexpr int W = 16 / sizeof(T);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
                         reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(scale);
  if (d % W == 0 && ptrs % 16 == 0) {
    return launch_w<T, S, W>(x, dy, scale, dx, dscale, partial, count, rows, d, blocks, eps,
                             stream);
  }
  return launch_w<T, S, 1>(x, dy, scale, dx, dscale, partial, count, rows, d, blocks, eps,
                           stream);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns a CUDA error code (0 on success). Does not
// synchronise. x, dy and dx are [rows, d] row-major in one dtype; scale and
// dscale are [d], f32 or x's dtype; partial holds blocks * d f32 (the
// blocks' dscale partials); counter is the grid barrier's three int32
// words, 0 before the first call (each call leaves them ready for the
// next); 1 <= blocks <= 512 (kernel.py::bwd_blocks), refused if the card
// cannot hold them at once.
int rmsnorm_bwd_launch(const void* x, const void* dy, int x_is_bf16, const void* scale,
                       int scale_is_bf16, void* dx, void* dscale, void* partial, void* counter,
                       int64_t rows, int64_t d, int64_t blocks, float eps, void* stream) {
  if (rows <= 0 || d <= 0 || d > kMaxD || blocks < 1 || blocks > kMaxBlocks ||
      (scale_is_bf16 && !x_is_bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(partial);
  unsigned* cp = static_cast<unsigned*>(counter);
  const int di = static_cast<int>(d), bi = static_cast<int>(blocks);
  cudaError_t err;
  if (!x_is_bf16) {
    err = launch<float, float>(x, dy, scale, dx, dscale, pp, cp, rows, di, bi, eps, s);
  } else if (scale_is_bf16) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, dy, scale, dx, dscale, pp, cp, rows, di, bi,
                                               eps, s);
  } else {
    err = launch<__nv_bfloat16, float>(x, dy, scale, dx, dscale, pp, cp, rows, di, bi, eps, s);
  }
  return static_cast<int>(err);
}

const char* rmsnorm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Fused AirComp aggregation, eq. (10) of the CA-AFL paper, for Hopper (sm_90a).
//
//   y[m] = (sum_i w[i] * float(x[i, m]) + sigma * z[m]) * inv_k
//
// Replaces the TPU kernel src/repro/kernels/aircomp/kernel.py::aircomp_pallas.
// The work is a weighted column reduction over a row-major [K, M] buffer: K·M
// multiply-adds against K·M·sizeof(x) + 2·M·4 + K·4 bytes moved, so the card's
// memory rate bounds it and there is no tensor-core work: at the main path's
// [40, 7850] f32 that is 1,318,960 bytes, 0.394 us at 3.35 TB/s. At that size
// the time goes to latency: one thread a column (256 a block) fills 31 of the
// 132 SMs, and a thread that walks the 40 rows in order with one accumulator
// waits on about five memory round trips (3.7 us a launch).
//
// What the design does about it (one kernel template in two layouts, and
// the previous design's kernel between them, chosen at launch by M):
//   - it fills the card: a lane sums 8 bytes of each row (two f32 columns or
//     four bf16) at columns 32 apart, and up to kNarrowMaxCols columns the
//     8 warps of a block split the K rows into slices (5 rows each at
//     K = 40, 13 at K = 100): [40, 7850] f32 is 123 blocks of 64 columns,
//     one on each of 123 SMs. Above kColumnMaxCols, the wide layout gives
//     each warp all the rows (4 warps a block, so the few blocks of bf16's
//     128-column warps spread evenly over the SMs). In between, where x
//     stays in the 50 MB L2 from call to call, the previous design (one
//     column a thread, w in shared memory) is the faster of the three, and
//     runs there (the switch points come from a compare.py --columns sweep
//     at K = 40);
//   - it keeps loads in flight: a thread issues the loads of x and w for up
//     to 8 rows into registers before any arithmetic, and loops over such
//     chunks when its rows are more; the epilogue's loads (z, sigma, inv_k)
//     are issued at the start, not after the reduction;
//   - bf16 is loaded as its 16 bits and widened to f32 only where it is
//     summed: converted next to its load, each row's conversion waited on
//     that row's loads before the next row's issued (4 loads in flight a
//     thread instead of 32; 787 against 508 us at [40, 2^24 + 3]). It is
//     read one element a load, never as a pair: a row of odd M starts 2
//     bytes off a 4-byte boundary;
//   - it reduces once, in a fixed order: the slices' partial sums go to
//     shared memory and the first warp adds them in slice order and stores
//     y, so there is one launch, no atomic and the same bits from launch to
//     launch;
//   - a warp's loads of a row are whole 128-byte lines (f32) or 64-byte
//     halves (bf16) whatever M's parity or x's alignment; in the narrow and
//     wide layouts w is read through the read-only cache (the lanes of a
//     warp all read the same row's), so no shared buffer or barrier comes
//     before the loads of x; sigma and inv_k come from device pointers, so a
//     round needs no host sync and a new sigma no rebuild.
//
// The sum is f32 with fmaf in row order within a slice, then the slices in
// order; the epilogue is fmaf(sigma, z, acc) * inv_k. With w = e_i, sigma =
// 0 and inv_k = 1, y is row i as f32 bit for bit.
//
// Measured (kernels/aircomp/compare.py, device time a call, 7 samples in
// turns with the previous design; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
// §6): f32 [40, 7850] 2.58 us (3.86), of which 1.82 is the kernel's own in
// the main path's trace (3.65-3.79); [100, 7850] 3.19 (6.94); [40, 2^24 + 3]
// 929 us (939) against a bound of 841; bf16 2.57 (3.99), 3.22 (7.07) and
// 508 us (551) against 441.
//
// Built by kernel.py with nvcc into a shared library with a plain C interface.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSplitWarps = 8;  // warps a block of the narrow layout
constexpr int kWideWarps = 4;   // warps a block of the wide layout
constexpr int kChunk = 8;       // rows whose loads are issued together
constexpr int kColumnThreads = 256;  // threads a block of the column layout
// x's rows: the column layout holds w in the default 48 KB of shared memory
constexpr int64_t kMaxRows = 48 * 1024 / 4;
// The narrow layout runs up to this many columns, the column layout above.
constexpr int64_t kNarrowMaxCols = 8 * 132 * 32;
// The column layout runs up to this many columns, the wide layout above: at
// K = 40 the wide one measured slower than the column one up to 101,376 f32
// columns (+4 %) and 405,505 bf16 (+3 to +16 %), faster from 202,752 and
// 540,672 (2-5 %).
template <typename T>
constexpr int64_t kColumnMaxCols = (sizeof(T) == 4 ? 4 : 16) * kNarrowMaxCols;
// The narrow layout's blocks are short-lived: asking for 4 of them an SM
// (at most 64 registers a thread) measured 4-7 % faster up to
// kNarrowMaxCols; the wide layout measured slower so.
constexpr int kNarrowMinBlocks = 4;

// columns a lane: 8 bytes of each row (two f32, four bf16), so that a warp's
// loads of a row cover 256 bytes and a thread keeps 64 bytes of a chunk in
// flight whatever the type of x
template <typename T>
constexpr int kLaneCols = 8 / sizeof(T);

// x's elements as loaded: f32 as they are, bf16 as their 16 bits in a
// 32-bit register, widened to f32 (exactly) only where they are summed, so
// that no conversion waits on a load before the chunk's other loads issue
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  using Bits = float;
  __device__ __forceinline__ static Bits load(const float* p) { return *p; }
  __device__ __forceinline__ static float value(Bits v) { return v; }
};
template <>
struct Elem<__nv_bfloat16> {
  using Bits = uint32_t;
  __device__ __forceinline__ static Bits load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const unsigned short*>(p);
  }
  __device__ __forceinline__ static float value(Bits v) { return __uint_as_float(v << 16); }
};

// A lane's columns are c0 + 32·i for i < kCols; the block's kWarps /
// kSlices warp groups sit side by side over the columns, and the kSlices
// warps of a group split the rows (8 slices in the narrow layout, 1 in the
// wide one).
template <typename T, int kCols, int kSlices, int kWarps>
__global__ void __launch_bounds__(32 * kWarps, kSlices == 8 ? kNarrowMinBlocks : 1)
aircomp_kernel(const T* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ z, const float* __restrict__ sigma,
               const float* __restrict__ inv_k, float* __restrict__ y,
               int64_t rows, int64_t m) {
  constexpr int kGroupCols = 32 * kCols;
  constexpr int kTileCols = kWarps / kSlices * kGroupCols;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slice = warp % kSlices;
  const int group = warp / kSlices;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kTileCols +
                     group * kGroupCols + lane;
  // the epilogue's loads, issued with the rows'; the first slice stores y
  const bool stores = slice == 0;
  const float sv = stores ? *sigma : 0.0f;
  const float kv = stores ? *inv_k : 0.0f;
  bool in[kCols];
  float zv[kCols], acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    in[i] = c0 + 32 * i < m;
    zv[i] = stores && in[i] ? z[c0 + 32 * i] : 0.0f;
    acc[i] = 0.0f;
  }
  const int64_t per = (rows + kSlices - 1) / kSlices;
  const int64_t r_begin = slice * per;
  const int64_t r_end = r_begin + per < rows ? r_begin + per : rows;
  for (int64_t r = r_begin; in[0] && r < r_end; r += kChunk) {
    typename Elem<T>::Bits xv[kChunk][kCols];
    float wv[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      wv[j] = 0.0f;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        xv[j][i] = 0;
      }
      if (r + j < r_end) {
        const T* row = x + (r + j) * m + c0;
        wv[j] = __ldg(w + r + j);
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          if (in[i]) {
            xv[j][i] = Elem<T>::load(row + 32 * i);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (r + j < r_end) {
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          acc[i] = fmaf(wv[j], Elem<T>::value(xv[j][i]), acc[i]);
        }
      }
    }
  }
  if constexpr (kSlices > 1) {
    // one fixed-order sum of the slices' partial sums
    __shared__ float part[kSlices][kTileCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      part[slice][group * kGroupCols + 32 * i + lane] = acc[i];
    }
    __syncthreads();
    if (!stores) {
      return;
    }
    for (int s = 1; s < kSlices; ++s) {
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        acc[i] += part[s][group * kGroupCols + 32 * i + lane];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    if (in[i]) {
      y[c0 + 32 * i] = fmaf(sv, zv[i], acc[i]) * kv;
    }
  }
}

template <typename T, int kCols, int kSlices, int kWarps>
int run(const void* x, const void* w, const void* z, const void* sigma,
        const void* inv_k, void* y, int64_t rows, int64_t m, cudaStream_t s) {
  constexpr int64_t tile = kWarps / kSlices * 32 * kCols;
  const int64_t blocks = (m + tile - 1) / tile;
  if (blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  aircomp_kernel<T, kCols, kSlices, kWarps>
      <<<dim3(static_cast<unsigned int>(blocks)), 32 * kWarps, 0, s>>>(
    static_cast<const T*>(x), static_cast<const float*>(w),
    static_cast<const float*>(z), static_cast<const float*>(sigma),
    static_cast<const float*>(inv_k), static_cast<float*>(y), rows, m);
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// The column layout: one column a thread, the rows walked in order (8 rows'
// loads in flight), w read from shared memory filled once a block. With w
// through the read-only cache instead, bf16 [40, 202,752] took 6.52 us
// against 5.38.
template <typename T>
__global__ void __launch_bounds__(kColumnThreads)
aircomp_column_kernel(const T* __restrict__ x, const float* __restrict__ w,
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
  y[col] = fmaf(*sigma, z[col], acc) * *inv_k;
}

template <typename T>
int run_column(const void* x, const void* w, const void* z, const void* sigma,
               const void* inv_k, void* y, int64_t rows, int64_t m,
               cudaStream_t s) {
  const int64_t blocks = (m + kColumnThreads - 1) / kColumnThreads;
  aircomp_column_kernel<T><<<dim3(static_cast<unsigned int>(blocks)), kColumnThreads,
                             static_cast<size_t>(rows) * sizeof(float), s>>>(
    static_cast<const T*>(x), static_cast<const float*>(w),
    static_cast<const float*>(z), static_cast<const float*>(sigma),
    static_cast<const float*>(inv_k), static_cast<float*>(y), rows, m);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_layout(const void* x, const void* w, const void* z, const void* sigma,
               const void* inv_k, void* y, int64_t rows, int64_t m,
               cudaStream_t s) {
  constexpr int kCols = kLaneCols<T>;
  if (m <= kNarrowMaxCols) {
    return run<T, kCols, 8, kSplitWarps>(x, w, z, sigma, inv_k, y, rows, m, s);
  }
  if (m <= kColumnMaxCols<T>) {
    return run_column<T>(x, w, z, sigma, inv_k, y, rows, m, s);
  }
  return run<T, kCols, 1, kWideWarps>(x, w, z, sigma, inv_k, y, rows, m, s);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success). Does not
// synchronise. Takes 1 to kMaxRows rows (MAX_ROWS in kernel.py).
int aircomp_launch(const void* x, int x_is_bf16, const void* w, const void* z,
                   const void* sigma, const void* inv_k, void* y, int64_t rows,
                   int64_t m, void* stream) {
  if (rows <= 0 || rows > kMaxRows || m <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    return run_layout<__nv_bfloat16>(x, w, z, sigma, inv_k, y, rows, m, s);
  }
  return run_layout<float>(x, w, z, sigma, inv_k, y, rows, m, s);
}

const char* aircomp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

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
// 0.394 us at 3.35 TB/s. At that size the time goes to latency: one thread a
// column fills 31 of the 132 SMs, and a thread that walks the 40 rows with a
// few loads in flight took 5.1 us.
//
// What the design does about it (kernel template below, two layouts):
//   - it fills the card: while M is small (the narrow layout, up to 33,792
//     columns) a block is a tile of 64 columns, two a lane, and its 8 warps
//     split the C rows into slices (5 rows each at C = 40, 13 at C = 100).
//     [40, 7850] is 123 blocks of 8 warps, one on each of 123 SMs; one
//     column a lane (246 blocks) measured 3-22 % slower up to 33,792
//     columns: the compare is cheap, so the per-row loads of w and thr and
//     the address arithmetic, shared by a lane's two columns, weigh more;
//   - it keeps loads in flight: a thread issues the loads of x, w and thr
//     for up to 8 rows into registers before any arithmetic, and loops over
//     such chunks when its rows are more;
//   - it reduces once, in a fixed order: the slices' partial sums go to
//     shared memory and the first warp adds them in slice order and stores
//     y, so there is one launch, no atomic and the same bits from launch to
//     launch;
//   - when M is large the short-lived blocks of the narrow layout hold too
//     few bytes in flight for the registers they take, so the wide layout
//     gives each warp all the rows of its 64 columns (512 columns a block,
//     no shared memory): each thread streams its rows in chunks of 8, 64
//     bytes in flight;
//   - a lane's columns are 32 apart, so every load is a coalesced 128-byte
//     line of a warp whatever M's parity or x's alignment; w and thr are
//     read through the read-only cache (the lanes of a warp all read the
//     same row's), so no shared memory bounds C; sigma and inv_k come from
//     device pointers, so a round needs no host sync and a new sigma no
//     rebuild.
//
// Measured (kernels/aircomp/compare.py, device time a call, in turns with
// the previous design, one thread a column; NVIDIA H100 80GB HBM3,
// 700.00 W): [40, 7850] 3.07 us (5.13), of which 2.13 is the kernel's own
// in the main path's trace; [100, 7850] 3.63 (9.52); [40, 2^24 + 3] 928 us
// against a bound of 841 (951). A call at [40, 32], next to no bytes,
// takes 2.80 us: at the main shape the kernel is within 0.3 us of its
// fixed cost (launch, one round trip to memory, the block barrier).
//
// The compare is fabsf(x) >= thr in f32, the very mask the error-feedback
// residual recomputes in PyTorch; the kernel returns only the aggregate, as
// the TPU kernel does.
//
// Built by kernel.py with nvcc into a shared library with a plain C interface.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // 8 warps a block
constexpr int kChunk = 8;               // rows whose loads are issued together
// Narrow layout (small M): two columns a lane, the 8 warps split the rows.
constexpr int kNarrowCols = 2;
constexpr int kNarrowSlices = 8;
// Wide layout (large M): two columns a lane, each warp sums all the rows.
constexpr int kWideCols = 2;
constexpr int kWideSlices = 1;
// The narrow layout runs up to this many columns (8 blocks an SM at one
// column a lane); above it the wide one holds more bytes in flight.
constexpr int64_t kNarrowMaxCols = 8 * 132 * 32;

__device__ __forceinline__ float compress(float x, float thr) {
  return fabsf(x) >= thr ? x : 0.0f;
}

// A lane's columns are c0 + 32·i for i < kCols, each load a coalesced
// 128-byte line of a warp; the block's kThreads / 32 / kSlices warp groups
// sit side by side over the columns, and the kSlices warps of a group split
// the rows.
template <int kCols, int kSlices>
__global__ void __launch_bounds__(kThreads)
sparse_aircomp_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ thr,
    const float* __restrict__ z, const float* __restrict__ sigma,
    const float* __restrict__ inv_k, float* __restrict__ y, int64_t rows,
    int64_t m) {
  constexpr int kGroupCols = 32 * kCols;
  constexpr int kTileCols = kThreads / kSlices * kCols;
  __shared__ float part[kSlices][kTileCols];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slice = warp % kSlices;
  const int group = warp / kSlices;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kTileCols +
                     group * kGroupCols + lane;
  bool in[kCols];
  float zv[kCols], acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    in[i] = c0 + 32 * i < m;
    // the epilogue's loads, issued with the rows'
    zv[i] = slice == 0 && in[i] ? z[c0 + 32 * i] : 0.0f;
    acc[i] = 0.0f;
  }
  const int64_t per = (rows + kSlices - 1) / kSlices;
  const int64_t r_begin = slice * per;
  const int64_t r_end = r_begin + per < rows ? r_begin + per : rows;
  for (int64_t r = r_begin; in[0] && r < r_end; r += kChunk) {
    float xv[kChunk][kCols], wv[kChunk], tv[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        xv[j][i] = 0.0f;
      }
      if (r + j < r_end) {
        const int64_t row = (r + j) * m + c0;
        wv[j] = __ldg(w + r + j);
        tv[j] = __ldg(thr + r + j);
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          if (in[i]) {
            xv[j][i] = x[row + i * 32];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (r + j < r_end) {
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          acc[i] = fmaf(wv[j], compress(xv[j][i], tv[j]), acc[i]);
        }
      }
    }
  }
  if (kSlices > 1) {
    // one fixed-order sum of the slices' partial sums
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      part[slice][group * kGroupCols + 32 * i + lane] = acc[i];
    }
    __syncthreads();
    if (slice != 0) {
      return;
    }
    for (int s = 1; s < kSlices; ++s) {
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        acc[i] += part[s][group * kGroupCols + 32 * i + lane];
      }
    }
  }
  const float sv = *sigma;
  const float kv = *inv_k;
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    if (in[i]) {
      y[c0 + 32 * i] = fmaf(sv, zv[i], acc[i]) * kv;
    }
  }
}

template <int kCols, int kSlices>
int64_t grid(int64_t m) {
  constexpr int64_t tile = kThreads / kSlices * kCols;
  return (m + tile - 1) / tile;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success). Does not
// synchronise.
int sparse_aircomp_launch(const void* x, const void* w, const void* thr,
                          const void* z, const void* sigma, const void* inv_k,
                          void* y, int64_t rows, int64_t m, void* stream) {
  if (rows <= 0 || m <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= kNarrowMaxCols) {
    const int64_t narrow = grid<kNarrowCols, kNarrowSlices>(m);
    sparse_aircomp_kernel<kNarrowCols, kNarrowSlices>
        <<<dim3(static_cast<unsigned int>(narrow)), kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(thr), static_cast<const float*>(z),
      static_cast<const float*>(sigma), static_cast<const float*>(inv_k),
      static_cast<float*>(y), rows, m);
  } else {
    const int64_t wide = grid<kWideCols, kWideSlices>(m);
    if (wide > 2147483647LL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    sparse_aircomp_kernel<kWideCols, kWideSlices>
        <<<dim3(static_cast<unsigned int>(wide)), kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(thr), static_cast<const float*>(z),
      static_cast<const float*>(sigma), static_cast<const float*>(inv_k),
      static_cast<float*>(y), rows, m);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* sparse_aircomp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

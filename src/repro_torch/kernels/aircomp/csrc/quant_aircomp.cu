// Fused quantize-aggregate AirComp pass, the quantized transport's eq. (10),
// for Hopper (sm_90a).
//
//   q[c, m] = d[c] > 0 ? floor(x[c, m] / d[c] + u[c, m]) * d[c] : x[c, m]
//   y[m]    = (sum_c w[c] * q[c, m] + sigma * z[m]) * inv_k
//
// Replaces the TPU kernel
// src/repro/kernels/aircomp/kernel.py::quant_aircomp_pallas. Per element it
// does one division, one add, one floor, one multiply and one FMA against 8
// bytes read (x and u), so the card's memory rate bounds it: at the main
// path's [40, 7850] f32 it must move 2·C·M·4 + 2·M·4 + 2·C·4 = 2,575,120
// bytes, 0.769 us at 3.35 TB/s. At that size the time goes to latency: one
// thread a column fills 31 of the 132 SMs, and a thread that walks the 40
// rows with a few loads in flight, one division after another, took 13.9 us.
//
// What the design does about it (kernel template below, two layouts):
//   - it fills the card: while M is small (the narrow layout, up to 33,792
//     columns) a block is a tile of 32 columns, one a lane, and its 8 warps
//     split the C rows into slices (5 rows each at C = 40, 13 at C = 100).
//     [40, 7850] is 246 blocks of 8 warps, 2 on most SMs: twice the warps of
//     two columns a lane, which measured 19-42 % slower at C = 40-100,
//     M = 7850, as each thread's chain of divisions is twice as long;
//   - it keeps loads in flight: a thread issues the loads of x, u, w and d
//     for up to 8 rows into registers before any arithmetic, and loops over
//     such chunks when its rows are more; the divisions then run on
//     independent elements, not on a serial chain;
//   - it reduces once, in a fixed order: the slices' partial sums go to
//     shared memory and the first warp adds them in slice order and stores
//     y, so there is one launch, no atomic and the same bits from launch to
//     launch;
//   - when M is large the short-lived blocks of the narrow layout hold too
//     few bytes in flight for the registers they take, so the wide layout
//     gives each lane 2 columns and each warp all the rows (512 columns a
//     block, no shared memory): each thread streams its rows in chunks of
//     8, 128 bytes in flight;
//   - a lane's columns are 32 apart, so every load is a coalesced 128-byte
//     line of a warp whatever M's parity or x's alignment; w and d are read
//     through the read-only cache (the lanes of a warp all read the same
//     row's), so no shared memory bounds C; sigma and inv_k come from device
//     pointers, so a round needs no host sync and a new sigma no rebuild.
//
// Measured (kernels/aircomp/compare.py, device time a call, in turns with
// the previous design, one thread a column; NVIDIA H100 80GB HBM3,
// 700.00 W): [40, 7850] 3.74 us (13.87), of which 2.88 is the kernel's own
// in the main path's trace; [100, 7850] 5.10 (30.86); [40, 2^24 + 3]
// 1,806 us against a bound of 1,643 (2,246). A call at [40, 32], next to no
// bytes, takes 3.25 us: at the main shape the kernel is within 0.5 us of
// its fixed cost (launch, one round trip to memory, the block barrier).
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

constexpr int kThreads = 256;           // 8 warps a block
constexpr int kChunk = 8;               // rows whose loads are issued together
// Narrow layout (small M): one column a lane, the 8 warps split the rows.
constexpr int kNarrowCols = 1;
constexpr int kNarrowSlices = 8;
// Wide layout (large M): two columns a lane, each warp sums all the rows.
constexpr int kWideCols = 2;
constexpr int kWideSlices = 1;
// The narrow layout runs up to this many columns (8 blocks an SM at one
// column a lane); above it the wide one holds more bytes in flight.
constexpr int64_t kNarrowMaxCols = 8 * 132 * 32;

__device__ __forceinline__ float sround(float x, float u, float d) {
  return d > 0.0f ? __fmul_rn(floorf(__fadd_rn(__fdiv_rn(x, d), u)), d) : x;
}

// A lane's columns are c0 + 32·i for i < kCols, each load a coalesced
// 128-byte line of a warp; the block's kThreads / 32 / kSlices warp groups
// sit side by side over the columns, and the kSlices warps of a group split
// the rows.
template <int kCols, int kSlices>
__global__ void __launch_bounds__(kThreads)
quant_aircomp_kernel(
    const float* __restrict__ x, const float* __restrict__ u,
    const float* __restrict__ w, const float* __restrict__ d,
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
    float xv[kChunk][kCols], uv[kChunk][kCols], wv[kChunk], dv[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        xv[j][i] = uv[j][i] = 0.0f;
      }
      if (r + j < r_end) {
        const int64_t row = (r + j) * m + c0;
        wv[j] = __ldg(w + r + j);
        dv[j] = __ldg(d + r + j);
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          if (in[i]) {
            xv[j][i] = x[row + i * 32];
            uv[j][i] = u[row + i * 32];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (r + j < r_end) {
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          acc[i] = fmaf(wv[j], sround(xv[j][i], uv[j][i], dv[j]), acc[i]);
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
int quant_aircomp_launch(const void* x, const void* u, const void* w,
                         const void* d, const void* z, const void* sigma,
                         const void* inv_k, void* y, int64_t rows, int64_t m,
                         void* stream) {
  if (rows <= 0 || m <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= kNarrowMaxCols) {
    const int64_t narrow = grid<kNarrowCols, kNarrowSlices>(m);
    quant_aircomp_kernel<kNarrowCols, kNarrowSlices>
        <<<dim3(static_cast<unsigned int>(narrow)), kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(u),
      static_cast<const float*>(w), static_cast<const float*>(d),
      static_cast<const float*>(z), static_cast<const float*>(sigma),
      static_cast<const float*>(inv_k), static_cast<float*>(y), rows, m);
  } else {
    const int64_t wide = grid<kWideCols, kWideSlices>(m);
    if (wide > 2147483647LL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    quant_aircomp_kernel<kWideCols, kWideSlices>
        <<<dim3(static_cast<unsigned int>(wide)), kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(u),
      static_cast<const float*>(w), static_cast<const float*>(d),
      static_cast<const float*>(z), static_cast<const float*>(sigma),
      static_cast<const float*>(inv_k), static_cast<float*>(y), rows, m);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* quant_aircomp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// sLSTM time scan for Hopper (sm_90a): one cooperative launch runs the whole
// scan of S steps.
//
// For t = 0 .. S-1, every batch row b, head h and channel e:
//   pre[g] = (gx[t, b, g, h, e] + sum_k hr[b, h, k] * r[h, k, g, e]) + bias[g, h, e]
//            for the gates g = i, f, z, o, where hr is h_{t-1} rounded to r's
//            type and the sum is taken in f32;
//   m' = max(f + m, i);  i' = exp(i - m');  f' = exp(f + m - m');
//   c' = f' c + i' tanh(z);  n' = f' n + i';  h' = sigmoid(o) c' / max(n', 1e-6);
//   hs[t] = h' (in gx's type).
// The final (h, c, n, m) are returned in f32. This is the cell of the model
// (src/repro/models/xlstm.py::_slstm_cell), and it replaces the TPU kernel
// src/repro/kernels/slstm/kernel.py::slstm_pallas, which keeps R and the
// state on chip for blocks of 64 steps; here nothing leaves the chip for the
// whole scan except h, exchanged once a step.
//
// Bound: at the long prefill (S = 2048, B = 8, H = 4, d = 512, f32) the
// recurrent products are 2·S·B·4·H·d² = 137.4 GFLOP of f32 FMAs against
// 0.69 GB of gx, hs and R, so the least time is 2.05 ms at the H100's
// 67 TFLOP/s of f32 outside the tensor cores (the bytes alone need 0.21 ms),
// and the S dependent steps add one grid barrier each. A decode call (S = 1)
// only reads R: 16.8 MB, 5.0 us at 3.35 TB/s.
//
// Design. R is block-diagonal over heads, so a block owns one head and cw of
// its d channels, for all four gates and all B rows; its slice of R,
// [d][4·cw] in R's type, is loaded into shared memory once and kept there
// for the whole scan (d = 512, cw = 16 in f32: 128 KiB, and 4·32 = 128 blocks
// on the 132 SMs; cw is the fewest channels for which one block an SM covers
// every head). Its c, n and m live in the output arrays cT, nT, mT, which
// only the thread that owns an element reads and writes, step after step.
// Each step, for each pass of up to 8 batch rows:
//   1. the head's h_{t-1} rows are staged in shared memory, rounded to R's
//      type, laid out [d][8] so one pair of float4 reads gives all 8 rows;
//   2. thread (ks, j) sums h·r over k = ks, ks + KS, ... for gate-channel j
//      and the 8 rows in registers (fmaf, a fixed order), and the KS partial
//      sums are added in order ks = 0 .. KS-1 through shared memory;
//   3. the owner of (b, e) adds gx and the bias and runs the cell in f32
//      with expf/tanhf, the IEEE division and explicitly rounded adds and
//      multiplies (__fadd_rn, __fmul_rn: no contraction into FMAs), in the
//      model's order of operations;
//   4. h' goes to hs[t] and to one half of a double-buffered global
//      [2, B, H·d] f32 exchange buffer (h_t in half t mod 2; step t reads the
//      other half, so no block can overwrite h while another still reads it);
// and a grid-wide barrier (cooperative_groups grid sync, which fences
// memory) ends the step. h is read with __ldcg and written with __stcg, at
// L2, so no block reads a stale L1 line of it. With m = -1e30 (the initial
// state) f + m - m' is -1e30 - i and f' = exp(-1e30 - i) is exactly 0.
//
// The launch needs every block resident at once: it raises (returns
// cudaErrorCooperativeLaunchTooLarge) when the occupancy calculator says
// the grid cannot be, and when no cw <= 64 gives at most one block an SM.
// Tensor cores for the B·H·d × 4d product, a per-head barrier and TMA are
// later work.
//
// gx and r are f32 or bf16; the bias and the states f32.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with a
// plain C interface (no -rdc: grid sync needs no separate compilation in
// CUDA 12).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;
constexpr int kRows = 8;      // batch rows a pass
constexpr int kMaxCw = 64;    // 4·cw gate-channels <= kMaxThreads

struct Args {
  const void* gx;      // [S, B, 4, H, d], f32 or bf16
  const void* r;       // [H, d, 4, d], f32 or bf16
  const float* bias;   // [4, H, d]
  const float* h0;     // [B, H, d] each
  const float* c0;
  const float* n0;
  const float* m0;
  void* hs;            // [S, B, H, d] in gx's type
  float* hT;           // [B, H, d] each; c, n and m also carry the state
  float* cT;
  float* nT;
  float* mT;
  float* hbuf;         // [2, B, H, d] f32: h exchanged between blocks
  int S, B, H, d;
  int cw;              // channels of one head a block owns
  int ks;              // ways the length-d sum is split across threads
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
// h as the recurrent product reads it: rounded to R's type
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// dynamic shared memory: R's slice [d][4·cw] in R's type, the h rows
// [d][kRows] f32, the partial sums [ks][kRows][4·cw] f32
template <typename R>
size_t smem_bytes(int d, int cw, int ks) {
  return align16(size_t(d) * 4 * cw * sizeof(R)) + size_t(d) * kRows * sizeof(float) +
         size_t(ks) * kRows * 4 * cw * sizeof(float);
}

template <typename G, typename R>
__global__ void __launch_bounds__(kMaxThreads) slstm_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int d = a.d, cw = a.cw, ks_n = a.ks, B = a.B;
  const int g4 = 4 * cw;
  const int nt = g4 * ks_n;   // == blockDim.x
  const size_t hd = size_t(a.H) * d;
  const int head = blockIdx.x / (d / cw);
  const int e0 = (blockIdx.x % (d / cw)) * cw;
  const size_t col = size_t(head) * d + e0;   // the block's first column of [B, H·d]
  R* r_s = reinterpret_cast<R*>(smem);
  float* h_s = reinterpret_cast<float*>(smem + align16(size_t(d) * g4 * sizeof(R)));
  float* part_s = h_s + size_t(d) * kRows;

  const int tid = threadIdx.x;
  const int j = tid % g4;     // gate j / cw, channel e0 + j % cw
  const int ks = tid / g4;    // sums over k = ks, ks + ks_n, ...

  // R's slice, once for the whole scan: r_s[k][g][c] = r[head, k, g, e0 + c]
  const R* r = static_cast<const R*>(a.r);
  for (int idx = tid; idx < d * g4; idx += nt) {
    const int k = idx / g4, g = (idx % g4) / cw, c = idx % cw;
    r_s[idx] = r[((size_t(head) * d + k) * 4 + g) * d + e0 + c];
  }
  const G* gx = static_cast<const G*>(a.gx);
  G* hs = static_cast<G*>(a.hs);

  for (int t = 0; t < a.S; ++t) {
    const float* h_prev = t == 0 ? a.h0 : a.hbuf + size_t((t - 1) & 1) * B * hd;
    float* h_next = a.hbuf + size_t(t & 1) * B * hd;
    const float* c_prev = t == 0 ? a.c0 : a.cT;
    const float* n_prev = t == 0 ? a.n0 : a.nT;
    const float* m_prev = t == 0 ? a.m0 : a.mT;
    for (int b0 = 0; b0 < B; b0 += kRows) {
      const int rows = min(kRows, B - b0);
      __syncthreads();   // r_s is written; the last pass is done with h_s, part_s
      for (int idx = tid; idx < kRows * d; idx += nt) {
        const int bb = idx / d, k = idx % d;
        h_s[k * kRows + bb] =
            bb < rows ? round_as(__ldcg(h_prev + size_t(b0 + bb) * hd + size_t(head) * d + k), r)
                      : 0.0f;
      }
      __syncthreads();
      float acc[kRows];
#pragma unroll
      for (int bb = 0; bb < kRows; ++bb) {
        acc[bb] = 0.0f;
      }
#pragma unroll 4
      for (int k = ks; k < d; k += ks_n) {
        const float rv = to_float(r_s[k * g4 + j]);
        const float4 lo = *reinterpret_cast<const float4*>(h_s + k * kRows);
        const float4 hi = *reinterpret_cast<const float4*>(h_s + k * kRows + 4);
        acc[0] = fmaf(lo.x, rv, acc[0]);
        acc[1] = fmaf(lo.y, rv, acc[1]);
        acc[2] = fmaf(lo.z, rv, acc[2]);
        acc[3] = fmaf(lo.w, rv, acc[3]);
        acc[4] = fmaf(hi.x, rv, acc[4]);
        acc[5] = fmaf(hi.y, rv, acc[5]);
        acc[6] = fmaf(hi.z, rv, acc[6]);
        acc[7] = fmaf(hi.w, rv, acc[7]);
      }
#pragma unroll
      for (int bb = 0; bb < kRows; ++bb) {
        part_s[(ks * kRows + bb) * g4 + j] = acc[bb];
      }
      __syncthreads();
      for (int o = tid; o < rows * cw; o += nt) {
        const int bb = o / cw, c = o % cw;
        const size_t si = size_t(b0 + bb) * hd + col + c;   // [B, H·d]
        float pre[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float s = 0.0f;
          for (int q = 0; q < ks_n; ++q) {
            s = __fadd_rn(s, part_s[(q * kRows + bb) * g4 + g * cw + c]);
          }
          const float x = to_float(gx[((size_t(t) * B + b0 + bb) * 4 + g) * hd + col + c]);
          pre[g] = __fadd_rn(__fadd_rn(x, s), a.bias[g * hd + col + c]);
        }
        const float m = m_prev[si];
        const float fm = __fadd_rn(pre[1], m);
        const float m_new = fmaxf(fm, pre[0]);
        const float i = expf(__fadd_rn(pre[0], -m_new));
        const float f = expf(__fadd_rn(fm, -m_new));
        const float c_new = __fadd_rn(__fmul_rn(f, c_prev[si]), __fmul_rn(i, tanhf(pre[2])));
        const float n_new = __fadd_rn(__fmul_rn(f, n_prev[si]), i);
        const float o_gate = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-pre[3])));
        const float h_new = __fdiv_rn(__fmul_rn(o_gate, c_new), fmaxf(n_new, 1e-6f));
        a.cT[si] = c_new;
        a.nT[si] = n_new;
        a.mT[si] = m_new;
        __stcg(h_next + si, h_new);
        store(hs + size_t(t) * B * hd + si, h_new);
        if (t == a.S - 1) {
          a.hT[si] = h_new;
        }
      }
    }
    if (t + 1 < a.S) {
      grid.sync();
    }
  }
}

// clears the pending error state so a refused launch is not reported again
// by the next kernel's cudaGetLastError()
cudaError_t fail(cudaError_t err) {
  cudaGetLastError();
  return err;
}

template <typename G, typename R>
cudaError_t launch(Args a, cudaStream_t stream) {
  int dev = 0, sms = 0, max_smem = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return fail(err);
  if (!coop) return cudaErrorNotSupported;
  // cw: the fewest channels a block (a power of two dividing d) for which
  // one block an SM covers every head
  int cw = 0;
  for (int c = 1; c <= kMaxCw && a.d % c == 0; c *= 2) {
    if (int64_t(a.H) * (a.d / c) <= sms) {
      cw = c;
      break;
    }
  }
  if (cw == 0) return cudaErrorCooperativeLaunchTooLarge;
  int ks = 1;   // the most ways (a power of two dividing d) within kMaxThreads
  while (8 * cw * ks <= kMaxThreads && a.d % (2 * ks) == 0) ks *= 2;
  a.cw = cw;
  a.ks = ks;
  const size_t smem = smem_bytes<R>(a.d, cw, ks);
  if (smem > size_t(max_smem)) return cudaErrorInvalidValue;
  const int threads = 4 * cw * ks;
  const int grid = a.H * (a.d / cw);
  auto kernel = slstm_kernel<G, R>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return fail(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return fail(err);
  if (int64_t(per_sm) * sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(threads), params, smem, stream);
  if (err != cudaSuccess) return fail(err);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns 0 on success or the CUDA error code (the
// launch is refused when the grid cannot be resident at once). Does not
// synchronise. All arrays are row-major and contiguous; hbuf is [2, B, H, d]
// f32 scratch.
int slstm_launch(const void* gx, int gx_is_bf16, const void* r, int r_is_bf16,
                 const void* bias, const void* h0, const void* c0, const void* n0,
                 const void* m0, void* hs, void* hT, void* cT, void* nT, void* mT,
                 void* hbuf, int64_t S, int64_t B, int64_t H, int64_t d, void* stream) {
  if (S < 1 || B < 1 || H < 1 || d < 1 || S > 2147483647LL || B > 2147483647LL ||
      H * d > 2147483647LL || B * H * d > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{gx, r, static_cast<const float*>(bias), static_cast<const float*>(h0),
         static_cast<const float*>(c0), static_cast<const float*>(n0),
         static_cast<const float*>(m0), hs, static_cast<float*>(hT),
         static_cast<float*>(cT), static_cast<float*>(nT), static_cast<float*>(mT),
         static_cast<float*>(hbuf), static_cast<int>(S), static_cast<int>(B),
         static_cast<int>(H), static_cast<int>(d), 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!gx_is_bf16 && !r_is_bf16) {
    err = launch<float, float>(a, s);
  } else if (!gx_is_bf16) {
    err = launch<float, __nv_bfloat16>(a, s);
  } else if (!r_is_bf16) {
    err = launch<__nv_bfloat16, float>(a, s);
  } else {
    err = launch<__nv_bfloat16, __nv_bfloat16>(a, s);
  }
  return static_cast<int>(err);
}

const char* slstm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

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
// 67 TFLOP/s of f32 outside the tensor cores (1.0 us a step; the bytes alone
// need 0.21 ms). A decode call (S = 1) only reads R: 16.8 MB, 5.1 us at
// 3.35 TB/s, 128 KiB a block.
//
// Design. R is block-diagonal over heads, so a block owns one head and cw of
// its d channels, for all four gates and all B rows (d = 512, cw = 16: 128
// blocks on the 132 SMs; cw is the fewest channels for which one block an
// SM covers every head). Its slice of R, [d][4·cw] in R's type, is copied
// into shared memory once, with 16-byte cp.async copies all in flight
// before one wait, and kept there for the whole scan; its c, n and m stay in
// shared memory, read from c0/n0/m0 once and written to cT/nT/mT once. Each
// step, for each pass of up to 8 batch rows:
//   1. the head's h_{t-1} rows come from L2 (__ldcg, 16-byte loads, all in
//      flight at once) into shared memory, rounded to R's type, [8][d];
//   2. thread (ks, cg) sums h·r for 4 gate-channels 4cg..4cg+3 and all 8
//      rows in 32 register accumulators over the k-groups i = ks, ks + KS,
//      ... (k = 4i .. 4i + 3 in order, fmaf; 4 groups unrolled): each
//      group's 4 float4 of R and 8 float4 of h feed 128 FMAs (the design
//      before it: 3 loads for 8 FMAs); the KS partial sums go through shared
//      memory and the owner adds them in order ks = 0 .. KS-1, 4 ways at a
//      time with their loads in flight together (a fixed order: a scan split
//      in two calls equals one call bit for bit);
//   3. the owner of (b, e) adds gx (loaded into registers before the step's
//      barrier, or before the pass's products, so its latency is hidden) and
//      the bias (registers, loaded once), and runs the cell in f32 with
//      expf/tanhf, the IEEE division and explicitly rounded adds and
//      multiplies (__fadd_rn, __fmul_rn: no contraction into FMAs), in the
//      model's order of operations;
//   4. h' goes to hs[t] and to one half of a double-buffered global
//      [2, B, H·d] f32 exchange buffer (h_t in half t mod 2), at L2 (__stcg).
// A per-head barrier ends the step: only the d / cw blocks of one head read
// each other's h, so each head has its own arrival counter in global memory.
// A block arrives with the release pattern (fence.acq_rel.gpu, then a
// relaxed add at GPU scope, after a __syncthreads, so the fence releases
// every thread's h), loads the next step's gx, and waits by spinning on an
// acquire load until the counter reaches (d / cw)·(t + 1). The counters are
// zeroed by cudaMemsetAsync on the launch's stream. The double buffer stays
// correct under a per-head barrier: a block writes half t & 1 during step t
// + 1 only after barrier t, which every block of its head passes only after
// it has finished step t, the last step that reads that half (h_{t-1}); no
// other head reads the block's columns. With m = -1e30 (the initial state)
// f + m - m' is -1e30 - i and f' = exp(-1e30 - i) is exactly 0.
//
// A spin barrier deadlocks unless every block is resident, so the launch
// stays cooperative and raises (cudaErrorCooperativeLaunchTooLarge) when the
// occupancy calculator says the grid cannot be, and when no cw <= 64 gives
// at most one block an SM. It takes d % 4 == 0; shared memory bounds the
// slice of R and the state (cudaErrorInvalidValue past it).
//
// Where a step of serve B's scan (S = 2048, B = 8, f32) goes, in us, measured
// by step_split.py, which builds the source with SLSTM_STAGES = 1 (the
// barrier alone), 2 (+ the h exchange), 3 (+ the products), 4 (+ the cell),
// on an NVIDIA H100 80GB HBM3, 700.00 W:
//                       barrier  h exchange  products  cell   step
//   grid-barrier design   1.13      4.25       3.36     2.42  11.17
//   this design           0.98      0.75       1.85     0.66   4.24
// (the design before it, with one grid barrier a step, staged h with
// dependent scalar L2 loads into a bank-conflicted layout, read R a scalar
// at a time and kept c, n, m in device memory). The
// products stay ~1.8x the 1.0 us of FMA issue a step: at 4 gate-channels a
// thread the shared-memory loads of R and h are about as many wavefronts as
// the SM has FMA cycles, and holding R in registers instead (128 a thread)
// measured no faster. The barrier's ~1 us is a release, an L2 atomic and
// an acquire poll in sequence.
//
// gx and r are f32 or bf16; the bias and the states f32.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with a
// plain C interface.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "slstm_sync.cuh"

// step-split variants (step_split.py): 1 the barrier alone, 2 + the h
// exchange, 3 + the products, 4 the whole step (the kernel)
#ifndef SLSTM_STAGES
#define SLSTM_STAGES 4
#endif

// The training variant (-DSLSTM_TRAIN, kernel.py's TRAIN_BUILD)
// also stores, each step, what the backward (slstm_bwd.cu) reads: c', n', i',
// f', tanh(z) and sigmoid(o) of every cell, as saved [6, S, B, H, d] f32
// (the f32 h before step t is h0, or hs[t - 1] when hs is f32). The serve
// build has neither the argument nor the stores.
#ifdef SLSTM_TRAIN
#define SAVED_C_PARAM , void* saved
#define SAVED_C_ARG , static_cast<float*>(saved)
#else
#define SAVED_C_PARAM
#define SAVED_C_ARG
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;                            // batch rows a pass
constexpr int kMaxCw = 64;                          // channels a block at most
constexpr int kOwn = kRows * kMaxCw / kThreads;     // cells a thread owns a pass

struct Args {
  const void* gx;      // [S, B, 4, H, d], f32 or bf16
  const void* r;       // [H, d, 4, d], f32 or bf16
  const float* bias;   // [4, H, d]
  const float* h0;     // [B, H, d] each
  const float* c0;
  const float* n0;
  const float* m0;
  void* hs;            // [S, B, H, d] in gx's type
  float* hT;           // [B, H, d] each
  float* cT;
  float* nT;
  float* mT;
  float* hbuf;         // [2, B, H, d] f32: h exchanged between blocks
  int* arrived;        // [H]: blocks of each head arrived, zeroed before the launch
  int S, B, H, d;
  int cw, log_cw;      // channels of one head a block owns (a power of two)
  int ks;              // ways the length-d sum is split (over groups of 4 k)
  int r_async;         // R's rows of cw values are whole 16-byte chunks
#ifdef SLSTM_TRAIN
  float* saved;        // [6, S, B, H, d]: c, n, i, f, tanh(z), sigmoid(o)
#endif
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
// four consecutive gate-channels of R's slice, in f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// dynamic shared memory: R's slice [d][4·cw] in R's type, the h rows
// [kRows][d] f32, the partial sums [ks][kRows][4·cw] f32, the state c, n, m
// [3][B][cw] f32
template <typename R>
size_t smem_bytes(int d, int cw, int ks, int B) {
  return align16(size_t(d) * 4 * cw * sizeof(R)) + size_t(kRows) * d * sizeof(float) +
         size_t(ks) * kRows * 4 * cw * sizeof(float) + size_t(3) * B * cw * sizeof(float);
}

// gx of the cells this thread owns in the pass of rows [b0, b0 + rows) of step t
template <typename G>
__device__ __forceinline__ void load_gx(float (&v)[kOwn][4], const G* gx, const Args& a,
                                        size_t col, int t, int b0, int rows) {
  const size_t hd = size_t(a.H) * a.d;
#pragma unroll
  for (int j = 0; j < kOwn; ++j) {
    const int o = threadIdx.x + j * kThreads;
    if (o < rows * a.cw) {
      const size_t base = (size_t(t) * a.B + b0 + (o >> a.log_cw)) * 4 * hd + col +
                          (o & (a.cw - 1));
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        v[j][g] = to_float(gx[base + g * hd]);
      }
    }
  }
}

template <typename G, typename R>
__global__ void __launch_bounds__(kThreads, 1) slstm_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = a.d, cw = a.cw, ks_n = a.ks, B = a.B;
  const int g4 = 4 * cw;
  const size_t hd = size_t(a.H) * d;
  const int per_head = d >> a.log_cw;   // blocks of one head
  const int head = blockIdx.x / per_head;
  const int e0 = (blockIdx.x - head * per_head) * cw;
  const size_t col = size_t(head) * d + e0;   // the block's first column of [B, H·d]
  R* r_s = reinterpret_cast<R*>(smem);
  float* h_s = reinterpret_cast<float*>(smem + align16(size_t(d) * g4 * sizeof(R)));
  float* part_s = h_s + size_t(kRows) * d;
  float* c_s = part_s + size_t(ks_n) * kRows * g4;
  float* n_s = c_s + B * cw;
  float* m_s = n_s + B * cw;

  const int tid = threadIdx.x;
  const int cg = tid & (cw - 1);        // gate-channels 4cg .. 4cg + 3 of the products
  const int ksi = tid >> a.log_cw;      // the products' k-split way (none past ks_n)
  const int own_c = tid & (cw - 1);     // the channel of every cell this thread owns
  const G* gx = static_cast<const G*>(a.gx);
  G* hs = static_cast<G*>(a.hs);
  const int rows0 = min(kRows, B);

  float gxv[kOwn][4];
#if SLSTM_STAGES >= 4
  load_gx(gxv, gx, a, col, 0, 0, rows0);
#endif
  // R's slice, once for the whole scan: r_s[k][g·cw + c] = r[head, k, g, e0 + c];
  // its row (k, g) is cw contiguous values of r
  const R* r_head = static_cast<const R*>(a.r) + size_t(head) * d * 4 * d + e0;
  if (a.r_async) {
    const int log_cpr = __ffs(int(cw * sizeof(R) / 16)) - 1;   // 16-byte chunks a row
    const int chunks = (d * 4) << log_cpr;
    for (int i = tid; i < chunks; i += kThreads) {
      const int row = i >> log_cpr, part = i & ((1 << log_cpr) - 1);
      cp_async16(reinterpret_cast<char*>(r_s + size_t(row) * cw) + 16 * part,
                 reinterpret_cast<const char*>(r_head + size_t(row) * d) + 16 * part);
    }
    cp_async_wait_all();
  } else {
    for (int i = tid; i < d * g4; i += kThreads) {
      r_s[i] = r_head[size_t(i >> a.log_cw) * d + (i & (cw - 1))];
    }
  }
  float bias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    bias[g] = a.bias[g * hd + col + own_c];
  }
  for (int i = tid; i < B * cw; i += kThreads) {
    const size_t si = size_t(i >> a.log_cw) * hd + col + (i & (cw - 1));
    c_s[i] = a.c0[si];
    n_s[i] = a.n0[si];
    m_s[i] = a.m0[si];
  }

  for (int t = 0; t < a.S; ++t) {
    const float* h_prev = t == 0 ? a.h0 : a.hbuf + size_t((t - 1) & 1) * B * hd;
    float* h_next = a.hbuf + size_t(t & 1) * B * hd;
    for (int b0 = 0; b0 < B; b0 += kRows) {
      const int rows = min(kRows, B - b0);
#if SLSTM_STAGES >= 2
#if SLSTM_STAGES >= 4
      if (b0 > 0) {
        load_gx(gxv, gx, a, col, t, b0, rows);
      }
#endif
      __syncthreads();   // r_s, the state are written; the last pass is done with h_s, part_s
      // 1. the head's h rows [b0, b0 + rows), all loads in flight before any store
      for (int k4 = tid; k4 < (d >> 2); k4 += kThreads) {
        float4 v[kRows];
#pragma unroll
        for (int bb = 0; bb < kRows; ++bb) {
          v[bb] = bb < rows ? __ldcg(reinterpret_cast<const float4*>(
                                  h_prev + size_t(b0 + bb) * hd + size_t(head) * d) + k4)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
#pragma unroll
        for (int bb = 0; bb < kRows; ++bb) {
          const R* as_r = nullptr;
          *reinterpret_cast<float4*>(h_s + bb * d + 4 * k4) =
              make_float4(round_as(v[bb].x, as_r), round_as(v[bb].y, as_r),
                          round_as(v[bb].z, as_r), round_as(v[bb].w, as_r));
        }
      }
      __syncthreads();
#endif
#if SLSTM_STAGES >= 3
      // 2. the products: 4 gate-channels × 8 rows a thread
      if (ksi < ks_n) {
        float acc[kRows][4];
#pragma unroll
        for (int bb = 0; bb < kRows; ++bb) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[bb][q] = 0.0f;
          }
        }
#pragma unroll 4
        for (int k = 4 * ksi; k < d; k += 4 * ks_n) {
          float4 rv[4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            rv[kk] = load4(r_s + size_t(k + kk) * g4 + 4 * cg);
          }
#pragma unroll
          for (int bb = 0; bb < kRows; ++bb) {
            const float4 hv = *reinterpret_cast<const float4*>(h_s + bb * d + k);
            const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              acc[bb][0] = fmaf(hk[kk], rv[kk].x, acc[bb][0]);
              acc[bb][1] = fmaf(hk[kk], rv[kk].y, acc[bb][1]);
              acc[bb][2] = fmaf(hk[kk], rv[kk].z, acc[bb][2]);
              acc[bb][3] = fmaf(hk[kk], rv[kk].w, acc[bb][3]);
            }
          }
        }
#pragma unroll
        for (int bb = 0; bb < kRows; ++bb) {
          *reinterpret_cast<float4*>(part_s + (size_t(ksi) * kRows + bb) * g4 + 4 * cg) =
              make_float4(acc[bb][0], acc[bb][1], acc[bb][2], acc[bb][3]);
        }
      }
      __syncthreads();
#endif
#pragma unroll
      for (int j = 0; j < kOwn; ++j) {
        const int o = tid + j * kThreads;
        if (SLSTM_STAGES < 2 || o >= rows * cw) {
          continue;
        }
        const int bb = o >> a.log_cw;
        const size_t si = size_t(b0 + bb) * hd + col + own_c;   // [B, H·d]
#if SLSTM_STAGES >= 4
        // 3. the cell
        const int sc = (b0 + bb) * cw + own_c;                  // [B, cw] state
        float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const float* part = part_s + size_t(bb) * g4 + own_c;
#pragma unroll 4
        for (int q = 0; q < ks_n; ++q) {
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            sum[g] = __fadd_rn(sum[g], part[size_t(q) * kRows * g4 + g * cw]);
          }
        }
        float pre[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          pre[g] = __fadd_rn(__fadd_rn(gxv[j][g], sum[g]), bias[g]);
        }
        const float m = m_s[sc];
        const float fm = __fadd_rn(pre[1], m);
        const float m_new = fmaxf(fm, pre[0]);
        const float i = expf(__fadd_rn(pre[0], -m_new));
        const float f = expf(__fadd_rn(fm, -m_new));
        const float tz = tanhf(pre[2]);
        const float c_new = __fadd_rn(__fmul_rn(f, c_s[sc]), __fmul_rn(i, tz));
        const float n_new = __fadd_rn(__fmul_rn(f, n_s[sc]), i);
        const float o_gate = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-pre[3])));
        const float h_new = __fdiv_rn(__fmul_rn(o_gate, c_new), fmaxf(n_new, 1e-6f));
        c_s[sc] = c_new;
        n_s[sc] = n_new;
        m_s[sc] = m_new;
        // 4. h out
        __stcg(h_next + si, h_new);
        store(hs + size_t(t) * B * hd + si, h_new);
#ifdef SLSTM_TRAIN
        {
          const size_t plane = size_t(a.S) * B * hd;
          float* sv = a.saved + size_t(t) * B * hd + si;
          sv[0] = c_new;
          sv[plane] = n_new;
          sv[2 * plane] = i;
          sv[3 * plane] = f;
          sv[4 * plane] = tz;
          sv[5 * plane] = o_gate;
        }
#endif
        if (t == a.S - 1) {
          a.hT[si] = h_new;
          a.cT[si] = c_new;
          a.nT[si] = n_new;
          a.mT[si] = m_new;
        }
#elif SLSTM_STAGES == 3
        __stcg(h_next + si, 0.5f * part_s[bb * g4 + own_c]);
#else
        __stcg(h_next + si, 0.5f * h_s[bb * d + e0 + own_c]);
#endif
      }
    }
    if (t + 1 < a.S) {
      __syncthreads();   // every h of this step is written
      if (tid == 0) {
        arrive(a.arrived + head);
      }
#if SLSTM_STAGES >= 4
      load_gx(gxv, gx, a, col, t + 1, 0, rows0);   // in flight across the barrier
#endif
      if (tid == 0) {
        wait_for(a.arrived + head, per_head * (t + 1));
      }
      __syncthreads();
    }
  }
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
  int cw = 0, log_cw = 0;
  for (int c = 1, lc = 0; c <= kMaxCw && a.d % c == 0; c *= 2, ++lc) {
    if (int64_t(a.H) * (a.d / c) <= sms) {
      cw = c;
      log_cw = lc;
      break;
    }
  }
  if (cw == 0) return cudaErrorCooperativeLaunchTooLarge;
  if (int64_t(a.S) * (a.d / cw) > 2147483647LL) return cudaErrorInvalidValue;
  a.cw = cw;
  a.log_cw = log_cw;
  a.ks = kThreads / cw < a.d / 4 ? kThreads / cw : a.d / 4;
  a.r_async = (cw * sizeof(R)) % 16 == 0 && (a.d * sizeof(R)) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(a.r) % 16 == 0;
  const size_t smem = smem_bytes<R>(a.d, cw, a.ks, a.B);
  if (smem > size_t(max_smem)) return cudaErrorInvalidValue;
  const int grid = a.H * (a.d / cw);
  auto kernel = slstm_kernel<G, R>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return fail(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return fail(err);
  if (int64_t(per_sm) * sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  if (a.S > 1) {
    err = cudaMemsetAsync(a.arrived, 0, size_t(a.H) * sizeof(int), stream);
    if (err != cudaSuccess) return fail(err);
  }
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(kThreads), params, smem, stream);
  if (err != cudaSuccess) return fail(err);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns 0 on success or the CUDA error code (the
// launch is refused when the grid cannot be resident at once). Does not
// synchronise. All arrays are row-major and contiguous, h0 16-byte aligned,
// d % 4 == 0; hbuf is [2, B, H, d] f32 scratch followed by H int32 arrival
// counters.
int slstm_launch(const void* gx, int gx_is_bf16, const void* r, int r_is_bf16,
                 const void* bias, const void* h0, const void* c0, const void* n0,
                 const void* m0, void* hs, void* hT, void* cT, void* nT, void* mT,
                 void* hbuf, int64_t S, int64_t B, int64_t H, int64_t d SAVED_C_PARAM,
                 void* stream) {
  if (S < 1 || B < 1 || H < 1 || d < 4 || d % 4 != 0 || S > 2147483647LL ||
      B > 2147483647LL || H * d > 2147483647LL || 2 * B * H * d > 2147483647LL ||
      reinterpret_cast<uintptr_t>(h0) % 16 != 0 || reinterpret_cast<uintptr_t>(hbuf) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* hb = static_cast<float*>(hbuf);
  Args a{gx, r, static_cast<const float*>(bias), static_cast<const float*>(h0),
         static_cast<const float*>(c0), static_cast<const float*>(n0),
         static_cast<const float*>(m0), hs, static_cast<float*>(hT),
         static_cast<float*>(cT), static_cast<float*>(nT), static_cast<float*>(mT),
         hb, reinterpret_cast<int*>(hb + 2 * B * H * d), static_cast<int>(S),
         static_cast<int>(B), static_cast<int>(H), static_cast<int>(d), 0, 0, 0, 0
         SAVED_C_ARG};
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

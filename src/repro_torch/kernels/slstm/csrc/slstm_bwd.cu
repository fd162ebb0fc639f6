// sLSTM backward for Hopper (sm_90a): the reverse-time scan of the model's
// hand-written BPTT, src/repro/models/xlstm.py::_slstm_core_bwd, over the
// stores of slstm.cu's training build (-DSLSTM_TRAIN).
//
// For t = S-1 .. 0, every batch row b, head h and channel e, with the saved
// c, n, i, f, tz = tanh(z), so = sigmoid(o) of step t and cp, np those of
// step t - 1 (c0, n0 at t = 0), and the carries (dh', dc', dn') starting at
// the final state's cotangents (dhT, dcT, dnT):
//   dh  = dhs[t] + dh';  nn = max(n, 1e-6)
//   do  = dh (c / nn) so (1 - so)
//   dc  = dh so / nn + dc';   dn = -dh so c / (nn nn) + dn'
//   dz  = dc i (1 - tz tz);   di = (dc tz + dn) i;   df = (dc cp + dn np) f
//   dpre[t, b, :, h, e] = (di, df, dz, do)
//   dh' = sum over (g, e) of dpre[t, b, g, h, e] r[h, :, g, e]   (dpre in r's
//         type, as the reference casts it; f32 here: the training path is f32)
//   dc' = dc f;  dn' = dn f
// and (dh0, dc0, dn0) are the carries after t = 0. The m-stabilizer is a
// constant (the reference's exact treatment: h does not depend on m) and its
// cotangent is ignored. dR = sum over (t, b) of h_{t-1} (x) dpre and db =
// sum of dpre are single products outside the scan, left to torch.matmul as
// the reference leaves its one deferred einsum to XLA. The plain version is
// repro_torch/kernels/slstm/ref.py::slstm_bwd_ref. It replaces no TPU kernel:
// src/repro/kernels/slstm/kernel.py::slstm_pallas has no backward; the
// model's custom_vjp is pure JAX.
//
// Bound: the recurrent product dpre . r^T is 2·S·B·4·H·d² flops, the
// forward's: at xlstm-1.3b's training shape (S = 128, B = 8, H = 4, d = 512,
// f32) 8.6 GFLOP, 0.13 ms at 67 TFLOP/s of f32 outside the tensor cores; the
// bytes (the six saved planes, dhs and dpre, R once) need ~0.12 ms.
//
// Design: slstm.cu's. One cooperative launch runs the whole reverse scan; a
// block owns one head and cw of its d channels (d = 512, cw = 16: 128 blocks
// on the 132 SMs; cw the fewest of 4, 8, .., 64 for which one block an SM
// covers every head; the last block of a head may own fewer). dh' of a
// channel k needs dpre of all 4d (gate, channel) columns of its head, so the
// block keeps its rows of R, R[h, k-slice, :, :] (cw x 4d f32, 128 KiB at
// d = 512), in shared memory for the whole scan, copied once; it is laid out
// as [cw/4][4d + 1] float4, element (q, j) holding R[h, e0 + 4q + 0..3, j],
// so that one 16-byte load gives a thread 4 channels at one column and the
// eight lanes of a load phase hit eight bank groups. Each step, over passes
// of up to 8 batch rows:
//   1. the head's dpre of step t + 1, [rows][4d] f32 (64 KiB at the
//      training shape), comes from the dpre output itself at L2 (16-byte
//      cp.async.cg, all in flight before one wait): each step has its own
//      slot there, so the output is the exchange buffer and nothing is
//      double-buffered;
//   2. thread (js, q) sums dpre·R for channels 4q..4q+3 and all 8 rows in 32
//      register accumulators over the column groups js, js + KS, ... (4
//      columns a group, fmaf in column order); the KS partial sums go through
//      shared memory and the owner of (b, channel) adds them in order js = 0
//      .. KS-1 (a fixed order: two launches are bit-identical);
//   3. the owner runs the cell with the plain version's operations (the
//      previous kernel's expressions), its saved values and dhs loaded
//      before the step's barrier (the first pass's) or before the pass's
//      products; its dc', dn' carries live in dc0 and dn0 (read from dcT and
//      dnT at t = S-1), which only it reads and writes;
//   4. dpre[t] goes to the output at L2 (__stcg).
// A per-head barrier ends the step (slstm.cu's): a block arrives with the
// release pattern (fence.acq_rel.gpu, a relaxed add at GPU scope, after a
// __syncthreads), loads the next step's cell inputs and waits on an acquire
// load until the head's counter reaches (d / cw)·(steps done). After step 0
// one more exchange forms dh0 = dpre[0]·r^T. The counters are zeroed by
// cudaMemsetAsync on the launch's stream.
//
// A spin barrier deadlocks unless every block is resident, so the launch is
// cooperative and raises (cudaErrorCooperativeLaunchTooLarge) when no cw <=
// 64 gives at most one block an SM or the occupancy calculator refuses the
// grid. Shared memory holds R's slice, 8 rows of the exchange and the
// partial sums, 16·cw·d + 128·d + 32 KiB (+16·cw/4 bytes of padding): on
// 132 SMs that is d <= 516 at H = 4 and d <= 776 at H = 1
// (cudaErrorInvalidValue past 227 KiB).
//
// Where a step of the long scan (S = 2048, B = 8, H = 4, d = 512, f32)
// goes, in us, measured by step_split.py --backward, which builds the
// source with SLSTM_BWD_STAGES = 1 (the barrier alone), 2 (+ the dpre
// exchange), 3 (+ the products and their sum), 4 (+ the cell), on an NVIDIA
// H100 80GB HBM3, 700.00 W (in one call with the forward's split):
//                 barrier  exchange  products + sum  cell  step
//   the forward     1.05     0.74        1.84        0.65  4.28
//   this kernel     1.15     2.12        3.50        0.53  7.30
// The exchange reads 4x the forward's bytes (the head's 4d dpre columns a
// row against its d h columns); the products, 8 rows x 4 channels a
// thread as the forward's, took 3.0-3.4 us even with their R or dpre loads
// taken out, about 3x their FMA issue, which this card's tools cannot
// explain (no ncu). Loading the carries with the step's cell inputs before
// the barrier took the cell from 1.33 to 0.3-0.5 us.
//
// Everything is f32; d % 4 == 0; any B >= 1.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with a
// plain C interface.

#include <cuda_runtime.h>
#include <stdint.h>

#include "slstm_sync.cuh"

// step-split variants (step_split.py --backward): 1 the barrier alone, 2 +
// the dpre exchange, 3 + the products and their sum, 4 the whole step (the
// kernel)
#ifndef SLSTM_BWD_STAGES
#define SLSTM_BWD_STAGES 4
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;                          // batch rows a pass
constexpr int kMaxCw = 64;                        // channels a block at most
constexpr int kOwn = kRows * kMaxCw / kThreads;   // cells a thread owns a pass

struct Args {
  const float* dhs;     // [S, B, H, d]
  const float* dhT;     // [B, H, d] each
  const float* dcT;
  const float* dnT;
  const float* saved;   // [6, S, B, H, d]: c, n, i, f, tanh(z), sigmoid(o)
  const float* c0;      // [B, H, d] each
  const float* n0;
  const float* r;       // [H, d, 4, d]
  float* dpre;          // [S, B, 4, H, d]
  float* dh0;           // [B, H, d] each; dc0, dn0 also carry dc', dn'
  float* dc0;
  float* dn0;
  int* arrived;         // [H]: blocks of each head arrived, zeroed before the launch
  int S, B, H, d;
  int cw;               // channels of one head a block owns (4, 8, .., 64)
  int per_head;         // blocks of one head, ceil(d / cw)
  int ks;               // ways the length-4d sum is split (over groups of 4 columns)
};

// dynamic shared memory: R's slice [cw/4][4d + 1] float4, the exchange rows
// [kRows][4d] f32, the partial sums [ks][kRows][cw] f32
size_t smem_bytes(int d, int cw, int ks) {
  return size_t(cw / 4) * (4 * size_t(d) + 1) * 16 + size_t(kRows) * 4 * d * sizeof(float) +
         size_t(ks) * kRows * cw * sizeof(float);
}

// what the cell of (b, e) at step t reads
struct Cell {
  float c, n, i, f, tz, so, cp, np, dhs, dc, dn;   // dc, dn: the carries dc', dn'
};

__device__ __forceinline__ void load_cell(Cell& x, const Args& a, int t, size_t si) {
  const size_t bhd = size_t(a.B) * a.H * a.d;
  const size_t plane = size_t(a.S) * bhd;
  const size_t at = size_t(t) * bhd + si;
  x.c = a.saved[at];
  x.n = a.saved[plane + at];
  x.i = a.saved[2 * plane + at];
  x.f = a.saved[3 * plane + at];
  x.tz = a.saved[4 * plane + at];
  x.so = a.saved[5 * plane + at];
  x.cp = t > 0 ? a.saved[at - bhd] : a.c0[si];
  x.np = t > 0 ? a.saved[plane + at - bhd] : a.n0[si];
  x.dhs = a.dhs[at];
  x.dc = t == a.S - 1 ? a.dcT[si] : a.dc0[si];
  x.dn = t == a.S - 1 ? a.dnT[si] : a.dn0[si];
}

// the cells this thread owns in the pass of rows [b0, b0 + rows): cell o =
// tid + j·kThreads is (row o / cw, channel e0 + o % cw); -1 if none
__device__ __forceinline__ size_t cell_index(const Args& a, int j, int b0, int rows, int head,
                                             int e0, int ch, bool& own) {
  const int o = threadIdx.x + j * kThreads;
  const int bb = o / a.cw, kk = o - bb * a.cw;
  own = o < rows * a.cw && kk < ch;
  return (size_t(b0 + bb) * a.H + head) * a.d + e0 + kk;
}

// dh' of the pass's cells: the head's dpre of step ts, rows [b0, b0 + rows),
// against the block's rows of R; the owner of cell j gets it in dh[j]
__device__ __forceinline__ void dh_products(const Args& a, int ts, int b0, int rows, int head,
                                            const float4* r_s, float* x_s, float* part_s,
                                            float (&dh)[kOwn]) {
  const int d = a.d, cw = a.cw, nkq = cw / 4;
  const int tid = threadIdx.x;
  // 1. the exchange: [rows][4d] of dpre[ts], column j = g·d + e
  const int seg = d / 4;   // 16-byte chunks (column groups) of one gate
  for (int c = tid; c < (SLSTM_BWD_STAGES >= 2 ? rows * d : 0); c += kThreads) {
    const int bb = c / d, rem = c - bb * d;
    const int g = rem / seg, e4 = rem - g * seg;
    cp_async16(x_s + size_t(bb) * 4 * d + g * d + 4 * e4,
               a.dpre + ((size_t(ts) * a.B + b0 + bb) * 4 + g) * size_t(a.H) * d +
                   size_t(head) * d + 4 * e4);
  }
  cp_async_wait_all();
  __syncthreads();
  // 2. the products: 4 channels x 8 rows a thread, over its column groups
  //    js, js + KS, ...
  const int q = tid % nkq, js = tid / nkq;
  float acc[kRows][4];
#pragma unroll
  for (int bb = 0; bb < kRows; ++bb) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      acc[bb][kk] = 0.0f;
    }
  }
  const float4* rq = r_s + size_t(q) * (4 * d + 1);
  const float4* xq = reinterpret_cast<const float4*>(x_s);
#pragma unroll 2
  for (int jg = js; jg < (SLSTM_BWD_STAGES >= 3 && js < a.ks ? d : 0); jg += a.ks) {
    float4 rv[4];   // channels 4q .. 4q + 3 at columns 4jg .. 4jg + 3
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      rv[jj] = rq[4 * jg + jj];
    }
#pragma unroll
    for (int bb = 0; bb < kRows; ++bb) {
      const float4 xv = xq[size_t(bb) * d + jg];
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        acc[bb][0] = fmaf(xs[jj], rv[jj].x, acc[bb][0]);
        acc[bb][1] = fmaf(xs[jj], rv[jj].y, acc[bb][1]);
        acc[bb][2] = fmaf(xs[jj], rv[jj].z, acc[bb][2]);
        acc[bb][3] = fmaf(xs[jj], rv[jj].w, acc[bb][3]);
      }
    }
  }
  if (SLSTM_BWD_STAGES >= 3 && js < a.ks) {
#pragma unroll
    for (int bb = 0; bb < kRows; ++bb) {
      *reinterpret_cast<float4*>(part_s + (size_t(js) * kRows + bb) * cw + 4 * q) =
          make_float4(acc[bb][0], acc[bb][1], acc[bb][2], acc[bb][3]);
    }
  }
  __syncthreads();
  // 3. each owner adds its cell's partial sums in order, 8 loads in flight
#pragma unroll
  for (int j = 0; j < kOwn; ++j) {
    const int o = tid + j * kThreads;
    if (o < rows * cw) {
      const int bb = o / cw, kk = o - bb * cw;
      const float* p = part_s + bb * cw + kk;
      const size_t step = size_t(kRows) * cw;
      const int ks = SLSTM_BWD_STAGES >= 3 ? a.ks : 0;
      float sum = 0.0f;
      int w = 0;
      for (; w + 8 <= ks; w += 8) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          v[u] = p[(w + u) * step];
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          sum = __fadd_rn(sum, v[u]);
        }
      }
      for (; w < ks; ++w) {
        sum = __fadd_rn(sum, p[w * step]);
      }
      dh[j] = sum;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) slstm_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = a.d, cw = a.cw, B = a.B;
  const size_t hd = size_t(a.H) * d;
  const int head = blockIdx.x / a.per_head;
  const int e0 = (blockIdx.x - head * a.per_head) * cw;
  const int ch = min(cw, d - e0);   // channels of this block
  float4* r_s = reinterpret_cast<float4*>(smem);
  float* x_s = reinterpret_cast<float*>(r_s + size_t(cw / 4) * (4 * d + 1));
  float* part_s = x_s + size_t(kRows) * 4 * d;
  const int tid = threadIdx.x;

  // R's slice, once for the whole scan: r_s[q][j] = R[head, e0 + 4q + 0..3, j],
  // zeros for channels past d; one 16-byte load a channel, 4 in flight
  const float* r_head = a.r + size_t(head) * d * 4 * d;
  for (int i = tid; i < (cw / 4) * d; i += kThreads) {
    const int q = i / d, jg = i - q * d;
    float4 x[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = e0 + 4 * q + kk;
      x[kk] = k < d ? __ldg(reinterpret_cast<const float4*>(r_head + size_t(k) * 4 * d) + jg)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    float4* dst = r_s + size_t(q) * (4 * d + 1) + 4 * jg;
    dst[0] = make_float4(x[0].x, x[1].x, x[2].x, x[3].x);
    dst[1] = make_float4(x[0].y, x[1].y, x[2].y, x[3].y);
    dst[2] = make_float4(x[0].z, x[1].z, x[2].z, x[3].z);
    dst[3] = make_float4(x[0].w, x[1].w, x[2].w, x[3].w);
  }
  // the first pass's cell inputs of step S - 1
  Cell next[kOwn];
#pragma unroll
  for (int j = 0; j < kOwn; ++j) {
    bool own;
    const size_t si = cell_index(a, j, 0, min(kRows, B), head, e0, ch, own);
    if (own) {
      load_cell(next[j], a, a.S - 1, si);
    }
  }
  __syncthreads();   // r_s is written

  for (int t = a.S - 1; t >= 0; --t) {
    for (int b0 = 0; b0 < B; b0 += kRows) {
      const int rows = min(kRows, B - b0);
      Cell cur[kOwn];
      size_t si[kOwn];
      bool own[kOwn];
#pragma unroll
      for (int j = 0; j < kOwn; ++j) {
        si[j] = cell_index(a, j, b0, rows, head, e0, ch, own[j]);
        if (b0 == 0) {
          cur[j] = next[j];
        } else if (own[j]) {
          load_cell(cur[j], a, t, si[j]);
        }
      }
      float dh[kOwn];
      if (t == a.S - 1) {
#pragma unroll
        for (int j = 0; j < kOwn; ++j) {
          dh[j] = own[j] ? a.dhT[si[j]] : 0.0f;
        }
      } else {
        dh_products(a, t + 1, b0, rows, head, r_s, x_s, part_s, dh);
      }
#pragma unroll
      for (int j = 0; j < kOwn; ++j) {
        if (!own[j]) {
          continue;
        }
#if SLSTM_BWD_STAGES < 4
        if (SLSTM_BWD_STAGES == 3) {   // keeps the sum live
          __stcg(a.dpre + size_t(t) * B * 4 * hd + si[j], dh[j]);
        }
        continue;
#endif
        const Cell& x = cur[j];
        const float dhv = x.dhs + dh[j];
        const float nn = fmaxf(x.n, 1e-6f);
        const float d_o = dhv * (x.c / nn) * x.so * (1.0f - x.so);
        const float dc = dhv * x.so / nn + x.dc;
        const float dn = -dhv * x.so * x.c / (nn * nn) + x.dn;
        const float dz = dc * x.i * (1.0f - x.tz * x.tz);
        const float di = (dc * x.tz + dn) * x.i;
        const float df = (dc * x.cp + dn * x.np) * x.f;
        const size_t b = si[j] / hd;
        float* out = a.dpre + (size_t(t) * B + b) * 4 * hd + (si[j] - b * hd);
        __stcg(out, di);
        __stcg(out + hd, df);
        __stcg(out + 2 * hd, dz);
        __stcg(out + 3 * hd, d_o);
        a.dc0[si[j]] = dc * x.f;
        a.dn0[si[j]] = dn * x.f;
      }
    }
    // the head's barrier: every dpre[t] of the head is written
    __syncthreads();
    if (tid == 0) {
      arrive(a.arrived + head);
    }
    if (t > 0) {
#pragma unroll
      for (int j = 0; j < kOwn; ++j) {
        bool own;
        const size_t si = cell_index(a, j, 0, min(kRows, B), head, e0, ch, own);
        if (own) {
          load_cell(next[j], a, t - 1, si);
        }
      }
    }
    if (tid == 0) {
      wait_for(a.arrived + head, a.per_head * (a.S - t));
    }
    __syncthreads();
  }
  // dh0 = dpre[0] · r^T
  for (int b0 = 0; b0 < B; b0 += kRows) {
    const int rows = min(kRows, B - b0);
    float dh[kOwn];
    dh_products(a, 0, b0, rows, head, r_s, x_s, part_s, dh);
#pragma unroll
    for (int j = 0; j < kOwn; ++j) {
      bool own;
      const size_t si = cell_index(a, j, b0, rows, head, e0, ch, own);
      if (own) {
        a.dh0[si] = dh[j];
      }
    }
  }
}

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
  // cw: the fewest channels a block (4, 8, .., 64) for which one block an SM
  // covers every head
  int cw = 0;
  for (int c = 4; c <= kMaxCw; c *= 2) {
    if (int64_t(a.H) * ((a.d + c - 1) / c) <= sms) {
      cw = c;
      break;
    }
  }
  if (cw == 0) return cudaErrorCooperativeLaunchTooLarge;
  a.cw = cw;
  a.per_head = (a.d + cw - 1) / cw;
  a.ks = kThreads / (cw / 4) < a.d ? kThreads / (cw / 4) : a.d;
  if (int64_t(a.per_head) * a.S > 2147483647LL) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a.d, cw, a.ks);
  if (smem > size_t(max_smem)) return cudaErrorInvalidValue;
  const int grid = a.H * a.per_head;
  err = cudaFuncSetAttribute(slstm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return fail(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, slstm_bwd_kernel, kThreads, smem);
  if (err != cudaSuccess) return fail(err);
  if (int64_t(per_sm) * sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaMemsetAsync(a.arrived, 0, size_t(a.H) * sizeof(int), stream);
  if (err != cudaSuccess) return fail(err);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(slstm_bwd_kernel), dim3(grid),
                                    dim3(kThreads), params, smem, stream);
  if (err != cudaSuccess) return fail(err);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns 0 on success or the CUDA error code (the
// launch is refused when the grid cannot be resident at once or its shared
// memory exceeds the card's). Does not synchronise. All arrays f32,
// row-major and contiguous, r and dpre 16-byte aligned; d % 4 == 0;
// counters holds H int32 (zeroed here, on the stream).
int slstm_bwd_launch(const void* dhs, const void* dhT, const void* dcT, const void* dnT,
                     const void* saved, const void* c0, const void* n0, const void* r,
                     void* dpre, void* dh0, void* dc0, void* dn0, void* counters, int64_t S,
                     int64_t B, int64_t H, int64_t d, void* stream) {
  if (S < 1 || B < 1 || H < 1 || d < 4 || d % 4 != 0 || S > 2147483647LL ||
      B > 2147483647LL || H * d > 2147483647LL ||
      reinterpret_cast<uintptr_t>(r) % 16 != 0 || reinterpret_cast<uintptr_t>(dpre) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(dhs), static_cast<const float*>(dhT),
               static_cast<const float*>(dcT), static_cast<const float*>(dnT),
               static_cast<const float*>(saved), static_cast<const float*>(c0),
               static_cast<const float*>(n0), static_cast<const float*>(r),
               static_cast<float*>(dpre), static_cast<float*>(dh0), static_cast<float*>(dc0),
               static_cast<float*>(dn0), static_cast<int*>(counters), static_cast<int>(S),
               static_cast<int>(B), static_cast<int>(H), static_cast<int>(d), 0, 0, 0};
  return static_cast<int>(launch(a, static_cast<cudaStream_t>(stream)));
}

const char* slstm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

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
// Design (a first kernel: right, simple, not fast): one block of 512
// threads owns one (b, h) pair for the whole reverse scan. The pairs are
// independent (dh' of (b, h) reads only dpre of (b, h) and r[h]), so no
// block waits for another and no barrier crosses blocks. Each step: every
// thread runs the cell of its channels (e = tid, tid + 512, ...) with its
// dc', dn' in registers and writes dpre to device memory and to shared
// memory; after a __syncthreads each warp forms dh' for rows k = warp,
// warp + 16, ...: its lanes read r[h, k, :, :] (4d contiguous values) in
// 16-byte loads, multiply by dpre from shared memory and sum by shuffles;
// dh' goes to shared memory for the next step. R is read from L2 once a
// step by every block (4·d² floats), which bounds the kernel: 32 blocks at
// the training shape leave most SMs idle. The forward's design (R's slices
// resident in shared memory over ~128 blocks, dpre exchanged at a per-head
// barrier) is the way to the bound, for a later PR.
//
// Everything is f32; d % 4 == 0, d <= 2048.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with a
// plain C interface.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                     // channels a thread at most
constexpr int kMaxD = kThreads * kPer;

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
  float* dh0;           // [B, H, d] each
  float* dc0;
  float* dn0;
  int S, B, H, d;
};

__global__ void __launch_bounds__(kThreads) slstm_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int d = a.d, H = a.H, B = a.B;
  float* dpre_s = smem;          // [4 d]: the step's dpre of (b, h), (g, e) order
  float* dh_s = smem + 4 * d;    // [d]: dh' carried into the next (earlier) step
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const size_t hd = size_t(H) * d;
  const size_t plane = size_t(a.S) * B * hd;
  const size_t state0 = size_t(b) * hd + size_t(h) * d;   // (b, h, 0) of [B, H, d]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float dc_n[kPer], dn_n[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = tid + j * kThreads;
    dc_n[j] = e < d ? a.dcT[state0 + e] : 0.0f;
    dn_n[j] = e < d ? a.dnT[state0 + e] : 0.0f;
    if (e < d) {
      dh_s[e] = a.dhT[state0 + e];
    }
  }
  __syncthreads();
  const float* r_head = a.r + size_t(h) * d * 4 * d;
  for (int t = a.S - 1; t >= 0; --t) {
    const size_t at = size_t(t) * B * hd + state0;   // (t, b, h, 0) of [S, B, H, d]
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * kThreads;
      if (e >= d) {
        continue;
      }
      const float c = a.saved[at + e], n = a.saved[plane + at + e];
      const float i = a.saved[2 * plane + at + e], f = a.saved[3 * plane + at + e];
      const float tz = a.saved[4 * plane + at + e], so = a.saved[5 * plane + at + e];
      const float cp = t > 0 ? a.saved[at - B * hd + e] : a.c0[state0 + e];
      const float np = t > 0 ? a.saved[plane + at - B * hd + e] : a.n0[state0 + e];
      const float dh = a.dhs[at + e] + dh_s[e];
      const float nn = fmaxf(n, 1e-6f);
      const float d_o = dh * (c / nn) * so * (1.0f - so);
      const float dc = dh * so / nn + dc_n[j];
      const float dn = -dh * so * c / (nn * nn) + dn_n[j];
      const float dz = dc * i * (1.0f - tz * tz);
      const float di = (dc * tz + dn) * i;
      const float df = (dc * cp + dn * np) * f;
      float* out = a.dpre + (size_t(t) * B + b) * 4 * hd + size_t(h) * d + e;
      out[0] = di;
      out[hd] = df;
      out[2 * hd] = dz;
      out[3 * hd] = d_o;
      dpre_s[e] = di;
      dpre_s[d + e] = df;
      dpre_s[2 * d + e] = dz;
      dpre_s[3 * d + e] = d_o;
      dc_n[j] = dc * f;
      dn_n[j] = dn * f;
    }
    __syncthreads();   // dpre_s is whole; every thread has read dh_s
    // dh'[k] = sum_j dpre_s[j] r[h, k, j] over the 4d values j = (g, e)
    for (int k = warp; k < d; k += kWarps) {
      const float4* row = reinterpret_cast<const float4*>(r_head + size_t(k) * 4 * d);
      const float4* dp = reinterpret_cast<const float4*>(dpre_s);
      float acc = 0.0f;
      for (int q = lane; q < d; q += 32) {   // d float4 a row
        const float4 rv = __ldg(row + q), pv = dp[q];
        acc = fmaf(pv.x, rv.x, acc);
        acc = fmaf(pv.y, rv.y, acc);
        acc = fmaf(pv.z, rv.z, acc);
        acc = fmaf(pv.w, rv.w, acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (lane == 0) {
        dh_s[k] = acc;
      }
    }
    __syncthreads();   // dh' is whole; dpre_s may be rewritten
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = tid + j * kThreads;
    if (e < d) {
      a.dh0[state0 + e] = dh_s[e];
      a.dc0[state0 + e] = dc_n[j];
      a.dn0[state0 + e] = dn_n[j];
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns a CUDA error code (0 on success). Does not
// synchronise. All arrays f32, row-major and contiguous, r 16-byte aligned;
// d % 4 == 0 and d <= 2048.
int slstm_bwd_launch(const void* dhs, const void* dhT, const void* dcT, const void* dnT,
                     const void* saved, const void* c0, const void* n0, const void* r,
                     void* dpre, void* dh0, void* dc0, void* dn0, int64_t S, int64_t B,
                     int64_t H, int64_t d, void* stream) {
  if (S < 1 || B < 1 || H < 1 || d < 4 || d % 4 != 0 || d > kMaxD || S > 2147483647LL ||
      B * H > 2147483647LL || reinterpret_cast<uintptr_t>(r) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(dhs), static_cast<const float*>(dhT),
               static_cast<const float*>(dcT), static_cast<const float*>(dnT),
               static_cast<const float*>(saved), static_cast<const float*>(c0),
               static_cast<const float*>(n0), static_cast<const float*>(r),
               static_cast<float*>(dpre), static_cast<float*>(dh0), static_cast<float*>(dc0),
               static_cast<float*>(dn0), static_cast<int>(S), static_cast<int>(B),
               static_cast<int>(H), static_cast<int>(d)};
  const size_t smem = size_t(5) * d * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  slstm_bwd_kernel<<<static_cast<unsigned>(B * H), kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* slstm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

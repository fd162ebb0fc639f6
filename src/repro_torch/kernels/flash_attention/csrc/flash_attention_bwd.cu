// Flash-attention backward for Hopper (sm_90a): the gradients of
// flash_attention.cu's causal / windowed GQA attention
//
//   o[b, i, :] = sum_j P[i, j] v[b / G, j, :],  P[i, j] = exp(s[i, j] - lse[b, i]),
//   s[i, j]    = scale * q[b, i, :] . k[b / G, j, :] where allowed, P = 0 elsewhere,
//
// given dO, the forward's output o and its row log-sum-exp lse (the
// -DFLASH_ATTENTION_LSE build of flash_attention.cu):
//
//   Dv[b, i]  = sum_d dO[b, i, d] o[b, i, d]
//   dP[i, j]  = dO[b, i, :] . v[b / G, j, :]
//   dS[i, j]  = P[i, j] (dP[i, j] - Dv[b, i])
//   dq[b, i]  = scale * sum_j dS[i, j] k[b / G, j]
//   dk[h, j]  = scale * sum over the G q heads b of h, sum_i dS[i, j] q[b, i]
//   dv[h, j]  =         sum over the G q heads b of h, sum_i P[i, j] dO[b, i]
//
// with allowed = (j <= i if causal) and (j > i - window if a window is
// given), positions from 0 in q and k. The plain version of the same formula
// is repro_torch/kernels/flash_attention/ref.py::attention_bwd_ref. It
// replaces no TPU kernel: the JAX package differentiates its pure-JAX
// attention (src/repro/models/attention.py) and flash_attention_pallas
// (src/repro/kernels/flash_attention/kernel.py:74) has no backward. It is
// here because the port's forward runs the hand-written kernel, which
// autograd cannot see through.
//
// Bound: operations. The backward recomputes S and dP (4·d flops an allowed
// pair) and forms dq, dk and dv (6·d), so about 2.5x the forward's 4·d: at
// the long causal shape (112 q heads, S = T = 2048, d = 64) 148 GFLOP of
// f32, 2.2 ms at the 67 TFLOP/s of f32 outside the tensor cores (0.30 ms at
// 495 TFLOP/s of TF32; the bytes need 0.1 ms). This first kernel is plain
// SIMT f32 from shared memory; the tensor cores (mma.sync as the forward,
// then wgmma) are later work.
//
// Design, three launches, no atomics (a run repeats bit for bit):
//   1. dot: one warp a q row, Dv = rowsum(dO o) in f32;
//   2. dkdv: a block of 256 threads owns 32 kv rows of one kv head and keeps
//      their dk and dv in registers (thread (c, e) holds row c's d-columns
//      e, e + 8, ...); it loops over the G q heads of its kv head and over
//      the 32-row q tiles that can see its kv rows (causal: from the
//      diagonal on; window: up to the last row that still sees them),
//      staging q, dO, k and v in shared memory as f32 (rows padded to d + 1
//      floats: the score loop reads k and v across 32 rows bank-free), and
//      for each q tile forms P and dS [32 x 32] in shared memory (thread
//      (r, c) recomputes s and dP by d-long dot products), then adds
//      P^T dO and dS^T q into its registers; the sum over the G heads of a
//      kv head is inside the block, in a fixed order;
//   3. dq: a block owns 32 q rows of one q head, loops over the kv tiles its
//      rows see, forms dS the same way and adds dS k into its registers.
// q, k, v, o, dO and the gradients are f32 or bf16 (all one dtype, computed
// in f32, written in that dtype); lse and the scratch Dv are f32; d is 64 or
// 128; any Sq and T (ragged tiles masked).
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with a
// plain C interface.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;   // q rows and kv rows a tile

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float& p, float v) { p = v; }
__device__ __forceinline__ void from_float(__nv_bfloat16& p, float v) { p = __float2bfloat16_rn(v); }

struct Shape {
  int64_t bhq, group, sq, t, window;
  int causal;
  float scale;
};

template <int D>
struct Smem {
  static constexpr int kLd = D + 1;   // a row of f32, padded
  static constexpr int kS = kTile + 1;
  // q, dO, k, v tiles, then P, dS, then lse and Dv of the q rows
  static constexpr size_t kBytes =
      (4 * size_t(kTile) * kLd + 2 * size_t(kTile) * kS + 2 * kTile) * sizeof(float);
};

__device__ __forceinline__ bool allowed(int64_t i, int64_t j, const Shape& s) {
  return i < s.sq && j < s.t && (!s.causal || j <= i) && (s.window <= 0 || j > i - s.window);
}

// rows [r0, r0 + kTile) of a [rows, D] matrix into an f32 tile, zeros past the end
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t r0, int64_t rows) {
  constexpr int kLd = Smem<D>::kLd;
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    dst[r * kLd + c] = r0 + r < rows ? to_float(src[(r0 + r) * D + c]) : 0.0f;
  }
}

// P and dS of q rows [q0, q0 + 32) against kv rows [k0, k0 + 32): thread
// (r8, c) computes rows r8, r8 + 8, r8 + 16, r8 + 24 of column c
template <int D>
__device__ __forceinline__ void probs(const float* qs, const float* dos, const float* ks,
                                      const float* vs, const float* lse_s, const float* dv_s,
                                      float* ps, float* dss, int64_t q0, int64_t k0,
                                      const Shape& s) {
  constexpr int kLd = Smem<D>::kLd, kS = Smem<D>::kS;
  const int c = threadIdx.x & 31, r8 = threadIdx.x >> 5;
  float sc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float kv = ks[c * kLd + d], vv = vs[c * kLd + d];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r8 + 8 * i;
      sc[i] = fmaf(qs[r * kLd + d], kv, sc[i]);
      dp[i] = fmaf(dos[r * kLd + d], vv, dp[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r8 + 8 * i;
    const float p = allowed(q0 + r, k0 + c, s) ? expf(sc[i] * s.scale - lse_s[r]) : 0.0f;
    ps[r * kS + c] = p;
    dss[r * kS + c] = p * (dp[i] - dv_s[r]);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dot(const T* __restrict__ o,
                                                          const T* __restrict__ dout,
                                                          float* __restrict__ dv_out,
                                                          int64_t rows) {
  const int64_t row = int64_t(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) {
    return;
  }
  float acc = 0.0f;
#pragma unroll
  for (int c = lane; c < D; c += 32) {
    acc = fmaf(to_float(dout[row * D + c]), to_float(o[row * D + c]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    dv_out[row] = acc;
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dvec,
    T* __restrict__ dk, T* __restrict__ dv, const Shape s) {
  constexpr int kLd = Smem<D>::kLd, kS = Smem<D>::kS, kPer = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kTile * kLd;
  float* ks = dos + kTile * kLd;
  float* vs = ks + kTile * kLd;
  float* ps = vs + kTile * kLd;
  float* dss = ps + kTile * kS;
  float* lse_s = dss + kTile * kS;
  float* dv_s = lse_s + kTile;

  const int64_t hkv = blockIdx.y;
  const int64_t k0 = int64_t(blockIdx.x) * kTile;
  load_tile<D>(ks, k + hkv * s.t * D, k0, s.t);
  load_tile<D>(vs, v + hkv * s.t * D, k0, s.t);
  const int c = threadIdx.x >> 3, e = threadIdx.x & 7;   // kv row c, columns e + 8j
  float dk_acc[kPer], dv_acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    dk_acc[j] = 0.0f;
    dv_acc[j] = 0.0f;
  }
  // the q rows that see a key of this tile
  int64_t q_begin = s.causal ? (k0 / kTile) * kTile : 0;
  int64_t q_end = s.sq;
  if (s.window > 0 && k0 + kTile - 1 + s.window < q_end) {
    q_end = k0 + kTile - 1 + s.window;
  }
  for (int64_t g = 0; g < s.group; ++g) {
    const int64_t bh = hkv * s.group + g;
    for (int64_t q0 = q_begin; q0 < q_end; q0 += kTile) {
      __syncthreads();   // the last tile's P, dS, q and dO are consumed
      load_tile<D>(qs, q + bh * s.sq * D, q0, s.sq);
      load_tile<D>(dos, dout + bh * s.sq * D, q0, s.sq);
      if (threadIdx.x < kTile) {
        const int64_t row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < s.sq ? lse[bh * s.sq + row] : 0.0f;
        dv_s[threadIdx.x] = row < s.sq ? dvec[bh * s.sq + row] : 0.0f;
      }
      __syncthreads();
      probs<D>(qs, dos, ks, vs, lse_s, dv_s, ps, dss, q0, k0, s);
      __syncthreads();
      for (int r = 0; r < kTile; ++r) {
        const float p = ps[r * kS + c], ds = dss[r * kS + c];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          dv_acc[j] = fmaf(p, dos[r * kLd + e + 8 * j], dv_acc[j]);
          dk_acc[j] = fmaf(ds, qs[r * kLd + e + 8 * j], dk_acc[j]);
        }
      }
    }
  }
  const int64_t row = k0 + c;
  if (row < s.t) {
    T* dkr = dk + (hkv * s.t + row) * D;
    T* dvr = dv + (hkv * s.t + row) * D;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      from_float(dkr[e + 8 * j], dk_acc[j] * s.scale);
      from_float(dvr[e + 8 * j], dv_acc[j]);
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dvec,
    T* __restrict__ dq, const Shape s) {
  constexpr int kLd = Smem<D>::kLd, kS = Smem<D>::kS, kPer = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kTile * kLd;
  float* ks = dos + kTile * kLd;
  float* vs = ks + kTile * kLd;
  float* ps = vs + kTile * kLd;
  float* dss = ps + kTile * kS;
  float* lse_s = dss + kTile * kS;
  float* dv_s = lse_s + kTile;

  const int64_t bh = blockIdx.y;
  const int64_t hkv = bh / s.group;
  const int64_t q0 = int64_t(blockIdx.x) * kTile;
  load_tile<D>(qs, q + bh * s.sq * D, q0, s.sq);
  load_tile<D>(dos, dout + bh * s.sq * D, q0, s.sq);
  if (threadIdx.x < kTile) {
    const int64_t row = q0 + threadIdx.x;
    lse_s[threadIdx.x] = row < s.sq ? lse[bh * s.sq + row] : 0.0f;
    dv_s[threadIdx.x] = row < s.sq ? dvec[bh * s.sq + row] : 0.0f;
  }
  const int r = threadIdx.x >> 3, e = threadIdx.x & 7;   // q row r, columns e + 8j
  float acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    acc[j] = 0.0f;
  }
  // the kv tiles this q tile sees
  int64_t k_end = s.t;
  if (s.causal && q0 + kTile < k_end) {
    k_end = q0 + kTile;
  }
  int64_t k_begin = 0;
  if (s.window > 0 && q0 - s.window + 1 > 0) {
    k_begin = ((q0 - s.window + 1) / kTile) * kTile;
  }
  for (int64_t k0 = k_begin; k0 < k_end; k0 += kTile) {
    __syncthreads();   // the last tile's dS, k and v are consumed
    load_tile<D>(ks, k + hkv * s.t * D, k0, s.t);
    load_tile<D>(vs, v + hkv * s.t * D, k0, s.t);
    __syncthreads();
    probs<D>(qs, dos, ks, vs, lse_s, dv_s, ps, dss, q0, k0, s);
    __syncthreads();
    for (int c = 0; c < kTile; ++c) {
      const float ds = dss[r * kS + c];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        acc[j] = fmaf(ds, ks[c * kLd + e + 8 * j], acc[j]);
      }
    }
  }
  const int64_t row = q0 + r;
  if (row < s.sq) {
    T* dqr = dq + (bh * s.sq + row) * D;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      from_float(dqr[e + 8 * j], acc[j] * s.scale);
    }
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, void* dq, void* dk, void* dv,
                   float* dvec, const Shape s, cudaStream_t stream) {
  const int64_t rows = s.bhq * s.sq;
  const int64_t dot_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  const int64_t q_tiles = (s.sq + kTile - 1) / kTile, kv_tiles = (s.t + kTile - 1) / kTile;
  if (dot_blocks > 2147483647LL || s.bhq > 65535 || q_tiles > 2147483647LL ||
      kv_tiles > 2147483647LL) {
    return cudaErrorInvalidValue;
  }
  flash_bwd_dot<D, T><<<static_cast<unsigned>(dot_blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), dvec, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t smem = Smem<D>::kBytes;
  err = cudaFuncSetAttribute(flash_bwd_dkdv<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  flash_bwd_dkdv<D, T><<<dim3(static_cast<unsigned>(kv_tiles), static_cast<unsigned>(s.bhq / s.group)),
                         kThreads, smem, stream>>>(qt, kt, vt, dot, lse, dvec, static_cast<T*>(dk),
                                                   static_cast<T*>(dv), s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq<D, T><<<dim3(static_cast<unsigned>(q_tiles), static_cast<unsigned>(s.bhq)),
                       kThreads, smem, stream>>>(qt, kt, vt, dot, lse, dvec, static_cast<T*>(dq), s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns a CUDA error code (0 on success). Does not
// synchronise. q, o, dout, dq are [bhq, sq, d]; k, v, dk, dv [bhq / group,
// t, d]; lse [bhq, sq] f32; scratch holds bhq * sq f32. window <= 0 means no
// window.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const void* lse, void* dq, void* dk, void* dv,
                               void* scratch, int is_bf16, int d, int64_t bhq, int64_t group,
                               int64_t sq, int64_t t, int causal, int64_t window, float scale,
                               void* stream) {
  if (bhq <= 0 || group <= 0 || bhq % group != 0 || sq <= 0 || t <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape s{bhq, group, sq, t, window, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(scratch);
  cudaError_t err;
  if (d == 64) {
    err = is_bf16 ? launch<64, __nv_bfloat16>(q, k, v, o, dout, l, dq, dk, dv, sc, s, st)
                  : launch<64, float>(q, k, v, o, dout, l, dq, dk, dv, sc, s, st);
  } else if (d == 128) {
    err = is_bf16 ? launch<128, __nv_bfloat16>(q, k, v, o, dout, l, dq, dk, dv, sc, s, st)
                  : launch<128, float>(q, k, v, o, dout, l, dq, dk, dv, sc, s, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

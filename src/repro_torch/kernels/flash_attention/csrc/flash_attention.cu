// Forward online-softmax GQA attention (flash attention) for Hopper (sm_90a).
//
//   o[b, i, :] = sum_j softmax_j(s[i, j]) v[b / G, j, :],
//   s[i, j]    = scale * q[b, i, :] . k[b / G, j, :] where allowed, else -1e30,
//
// allowed = (j <= i if causal) and (j > i - window if a window is given),
// positions counted from 0 in both q and k. Replaces the TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas; like
// it, masked scores contribute exactly 0 and a row with no allowed key gives 0.
//
// Bound: operations. A causal launch does about 4·d·S(S+1)/2 f32 operations
// a q head (QK^T and PV) against 2·S·d·4 bytes of q and o and a shared K/V,
// so at the long prefill (112 q heads, S = T = 2048, d = 64) it is 60 GFLOP
// against 134 MB: 0.90 ms at 67 TFLOP/s of f32 outside the tensor cores, 40
// us of memory time. This first version uses SIMT FMAs only (no mma/wgmma,
// no TMA). What the design does about the bound:
//   - one block a (q head, 64-row q tile); the block loops over 64-row kv
//     tiles and keeps the running max m, denominator l and accumulator acc in
//     f32 registers, so neither the [S, T] scores nor the probabilities ever
//     reach device memory;
//   - GQA: q head b reads kv head b / G, so K/V are never repeated in memory;
//   - kv tiles wholly above the causal diagonal or wholly outside the window
//     are skipped (a skipped tile would leave m, l and acc unchanged), and
//     the q tiles with the longest causal rows are launched first;
//   - the 16 x 16 threads each own a 4 x 4 block of the score tile (rows
//     ty + 16i, kv columns tx + 16j) and 4 rows x d/16 columns of acc, so
//     every float4 read from shared memory feeds 4 FMAs per operand; the
//     tiles' rows are padded by 4 floats so these reads are free of bank
//     conflicts;
//   - the masked entries get p = 0 explicitly, so a row whose first tiles
//     are all masked (a window) never picks up exp(-1e30 - (-1e30)) = 1.
//
// q, o are [BHq, Sq, d], k, v [BHkv, T, d], all row-major, f32 or bf16 (all
// one dtype), d in {64, 128}, any Sq and T (the ragged last tiles are
// masked). Everything inside is f32; o is written in q's dtype.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with a
// plain C interface.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // q rows a block, kv rows a step
constexpr int kThreads = 256;   // 16 x 16
constexpr int kLdP = kTile + 4; // padded row stride of the probability tile
constexpr float kNegInf = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  // q, k, v tiles [64, D + 4] and the probability tile [64, 68], f32
  return (3 * kTile * (D + 4) + kTile * kLdP) * sizeof(float);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// Rows [row0, row0 + 64) of an [n, D] matrix into a padded f32 tile; rows
// at or past n become 0 (never garbage: 0 * NaN would poison acc).
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* __restrict__ src,
                                          int64_t row0, int64_t n) {
  constexpr int kVecs = D / 4;
  for (int e = threadIdx.x; e < kTile * kVecs; e += kThreads) {
    const int r = e / kVecs;
    const int c = (e % kVecs) * 4;
    const int64_t row = row0 + r;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row < n) {
      v = load4(src + row * D + c);
    }
    store4(tile + r * (D + 4) + c, v);
  }
}

__device__ __forceinline__ float group_max(float v) {   // over the 16 lanes of a row group
#pragma unroll
  for (int offset = 8; offset > 0; offset >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  }
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int offset = 8; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int64_t bhq,
                       int64_t group, int64_t sq, int64_t t, int causal,
                       int64_t window, float scale) {
  constexpr int kLd = D + 4;
  constexpr int kCols = D / 16;   // acc columns a thread: 4 (d = 64) or 8 (d = 128)
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kTile * kLd;
  float* vs = ks + kTile * kLd;
  float* ps = vs + kTile * kLd;

  const int64_t num_q_tiles = (sq + kTile - 1) / kTile;
  const int64_t rank = blockIdx.x;
  const int64_t bh = rank % bhq;
  const int64_t q0 = (num_q_tiles - 1 - rank / bhq) * kTile;   // longest rows first
  const T* qb = q + bh * sq * D;
  const T* kb = k + (bh / group) * t * D;
  const T* vb = v + (bh / group) * t * D;
  const int tx = threadIdx.x & 15;   // kv columns tx + 16j; acc columns 64c + 4tx + e
  const int ty = threadIdx.x >> 4;   // rows ty + 16i

  load_tile<D>(qs, qb, q0, sq);

  // kv tiles that hold an allowed key for some row of this q tile
  int64_t kv_end = t;
  if (causal && q0 + kTile < kv_end) {
    kv_end = q0 + kTile;
  }
  int64_t kv_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) {
    kv_begin = ((q0 - window + 1) / kTile) * kTile;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      acc[i][c] = 0.0f;
    }
  }

  for (int64_t k0 = kv_begin; k0 < kv_end; k0 += kTile) {
    __syncthreads();   // the previous step's readers of ks, vs, ps are done
    load_tile<D>(ks, kb, k0, t);
    load_tile<D>(vs, vb, k0, t);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = 0.0f;
      }
    }
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * kLd + c);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * kLd + c);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qpos = q0 + ty + 16 * i;
      bool ok[4];
      float tile_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kpos = k0 + tx + 16 * j;
        ok[j] = kpos < t && (!causal || kpos <= qpos) &&
                (window <= 0 || kpos > qpos - window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(tile_max));
      const float corr = expf(m[i] - m_new);
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        ps[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        row_sum += p;
      }
      l[i] = l[i] * corr + group_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        acc[i][c] *= corr;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * kLdP + j);
        p[i][0] = p4.x;
        p[i][1] = p4.y;
        p[i][2] = p4.z;
        p[i][3] = p4.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = vs + (j + jj) * kLd + 4 * tx;
#pragma unroll
        for (int c4 = 0; c4 < kCols / 4; ++c4) {
          const float4 v4 = *reinterpret_cast<const float4*>(vrow + 64 * c4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * c4 + 0] = fmaf(p[i][jj], v4.x, acc[i][4 * c4 + 0]);
            acc[i][4 * c4 + 1] = fmaf(p[i][jj], v4.y, acc[i][4 * c4 + 1]);
            acc[i][4 * c4 + 2] = fmaf(p[i][jj], v4.z, acc[i][4 * c4 + 2]);
            acc[i][4 * c4 + 3] = fmaf(p[i][jj], v4.w, acc[i][4 * c4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + ty + 16 * i;
    if (row >= sq) {
      continue;
    }
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + (bh * sq + row) * D + 4 * tx;
#pragma unroll
    for (int c4 = 0; c4 < kCols / 4; ++c4) {
      store4(orow + 64 * c4,
             make_float4(acc[i][4 * c4 + 0] / denom, acc[i][4 * c4 + 1] / denom,
                         acc[i][4 * c4 + 2] / denom, acc[i][4 * c4 + 3] / denom));
    }
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int64_t bhq,
           int64_t group, int64_t sq, int64_t t, int causal, int64_t window,
           float scale, cudaStream_t stream) {
  const int64_t blocks = bhq * ((sq + kTile - 1) / kTile);
  if (blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<D, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  flash_attention_kernel<D, T><<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), bhq, group, sq, t, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns a CUDA error code (0 on success). Does not
// synchronise. window <= 0 means no window.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           int is_bf16, int d, int64_t bhq, int64_t group, int64_t sq,
                           int64_t t, int causal, int64_t window, float scale,
                           void* stream) {
  if (bhq <= 0 || group <= 0 || bhq % group != 0 || sq <= 0 || t <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) {
    return is_bf16 ? launch<64, __nv_bfloat16>(q, k, v, o, bhq, group, sq, t, causal, window, scale, s)
                   : launch<64, float>(q, k, v, o, bhq, group, sq, t, causal, window, scale, s);
  }
  if (d == 128) {
    return is_bf16 ? launch<128, __nv_bfloat16>(q, k, v, o, bhq, group, sq, t, causal, window, scale, s)
                   : launch<128, float>(q, k, v, o, bhq, group, sq, t, causal, window, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

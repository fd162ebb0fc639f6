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
// Bound: operations. A causal launch does about 4·d·S(S+1)/2 flops a q head
// (QK^T and PV) against q, o and a shared K/V read or written once: at the
// long prefill (112 q heads, S = T = 2048, d = 64) 60 GFLOP against 134 MB
// (f32). Both products run on the tensor cores with warp-level mma.sync, at
// a precision that keeps the plain version's tolerances:
//
//   - f32 inputs, 3xTF32: each operand x is split into x_hi = rna_tf32(x) and
//     x_lo = rna_tf32(x - x_hi), and each product is a_lo·b_hi + a_hi·b_lo +
//     a_hi·b_hi in mma.m16n8k8.tf32 with f32 accumulation: ~3·2^-22 of
//     relative error a product against 2^-11 for one TF32 pass (whose ~1e-3
//     errors fail the f32 tolerance). Three passes at 495 TFLOP/s: 0.365 ms
//     at the long prefill (the SIMT f32 bound is 0.90 ms).
//   - bf16 inputs: S = QK^T in one mma.m16n8k16.bf16 pass (a bf16 product is
//     exact in f32), and PV with P split into P_hi = bf16(P) and P_lo =
//     bf16(P - P_hi), two passes against V: the reference keeps P in f32,
//     and one bf16 P would put 2^-9·sum_j p_j|v_j| on outputs that nearly
//     cancel. The tensor cores do 1.5x the one-pass work (0.061 ms bound).
//
// What the design does:
//   - a block of 4 warps owns 16·kM q rows a warp of one q head and loops over
//     kv tiles; the score tile lives in registers as m16n8 accumulator
//     fragments, the row max and sum are taken by shuffles over the 4 lanes
//     that share a row, and the accumulator fragment is re-packed in
//     registers as the A operand of PV, so P never reaches shared memory and
//     one barrier a kv tile suffices;
//   - K/V tiles sit in a two-stage ring in shared memory, filled by 16-byte
//     cp.async.cg: the copy of tile i + 1 is issued before the math of tile
//     i; ragged rows are zero-filled through the copy's source size (zeros,
//     never garbage: 0·NaN would poison acc);
//   - fragments are read with ldmatrix (bf16: .trans for V; f32: Q and K as
//     8x4-word matrices; f32 V by 16-byte loads, d permuted across n-blocks).
//     Rows are padded by 16 bytes (4 floats / 8 bf16), which makes every
//     ldmatrix phase (8 rows of 16 bytes) and the V loads conflict-free;
//   - f32: each TF32 split takes 4 instructions, and the kernel is bound by
//     the issue of the instructions beside the mma (not by shared memory), so
//     operands are split as few times as the registers allow:
//     K and V fragments once a warp as they are loaded, shared by the warp's
//     kM m-tiles; at d = 64 two m-tiles a warp (32 q rows) and Q split once a
//     block into shared memory (hi in place, lo beside it); at d = 128, where
//     acc takes 64 registers an m-tile, one m-tile and Q split each kv tile
//     as its fragments are loaded (its hi/lo, 128 registers, never held);
//   - kv tiles wholly above the causal diagonal or wholly outside the window
//     are skipped by the block, and by a warp whose rows they miss; masks
//     are applied only on the tiles that need them; the longest causal rows
//     are launched first; GQA reads kv head b / G, never repeated K/V;
//   - softmax in the log2 domain: the max of the raw scores, then p =
//     2^(s·scale·log2(e) - m) as one FFMA and ex2.approx;
//   - f32: each thread rewrites a NaN in the q, K and V chunks it copied as
//     0x7fc00000 (its own copies are visible to it after the wait; its
//     chunks are loaded together and checked by the sums of their |x|), so
//     the integer TF32 rounding keeps it a NaN; checking at each warp's
//     split instead made the f32 kernel 1.5x (d = 64) and 2.35x (d = 128)
//     slower on the H100.
//
// Shared memory, registers (ptxas) and occupancy (128 threads a block):
//   f32  d = 64:  2 m-tiles a warp, q 128x68 hi + lo, K/V 2 x 2 x 32x68 floats
//                 = 104,448 B, 218 registers: 2 blocks an SM
//   f32  d = 128: 1 m-tile, q 64x132, K/V 2 x 2 x 32x132 = 101,376 B, 202: 2 blocks
//   bf16 d = 64:  1 m-tile, q 64x72, K/V 2 x 2 x 64x72 bf16 = 46,080 B, 162: 3 blocks
//   bf16 d = 128: 1 m-tile, q 64x136, K/V 2 x 2 x 64x136 = 87,040 B, 242: 2 blocks
//
// q, o are [BHq, Sq, d], k, v [BHkv, T, d], all row-major, f32 or bf16 (all
// one dtype), 16-byte aligned, d in {64, 128}, any Sq and T (the ragged
// last tiles are masked). m, l and the accumulator are f32; o is written in
// q's dtype. A NaN in q, k or v makes NaN every output it reaches, as in the
// plain version (which, summing over all keys, also spreads a NaN of v to
// rows whose tiles this kernel skips). An Inf in f32 can give NaN where the
// plain version gives +-Inf: its 3xTF32 product with a finite operand adds
// the Inf times the lo part, whose sign may differ from hi's.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with a
// plain C interface.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mma.cuh"

// The training variant (-DFLASH_ATTENTION_LSE, kernel.py's LSE_BUILD) also
// writes each row's natural log-sum-exp of the scaled scores,
// lse [BHq, Sq] f32 = (m + log2(max(l, 1e-30))) / log2(e),
// which flash_attention_bwd.cu reads to recompute P; the serve build has
// neither the argument nor the store.
#ifdef FLASH_ATTENTION_LSE
#define LSE_PARAM , float* __restrict__ lse
#define LSE_ARG , lse
#define LSE_C_PARAM , void* lse
#define LSE_C_ARG , static_cast<float*>(lse)
#else
#define LSE_PARAM
#define LSE_ARG
#define LSE_C_PARAM
#define LSE_C_ARG
#endif

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Route;
template <>
struct Route<float> {             // 3xTF32, mma.m16n8k8
  static constexpr int kKv = 32;   // kv rows a tile
  static constexpr int kPad = 4;   // elements a row: 16 bytes
};
template <>
struct Route<__nv_bfloat16> {     // bf16, mma.m16n8k16, split P
  static constexpr int kKv = 64;
  static constexpr int kPad = 8;
};

template <int D, typename T>
struct Layout {
  // m16 tiles a warp: two for f32 at d = 64, so that each K/V fragment is
  // loaded and split once for twice the mma; one where acc would not fit
  // the registers twice (d = 128) and for bf16 (no split of K/V)
  static constexpr int kM = sizeof(T) == 4 && D == 64 ? 2 : 1;
  // f32 with two m-tiles: Q split into hi (in place) and lo once a block
  static constexpr bool kSplitQ = sizeof(T) == 4 && kM == 2;
  static constexpr int kRows = 16 * kM;            // q rows a warp
  static constexpr int kBq = kWarps * kRows;       // q rows a block
  static constexpr int kKv = Route<T>::kKv;
  static constexpr int kLd = D + Route<T>::kPad;   // elements a row
  static constexpr int kQ = kBq * kLd;             // elements of the q tile
  static constexpr int kStage = kKv * kLd;         // elements of one K or V tile
  static constexpr size_t kBytes =
      static_cast<size_t>((kSplitQ ? 2 : 1) * kQ + 4 * kStage) * sizeof(T);
  // blocks an SM by shared memory (227 KB, 1 KB a block reserved), at most 3
  // (a cap of 4, 128 registers a thread, made the bf16 d = 64 kernel spill),
  // and 2 with two m-tiles a warp (3 spilled there)
  static constexpr int kFit = 232448 / (kBytes + 1024);
  static constexpr int kCap = kM == 2 ? 2 : 3;
  static constexpr int kMinBlocks = kFit < kCap ? (kFit < 1 ? 1 : kFit) : kCap;
};

// Rows [row0, row0 + R) of an [n, D] matrix into a padded shared tile, by
// 16-byte cp.async; rows at or past n are zero-filled.
template <int R, int D, typename T>
__device__ __forceinline__ void copy_tile(T* tile, const T* __restrict__ src, int64_t row0,
                                          int64_t n) {
  constexpr int kLd = Layout<D, T>::kLd;
  constexpr int kElts = 16 / sizeof(T);
  constexpr int kChunks = D / kElts;   // 16-byte chunks a row
  static_assert((R * kChunks) % kThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < R * kChunks / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / kChunks;
    const int c = (e % kChunks) * kElts;
    const int64_t row = row0 + r;
    const bool in = row < n;
    cp_async16(smem_addr(tile + r * kLd + c), src + (in ? row * D + c : 0), in ? 16 : 0);
  }
}

// The offset of the i-th 16-byte chunk that copy_tile gives this thread in
// an f32 tile (its own copies are visible to it after the wait)
template <int D>
__device__ __forceinline__ int own_chunk(int i) {
  constexpr int kChunks = D / 4;
  const int e = threadIdx.x + i * kThreads;
  return (e / kChunks) * Layout<D, float>::kLd + (e % kChunks) * 4;
}

// This thread's chunks of N R-row f32 tiles with NaNs made quiet_nan's, in
// place: once a block rather than at each warp's split. All chunks are
// loaded first and checked together (a chunk whose |x| sum is finite holds
// no NaN), so only a tile holding a NaN, Inf or huge value pays a branch.
template <int R, int D, int N>
__device__ __forceinline__ void quiet_own_chunks(float* const (&tiles)[N]) {
  constexpr int kEach = R * (D / 4) / kThreads;
  float4 x[N][kEach];
  bool special = false;
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int i = 0; i < kEach; ++i) {
      x[n][i] = *reinterpret_cast<const float4*>(tiles[n] + own_chunk<D>(i));
      special |= !((fabsf(x[n][i].x) + fabsf(x[n][i].y)) + (fabsf(x[n][i].z) + fabsf(x[n][i].w)) <
                   INFINITY);
    }
  }
  if (special) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
#pragma unroll
      for (int i = 0; i < kEach; ++i) {
        *reinterpret_cast<float4*>(tiles[n] + own_chunk<D>(i)) =
            make_float4(quiet_nan(x[n][i].x), quiet_nan(x[n][i].y), quiet_nan(x[n][i].z),
                        quiet_nan(x[n][i].w));
      }
    }
  }
}

// This thread's chunks of an f32 tile split into hi in place and lo
template <int R, int D>
__device__ __forceinline__ void split_own_chunks(float* tile, float* lo_tile) {
#pragma unroll
  for (int i = 0; i < R * (D / 4) / kThreads; ++i) {
    const int off = own_chunk<D>(i);
    const float4 v = *reinterpret_cast<const float4*>(tile + off);
    const uint32_t x[4] = {__float_as_uint(quiet_nan(v.x)), __float_as_uint(quiet_nan(v.y)),
                           __float_as_uint(quiet_nan(v.z)), __float_as_uint(quiet_nan(v.w))};
    uint32_t hi[4], lo[4];
    split_tf32(x, hi, lo);
    *reinterpret_cast<uint4*>(tile + off) = *reinterpret_cast<const uint4*>(hi);
    *reinterpret_cast<uint4*>(lo_tile + off) = *reinterpret_cast<const uint4*>(lo);
  }
}

// ------------------------------------------------------------- the products

// S (kM x 16 q rows x 8·kNb keys, m16n8 fragments) = Q_warp · K_tile^T. Each
// K fragment is loaded (and, f32, split) once and used by all kM m-tiles.
template <int D, typename T, int kM, int kNb>
__device__ __forceinline__ void scores(float (&s)[kM][kNb][4], const T* qs, int qs_lo_off,
                                       const T* ks, int lane) {
  constexpr int kLd = Layout<D, T>::kLd;
#pragma unroll
  for (int mi = 0; mi < kM; ++mi) {
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[mi][nb][e] = 0.0f;
      }
    }
  }
  // ldmatrix: lane L gives the row address of matrix L / 8, row L % 8
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1);
  constexpr uint32_t kTileBytes = 16 * kLd * sizeof(T);   // one m-tile of q
  if constexpr (sizeof(T) == 4) {
    // a 16-byte matrix row holds 4 floats: lane (g, t) receives word t of row g
    const uint32_t q_base = smem_addr(qs + a_row * kLd + 4 * (lane >> 4));
    const uint32_t k_base = smem_addr(ks + (lane & 7) * kLd + 4 * (lane >> 3));
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {   // two k-steps of 8
      uint32_t q_hi[kM][2][4], q_lo[kM][2][4];
#pragma unroll
      for (int mi = 0; mi < kM; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t at = q_base + mi * kTileBytes + (kk + 8 * h) * 4;
          if constexpr (Layout<D, T>::kSplitQ) {
            ldmatrix_x4(q_hi[mi][h], at);
            ldmatrix_x4(q_lo[mi][h], at + qs_lo_off * 4);
          } else {
            uint32_t qa[4];
            ldmatrix_x4(qa, at);
            split_tf32(qa, q_hi[mi][h], q_lo[mi][h]);
          }
        }
      }
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb) {
        uint32_t kb[4], k_hi[4], k_lo[4];   // b0, b1 of k-step kk; b0, b1 of kk + 8
        ldmatrix_x4(kb, k_base + (nb * 8 * kLd + kk) * 4);
        split_tf32(kb, k_hi, k_lo);
#pragma unroll
        for (int mi = 0; mi < kM; ++mi) {
          mma_3xtf32(s[mi][nb], q_hi[mi][0], q_lo[mi][0], k_hi[0], k_hi[1], k_lo[0], k_lo[1]);
          mma_3xtf32(s[mi][nb], q_hi[mi][1], q_lo[mi][1], k_hi[2], k_hi[3], k_lo[2], k_lo[3]);
        }
      }
    }
  } else {
    const uint32_t q_base = smem_addr(qs + a_row * kLd + 8 * (lane >> 4));
    const uint32_t k_base = smem_addr(ks + (lane & 7) * kLd + 8 * (lane >> 3));
#pragma unroll
    for (int kk = 0; kk < D; kk += 32) {   // two k-steps of 16
      uint32_t qa[kM][2][4];
#pragma unroll
      for (int mi = 0; mi < kM; ++mi) {
        ldmatrix_x4(qa[mi][0], q_base + mi * kTileBytes + kk * 2);
        ldmatrix_x4(qa[mi][1], q_base + mi * kTileBytes + (kk + 16) * 2);
      }
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb) {
        uint32_t kb[4];   // b0, b1 of k-step kk; b0, b1 of kk + 16
        ldmatrix_x4(kb, k_base + (nb * 8 * kLd + kk) * 2);
#pragma unroll
        for (int mi = 0; mi < kM; ++mi) {
          mma_bf16(s[mi][nb], qa[mi][0], kb[0], kb[1]);
          mma_bf16(s[mi][nb], qa[mi][1], kb[2], kb[3]);
        }
      }
    }
  }
}

// acc (kM x 16 q rows x D, m16n8 fragments) += P · V_tile, P the
// probabilities in the score fragments. Each V fragment is loaded (and, f32,
// split) once and used by all kM m-tiles.
template <int D, typename T, int kM, int kNb>
__device__ __forceinline__ void accumulate(float (&acc)[kM][D / 8][4],
                                           const float (&p)[kM][kNb][4], const T* vs,
                                           int lane) {
  constexpr int kLd = Layout<D, T>::kLd;
  if constexpr (sizeof(T) == 4) {
    // k-step j covers keys 8j..8j+7 in the order k = t <-> key 8j + 2t, k = t + 4
    // <-> key 8j + 2t + 1, which is where the score fragment holds them: a0 =
    // (row g, key 2t) = c0, a1 = (g + 8, 2t) = c2, a2 = (g, 2t + 1) = c1, a3 = c3.
    // n-block 4c + i takes its column n = g from d = 32c + 4g + i, so one
    // 16-byte load a key row gives a lane its b of 4 n-blocks (banks 8t + 4g:
    // conflict-free a quarter warp); acc[4c + i] then holds d = 32c + 8t + i
    // (c0, c2) and 32c + 8t + 4 + i (c1, c3).
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < kNb; ++j) {
      uint32_t p_hi[kM][4], p_lo[kM][4];
#pragma unroll
      for (int mi = 0; mi < kM; ++mi) {
        const uint32_t pa[4] = {__float_as_uint(p[mi][j][0]), __float_as_uint(p[mi][j][2]),
                                __float_as_uint(p[mi][j][1]), __float_as_uint(p[mi][j][3])};
        split_tf32(pa, p_hi[mi], p_lo[mi]);
      }
      const float* v0 = vs + (8 * j + 2 * t) * kLd + 4 * g;   // b0: key 2t
      const float* v1 = v0 + kLd;                             // b1: key 2t + 1
#pragma unroll
      for (int c = 0; c < D / 32; ++c) {
        uint32_t x0[4], x1[4], h0[4], h1[4], l0[4], l1[4];
        load16(x0, v0 + 32 * c);
        load16(x1, v1 + 32 * c);
        split_tf32(x0, h0, l0);
        split_tf32(x1, h1, l1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int mi = 0; mi < kM; ++mi) {
            mma_3xtf32(acc[mi][4 * c + i], p_hi[mi], p_lo[mi], h0[i], h1[i], l0[i], l1[i]);
          }
        }
      }
    }
  } else {
    // k-step j covers keys 16j..16j+15: the fragments of key blocks 2j, 2j + 1
    const uint32_t v_base = smem_addr(vs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kLd +
                                      8 * (lane >> 4));
#pragma unroll
    for (int j = 0; j < kNb / 2; ++j) {
      uint32_t p_hi[kM][4], p_lo[kM][4];
#pragma unroll
      for (int mi = 0; mi < kM; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {   // a0/a1 from block 2j, a2/a3 from 2j + 1
            const float x0 = p[mi][2 * j + h][2 * r], x1 = p[mi][2 * j + h][2 * r + 1];
            const uint32_t hi = pack_bf16(x0, x1);
            p_hi[mi][2 * h + r] = hi;
            p_lo[mi][2 * h + r] = pack_bf16(x0 - bf16_low(hi), x1 - bf16_high(hi));
          }
        }
      }
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 2) {
        uint32_t vb[4];   // b0, b1 of columns 8nd..; b0, b1 of 8(nd + 1)..
        ldmatrix_x4_trans(vb, v_base + (16 * j * kLd + 8 * nd) * 2);
#pragma unroll
        for (int mi = 0; mi < kM; ++mi) {
          mma_bf16(acc[mi][nd], p_lo[mi], vb[0], vb[1]);
          mma_bf16(acc[mi][nd], p_hi[mi], vb[0], vb[1]);
          mma_bf16(acc[mi][nd + 1], p_lo[mi], vb[2], vb[3]);
          mma_bf16(acc[mi][nd + 1], p_hi[mi], vb[2], vb[3]);
        }
      }
    }
  }
}

// The online softmax of one kv tile on one m-tile's score fragments s (16
// rows x 8·kNb keys): lane (g, tq) holds row g's keys 8nb + 2tq + {0, 1} in
// s[nb][0..1] and row g + 8's in s[nb][2..3]. Scales to log2 units, updates
// the running max m and this lane's part of the sum l, rescales acc, and
// leaves the probabilities in s. kMask: the tile holds a key some row may not
// see (ragged, causal diagonal, window edge); such keys get p = 0 exactly
// (the raw score -1e30, then p = 0 explicitly).
template <bool kMask, int kNb, int kAcc>
__device__ __forceinline__ void online_softmax(float (&s)[kNb][4], float (&m)[2],
                                               float (&l)[2], float (&acc)[kAcc][4],
                                               float scale_log2, int64_t k0, int64_t row0,
                                               int lane, int64_t t, int causal,
                                               int64_t window) {
  const int g = lane >> 2, tq = lane & 3;
  uint32_t ok = 0xffffffffu;   // bit 4nb + e: s[nb][e] is allowed
  if constexpr (kMask) {
    ok = 0;
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t qpos = row0 + g + 8 * (e >> 1);
        const int64_t kpos = k0 + 8 * nb + 2 * tq + (e & 1);
        const bool allowed = kpos < t && (!causal || kpos <= qpos) &&
                             (window <= 0 || kpos > qpos - window);
        ok |= static_cast<uint32_t>(allowed) << (4 * nb + e);
      }
    }
  }
  // the max of the raw scores (scale > 0), then p = 2^(s·scale·log2(e) - m) in one FFMA
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int nb = 0; nb < kNb; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kMask) {
        s[nb][e] = (ok >> (4 * nb + e)) & 1u ? s[nb][e] : kNegInf;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
    }
  }
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // an all-masked row keeps m = -1e30 (mx·scale would round it inwards)
    const float m_new = fmaxf(m[r], mx[r] == kNegInf ? kNegInf : mx[r] * scale_log2);
    corr[r] = exp2_approx(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int nb = 0; nb < kNb; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pe = exp2_approx(fmaf(s[nb][e], scale_log2, -m[e >> 1]));
      if constexpr (kMask) {
        pe = (ok >> (4 * nb + e)) & 1u ? pe : 0.0f;
      }
      s[nb][e] = pe;
      l[e >> 1] += pe;
    }
  }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[i][e] *= corr[e >> 1];
    }
  }
}

// ------------------------------------------------------------------ the kernel

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, Layout<D, T>::kMinBlocks)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int64_t bhq,
                       int64_t group, int64_t sq, int64_t t, int causal,
                       int64_t window, float scale LSE_PARAM) {
  using L = Layout<D, T>;
  constexpr int kM = L::kM;
  constexpr int kKv = L::kKv;
  constexpr int kNb = kKv / 8;
  constexpr int kBq = L::kBq;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* qs_lo = qs + L::kQ;                              // kSplitQ: lo of the q tile
  T* ks = qs + (L::kSplitQ ? 2 : 1) * L::kQ;          // stage s at ks + s * kStage
  T* vs = ks + 2 * L::kStage;

  const int64_t num_q_tiles = (sq + kBq - 1) / kBq;
  const int64_t rank = blockIdx.x;
  const int64_t bh = rank % bhq;
  const int64_t q0 = (num_q_tiles - 1 - rank / bhq) * kBq;   // longest rows first
  const T* kb = k + (bh / group) * t * D;
  const T* vb = v + (bh / group) * t * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment rows g and g + 8 of each m-tile
  const int tq = lane & 3;
  const int64_t wq0 = q0 + L::kRows * warp;   // the warp's first row
  const int64_t wq_last = wq0 + L::kRows - 1;
  const float scale_log2 = scale * kLog2e;

  // kv tiles that hold an allowed key for some row of this q tile
  int64_t kv_end = t;
  if (causal && q0 + kBq < kv_end) {
    kv_end = q0 + kBq;
  }
  int64_t kv_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) {
    kv_begin = ((q0 - window + 1) / kKv) * kKv;
  }

  copy_tile<kBq, D>(qs, q + bh * sq * D, q0, sq);
  if (kv_begin < kv_end) {
    copy_tile<kKv, D>(ks, kb, kv_begin, t);
    copy_tile<kKv, D>(vs, vb, kv_begin, t);
  }
  cp_async_commit();

  float m[kM][2], l[kM][2];   // running max (log2 units) and this lane's part of the sum
  float acc[kM][D / 8][4];
#pragma unroll
  for (int mi = 0; mi < kM; ++mi) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mi][r] = kNegInf;
      l[mi][r] = 0.0f;
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mi][nd][e] = 0.0f;
      }
    }
  }
  const T* q_warp = qs + L::kRows * warp * L::kLd;

  int stage = 0;
  for (int64_t k0 = kv_begin; k0 < kv_end; k0 += kKv, stage ^= 1) {
    cp_async_wait_all();
    if constexpr (sizeof(T) == 4) {
      if (k0 == kv_begin) {   // the q tile came with the first kv tile
        if constexpr (L::kSplitQ) {
          split_own_chunks<kBq, D>(reinterpret_cast<float*>(qs), reinterpret_cast<float*>(qs_lo));
        } else {
          float* const q_tile[1] = {reinterpret_cast<float*>(qs)};
          quiet_own_chunks<kBq, D>(q_tile);
        }
      }
      float* const kv_tiles[2] = {reinterpret_cast<float*>(ks + stage * L::kStage),
                                  reinterpret_cast<float*>(vs + stage * L::kStage)};
      quiet_own_chunks<kKv, D>(kv_tiles);
    }
    __syncthreads();   // tile k0 visible to all; every warp is done with the other stage
    if (k0 + kKv < kv_end) {
      copy_tile<kKv, D>(ks + (stage ^ 1) * L::kStage, kb, k0 + kKv, t);
      copy_tile<kKv, D>(vs + (stage ^ 1) * L::kStage, vb, k0 + kKv, t);
    }
    cp_async_commit();

    // a tile that misses all rows of this warp leaves m, l and acc as they are
    const int64_t k_last = k0 + kKv - 1;
    if (wq0 >= sq || (causal && k0 > wq_last) || (window > 0 && k_last <= wq0 - window)) {
      continue;
    }
    float s[kM][kNb][4];
    scores<D, T>(s, q_warp, static_cast<int>(qs_lo - qs), ks + stage * L::kStage, lane);
    const bool need_mask = k0 + kKv > t || (causal && k_last > wq0) ||
                           (window > 0 && k0 <= wq_last - window);
#pragma unroll
    for (int mi = 0; mi < kM; ++mi) {
      if (need_mask) {
        online_softmax<true>(s[mi], m[mi], l[mi], acc[mi], scale_log2, k0, wq0 + 16 * mi,
                             lane, t, causal, window);
      } else {
        online_softmax<false>(s[mi], m[mi], l[mi], acc[mi], scale_log2, k0, wq0 + 16 * mi,
                              lane, t, causal, window);
      }
    }
    accumulate<D, T>(acc, s, vs + stage * L::kStage, lane);
  }
  cp_async_wait_all();

#pragma unroll
  for (int mi = 0; mi < kM; ++mi) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[mi][r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int64_t row = wq0 + 16 * mi + g + 8 * r;
      if (row >= sq) {
        continue;
      }
      const float denom = sum < 1e-30f ? 1e-30f : sum;   // max(l, 1e-30), NaN kept
#ifdef FLASH_ATTENTION_LSE
      if (tq == 0) {
        lse[bh * sq + row] = (m[mi][r] + log2f(denom)) * (1.0f / kLog2e);
      }
#endif
      T* orow = o + (bh * sq + row) * D;
      const float(&a)[D / 8][4] = acc[mi];
      if constexpr (sizeof(T) == 4) {   // a[4c + i]: d = 32c + 8tq + i and + 4 (accumulate)
#pragma unroll
        for (int c = 0; c < D / 32; ++c) {
          float* dst = orow + 32 * c + 8 * tq;
          *reinterpret_cast<float4*>(dst) =
              make_float4(a[4 * c][2 * r] / denom, a[4 * c + 1][2 * r] / denom,
                          a[4 * c + 2][2 * r] / denom, a[4 * c + 3][2 * r] / denom);
          *reinterpret_cast<float4*>(dst + 4) =
              make_float4(a[4 * c][2 * r + 1] / denom, a[4 * c + 1][2 * r + 1] / denom,
                          a[4 * c + 2][2 * r + 1] / denom, a[4 * c + 3][2 * r + 1] / denom);
        }
      } else {                          // a[nd]: d = 8nd + 2tq, + 1
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * nd + 2 * tq) =
              __floats2bfloat162_rn(a[nd][2 * r] / denom, a[nd][2 * r + 1] / denom);
        }
      }
    }
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int64_t bhq,
           int64_t group, int64_t sq, int64_t t, int causal, int64_t window,
           float scale LSE_PARAM, cudaStream_t stream) {
  constexpr int kBq = Layout<D, T>::kBq;
  const int64_t blocks = bhq * ((sq + kBq - 1) / kBq);
  if (blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr size_t smem = Layout<D, T>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<D, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  flash_attention_kernel<D, T><<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), bhq, group, sq, t, causal, window, scale LSE_ARG);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns a CUDA error code (0 on success). Does not
// synchronise. window <= 0 means no window.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           int is_bf16, int d, int64_t bhq, int64_t group, int64_t sq,
                           int64_t t, int causal, int64_t window, float scale
                           LSE_C_PARAM, void* stream) {
  if (bhq <= 0 || group <= 0 || bhq % group != 0 || sq <= 0 || t <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) {
    return is_bf16 ? launch<64, __nv_bfloat16>(q, k, v, o, bhq, group, sq, t, causal, window, scale LSE_C_ARG, s)
                   : launch<64, float>(q, k, v, o, bhq, group, sq, t, causal, window, scale LSE_C_ARG, s);
  }
  if (d == 128) {
    return is_bf16 ? launch<128, __nv_bfloat16>(q, k, v, o, bhq, group, sq, t, causal, window, scale LSE_C_ARG, s)
                   : launch<128, float>(q, k, v, o, bhq, group, sq, t, causal, window, scale LSE_C_ARG, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

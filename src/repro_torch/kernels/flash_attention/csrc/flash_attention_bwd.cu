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
// pair) and forms dq, dk and dv (6·d), 10·d flops an allowed pair: at the
// long causal shape (112 q heads, S = T = 2048, d = 64) 150 GFLOP, 0.91 ms
// as 3xTF32 (three passes at 495 TFLOP/s; 2.2 ms at the 67 TFLOP/s of SIMT
// f32); at the training shape (112 q heads, S = 128) the bytes bind (5 us).
// All five products run on the tensor cores with warp-level mma.sync, at the
// forward's precision routes:
//
//   - f32 inputs, 3xTF32: every operand x split into x_hi = rna_tf32(x) and
//     x_lo = rna_tf32(x - x_hi), each product a_lo·b_hi + a_hi·b_lo +
//     a_hi·b_hi in mma.m16n8k8.tf32 (small terms first), f32 accumulation;
//     one TF32 pass would put ~2^-11 of relative error on each product and
//     fail the f32 tolerance (tests/test_torch_flash_bwd_numerics.py);
//   - bf16 inputs: S = QK^T and dP = dO V^T in one mma.m16n8k16.bf16 pass
//     each (a bf16 product is exact in f32); P and dS, which the three
//     accumulating products take as their A operand, split into hi =
//     bf16(x) and lo = bf16(x - hi), two passes each: one bf16 P or dS
//     would put ~2^-9 of relative error on gradients that nearly cancel.
//
// Design, three or four launches, no atomics (two launches are bit-identical):
//   1. flash_bwd_dot: one warp a q row, Dv = rowsum(dO o) in f32, into the
//      scratch;
//   2. flash_bwd_dkdv: a block of 4 warps owns 64 kv rows of one kv head,
//      16 a warp, with dK and dV as m16n8 accumulator fragments in registers.
//      K and V are its A operands, copied once (f32, d = 64: split once into
//      hi and lo in shared memory). It walks 32-row q tiles (Q, dO, lse and
//      Dv through a two-stage cp.async ring) of its q heads; a warp forms
//      S^T and dP^T in registers, then P^T = exp2(S^T·scale·log2 e - lse·
//      log2 e) and dS^T = P^T (dP^T - Dv), and re-packs both in registers
//      as the A operand of dV += P^T dO and dK += dS^T Q, so neither
//      reaches shared memory. The tensor cores accumulate by truncation,
//      so each tile's product goes into a zeroed fragment and is added to
//      dK and dV by an IEEE add: summed inside the mma, dK and dV of the
//      first kv rows (seen by all 7 × 2048 q rows of the long shape)
//      drifted to 1.1e-4 of the largest entry on the H100, against 4.6e-6
//      since. Tiles wholly above the diagonal or outside the window are
//      skipped, by the block and by a warp whose rows they miss; masks
//      only where a tile needs them.
//      Filling the card: with kv_tiles × Hkv blocks below 264 (two an SM),
//      a kv head's G q heads are split over `splits` blocks (the least
//      divisor of G that reaches 264 blocks, else G; chosen by the wrapper
//      from the shape alone). Each then writes f32 partial dK and dV to the
//      scratch, and
//   3. flash_bwd_sum adds the partials in split order, scales dK and writes
//      dk, dv in the input dtype. At splits = 1 (the long shape: 512
//      blocks) dkdv writes dk, dv itself and this launch is skipped;
//   4. flash_bwd_dq: the forward's structure. A block owns 64 q rows of one
//      q head (Q and dO its A operands), walks the 32-row kv tiles they see
//      (K, V through the ring), recomputes S and dP and accumulates dS K in
//      fragments. The grid is one-dimensional, q head folded with the tile
//      index, longest causal rows first.
// The fragment loads (ldmatrix on rows padded by 16 bytes, f32 V-side
// operands by 16-byte loads with d permuted across n-blocks), the TF32 split
// and the two-stage ring are the forward's (flash_attention.cu; the PTX
// helpers both include are flash_mma.cuh).
//
// Shared memory, registers (ptxas: dkdv / dq) and occupancy (128 threads a
// block; the same layout in dkdv and dq; at most 255 registers, two blocks):
//   f32  d = 64:  A tiles 2 × (hi + lo) × 64x68, ring 2 × 2 × 32x68 floats,
//                 lse/Dv 512 B = 104,960 B; 241 / 197: 2 blocks an SM
//   f32  d = 128: A 2 × 64x132 (split at each load), ring 2 × 2 × 32x132
//                 = 135,680 B; 255 (132 B spilled) / 255: 1 block
//   bf16 d = 64:  A 2 × 64x72, ring 2 × 2 × 32x72 bf16 = 37,376 B;
//                 224 / 182: 2 blocks
//   bf16 d = 128: A 2 × 64x136, ring 2 × 2 × 32x136 = 70,144 B; 255 (20 B
//                 spilled) / 236: 2 blocks
// On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md row 5b) the dK/dV pass
// takes 2.41 ms and dq 1.58 of the long shape's ~4.1 (f32), and 22.6 and
// 16.5 us of the training shape's ~60 (with 2.8 for Dv, 3.5 for the sum):
// both recompute S and dP, 7 products where 5 would do without atomics.
//
// NaN and Inf: f32 operands reach the tensor cores through the integer TF32
// split, which wraps CUDA's NaN 0x7fffffff to -0. Each thread rewrites a NaN
// in the chunks of q, k, v and dO it copied as 0x7fffffff's quiet 0x7fc00000
// (which the split keeps a NaN), once a tile, as the forward does, and P and
// dS are made quiet in registers before they are split; so a NaN in an input
// reaches every gradient the plain version's does within the tiles the
// kernel visits (the plain version, summing over all pairs, also spreads a
// NaN to pairs of tiles this kernel skips). An Inf in f32 can give NaN where
// the plain version gives +-Inf (the Inf times the lo part).
//
// q, k, v, o, dO and the gradients are f32 or bf16 (all one dtype, computed
// in f32, written in that dtype); lse and the scratch are f32; d is 64 or
// 128; any Sq and T (ragged tiles masked, zero-filled rows).
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library with a
// plain C interface.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kA = 16 * kWarps;   // rows of the A side a block: kv (dkdv) or q (dq)
constexpr int kB = 32;            // rows of a streamed tile: q (dkdv) or kv (dq)
constexpr int kNb = kB / 8;       // n-blocks of a score tile
constexpr float kLog2e = 1.4426950408889634f;

struct Shape {
  int64_t bhq, group, sq, t, window;
  int causal;
  float scale;
};

template <int D, typename T>
struct Layout {
  static constexpr int kPad = sizeof(T) == 4 ? 4 : 8;   // elements a row: 16 bytes
  static constexpr int kLd = D + kPad;
  // f32 at d = 64: the two A tiles split once into hi (in place) and lo
  static constexpr bool kSplitA = sizeof(T) == 4 && D == 64;
  static constexpr int kATile = kA * kLd;
  static constexpr int kStage = kB * kLd;
  static constexpr size_t kBytes =
      static_cast<size_t>((kSplitA ? 4 : 2) * kATile + 4 * kStage) * sizeof(T) +
      4 * kB * sizeof(float);
};

// 4 bytes global -> shared; src_bytes = 0 writes a zero.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

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

// kB entries [row0, row0 + kB) of an f32 vector (lse or Dv) by 4-byte
// cp.async, zeros past n; threads [lane0, lane0 + kB) copy
__device__ __forceinline__ void copy_vec(float* dst, const float* __restrict__ src,
                                         int64_t row0, int64_t n, int lane0) {
  const int i = static_cast<int>(threadIdx.x) - lane0;
  if (i >= 0 && i < kB) {
    const bool in = row0 + i < n;
    cp_async4(smem_addr(dst + i), src + (in ? row0 + i : 0), in ? 4 : 0);
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
// place (flash_attention.cu's): all chunks loaded first and checked by the
// sums of their |x|, so only a tile holding a NaN, Inf or huge value pays a
// branch.
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

// The A tiles once they have arrived: f32 at d = 64 split into hi and lo,
// f32 at d = 128 made NaN-quiet (split at each load), bf16 as they are
template <int D, typename T>
__device__ __forceinline__ void prepare_a(T* a0, T* a1, T* a0_lo, T* a1_lo) {
  if constexpr (Layout<D, T>::kSplitA) {
    split_own_chunks<kA, D>(reinterpret_cast<float*>(a0), reinterpret_cast<float*>(a0_lo));
    split_own_chunks<kA, D>(reinterpret_cast<float*>(a1), reinterpret_cast<float*>(a1_lo));
  } else if constexpr (sizeof(T) == 4) {
    float* const t0[1] = {reinterpret_cast<float*>(a0)};
    quiet_own_chunks<kA, D>(t0);
    float* const t1[1] = {reinterpret_cast<float*>(a1)};
    quiet_own_chunks<kA, D>(t1);
  }
}

// ------------------------------------------------------------- the products

// S (16 rows x kB cols, m16n8 fragments) = A_warp · B_tile^T over d: A the
// warp's 16 rows (a; a_lo its TF32 lo when split in shared memory), B the
// tile's kB rows. Each B fragment is loaded (and, f32, split) once.
template <int D, typename T>
__device__ __forceinline__ void products_abt(float (&s)[kNb][4], const T* a, const T* a_lo,
                                             const T* b, int lane) {
  constexpr int kLd = Layout<D, T>::kLd;
#pragma unroll
  for (int nb = 0; nb < kNb; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nb][e] = 0.0f;
    }
  }
  // ldmatrix: lane L gives the row address of matrix L / 8, row L % 8
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1);
  if constexpr (sizeof(T) == 4) {
    // a 16-byte matrix row holds 4 floats: lane (g, t) receives word t of row g
    const int a_off = a_row * kLd + 4 * (lane >> 4);
    const uint32_t a_base = smem_addr(a + a_off);
    const uint32_t b_base = smem_addr(b + (lane & 7) * kLd + 4 * (lane >> 3));
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {   // two k-steps of 8
      uint32_t a_hi[2][4], a_lo_f[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if constexpr (Layout<D, T>::kSplitA) {
          ldmatrix_x4(a_hi[h], a_base + (kk + 8 * h) * 4);
          ldmatrix_x4(a_lo_f[h], smem_addr(a_lo + a_off) + (kk + 8 * h) * 4);
        } else {
          uint32_t x[4];
          ldmatrix_x4(x, a_base + (kk + 8 * h) * 4);
          split_tf32(x, a_hi[h], a_lo_f[h]);
        }
      }
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb) {
        uint32_t kb[4], b_hi[4], b_lo[4];   // b0, b1 of k-step kk; b0, b1 of kk + 8
        ldmatrix_x4(kb, b_base + (nb * 8 * kLd + kk) * 4);
        split_tf32(kb, b_hi, b_lo);
        mma_3xtf32(s[nb], a_hi[0], a_lo_f[0], b_hi[0], b_hi[1], b_lo[0], b_lo[1]);
        mma_3xtf32(s[nb], a_hi[1], a_lo_f[1], b_hi[2], b_hi[3], b_lo[2], b_lo[3]);
      }
    }
  } else {
    const uint32_t a_base = smem_addr(a + a_row * kLd + 8 * (lane >> 4));
    const uint32_t b_base = smem_addr(b + (lane & 7) * kLd + 8 * (lane >> 3));
#pragma unroll
    for (int kk = 0; kk < D; kk += 32) {   // two k-steps of 16
      uint32_t aa[2][4];
      ldmatrix_x4(aa[0], a_base + kk * 2);
      ldmatrix_x4(aa[1], a_base + (kk + 16) * 2);
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb) {
        uint32_t kb[4];   // b0, b1 of k-step kk; b0, b1 of kk + 16
        ldmatrix_x4(kb, b_base + (nb * 8 * kLd + kk) * 2);
        mma_bf16(s[nb], aa[0], kb[0], kb[1]);
        mma_bf16(s[nb], aa[1], kb[2], kb[3]);
      }
    }
  }
}

// acc (16 rows x D, m16n8 fragments) += X · B_tile, X (16 x kB) in the
// score fragments (P or dS, transposed or not), B_tile's kB rows the k
// dimension (flash_attention.cu's accumulate with one m-tile). The tile's
// product is summed by the tensor cores into a zeroed fragment and added to
// acc by one IEEE add: an mma accumulates by truncation, and dK and dV sum
// up to G·Sq terms (7 × 2048 at the long shape), which summed inside the
// mma drifted to 1.1e-4 of the largest entry on the card. f32: X made
// NaN-quiet and split in registers (again for each 32 columns of d, which
// keeps the registers of one split live), the accumulator's d order
// permuted (n-block 4c + i holds d = 32c + 8t + i and + 4). bf16: X split
// into two bf16 passes.
template <int D, typename T>
__device__ __forceinline__ void products_xb(float (&acc)[D / 8][4], const float (&x)[kNb][4],
                                            const T* b, int lane) {
  constexpr int kLd = Layout<D, T>::kLd;
  if constexpr (sizeof(T) == 4) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int c = 0; c < D / 32; ++c) {
      float part[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          part[i][e] = 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < kNb; ++j) {
        const uint32_t xa[4] = {
            __float_as_uint(quiet_nan(x[j][0])), __float_as_uint(quiet_nan(x[j][2])),
            __float_as_uint(quiet_nan(x[j][1])), __float_as_uint(quiet_nan(x[j][3]))};
        uint32_t x_hi[4], x_lo[4];
        split_tf32(xa, x_hi, x_lo);
        const float* v0 = b + (8 * j + 2 * t) * kLd + 4 * g + 32 * c;   // b0: row 2t
        uint32_t x0[4], x1[4], h0[4], h1[4], l0[4], l1[4];
        load16(x0, v0);
        load16(x1, v0 + kLd);                                            // b1: row 2t + 1
        split_tf32(x0, h0, l0);
        split_tf32(x1, h1, l1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma_3xtf32(part[i], x_hi, x_lo, h0[i], h1[i], l0[i], l1[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[4 * c + i][e] += part[i][e];
        }
      }
    }
  } else {
    // k-step j covers rows 16j..16j+15: the fragments of n-blocks 2j, 2j + 1
    uint32_t x_hi[kNb / 2][4], x_lo[kNb / 2][4];
#pragma unroll
    for (int j = 0; j < kNb / 2; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {   // a0/a1 from block 2j, a2/a3 from 2j + 1
          const float x0 = x[2 * j + h][2 * r], x1 = x[2 * j + h][2 * r + 1];
          const uint32_t hi = pack_bf16(x0, x1);
          x_hi[j][2 * h + r] = hi;
          x_lo[j][2 * h + r] = pack_bf16(x0 - bf16_low(hi), x1 - bf16_high(hi));
        }
      }
    }
    const uint32_t v_base = smem_addr(b + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kLd +
                                      8 * (lane >> 4));
#pragma unroll
    for (int nd = 0; nd < D / 8; nd += 2) {
      float part[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int j = 0; j < kNb / 2; ++j) {
        uint32_t vb[4];   // b0, b1 of columns 8nd..; b0, b1 of 8(nd + 1)..
        ldmatrix_x4_trans(vb, v_base + (16 * j * kLd + 8 * nd) * 2);
        mma_bf16(part[0], x_lo[j], vb[0], vb[1]);
        mma_bf16(part[0], x_hi[j], vb[0], vb[1]);
        mma_bf16(part[1], x_lo[j], vb[2], vb[3]);
        mma_bf16(part[1], x_hi[j], vb[2], vb[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[nd][e] += part[0][e];
        acc[nd + 1][e] += part[1][e];
      }
    }
  }
}

__device__ __forceinline__ bool allowed(int64_t i, int64_t j, const Shape& s) {
  return i < s.sq && j < s.t && (!s.causal || j <= i) && (s.window <= 0 || j > i - s.window);
}

// P and dS in place of S and dP, fragment element (nb, e) at row g + 8(e/2)
// and column 8nb + 2t + e%2 of the tile. kT: rows are kv and columns q (the
// dkdv pass; lse and Dv by column from shared memory), else rows are q and
// columns kv (the dq pass; lse and Dv by row, in registers).
template <bool kT, bool kMask>
__device__ __forceinline__ void grad_probs(float (&s)[kNb][4], float (&dp)[kNb][4],
                                           const float* lse_col, const float* dv_col,
                                           const float (&nl2_row)[2], const float (&dv_row)[2],
                                           float scale_log2, int64_t row0, int64_t col0,
                                           int lane, const Shape& sh) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nb = 0; nb < kNb; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e >> 1), c = 8 * nb + 2 * tq + (e & 1);
      float nl2, dvi;
      if constexpr (kT) {
        nl2 = -lse_col[c] * kLog2e;
        dvi = dv_col[c];
      } else {
        nl2 = nl2_row[e >> 1];
        dvi = dv_row[e >> 1];
      }
      float p = exp2_approx(fmaf(s[nb][e], scale_log2, nl2));
      if constexpr (kMask) {
        const bool ok = kT ? allowed(col0 + c, row0 + r, sh) : allowed(row0 + r, col0 + c, sh);
        p = ok ? p : 0.0f;
      }
      s[nb][e] = p;
      dp[nb][e] = p * (dp[nb][e] - dvi);
    }
  }
}

// Stores a warp's 16 accumulator rows, times mul, as rows row0 + g (+ 8) of
// the [rows, D] matrix out, skipping rows at or past `rows`. T is the
// route (its accumulator layout), O the stored type.
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <int D, typename T, typename O>
__device__ __forceinline__ void store_rows(O* out, const float (&a)[D / 8][4], int64_t row0,
                                           int64_t rows, float mul, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t row = row0 + g + 8 * r;
    if (row >= rows) {
      continue;
    }
    O* orow = out + row * D;
    if constexpr (sizeof(T) == 4) {   // a[4c + i]: d = 32c + 8tq + i and + 4
#pragma unroll
      for (int c = 0; c < D / 32; ++c) {
        store4(orow + 32 * c + 8 * tq, a[4 * c][2 * r] * mul, a[4 * c + 1][2 * r] * mul,
               a[4 * c + 2][2 * r] * mul, a[4 * c + 3][2 * r] * mul);
        store4(orow + 32 * c + 8 * tq + 4, a[4 * c][2 * r + 1] * mul,
               a[4 * c + 1][2 * r + 1] * mul, a[4 * c + 2][2 * r + 1] * mul,
               a[4 * c + 3][2 * r + 1] * mul);
      }
    } else {                          // a[nd]: d = 8nd + 2tq, + 1
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        store2(orow + 8 * nd + 2 * tq, a[nd][2 * r] * mul, a[nd][2 * r + 1] * mul);
      }
    }
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&a)[D / 8][4]) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      a[i][e] = 0.0f;
    }
  }
}

// ------------------------------------------------------------------ the kernels

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int D, typename T>
__global__ void __launch_bounds__(256) flash_bwd_dot(const T* __restrict__ o,
                                                    const T* __restrict__ dout,
                                                    float* __restrict__ dv_out, int64_t rows) {
  const int64_t row = int64_t(blockIdx.x) * 8 + (threadIdx.x >> 5);
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
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dkdv(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dvec,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ part, const Shape s,
    int splits) {
  using L = Layout<D, T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ka = reinterpret_cast<T*>(smem);
  T* va = ka + L::kATile;
  T* ka_lo = va + L::kATile;                          // kSplitA only
  T* va_lo = ka_lo + L::kATile;
  T* ring = ka + (L::kSplitA ? 4 : 2) * L::kATile;    // stage s: Q at 2s, dO at 2s + 1
  float* vec = reinterpret_cast<float*>(ring + 4 * L::kStage);   // stage s: lse, Dv

  const int64_t bhkv = s.bhq / s.group;
  const int64_t per_tile = bhkv * splits;
  const int64_t rank = blockIdx.x;
  const int64_t k0 = (rank / per_tile) * kA;            // kv tile 0 (most q rows) first
  const int64_t hkv = (rank % per_tile) / splits;
  const int split = static_cast<int>(rank % splits);
  const int64_t heads = s.group / splits;               // q heads of this block
  const int64_t bh0 = hkv * s.group + split * heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t kw0 = k0 + 16 * warp;                   // the warp's first kv row
  const float scale_log2 = s.scale * kLog2e;

  // the q rows that see a key of this kv tile
  const int64_t q_begin = s.causal ? k0 : 0;
  int64_t q_end = s.sq;
  if (s.window > 0 && k0 + kA - 1 + s.window < q_end) {
    q_end = k0 + kA - 1 + s.window;
  }
  const int64_t n_q = q_begin < q_end ? (q_end - q_begin + kB - 1) / kB : 0;
  const int64_t n_tiles = heads * n_q;

  auto issue = [&](int64_t i, int stage) {   // q tile i of the block into a stage
    const int64_t bh = bh0 + i / n_q;
    const int64_t q0 = q_begin + (i % n_q) * kB;
    copy_tile<kB, D>(ring + 2 * stage * L::kStage, q + bh * s.sq * D, q0, s.sq);
    copy_tile<kB, D>(ring + (2 * stage + 1) * L::kStage, dout + bh * s.sq * D, q0, s.sq);
    copy_vec(vec + 2 * stage * kB, lse + bh * s.sq, q0, s.sq, 0);
    copy_vec(vec + (2 * stage + 1) * kB, dvec + bh * s.sq, q0, s.sq, kB);
  };
  copy_tile<kA, D>(ka, k + hkv * s.t * D, k0, s.t);
  copy_tile<kA, D>(va, v + hkv * s.t * D, k0, s.t);
  if (n_tiles > 0) {
    issue(0, 0);
  }
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero<D>(dk_acc);
  zero<D>(dv_acc);
  const T* ka_w = ka + 16 * warp * L::kLd;
  const T* va_w = va + 16 * warp * L::kLd;
  const T* ka_lo_w = ka_lo + 16 * warp * L::kLd;
  const T* va_lo_w = va_lo + 16 * warp * L::kLd;
  const float no_rows[2] = {0.0f, 0.0f};

  for (int64_t i = 0; i < n_tiles; ++i) {
    const int stage = static_cast<int>(i & 1);
    T* qb = ring + 2 * stage * L::kStage;
    T* dob = qb + L::kStage;
    cp_async_wait_all();
    if (i == 0) {
      prepare_a<D, T>(ka, va, ka_lo, va_lo);
    }
    if constexpr (sizeof(T) == 4) {
      float* const tiles[2] = {reinterpret_cast<float*>(qb), reinterpret_cast<float*>(dob)};
      quiet_own_chunks<kB, D>(tiles);
    }
    __syncthreads();   // tile i visible to all; every warp is done with the other stage
    if (i + 1 < n_tiles) {
      issue(i + 1, stage ^ 1);
    }
    cp_async_commit();

    const int64_t q0 = q_begin + (i % n_q) * kB;
    const int64_t q_last = q0 + kB - 1;
    // a tile that misses all kv rows of this warp adds nothing
    if (kw0 >= s.t || (s.causal && q_last < kw0) ||
        (s.window > 0 && q0 >= kw0 + 15 + s.window)) {
      continue;
    }
    const bool need_mask = q0 + kB > s.sq || kw0 + 16 > s.t || (s.causal && q0 < kw0 + 15) ||
                           (s.window > 0 && q_last >= kw0 + s.window);
    float st[kNb][4], dpt[kNb][4];
    products_abt<D, T>(st, ka_w, ka_lo_w, qb, lane);
    products_abt<D, T>(dpt, va_w, va_lo_w, dob, lane);
    const float* lse_s = vec + 2 * stage * kB;
    if (need_mask) {
      grad_probs<true, true>(st, dpt, lse_s, lse_s + kB, no_rows, no_rows, scale_log2, kw0,
                             q0, lane, s);
    } else {
      grad_probs<true, false>(st, dpt, lse_s, lse_s + kB, no_rows, no_rows, scale_log2, kw0,
                              q0, lane, s);
    }
    products_xb<D, T>(dv_acc, st, dob, lane);    // dV += P^T dO
    products_xb<D, T>(dk_acc, dpt, qb, lane);    // dK += dS^T Q
  }
  cp_async_wait_all();

  if (splits == 1) {
    store_rows<D, T>(dk + hkv * s.t * D, dk_acc, kw0, s.t, s.scale, lane);
    store_rows<D, T>(dv + hkv * s.t * D, dv_acc, kw0, s.t, 1.0f, lane);
  } else {   // partials [2][splits][bhkv][t][D], dK unscaled
    const int64_t plane = bhkv * s.t * D;
    float* pk = part + split * plane + hkv * s.t * D;
    store_rows<D, T>(pk, dk_acc, kw0, s.t, 1.0f, lane);
    store_rows<D, T>(pk + splits * plane, dv_acc, kw0, s.t, 1.0f, lane);
  }
}

// dk = scale · sum of the split partials, dv = their sum, splits in order
__device__ __forceinline__ void store_vec4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store_vec4(__nv_bfloat16* p, float4 x) {
  store2(p, x.x, x.y);
  store2(p + 2, x.z, x.w);
}

template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_sum(const float* __restrict__ part,
                                                    T* __restrict__ dk, T* __restrict__ dv,
                                                    int64_t plane, int splits, float scale) {
  const int64_t i = (int64_t(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (i >= plane) {
    return;
  }
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const float* p = part + w * splits * plane + i;
    float4 acc = *reinterpret_cast<const float4*>(p);
    for (int sp = 1; sp < splits; ++sp) {
      const float4 x = *reinterpret_cast<const float4*>(p + sp * plane);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const float mul = w == 0 ? scale : 1.0f;
    store_vec4((w == 0 ? dk : dv) + i,
               make_float4(acc.x * mul, acc.y * mul, acc.z * mul, acc.w * mul));
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dq(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dvec,
    T* __restrict__ dq, const Shape s) {
  using L = Layout<D, T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qa = reinterpret_cast<T*>(smem);
  T* doa = qa + L::kATile;
  T* qa_lo = doa + L::kATile;                         // kSplitA only
  T* doa_lo = qa_lo + L::kATile;
  T* ring = qa + (L::kSplitA ? 4 : 2) * L::kATile;    // stage s: K at 2s, V at 2s + 1

  const int64_t num_q_tiles = (s.sq + kA - 1) / kA;
  const int64_t rank = blockIdx.x;
  const int64_t bh = rank % s.bhq;
  const int64_t q0 = (num_q_tiles - 1 - rank / s.bhq) * kA;   // longest rows first
  const int64_t hkv = bh / s.group;
  const T* kb = k + hkv * s.t * D;
  const T* vb = v + hkv * s.t * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int64_t wq0 = q0 + 16 * warp;   // the warp's first q row
  const int64_t wq_last = wq0 + 15;
  const float scale_log2 = s.scale * kLog2e;

  // kv tiles that hold an allowed key for some row of this q tile
  int64_t kv_end = s.t;
  if (s.causal && q0 + kA < kv_end) {
    kv_end = q0 + kA;
  }
  int64_t kv_begin = 0;
  if (s.window > 0 && q0 - s.window + 1 > 0) {
    kv_begin = ((q0 - s.window + 1) / kB) * kB;
  }

  copy_tile<kA, D>(qa, q + bh * s.sq * D, q0, s.sq);
  copy_tile<kA, D>(doa, dout + bh * s.sq * D, q0, s.sq);
  if (kv_begin < kv_end) {
    copy_tile<kB, D>(ring, kb, kv_begin, s.t);
    copy_tile<kB, D>(ring + L::kStage, vb, kv_begin, s.t);
  }
  cp_async_commit();
  // -lse·log2(e) and Dv of the lane's rows g, g + 8
  float nl2[2], dvr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t row = wq0 + g + 8 * r;
    nl2[r] = row < s.sq ? -lse[bh * s.sq + row] * kLog2e : 0.0f;
    dvr[r] = row < s.sq ? dvec[bh * s.sq + row] : 0.0f;
  }

  float dq_acc[D / 8][4];
  zero<D>(dq_acc);
  const T* qa_w = qa + 16 * warp * L::kLd;
  const T* doa_w = doa + 16 * warp * L::kLd;
  const T* qa_lo_w = qa_lo + 16 * warp * L::kLd;
  const T* doa_lo_w = doa_lo + 16 * warp * L::kLd;

  int stage = 0;
  for (int64_t k0 = kv_begin; k0 < kv_end; k0 += kB, stage ^= 1) {
    T* kt = ring + 2 * stage * L::kStage;
    T* vt = kt + L::kStage;
    cp_async_wait_all();
    if (k0 == kv_begin) {
      prepare_a<D, T>(qa, doa, qa_lo, doa_lo);
    }
    if constexpr (sizeof(T) == 4) {
      float* const tiles[2] = {reinterpret_cast<float*>(kt), reinterpret_cast<float*>(vt)};
      quiet_own_chunks<kB, D>(tiles);
    }
    __syncthreads();   // tile k0 visible to all; every warp is done with the other stage
    if (k0 + kB < kv_end) {
      copy_tile<kB, D>(ring + 2 * (stage ^ 1) * L::kStage, kb, k0 + kB, s.t);
      copy_tile<kB, D>(ring + (2 * (stage ^ 1) + 1) * L::kStage, vb, k0 + kB, s.t);
    }
    cp_async_commit();

    // a tile that misses all rows of this warp adds nothing
    const int64_t k_last = k0 + kB - 1;
    if (wq0 >= s.sq || (s.causal && k0 > wq_last) ||
        (s.window > 0 && k_last <= wq0 - s.window)) {
      continue;
    }
    const bool need_mask = k0 + kB > s.t || wq0 + 16 > s.sq || (s.causal && k_last > wq0) ||
                           (s.window > 0 && k0 <= wq_last - s.window);
    float sc[kNb][4], dp[kNb][4];
    products_abt<D, T>(sc, qa_w, qa_lo_w, kt, lane);
    products_abt<D, T>(dp, doa_w, doa_lo_w, vt, lane);
    if (need_mask) {
      grad_probs<false, true>(sc, dp, nullptr, nullptr, nl2, dvr, scale_log2, wq0, k0, lane, s);
    } else {
      grad_probs<false, false>(sc, dp, nullptr, nullptr, nl2, dvr, scale_log2, wq0, k0, lane,
                               s);
    }
    products_xb<D, T>(dq_acc, dp, kt, lane);   // dQ += dS K
  }
  cp_async_wait_all();
  store_rows<D, T>(dq + bh * s.sq * D, dq_acc, wq0, s.sq, s.scale, lane);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, void* dq, void* dk, void* dv,
                   float* scratch, const Shape s, int splits, cudaStream_t stream) {
  const int64_t bhkv = s.bhq / s.group;
  const int64_t rows = s.bhq * s.sq;
  const int64_t dot_blocks = (rows + 7) / 8;
  const int64_t q_blocks = s.bhq * ((s.sq + kA - 1) / kA);
  const int64_t kv_blocks = bhkv * ((s.t + kA - 1) / kA) * splits;
  const int64_t plane = bhkv * s.t * D;
  const int64_t sum_blocks = (plane / 4 + 255) / 256;
  if (dot_blocks > 2147483647LL || q_blocks > 2147483647LL || kv_blocks > 2147483647LL ||
      sum_blocks > 2147483647LL) {
    return cudaErrorInvalidValue;
  }
  float* dvec = scratch;
  float* part = scratch + ((rows + 3) & ~int64_t(3));   // 16-byte aligned
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  flash_bwd_dot<D, T><<<static_cast<unsigned>(dot_blocks), 256, 0, stream>>>(
      static_cast<const T*>(o), dot, dvec, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t smem = Layout<D, T>::kBytes;
  err = set_smem(flash_bwd_dkdv<D, T>, smem);
  if (err != cudaSuccess) return err;
  err = set_smem(flash_bwd_dq<D, T>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv<D, T><<<static_cast<unsigned>(kv_blocks), kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, dvec, static_cast<T*>(dk), static_cast<T*>(dv), part, s, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    flash_bwd_sum<T><<<static_cast<unsigned>(sum_blocks), 256, 0, stream>>>(
        part, static_cast<T*>(dk), static_cast<T*>(dv), plane, splits, s.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  flash_bwd_dq<D, T><<<static_cast<unsigned>(q_blocks), kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, dvec, static_cast<T*>(dq), s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns a CUDA error code (0 on success). Does not
// synchronise. q, o, dout, dq are [bhq, sq, d]; k, v, dk, dv [bhq / group,
// t, d]; lse [bhq, sq] f32. splits (>= 1, dividing group): blocks a kv
// head's q heads are split over; scratch holds round_up(bhq * sq, 4) f32,
// and 2 * splits * (bhq / group) * t * d f32 more when splits > 1. window
// <= 0 means no window.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const void* lse, void* dq, void* dk, void* dv,
                               void* scratch, int is_bf16, int d, int64_t bhq, int64_t group,
                               int64_t sq, int64_t t, int causal, int64_t window, float scale,
                               int splits, void* stream) {
  if (bhq <= 0 || group <= 0 || bhq % group != 0 || sq <= 0 || t <= 0 || splits < 1 ||
      group % splits != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape s{bhq, group, sq, t, window, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(scratch);
  cudaError_t err;
  if (d == 64) {
    err = is_bf16 ? launch<64, __nv_bfloat16>(q, k, v, o, dout, l, dq, dk, dv, sc, s, splits, st)
                  : launch<64, float>(q, k, v, o, dout, l, dq, dk, dv, sc, s, splits, st);
  } else if (d == 128) {
    err = is_bf16 ? launch<128, __nv_bfloat16>(q, k, v, o, dout, l, dq, dk, dv, sc, s, splits, st)
                  : launch<128, float>(q, k, v, o, dout, l, dq, dk, dv, sc, s, splits, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

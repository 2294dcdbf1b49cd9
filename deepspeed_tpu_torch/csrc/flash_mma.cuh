// Shared pieces of the tensor-core flash-attention kernels (the bf16 and
// f16 B1, B2, B3 and B4): 16-bit tiles staged in shared memory by
// cp.async, ldmatrix loads of mma.sync m16n8k16 operand fragments from
// them, the bf16 x bf16 (or f16 x f16) -> f32 product, the
// accumulator-to-operand repack that lets p and ds feed the next product
// from registers, and the masked softmax-gradient step on accumulator
// fragments.  Tiles and pointers are typed `bf16` as 16-bit storage;
// the element type E of `mma`, `pack`, `c_to_a` and `store_acc` (bf16 by
// default, or __half) picks the arithmetic.  ldmatrix and cp.async move
// bits, so an f16 kernel runs the same loads as a bf16 one.
//
// Fragments of mma.sync.m16n8k16 (bf16 in, f32 accumulate), for lane l of
// a warp with g = l / 4 and t = l % 4:
//   A (16 x 16, row major), 4 registers of two bf16 each:
//     a[0] = A[g][2t, 2t+1]      a[1] = A[g+8][2t, 2t+1]
//     a[2] = A[g][2t+8, 2t+9]    a[3] = A[g+8][2t+8, 2t+9]
//   B (16 x 8, k by n), 2 registers:
//     b[0] = B[2t, 2t+1][g]      b[1] = B[2t+8, 2t+9][g]
//   C (16 x 8, f32), 4 floats:
//     c[0], c[1] = C[g][2t, 2t+1]    c[2], c[3] = C[g+8][2t, 2t+1]
// so two neighbouring C tiles (columns 0-7 and 8-15) hold exactly the
// elements of one A fragment over those 16 columns (`c_to_a`).
//
// Shared-memory tiles are [64 rows][D] bf16 with each row padded by 16
// bytes (row stride D + 8 elements).  ldmatrix reads one 16-byte chunk
// from each of 8 rows at the same column; with the padding, row r of the
// eight starts at word 4 r (mod 32) of a bank line for D = 64 and 128
// (stride 36 / 68 words), and at words {0, 12, 24, 4, 16, 28, 8, 20} /
// {0, 20, 8, 28, 16, 4, 24, 12} for D = 16 / 32 (stride 12 / 20 words):
// eight distinct 4-word groups, so every ldmatrix phase is free of bank
// conflicts at those head dims; every other multiple of 16 up to 256
// gives eight distinct groups too (D = 80: stride 44 words, D = 96: 52),
// since a stride of (D + 8) / 2 = 4 (2 (D / 16) + 1) words is 4 x an odd
// number.  Rows stay 16-byte aligned for cp.async and ldmatrix.
#pragma once

#include "attention_common.cuh"

#include <cuda_fp16.h>

#include <type_traits>

namespace dstt {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;             // rows of every q and kv tile
constexpr int kWarps = 4;             // each warp owns 16 rows of a tile
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

template <int D> struct Tile {
  static constexpr int kStride = D + 8;            // bf16 elements a row
  static constexpr int kElems = kTile * kStride;   // elements a tile
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte cp.async, zero-filled (nothing read) when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4-byte cp.async, zero-filled (nothing read) when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows row0 .. row0 + 63 of a [t_len, D] bf16 matrix into a padded
// tile.  Rows at or past t_len are never read: they are zero-filled (the
// source address is clamped to row 0, which is never dereferenced).
template <int D>
__device__ __forceinline__ void load_tile_async(const bf16* __restrict__ src,
                                                int row0, int t_len,
                                                bf16* dst) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    const int row = row0 + r;
    const bool ok = row < t_len;
    cp_async16(dst + r * Tile<D>::kStride + c,
               src + static_cast<size_t>(ok ? row : 0) * D + c, ok);
  }
}

// Stage lse and delta of rows row0 .. row0 + 63 (each [t_len] float32,
// for one head row) into lse_s / delta_s ([64] each); zeros past t_len.
// A row's statistics start at any 4-byte offset, so they move by 4-byte
// copies: one a thread (kThreads = 2 x 64).
__device__ __forceinline__ void load_stats_async(
    const float* __restrict__ lse, const float* __restrict__ delta, int row0,
    int t_len, float* lse_s, float* delta_s) {
  static_assert(kThreads == 2 * kTile, "one statistic a thread");
  const int i = threadIdx.x % kTile, row = row0 + i;
  const bool ok = row < t_len;
  const float* src = threadIdx.x < kTile ? lse : delta;
  float* dst = threadIdx.x < kTile ? lse_s : delta_s;
  cp_async4(dst + i, src + (ok ? row : 0), ok);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// A fragment of rows m0 .. m0 + 15 and columns k0 .. k0 + 15 of a tile.
// Lanes 0-15 address rows m0 + l at column k0, lanes 16-31 the same rows
// at k0 + 8: matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15),
// (8-15, 8-15) are a[0..3].
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int m0, int k0) {
  const int l = threadIdx.x & 31;
  ldmatrix_x4(a, tile + (m0 + (l & 15)) * Tile<D>::kStride + k0 +
                     (l >> 4) * 8);
}

// B fragments of two n8 tiles (n0 .. n0 + 7 in b[0..1], n0 + 8 .. n0 + 15
// in b[2..3]) at depth k0 .. k0 + 15, from a tile stored [n][k] (B = the
// tile's transpose: S = Q K^T reads K so).  Matrices (n 0-7, k 0-7),
// (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15).
template <int D>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* tile,
                                          int n0, int k0) {
  const int l = threadIdx.x & 31;
  ldmatrix_x4(b, tile + (n0 + (l & 7) + ((l >> 4) << 3)) * Tile<D>::kStride +
                     k0 + ((l >> 3) & 1) * 8);
}

// B fragments of two n8 tiles as load_b_nk, from a tile stored [k][n]
// (dQ = dS K reads K so): ldmatrix.trans of matrices (k 0-7, n 0-7),
// (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15).
template <int D>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* tile,
                                          int k0, int n0) {
  const int l = threadIdx.x & 31;
  ldmatrix_x4_trans(b, tile + (k0 + (l & 7) + ((l >> 3) & 1) * 8) *
                                  Tile<D>::kStride +
                           n0 + (l >> 4) * 8);
}

// c += a b  (m16 n8 k16, bf16 operands, f32 accumulator)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b  (m16 n8 k16, f16 operands, f32 accumulator)
__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[j] += a . (two n8 tiles of b): the pair a load_b_* call gives, with
// operands of type E (bf16 or __half)
template <typename E = bf16>
__device__ __forceinline__ void mma_pair(float (&c0)[4], float (&c1)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[4]) {
  if constexpr (std::is_same<E, __half>::value) {
    mma_f16(c0, a, b[0], b[1]);
    mma_f16(c1, a, b[2], b[3]);
  } else {
    mma_bf16(c0, a, b[0], b[1]);
    mma_bf16(c1, a, b[2], b[3]);
  }
}

// Two f32 values rounded to bf16 (round to nearest even) in one register,
// the first in the low half (the lower column of a fragment pair).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The same rounded to E (bf16 or __half, round to nearest even).
template <typename E = bf16>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  if constexpr (std::is_same<E, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    return pack_bf16(lo, hi);
  }
}

// The A fragment (16 rows x 16 columns, rounded to E) held by two
// neighbouring C tiles c0 (columns 0-7) and c1 (columns 8-15).
template <typename E = bf16>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack<E>(c0[0], c0[1]);
  a[1] = pack<E>(c0[2], c0[3]);
  a[2] = pack<E>(c1[0], c1[1]);
  a[3] = pack<E>(c1[2], c1[3]);
}

// Rows of an m16 fragment held by this lane: element i of a C tile sits
// at row g + 8 (i / 2) and column 2t + i % 2 of the tile's 8 columns.
__device__ __forceinline__ int frag_row(int i) {
  return ((threadIdx.x & 31) >> 2) + 8 * (i >> 1);
}
__device__ __forceinline__ int frag_col(int i) {
  return 2 * (threadIdx.x & 3) + (i & 1);
}

// The softmax-gradient step on one element of the score fragments:
// s (= q . k) becomes p = exp(s * sm_scale - lse) and dp (= dO . v)
// becomes ds = p * (dp - delta) * sm_scale; a pair outside the sequence
// or above the causal diagonal (`keep` false) gets p = ds = 0.  lse2 is
// lse * log2(e), scale2 sm_scale * log2(e).
__device__ __forceinline__ void softmax_grad(float& s, float& dp, float lse2,
                                             float delta, float scale2,
                                             float sm_scale, bool keep) {
  const float p = keep ? exp2f(fmaf(s, scale2, -lse2)) : 0.f;
  dp = p * (dp - delta) * sm_scale;
  s = p;
}

// Store one m16 x D accumulator (D / 8 C tiles) as E rows row0 + r of a
// [t_len, D] matrix, rows at or past t_len left out.
template <int D, typename E = bf16>
__device__ __forceinline__ void store_acc(bf16* __restrict__ dst, int row0,
                                          int t_len,
                                          const float (&acc)[D / 8][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + frag_row(2 * h);
    if (row >= t_len) continue;
    bf16* out = dst + static_cast<size_t>(row) * D + frag_col(0);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack<E>(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

// Operand fragments of a warp's 16 rows of a [64][D] tile over the whole
// head dim: held in registers when kCache (loaded once by `fill`), else
// read from the tile at each use (D = 128, where 2 x D / 4 more registers
// a thread would spill).
template <int D, bool kCache> struct RowFrags;

template <int D> struct RowFrags<D, true> {
  uint32_t a[D / 16][4];
  __device__ __forceinline__ void fill(const bf16* tile, int m0) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) load_a<D>(a[kk], tile, m0, 16 * kk);
  }
  __device__ __forceinline__ void get(uint32_t (&out)[4], const bf16*, int,
                                      int kk) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = a[kk][i];
  }
};

template <int D> struct RowFrags<D, false> {
  __device__ __forceinline__ void fill(const bf16*, int) {}
  __device__ __forceinline__ void get(uint32_t (&out)[4], const bf16* tile,
                                      int m0, int kk) const {
    load_a<D>(out, tile, m0, 16 * kk);
  }
};

}  // namespace mma
}  // namespace dstt

// Shared pieces of the flash-attention kernels B1 (forward), B2 (fused
// backward), B3 (dq pass) and B4 (dk/dv pass): 64-row tiles staged in
// shared memory as f32, the three tile products they need, computed on
// the CUDA cores in f32, and the backward's probabilities and score
// gradients of one tile pair.
//
// Grouped-query attention: q, o, dO, dq, lse and delta are [B.H, T, ...]
// and k, v, dk, dv [B.KVH, T, D] with H = g.KVH; query head b reads kv
// head b / g (the JAX kernels' k/v index map `b // g`), so k/v are never
// repeated through memory.
//
// Thread layout (256 threads, tx = tid % 16, ty = tid / 16): a thread
// owns rows ty + 16 * a (a < 4) and columns tx + 16 * b of every 64-row
// output tile, so the 16 threads that share a row sit in one half-warp
// and row reductions are four xor-shuffles.  Tiles are stored with an
// odd row stride (D + 1, 65) so the 16 rows one half-warp reads at the
// same column fall in 16 distinct banks.
#pragma once

#include "attention_common.cuh"

namespace dstt {
namespace flash {

constexpr int kTile = 64;      // rows of every q and kv tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRowsPT = 4;     // rows per thread: ty + 16 * a
constexpr int kPStride = kTile + 1;

template <int D> struct Dims {
  static constexpr int kStride = D + 1;  // f32 row stride of a [64, D] tile
  static constexpr int kColsPT = D / 16; // output columns per thread
};

// Rounds x to T and back (bf16: the value a bf16 operand would carry).
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Stage rows row0 .. row0 + 63 of a [T, D] matrix into dst ([64][D + 1]
// f32).  Rows at or past t_len are never read: they hold zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int row0,
                                          int t_len, float* dst) {
  constexpr int N = VecWidth<T>::N;
  constexpr int kVecPerRow = D / N;
  for (int idx = threadIdx.x; idx < kTile * kVecPerRow; idx += kThreads) {
    const int r = idx / kVecPerRow, c = (idx % kVecPerRow) * N;
    const int row = row0 + r;
    float f[N];
    if (row < t_len) {
      load_vec(src + static_cast<size_t>(row) * D + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) dst[r * Dims<D>::kStride + c + e] = f[e];
  }
}

// out[a][b] = sum_k A[ty + 16a][k] * B[tx + 16b][k]   (A Bt: 64 x 64, depth D)
template <int D>
__device__ __forceinline__ void mm_abt(const float* __restrict__ A,
                                       const float* __restrict__ B, int tx,
                                       int ty, float (&out)[kRowsPT][4]) {
  constexpr int S = Dims<D>::kStride;
#pragma unroll
  for (int a = 0; a < kRowsPT; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) out[a][b] = 0.f;
#pragma unroll 8
  for (int k = 0; k < D; ++k) {
    float av[kRowsPT], bv[4];
#pragma unroll
    for (int a = 0; a < kRowsPT; ++a) av[a] = A[(ty + 16 * a) * S + k];
#pragma unroll
    for (int b = 0; b < 4; ++b) bv[b] = B[(tx + 16 * b) * S + k];
#pragma unroll
    for (int a = 0; a < kRowsPT; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) out[a][b] = fmaf(av[a], bv[b], out[a][b]);
  }
}

// acc[a][b] += sum_j P[ty + 16a][j] * B[j][tx + 16b]   (P B: 64 x D, depth 64)
template <int D>
__device__ __forceinline__ void mm_pb(const float* __restrict__ P,
                                      const float* __restrict__ B, int tx,
                                      int ty,
                                      float (&acc)[kRowsPT][Dims<D>::kColsPT]) {
  constexpr int S = Dims<D>::kStride, C = Dims<D>::kColsPT;
#pragma unroll 8
  for (int j = 0; j < kTile; ++j) {
    float pv[kRowsPT], bv[C];
#pragma unroll
    for (int a = 0; a < kRowsPT; ++a) pv[a] = P[(ty + 16 * a) * kPStride + j];
#pragma unroll
    for (int b = 0; b < C; ++b) bv[b] = B[j * S + tx + 16 * b];
#pragma unroll
    for (int a = 0; a < kRowsPT; ++a)
#pragma unroll
      for (int b = 0; b < C; ++b) acc[a][b] = fmaf(pv[a], bv[b], acc[a][b]);
  }
}

// acc[a][b] += sum_r P[r][ty + 16a] * B[r][tx + 16b]   (Pt B: 64 x D, depth 64)
template <int D>
__device__ __forceinline__ void mm_ptb(const float* __restrict__ P,
                                       const float* __restrict__ B, int tx,
                                       int ty,
                                       float (&acc)[kRowsPT][Dims<D>::kColsPT]) {
  constexpr int S = Dims<D>::kStride, C = Dims<D>::kColsPT;
#pragma unroll 8
  for (int r = 0; r < kTile; ++r) {
    float pv[kRowsPT], bv[C];
#pragma unroll
    for (int a = 0; a < kRowsPT; ++a) pv[a] = P[r * kPStride + ty + 16 * a];
#pragma unroll
    for (int b = 0; b < C; ++b) bv[b] = B[r * S + tx + 16 * b];
#pragma unroll
    for (int a = 0; a < kRowsPT; ++a)
#pragma unroll
      for (int b = 0; b < C; ++b) acc[a][b] = fmaf(pv[a], bv[b], acc[a][b]);
  }
}

// Write rows row0 + ty + 16a (< t_len) of acc * scale[a] as T into a
// [T, D] matrix.
template <typename T, int D>
__device__ __forceinline__ void store_rows(
    T* __restrict__ dst, int row0, int t_len, int tx, int ty,
    const float (&acc)[kRowsPT][Dims<D>::kColsPT],
    const float (&scale)[kRowsPT]) {
#pragma unroll
  for (int a = 0; a < kRowsPT; ++a) {
    const int row = row0 + ty + 16 * a;
    if (row >= t_len) continue;
    T* out = dst + static_cast<size_t>(row) * D;
#pragma unroll
    for (int b = 0; b < Dims<D>::kColsPT; ++b)
      out[tx + 16 * b] = from_float<T>(acc[a][b] * scale[a]);
  }
}

// Max and sum over the 16 lanes of a half-warp (the threads of one row).
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Whether tile row r and column c fall in a kept sub-block of `bits`
// (bit 4 i + j for row sub-block i = r >> sub_shift, column sub-block j).
__device__ __forceinline__ bool sub_block_kept(unsigned bits, int sub_shift,
                                               int r, int c) {
  return (bits >> (((r >> sub_shift) << 2) | (c >> sub_shift))) & 1u;
}

// lse and delta of query rows q0 .. q0 + 63 of head row `bh` into
// lse_s / delta_s ([64] each); rows at or past t_len hold 0.
__device__ __forceinline__ void load_rowstats(const float* __restrict__ lse,
                                              const float* __restrict__ delta,
                                              size_t bh, int q0, int t_len,
                                              float* lse_s, float* delta_s) {
  if (threadIdx.x < kTile) {
    const int row = q0 + threadIdx.x;
    const bool ok = row < t_len;
    lse_s[threadIdx.x] = ok ? lse[bh * t_len + row] : 0.f;
    delta_s[threadIdx.x] = ok ? delta[bh * t_len + row] : 0.f;
  }
}

// p (rounded to T) and ds (rounded to T) of one [64 q rows, 64 kv rows]
// tile pair into ps / dss, from q/dO/k/v tiles already in shared memory:
//   p = exp(q k^T * sm_scale - lse),  ds = p * (dO v^T - delta) * sm_scale.
// A pair outside the sequence (row or column at or past t_len), above
// the diagonal when causal, or in a sub-block whose bit of `bits` is
// clear has p = ds = 0.  ps may be null (the dq pass needs ds only).
// With kSubBlocks, `bits` and `sub_shift` are the block-sparse kernels'
// sub-block mask (bit 4 (r >> sub_shift) + (c >> sub_shift) for tile
// row r and column c); the dense kernels compile without the test (on
// the H100 a runtime test that keeps every pair cost B4 ~6 %).
template <typename T, int D, bool kSubBlocks = false>
__device__ __forceinline__ void probs_and_dscores(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* delta_s, int q0, int k0, int t_len,
    float sm_scale, int causal, int tx, int ty, float* ps, float* dss,
    unsigned bits = 0u, int sub_shift = 0) {
  float s[kRowsPT][4], dp[kRowsPT][4];
  mm_abt<D>(qs, ks, tx, ty, s);
  mm_abt<D>(dos, vs, tx, ty, dp);
#pragma unroll
  for (int a = 0; a < kRowsPT; ++a) {
    const int r = ty + 16 * a, row = q0 + r;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = tx + 16 * b, col = k0 + c;
      const bool keep =
          row < t_len && col < t_len && (!causal || col <= row) &&
          (!kSubBlocks || sub_block_kept(bits, sub_shift, r, c));
      const float p = keep ? expf(s[a][b] * sm_scale - lse_s[r]) : 0.f;
      const float ds = p * (dp[a][b] - delta_s[r]) * sm_scale;
      if (ps != nullptr) ps[r * kPStride + c] = round_to<T>(p);
      dss[r * kPStride + c] = round_to<T>(ds);
    }
  }
}

// Set the dynamic shared-memory limit of `kernel` when it needs more
// than the default 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace flash
}  // namespace dstt

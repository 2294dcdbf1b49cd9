// Flash-attention backward, dk/dv pass (kernel B4) for sm_90a.
//
// Replaces: deepspeed_tpu/ops/transformer/flash_attention.py
//   `_bwd_dkv_kernel` (launched by `_bwd` `:400`), the dk/dv half of the
//   two-pass backward: dk and dv at kv-head width, summed over the g query
//   heads of a group and over their query tiles.  With
//   p = exp(q k^T * sm_scale - lse) and ds = p * (dO v^T - delta) *
//   sm_scale,
//     dv = sum over the group of p^T dO,   dk = sum of ds^T q.
//   p is rounded to dO's dtype before the dv product and ds to q's dtype
//   before the dk product (`:283-292`); every sum is f32.
//
// Bound on the H100: at TinyLlama's training shape (B.H 256, B.KVH 32,
//   T 2048, D 64, bf16, causal) the four causal products (s, dV, dP, dK;
//   8 D flops per visible pair, 275 GFLOP) take 0.2781 ms on the tensor
//   cores and the least bytes (q, dO, lse, delta per query head, k, v,
//   dk, dv per kv head: ~172 MB) 0.051 ms, so the bound is operations.
//
// bf16 design (tensor cores; `dkv_walk` in flash_bwd_mma.cuh, which B2
//   shares at g = 1): one block of 4 warps per (kv head row, 64-row kv
//   tile); each warp owns 16 kv rows and keeps their K as mma.sync A fragments
//   in registers (read from shared memory at each use at D = 128, where they
//   would spill).  V's fragments are read from shared memory at each use:
//   holding them too takes B4 past the 168 registers a thread at which three
//   blocks fit an SM, and the third block is worth more than the loads holding
//   V would save.  The block walks the g query heads of its group (rows kv * g
//   .. kv * g + g - 1) and, for each, the query tiles that see the kv tile
//   (every tile, or from the kv tile's own index when causal: a q tile whose
//   rows all precede the kv tile is never loaded), with each pair's Q and dO
//   tiles and their lse and delta staged by cp.async in a two-stage ring.  Per
//   32 query columns a warp computes the transposed products S^T = K Q^T and
//   dP^T = V dO^T (Q and dO by ldmatrix), so p^T and ds^T come out as the
//   warp's own kv rows; lse and delta index by column (the query row) and are
//   read from shared memory per column; masks apply in fragment coordinates on
//   the diagonal and ragged tiles only.  p^T and ds^T are packed to bf16 A
//   fragments in registers (the rounding points) for dV += p^T dO and dK +=
//   ds^T Q (dO and Q by ldmatrix.trans).  dK and dV are f32 fragments, 16 x D
//   each a warp, written once: no atomics, so two launches give the same bits.
//   Query rows at or past T are zero-filled, never read (`:264-274`).  The
//   grid is B.KVH x T/64 blocks (1024 at micro 8) of uneven causal walks, so
//   kv tiles launch first-first: the longest walks start in the first wave and
//   the short ones fill the tail.
//
// Head dims and dtypes: every multiple of 16 up to 256 (the reference
//   takes any head dim; its configurations use 64, 80, 96, 128 and 256),
//   in bf16 and f16 on the tensor cores (the f16 kernel is the bf16 one
//   with the .f16 mma.sync and p/ds packed to f16: ET in flash_mma.cuh),
//   and in f32 on the CUDA cores where the f32 tiles fit shared memory
//   (up to D 192).  Above D 128 dK and dV together would take 4 x D f32
//   accumulators a thread, so each kv tile runs as two blocks
//   (blockIdx.z): one accumulates dV (no dP product), the other dK
//   (no P^T dO product): five products where one block does four.
//
// f32 design (CUDA cores, kept as it was: the tensor cores would round f32
//   operands to TF32): one block of 256 threads per (kv head row, 64-row kv
//   tile) keeps its K/V tile in shared memory as f32 and walks the same
//   query tiles; dK and dV accumulate in f32 registers (4 rows x D/16
//   columns each a thread), written once.
#include "flash_bwd_mma.cuh"
#include "flash_tiles.cuh"

#include <type_traits>

using namespace dstt;
using namespace dstt::flash;

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int t_len, int group,
                     float sm_scale, int causal) {
  constexpr int S = Dims<D>::kStride, C = Dims<D>::kColsPT;
  extern __shared__ float smem[];
  float* qs = smem;                       // [64][D + 1]
  float* dos = qs + kTile * S;            // [64][D + 1]
  float* ks = dos + kTile * S;            // [64][D + 1]
  float* vs = ks + kTile * S;             // [64][D + 1]
  float* ps = vs + kTile * S;             // [64][65]
  float* dss = ps + kTile * kPStride;     // [64][65]
  float* lse_s = dss + kTile * kPStride;  // [64]
  float* delta_s = lse_s + kTile;         // [64]

  const int n_tiles = (t_len + kTile - 1) / kTile;
  const size_t kvh = blockIdx.y;
  const size_t kv_base = kvh * t_len * D;
  const int kt = blockIdx.x, k0 = kt * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float one[kRowsPT] = {1.f, 1.f, 1.f, 1.f};

  load_tile<T, D>(k + kv_base, k0, t_len, ks);
  load_tile<T, D>(v + kv_base, k0, t_len, vs);
  float dk_acc[kRowsPT][C], dv_acc[kRowsPT][C];
#pragma unroll
  for (int a = 0; a < kRowsPT; ++a)
#pragma unroll
    for (int b = 0; b < C; ++b) dk_acc[a][b] = dv_acc[a][b] = 0.f;

  for (int m = 0; m < group; ++m) {
    const size_t bh = kvh * group + m;
    const size_t base = bh * t_len * D;
    for (int qt = causal ? kt : 0; qt < n_tiles; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the previous pair's products are done
      load_tile<T, D>(q + base, q0, t_len, qs);
      load_tile<T, D>(dout + base, q0, t_len, dos);
      load_rowstats(lse, delta, bh, q0, t_len, lse_s, delta_s);
      __syncthreads();
      probs_and_dscores<T, D>(qs, dos, ks, vs, lse_s, delta_s, q0, k0,
                              t_len, sm_scale, causal, tx, ty, ps, dss);
      __syncthreads();
      mm_ptb<D>(ps, dos, tx, ty, dv_acc);
      mm_ptb<D>(dss, qs, tx, ty, dk_acc);
    }
  }
  store_rows<T, D>(dk + kv_base, k0, t_len, tx, ty, dk_acc, one);
  store_rows<T, D>(dv + kv_base, k0, t_len, tx, ty, dv_acc, one);
}

// shared memory of the CUDA-core kernel: q, dO, k, v tiles, p, ds, lse
// and delta, f32
template <int D> constexpr size_t f32_smem() {
  return sizeof(float) *
         (4 * kTile * Dims<D>::kStride + 2 * kTile * kPStride + 2 * kTile);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv, int bkv,
           int group, int t_len, float sm_scale, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = f32_smem<D>();
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_len + kTile - 1) / kTile, bkv);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), t_len, group, sm_scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

namespace tc = dstt::mma;

// The bf16 / f16 tensor-core kernel (see the note at the top): one dk/dv
// walk a block (flash_bwd_mma.cuh), or above D 128 a dV block (z 0) and
// a dK block (z 1) per kv tile; ET is the operands' type.  At D <= 64 it
// is held to 168 registers a thread so that three blocks share an SM.
template <int D, typename ET>
__global__ void __launch_bounds__(tc::kThreads, D <= 64 ? 3 : 1)
flash_bwd_dkv_mma_kernel(const tc::bf16* __restrict__ q,
                         const tc::bf16* __restrict__ k,
                         const tc::bf16* __restrict__ v,
                         const tc::bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         tc::bf16* __restrict__ dk, tc::bf16* __restrict__ dv,
                         int t_len, int group, float sm_scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (tc::dkv_outs<D>() == 1)
    tc::dkv_walk<D, ET>(q, k, v, dout, lse, delta, dk, dv, t_len, group,
                        sm_scale, causal, blockIdx.y, blockIdx.x, smem_raw);
  else if (blockIdx.z == 0)
    tc::dkv_walk<D, ET, tc::kDvOnly>(q, k, v, dout, lse, delta, dk, dv,
                                     t_len, group, sm_scale, causal,
                                     blockIdx.y, blockIdx.x, smem_raw);
  else
    tc::dkv_walk<D, ET, tc::kDkOnly>(q, k, v, dout, lse, delta, dk, dv,
                                     t_len, group, sm_scale, causal,
                                     blockIdx.y, blockIdx.x, smem_raw);
}

template <int D, typename ET>
int launch_mma(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int bkv, int group, int t_len, float sm_scale, int causal,
               cudaStream_t stream) {
  const size_t smem = tc::dkv_walk_smem<D>();
  cudaError_t err = allow_smem(flash_bwd_dkv_mma_kernel<D, ET>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_len + tc::kTile - 1) / tc::kTile, bkv,
                  tc::dkv_outs<D>());
  flash_bwd_dkv_mma_kernel<D, ET><<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<const tc::bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<tc::bf16*>(dk), static_cast<tc::bf16*>(dv), t_len, group,
      sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// f32 to the CUDA-core kernel (where its f32 tiles fit shared memory),
// bf16 and f16 to the tensor-core one
template <typename T, int D>
int launch_route(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, int bkv, int group, int t_len,
                 float sm_scale, int causal, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value)
    return launch_mma<D, T>(q, k, v, dout, lse, delta, dk, dv, bkv, group,
                            t_len, sm_scale, causal, stream);
  else if constexpr (f32_smem<D>() <= kMaxSmem)
    return launch<T, D>(q, k, v, dout, lse, delta, dk, dv, bkv, group, t_len,
                        sm_scale, causal, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dk, void* dv, int bkv,
             int group, int t_len, int d, float sm_scale, int causal,
             cudaStream_t st) {
  switch (d) {
#define DSTT_CASE(D)                                                      \
  case D:                                                                 \
    return launch_route<T, D>(q, k, v, dout, lse, delta, dk, dv, bkv,     \
                              group, t_len, sm_scale, causal, st);
    DSTT_FLASH_HEAD_DIMS(DSTT_CASE)
#undef DSTT_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  q/dout [BKV * group,
// T, D] and k/v/dk/dv [BKV, T, D] contiguous; lse and delta [BKV * group,
// T] float32.  D a multiple of 16 up to 256 (float32: up to 192, where its
// tiles fit shared memory); BKV <= 65535.
extern "C" int dstt_flash_attention_bwd_dkv(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const void* lse, const void* delta,
                                            void* dk, void* dv, int bkv,
                                            int group, int t_len, int d,
                                            float sm_scale, int causal,
                                            int dtype, void* stream) {
  if (bkv < 1 || bkv > 65535 || t_len < 1 || group < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, dout, lse, delta, dk, dv, bkv, group,
                           t_len, d, sm_scale, causal, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, bkv,
                                   group, t_len, d, sm_scale, causal, st);
  if (dtype == 2)
    return dispatch<__half>(q, k, v, dout, lse, delta, dk, dv, bkv, group,
                            t_len, d, sm_scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

DSTT_DEFINE_ERROR_STRING(dstt_flash_attention_bwd_dkv)

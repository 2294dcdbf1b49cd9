// Block-sparse flash-attention backward, dk/dv pass (kernel B10) for
// sm_90a.
//
// Replaces: deepspeed_tpu/ops/sparse_attention/blocksparse_flash.py
//   `_bwd_dkv_kernel` (launched by `_bwd`), which walks the TRANSPOSED
//   layout (each kv block's list of query blocks).  With
//   p = exp(q k^T * sm_scale - lse) (0 outside the layout and above the
//   diagonal when causal) and ds = p * (dO v^T - delta) * sm_scale,
//     dv = p^T dO,   dk = ds^T q.
//   p is rounded to dO's dtype before the dv product and ds to q's dtype
//   before the dk product, as the TPU kernel does; every sum is f32.
//
// Bound on the H100: at GPT-2 125M's block-sparse training shape (B.H 96,
//   T 8192, D 64, bf16, FixedSparsityConfig block 64, 4 local + 1
//   global, unidirectional: 8.81e8 visible pairs) the four products (s,
//   dV, dP, dK; 8 D flops per pair, 451.2 GFLOP) take 0.456 ms on the
//   tensor cores and the least bytes (q, k, v, dO read, dk, dv written,
//   lse and delta: ~610 MB) 0.182 ms, so the bound is operations.
//
// bf16 design (tensor cores; `bsa_dkv_walk` in blocksparse_bwd_mma.cuh):
//   B4's `dkv_walk` at one query head per kv head, over a TileList, the
//   query tiles that read the block's kv tile (the transposed lists' `idx`,
//   `cnt`) in increasing order.  One block of 4 warps per (head row, 64-row
//   kv tile); each warp owns 16 kv rows and keeps their K as mma.sync A
//   fragments (read from shared memory at each use at D = 128) and reads V
//   from shared memory; the (Q, dO, lse, delta) stage of entry i + 1 loads
//   by cp.async into the other stage of a two-stage ring while entry i's
//   products run.  Per 32 query columns S^T = K Q^T and dP^T = V dO^T on
//   m16n8k16, p^T and ds^T packed to bf16 A fragments in registers (the
//   rounding points), dV += p^T dO and dK += ds^T Q with dO and Q by
//   ldmatrix.trans.  The mask runs only on the causal diagonal, a tile
//   holding rows at or past T, or a pair whose sub-block mask is not full.
//   The lists transpose the tile grid but not a pair's bits: bit 4 i + j is
//   still query sub-block i and key sub-block j, and a fragment's row is a
//   KV row, so the sub-block test takes (column, row).  Causal walks leave
//   out the query tiles before the kv tile (every element above the
//   diagonal).  dK and dV are written once, with no atomics, so two launches
//   give the same bits; a kv tile no query reads loads nothing and writes
//   zeros.  Walks are very uneven (at the shape above a "summary" kv tile is
//   read by up to 125 query tiles, a local one by at most 4), so kv tiles
//   launch in `order`, longest walk first, and the short walks fill the
//   tail.  Three blocks share an SM at D <= 64 (at most 168 registers a
//   thread, as B4), which needs the 32-column chunks as a loop, not
//   unrolled; two blocks an SM without the cap were slower.
//
// Head dims and blocks: every multiple of 16 up to 256, in bf16 and f16
//   on the tensor cores (the f16 kernel is the bf16 one with the .f16
//   mma.sync and p/ds packed to f16: ET in flash_mma.cuh) and f32 on the
//   CUDA cores where its tiles fit shared memory; any layout block that
//   is a multiple of 16 (the wrapper passes 16-row sub-block masks for
//   blocks other than 16, 32 and multiples of 64).  Above D 128 each kv
//   tile runs as a dV and a dK block, as B4 does.
//
// f32 design (CUDA cores, kept as it was: the tensor cores would round f32
//   operands to TF32): B4's f32 kernel with the transposed walk, one block
//   of 256 threads per (head row, 64-row kv tile) keeping K and V in
//   shared memory as f32 and testing each element's sub-block bit.
#include "blocksparse_bwd_mma.cuh"
#include "flash_tiles.cuh"

#include <type_traits>

using namespace dstt;
using namespace dstt::flash;

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bsa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, const int* __restrict__ idx,
                   const int* __restrict__ cnt, const int* __restrict__ bits,
                   const int* __restrict__ order, int t_len, int lheads,
                   int jmax, int sub_shift, float sm_scale, int causal) {
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
  const int kt = order[blockIdx.x], k0 = kt * kTile;
  const size_t bh = blockIdx.y;
  const size_t base = bh * t_len * D;
  const size_t walk = (bh % lheads) * n_tiles + kt;
  const int* qts = idx + walk * jmax;
  const int* qbits = bits + walk * jmax;
  const int n_walk = cnt[walk];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float one[kRowsPT] = {1.f, 1.f, 1.f, 1.f};

  load_tile<T, D>(k + base, k0, t_len, ks);
  load_tile<T, D>(v + base, k0, t_len, vs);
  float dk_acc[kRowsPT][C], dv_acc[kRowsPT][C];
#pragma unroll
  for (int a = 0; a < kRowsPT; ++a)
#pragma unroll
    for (int b = 0; b < C; ++b) dk_acc[a][b] = dv_acc[a][b] = 0.f;

  for (int j = 0; j < n_walk; ++j) {
    const int q0 = qts[j] * kTile;
    __syncthreads();  // the previous pair's products are done
    load_tile<T, D>(q + base, q0, t_len, qs);
    load_tile<T, D>(dout + base, q0, t_len, dos);
    load_rowstats(lse, delta, bh, q0, t_len, lse_s, delta_s);
    __syncthreads();
    probs_and_dscores<T, D, true>(qs, dos, ks, vs, lse_s, delta_s, q0, k0,
                                  t_len, sm_scale, causal, tx, ty, ps, dss,
                                  static_cast<unsigned>(qbits[j]),
                                  sub_shift);
    __syncthreads();
    mm_ptb<D>(ps, dos, tx, ty, dv_acc);
    mm_ptb<D>(dss, qs, tx, ty, dk_acc);
  }
  store_rows<T, D>(dk + base, k0, t_len, tx, ty, dk_acc, one);
  store_rows<T, D>(dv + base, k0, t_len, tx, ty, dv_acc, one);
}

// shared memory of the CUDA-core kernel: q, dO, k, v tiles, p, ds, lse
// and delta, f32
template <int D> constexpr size_t f32_smem() {
  return sizeof(float) * (4 * kTile * Dims<D>::kStride + 2 * kTile * kPStride + 2 * kTile);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv,
           const void* idx, const void* cnt, const void* bits,
           const void* order, int bh, int lheads, int t_len, int jmax,
           int sub_shift, float sm_scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = f32_smem<D>();
  cudaError_t err = allow_smem(bsa_bwd_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_len + kTile - 1) / kTile, bh);
  bsa_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<const int*>(idx),
      static_cast<const int*>(cnt), static_cast<const int*>(bits),
      static_cast<const int*>(order), t_len, lheads, jmax, sub_shift,
      sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

namespace tc = dstt::mma;

// The bf16 / f16 tensor-core kernel (see the note at the top): one dk/dv
// walk over a tile list a block, or above D 128 a dV block (z 0) and a dK
// block (z 1) per kv tile; ET is the operands' type.
template <int D, typename ET>
__global__ void __launch_bounds__(tc::kThreads, D <= 64 ? 3 : 1)
bsa_bwd_dkv_mma_kernel(const tc::bf16* __restrict__ q,
                       const tc::bf16* __restrict__ k,
                       const tc::bf16* __restrict__ v,
                       const tc::bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       tc::bf16* __restrict__ dk, tc::bf16* __restrict__ dv,
                       const int* __restrict__ idx,
                       const int* __restrict__ cnt,
                       const int* __restrict__ bits,
                       const int* __restrict__ order, int t_len, int lheads,
                       int jmax, int sub_shift, float sm_scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_tiles = (t_len + tc::kTile - 1) / tc::kTile;
  const int kt = order[blockIdx.x];
  const size_t bh = blockIdx.y;
  const int row = static_cast<int>(bh % lheads) * n_tiles + kt;
  tc::TileList walk{idx, bits, row * jmax, cnt[row], kt, sub_shift};
  if (causal) walk.drop_before(kt);
  if constexpr (tc::dkv_outs<D>() == 1)
    tc::bsa_dkv_walk<D, ET>(q, k, v, dout, lse, delta, dk, dv, t_len, sm_scale,
                        causal, bh, walk, smem_raw);
  else if (blockIdx.z == 0)
    tc::bsa_dkv_walk<D, ET, tc::kDvOnly>(q, k, v, dout, lse, delta, dk,
                                         dv, t_len, sm_scale, causal, bh, walk,
                                     smem_raw);
  else
    tc::bsa_dkv_walk<D, ET, tc::kDkOnly>(q, k, v, dout, lse, delta, dk,
                                         dv, t_len, sm_scale, causal, bh, walk,
                                     smem_raw);
}

template <int D, typename ET>
int launch_mma(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const void* idx, const void* cnt, const void* bits,
               const void* order, int bh, int lheads, int t_len, int jmax,
               int sub_shift, float sm_scale, int causal,
               cudaStream_t stream) {
  const size_t smem = tc::dkv_walk_smem<D>();
  cudaError_t err = allow_smem(bsa_bwd_dkv_mma_kernel<D, ET>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_len + tc::kTile - 1) / tc::kTile, bh,
                  tc::dkv_outs<D>());
  bsa_bwd_dkv_mma_kernel<D, ET><<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<const tc::bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<tc::bf16*>(dk), static_cast<tc::bf16*>(dv),
      static_cast<const int*>(idx), static_cast<const int*>(cnt),
      static_cast<const int*>(bits), static_cast<const int*>(order), t_len,
      lheads, jmax, sub_shift, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// f32 to the CUDA-core kernel (where its f32 tiles fit shared memory),
// bf16 and f16 to the tensor-core one
template <typename T, int D>
int launch_route(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, const void* idx, const void* cnt,
                 const void* bits, const void* order, int bh, int lheads,
                 int t_len, int jmax, int sub_shift, float sm_scale,
                 int causal, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value)
    return launch_mma<D, T>(q, k, v, dout, lse, delta, dk, dv, idx, cnt,
                            bits, order, bh, lheads, t_len, jmax, sub_shift,
                            sm_scale, causal, stream);
  else if constexpr (f32_smem<D>() <= kMaxSmem)
    return launch<T, D>(q, k, v, dout, lse, delta, dk, dv, idx, cnt, bits,
                        order, bh, lheads, t_len, jmax, sub_shift, sm_scale,
                        causal, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dk, void* dv,
             const void* idx, const void* cnt, const void* bits,
             const void* order, int bh, int lheads, int t_len, int jmax,
             int d, int sub_shift, float sm_scale, int causal,
             cudaStream_t st) {
  switch (d) {
#define DSTT_CASE(D)                                                      \
  case D:                                                                 \
    return launch_route<T, D>(q, k, v, dout, lse, delta, dk, dv, idx, \
                              cnt, bits, order, bh, lheads, t_len, \
                              jmax, sub_shift, sm_scale, causal, st);
    DSTT_FLASH_HEAD_DIMS(DSTT_CASE)
#undef DSTT_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  q/k/v/dout/dk/dv
// [BH, T, D] contiguous; lse and delta [BH, T] float32; the transposed walk
// (idx/bits [lheads, n, jmax]: each kv tile's query tiles, cnt [lheads,
// n], order [n], n = ceil(T / 64)).  D a multiple of 16 up to 256
// (float32: where its tiles fit shared memory); BH <= 65535 and a
// multiple of lheads; sub_shift 4, 5 or 6.
extern "C" int dstt_blocksparse_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, const void* idx,
    const void* cnt, const void* bits, const void* order, int bh, int lheads,
    int t_len, int jmax, int d, int sub_shift, float sm_scale, int causal,
    int dtype, void* stream) {
  if (bh < 1 || bh > 65535 || t_len < 1 || lheads < 1 || bh % lheads ||
      jmax < 1 || sub_shift < 4 || sub_shift > 6)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, dout, lse, delta, dk, dv, idx, cnt, bits,
                           order, bh, lheads, t_len, jmax, d, sub_shift,
                           sm_scale, causal, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, idx,
                                   cnt, bits, order, bh, lheads, t_len, jmax,
                                   d, sub_shift, sm_scale, causal, st);
  if (dtype == 2)
    return dispatch<__half>(q, k, v, dout, lse, delta, dk, dv, idx, cnt, bits,
                            order, bh, lheads, t_len, jmax, d, sub_shift,
                            sm_scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

DSTT_DEFINE_ERROR_STRING(dstt_blocksparse_flash_bwd_dkv)

// Flash-attention backward, dq pass (kernel B3) for sm_90a.
//
// Replaces: deepspeed_tpu/ops/transformer/flash_attention.py
//   `_bwd_dq_kernel` (launched by `_bwd` `:377`), the dq half of the
//   two-pass backward JAX runs whenever the fused backward does not
//   apply (a sequence past one block, or grouped-query attention).  From
//   the forward's logsumexp and delta = rowsum(dO * O), with
//   p = exp(q k^T * sm_scale - lse):
//     ds = p * (dO v^T - delta) * sm_scale,   dq = ds k.
//   ds is rounded to q's dtype before the dq product, as the TPU kernel
//   rounds it to k's (`:229-231`; q and k share one dtype); every sum is
//   f32.  Query head row b reads kv head row b / g (the TPU kernel's
//   k/v index map `b // g`).
//
// Bound on the H100: at TinyLlama's training shape (B.H 256, B.KVH 32,
//   T 2048, D 64, bf16, causal) the three causal products (s, dP, dQ;
//   6 D flops per visible pair, 206 GFLOP) take 0.2086 ms on the tensor
//   cores and the least bytes (q, dO, dq, lse, delta per query head, k
//   and v per kv head: ~222 MB) 0.066 ms, so the bound is operations.
//
// bf16 design (tensor cores; `dq_walk` in flash_bwd_mma.cuh, which B2
//   shares at g = 1): one block of 4 warps per (query head row,
//   64-row query tile); each warp owns 16 query rows and keeps their Q
//   and dO as mma.sync A fragments in registers for the whole walk (read
//   from shared memory at each use at D = 128, where they would spill),
//   with their lse and delta.  The block walks the 64-row K/V tiles of
//   its kv head (up to the diagonal tile when causal), staged as bf16 by
//   cp.async in a two-stage ring so the next tile's load overlaps this
//   tile's products.  Per tile a warp computes S = Q K^T and dP = dO V^T
//   (mma.sync m16n8k16, K and V read by ldmatrix) into f32 fragments,
//   p and ds on the fragments (masked in fragment coordinates on the
//   diagonal and ragged tiles only), packs ds to bf16 A fragments in
//   registers (no shared-memory round trip; the packing is the rounding
//   point) and adds dS K (K by ldmatrix.trans) to its f32 dQ fragments,
//   16 x D a warp, written once.  No atomics: each dq row is written by
//   one block in a fixed order, so two launches give the same bits.  K/V
//   rows at or past T are zero-filled, never read (`:211-218`).  Query
//   tiles launch last-first so the longest causal walks start first.
//
// Head dims and dtypes: every multiple of 16 up to 256 (the reference
//   takes any head dim; its configurations use 64, 80, 96, 128 and 256),
//   in bf16 and f16 on the tensor cores (the f16 kernel is the bf16 one
//   with the .f16 mma.sync and p/ds packed to f16: ET in flash_mma.cuh),
//   and in f32 on the CUDA cores where the f32 tiles fit shared memory
//   (up to D 208).  Above D 128 the dq accumulator is 2 x D f32 a
//   thread, so those instantiations run near 255 registers.
//
// f32 design (CUDA cores, kept as it was: the tensor cores would round f32
//   operands to TF32): one block of 256 threads per (query head row,
//   64-row query tile) keeps its Q and dO tiles, lse and delta in shared
//   memory as f32 and walks the K/V tiles of its kv head; dQ accumulates
//   in registers (4 rows x D/16 columns a thread), written once.
#include "flash_bwd_mma.cuh"
#include "flash_tiles.cuh"

#include <type_traits>

using namespace dstt;
using namespace dstt::flash;

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int t_len, int group, float sm_scale, int causal) {
  constexpr int S = Dims<D>::kStride, C = Dims<D>::kColsPT;
  extern __shared__ float smem[];
  float* qs = smem;                       // [64][D + 1]
  float* dos = qs + kTile * S;            // [64][D + 1]
  float* ks = dos + kTile * S;            // [64][D + 1]
  float* vs = ks + kTile * S;             // [64][D + 1]
  float* dss = vs + kTile * S;            // [64][65]
  float* lse_s = dss + kTile * kPStride;  // [64]
  float* delta_s = lse_s + kTile;         // [64]

  const int n_tiles = (t_len + kTile - 1) / kTile;
  const size_t bh = blockIdx.y;
  const size_t base = bh * t_len * D;
  const size_t kv_base = (bh / group) * t_len * D;
  const int qt = n_tiles - 1 - blockIdx.x, q0 = qt * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float one[kRowsPT] = {1.f, 1.f, 1.f, 1.f};

  load_tile<T, D>(q + base, q0, t_len, qs);
  load_tile<T, D>(dout + base, q0, t_len, dos);
  load_rowstats(lse, delta, bh, q0, t_len, lse_s, delta_s);
  float dq_acc[kRowsPT][C];
#pragma unroll
  for (int a = 0; a < kRowsPT; ++a)
#pragma unroll
    for (int b = 0; b < C; ++b) dq_acc[a][b] = 0.f;

  const int last_kt = causal ? qt : n_tiles - 1;
  for (int kt = 0; kt <= last_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's dQ product is done with ks/dss
    load_tile<T, D>(k + kv_base, k0, t_len, ks);
    load_tile<T, D>(v + kv_base, k0, t_len, vs);
    __syncthreads();
    probs_and_dscores<T, D>(qs, dos, ks, vs, lse_s, delta_s, q0, k0, t_len,
                            sm_scale, causal, tx, ty, nullptr, dss);
    __syncthreads();
    mm_pb<D>(dss, ks, tx, ty, dq_acc);
  }
  store_rows<T, D>(dq + base, q0, t_len, tx, ty, dq_acc, one);
}

// shared memory of the CUDA-core kernel: q, dO, k, v tiles, ds, lse and
// delta, f32
template <int D> constexpr size_t f32_smem() {
  return sizeof(float) *
         (4 * kTile * Dims<D>::kStride + kTile * kPStride + 2 * kTile);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int bh, int group,
           int t_len, float sm_scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = f32_smem<D>();
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_len + kTile - 1) / kTile, bh);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), t_len, group, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

namespace tc = dstt::mma;

// The bf16 / f16 tensor-core kernel (see the note at the top): one dq
// walk a block (flash_bwd_mma.cuh); ET is the operands' type.
template <int D, typename ET>
__global__ void __launch_bounds__(tc::kThreads)
flash_bwd_dq_mma_kernel(const tc::bf16* __restrict__ q,
                        const tc::bf16* __restrict__ k,
                        const tc::bf16* __restrict__ v,
                        const tc::bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        tc::bf16* __restrict__ dq, int t_len, int group,
                        float sm_scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tc::dq_walk<D, ET>(q, k, v, dout, lse, delta, dq, t_len, group, sm_scale,
                     causal, blockIdx.y, blockIdx.x, smem_raw);
}

template <int D, typename ET>
int launch_mma(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, int bh,
               int group, int t_len, float sm_scale, int causal,
               cudaStream_t stream) {
  const size_t smem = tc::dq_walk_smem<D>();
  cudaError_t err = allow_smem(flash_bwd_dq_mma_kernel<D, ET>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_len + tc::kTile - 1) / tc::kTile, bh);
  flash_bwd_dq_mma_kernel<D, ET><<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<const tc::bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<tc::bf16*>(dq), t_len, group, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// f32 to the CUDA-core kernel (where its f32 tiles fit shared memory),
// bf16 and f16 to the tensor-core one
template <typename T, int D>
int launch_route(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int bh, int group, int t_len, float sm_scale,
                 int causal, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value)
    return launch_mma<D, T>(q, k, v, dout, lse, delta, dq, bh, group, t_len,
                            sm_scale, causal, stream);
  else if constexpr (f32_smem<D>() <= kMaxSmem)
    return launch<T, D>(q, k, v, dout, lse, delta, dq, bh, group, t_len,
                        sm_scale, causal, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, int bh, int group,
             int t_len, int d, float sm_scale, int causal, cudaStream_t st) {
  switch (d) {
#define DSTT_CASE(D)                                                     \
  case D:                                                                \
    return launch_route<T, D>(q, k, v, dout, lse, delta, dq, bh, group,  \
                              t_len, sm_scale, causal, st);
    DSTT_FLASH_HEAD_DIMS(DSTT_CASE)
#undef DSTT_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  q/dout/dq [BH, T, D]
// and k/v [BH / group, T, D] contiguous; lse and delta [BH, T] float32.
// D a multiple of 16 up to 256 (float32: up to 208, where its tiles fit
// shared memory); BH <= 65535 and a multiple of group.
extern "C" int dstt_flash_attention_bwd_dq(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse, const void* delta,
                                           void* dq, int bh, int group,
                                           int t_len, int d, float sm_scale,
                                           int causal, int dtype,
                                           void* stream) {
  if (bh < 1 || bh > 65535 || t_len < 1 || group < 1 || bh % group)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, dout, lse, delta, dq, bh, group, t_len,
                           d, sm_scale, causal, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, bh, group,
                                   t_len, d, sm_scale, causal, st);
  if (dtype == 2)
    return dispatch<__half>(q, k, v, dout, lse, delta, dq, bh, group, t_len,
                            d, sm_scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

DSTT_DEFINE_ERROR_STRING(dstt_flash_attention_bwd_dq)

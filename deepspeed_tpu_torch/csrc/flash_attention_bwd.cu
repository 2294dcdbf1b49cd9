// Fused flash-attention backward (kernel B2) for sm_90a.
//
// Replaces: deepspeed_tpu/ops/transformer/flash_attention.py
//   `_bwd_fused_kernel` (launched by `_bwd_fused`), the backward JAX runs
//   when the whole sequence is one block and attention is MHA
//   (nq == nk == 1, `_bwd` `:373`): from the forward's logsumexp and
//   delta = rowsum(dO * O), with p = exp(q k^T * sm_scale - lse),
//     dv = p^T dO,   ds = p * (dO v^T - delta) * sm_scale,
//     dq = ds k,     dk = ds^T q.
//   The TPU kernel's rounding points are kept: p is rounded to dO's
//   dtype before the dv product, ds to q's dtype before dq and dk; every
//   sum is f32.
//
// Bound on the H100: at the training shape (B.H 768, T 1024, D 64, bf16,
//   causal) the least bytes take 0.21 ms and the five causal products
//   (s, dP, dV, dQ, dK) 0.26 ms on the tensor cores, so the bound is
//   operations.  The kernel runs seven: s and dP are recomputed by the dq
//   blocks, since summing dq across kv tiles in one pass needs atomics
//   (two launches would then differ) or a dq scratch per kv tile (a
//   kernel allocates nothing).
//
// Design: the TPU kernel holds the whole [T, T] score matrix of one
//   (batch, head) in VMEM; 228 KB of shared memory holds 64-row tiles.
//   One launch runs two kinds of block, told apart by blockIdx.z, as the
//   JAX kernel is one pallas_call:
//   * z = 0, one per (kv tile, batch x head): keeps its K/V tile and
//     walks the query tiles that see it (all of them, or those at or
//     after it when causal), accumulating dK and dV; the earliest kv
//     tiles walk the most and launch first;
//   * z = 1, one per (query tile, batch x head): keeps its Q/dO tile and
//     walks the kv tiles it sees, accumulating dQ; the last query tiles
//     walk the most and launch first.
//   Each output row is written once by one block, in a fixed order, so
//   two launches give the same bits.  Rows at or past T are never loaded
//   and their probabilities are zero.
//
// bf16 (tensor cores): the z = 0 blocks run B4's `dkv_walk` and the
//   z = 1 blocks B3's `dq_walk` (flash_bwd_mma.cuh) at g = 1: mma.sync
//   m16n8k16 fed by ldmatrix from a two-stage cp.async ring, p and ds
//   packed to bf16 operand fragments in registers.  The kernel takes B4's
//   register budget (168 a thread at D <= 64, three blocks an SM), which
//   the dq walk already fits.
//
// Head dims and dtypes: every multiple of 16 up to 256 (the reference
//   takes any head dim; its configurations use 64, 80, 96, 128 and 256),
//   in bf16 and f16 on the tensor cores (the f16 kernel is the bf16 one
//   with the .f16 mma.sync and p/ds packed to f16: ET in flash_mma.cuh),
//   and in f32 on the CUDA cores where the f32 tiles fit shared memory
//   (up to D 192).  Above D 128 the dk/dv walk is split into a dV and a
//   dK block, as in B4.
//
// f32 (CUDA cores, kept as it was: the tensor cores would round f32
//   operands to TF32): 256 threads a block, 64-row tiles in shared memory
//   as f32 (flash_tiles.cuh), accumulators in registers.
#include "flash_bwd_mma.cuh"
#include "flash_tiles.cuh"

#include <type_traits>

using namespace dstt;
using namespace dstt::flash;

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                 int t_len, float sm_scale, int causal) {
  constexpr int S = Dims<D>::kStride, C = Dims<D>::kColsPT;
  extern __shared__ float smem[];
  float* qs = smem;                   // [64][D + 1]
  float* dos = qs + kTile * S;        // [64][D + 1]
  float* ks = dos + kTile * S;        // [64][D + 1]
  float* vs = ks + kTile * S;         // [64][D + 1]
  float* ps = vs + kTile * S;         // [64][65]
  float* dss = ps + kTile * kPStride; // [64][65]
  float* lse_s = dss + kTile * kPStride;  // [64]
  float* delta_s = lse_s + kTile;         // [64]

  const int n_tiles = (t_len + kTile - 1) / kTile;
  const size_t bh = blockIdx.y;
  const size_t base = bh * t_len * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float one[kRowsPT] = {1.f, 1.f, 1.f, 1.f};

  if (blockIdx.z == 0) {
    // dK, dV of kv tile kt; causal: the earliest kv tiles walk the most
    // query tiles and are launched first
    const int kt = blockIdx.x, k0 = kt * kTile;
    load_tile<T, D>(k + base, k0, t_len, ks);
    load_tile<T, D>(v + base, k0, t_len, vs);
    float dk_acc[kRowsPT][C], dv_acc[kRowsPT][C];
#pragma unroll
    for (int a = 0; a < kRowsPT; ++a)
#pragma unroll
      for (int b = 0; b < C; ++b) dk_acc[a][b] = dv_acc[a][b] = 0.f;
    for (int qt = causal ? kt : 0; qt < n_tiles; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the previous tile's products are done
      load_tile<T, D>(q + base, q0, t_len, qs);
      load_tile<T, D>(dout + base, q0, t_len, dos);
      load_rowstats(lse, delta, bh, q0, t_len, lse_s, delta_s);
      __syncthreads();
      probs_and_dscores<T, D>(qs, dos, ks, vs, lse_s, delta_s, q0, k0, t_len,
                              sm_scale, causal, tx, ty, ps, dss);
      __syncthreads();
      mm_ptb<D>(ps, dos, tx, ty, dv_acc);
      mm_ptb<D>(dss, qs, tx, ty, dk_acc);
    }
    store_rows<T, D>(dk + base, k0, t_len, tx, ty, dk_acc, one);
    store_rows<T, D>(dv + base, k0, t_len, tx, ty, dv_acc, one);
  } else {
    // dQ of query tile qt; causal: the last query tiles walk the most kv
    // tiles and are launched first
    const int qt = n_tiles - 1 - blockIdx.x, q0 = qt * kTile;
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
      __syncthreads();
      load_tile<T, D>(k + base, k0, t_len, ks);
      load_tile<T, D>(v + base, k0, t_len, vs);
      __syncthreads();
      probs_and_dscores<T, D>(qs, dos, ks, vs, lse_s, delta_s, q0, k0, t_len,
                              sm_scale, causal, tx, ty, nullptr, dss);
      __syncthreads();
      mm_pb<D>(dss, ks, tx, ty, dq_acc);
    }
    store_rows<T, D>(dq + base, q0, t_len, tx, ty, dq_acc, one);
  }
}

// shared memory of the CUDA-core kernel: four tiles, p, ds, lse and
// delta, f32
template <int D> constexpr size_t f32_smem() {
  return sizeof(float) *
         (4 * kTile * Dims<D>::kStride + 2 * kTile * kPStride + 2 * kTile);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, void* dk, void* dv,
           int bh, int t_len, float sm_scale, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = f32_smem<D>();
  cudaError_t err = allow_smem(flash_bwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_len + kTile - 1) / kTile, bh, 2);
  flash_bwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), t_len,
      sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

namespace tc = dstt::mma;

// The bf16 / f16 tensor-core kernel (see the note at the top); ET is the
// operands' type.  `group` is 1, passed at run time so that each walk
// compiles as it does in B3 and B4 (a constant 1 changes the dk/dv walk's
// register allocation, which then spills at D 64).  Above D 128 the dk/dv
// walk is two blocks, as in B4: z 0 writes dV, z 1 runs the dq walk and z
// 2 writes dK.  Three blocks an SM (168 registers) at D 16, 32 and 64; at
// D 48 that budget spilled 52 bytes on an H100, so it takes one.
template <int D, typename ET>
__global__ void __launch_bounds__(tc::kThreads,
                                  D <= 64 && (D & (D - 1)) == 0 ? 3 : 1)
flash_bwd_mma_kernel(const tc::bf16* __restrict__ q,
                     const tc::bf16* __restrict__ k,
                     const tc::bf16* __restrict__ v,
                     const tc::bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     tc::bf16* __restrict__ dq, tc::bf16* __restrict__ dk,
                     tc::bf16* __restrict__ dv, int t_len, int group,
                     float sm_scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (tc::dkv_outs<D>() == 1) {
    if (blockIdx.z == 0)
      tc::dkv_walk<D, ET>(q, k, v, dout, lse, delta, dk, dv, t_len, group,
                          sm_scale, causal, blockIdx.y, blockIdx.x, smem_raw);
    else
      tc::dq_walk<D, ET>(q, k, v, dout, lse, delta, dq, t_len, group,
                         sm_scale, causal, blockIdx.y, blockIdx.x, smem_raw);
  } else {
    if (blockIdx.z == 0)
      tc::dkv_walk<D, ET, tc::kDvOnly>(q, k, v, dout, lse, delta, dk, dv,
                                       t_len, group, sm_scale, causal,
                                       blockIdx.y, blockIdx.x, smem_raw);
    else if (blockIdx.z == 1)
      tc::dq_walk<D, ET>(q, k, v, dout, lse, delta, dq, t_len, group,
                         sm_scale, causal, blockIdx.y, blockIdx.x, smem_raw);
    else
      tc::dkv_walk<D, ET, tc::kDkOnly>(q, k, v, dout, lse, delta, dk, dv,
                                       t_len, group, sm_scale, causal,
                                       blockIdx.y, blockIdx.x, smem_raw);
  }
}

template <int D, typename ET>
int launch_mma(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, void* dk,
               void* dv, int bh, int t_len, float sm_scale, int causal,
               cudaStream_t stream) {
  constexpr size_t smem = tc::dkv_walk_smem<D>() > tc::dq_walk_smem<D>()
                              ? tc::dkv_walk_smem<D>()
                              : tc::dq_walk_smem<D>();
  cudaError_t err = allow_smem(flash_bwd_mma_kernel<D, ET>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_len + tc::kTile - 1) / tc::kTile, bh,
                  1 + tc::dkv_outs<D>());
  flash_bwd_mma_kernel<D, ET><<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<const tc::bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<tc::bf16*>(dq), static_cast<tc::bf16*>(dk),
      static_cast<tc::bf16*>(dv), t_len, 1, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// f32 to the CUDA-core kernel (where its f32 tiles fit shared memory),
// bf16 and f16 to the tensor-core one
template <typename T, int D>
int launch_route(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, void* dk, void* dv, int bh, int t_len,
                 float sm_scale, int causal, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value)
    return launch_mma<D, T>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t_len,
                            sm_scale, causal, stream);
  else if constexpr (f32_smem<D>() <= kMaxSmem)
    return launch<T, D>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t_len,
                        sm_scale, causal, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, void* dk, void* dv,
             int bh, int t_len, int d, float sm_scale, int causal,
             cudaStream_t st) {
  switch (d) {
#define DSTT_CASE(D)                                                      \
  case D:                                                                 \
    return launch_route<T, D>(q, k, v, dout, lse, delta, dq, dk, dv, bh,  \
                              t_len, sm_scale, causal, st);
    DSTT_FLASH_HEAD_DIMS(DSTT_CASE)
#undef DSTT_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  q/k/v/dout/dq/dk/dv
// [BH, T, D] contiguous; lse and delta [BH, T] float32.  D a multiple of
// 16 up to 256 (float32: up to 192, where its tiles fit shared memory);
// BH <= 65535.
extern "C" int dstt_flash_attention_bwd(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* delta,
                                        void* dq, void* dk, void* dv, int bh,
                                        int t_len, int d, float sm_scale,
                                        int causal, int dtype, void* stream) {
  if (bh < 1 || bh > 65535 || t_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t_len,
                           d, sm_scale, causal, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk, dv, bh,
                                   t_len, d, sm_scale, causal, st);
  if (dtype == 2)
    return dispatch<__half>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t_len,
                            d, sm_scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

DSTT_DEFINE_ERROR_STRING(dstt_flash_attention_bwd)

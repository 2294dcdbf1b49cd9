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
//   operations.  This first version runs its products on the CUDA cores
//   in f32 and recomputes s and dP once more than the least (seven
//   products), so it sits well above that bound.
//
// Design: the TPU kernel holds the whole [T, T] score matrix of one
//   (batch, head) in VMEM; 228 KB of shared memory holds 64-row tiles.
//   Summing dq across kv tiles with atomics would make the result change
//   from run to run, and the JAX kernel is deterministic, so one launch
//   runs two kinds of block, told apart by blockIdx.z:
//   * z = 0, one per (kv tile, batch x head): keeps its K/V tile in
//     shared memory and walks the query tiles that see it (all of them,
//     or those at or after it when causal), accumulating dK and dV in
//     registers;
//   * z = 1, one per (query tile, batch x head): keeps its Q/dO tile and
//     walks the kv tiles it sees, accumulating dQ in registers.
//   Each output row is written once by one block, in a fixed order, so
//   the kernel is deterministic.  Rows at or past T are never loaded and
//   their probabilities are zero.
#include "flash_tiles.cuh"

using namespace dstt;
using namespace dstt::flash;

namespace {

// p (rounded to T) and ds (rounded to T) of one [64 q rows, 64 kv rows]
// tile pair into ps / dss, from q/dO/k/v tiles already in shared memory.
template <typename T, int D>
__device__ __forceinline__ void probs_and_dscores(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* delta_s, int q0, int k0, int t_len,
    float sm_scale, int causal, int tx, int ty, float* ps, float* dss) {
  float s[kRowsPT][4], dp[kRowsPT][4];
  mm_abt<D>(qs, ks, tx, ty, s);
  mm_abt<D>(dos, vs, tx, ty, dp);
#pragma unroll
  for (int a = 0; a < kRowsPT; ++a) {
    const int r = ty + 16 * a, row = q0 + r;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = tx + 16 * b, col = k0 + c;
      const bool keep = row < t_len && col < t_len && (!causal || col <= row);
      const float p = keep ? expf(s[a][b] * sm_scale - lse_s[r]) : 0.f;
      const float ds = p * (dp[a][b] - delta_s[r]) * sm_scale;
      if (ps != nullptr) ps[r * kPStride + c] = round_to<T>(p);
      dss[r * kPStride + c] = round_to<T>(ds);
    }
  }
}

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

  auto load_rowstats = [&](int q0) {
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const bool ok = row < t_len;
      lse_s[threadIdx.x] = ok ? lse[bh * t_len + row] : 0.f;
      delta_s[threadIdx.x] = ok ? delta[bh * t_len + row] : 0.f;
    }
  };

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
      load_rowstats(q0);
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
    load_rowstats(q0);
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, void* dk, void* dv,
           int bh, int t_len, float sm_scale, int causal,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * kTile * Dims<D>::kStride +
                                       2 * kTile * kPStride + 2 * kTile);
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

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, void* dk, void* dv,
             int bh, int t_len, int d, float sm_scale, int causal,
             cudaStream_t st) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t_len, sm_scale, causal, st);
    case 32: return launch<T, 32>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t_len, sm_scale, causal, st);
    case 64: return launch<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t_len, sm_scale, causal, st);
    case 128: return launch<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t_len, sm_scale, causal, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/k/v/dout/dq/dk/dv [BH, T, D]
// contiguous; lse and delta [BH, T] float32.  D in {16, 32, 64, 128};
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
  return static_cast<int>(cudaErrorInvalidValue);
}

DSTT_DEFINE_ERROR_STRING(dstt_flash_attention_bwd)

// FlashAttention-2 forward (kernel B1) for sm_90a.
//
// Replaces: deepspeed_tpu/ops/transformer/flash_attention.py `_fwd_kernel`
//   (launched by `_fwd`): o = softmax(q k^T * sm_scale) v per (batch x
//   head), causal or not, with online softmax and f32 accumulators; also
//   writes the per-row logsumexp the backward (kernels B2, B3, B4)
//   reads.  The probabilities are rounded to v's dtype before the P.V
//   product, as the TPU kernel does; the running sum l takes them
//   unrounded.  Grouped-query attention: q/o/lse hold B.H head rows and
//   k/v B.KVH, g = H / KVH; query head row b reads kv head row b / g, the
//   TPU kernel's k/v index map `b // g` (`_fwd`), so k/v are never
//   repeated through memory.  With g = 1 the kernel is the MHA kernel.
//
// Bound on the H100: at GPT-2 125M's training shape (B.H 768, T 1024,
//   D 64, bf16, causal) the least bytes (q, k, v read once, o written
//   once) take 0.12 ms and the causal products about 0.10 ms on the
//   tensor cores, so the bound is bytes; at TinyLlama's (B.H 256, B.KVH
//   32, T 2048, D 64, g 8) the k/v bytes shrink by g and the products
//   (137.5 GFLOP, 0.139 ms) bound it.  This first version does both products on the
//   CUDA cores in f32 (67 TF/s peak), so it is bound by those operations;
//   moving them onto mma/wgmma is the later step.
//
// Design:
//   * the TPU kernel holds a 1024 x 1024 score block in VMEM; here one
//     block of 256 threads owns a 64-row query tile of one (batch, head)
//     and walks 64-row K/V tiles through shared memory (f32, odd row
//     stride), the TPU grid's sequential kv axis becoming that loop;
//   * causal early exit: a query tile stops at the kv tile holding its
//     last row, and only that diagonal tile is masked; query tiles are
//     launched last-first so the longest walks start first;
//   * rows at or past T are never loaded (zeros in shared memory, scores
//     -inf), which is the TPU kernel's ragged-tail NaN-safety rule;
//   * each thread keeps 4 query rows x D/16 output columns and the
//     rows' running max and sum in registers; the 16 threads of a row
//     reduce with half-warp shuffles.
#include "flash_tiles.cuh"

using namespace dstt;
using namespace dstt::flash;

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int t_len, int group,
                 float sm_scale, int causal) {
  constexpr int S = Dims<D>::kStride, C = Dims<D>::kColsPT;
  extern __shared__ float smem[];
  float* qs = smem;                 // [64][D + 1]
  float* ks = qs + kTile * S;       // [64][D + 1]
  float* vs = ks + kTile * S;       // [64][D + 1]
  float* ps = vs + kTile * S;       // [64][65] probabilities, rounded to T

  const int n_tiles = (t_len + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.x;  // longest causal walks first
  const size_t base = static_cast<size_t>(blockIdx.y) * t_len * D;
  const size_t kv_base = static_cast<size_t>(blockIdx.y / group) * t_len * D;
  const int q0 = qt * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, D>(q + base, q0, t_len, qs);

  float m[kRowsPT], l[kRowsPT], acc[kRowsPT][C];
#pragma unroll
  for (int a = 0; a < kRowsPT; ++a) {
    m[a] = DSTT_NEG_INF;
    l[a] = 0.f;
#pragma unroll
    for (int b = 0; b < C; ++b) acc[a][b] = 0.f;
  }

  const int last_kt = causal ? qt : n_tiles - 1;
  for (int kt = 0; kt <= last_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's P.V is done with ks/vs/ps
    load_tile<T, D>(k + kv_base, k0, t_len, ks);
    load_tile<T, D>(v + kv_base, k0, t_len, vs);
    __syncthreads();

    float s[kRowsPT][4];
    mm_abt<D>(qs, ks, tx, ty, s);
#pragma unroll
    for (int a = 0; a < kRowsPT; ++a) {
      const int row = q0 + ty + 16 * a;
      float mx = DSTT_NEG_INF;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = k0 + tx + 16 * b;
        const bool keep = col < t_len && (!causal || col <= row);
        s[a][b] = keep ? s[a][b] * sm_scale : DSTT_NEG_INF;
        mx = fmaxf(mx, s[a][b]);
      }
      const float m_new = fmaxf(m[a], row_max16(mx));
      // a row that has seen no visible key yet keeps m = -inf, p = 0
      const bool any = m_new != DSTT_NEG_INF;
      const float alpha = any ? expf(m[a] - m_new) : 1.f;
      float psum = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = any ? expf(s[a][b] - m_new) : 0.f;
        psum += p;
        ps[(ty + 16 * a) * kPStride + tx + 16 * b] = round_to<T>(p);
      }
      l[a] = alpha * l[a] + row_sum16(psum);
      m[a] = m_new;
#pragma unroll
      for (int b = 0; b < C; ++b) acc[a][b] *= alpha;
    }
    __syncthreads();
    mm_pb<D>(ps, vs, tx, ty, acc);
  }

  float inv[kRowsPT];
#pragma unroll
  for (int a = 0; a < kRowsPT; ++a) {
    inv[a] = 1.f / fmaxf(l[a], 1e-30f);
    const int row = q0 + ty + 16 * a;
    if (tx == 0 && row < t_len)
      lse[static_cast<size_t>(blockIdx.y) * t_len + row] = m[a] + logf(l[a]);
  }
  store_rows<T, D>(o + base, q0, t_len, tx, ty, acc, inv);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int group, int t_len, float sm_scale, int causal,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (3 * kTile * Dims<D>::kStride + kTile * kPStride);
  cudaError_t err = allow_smem(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_len + kTile - 1) / kTile, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), t_len, group, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
             int bh, int group, int t_len, int d, float sm_scale, int causal,
             cudaStream_t st) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, lse, bh, group, t_len, sm_scale, causal, st);
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, group, t_len, sm_scale, causal, st);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, group, t_len, sm_scale, causal, st);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, group, t_len, sm_scale, causal, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/o [BH, T, D] and k/v
// [BH / group, T, D] contiguous; lse [BH, T] float32.  D in {16, 32, 64,
// 128}; BH <= 65535 and a multiple of group.
extern "C" int dstt_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int bh, int group, int t_len, int d,
                                        float sm_scale, int causal, int dtype,
                                        void* stream) {
  if (bh < 1 || bh > 65535 || t_len < 1 || group < 1 || bh % group)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, lse, bh, group, t_len, d, sm_scale,
                           causal, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, lse, bh, group, t_len, d,
                                   sm_scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

DSTT_DEFINE_ERROR_STRING(dstt_flash_attention_fwd)

// Block-sparse flash-attention forward (kernel B8) for sm_90a.
//
// Replaces: deepspeed_tpu/ops/sparse_attention/blocksparse_flash.py
//   `_fwd_kernel` (launched by `_fwd`): o = softmax(q k^T * sm_scale) v
//   over the (q, k) pairs of a block layout, per (batch x head), causal
//   or not, with online softmax and f32 accumulators; also writes the
//   per-row logsumexp the backward (kernels B9, B10) reads.  Scores
//   outside the layout, or above the diagonal when causal, take the
//   finite MASK_VALUE (-0.7 f32max), as the TPU kernel does: a row that
//   sees no key in one tile pair and keys in a later one carries finite
//   junk that the first real maximum scales to 0 (-inf would give
//   -inf - -inf = NaN).  Probabilities are rounded to v's dtype before
//   the P.V product; the running sum takes them unrounded.
//
// Bound on the H100: at GPT-2 125M's block-sparse training shape (B.H 96,
//   T 8192, D 64, bf16, FixedSparsityConfig block 64, 4 local + 1 global,
//   unidirectional: 8.81e8 visible pairs) the two products (4 D flops per
//   pair, 225.6 GFLOP) take 0.228 ms on the tensor cores and the least
//   bytes (q, k, v read once, o and lse written once: ~406 MB) 0.121 ms,
//   so the bound is operations.  This first version runs its products
//   on the CUDA cores in f32 (67 TF/s peak), as B1 does; mma/wgmma is the
//   later step.
//
// Design: B1 (csrc/flash_attention_fwd.cu) with another walk.  The TPU
//   kernel's grid (B.H, q blocks, max row nnz) prefetches a compressed
//   index row; here one block of 256 threads owns a 64-row query tile
//   of one head row and walks the kv tiles of its layout row (`idx`,
//   `cnt`), loading only those K/V tiles.  The lists are built on the
//   host at 64-row tile granularity: a layout block of 64 m rows spans
//   m x m tile pairs, and blocks of 16 or 32 share a tile pair whose
//   16-bit sub-block mask (`bits`, bit 4 i + j) the kernel tests per
//   element.  Query tiles launch in `order`, longest walk first.  Head
//   row b reads layout head b % lheads (lheads 1 when every head shares
//   one layout).  Rows at or past T are never loaded.
#include "flash_tiles.cuh"

using namespace dstt;
using namespace dstt::flash;

namespace {

constexpr float kMaskValue = -0.7f * 3.402823466e38f;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bsa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, const int* __restrict__ idx,
               const int* __restrict__ cnt, const int* __restrict__ bits,
               const int* __restrict__ order, int t_len, int lheads,
               int jmax, int sub_shift, float sm_scale, int causal) {
  constexpr int S = Dims<D>::kStride, C = Dims<D>::kColsPT;
  extern __shared__ float smem[];
  float* qs = smem;                 // [64][D + 1]
  float* ks = qs + kTile * S;       // [64][D + 1]
  float* vs = ks + kTile * S;       // [64][D + 1]
  float* ps = vs + kTile * S;       // [64][65] probabilities, rounded to T

  const int n_tiles = (t_len + kTile - 1) / kTile;
  const int qt = order[blockIdx.x];
  const size_t bh = blockIdx.y;
  const size_t base = bh * t_len * D;
  const size_t walk = (bh % lheads) * n_tiles + qt;
  const int* kts = idx + walk * jmax;
  const int* kbits = bits + walk * jmax;
  const int n_walk = cnt[walk];
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

  for (int j = 0; j < n_walk; ++j) {
    const int k0 = kts[j] * kTile;
    const unsigned mask = static_cast<unsigned>(kbits[j]);
    __syncthreads();  // the previous tile's P.V is done with ks/vs/ps
    load_tile<T, D>(k + base, k0, t_len, ks);
    load_tile<T, D>(v + base, k0, t_len, vs);
    __syncthreads();

    float s[kRowsPT][4];
    mm_abt<D>(qs, ks, tx, ty, s);
#pragma unroll
    for (int a = 0; a < kRowsPT; ++a) {
      const int r = ty + 16 * a, row = q0 + r;
      float mx = DSTT_NEG_INF;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = tx + 16 * b, col = k0 + c;
        const bool keep = col < t_len && (!causal || col <= row) &&
                          sub_block_kept(mask, sub_shift, r, c);
        s[a][b] = keep ? s[a][b] * sm_scale : kMaskValue;
        mx = fmaxf(mx, s[a][b]);
      }
      // finite from the first tile on: m_new >= kMaskValue
      const float m_new = fmaxf(m[a], row_max16(mx));
      const float alpha = expf(m[a] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = expf(s[a][b] - m_new);
        psum += p;
        ps[r * kPStride + tx + 16 * b] = round_to<T>(p);
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
    if (tx == 0 && row < t_len) lse[bh * t_len + row] = m[a] + logf(l[a]);
  }
  store_rows<T, D>(o + base, q0, t_len, tx, ty, acc, inv);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const void* idx, const void* cnt, const void* bits,
           const void* order, int bh, int lheads, int t_len, int jmax,
           int sub_shift, float sm_scale, int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (3 * kTile * Dims<D>::kStride + kTile * kPStride);
  cudaError_t err = allow_smem(bsa_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_len + kTile - 1) / kTile, bh);
  bsa_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      static_cast<const int*>(idx), static_cast<const int*>(cnt),
      static_cast<const int*>(bits), static_cast<const int*>(order), t_len,
      lheads, jmax, sub_shift, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
             const void* idx, const void* cnt, const void* bits,
             const void* order, int bh, int lheads, int t_len, int jmax,
             int d, int sub_shift, float sm_scale, int causal,
             cudaStream_t st) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, lse, idx, cnt, bits, order, bh, lheads, t_len, jmax, sub_shift, sm_scale, causal, st);
    case 32: return launch<T, 32>(q, k, v, o, lse, idx, cnt, bits, order, bh, lheads, t_len, jmax, sub_shift, sm_scale, causal, st);
    case 64: return launch<T, 64>(q, k, v, o, lse, idx, cnt, bits, order, bh, lheads, t_len, jmax, sub_shift, sm_scale, causal, st);
    case 128: return launch<T, 128>(q, k, v, o, lse, idx, cnt, bits, order, bh, lheads, t_len, jmax, sub_shift, sm_scale, causal, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/k/v/o [BH, T, D] contiguous; lse
// [BH, T] float32.  The walk (int32, lheads layout heads, n = ceil(T /
// 64) tiles): idx/bits [lheads, n, jmax], cnt [lheads, n], order [n].
// D in {16, 32, 64, 128}; BH <= 65535 and a multiple of lheads;
// sub_shift 4, 5 or 6 (sub-blocks of 16, 32 or 64 rows).
extern "C" int dstt_blocksparse_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* idx, const void* cnt, const void* bits, const void* order,
    int bh, int lheads, int t_len, int jmax, int d, int sub_shift,
    float sm_scale, int causal, int dtype, void* stream) {
  if (bh < 1 || bh > 65535 || t_len < 1 || lheads < 1 || bh % lheads ||
      jmax < 1 || sub_shift < 4 || sub_shift > 6)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, lse, idx, cnt, bits, order, bh, lheads,
                           t_len, jmax, d, sub_shift, sm_scale, causal, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, lse, idx, cnt, bits, order, bh,
                                   lheads, t_len, jmax, d, sub_shift,
                                   sm_scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

DSTT_DEFINE_ERROR_STRING(dstt_blocksparse_flash_fwd)

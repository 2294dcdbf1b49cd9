// Block-sparse flash-attention backward, dq pass (kernel B9) for sm_90a.
//
// Replaces: deepspeed_tpu/ops/sparse_attention/blocksparse_flash.py
//   `_bwd_dq_kernel` (launched by `_bwd`): from the forward's logsumexp
//   and delta = rowsum(dO * O), over the (q, k) pairs of a block layout,
//   with p = exp(q k^T * sm_scale - lse) (0 outside the layout and above
//   the diagonal when causal):
//     ds = p * (dO v^T - delta) * sm_scale,   dq = ds k.
//   ds is rounded to k's dtype before the dq product, as the TPU kernel
//   does; every sum is f32.
//
// Bound on the H100: at GPT-2 125M's block-sparse training shape (B.H 96,
//   T 8192, D 64, bf16, FixedSparsityConfig block 64, 4 local + 1
//   global, unidirectional: 8.81e8 visible pairs) the three products (s,
//   dP, dQ; 6 D flops per pair, 338.4 GFLOP) take 0.342 ms on the tensor
//   cores and the least bytes (q, k, v, dO read, dq written, lse and
//   delta: ~509 MB) 0.152 ms, so the bound is operations.
//
// bf16 design (tensor cores; `bsa_dq_walk` in blocksparse_bwd_mma.cuh):
//   B3's `dq_walk` over a TileList, the kv tiles of the block's layout row
//   (`idx`, `cnt`) in increasing order.  One block of 4 warps per (head
//   row, 64-row query tile); each warp owns 16 query rows and keeps their Q
//   and dO as mma.sync A fragments (read from shared memory at each use at
//   D = 128), the K/V tiles of entry j + 1 load by cp.async into the other
//   stage of a two-stage ring while entry j's products run.  S = Q K^T and
//   dP = dO V^T on m16n8k16, ds packed to bf16 A fragments in registers
//   (the rounding point), dQ += dS K with K by ldmatrix.trans.  The mask
//   runs only on the pairs that need it: the causal diagonal, a tile
//   holding rows at or past T, or a pair whose sub-block mask (`bits`, bit
//   4 i + j for query sub-block i and key sub-block j of 16 or 32 rows) is
//   not full; there an element is kept when the causal, length and
//   sub-block tests pass.  Causal walks leave out the kv tiles past the
//   diagonal (a layout block of 128 rows or more lists them; every element
//   would be masked).  Each dq row is written once, with no atomics, so two
//   launches give the same bits.  Query tiles launch in `order`, longest
//   walk first.
//
// Head dims and blocks: every multiple of 16 up to 256, in bf16 and f16
//   on the tensor cores (the f16 kernel is the bf16 one with the .f16
//   mma.sync and ds packed to f16: ET in flash_mma.cuh) and f32 on the
//   CUDA cores where its tiles fit shared memory; any layout block that
//   is a multiple of 16 (the wrapper passes 16-row sub-block masks for
//   blocks other than 16, 32 and multiples of 64).
//
// f32 design (CUDA cores, kept as it was: the tensor cores would round f32
//   operands to TF32): B3's f32 kernel with the walk of B8, one block of
//   256 threads per (head row, 64-row query tile) keeping Q, dO, lse and
//   delta in shared memory as f32 and testing each element's sub-block
//   bit.
#include "blocksparse_bwd_mma.cuh"
#include "flash_tiles.cuh"

#include <type_traits>

using namespace dstt;
using namespace dstt::flash;

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bsa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq,
                  const int* __restrict__ idx, const int* __restrict__ cnt,
                  const int* __restrict__ bits,
                  const int* __restrict__ order, int t_len, int lheads,
                  int jmax, int sub_shift, float sm_scale, int causal) {
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
  const int qt = order[blockIdx.x], q0 = qt * kTile;
  const size_t bh = blockIdx.y;
  const size_t base = bh * t_len * D;
  const size_t walk = (bh % lheads) * n_tiles + qt;
  const int* kts = idx + walk * jmax;
  const int* kbits = bits + walk * jmax;
  const int n_walk = cnt[walk];
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

  for (int j = 0; j < n_walk; ++j) {
    const int k0 = kts[j] * kTile;
    __syncthreads();  // the previous tile's dQ product is done with ks/dss
    load_tile<T, D>(k + base, k0, t_len, ks);
    load_tile<T, D>(v + base, k0, t_len, vs);
    __syncthreads();
    probs_and_dscores<T, D, true>(qs, dos, ks, vs, lse_s, delta_s, q0, k0,
                                  t_len, sm_scale, causal, tx, ty, nullptr,
                                  dss, static_cast<unsigned>(kbits[j]),
                                  sub_shift);
    __syncthreads();
    mm_pb<D>(dss, ks, tx, ty, dq_acc);
  }
  store_rows<T, D>(dq + base, q0, t_len, tx, ty, dq_acc, one);
}

// shared memory of the CUDA-core kernel: q, dO, k, v tiles, ds, lse and
// delta, f32
template <int D> constexpr size_t f32_smem() {
  return sizeof(float) * (4 * kTile * Dims<D>::kStride + kTile * kPStride + 2 * kTile);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, const void* idx,
           const void* cnt, const void* bits, const void* order, int bh,
           int lheads, int t_len, int jmax, int sub_shift, float sm_scale,
           int causal, cudaStream_t stream) {
  constexpr size_t smem = f32_smem<D>();
  cudaError_t err = allow_smem(bsa_bwd_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_len + kTile - 1) / kTile, bh);
  bsa_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), static_cast<const int*>(idx),
      static_cast<const int*>(cnt), static_cast<const int*>(bits),
      static_cast<const int*>(order), t_len, lheads, jmax, sub_shift,
      sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

namespace tc = dstt::mma;

// The bf16 / f16 tensor-core kernel (see the note at the top): one dq
// walk over a tile list a block; ET is the operands' type.
template <int D, typename ET>
__global__ void __launch_bounds__(tc::kThreads)
bsa_bwd_dq_mma_kernel(const tc::bf16* __restrict__ q,
                      const tc::bf16* __restrict__ k,
                      const tc::bf16* __restrict__ v,
                      const tc::bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      tc::bf16* __restrict__ dq, const int* __restrict__ idx,
                      const int* __restrict__ cnt,
                      const int* __restrict__ bits,
                      const int* __restrict__ order, int t_len, int lheads,
                      int jmax, int sub_shift, float sm_scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_tiles = (t_len + tc::kTile - 1) / tc::kTile;
  const int qt = order[blockIdx.x];
  const size_t bh = blockIdx.y;
  const int row = static_cast<int>(bh % lheads) * n_tiles + qt;
  tc::TileList walk{idx, bits, row * jmax, cnt[row], qt, sub_shift};
  if (causal) walk.drop_after(qt);
  tc::bsa_dq_walk<D, ET>(q, k, v, dout, lse, delta, dq, t_len, sm_scale, causal,
                     bh, walk, smem_raw);
}

template <int D, typename ET>
int launch_mma(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, const void* idx,
               const void* cnt, const void* bits, const void* order, int bh,
               int lheads, int t_len, int jmax, int sub_shift,
               float sm_scale, int causal, cudaStream_t stream) {
  const size_t smem = tc::dq_walk_smem<D>();
  cudaError_t err = allow_smem(bsa_bwd_dq_mma_kernel<D, ET>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_len + tc::kTile - 1) / tc::kTile, bh);
  bsa_bwd_dq_mma_kernel<D, ET><<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<const tc::bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<tc::bf16*>(dq), static_cast<const int*>(idx),
      static_cast<const int*>(cnt), static_cast<const int*>(bits),
      static_cast<const int*>(order), t_len, lheads, jmax, sub_shift,
      sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// f32 to the CUDA-core kernel (where its f32 tiles fit shared memory),
// bf16 and f16 to the tensor-core one
template <typename T, int D>
int launch_route(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, const void* idx, const void* cnt,
                 const void* bits, const void* order, int bh, int lheads,
                 int t_len, int jmax, int sub_shift, float sm_scale,
                 int causal, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value)
    return launch_mma<D, T>(q, k, v, dout, lse, delta, dq, idx, cnt, bits,
                            order, bh, lheads, t_len, jmax, sub_shift,
                            sm_scale, causal, stream);
  else if constexpr (f32_smem<D>() <= kMaxSmem)
    return launch<T, D>(q, k, v, dout, lse, delta, dq, idx, cnt, bits, order,
                        bh, lheads, t_len, jmax, sub_shift, sm_scale, causal,
                        stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, const void* idx,
             const void* cnt, const void* bits, const void* order, int bh,
             int lheads, int t_len, int jmax, int d, int sub_shift,
             float sm_scale, int causal, cudaStream_t st) {
  switch (d) {
#define DSTT_CASE(D)                                                      \
  case D:                                                                 \
    return launch_route<T, D>(q, k, v, dout, lse, delta, dq, idx, cnt, \
                              bits, order, bh, lheads, t_len, jmax, \
                              sub_shift, sm_scale, causal, st);
    DSTT_FLASH_HEAD_DIMS(DSTT_CASE)
#undef DSTT_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  q/k/v/dout/dq [BH, T, D] contiguous;
// lse and delta [BH, T] float32; the walk as in B8 (idx/bits [lheads, n,
// jmax], cnt [lheads, n], order [n], n = ceil(T / 64)).  D a multiple of
// 16 up to 256 (float32: where its tiles fit shared memory); BH <= 65535
// and a multiple of lheads; sub_shift 4, 5 or 6.
extern "C" int dstt_blocksparse_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const void* idx,
    const void* cnt, const void* bits, const void* order, int bh, int lheads,
    int t_len, int jmax, int d, int sub_shift, float sm_scale, int causal,
    int dtype, void* stream) {
  if (bh < 1 || bh > 65535 || t_len < 1 || lheads < 1 || bh % lheads ||
      jmax < 1 || sub_shift < 4 || sub_shift > 6)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, dout, lse, delta, dq, idx, cnt, bits,
                           order, bh, lheads, t_len, jmax, d, sub_shift,
                           sm_scale, causal, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, idx, cnt,
                                   bits, order, bh, lheads, t_len, jmax, d,
                                   sub_shift, sm_scale, causal, st);
  if (dtype == 2)
    return dispatch<__half>(q, k, v, dout, lse, delta, dq, idx, cnt, bits,
                            order, bh, lheads, t_len, jmax, d, sub_shift,
                            sm_scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

DSTT_DEFINE_ERROR_STRING(dstt_blocksparse_flash_bwd_dq)

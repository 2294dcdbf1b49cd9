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
//   so the bound is operations.
//
// Walk: the TPU kernel's grid (B.H, q blocks, max row nnz) prefetches a
//   compressed index row; here one block owns a 64-row query tile of one
//   head row and walks the kv tiles of its layout row (`idx`, `cnt`),
//   loading only those K/V tiles.  The lists are built on the host at
//   64-row tile granularity: a layout block of 64 m rows spans m x m tile
//   pairs, and blocks of 16 or 32 share a tile pair whose 16-bit sub-block
//   mask (`bits`, bit 4 i + j) says which of its sub-blocks the layout
//   holds.  Query tiles launch in `order`, longest walk first.  Head row b
//   reads layout head b % lheads (lheads 1 when every head shares one
//   layout).  Rows at or past T are never loaded.
//
// bf16 design (tensor cores, bsa_fwd_mma_kernel): B1's bf16 forward
//   (flash_attention_fwd.cu) over a TileList (blocksparse_bwd_mma.cuh) in
//   place of a dense range: 4 warps a 64-row query tile, each owning 16
//   query rows as mma.sync A fragments (read from shared memory at each
//   use at D = 128); the K/V tiles of walk entry j + 1 load by cp.async
//   into the other stage of a two-stage ring while entry j's products
//   run; S = Q K^T on m16n8k16 (K by ldmatrix), the online softmax on the
//   fragment rows in base 2 (sm_scale * log2 e folded into one multiply,
//   one ex2.approx a probability), P packed to bf16 A fragments (the
//   rounding point) for O += P V (V by ldmatrix.trans), o = acc / l
//   rounded once, lse = m ln 2 + ln l in f32.  Masks run only on the pairs
//   that need them: on or above the causal diagonal, a kv tile holding
//   rows at or past T, or a pair whose sub-block mask is not full; each
//   warp takes its 16 rows' bits of a pair once as 8-column groups
//   (TileList::dq_columns).  A masked score takes MASK_VALUE in the base-2
//   domain, after the scale: MASK_VALUE itself times log2 e would overflow
//   to -inf, and a row whose first pair is wholly masked would then take
//   -inf - -inf = NaN.  Columns at or past T take -inf (the plain version
//   leaves them out of the softmax).  Every walk is taken whole, pairs
//   above the diagonal included, so a row that sees no key keeps the
//   TPU kernel's finite junk (lse = MASK_VALUE + ln l, as the plain
//   version).  Each output row is written once, with no atomics, so two
//   launches give the same bits.
//
// Head dims and blocks: every multiple of 16 up to 256, in bf16 and f16
//   on the tensor cores (the f16 kernel is the bf16 one with the .f16
//   mma.sync and p packed to f16: ET in flash_mma.cuh) and f32 on the
//   CUDA cores where its tiles fit shared memory; any layout block that
//   is a multiple of 16 (the wrapper passes 16-row sub-block masks for
//   blocks other than 16, 32 and multiples of 64).
//
// f32 design (CUDA cores, kept as it was: the tensor cores would round f32
//   operands to TF32): B1's f32 kernel with this walk, one block of 256
//   threads per 64-row query tile testing each element's sub-block bit.
#include "blocksparse_bwd_mma.cuh"
#include "flash_tiles.cuh"

#include <type_traits>

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

// shared memory of the CUDA-core kernel: q, k, v tiles and p, f32
template <int D> constexpr size_t f32_smem() {
  return sizeof(float) * (3 * kTile * Dims<D>::kStride + kTile * kPStride);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const void* idx, const void* cnt, const void* bits,
           const void* order, int bh, int lheads, int t_len, int jmax,
           int sub_shift, float sm_scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = f32_smem<D>();
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

namespace tc = dstt::mma;

constexpr float kLn2 = 0.6931471805599453f;

// 2^x on the special-function unit (ex2.approx: relative error at most
// 2^-22; 2^-inf = 0), as the bf16 B1 computes its probabilities
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The bf16 / f16 tensor-core kernel (see the note at the top); ET is the
// operands' type.
template <int D, typename ET>
__global__ void __launch_bounds__(tc::kThreads)
bsa_fwd_mma_kernel(const tc::bf16* __restrict__ q,
                   const tc::bf16* __restrict__ k,
                   const tc::bf16* __restrict__ v, tc::bf16* __restrict__ o,
                   float* __restrict__ lse, const int* __restrict__ idx,
                   const int* __restrict__ cnt, const int* __restrict__ bits,
                   const int* __restrict__ order, int t_len, int lheads,
                   int jmax, int sub_shift, float sm_scale, int causal) {
  constexpr int E = tc::Tile<D>::kElems, T64 = tc::kTile;
  constexpr int NT = D / 8;        // C tiles across the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tc::bf16* qs = reinterpret_cast<tc::bf16*>(smem_raw);  // [64][D + 8]
  tc::bf16* kvs = qs + E;  // 2 stages of K then V, [64][D + 8] each

  const int n_tiles = (t_len + T64 - 1) / T64;
  const int qt = order[blockIdx.x], q0 = qt * T64;
  const size_t bh = blockIdx.y;
  const size_t base = bh * t_len * D;
  const int row = (bh % lheads) * n_tiles + qt;
  const tc::TileList walk{idx, bits, row * jmax, cnt[row], qt, sub_shift};
  const int n_walk = walk.n;
  const int m0 = 16 * (threadIdx.x >> 5);  // this warp's rows in the tile
  const float scale2 = sm_scale * tc::kLog2e;

  if (n_walk > 0) {
    tc::load_tile_async<D>(q + base, q0, t_len, qs);
    tc::load_tile_async<D>(k + base, walk.tile(0) * T64, t_len, kvs);
    tc::load_tile_async<D>(v + base, walk.tile(0) * T64, t_len, kvs + E);
  }
  tc::cp_async_commit();

  // running max (scaled, base 2) of rows g and g + 8, this lane's part of
  // their running sums, and the 16 x D output accumulator of the warp
  float m[2] = {DSTT_NEG_INF, DSTT_NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  tc::RowFrags<D, (D <= 64)> qf;

  for (int w = 0; w < n_walk; ++w) {
    if (w + 1 < n_walk) {  // the next tile into the other stage
      tc::bf16* nxt = kvs + ((w + 1) & 1) * 2 * E;
      const int k_next = walk.tile(w + 1) * T64;
      tc::load_tile_async<D>(k + base, k_next, t_len, nxt);
      tc::load_tile_async<D>(v + base, k_next, t_len, nxt + E);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this tile (and, at w 0, Q) landed
    __syncthreads();
    if (w == 0) qf.fill(qs, m0);
    const int kt = walk.tile(w), k0 = kt * T64;
    const unsigned sub = walk.mask(w);
    const tc::bf16* ks = kvs + (w & 1) * 2 * E;
    const tc::bf16* vs = ks + E;

    // S = Q K^T: 16 rows x 64 kv columns a warp
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      qf.get(a, qs, m0, kk);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        tc::load_b_nk<D>(b, ks, 16 * jp, 16 * kk);
        tc::mma_pair<ET>(s[2 * jp], s[2 * jp + 1], a, b);
      }
    }

    // scaled (base 2) scores; masks only on the pairs that need them;
    // the rows' new max over the quad
    const bool edge = (causal && kt >= qt) || k0 + T64 > t_len ||
                      walk.partial(sub);
    const unsigned cols = walk.dq_columns(sub, m0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] *= scale2;
        if (edge) {
          const int r = q0 + m0 + tc::frag_row(i);
          const int c = k0 + 8 * j + tc::frag_col(i);
          if (c >= t_len)
            s[j][i] = DSTT_NEG_INF;
          else if ((causal && c > r) || !((cols >> j) & 1u))
            s[j][i] = kMaskValue;
        }
        mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
      }
    // a pair holds a column below T for every row, so the new max is
    // finite (at least MASK_VALUE) and a first pair's alpha is 2^-inf = 0
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = fast_exp2(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = fast_exp2(s[j][i] - m[i >> 1]);
        l[i >> 1] += s[j][i];  // the unrounded p
      }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] *= alpha[i >> 1];

    // O += P V: p packed to ET A fragments (the rounding point), V by
    // ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < T64 / 16; ++kk) {
      uint32_t a[4];
      tc::c_to_a<ET>(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) {
        uint32_t b[4];
        tc::load_b_kn<D>(b, vs, 16 * kk, 16 * jj);
        tc::mma_pair<ET>(acc[2 * jj], acc[2 * jj + 1], a, b);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  // o = acc / l once, in ET; lse = m ln 2 + ln l in f32 (MASK_VALUE +
  // ln l for a row that saw no key: its max is MASK_VALUE itself)
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.f / fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] *= inv[i >> 1];
  tc::store_acc<D, ET>(o + base, q0 + m0, t_len, acc);
  if ((threadIdx.x & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + m0 + tc::frag_row(2 * h);
      const float mn = m[h] == kMaskValue ? kMaskValue : m[h] * kLn2;
      if (r < t_len) lse[bh * t_len + r] = mn + logf(l[h]);
    }
  }
}

template <int D, typename ET>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               void* lse, const void* idx, const void* cnt, const void* bits,
               const void* order, int bh, int lheads, int t_len, int jmax,
               int sub_shift, float sm_scale, int causal,
               cudaStream_t stream) {
  const size_t smem = sizeof(tc::bf16) * 5 * tc::Tile<D>::kElems;
  cudaError_t err = allow_smem(bsa_fwd_mma_kernel<D, ET>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_len + tc::kTile - 1) / tc::kTile, bh);
  bsa_fwd_mma_kernel<D, ET><<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(o),
      static_cast<float*>(lse), static_cast<const int*>(idx),
      static_cast<const int*>(cnt), static_cast<const int*>(bits),
      static_cast<const int*>(order), t_len, lheads, jmax, sub_shift,
      sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// f32 to the CUDA-core kernel (where its f32 tiles fit shared memory),
// bf16 and f16 to the tensor-core one
template <typename T, int D>
int launch_route(const void* q, const void* k, const void* v, void* o,
                 void* lse, const void* idx, const void* cnt,
                 const void* bits, const void* order, int bh, int lheads,
                 int t_len, int jmax, int sub_shift, float sm_scale,
                 int causal, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value)
    return launch_mma<D, T>(q, k, v, o, lse, idx, cnt, bits, order, bh,
                            lheads, t_len, jmax, sub_shift, sm_scale, causal,
                            stream);
  else if constexpr (f32_smem<D>() <= kMaxSmem)
    return launch<T, D>(q, k, v, o, lse, idx, cnt, bits, order, bh, lheads,
                        t_len, jmax, sub_shift, sm_scale, causal, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
             const void* idx, const void* cnt, const void* bits,
             const void* order, int bh, int lheads, int t_len, int jmax,
             int d, int sub_shift, float sm_scale, int causal,
             cudaStream_t st) {
  switch (d) {
#define DSTT_CASE(D)                                                      \
  case D:                                                                 \
    return launch_route<T, D>(q, k, v, o, lse, idx, cnt, bits, order, \
                              bh, lheads, t_len, jmax, sub_shift, \
                              sm_scale, causal, st);
    DSTT_FLASH_HEAD_DIMS(DSTT_CASE)
#undef DSTT_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  q/k/v/o [BH, T, D]
// contiguous; lse [BH, T] float32.  The walk (int32, lheads layout heads, n = ceil(T /
// 64) tiles): idx/bits [lheads, n, jmax], cnt [lheads, n], order [n].
// D a multiple of 16 up to 256 (float32: where its
// tiles fit shared memory); BH <= 65535 and a multiple of lheads;
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
  if (dtype == 2)
    return dispatch<__half>(q, k, v, o, lse, idx, cnt, bits, order, bh, lheads,
                            t_len, jmax, d, sub_shift, sm_scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

DSTT_DEFINE_ERROR_STRING(dstt_blocksparse_flash_fwd)

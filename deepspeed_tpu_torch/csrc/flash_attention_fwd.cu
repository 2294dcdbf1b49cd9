// FlashAttention-2 forward (kernel B1) for sm_90a.
//
// Replaces: deepspeed_tpu/ops/transformer/flash_attention.py `_fwd_kernel`
//   (launched by `_fwd`): o = softmax(q k^T * sm_scale) v per (batch x
//   head), causal or not, with online softmax and f32 accumulators; also
//   writes the per-row logsumexp the backward (kernels B2, B3, B4)
//   reads.  The probabilities are rounded to v's dtype before the P.V
//   product, as the TPU kernel does (`p.astype(v.dtype)`); the running
//   sum l takes them unrounded.  Grouped-query attention: q/o/lse hold
//   B.H head rows and k/v B.KVH, g = H / KVH; query head row b reads kv
//   head row b / g, the TPU kernel's k/v index map `b // g` (`_fwd`), so
//   k/v are never repeated through memory.  With g = 1 the kernel is the
//   MHA kernel.
//
// Bound on the H100: at GPT-2 125M's training shape (B.H 768, T 1024,
//   D 64, bf16, causal) the least bytes (q, k, v read once, o written
//   once) take 0.12 ms and the causal products about 0.10 ms on the
//   tensor cores, so the bound is bytes; at TinyLlama's (B.H 256, B.KVH
//   32, T 2048, D 64, g 8) the k/v bytes shrink by g and the products
//   (137.5 GFLOP, 0.139 ms) bound it.
//
// bf16 design (tensor cores, on flash_mma.cuh as B3): one block of 4
//   warps per (query head row, 64-row query tile); each warp owns 16
//   query rows and keeps their Q as mma.sync A fragments in registers
//   (read from shared memory at each use at D = 128, where they would
//   spill).  The block walks the 64-row K/V tiles of its kv head (up to
//   the diagonal tile when causal), staged as bf16 by cp.async in a
//   two-stage ring so the next tile's load overlaps this tile's products.
//   Per tile a warp computes S = Q K^T (m16n8k16, K by ldmatrix) into f32
//   fragments, masks them in fragment coordinates on the diagonal and
//   ragged tiles only, and runs the online softmax on the fragment rows
//   in base 2 (sm_scale * log2 e folded into one multiply): a row's max
//   and sum span the 4 lanes of a quad (two xor-shuffles for the max; the
//   sum stays a per-lane partial until the end, since every lane of a row
//   rescales by the same factor).  A row that has seen no visible key yet
//   keeps m = -inf and p = 0.  Each probability is one ex2.approx on the
//   special-function unit: at two products per probability (D = 64) the
//   softmax's instructions, not the tensor cores, set the pace, and the
//   library exp2f, with its extra range handling, made the whole kernel
//   markedly slower on an H100 (PERF.md).  P is packed to bf16 A fragments in
//   registers (the rounding point) for O += P V (V by ldmatrix.trans).
//   At the end o = acc / l is rounded to bf16 once and lse = m ln 2 +
//   ln l (natural log) goes out in f32.  K/V rows at or past T are
//   zero-filled by cp.async and never read; no atomics.  Query tiles
//   launch last-first so the longest causal walks start first.  Two
//   16-row blocks a warp (128-row tiles, 233 registers) and 8 warps over
//   a 128-row tile were both slower on an H100.
//
// Head dims and dtypes: every multiple of 16 up to 256 (the reference
//   takes any head dim; its configurations use 64, 80, 96, 128 and 256),
//   in bf16 and f16 on the tensor cores (the f16 kernel is the bf16 one
//   with the .f16 mma.sync and p/ds packed to f16: ET in flash_mma.cuh),
//   and in f32 on the CUDA cores where the f32 tiles fit shared memory.
//
// f32 design (CUDA cores, kept as it was: the tensor cores would round f32
//   operands to TF32): one block of 256 threads per 64-row query tile
//   walks 64-row K/V tiles through shared memory (f32, odd row stride);
//   each thread keeps 4 query rows x D/16 output columns and the rows'
//   running max and sum in registers; the 16 threads of a row reduce with
//   half-warp shuffles; only the diagonal tile is masked.
#include "flash_mma.cuh"
#include "flash_tiles.cuh"

#include <type_traits>

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

// shared memory of the CUDA-core kernel: q, k, v tiles and p, f32
template <int D> constexpr size_t f32_smem() {
  return sizeof(float) * (3 * kTile * Dims<D>::kStride + kTile * kPStride);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int group, int t_len, float sm_scale, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = f32_smem<D>();
  cudaError_t err = allow_smem(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_len + kTile - 1) / kTile, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), t_len, group, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

namespace tc = dstt::mma;

constexpr float kLn2 = 0.6931471805599453f;

// 2^x on the special-function unit, one instruction (ex2.approx: relative
// error at most 2^-22; results below 2^-126 flush to 0, far under what a
// bf16 probability or the f32 row sum resolves; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The bf16 / f16 tensor-core kernel (see the note at the top); ET is the
// operands' type, the pointers 16-bit storage.
template <int D, typename ET>
__global__ void __launch_bounds__(tc::kThreads)
flash_fwd_mma_kernel(const tc::bf16* __restrict__ q,
                     const tc::bf16* __restrict__ k,
                     const tc::bf16* __restrict__ v,
                     tc::bf16* __restrict__ o, float* __restrict__ lse,
                     int t_len, int group, float sm_scale, int causal) {
  constexpr int E = tc::Tile<D>::kElems, T64 = tc::kTile;
  constexpr int NT = D / 8;        // C tiles across the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tc::bf16* qs = reinterpret_cast<tc::bf16*>(smem_raw);  // [64][D + 8]
  tc::bf16* kvs = qs + E;  // 2 stages of K then V, [64][D + 8] each

  const int n_tiles = (t_len + T64 - 1) / T64;
  const size_t bh = blockIdx.y;
  const size_t base = bh * t_len * D;
  const size_t kv_base = (bh / group) * t_len * D;
  const int qt = n_tiles - 1 - blockIdx.x, q0 = qt * T64;
  const int m0 = 16 * (threadIdx.x >> 5);  // this warp's rows in the tile
  const float scale2 = sm_scale * tc::kLog2e;

  tc::load_tile_async<D>(q + base, q0, t_len, qs);
  tc::load_tile_async<D>(k + kv_base, 0, t_len, kvs);
  tc::load_tile_async<D>(v + kv_base, 0, t_len, kvs + E);
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

  const int last_kt = causal ? qt : n_tiles - 1;
  for (int kt = 0; kt <= last_kt; ++kt) {
    if (kt < last_kt) {  // the next tile into the other stage
      tc::bf16* nxt = kvs + ((kt + 1) & 1) * 2 * E;
      tc::load_tile_async<D>(k + kv_base, (kt + 1) * T64, t_len, nxt);
      tc::load_tile_async<D>(v + kv_base, (kt + 1) * T64, t_len, nxt + E);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this tile (and, at kt 0, Q) landed
    __syncthreads();
    if (kt == 0) qf.fill(qs, m0);
    const tc::bf16* ks = kvs + (kt & 1) * 2 * E;
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

    // scaled (base 2) scores, masked only on the diagonal / ragged tiles;
    // the rows' new max over the quad
    const int k0 = kt * T64;
    const bool edge = (causal && kt == qt) || k0 + T64 > t_len;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] *= scale2;
        if (edge) {
          const int row = q0 + m0 + tc::frag_row(i);
          const int col = k0 + 8 * j + tc::frag_col(i);
          if (col >= t_len || (causal && col > row)) s[j][i] = DSTT_NEG_INF;
        }
        mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
      }
    // a row that has seen no visible key yet keeps m = -inf and p = 0:
    // its scores are all -inf, so it subtracts 0 and 2^-inf = 0
    float alpha[2], sub[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const bool none = mx[h] == DSTT_NEG_INF;
      alpha[h] = none ? 1.f : fast_exp2(m[h] - mx[h]);
      sub[h] = none ? 0.f : mx[h];
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = fast_exp2(s[j][i] - sub[i >> 1]);
        l[i >> 1] += s[j][i];  // the unrounded p
      }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] *= alpha[i >> 1];

    // O += P V: p packed to bf16 A fragments (the rounding point), V by
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

  // o = acc / l once, in bf16; lse = m ln 2 + ln l in f32
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
      const int row = q0 + m0 + tc::frag_row(2 * h);
      if (row < t_len) lse[bh * t_len + row] = m[h] * kLn2 + logf(l[h]);
    }
  }
}

template <int D, typename ET>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               void* lse, int bh, int group, int t_len, float sm_scale,
               int causal, cudaStream_t stream) {
  const size_t smem = sizeof(tc::bf16) * 5 * tc::Tile<D>::kElems;
  cudaError_t err = allow_smem(flash_fwd_mma_kernel<D, ET>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_len + tc::kTile - 1) / tc::kTile, bh);
  flash_fwd_mma_kernel<D, ET><<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(o),
      static_cast<float*>(lse), t_len, group, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// f32 to the CUDA-core kernel (where its f32 tiles fit shared memory),
// bf16 and f16 to the tensor-core one
template <typename T, int D>
int launch_route(const void* q, const void* k, const void* v, void* o,
                 void* lse, int bh, int group, int t_len, float sm_scale,
                 int causal, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value)
    return launch_mma<D, T>(q, k, v, o, lse, bh, group, t_len, sm_scale,
                            causal, stream);
  else if constexpr (f32_smem<D>() <= kMaxSmem)
    return launch<T, D>(q, k, v, o, lse, bh, group, t_len, sm_scale, causal,
                        stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
             int bh, int group, int t_len, int d, float sm_scale, int causal,
             cudaStream_t st) {
  switch (d) {
#define DSTT_CASE(D)                                                      \
  case D:                                                                 \
    return launch_route<T, D>(q, k, v, o, lse, bh, group, t_len, sm_scale, \
                              causal, st);
    DSTT_FLASH_HEAD_DIMS(DSTT_CASE)
#undef DSTT_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  q/o [BH, T, D] and k/v
// [BH / group, T, D] contiguous; lse [BH, T] float32.  D a multiple of 16
// up to 256; BH <= 65535 and a multiple of group.
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
  if (dtype == 2)
    return dispatch<__half>(q, k, v, o, lse, bh, group, t_len, d, sm_scale,
                            causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

DSTT_DEFINE_ERROR_STRING(dstt_flash_attention_fwd)

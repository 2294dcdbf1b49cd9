// Causal chunked-prefill attention through one slot's block table
// (kernel B7) for sm_90a.
//
// Replaces: deepspeed_tpu/ops/transformer/paged_decode_attention.py
//   `_prefill_kernel` (launched by `paged_prefill_attention`) at kv_bits
//   0, 8 and 4: C query tokens at absolute rows base .. base + C - 1 of
//   one slot attend over that slot's pages; rows below `base` are fully
//   visible, the chunk is causal inside (pos <= base + i), nothing at or
//   past base + chunk_len is read (neither rows nor, in a quantized pool,
//   their scales).  Query rows past chunk_len come out finite and are
//   ignored by callers.  A quantized pool holds int8, or packed int4 split
//   by feature, with one f32 scale per row and kv head (`_dequant_rows`).
//
// Bound on the H100: at the serving chunk (C 256 at base 256, H = Hkv
// 32, D 128, bf16) the least bytes are the 512 K and V rows of every kv
// head read once and q and o once: 12.6 MB, 3.8 us at 3.35 TB/s; the
// causal products (4 D per visible (query, key) pair, 1.6 GFLOP) take
// 1.6 us at 989 TF/s.  So the bound is bytes, and a kernel that reads
// each K/V row once per kv head and keeps its products on the tensor
// cores is paced by its loads and the walk's latency.
//
// bf16 design (paged_prefill_mma_kernel, tensor cores; B1's mma.sync
// forward with its K/V tiles gathered through the block table):
//   * one block of 4 warps per (kv head, 64-row query tile): the tile's
//     rows are 64 / G positions x the kv head's G query heads (row r =
//     position i0 + r / G, head kvh * G + r % G), so one K/V tile feeds
//     the whole group (a G that does not divide 64 leaves 64 % G rows
//     of padding, zero queries never written; a G past 64 is split into
//     the fewest parts of G / parts heads, group_parts: the kSplit
//     instantiations); each warp owns 16 rows and keeps their Q as
//     mma.sync A fragments (read from shared memory at each use at D 128,
//     as B1 does, where they would spill).  At the serving chunk that is
//     only 128 blocks; 32-row tiles (2 warps, 256 blocks) were slower on
//     an H100 all the same (0.046 against 0.037 ms, `paged_variants.py`);
//   * 64-row K/V tiles walk the slot's rows from 0 up to the tile's last
//     visible key, min(base + chunk_len, base + last position + 1): each
//     row is D contiguous elements inside a page (stride Hkv D between
//     rows), found by the block's own __ldg of the table, and staged by
//     16-byte cp.async into B1's padded tiles (flash_mma.cuh `Tile`,
//     row stride D + 8) through a two-stage ring; rows at or past the
//     limit are zero-filled, never read;
//   * S = Q K^T and O += P V on mma.sync m16n8k16 with f32 accumulators;
//     the online softmax runs on the fragment rows in base 2 (sm_scale
//     log2 e folded into one multiply, one ex2.approx a probability), the
//     causal limit per row, masks only on tiles that cross a row's limit.
//     The TPU kernel keeps p in f32 through P V, so p goes to the tensor
//     cores as two bf16 parts, hi = p rounded and lo = p - hi rounded
//     (two products, p to 16 bits): rounding p to bf16 once left a rare
//     output outside atol 4e-3 + rtol 8e-3 of the plain version where a
//     few visible rows nearly cancel.  l sums the unrounded p.  Every row
//     sees key 0 in its first tile, so a running max is finite from the
//     first tile on; masked scores are -inf, and B1's guard keeps a row
//     that saw no key at m = -inf, p = 0 (a zero-length chunk at base 0
//     gives zeros);
//   * kv_bits 8 and 4 (KV_BITS stays a template parameter that only the
//     staging reads): the raw rows and their scales move by cp.async
//     through a two-stage ring (only compressed bytes and scales cross
//     device memory); a conversion pass then writes K as bf16 integers
//     (int8 values and int4 nibbles are exact in bf16) and V as
//     bf16(int x scale) rounded to nearest plus its residual rounded
//     toward zero (a third product, against p's high part).  Each score
//     column is multiplied by its row's k scale in f32 before the
//     softmax: the plain version's q . (int x scale) in another order,
//     with no rounding added.  The v scale is not folded into the
//     probabilities: with p = 1 that would round the scale to bf16.  A
//     single fully attended row comes back as bf16(int x scale) exactly:
//     p = 1 splits into 1 and 0, and hi + lo, exact in f32 with |lo|
//     under half an ulp of hi, rounds back to hi;
//   * query tiles launch last-first, so the longest walks start first.
//
// float16 (ET = __half) runs the same kernels: the .f16 mma.sync, p as
// f16 hi + lo, a quantized V as f16(int x scale) to nearest plus its
// residual toward zero (int8 values and int4 nibbles are exact in f16 as
// in bf16), so a single fully attended row comes back exact in f16 too;
// the CUDA-core kernel takes f16 rows by 16-byte loads.
//
// Shape route (by shape, never after a failure): the tensor-core kernel
// takes bf16 and f16 at every multiple of 16 up to 128 (k16 steps over the
// head dim), any G.  The other head dims (multiples of 8 up to 256: D %
// 16 == 8, and above 128), and f32, stay on the CUDA-core kernel below,
// which puts 16 / G positions of a group in its 16 rows the same way.
//
// CUDA-core design (paged_prefill_kernel, the first port): one block per
// (query tile, kv head): 16 query rows staged in shared memory as f32;
// 32-row K/V tiles loaded with 16-byte loads through the block table
// into padded shared memory (row stride D + 1 floats), a quantized pool
// widened to f32 as int x scale while each tile is staged; scores
// lane-per-key, the weighted V sum lane-per-feature, probabilities
// broadcast by warp shuffles; the walk stops at the tile's last visible
// key as above.
#include "flash_mma.cuh"

#include <type_traits>

using namespace dstt;

namespace {

constexpr int kRows = 16;      // query rows (position x head) per block
constexpr int kTk = 32;        // key rows per shared-memory tile
constexpr int kThreads = 128;  // four warps, kRows / 4 query rows each
constexpr int kMaxDpl = 8;     // features per lane: D / 32 <= 8
constexpr int kRowsPerWarp = kRows / (kThreads / 32);

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// element type of a pool row: T unquantized, int8 at 8 and 4 bits
template <typename T, int KV_BITS> struct PoolElem { using type = int8_t; };
template <typename T> struct PoolElem<T, 0> { using type = T; };

// Blocks a kv head's group of g query heads is split into: the fewest
// parts whose heads (g / parts, a divisor of g) fit `rows` query rows.  A
// tile then holds rows / (g / parts) positions of those heads; rows past
// positions x heads are padding, zero queries never written.
inline int group_parts(int g, int rows) {
  int parts = (g + rows - 1) / rows;
  while (g % parts) ++parts;
  return parts;
}

template <typename T, int KV_BITS>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const T* __restrict__ q,
                     const typename PoolElem<T, KV_BITS>::type* __restrict__ pk,
                     const typename PoolElem<T, KV_BITS>::type* __restrict__ pv,
                     const float* __restrict__ kscale,
                     const float* __restrict__ vscale,
                     const int* __restrict__ table, T* __restrict__ o, int C,
                     int H, int Hkv, int D, int parts, int blk, int npages,
                     int base, int chunk_len, float sm_scale) {
  constexpr int N = VecWidth<T>::N;
  extern __shared__ float smem[];
  // this block's gs query heads: part blockIdx.y % parts of kv head
  // blockIdx.y / parts's group, from head h0; rows r < qt * gs are used
  const int gs = H / Hkv / parts;
  const int qt = kRows / gs;  // query positions per block
  const int ks_stride = D + 1;
  float* qs = smem;                  // [kRows][D]
  float* ks = qs + kRows * D;        // [kTk][D + 1]
  float* vs = ks + kTk * ks_stride;  // [kTk][D + 1]
  const int kvh = blockIdx.y / parts;
  const int h0 = kvh * (H / Hkv) + (blockIdx.y % parts) * gs;
  const int i0 = blockIdx.x * qt;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int total = min(base + chunk_len, npages * blk);
  const int kend = min(total, base + min(i0 + qt, C));

  // tile row r = query position i0 + r / gs, head h0 + r % gs
  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, i = i0 + r / gs;
    qs[idx] = i < C && r < qt * gs
                  ? to_float(q[(static_cast<size_t>(i) * H + h0 + r % gs) * D +
                               d])
                  : 0.f;
  }
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kMaxDpl];
  float prob[kRowsPerWarp];
  int qpos[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    m[j] = DSTT_NEG_INF;
    l[j] = 0.f;
    qpos[j] = base + i0 + (warp * kRowsPerWarp + j) / gs;
#pragma unroll
    for (int t = 0; t < kMaxDpl; ++t) acc[j][t] = 0.f;
  }
  const int vec_per_row = D / (KV_BITS ? 8 : N);
  for (int k0 = 0; k0 < kend; k0 += kTk) {
    __syncthreads();  // previous tile consumed; q staged on the first pass
    if constexpr (KV_BITS == 0) {
      for (int idx = tid; idx < kTk * vec_per_row; idx += kThreads) {
        const int j = idx / vec_per_row, c = (idx % vec_per_row) * N;
        const int p = k0 + j;
        float kf[N], vf[N];
        if (p < kend) {
          const size_t bid = __ldg(table + p / blk);
          const size_t off = ((bid * blk + p % blk) * Hkv + kvh) *
                                 static_cast<size_t>(D) + c;
          load_vec(pk + off, kf);
          load_vec(pv + off, vf);
        } else {
#pragma unroll
          for (int e = 0; e < N; ++e) { kf[e] = 0.f; vf[e] = 0.f; }
        }
#pragma unroll
        for (int e = 0; e < N; ++e) {
          ks[j * ks_stride + c + e] = kf[e];
          vs[j * ks_stride + c + e] = vf[e];
        }
      }
    } else {
      const int de = KV_BITS == 8 ? D : D / 2;  // bytes a row
      for (int idx = tid; idx < kTk * vec_per_row; idx += kThreads) {
        const int j = idx / vec_per_row, slice = idx % vec_per_row;
        const int p = k0 + j;
        float kf[8], vf[8];
        if (p < kend) {
          const size_t bid = __ldg(table + p / blk);
          const size_t r = (bid * blk + p % blk) * Hkv + kvh;
          const size_t off = r * de + slice * (KV_BITS == 8 ? 8 : 4);
          load_quant_vec<KV_BITS>(pk + off, __ldg(kscale + r), kf);
          load_quant_vec<KV_BITS>(pv + off, __ldg(vscale + r), vf);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) { kf[e] = 0.f; vf[e] = 0.f; }
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int f = quant_feature<KV_BITS>(slice, e, D);
          ks[j * ks_stride + f] = kf[e];
          vs[j * ks_stride + f] = vf[e];
        }
      }
    }
    __syncthreads();
    const int p = k0 + lane;  // this lane's key in the score pass
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const float* qr = qs + (warp * kRowsPerWarp + j) * D;
      const float* kr = ks + lane * ks_stride;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      s = (p < kend && p <= qpos[j]) ? s * sm_scale : DSTT_NEG_INF;
      const float m_new = fmaxf(m[j], warp_max(s));
      float pj = 0.f, alpha = 1.f;
      if (m_new != DSTT_NEG_INF) {  // warp-uniform
        alpha = expf(m[j] - m_new);
        pj = expf(s - m_new);
        m[j] = m_new;
      }
      l[j] = alpha * l[j] + warp_sum(pj);
      prob[j] = pj;
#pragma unroll
      for (int t = 0; t < kMaxDpl; ++t) acc[j][t] *= alpha;
    }
    for (int jj = 0; jj < kTk; ++jj) {
      float vrow[kMaxDpl];
#pragma unroll
      for (int t = 0; t < kMaxDpl; ++t)
        vrow[t] = lane + 32 * t < D ? vs[jj * ks_stride + lane + 32 * t] : 0.f;
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const float pj = __shfl_sync(0xffffffffu, prob[j], jj);
#pragma unroll
        for (int t = 0; t < kMaxDpl; ++t) acc[j][t] = fmaf(pj, vrow[t], acc[j][t]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = warp * kRowsPerWarp + j, i = i0 + r / gs;
    if (i >= C || r >= qt * gs) continue;
    const float inv = 1.f / fmaxf(l[j], 1e-30f);
    T* dst = o + (static_cast<size_t>(i) * H + h0 + r % gs) * D;
#pragma unroll
    for (int t = 0; t < kMaxDpl; ++t)
      if (lane + 32 * t < D) dst[lane + 32 * t] = from_float<T>(acc[j][t] * inv);
  }
}

template <typename T, int KV_BITS>
int launch(const void* q, const void* pk, const void* pv, const float* ks,
           const float* vs, const void* table, void* o, int C, int H,
           int Hkv, int D, int blk, int npages, int base, int chunk_len,
           float sm_scale, cudaStream_t stream) {
  using P = typename PoolElem<T, KV_BITS>::type;
  const int parts = group_parts(H / Hkv, kRows);
  const int qt = kRows / (H / Hkv / parts);
  const dim3 grid((C + qt - 1) / qt, Hkv * parts);
  const size_t smem = sizeof(float) * (kRows * D + 2 * kTk * (D + 1));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_prefill_kernel<T, KV_BITS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  paged_prefill_kernel<T, KV_BITS><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(pk),
      static_cast<const P*>(pv), ks, vs, static_cast<const int*>(table),
      static_cast<T*>(o), C, H, Hkv, D, parts, blk, npages, base, chunk_len,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// -- bf16 on the tensor cores ---------------------------------------------
namespace tc = dstt::mma;

constexpr int kKv = 64;        // key rows of a K/V tile
constexpr int kMmaWarps = 4;   // warps of a block: 16 query rows each

// 2^x on the special-function unit (ex2.approx: relative error at most
// 2^-22; 2^-inf = 0), as the bf16 B1 computes its probabilities
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// cp.async of N = 8 or 16 bytes, zero-filled (nothing read) when !valid
template <int N>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src,
                                           bool valid) {
  if constexpr (N == 16) {
    tc::cp_async16(dst, src, valid);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     tc::smem_u32(dst)),
                 "l"(src), "n"(N), "r"(valid ? N : 0));
  }
}

// Shared memory of the tensor-core kernel, in bytes: the Q tile, the K/V
// tiles (kv_bits 0: two stages of K then V; quantized: one K tile, the V
// tile as its bf16 high and low parts, the tile's k scales, and two
// stages of raw K rows, raw V rows, k scales and v scales)
template <int D, int KV_BITS, int WARPS> struct MmaSmem {
  static constexpr int kStride = tc::Tile<D>::kStride;
  static constexpr int kTileBytes = kKv * kStride * 2;
  static constexpr int kQBytes = 16 * WARPS * kStride * 2;
  static constexpr int kRowBytes = KV_BITS == 8 ? D : D / 2;  // quantized
  static constexpr int kRawStage = 2 * kKv * kRowBytes + 2 * kKv * 4;
  static constexpr int kBytes =
      KV_BITS == 0 ? kQBytes + 4 * kTileBytes
                   : kQBytes + 3 * kTileBytes + kKv * 4 + 2 * kRawStage;
};

// Four sign-extended ints of a 32-bit word: bytes (int8) or the low or
// high nibbles of its four bytes (packed int4).
template <int KV_BITS>
__device__ __forceinline__ void widen4(unsigned w, bool high,
                                       float (&out)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = KV_BITS == 8
                 ? static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 24)
                 : static_cast<float>(
                       static_cast<int>(w << ((high ? 24 : 28) - 8 * i)) >> 28);
}

template <typename ET>
constexpr bool kHalf = std::is_same<ET, __half>::value;

// The low (first) and high halves of a packed pair of ET, as f32.
template <typename ET>
__device__ __forceinline__ float low_f32(uint32_t x) {
  if constexpr (kHalf<ET>)
    return __half2float(__ushort_as_half(static_cast<unsigned short>(x)));
  else
    return __uint_as_float(x << 16);
}
template <typename ET>
__device__ __forceinline__ float high_f32(uint32_t x) {
  if constexpr (kHalf<ET>)
    return __half2float(
        __ushort_as_half(static_cast<unsigned short>(x >> 16)));
  else
    return __uint_as_float(x & 0xffff0000u);
}

// x rounded toward zero to ET, as its 16 bits.
template <typename ET>
__device__ __forceinline__ unsigned short round_rz(float x) {
  if constexpr (kHalf<ET>)
    return __half_as_ushort(__float2half_rz(x));
  else
    return __bfloat16_as_ushort(__float2bfloat16_rz(x));
}

// Two f32 values x0, x1 rounded to ET (bf16 or __half, to nearest) in one
// register, x0 in the low half, and their residuals x - hi rounded toward
// zero in another: |lo| stays below half an ulp of hi, so hi + lo (exact
// in f32) rounds back to hi, and hi + lo is x to twice ET's bits.
template <typename ET>
__device__ __forceinline__ void split_rz(float x0, float x1, uint32_t& hi,
                                         uint32_t& lo) {
  hi = tc::pack<ET>(x0, x1);
  const unsigned short l0 = round_rz<ET>(x0 - low_f32<ET>(hi));
  const unsigned short l1 = round_rz<ET>(x1 - high_f32<ET>(hi));
  lo = static_cast<uint32_t>(l0) | (static_cast<uint32_t>(l1) << 16);
}

// Eight ints times `scale` as ET high parts (one 16-byte store to hi)
// and, when lo is given, their residuals (one to lo).
template <typename ET>
__device__ __forceinline__ void store8(tc::bf16* hi, tc::bf16* lo,
                                       const float (&a)[4],
                                       const float (&b)[4], float scale) {
  uint4 h, r;
  split_rz<ET>(a[0] * scale, a[1] * scale, h.x, r.x);
  split_rz<ET>(a[2] * scale, a[3] * scale, h.y, r.y);
  split_rz<ET>(b[0] * scale, b[1] * scale, h.z, r.z);
  split_rz<ET>(b[2] * scale, b[3] * scale, h.w, r.w);
  *reinterpret_cast<uint4*>(hi) = h;
  if (lo) *reinterpret_cast<uint4*>(lo) = r;
}

// Two f32 values as ET pairs hi (to nearest) and lo (the residuals, to
// nearest) in mma.sync's operand layout: hi + lo is each value to twice
// ET's bits.
template <typename ET>
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tc::pack<ET>(x0, x1);
  lo = tc::pack<ET>(x0 - low_f32<ET>(hi), x1 - high_f32<ET>(hi));
}

// ET (bf16 or __half) is the queries', outputs' and kv_bits 0 pools'
// type and the products' operand type; 16-bit rows are typed bf16 as
// storage.
template <int D, int KV_BITS, int WARPS, bool kSplit, typename ET>
__global__ void __launch_bounds__(32 * WARPS)
paged_prefill_mma_kernel(
    const tc::bf16* __restrict__ q,
    const typename PoolElem<tc::bf16, KV_BITS>::type* __restrict__ pk,
    const typename PoolElem<tc::bf16, KV_BITS>::type* __restrict__ pv,
    const float* __restrict__ kscale, const float* __restrict__ vscale,
    const int* __restrict__ table, tc::bf16* __restrict__ o, int C, int H,
    int Hkv, int parts, int blk, int base, int chunk_len, float sm_scale) {
  using Sm = MmaSmem<D, KV_BITS, WARPS>;
  constexpr int S = Sm::kStride, QR = 16 * WARPS, NTH = 32 * WARPS;
  constexpr int NT = D / 8;  // C tiles across the head dim
  constexpr int VPR = D / 8; // 16-byte chunks of a bf16 row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tc::bf16* qs = reinterpret_cast<tc::bf16*>(smem_raw);  // [QR][D + 8]
  tc::bf16* kvs = reinterpret_cast<tc::bf16*>(smem_raw + Sm::kQBytes);

  // kSplit (a group that does not divide the tile's rows, or is split
  // into parts): this block's gs query heads are part blockIdx.x % parts
  // of kv head blockIdx.x / parts's group, from head h0, and only rows
  // r < qt * gs are used.  Otherwise gs = G and every row is used: the
  // code the kernel had before groups were split (its registers at D 128,
  // kv_bits 8 sit at an edge where the split's extra live values spill)
  const int G = H / Hkv;
  const int gs = kSplit ? G / parts : G, qt = QR / gs;  // positions a tile
  const int kvh = kSplit ? blockIdx.x / parts : blockIdx.x;
  const int h0 = kSplit ? kvh * G + (blockIdx.x % parts) * gs : 0;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * qt;  // longest walks first
  const int total = base + chunk_len;
  const int kend = min(total, base + min(i0 + qt, C));
  const int nk = (kend + kKv - 1) / kKv;
  const int m0 = 16 * (threadIdx.x >> 5);  // this warp's rows in the tile
  const float scale2 = sm_scale * tc::kLog2e;

  // the tile's query rows, zero past C and past qt * gs
  for (int idx = threadIdx.x; idx < QR * VPR; idx += NTH) {
    const int r = idx / VPR, c = (idx % VPR) * 8;
    const int i = i0 + r / gs;
    const bool ok = i < C && (!kSplit || r < qt * gs);
    const size_t row = !ok ? 0
                       : kSplit ? static_cast<size_t>(i) * H + h0 + r % gs
                                : static_cast<size_t>(i) * H + kvh * G + r % G;
    tc::cp_async16(qs + r * S + c, q + row * D + c, ok);
  }
  // pool row (block-table lookup) of key p < kend, in rows of Hkv heads
  auto pool_row = [&](int p) -> size_t {
    const size_t bid = __ldg(table + p / blk);
    return (bid * blk + p % blk) * Hkv + kvh;
  };
  // kv_bits 0: the tile of keys k0 .. k0 + 63 into stage st
  auto load_kv = [&](int k0, int st) {
    tc::bf16* ks = kvs + st * 2 * kKv * S;
    tc::bf16* vs = ks + kKv * S;
    for (int idx = threadIdx.x; idx < kKv * VPR; idx += NTH) {
      const int r = idx / VPR, c = (idx % VPR) * 8;
      const int p = k0 + r;
      const bool ok = p < kend;
      const size_t off = ok ? pool_row(p) * D + c : 0;
      tc::cp_async16(ks + r * S + c, pk + off, ok);
      tc::cp_async16(vs + r * S + c, pv + off, ok);
    }
  };
  // quantized: raw rows and scales of keys k0 .. k0 + 63 into stage st
  constexpr int RB = Sm::kRowBytes;
  tc::bf16* kts = kvs;                  // K as bf16 integers [64][D + 8]
  tc::bf16* vts = kvs + kKv * S;        // V dequantized: bf16 high parts
  tc::bf16* vlo = vts + kKv * S;        // and their residuals
  float* ksc = reinterpret_cast<float*>(vlo + kKv * S);  // [64] k scales
  unsigned char* raw = reinterpret_cast<unsigned char*>(ksc + kKv);
  auto load_raw = [&](int k0, int st) {
    unsigned char* kr = raw + st * Sm::kRawStage;
    unsigned char* vr = kr + kKv * RB;
    float* sr = reinterpret_cast<float*>(vr + kKv * RB);  // [2][64]
    // copies of CB bytes (the largest of 16 and 8 dividing a raw row)
    constexpr int CB = RB % 16 == 0 ? 16 : 8, RC = RB / CB;
    for (int idx = threadIdx.x; idx < kKv * RC; idx += NTH) {
      const int r = idx / RC, c = (idx % RC) * CB;
      const int p = k0 + r;
      const bool ok = p < kend;
      const size_t off = ok ? pool_row(p) * RB + c : 0;
      cp_async_n<CB>(kr + r * RB + c, pk + off, ok);
      cp_async_n<CB>(vr + r * RB + c, pv + off, ok);
    }
    for (int idx = threadIdx.x; idx < 2 * kKv; idx += NTH) {
      const int r = idx % kKv, p = k0 + r;
      const bool ok = p < kend;
      const size_t row = ok ? pool_row(p) : 0;
      tc::cp_async4(sr + idx, (idx < kKv ? kscale : vscale) + row, ok);
    }
  };
  // quantized: stage st's raw rows into the bf16 K and V tiles, 8 bytes a
  // step (int8: features 8u .. 8u + 7; int4: 8u .. 8u + 7 from the low
  // nibbles and D/2 + 8u .. from the high ones)
  auto convert = [&](int st) {
    const unsigned char* kr = raw + st * Sm::kRawStage;
    const float* sr = reinterpret_cast<const float*>(kr + 2 * kKv * RB);
    constexpr int U = RB / 8;
    for (int idx = threadIdx.x; idx < 2 * kKv * U; idx += NTH) {
      const int which = idx / (kKv * U), rem = idx % (kKv * U);
      const int r = rem / U, u = rem % U;
      const uint2 w = *reinterpret_cast<const uint2*>(kr + which * kKv * RB +
                                                      r * RB + 8 * u);
      const float sc = which ? sr[kKv + r] : 1.f;
      tc::bf16* dst = (which ? vts : kts) + r * S;
      tc::bf16* res = which ? vlo + r * S : nullptr;  // K is exact
      float a[4], b[4];
      if constexpr (KV_BITS == 8) {
        widen4<8>(w.x, false, a);
        widen4<8>(w.y, false, b);
        store8<ET>(dst + 8 * u, res ? res + 8 * u : nullptr, a, b, sc);
      } else {
        widen4<4>(w.x, false, a);
        widen4<4>(w.y, false, b);
        store8<ET>(dst + 8 * u, res ? res + 8 * u : nullptr, a, b, sc);
        widen4<4>(w.x, true, a);
        widen4<4>(w.y, true, b);
        store8<ET>(dst + D / 2 + 8 * u, res ? res + D / 2 + 8 * u : nullptr,
                    a, b, sc);
      }
    }
    for (int r = threadIdx.x; r < kKv; r += NTH) ksc[r] = sr[r];
  };

  if constexpr (KV_BITS == 0) load_kv(0, 0); else load_raw(0, 0);
  tc::cp_async_commit();

  // this lane's two rows (g and g + 8 of the warp's 16): their last
  // visible key, and the running max (scaled, base 2) and sum
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    lim[h] = min(base + i0 + (m0 + tc::frag_row(2 * h)) / gs, total - 1);
  const int lim_lo = min(base + i0, total - 1);  // the tile's lowest limit
  float m[2] = {DSTT_NEG_INF, DSTT_NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  tc::RowFrags<D, (D <= 64)> qf;

  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {  // the next tile into the other stage
      if constexpr (KV_BITS == 0) load_kv((kt + 1) * kKv, (kt + 1) & 1);
      else load_raw((kt + 1) * kKv, (kt + 1) & 1);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this tile (and, at kt 0, Q) landed
    __syncthreads();
    const tc::bf16* ks;
    const tc::bf16* vs;
    if constexpr (KV_BITS == 0) {
      ks = kvs + (kt & 1) * 2 * kKv * S;
      vs = ks + kKv * S;
    } else {
      convert(kt & 1);
      __syncthreads();
      ks = kts;
      vs = vts;
    }
    if (kt == 0) qf.fill(qs, m0);

    // S = Q K^T: 16 rows x 64 keys a warp
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

    // scaled (base 2; times the key's k scale when quantized) scores,
    // masked only where the tile crosses a row's limit; the rows' new
    // max over the quad
    const int k0 = kt * kKv;
    const bool edge = k0 + kKv - 1 > lim_lo;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 8 * j + tc::frag_col(i);
        float f = scale2;
        if constexpr (KV_BITS != 0) f *= ksc[col];
        s[j][i] *= f;
        if (edge && k0 + col > lim[i >> 1]) s[j][i] = DSTT_NEG_INF;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
      }
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

    // O += P V with p as bf16 high and low parts (two products: p keeps
    // 16 bits, as the plain version's f32 p nearly does); a quantized V
    // adds its residual tile against p's high part.  V by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kKv / 16; ++kk) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        split_pair<ET>(s[2 * kk][2 * i], s[2 * kk][2 * i + 1], ah[i], al[i]);
        split_pair<ET>(s[2 * kk + 1][2 * i], s[2 * kk + 1][2 * i + 1],
                   ah[2 + i], al[2 + i]);
      }
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) {
        uint32_t b[4];
        tc::load_b_kn<D>(b, vs, 16 * kk, 16 * jj);
        tc::mma_pair<ET>(acc[2 * jj], acc[2 * jj + 1], ah, b);
        tc::mma_pair<ET>(acc[2 * jj], acc[2 * jj + 1], al, b);
        if constexpr (KV_BITS != 0) {
          tc::load_b_kn<D>(b, vlo, 16 * kk, 16 * jj);
          tc::mma_pair<ET>(acc[2 * jj], acc[2 * jj + 1], ah, b);
        }
      }
    }
    // kv_bits 0: every warp is done with this stage before it is
    // refilled; quantized: the next conversion waits at the loop's top
    if constexpr (KV_BITS == 0) __syncthreads();
  }
  tc::cp_async_wait<0>();

  // o = acc / l once, in bf16, rows past C left out
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    const int r = m0 + tc::frag_row(2 * h), i = i0 + r / gs;
    if (i >= C || (kSplit && r >= qt * gs)) continue;
    tc::bf16* out = o + (kSplit ? static_cast<size_t>(i) * H + h0 + r % gs
                                : static_cast<size_t>(i) * H + kvh * G + r % G) *
                            D +
                    tc::frag_col(0);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          tc::pack<ET>(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
  }
}

template <int D, int KV_BITS, typename ET>
int launch_mma(const void* q, const void* pk, const void* pv, const float* ks,
               const float* vs, const void* table, void* o, int C, int H,
               int Hkv, int blk, int base, int chunk_len, float sm_scale,
               cudaStream_t stream) {
  using P = typename PoolElem<tc::bf16, KV_BITS>::type;
  constexpr int W = kMmaWarps;
  const int parts = group_parts(H / Hkv, 16 * W);
  const bool split = parts > 1 || (16 * W) % (H / Hkv);
  auto kernel = split ? paged_prefill_mma_kernel<D, KV_BITS, W, true, ET>
                      : paged_prefill_mma_kernel<D, KV_BITS, W, false, ET>;
  const int smem = MmaSmem<D, KV_BITS, W>::kBytes;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int qt = 16 * W / (H / Hkv / parts);
  const dim3 grid(Hkv * parts, (C + qt - 1) / qt);
  kernel<<<grid, 32 * W, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const P*>(pk),
      static_cast<const P*>(pv), ks, vs, static_cast<const int*>(table),
      static_cast<tc::bf16*>(o), C, H, Hkv, parts, blk, base, chunk_len,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// bf16 and f16 (ET) at the multiples of 16 up to 128 to the tensor-core
// kernel; every other shape (D % 16 == 8, D > 128), and f32, to the
// CUDA-core one
template <int KV_BITS, typename ET>
int launch_16(const void* q, const void* pk, const void* pv,
                const float* ks, const float* vs, const void* table, void* o,
                int C, int H, int Hkv, int D, int blk, int npages, int base,
                int chunk_len, float sm_scale, cudaStream_t st) {
  switch (D) {
#define DSTT_CASE(DD)                                                     \
  case DD:                                                                \
    return launch_mma<DD, KV_BITS, ET>(q, pk, pv, ks, vs, table, o, C, H,  \
                                       Hkv, blk, base, chunk_len, sm_scale, \
                                       st);
    DSTT_CASE(16) DSTT_CASE(32) DSTT_CASE(48) DSTT_CASE(64) DSTT_CASE(80)
    DSTT_CASE(96) DSTT_CASE(112) DSTT_CASE(128)
#undef DSTT_CASE
  }
  return launch<ET, KV_BITS>(q, pk, pv, ks, vs, table, o, C, H, Hkv, D, blk,
                             npages, base, chunk_len, sm_scale, st);
}

template <int KV_BITS>
int launch_dtype(const void* q, const void* pk, const void* pv,
                 const float* ks, const float* vs, const void* table,
                 void* o, int C, int H, int Hkv, int D, int blk, int npages,
                 int base, int chunk_len, float sm_scale, int dtype,
                 cudaStream_t st) {
  if (dtype == 0)
    return launch<float, KV_BITS>(q, pk, pv, ks, vs, table, o, C, H, Hkv, D,
                                  blk, npages, base, chunk_len, sm_scale, st);
  if (dtype == 1)
    return launch_16<KV_BITS, tc::bf16>(q, pk, pv, ks, vs, table, o, C, H,
                                        Hkv, D, blk, npages, base, chunk_len,
                                        sm_scale, st);
  if (dtype == 2)
    return launch_16<KV_BITS, __half>(q, pk, pv, ks, vs, table, o, C, H, Hkv,
                                      D, blk, npages, base, chunk_len,
                                      sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool bad_shape(int C, int H, int Hkv, int D) {
  return D < 8 || D % 8 || D > 32 * kMaxDpl || Hkv < 1 || H % Hkv || C < 1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  q/o [C, H, D]; pools
// [num_blocks, blk, Hkv, D]; table [npages] int32.  Needs D a multiple of
// 8 up to 256 and H a multiple of Hkv (a group larger than a tile's rows
// is split across blocks: group_parts).
extern "C" int dstt_paged_prefill_attention(
    const void* q, const void* pk, const void* pv, const void* table,
    void* o, int C, int H, int Hkv, int D, int blk, int npages, int base,
    int chunk_len, float sm_scale, int dtype, void* stream) {
  if (bad_shape(C, H, Hkv, D)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dtype<0>(q, pk, pv, nullptr, nullptr, table, o, C, H, Hkv, D,
                         blk, npages, base, chunk_len, sm_scale, dtype,
                         static_cast<cudaStream_t>(stream));
}

// The quantized pools: kv_bits 8 (int8 pools [num_blocks, blk, Hkv, D]) or
// 4 (packed int4, [num_blocks, blk, Hkv, D / 2] int8), scales
// [num_blocks, blk, Hkv] f32; the rest as above.
extern "C" int dstt_paged_prefill_attention_quant(
    const void* q, const void* pk, const void* pv, const void* k_scale,
    const void* v_scale, const void* table, void* o, int C, int H, int Hkv,
    int D, int blk, int npages, int base, int chunk_len, float sm_scale,
    int dtype, int kv_bits, void* stream) {
  if (bad_shape(C, H, Hkv, D)) return static_cast<int>(cudaErrorInvalidValue);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_bits == 8)
    return launch_dtype<8>(q, pk, pv, ks, vs, table, o, C, H, Hkv, D, blk,
                           npages, base, chunk_len, sm_scale, dtype, st);
  if (kv_bits == 4)
    return launch_dtype<4>(q, pk, pv, ks, vs, table, o, C, H, Hkv, D, blk,
                           npages, base, chunk_len, sm_scale, dtype, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

DSTT_DEFINE_ERROR_STRING(dstt_paged_prefill_attention)

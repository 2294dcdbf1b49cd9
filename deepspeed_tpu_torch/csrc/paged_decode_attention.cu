// Batched paged decode attention (kernel B6) for sm_90a.
//
// Replaces: deepspeed_tpu/ops/transformer/paged_decode_attention.py
//   `_decode_kernel` (launched by `paged_decode_attention`) at kv_bits 0,
//   8 and 4: one new query token per slot attends over that slot's KV
//   pages, found through its row of the block table, up to the slot's
//   own length; GQA query groups read their kv head once.  At kv_bits 8
//   or 4 the pools hold int8 or packed-int4 rows with one f32 scale per
//   (row, kv head), and each row is widened to f32 as int x scale inside
//   the kernel (`_dequant_rows`): only the compressed bytes and the
//   scales cross device memory.
//
// Bound on the H100: device-memory bytes.  Every slot reads its K and V
// rows (length * Hkv * row bytes each, row bytes D * sizeof(T), or D / D/2
// bytes + a 4-byte scale when quantized) once and does 4 * G * D flops
// per row pair, so the least time is those bytes / 3.35 TB/s.
//
// Design against that bound:
//   * one block per (kv head, slot); the TPU grid's sequential page-group
//     axis becomes a loop inside the block: four warps interleave over
//     the slot's positions, each warp split into row groups of D / N
//     lanes (N features a lane: 16 bytes of T, or 8 features of a
//     quantized row: 8 bytes of int8 or 4 bytes of int4, so all three
//     widths keep the bf16 geometry of 16 lanes a row at D = 128), each
//     lane holding 2 * 4 row loads in flight;
//   * the block reads its own block-table entries and walks only the
//     positions below its length: pages past it, their scales, and
//     inactive slots (length 0), cost no traffic and give all-zero rows;
//   * the G query heads of a kv head share every K/V load (GQA at
//     kv-head width), their (m, l, acc) in registers; the four warps'
//     states merge once through shared memory at the end;
//   * kv_bits is a template parameter: the kv_bits 0 instantiation is the
//     unquantized kernel with nothing added.  A packed-int4 lane holds
//     features j .. j + 3 and j + D/2 .. j + D/2 + 3 (the pool's split by
//     feature), and its q slice and its share of the output follow.
#include "attention_common.cuh"

using namespace dstt;

namespace {

constexpr int kWarps = 4;
constexpr int kUnroll = 4;
constexpr int kMaxD = 256;

// element type of a pool row: T unquantized, int8 at 8 and 4 bits
template <typename T, int KV_BITS> struct PoolElem { using type = int8_t; };
template <typename T> struct PoolElem<T, 0> { using type = T; };

template <typename T, int G, int KV_BITS>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q,
                    const typename PoolElem<T, KV_BITS>::type* __restrict__ pk,
                    const typename PoolElem<T, KV_BITS>::type* __restrict__ pv,
                    const float* __restrict__ kscale,
                    const float* __restrict__ vscale,
                    const int* __restrict__ lengths,
                    const int* __restrict__ tables, T* __restrict__ o, int H,
                    int Hkv, int D, int blk, int npages, float sm_scale) {
  constexpr int N = KV_BITS ? 8 : VecWidth<T>::N;
  __shared__ float sm_ml[kWarps][G][2];
  __shared__ float sm_acc[kWarps][G][kMaxD];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int lpr = D / N;
  const int rpw = 32 / lpr;  // key rows per warp per step
  const int row_in_warp = lane / lpr;
  const int lane_off = (lane % lpr) * N;
  const int len = max(0, min(lengths[b], npages * blk));
  const size_t qrow = static_cast<size_t>(b) * H + kvh * G;

  float qf[G][N], m[G], l[G], acc[G][N];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if constexpr (KV_BITS == 0) {
      load_vec(q + (qrow + g) * D + lane_off, qf[g]);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i)
        qf[g][i] = to_float(
            q[(qrow + g) * D + quant_feature<KV_BITS>(lane % lpr, i, D)]);
    }
    m[g] = DSTT_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) acc[g][i] = 0.f;
  }
  const int* table = tables + static_cast<size_t>(b) * npages;
  if constexpr (KV_BITS == 0) {
    auto row = [=](int p) {
      const size_t bid = __ldg(table + p / blk);
      return ((bid * blk + p % blk) * Hkv + kvh) * static_cast<size_t>(D);
    };
    attend_rows<T, G, kUnroll>(qf, pk, pv, row, lane_off, lpr, warp * rpw,
                               row_in_warp, len, kWarps * rpw, sm_scale, m,
                               l, acc);
  } else {
    // a row is De bytes; this lane's slice starts (lane % lpr) * 8 (int8)
    // or * 4 (int4) bytes in
    const int de = KV_BITS == 8 ? D : D / 2;
    const int byte_off = (lane % lpr) * (KV_BITS == 8 ? 8 : 4);
    auto load_row = [=](int p, float (&kf)[N], float (&vf)[N]) {
      const size_t bid = __ldg(table + p / blk);
      const size_t r = (bid * blk + p % blk) * Hkv + kvh;
      const size_t off = r * de + byte_off;
      load_quant_vec<KV_BITS>(pk + off, __ldg(kscale + r), kf);
      load_quant_vec<KV_BITS>(pv + off, __ldg(vscale + r), vf);
    };
    attend_rows_with<G, N, kUnroll>(qf, load_row, lpr, warp * rpw,
                                    row_in_warp, len, kWarps * rpw,
                                    sm_scale, m, l, acc);
  }
  warp_merge_groups<G, N>(m, l, acc, lpr);
  if (row_in_warp == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lane == 0) {
        sm_ml[warp][g][0] = m[g];
        sm_ml[warp][g][1] = l[g];
      }
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int f = KV_BITS ? quant_feature<KV_BITS>(lane % lpr, i, D)
                              : lane_off + i;
        sm_acc[warp][g][f] = acc[g][i];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D;
    float mx = DSTT_NEG_INF;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_ml[w][g][0]);
    float num = 0.f, den = 0.f;
    if (mx != DSTT_NEG_INF) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float wt = expf(sm_ml[w][g][0] - mx);
        num = fmaf(wt, sm_acc[w][g][d], num);
        den = fmaf(wt, sm_ml[w][g][1], den);
      }
    }
    o[(qrow + g) * D + d] = from_float<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int G, int KV_BITS>
int launch_g(const void* q, const void* pk, const void* pv, const float* ks,
             const float* vs, const void* lengths, const void* tables,
             void* o, int B, int H, int Hkv, int D, int blk, int npages,
             float sm_scale, cudaStream_t stream) {
  using P = typename PoolElem<T, KV_BITS>::type;
  const dim3 grid(Hkv, B);
  paged_decode_kernel<T, G, KV_BITS><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(pk),
      static_cast<const P*>(pv), ks, vs, static_cast<const int*>(lengths),
      static_cast<const int*>(tables), static_cast<T*>(o), H, Hkv, D, blk,
      npages, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KV_BITS>
int launch(const void* q, const void* pk, const void* pv, const float* ks,
           const float* vs, const void* lengths, const void* tables, void* o,
           int B, int H, int Hkv, int D, int blk, int npages, float sm_scale,
           cudaStream_t stream) {
  switch (H / Hkv) {
#define DSTT_CASE(g)                                                       \
  case g:                                                                  \
    return launch_g<T, g, KV_BITS>(q, pk, pv, ks, vs, lengths, tables, o,  \
                                   B, H, Hkv, D, blk, npages, sm_scale,    \
                                   stream);
    DSTT_CASE(1)
    DSTT_CASE(2)
    DSTT_CASE(4)
    DSTT_CASE(8)
#undef DSTT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int KV_BITS>
int launch_dtype(const void* q, const void* pk, const void* pv,
                 const float* ks, const float* vs, const void* lengths,
                 const void* tables, void* o, int B, int H, int Hkv, int D,
                 int blk, int npages, float sm_scale, int dtype,
                 cudaStream_t st) {
  if (dtype == 0)
    return launch<float, KV_BITS>(q, pk, pv, ks, vs, lengths, tables, o, B,
                                  H, Hkv, D, blk, npages, sm_scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, KV_BITS>(q, pk, pv, ks, vs, lengths,
                                          tables, o, B, H, Hkv, D, blk,
                                          npages, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/o [B, H, D]; pools
// [num_blocks, blk, Hkv, D]; lengths [B] int32; tables [B, npages] int32.
extern "C" int dstt_paged_decode_attention(
    const void* q, const void* pk, const void* pv, const void* lengths,
    const void* tables, void* o, int B, int H, int Hkv, int D, int blk,
    int npages, float sm_scale, int dtype, void* stream) {
  if (D > kMaxD || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dtype<0>(q, pk, pv, nullptr, nullptr, lengths, tables, o, B,
                         H, Hkv, D, blk, npages, sm_scale, dtype,
                         static_cast<cudaStream_t>(stream));
}

// The quantized pools: kv_bits 8 (int8 pools [num_blocks, blk, Hkv, D]) or
// 4 (packed int4, [num_blocks, blk, Hkv, D / 2] int8), scales
// [num_blocks, blk, Hkv] f32; q and o as above, in dtype.  Needs D a
// multiple of 8 and at most 256 (D / 8 lanes a row).
extern "C" int dstt_paged_decode_attention_quant(
    const void* q, const void* pk, const void* pv, const void* k_scale,
    const void* v_scale, const void* lengths, const void* tables, void* o,
    int B, int H, int Hkv, int D, int blk, int npages, float sm_scale,
    int dtype, int kv_bits, void* stream) {
  if (D > kMaxD || D % 8 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_bits == 8)
    return launch_dtype<8>(q, pk, pv, ks, vs, lengths, tables, o, B, H, Hkv,
                           D, blk, npages, sm_scale, dtype, st);
  if (kv_bits == 4)
    return launch_dtype<4>(q, pk, pv, ks, vs, lengths, tables, o, B, H, Hkv,
                           D, blk, npages, sm_scale, dtype, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

DSTT_DEFINE_ERROR_STRING(dstt_paged_decode_attention)

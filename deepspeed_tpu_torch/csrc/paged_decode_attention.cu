// Batched paged decode attention (kernel B6) for sm_90a.
//
// Replaces: deepspeed_tpu/ops/transformer/paged_decode_attention.py
//   `_decode_kernel` (launched by `paged_decode_attention`) with
//   kv_bits = 0: one new query token per slot attends over that slot's
//   KV pages, found through its row of the block table, up to the slot's
//   own length; GQA query groups read their kv head once.
//
// Bound on the H100: device-memory bytes.  Every slot reads its K and V
// rows (length * Hkv * D elements each) once and does 4 * G * D flops
// per row pair, so the least time is (K + V bytes below each slot's
// length) / 3.35 TB/s.
//
// Design against that bound:
//   * one block per (kv head, slot); the TPU grid's sequential page-group
//     axis becomes a loop inside the block: four warps interleave over
//     the slot's positions, each warp split into row groups of
//     D*sizeof(T)/16 lanes, each lane holding 2 * 4 16-byte loads in
//     flight;
//   * the block reads its own block-table entries and walks only the
//     positions below its length: pages past it, and inactive slots
//     (length 0), cost no traffic and give all-zero rows;
//   * the G query heads of a kv head share every K/V load (GQA at
//     kv-head width), their (m, l, acc) in registers; the four warps'
//     states merge once through shared memory at the end.
#include "attention_common.cuh"

using namespace dstt;

namespace {

constexpr int kWarps = 4;
constexpr int kUnroll = 4;
constexpr int kMaxD = 256;

template <typename T, int G>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pk,
                    const T* __restrict__ pv, const int* __restrict__ lengths,
                    const int* __restrict__ tables, T* __restrict__ o, int H,
                    int Hkv, int D, int blk, int npages, float sm_scale) {
  constexpr int N = VecWidth<T>::N;
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
    load_vec(q + (qrow + g) * D + lane_off, qf[g]);
    m[g] = DSTT_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) acc[g][i] = 0.f;
  }
  const int* table = tables + static_cast<size_t>(b) * npages;
  auto row = [=](int p) {
    const size_t bid = __ldg(table + p / blk);
    return ((bid * blk + p % blk) * Hkv + kvh) * static_cast<size_t>(D);
  };
  attend_rows<T, G, kUnroll>(qf, pk, pv, row, lane_off, lpr, warp * rpw,
                             row_in_warp, len, kWarps * rpw, sm_scale, m, l,
                             acc);
  warp_merge_groups<G, N>(m, l, acc, lpr);
  if (row_in_warp == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lane == 0) {
        sm_ml[warp][g][0] = m[g];
        sm_ml[warp][g][1] = l[g];
      }
#pragma unroll
      for (int i = 0; i < N; ++i) sm_acc[warp][g][lane_off + i] = acc[g][i];
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

template <typename T, int G>
int launch_g(const void* q, const void* pk, const void* pv,
             const void* lengths, const void* tables, void* o, int B, int H,
             int Hkv, int D, int blk, int npages, float sm_scale,
             cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  paged_decode_kernel<T, G><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), static_cast<const int*>(lengths),
      static_cast<const int*>(tables), static_cast<T*>(o), H, Hkv, D, blk,
      npages, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* pk, const void* pv,
           const void* lengths, const void* tables, void* o, int B, int H,
           int Hkv, int D, int blk, int npages, float sm_scale,
           cudaStream_t stream) {
  switch (H / Hkv) {
    case 1: return launch_g<T, 1>(q, pk, pv, lengths, tables, o, B, H, Hkv,
                                  D, blk, npages, sm_scale, stream);
    case 2: return launch_g<T, 2>(q, pk, pv, lengths, tables, o, B, H, Hkv,
                                  D, blk, npages, sm_scale, stream);
    case 4: return launch_g<T, 4>(q, pk, pv, lengths, tables, o, B, H, Hkv,
                                  D, blk, npages, sm_scale, stream);
    case 8: return launch_g<T, 8>(q, pk, pv, lengths, tables, o, B, H, Hkv,
                                  D, blk, npages, sm_scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/o [B, H, D]; pools
// [num_blocks, blk, Hkv, D]; lengths [B] int32; tables [B, npages] int32.
extern "C" int dstt_paged_decode_attention(
    const void* q, const void* pk, const void* pv, const void* lengths,
    const void* tables, void* o, int B, int H, int Hkv, int D, int blk,
    int npages, float sm_scale, int dtype, void* stream) {
  if (D > kMaxD || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, pk, pv, lengths, tables, o, B, H, Hkv, D, blk,
                         npages, sm_scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, pk, pv, lengths, tables, o, B, H, Hkv, D,
                                 blk, npages, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

DSTT_DEFINE_ERROR_STRING(dstt_paged_decode_attention)

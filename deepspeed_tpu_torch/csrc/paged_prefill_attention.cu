// Causal chunked-prefill attention through one slot's block table
// (kernel B7) for sm_90a.
//
// Replaces: deepspeed_tpu/ops/transformer/paged_decode_attention.py
//   `_prefill_kernel` (launched by `paged_prefill_attention`) with
//   kv_bits = 0: C query tokens at absolute rows base .. base + C - 1 of
//   one slot attend over that slot's pages; rows below `base` are fully
//   visible, the chunk is causal inside (pos <= base + i), nothing at or
//   past base + chunk_len is read.  Query rows past chunk_len come out
//   finite and are ignored by callers.
//
// Bound on the H100: device-memory bytes at the tensor-core rate.  The
// K and V rows below base + chunk_len are read once per kv head (the
// least bytes); the flops, 4 * D per visible (query, key) pair, sit near
// the bf16 ridge at chunk 256.  This first version does its products
// on the CUDA cores in f32, so at full chunks it is bound by those
// operations rather than by bytes; moving the two products onto
// mma/wgmma is the later step.
//
// Design:
//   * one block per (query tile, kv head): 16 query rows (positions x
//     the kv head's G query heads) staged in shared memory as f32;
//   * the TPU grid's sequential page-group axis becomes a loop over
//     32-row K/V tiles, each loaded with 16-byte loads through the block
//     table into padded shared memory (row stride D + 1 floats, so the
//     score pass reads it without bank conflicts);
//   * the walk stops at the tile's last visible key, min(base +
//     chunk_len, base + last query of the tile + 1): rows past it are
//     never read (the NaN-safety rule), and later tiles of a long chunk
//     read more keys than earlier ones, exactly the causal triangle;
//   * online softmax per query row in registers: scores lane-per-key,
//     the weighted V sum lane-per-feature, probabilities broadcast by
//     warp shuffles.
#include "attention_common.cuh"

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ pk,
                     const T* __restrict__ pv, const int* __restrict__ table,
                     T* __restrict__ o, int C, int H, int Hkv, int D,
                     int blk, int npages, int base, int chunk_len,
                     float sm_scale) {
  constexpr int N = VecWidth<T>::N;
  extern __shared__ float smem[];
  const int G = H / Hkv;
  const int qt = kRows / G;  // query positions per block
  const int ks_stride = D + 1;
  float* qs = smem;                  // [kRows][D]
  float* ks = qs + kRows * D;        // [kTk][D + 1]
  float* vs = ks + kTk * ks_stride;  // [kTk][D + 1]
  const int kvh = blockIdx.y;
  const int i0 = blockIdx.x * qt;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int total = min(base + chunk_len, npages * blk);
  const int kend = min(total, base + min(i0 + qt, C));
  const int dpl = D / 32;

  // tile row r = query position i0 + r / G, head kvh * G + r % G
  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, i = i0 + r / G;
    qs[idx] = i < C ? to_float(q[(static_cast<size_t>(i) * H + kvh * G +
                                  r % G) * D + d])
                    : 0.f;
  }
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kMaxDpl];
  float prob[kRowsPerWarp];
  int qpos[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    m[j] = DSTT_NEG_INF;
    l[j] = 0.f;
    qpos[j] = base + i0 + (warp * kRowsPerWarp + j) / G;
#pragma unroll
    for (int t = 0; t < kMaxDpl; ++t) acc[j][t] = 0.f;
  }
  const int vec_per_row = D / N;
  for (int k0 = 0; k0 < kend; k0 += kTk) {
    __syncthreads();  // previous tile consumed; q staged on the first pass
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
        vrow[t] = t < dpl ? vs[jj * ks_stride + lane + 32 * t] : 0.f;
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
    const int r = warp * kRowsPerWarp + j, i = i0 + r / G;
    if (i >= C) continue;
    const float inv = 1.f / fmaxf(l[j], 1e-30f);
    T* dst = o + (static_cast<size_t>(i) * H + kvh * G + r % G) * D;
#pragma unroll
    for (int t = 0; t < kMaxDpl; ++t)
      if (t < dpl) dst[lane + 32 * t] = from_float<T>(acc[j][t] * inv);
  }
}

template <typename T>
int launch(const void* q, const void* pk, const void* pv, const void* table,
           void* o, int C, int H, int Hkv, int D, int blk, int npages,
           int base, int chunk_len, float sm_scale, cudaStream_t stream) {
  const int qt = kRows / (H / Hkv);
  const dim3 grid((C + qt - 1) / qt, Hkv);
  const size_t smem = sizeof(float) * (kRows * D + 2 * kTk * (D + 1));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_prefill_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  paged_prefill_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), static_cast<const int*>(table),
      static_cast<T*>(o), C, H, Hkv, D, blk, npages, base, chunk_len,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/o [C, H, D]; pools
// [num_blocks, blk, Hkv, D]; table [npages] int32.  Needs D % 32 == 0,
// D <= 256 and H / Hkv dividing 16.
extern "C" int dstt_paged_prefill_attention(
    const void* q, const void* pk, const void* pv, const void* table,
    void* o, int C, int H, int Hkv, int D, int blk, int npages, int base,
    int chunk_len, float sm_scale, int dtype, void* stream) {
  if (D % 32 || D > 32 * kMaxDpl || H % Hkv || kRows % (H / Hkv) || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, pk, pv, table, o, C, H, Hkv, D, blk, npages,
                         base, chunk_len, sm_scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, pk, pv, table, o, C, H, Hkv, D, blk,
                                 npages, base, chunk_len, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

DSTT_DEFINE_ERROR_STRING(dstt_paged_prefill_attention)

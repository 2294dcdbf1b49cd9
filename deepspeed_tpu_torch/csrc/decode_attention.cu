// Dense-cache decode attention (kernel B5) for sm_90a.
//
// Replaces: deepspeed_tpu/ops/transformer/decode_attention.py
//   `_kernel_heads` (launched by `decode_attention`): one new query token
//   per batch row attends over the contiguous [B, S, H, D] KV cache up to
//   a single valid length, online softmax, f32 accumulators.
//
// Bound on the H100: device-memory bytes.  Each (row, head) reads
// `length` K rows and `length` V rows of D elements once and does 4*D
// flops per row pair, far below the ~295 flop/byte ridge, so the least
// time is (K + V bytes read) / 3.35 TB/s.
//
// Design against that bound:
//   * the TPU kernel's sequential chunk axis becomes a loop inside a
//     warp; one warp per head, four consecutive heads per block, so a
//     block reads the four heads' rows of one position as one contiguous
//     1 KB run (bf16, D = 128);
//   * each lane issues 16-byte loads; a group of D*sizeof(T)/16 lanes
//     owns one key row, and every lane keeps 2 * 4 loads in flight
//     (K and V of four rows) before it reduces;
//   * the walk stops at `length`: rows past it are never read, which is
//     the NaN-safety rule of the TPU kernel without a mask pass;
//   * when B * H / 4 blocks cannot fill the card, positions are split
//     over gridDim.z and a second small kernel merges the per-split
//     (m, l, acc) — the wrapper sizes the split and allocates the
//     partials; this file allocates nothing.
#include "attention_common.cuh"

using namespace dstt;

namespace {

constexpr int kWarps = 4;   // heads per block, one warp each
constexpr int kUnroll = 4;  // key rows per group per iteration

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        float* __restrict__ part_ml,
                        float* __restrict__ part_acc, int S, int H, int D,
                        int length, int split_len, float sm_scale) {
  constexpr int N = VecWidth<T>::N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.x * kWarps + warp;
  if (h >= H) return;  // whole warp leaves; no block barrier follows
  const int b = blockIdx.y, split = blockIdx.z, nsplit = gridDim.z;
  const int lpr = D / N;  // lanes per key row
  const int row_in_warp = lane / lpr;
  const int lane_off = (lane % lpr) * N;
  const int p0 = split * split_len;
  const int p1 = min(length, p0 + split_len);
  const size_t bh = static_cast<size_t>(b) * H + h;

  float qf[1][N];
  load_vec(q + bh * D + lane_off, qf[0]);
  float m[1] = {DSTT_NEG_INF}, l[1] = {0.f}, acc[1][N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[0][i] = 0.f;

  const size_t row0 = static_cast<size_t>(b) * S;
  auto row = [=](int p) {
    return ((row0 + p) * H + h) * static_cast<size_t>(D);
  };
  attend_rows<T, 1, kUnroll>(qf, k, v, row, lane_off, lpr, p0, row_in_warp,
                             p1, 32 / lpr, sm_scale, m, l, acc);
  warp_merge_groups<1, N>(m, l, acc, lpr);
  if (row_in_warp != 0) return;
  if (nsplit == 1) {
    const float inv = 1.f / fmaxf(l[0], 1e-30f);
    float out[N];
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = acc[0][i] * inv;
    store_vec(o + bh * D + lane_off, out);
  } else {
    const size_t sidx = bh * nsplit + split;
    if (lane == 0) {
      part_ml[2 * sidx] = m[0];
      part_ml[2 * sidx + 1] = l[0];
    }
    float* dst = part_acc + sidx * D + lane_off;
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = acc[0][i];
  }
}

// Merge the per-split online-softmax states of one (row, head).
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_ml,
                                      const float* __restrict__ part_acc,
                                      T* __restrict__ o, int nsplit, int D) {
  const size_t bh = blockIdx.x;
  float mx = DSTT_NEG_INF;
  for (int s = 0; s < nsplit; ++s)
    mx = fmaxf(mx, part_ml[2 * (bh * nsplit + s)]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.f, den = 0.f;
    if (mx != DSTT_NEG_INF) {
      for (int s = 0; s < nsplit; ++s) {
        const size_t sidx = bh * nsplit + s;
        const float w = expf(part_ml[2 * sidx] - mx);
        num = fmaf(w, part_acc[sidx * D + d], num);
        den = fmaf(w, part_ml[2 * sidx + 1], den);
      }
    }
    o[bh * D + d] = from_float<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           void* part_ml, void* part_acc, int B, int S, int H, int D,
           int length, int nsplit, int split_len, float sm_scale,
           cudaStream_t stream) {
  const dim3 grid((H + kWarps - 1) / kWarps, B, nsplit);
  decode_attention_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc), S, H, D,
      length, split_len, sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  decode_combine_kernel<T><<<B * H, D < 256 ? D : 256, 0, stream>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<T*>(o), nsplit, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  part_ml [B*H*nsplit*2] and part_acc
// [B*H*nsplit*D] f32 are scratch, read only when nsplit > 1.  Returns the
// cudaError_t of the launches (0 = success).
extern "C" int dstt_decode_attention(const void* q, const void* k,
                                     const void* v, void* o, void* part_ml,
                                     void* part_acc, int B, int S, int H,
                                     int D, int length, int nsplit,
                                     int split_len, float sm_scale,
                                     int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, part_ml, part_acc, B, S, H, D, length,
                         nsplit, split_len, sm_scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, part_ml, part_acc, B, S, H, D,
                                 length, nsplit, split_len, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

DSTT_DEFINE_ERROR_STRING(dstt_decode_attention)

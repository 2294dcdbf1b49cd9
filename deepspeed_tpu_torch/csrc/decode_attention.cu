// Dense-cache decode attention (kernel B5) for sm_90a.
//
// Replaces: deepspeed_tpu/ops/transformer/decode_attention.py
//   `_kernel_heads` (launched by `decode_attention`): one new query token
//   per batch row attends over the contiguous KV cache up to a single
//   valid length, online softmax, f32 accumulators.  The cache is read at
//   kv-head width: q [B, H, D], k/v [B, S, Hkv, D], and query head h
//   reads kv head h / g with g = H / Hkv (B1's, B6's and B7's map), so a
//   grouped-query cache is never expanded through memory.  With Hkv == H
//   this is the TPU kernel's contract.
//
// Bound on the H100: device-memory bytes.  Each (row, kv head) reads
//   `length` K rows and `length` V rows of D elements once and does 4 D g
//   flops per row, far below the ~295 flop/byte ridge, so the least time
//   is (K + V bytes read, q and o once) / 3.35 TB/s.  At GPT-3 6.7B's
//   decode shape (B 8, H = Hkv 32, D 128, length 192) that is 25 MB,
//   7.5 us.  What binds a kernel there is how many bytes it keeps in
//   flight: by Little's law ~3.35 TB/s x ~1 us / 132 SMs = ~25 KB an SM.
//
// bf16 design (decode_cluster_kernel):
//   * one block of 128 threads per (batch row, kv head, split) holds the
//     group's g query heads, so each K/V row is read once per group;
//   * the split's K/V rows are staged in chunks of 64 rows (32 at D 128
//     and 256) by 16-byte cp.async into a ring of three stages (~17 KB a
//     stage at D 128), so a block keeps ~52 KB in flight and four blocks
//     an SM fit; rows at or past the split's end are zero-filled, never
//     read.  On an H100 64-row chunks at D 128 were slower (the last
//     chunk's products, after its data lands, are the kernel's tail),
//     and so were four stages, or 16-row chunks in six (PERF.md);
//   * scores: each (row, head) pair of a chunk is one thread's dot
//     product over D / SL features read from shared memory, SL = 1, 2 or
//     4 lanes a pair (only when the pairs are fewer than the threads), so
//     a row pays at most two xor-shuffles, not a shuffle tree per row;
//   * the online softmax runs per head over a whole chunk in base 2
//     (sm_scale * log2 e folded into the score), one warp a head: one
//     max and one sum reduction per chunk, one ex2.approx a probability;
//     p stays f32 through P.V, as in the plain version;
//   * P.V: each thread owns 8 output features (one 16-byte V vector) of
//     one head and a residue class of the chunk's rows; the row classes'
//     partial sums share the chunk max, so they are added once per split
//     in a fixed order (no per-row reduction);
//   * splits: positions are split only as far as it takes to fill the
//     card (the wrapper's `cluster_plan`, at most 8).  The splits of one
//     (row, kv head) form one thread-block cluster; each split leaves its
//     (m, l, acc) in its shared memory, and split 0 merges them through
//     distributed shared memory in rank order after a cluster barrier.
//     So one launch, no scratch, no atomics: two launches give the same
//     bits.
//
// float16 runs the same kernel (ET = __half): the rows convert with
//   __half22float2 in place of __bfloat1622float2 and the output rounds
//   to f16; every sum is f32 as in bf16.
//
// Head dims and groups (bf16, f16): every multiple of 8 up to 256, the
//   reference's gate (a row of D / 8 16-byte vectors; a score is split
//   over SL lanes only where D / 8 divides by 2 SL), and any kv group: a
//   group of more than 4096 output features (g x D) is split into the
//   fewest `parts` blocks of g / parts heads (blockIdx.y = kv head x
//   parts + part), each reading the kv head's rows again, never a copy
//   at query-head width.
//
// f32 design (CUDA cores, kept as it was, with the kv head index h / g):
//   one warp per head, four consecutive heads per block, each lane
//   16-byte loads of a slice of a key row (attention_common.cuh's
//   attend_rows); when B * H / 4 blocks cannot fill the card, positions
//   are split over gridDim.z and a second small kernel merges the
//   per-split (m, l, acc) from a scratch the wrapper allocates.
//
// Both: the walk stops at `length`: rows past it are never read, which is
// the NaN-safety rule of the TPU kernel without a mask pass; `length` 0
// gives zero rows.  This file allocates nothing.
#include "flash_mma.cuh"

#include <cooperative_groups.h>

#include <type_traits>

using namespace dstt;

namespace {

constexpr int kWarps = 4;   // heads per block, one warp each
constexpr int kUnroll = 4;  // key rows per group per iteration

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        float* __restrict__ part_ml,
                        float* __restrict__ part_acc, int S, int H, int Hkv,
                        int D, int length, int split_len, float sm_scale) {
  constexpr int N = VecWidth<T>::N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.x * kWarps + warp;
  if (h >= H) return;  // whole warp leaves; no block barrier follows
  const int b = blockIdx.y, split = blockIdx.z, nsplit = gridDim.z;
  const int hkv = h / (H / Hkv);
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
    return ((row0 + p) * Hkv + hkv) * static_cast<size_t>(D);
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

int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* part_ml, void* part_acc, int B, int S, int H, int Hkv,
               int D, int length, int nsplit, int split_len, float sm_scale,
               cudaStream_t stream) {
  const dim3 grid((H + kWarps - 1) / kWarps, B, nsplit);
  decode_attention_kernel<float><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc), S, H, Hkv,
      D, length, split_len, sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  decode_combine_kernel<float><<<B * H, D < 256 ? D : 256, 0, stream>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<float*>(o), nsplit, D);
  return static_cast<int>(cudaGetLastError());
}

// -- bf16: one block per (row, kv head, split), splits merged in a cluster
namespace tc = dstt::mma;
namespace cg = cooperative_groups;

constexpr int kThreads = 128;
constexpr int kStages = 3;       // cp.async ring depth, in chunks
constexpr int kMaxSplits = 8;    // the portable cluster size
constexpr int kMaxGroupDim = 4096;  // g * D: output features of a block
constexpr int kMaxVecs = kMaxGroupDim / 8 / kThreads;  // a thread's vectors

template <int D> struct Geo {
  static constexpr int kRows = D <= 64 ? 64 : 32;       // rows a chunk
  static constexpr int kStride = D + 8;                 // padded bf16 row
  static constexpr int kChunk = kRows * kStride;        // K (or V) chunk
  static constexpr int kStage = 2 * kChunk;             // K then V
};

// Shared-memory bytes of a block: the ring (only as many stages as the
// split has chunks), q [g][D] bf16, scores [g][R] f32, the split's
// accumulator [g][D] f32, and m, l, alpha [g] f32.
template <int D>
size_t cluster_smem(int g, int split_len) {
  using G = Geo<D>;
  const int chunks = (split_len + G::kRows - 1) / G::kRows;
  const int stages = chunks < kStages ? (chunks < 1 ? 1 : chunks) : kStages;
  return sizeof(tc::bf16) * (static_cast<size_t>(stages) * G::kStage +
                             static_cast<size_t>(g) * D) +
         sizeof(float) * (static_cast<size_t>(g) * (G::kRows + D + 3));
}

// 2^x on the special-function unit (ex2.approx: relative error at most
// 2^-22; 2^-inf = 0), as the bf16 B1 computes its probabilities
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

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

// Eight ET (bf16 or __half) from shared memory, widened to f32.
template <typename ET>
__device__ __forceinline__ void lds8(const tc::bf16* p, float (&out)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  if constexpr (std::is_same<ET, __half>::value) {
    const __half2* h = reinterpret_cast<const __half2*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
}

// ET (bf16 or __half) is the element type; rows are 16-bit storage.
template <int D, typename ET>
__global__ void __launch_bounds__(kThreads)
decode_cluster_kernel(const tc::bf16* __restrict__ q,
                      const tc::bf16* __restrict__ k,
                      const tc::bf16* __restrict__ v,
                      tc::bf16* __restrict__ o, int S, int H, int Hkv,
                      int parts, int length, int split_len,
                      float sm_scale) {
  using G = Geo<D>;
  constexpr int R = G::kRows, VPR = D / 8;  // 16-byte vectors a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // this block's g query heads: part blockIdx.y % parts of kv head
  // blockIdx.y / parts's group of H / Hkv
  const int g = H / Hkv / parts;
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int kvh = blockIdx.y / parts, part = blockIdx.y % parts;
  const int b = blockIdx.z;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int p0 = split * split_len;
  const int p1 = min(length, p0 + split_len);
  const int nc = p1 > p0 ? (p1 - p0 + R - 1) / R : 0;  // chunks to walk
  const float scale2 = sm_scale * tc::kLog2e;

  const int chunks = (split_len + R - 1) / R;
  const int nstage = chunks < kStages ? (chunks < 1 ? 1 : chunks) : kStages;
  tc::bf16* ring = reinterpret_cast<tc::bf16*>(smem_raw);
  tc::bf16* qs = ring + nstage * G::kStage;                  // [g][D]
  float* sp = reinterpret_cast<float*>(qs + g * D);          // [g][R]
  float* fin = sp + g * R;                                   // [g][D]
  float* st_m = fin + g * D;                                 // [g]
  float* st_l = st_m + g;                                    // [g]
  float* st_a = st_l + g;                                    // [g]

  // chunk c of the split into stage c % kStages: rows at or past p1
  // zero-filled, never read (the source is clamped to row p0)
  const size_t row0 = static_cast<size_t>(b) * S;
  auto load_chunk = [&](int c) {
    tc::bf16* ks = ring + (c % kStages) * G::kStage;
    tc::bf16* vs = ks + G::kChunk;
    for (int i = t; i < R * VPR; i += kThreads) {
      const int r = i / VPR, col = (i % VPR) * 8;
      const int p = p0 + c * R + r;
      const bool ok = p < p1;
      const size_t off =
          ((row0 + (ok ? p : p0)) * Hkv + kvh) * static_cast<size_t>(D) + col;
      tc::cp_async16(ks + r * G::kStride + col, k + off, ok);
      tc::cp_async16(vs + r * G::kStride + col, v + off, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s < nc) load_chunk(s);
    tc::cp_async_commit();
  }

  // the block's query heads, contiguous in q from kvh * (H / Hkv) +
  // part * g
  const size_t qbase =
      (static_cast<size_t>(b) * H + kvh * (H / Hkv) + part * g) * D;
  for (int i = t; i < g * VPR; i += kThreads)
    *reinterpret_cast<uint4*>(qs + 8 * i) =
        __ldg(reinterpret_cast<const uint4*>(q + qbase + 8 * i));
  for (int j = t; j < g; j += kThreads) {
    st_m[j] = DSTT_NEG_INF;
    st_l[j] = 0.f;
  }

  // score layout: (row, head) pairs, SL lanes a pair over D / SL features
  const int pairs = R * g;
  int SL = 1;
  while (SL < 4 && pairs * SL * 2 <= kThreads && VPR % (SL * 2) == 0)
    SL *= 2;
  const int slice = t % SL, item = t / SL, items = kThreads / SL;
  const int fpl = D / SL;
  // P.V layout: NV output vectors of 8 features; thread t owns vector
  // t % NV of row class t / NV (RG classes) when NV <= kThreads, else
  // vectors t, t + kThreads, ... of the one class
  const int NV = g * VPR;
  const int RG = NV <= kThreads ? kThreads / NV : 1;
  const int rg = NV <= kThreads ? t / NV : 0;
  const bool pv_active = rg < RG;
  float acc[kMaxVecs][8];
#pragma unroll
  for (int u = 0; u < kMaxVecs; ++u)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[u][i] = 0.f;
  auto vec_of = [&](int u) { return NV <= kThreads ? t % NV : t + u * kThreads; };
  __syncthreads();

  for (int c = 0; c < nc; ++c) {
    tc::cp_async_wait<kStages - 1>();  // chunk c landed
    __syncthreads();
    const tc::bf16* ks = ring + (c % kStages) * G::kStage;
    const tc::bf16* vs = ks + G::kChunk;
    const int valid = min(R, p1 - (p0 + c * R));  // rows of the chunk

    // scores, base 2 and scaled; -inf past the split's end
    for (int base = 0; base < pairs; base += items) {
      const int pi = base + item;
      const int pc = pi < pairs ? pi : 0;
      const int r = pc % R, j = pc / R;
      const tc::bf16* kr = ks + r * G::kStride + slice * fpl;
      const tc::bf16* qj = qs + j * D + slice * fpl;
      float d = 0.f;
#pragma unroll 4
      for (int f = 0; f < fpl; f += 8) {
        float kf[8], qf[8];
        lds8<ET>(kr + f, kf);
        lds8<ET>(qj + f, qf);
#pragma unroll
        for (int i = 0; i < 8; ++i) d = fmaf(qf[i], kf[i], d);
      }
      for (int off = SL >> 1; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      if (pi < pairs && slice == 0)
        sp[j * R + r] = r < valid ? d * scale2 : DSTT_NEG_INF;
    }
    __syncthreads();

    // online softmax over the chunk, one warp a head; the chunk holds a
    // valid row, so its max is finite and a first chunk's alpha is 0
    for (int j = warp; j < g; j += kThreads / 32) {
      float* sj = sp + j * R;
      float mx = DSTT_NEG_INF;
      for (int r = lane; r < R; r += 32) mx = fmaxf(mx, sj[r]);
      mx = warp_max(mx);
      const float m_old = st_m[j];
      const float m_new = fmaxf(m_old, mx);
      float psum = 0.f;
      for (int r = lane; r < R; r += 32) {
        const float p = fast_exp2(sj[r] - m_new);
        sj[r] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = fast_exp2(m_old - m_new);
        st_l[j] = alpha * st_l[j] + psum;
        st_m[j] = m_new;
        st_a[j] = alpha;
      }
    }
    __syncthreads();

    // acc = alpha acc + p V over this thread's row class
    if (pv_active) {
#pragma unroll
      for (int u = 0; u < kMaxVecs; ++u) {
        const int vec = vec_of(u);
        if (vec >= NV || (u > 0 && NV <= kThreads)) break;
        const int j = vec / VPR, f0 = (vec % VPR) * 8;
        const float alpha = st_a[j];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[u][i] *= alpha;
        const float* pj = sp + j * R;
        for (int r = rg; r < valid; r += RG) {
          const float p = pj[r];
          float vf[8];
          lds8<ET>(vs + r * G::kStride + f0, vf);
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[u][i] = fmaf(p, vf[i], acc[u][i]);
        }
      }
    }
    __syncthreads();  // every thread is done with this stage
    if (c + kStages < nc) load_chunk(c + kStages);
    tc::cp_async_commit();
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // the split's accumulator: row classes added in a fixed order
  if (RG > 1) {
    float* red = reinterpret_cast<float*>(ring);  // [kThreads][8]
#pragma unroll
    for (int i = 0; i < 8; ++i) red[8 * t + i] = acc[0][i];
    __syncthreads();
    if (t < NV) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float s = red[8 * t + i];
        for (int c = 1; c < RG; ++c) s += red[8 * (c * NV + t) + i];
        fin[8 * t + i] = s;
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < kMaxVecs; ++u) {
      const int vec = t + u * kThreads;
      if (vec < NV)
#pragma unroll
        for (int i = 0; i < 8; ++i) fin[8 * vec + i] = acc[u][i];
    }
  }
  __syncthreads();

  tc::bf16* out = o + qbase;
  if (nsplit == 1) {
    for (int vec = t; vec < NV; vec += kThreads) {
      const float inv = 1.f / fmaxf(st_l[vec / VPR], 1e-30f);
      float r[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) r[i] = fin[8 * vec + i] * inv;
      store_vec(reinterpret_cast<ET*>(out + 8 * vec), r);
    }
    return;
  }
  // merge the cluster's splits in rank order through distributed shared
  // memory; an empty split has m = -inf and weight 0
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (split == 0) {
    for (int vec = t; vec < NV; vec += kThreads) {
      const int j = vec / VPR;
      float mx = DSTT_NEG_INF;
      for (int s = 0; s < nsplit; ++s)
        mx = fmaxf(mx, cluster.map_shared_rank(st_m, s)[j]);
      float num[8], den = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) num[i] = 0.f;
      if (mx != DSTT_NEG_INF) {
        for (int s = 0; s < nsplit; ++s) {
          const float w = fast_exp2(cluster.map_shared_rank(st_m, s)[j] - mx);
          den = fmaf(w, cluster.map_shared_rank(st_l, s)[j], den);
          const float* fs = cluster.map_shared_rank(fin, s) + 8 * vec;
#pragma unroll
          for (int i = 0; i < 8; ++i) num[i] = fmaf(w, fs[i], num[i]);
        }
      }
      const float inv = 1.f / fmaxf(den, 1e-30f);
#pragma unroll
      for (int i = 0; i < 8; ++i) num[i] *= inv;
      store_vec(reinterpret_cast<ET*>(out + 8 * vec), num);
    }
  }
  cluster.sync();  // no split leaves while split 0 reads its memory
}

template <int D, typename ET>
int launch_16(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int Hkv, int parts, int length, int nsplit,
                int split_len, float sm_scale, cudaStream_t stream) {
  const size_t smem = cluster_smem<D>(H / Hkv / parts, split_len);
  auto kernel = decode_cluster_kernel<D, ET>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, Hkv * parts, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const tc::bf16*>(q),
      static_cast<const tc::bf16*>(k), static_cast<const tc::bf16*>(v),
      static_cast<tc::bf16*>(o), S, H, Hkv, parts, length, split_len,
      sm_scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// bf16 or f16 (ET).  A kv head's group is split into `parts` blocks of
// (H / Hkv) / parts heads when it holds more than kMaxGroupDim output
// features (each part reads the kv head's rows again: never a copy at
// query-head width).
template <typename ET>
int dispatch_16(const void* q, const void* k, const void* v, void* o,
                  int B, int S, int H, int Hkv, int D, int parts, int length,
                  int nsplit, int split_len, float sm_scale, cudaStream_t st) {
  if (nsplit < 1 || nsplit > kMaxSplits || split_len < 1 || parts < 1 ||
      (H / Hkv) % parts || (H / Hkv / parts) * D > kMaxGroupDim ||
      static_cast<long long>(Hkv) * parts > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
#define DSTT_CASE(DD)                                                     \
  case DD:                                                                \
    return launch_16<DD, ET>(q, k, v, o, B, S, H, Hkv, parts, length,    \
                             nsplit, split_len, sm_scale, st);
    DSTT_DECODE_HEAD_DIMS(DSTT_CASE)
#undef DSTT_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  q/o [B, H, D], k/v
// [B, S, Hkv, D], H a multiple of Hkv.  float32: part_ml [B*H*nsplit*2]
// and part_acc [B*H*nsplit*D] f32 are scratch, read only when nsplit > 1;
// `parts` is ignored.  bfloat16 and float16: D a multiple of 8 up to 256; nsplit (1..8) splits of
// split_len positions form one cluster, no scratch (part_* ignored); each
// kv head's group in `parts` blocks of (H / Hkv) / parts heads, (H / Hkv /
// parts) * D <= 4096.  Returns the cudaError_t of the launches (0 =
// success).
extern "C" int dstt_decode_attention(const void* q, const void* k,
                                     const void* v, void* o, void* part_ml,
                                     void* part_acc, int B, int S, int H,
                                     int Hkv, int D, int parts, int length,
                                     int nsplit, int split_len,
                                     float sm_scale, int dtype,
                                     void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(q, k, v, o, part_ml, part_acc, B, S, H, Hkv, D, length,
                      nsplit, split_len, sm_scale, st);
  if (dtype == 1)
    return dispatch_16<tc::bf16>(q, k, v, o, B, S, H, Hkv, D, parts, length,
                                 nsplit, split_len, sm_scale, st);
  if (dtype == 2)
    return dispatch_16<__half>(q, k, v, o, B, S, H, Hkv, D, parts, length,
                               nsplit, split_len, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

DSTT_DEFINE_ERROR_STRING(dstt_decode_attention)

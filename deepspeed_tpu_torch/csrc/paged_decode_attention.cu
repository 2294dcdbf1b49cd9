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
// per row pair, so the least time is those bytes / 3.35 TB/s.  At the
// serving shape (8 slots of lengths up to 513, H = Hkv 32, D 128) that is
// 5.3 us; what a kernel actually pays is the latency of walking the
// longest slot's rows one after another, and the launch of its grid
// (on an H100 the 2048 blocks below take 0.012-0.014 ms with every slot
// inactive, `paged_variants.py`).
//
// bf16 design (paged_decode_cluster_kernel; B5's cluster design, on a
// table): one block of 128 threads per (slot, kv head, split) holds the
// group's G query heads, so each K/V row is read once per group.  The
// table's npages * blk rows are cut into nsplit splits of split_len rows
// (whole pages; the wrapper's `paged_split_plan`, sized from the table's
// width because the lengths live on the card); split r walks rows
// [r * split_len, min((r + 1) * split_len, length)), so a long slot's
// rows are walked by up to 8 blocks at once instead of one:
//   * a split's rows are staged in chunks of 64 rows (32 at D 128 and
//     256) through the table by cp.async into a ring of three stages, or
//     two where a stage holds 16 KB or more (bf16 rows at D >= 64): at
//     D 128 that is 35 KB a block instead of 52, six blocks an SM instead
//     of four, and on an H100 the 8-slot case took 0.029 ms against
//     0.033 with three stages (`paged_variants.py`); rows past the
//     split's end are zero-filled, never read.  At kv_bits 8 and 4 the
//     ring holds the raw bytes and the row scales, widened while shared
//     memory is read (only compressed bytes and scales cross device
//     memory);
//   * scores: each (row, head) pair of a chunk is one thread's dot
//     product over D / SL features (SL = 1, 2 or 4 lanes a pair), times
//     the row's k scale when quantized; the online softmax runs per head
//     over a whole chunk in base 2, one warp a head, one ex2.approx a
//     probability; P.V: each thread owns 8 output features of one head
//     and a residue class of the chunk's rows, p (times the row's v scale
//     when quantized) in f32;
//   * the splits of one (slot, kv head) are one thread-block cluster of
//     at most 8 ranks.  A rank whose split starts at or past the slot's
//     length has nothing to add and exits at once (the cluster barrier
//     waits only for threads that have not exited), so the empty ranks of
//     short and inactive slots give their place on the SM back; the
//     ranks with rows leave (m, l, acc) in their shared memory, and rank
//     0 merges them through distributed shared memory in rank order
//     between two cluster barriers.  One launch, no scratch, no atomics:
//     two launches give the same bits.  A slot with rows in rank 0 alone
//     (and an inactive slot, which gives zero rows) needs no barrier.
//
// float16 (queries, outputs and kv_bits 0 pools) runs the same kernel
// (ET = __half): rows widen with __half22float2, dequantized rows go to
// f32 as in bf16, and the output rounds to f16.
//
// Head dims and groups (bf16 and f16 queries): every multiple of 8 up to
// 256 at kv_bits 0, 8 and 4 (a pool row moves by cp.async of 16, 8 or 4
// bytes, the largest that divides it), and any kv group: a group of more
// than 2048 output features is split into the fewest `parts` blocks of
// g / parts heads (one cluster per (slot, kv head, part)), each reading
// the kv head's rows again.
//
// f32 design (paged_decode_kernel, CUDA cores, the first port): one block
// per (kv head, slot); four warps interleave over the slot's positions,
// each warp split into row groups of D / N lanes (N features a lane: 16
// bytes of T, or 8 features of a quantized row), each lane holding 2 * 4
// row loads in flight; the G query heads share every K/V load, their
// (m, l, acc) in registers; the four warps' states merge once through
// shared memory at the end.
//
// Both: the walk reads its own block-table entries and stops at the
// slot's length: pages past it, their scales, and inactive slots (length
// 0), cost no traffic and give all-zero rows.  kv_bits is a template
// parameter: the kv_bits 0 instantiation is the unquantized kernel.
#include "flash_mma.cuh"

#include <cooperative_groups.h>

#include <type_traits>

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

// -- bf16: one block per (slot, kv head, split), splits merged in a cluster
namespace tc = dstt::mma;
namespace cg = cooperative_groups;

constexpr int kThreads = 128;
constexpr int kStages = 3;          // cp.async ring depth, in chunks
constexpr int kBigStage = 16384;    // ... but 2 for stages this large
constexpr int kMaxRanks = 8;        // the portable cluster size
constexpr int kMaxGroupDim = 2048;  // G * D: output features of a block
constexpr int kMaxUnits = kMaxGroupDim / 8 / kThreads;  // a thread's units

// Geometry of a chunk: R pool rows of RB bytes each (bf16 2 D, int8 D,
// packed int4 D / 2), each padded by 16 bytes in shared memory, K then V,
// then (quantized) the R k scales and R v scales.
template <int D, int KV_BITS> struct Geo {
  static constexpr int kRows = D <= 64 ? 64 : 32;
  static constexpr int kRowBytes = KV_BITS == 0 ? 2 * D
                                   : KV_BITS == 8 ? D : D / 2;
  // bytes of one cp.async: the largest of 16, 8 and 4 that divides a row
  static constexpr int kCopy = kRowBytes % 16 == 0  ? 16
                               : kRowBytes % 8 == 0 ? 8
                                                    : 4;
  static constexpr int kStride = kRowBytes + 16;
  static constexpr int kChunk = kRows * kStride;
  static constexpr int kStage = 2 * kChunk + (KV_BITS ? 2 * kRows * 4 : 0);
  static constexpr int kRing = kStage >= kBigStage ? 2 : kStages;
};

// Bytes of the ring: only as many stages as a split has chunks, and at
// least the [kThreads][8] f32 the row classes' sums pass through after
// the walk.
template <int D, int KV_BITS>
__host__ __device__ __forceinline__ int ring_bytes(int split_len) {
  using Gm = Geo<D, KV_BITS>;
  const int chunks = (split_len + Gm::kRows - 1) / Gm::kRows;
  const int stages = chunks < Gm::kRing ? (chunks < 1 ? 1 : chunks)
                                        : Gm::kRing;
  const int bytes = stages * Gm::kStage;
  return bytes < kThreads * 32 ? kThreads * 32 : bytes;
}

// Shared-memory bytes of a block: the ring, q [g][D] f32, scores [g][R]
// f32, the split's accumulator [g][D] f32, and m, l, alpha [g] f32.
template <int D, int KV_BITS>
size_t cluster_smem(int g, int split_len) {
  return static_cast<size_t>(ring_bytes<D, KV_BITS>(split_len)) +
         sizeof(float) * static_cast<size_t>(g) *
             (2 * D + Geo<D, KV_BITS>::kRows + 3);
}

// cp.async of N = 4, 8 or 16 bytes, zero-filled (nothing read) when !valid
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

// 2^x on the special-function unit (ex2.approx: relative error at most
// 2^-22; 2^-inf = 0)
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

// Unit u (8 features) of a staged row, widened to f32, unscaled: ET
// (bf16 or __half) features 8u .. 8u + 7; int8 the same; packed int4 the
// low nibbles of bytes 4u .. 4u + 3 (features 4u .. 4u + 3) then their
// high nibbles (features D/2 + 4u .. D/2 + 4u + 3): quant_feature's order.
template <int KV_BITS, typename ET>
__device__ __forceinline__ void widen_unit(const unsigned char* row, int u,
                                           float (&out)[8]) {
  if constexpr (KV_BITS == 0 && std::is_same<ET, __half>::value) {
    const uint4 w = *reinterpret_cast<const uint4*>(row + 16 * u);
    const __half2* h = reinterpret_cast<const __half2*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else if constexpr (KV_BITS == 0) {
    const uint4 w = *reinterpret_cast<const uint4*>(row + 16 * u);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else if constexpr (KV_BITS == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(row + 8 * u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[i] = static_cast<float>(static_cast<int>(w.x << (24 - 8 * i)) >> 24);
      out[4 + i] =
          static_cast<float>(static_cast<int>(w.y << (24 - 8 * i)) >> 24);
    }
  } else {
    const unsigned w = *reinterpret_cast<const unsigned*>(row + 4 * u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[i] = static_cast<float>(static_cast<int>(w << (28 - 8 * i)) >> 28);
      out[4 + i] =
          static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 28);
    }
  }
}

// Unit u's eight values into an ET (bf16 or __half) output row of D
// features.
template <int KV_BITS, typename ET>
__device__ __forceinline__ void store_unit(tc::bf16* row, int u, int D,
                                           const float (&x)[8]) {
  if constexpr (KV_BITS == 4) {
    uint2 lo, hi;
    lo.x = tc::pack<ET>(x[0], x[1]);
    lo.y = tc::pack<ET>(x[2], x[3]);
    hi.x = tc::pack<ET>(x[4], x[5]);
    hi.y = tc::pack<ET>(x[6], x[7]);
    *reinterpret_cast<uint2*>(row + 4 * u) = lo;
    *reinterpret_cast<uint2*>(row + D / 2 + 4 * u) = hi;
  } else {
    store_vec(reinterpret_cast<ET*>(row + 8 * u), x);
  }
}

// ET (bf16 or __half) is the queries' and outputs' type (and the pools'
// at kv_bits 0); 16-bit rows are typed bf16 as storage.
template <int D, int KV_BITS, typename ET>
__global__ void __launch_bounds__(kThreads)
paged_decode_cluster_kernel(
    const tc::bf16* __restrict__ q,
    const typename PoolElem<tc::bf16, KV_BITS>::type* __restrict__ pk,
    const typename PoolElem<tc::bf16, KV_BITS>::type* __restrict__ pv,
    const float* __restrict__ kscale, const float* __restrict__ vscale,
    const int* __restrict__ lengths, const int* __restrict__ tables,
    tc::bf16* __restrict__ o, int H, int Hkv, int parts, int blk,
    int npages, int split_len, float sm_scale) {
  using Gm = Geo<D, KV_BITS>;
  constexpr int R = Gm::kRows, VPR = D / 8;  // 8-feature units a row
  constexpr int RB = Gm::kRowBytes, RS = Gm::kStride, CB = Gm::kCopy;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // this block's g query heads: part blockIdx.y % parts of kv head
  // blockIdx.y / parts's group of H / Hkv
  const int g = H / Hkv / parts;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y / parts, part = blockIdx.y % parts;
  const int b = blockIdx.z;
  const int len = max(0, min(__ldg(lengths + b), npages * blk));
  const int p0 = split * split_len;
  if (split > 0 && p0 >= len) return;  // an empty rank: nothing to merge
  const int p1 = min(len, p0 + split_len);
  const int nc = p1 > p0 ? (p1 - p0 + R - 1) / R : 0;  // chunks to walk
  const int nact = (len + split_len - 1) / split_len;  // ranks with rows
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float scale2 = sm_scale * tc::kLog2e;

  unsigned char* ring = smem_raw;
  float* qs = reinterpret_cast<float*>(ring +
                                       ring_bytes<D, KV_BITS>(split_len));
  float* sp = qs + g * D;     // [g][R]
  float* fin = sp + g * R;    // [g][D]
  float* st_m = fin + g * D;  // [g]
  float* st_l = st_m + g;     // [g]
  float* st_a = st_l + g;     // [g]

  // chunk c of the split into stage c % kRing through the slot's table:
  // rows at or past p1 zero-filled, never read, nor their scales
  const int* table = tables + static_cast<size_t>(b) * npages;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(pk);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(pv);
  auto load_chunk = [&](int c) {
    unsigned char* ks = ring + (c % Gm::kRing) * Gm::kStage;
    unsigned char* vs = ks + Gm::kChunk;
    constexpr int CPR = RB / CB;  // copies a row
    for (int i = t; i < R * CPR; i += kThreads) {
      const int r = i / CPR, col = (i % CPR) * CB;
      const int p = p0 + c * R + r;
      const bool ok = p < p1;
      size_t off = 0;
      if (ok) {
        const size_t bid = __ldg(table + p / blk);
        off = ((bid * blk + p % blk) * Hkv + kvh) * RB + col;
      }
      cp_async_n<CB>(ks + r * RS + col, kb + off, ok);
      cp_async_n<CB>(vs + r * RS + col, vb + off, ok);
    }
    if constexpr (KV_BITS != 0) {
      float* sc = reinterpret_cast<float*>(vs + Gm::kChunk);  // [2][R]
      for (int i = t; i < 2 * R; i += kThreads) {
        const int r = i % R, p = p0 + c * R + r;
        const bool ok = p < p1;
        size_t row = 0;
        if (ok) {
          const size_t bid = __ldg(table + p / blk);
          row = (bid * blk + p % blk) * Hkv + kvh;
        }
        tc::cp_async4(sc + i, (i < R ? kscale : vscale) + row, ok);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < Gm::kRing; ++s) {
    if (s < nc) load_chunk(s);
    tc::cp_async_commit();
  }

  // the block's query heads (contiguous in q from kvh * (H / Hkv) +
  // part * g), f32, each unit's features in widen_unit's order
  const size_t qbase =
      (static_cast<size_t>(b) * H + kvh * (H / Hkv) + part * g) * D;
  for (int i = t; i < g * D; i += kThreads) {
    const int j = i / D, e = i % D;
    qs[i] = to_float(reinterpret_cast<const ET*>(
        q)[qbase + j * D + quant_feature<KV_BITS>(e / 8, e % 8, D)]);
  }
  for (int j = t; j < g; j += kThreads) {
    st_m[j] = DSTT_NEG_INF;
    st_l[j] = 0.f;
  }

  // score layout: (row, head) pairs, SL lanes a pair over VPR / SL units
  const int pairs = R * g;
  int SL = 1;
  while (SL < 4 && pairs * SL * 2 <= kThreads && VPR % (SL * 2) == 0)
    SL *= 2;
  const int slice = t % SL, item = t / SL, items = kThreads / SL;
  const int upl = VPR / SL;
  // P.V layout: NV units of 8 features; thread t owns unit t % NV of row
  // class t / NV (RG classes) when NV <= kThreads, else units t,
  // t + kThreads, ... of the one class
  const int NV = g * VPR;
  const int RG = NV <= kThreads ? kThreads / NV : 1;
  const int rg = NV <= kThreads ? t / NV : 0;
  const bool pv_active = rg < RG;
  float acc[kMaxUnits][8];
#pragma unroll
  for (int u = 0; u < kMaxUnits; ++u)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[u][i] = 0.f;
  auto unit_of = [&](int u) { return NV <= kThreads ? t % NV : t + u * kThreads; };
  __syncthreads();

  for (int c = 0; c < nc; ++c) {
    tc::cp_async_wait<Gm::kRing - 1>();  // chunk c landed
    __syncthreads();
    const unsigned char* ks = ring + (c % Gm::kRing) * Gm::kStage;
    const unsigned char* vs = ks + Gm::kChunk;
    const float* ksc = reinterpret_cast<const float*>(vs + Gm::kChunk);
    const float* vsc = ksc + R;
    const int valid = min(R, p1 - (p0 + c * R));  // rows of the chunk

    // scores, base 2 and scaled; -inf past the split's end
    for (int base = 0; base < pairs; base += items) {
      const int pi = base + item;
      const int pc = pi < pairs ? pi : 0;
      const int r = pc % R, j = pc / R;
      const unsigned char* kr = ks + r * RS;
      const float* qj = qs + j * D;
      float d = 0.f;
#pragma unroll 4
      for (int u = slice * upl; u < (slice + 1) * upl; ++u) {
        float kf[8];
        widen_unit<KV_BITS, ET>(kr, u, kf);
        const float4 qa = *reinterpret_cast<const float4*>(qj + 8 * u);
        const float4 qb = *reinterpret_cast<const float4*>(qj + 8 * u + 4);
        d = fmaf(qa.x, kf[0], d);
        d = fmaf(qa.y, kf[1], d);
        d = fmaf(qa.z, kf[2], d);
        d = fmaf(qa.w, kf[3], d);
        d = fmaf(qb.x, kf[4], d);
        d = fmaf(qb.y, kf[5], d);
        d = fmaf(qb.z, kf[6], d);
        d = fmaf(qb.w, kf[7], d);
      }
      for (int off = SL >> 1; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      if (pi < pairs && slice == 0) {
        float f = scale2;
        if constexpr (KV_BITS != 0) f *= ksc[r];
        sp[j * R + r] = r < valid ? d * f : DSTT_NEG_INF;
      }
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
        const float pr = fast_exp2(sj[r] - m_new);
        sj[r] = pr;
        psum += pr;
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

    // acc = alpha acc + p V over this thread's row class (p times the
    // row's v scale when quantized)
    if (pv_active) {
#pragma unroll
      for (int u = 0; u < kMaxUnits; ++u) {
        const int unit = unit_of(u);
        if (unit >= NV || (u > 0 && NV <= kThreads)) break;
        const int j = unit / VPR, f0 = unit % VPR;
        const float alpha = st_a[j];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[u][i] *= alpha;
        const float* pj = sp + j * R;
        for (int r = rg; r < valid; r += RG) {
          float pr = pj[r];
          if constexpr (KV_BITS != 0) pr *= vsc[r];
          float vf[8];
          widen_unit<KV_BITS, ET>(vs + r * RS, f0, vf);
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[u][i] = fmaf(pr, vf[i], acc[u][i]);
        }
      }
    }
    __syncthreads();  // every thread is done with this stage
    if (c + Gm::kRing < nc) load_chunk(c + Gm::kRing);
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
        float sum = red[8 * t + i];
        for (int k = 1; k < RG; ++k) sum += red[8 * (k * NV + t) + i];
        fin[8 * t + i] = sum;
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < kMaxUnits; ++u) {
      const int unit = t + u * kThreads;
      if (unit < NV)
#pragma unroll
        for (int i = 0; i < 8; ++i) fin[8 * unit + i] = acc[u][i];
    }
  }
  __syncthreads();

  tc::bf16* out = o + qbase;
  if (nact <= 1) {  // rank 0 alone (or an inactive slot: zeros)
    for (int unit = t; unit < NV; unit += kThreads) {
      const float inv = 1.f / fmaxf(st_l[unit / VPR], 1e-30f);
      float r8[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) r8[i] = fin[8 * unit + i] * inv;
      store_unit<KV_BITS, ET>(out + (unit / VPR) * D, unit % VPR, D, r8);
    }
    return;
  }
  // merge the ranks with rows in rank order through distributed shared
  // memory (the empty ones have exited)
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (split == 0) {
    for (int unit = t; unit < NV; unit += kThreads) {
      const int j = unit / VPR;
      float mx = DSTT_NEG_INF;
      for (int s = 0; s < nact; ++s)
        mx = fmaxf(mx, cluster.map_shared_rank(st_m, s)[j]);
      float num[8], den = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) num[i] = 0.f;
      for (int s = 0; s < nact; ++s) {
        const float w = fast_exp2(cluster.map_shared_rank(st_m, s)[j] - mx);
        den = fmaf(w, cluster.map_shared_rank(st_l, s)[j], den);
        const float* fs = cluster.map_shared_rank(fin, s) + 8 * unit;
#pragma unroll
        for (int i = 0; i < 8; ++i) num[i] = fmaf(w, fs[i], num[i]);
      }
      const float inv = 1.f / fmaxf(den, 1e-30f);
#pragma unroll
      for (int i = 0; i < 8; ++i) num[i] *= inv;
      store_unit<KV_BITS, ET>(out + j * D, unit % VPR, D, num);
    }
  }
  cluster.sync();  // no rank leaves while rank 0 reads its memory
}

template <int D, int KV_BITS, typename ET>
int launch_cluster(const void* q, const void* pk, const void* pv,
                   const float* ks, const float* vs, const void* lengths,
                   const void* tables, void* o, int B, int H, int Hkv,
                   int parts, int blk, int npages, int nsplit, int split_len,
                   float sm_scale, cudaStream_t stream) {
  using P = typename PoolElem<tc::bf16, KV_BITS>::type;
  const size_t smem = cluster_smem<D, KV_BITS>(H / Hkv / parts, split_len);
  auto kernel = paged_decode_cluster_kernel<D, KV_BITS, ET>;
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
      static_cast<const P*>(pk), static_cast<const P*>(pv), ks, vs,
      static_cast<const int*>(lengths), static_cast<const int*>(tables),
      static_cast<tc::bf16*>(o), H, Hkv, parts, blk, npages, split_len,
      sm_scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The 16-bit kernels are built in parts: ops/build.py compiles this file
// once per part with -DDSTT_PART=p (its PARTS), and each (kv_bits, ET)
// instantiation of launch_16 lives in one part only, so the parts compile
// in parallel; part 0 also holds the f32 kernel and the entry points.  A
// compile without DSTT_PART holds everything.
namespace dstt_paged_decode {

// The bf16 / f16 (ET) kernel: nsplit splits of split_len rows must cover
// the table; a kv head's group is split into `parts` blocks of
// (H / Hkv) / parts heads when it holds more than kMaxGroupDim output
// features (each part reads the kv head's rows again: never a copy at
// query-head width).
template <int KV_BITS, typename ET>
int launch_16(const void* q, const void* pk, const void* pv,
              const float* ks, const float* vs, const void* lengths,
              const void* tables, void* o, int B, int H, int Hkv, int D,
              int parts, int blk, int npages, int nsplit, int split_len,
              float sm_scale, cudaStream_t st) {
  if (nsplit < 1 || nsplit > kMaxRanks || split_len < 1 || parts < 1 ||
      static_cast<long long>(nsplit) * split_len <
          static_cast<long long>(npages) * blk ||
      (H / Hkv) % parts || (H / Hkv / parts) * D > kMaxGroupDim ||
      static_cast<long long>(Hkv) * parts > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
#define DSTT_CASE(DD)                                                     \
  case DD:                                                                \
    return launch_cluster<DD, KV_BITS, ET>(q, pk, pv, ks, vs, lengths,     \
                                           tables, o, B, H, Hkv, parts,   \
                                           blk, npages, nsplit, split_len, \
                                           sm_scale, st);
    DSTT_DECODE_HEAD_DIMS(DSTT_CASE)
#undef DSTT_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef DSTT_PART
#define DSTT_LAUNCH_16(KV, ET)                                             \
  int launch_16<KV, ET>(const void*, const void*, const void*,            \
                        const float*, const float*, const void*,          \
                        const void*, void*, int, int, int, int, int, int,  \
                        int, int, int, float, cudaStream_t)
#if DSTT_PART == 0
template DSTT_LAUNCH_16(0, tc::bf16);
template DSTT_LAUNCH_16(0, __half);
#else
extern template DSTT_LAUNCH_16(0, tc::bf16);
extern template DSTT_LAUNCH_16(0, __half);
#endif
#if DSTT_PART == 1
template DSTT_LAUNCH_16(8, tc::bf16);
template DSTT_LAUNCH_16(8, __half);
#else
extern template DSTT_LAUNCH_16(8, tc::bf16);
extern template DSTT_LAUNCH_16(8, __half);
#endif
#if DSTT_PART == 2
template DSTT_LAUNCH_16(4, tc::bf16);
template DSTT_LAUNCH_16(4, __half);
#else
extern template DSTT_LAUNCH_16(4, tc::bf16);
extern template DSTT_LAUNCH_16(4, __half);
#endif
#undef DSTT_LAUNCH_16
#endif

}  // namespace dstt_paged_decode

#if !defined(DSTT_PART) || DSTT_PART == 0
namespace {

using dstt_paged_decode::launch_16;

template <int KV_BITS>
int launch_dtype(const void* q, const void* pk, const void* pv,
                 const float* ks, const float* vs, const void* lengths,
                 const void* tables, void* o, int B, int H, int Hkv, int D,
                 int parts, int blk, int npages, int nsplit, int split_len,
                 float sm_scale, int dtype, cudaStream_t st) {
  if (dtype == 0)
    return launch<float, KV_BITS>(q, pk, pv, ks, vs, lengths, tables, o, B,
                                  H, Hkv, D, blk, npages, sm_scale, st);
  if (dtype == 1)
    return launch_16<KV_BITS, tc::bf16>(q, pk, pv, ks, vs, lengths, tables, o,
                                        B, H, Hkv, D, parts, blk, npages,
                                        nsplit, split_len, sm_scale, st);
  if (dtype == 2)
    return launch_16<KV_BITS, __half>(q, pk, pv, ks, vs, lengths, tables, o,
                                      B, H, Hkv, D, parts, blk, npages,
                                      nsplit, split_len, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  q/o [B, H, D]; pools
// [num_blocks, blk, Hkv, D]; lengths [B] int32; tables [B, npages] int32.
// bfloat16 and float16: D a multiple of 8 up to 256; nsplit (1..8) splits of
// split_len rows, nsplit * split_len >= npages * blk, form one cluster per
// (slot, kv head, part); each kv head's group in `parts` blocks of
// (H / Hkv) / parts heads, (H / Hkv / parts) * D <= 2048.  float32 (a
// query group of 1, 2, 4 or 8) ignores nsplit, split_len and parts.
extern "C" int dstt_paged_decode_attention(
    const void* q, const void* pk, const void* pv, const void* lengths,
    const void* tables, void* o, int B, int H, int Hkv, int D, int parts,
    int blk, int npages, int nsplit, int split_len, float sm_scale,
    int dtype, void* stream) {
  if (D > kMaxD || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dtype<0>(q, pk, pv, nullptr, nullptr, lengths, tables, o, B,
                         H, Hkv, D, parts, blk, npages, nsplit, split_len,
                         sm_scale, dtype, static_cast<cudaStream_t>(stream));
}

// The quantized pools: kv_bits 8 (int8 pools [num_blocks, blk, Hkv, D]) or
// 4 (packed int4, [num_blocks, blk, Hkv, D / 2] int8), scales
// [num_blocks, blk, Hkv] f32; q, o, the split plan and the parts as
// above.  Needs D a multiple of 8 and at most 256.
extern "C" int dstt_paged_decode_attention_quant(
    const void* q, const void* pk, const void* pv, const void* k_scale,
    const void* v_scale, const void* lengths, const void* tables, void* o,
    int B, int H, int Hkv, int D, int parts, int blk, int npages, int nsplit,
    int split_len, float sm_scale, int dtype, int kv_bits, void* stream) {
  if (D > kMaxD || D % 8 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_bits == 8)
    return launch_dtype<8>(q, pk, pv, ks, vs, lengths, tables, o, B, H, Hkv,
                           D, parts, blk, npages, nsplit, split_len, sm_scale,
                           dtype, st);
  if (kv_bits == 4)
    return launch_dtype<4>(q, pk, pv, ks, vs, lengths, tables, o, B, H, Hkv,
                           D, parts, blk, npages, nsplit, split_len, sm_scale,
                           dtype, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

DSTT_DEFINE_ERROR_STRING(dstt_paged_decode_attention)
#endif  // part 0

// Shared device helpers for the port's attention kernels (decode,
// paged decode, paged prefill): 16-byte vector loads of bf16/f16/f32 rows
// and 8-/4-byte loads of int8/packed-int4 rows (times their f32 scale)
// into f32 registers, and the online-softmax state (running max m,
// running sum l, f32 accumulator) with its merge rule.
//
// Convention shared by every kernel here: a key/value row at or past a
// sequence's valid length is never loaded, and neither is its scale in a
// quantized pool.  Its registers hold zeros and
// its score is -inf, so a recycled pool block holding NaN/inf garbage
// cannot reach the accumulator (0 * NaN never happens), and a row set
// with no valid key ends with l == 0 and is written as zeros through
// 1 / max(l, 1e-30).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dstt {

#define DSTT_NEG_INF (-INFINITY)

// Dynamic shared memory one block can use on sm_90 (227 KB).
constexpr size_t kMaxSmem = 232448;

// X(D) for every head dim of the flash and block-sparse kernels (B1-B4,
// B8-B10): the multiples of 16 up to 256.
#define DSTT_FLASH_HEAD_DIMS(X)                                            \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(144) X(160) X(176) \
  X(192) X(208) X(224) X(240) X(256)

// X(D) for every head dim of the decode kernels (B5, B6, B7): the
// multiples of 8 up to 256, the reference's `head_dim % 8` gate.
#define DSTT_DECODE_HEAD_DIMS(X)                                           \
  X(8) X(16) X(24) X(32) X(40) X(48) X(56) X(64) X(72) X(80) X(88) X(96) \
  X(104) X(112) X(120) X(128) X(136) X(144) X(152) X(160) X(168) X(176)  \
  X(184) X(192) X(200) X(208) X(216) X(224) X(232) X(240) X(248) X(256)

// elements of T in one 16-byte load
template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int N = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int N = 8; };
template <> struct VecWidth<__half> { static constexpr int N = 8; };

__device__ __forceinline__ void load_vec(const float* p, float (&out)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&out)[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load_vec(const __half* p, float (&out)[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float (&in)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&in)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ void store_vec(__half* p, const float (&in)[8]) {
  uint4 v;
  __half2* h = reinterpret_cast<__half2*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}

// Merge online-softmax state (m2, l2, acc2) into (m, l, acc).  Either
// side may be empty (m == -inf, l == 0, acc == 0).
template <int N>
__device__ __forceinline__ void merge_state(float& m, float& l,
                                            float (&acc)[N], float m2,
                                            float l2, const float (&acc2)[N]) {
  const float mn = fmaxf(m, m2);
  if (mn == DSTT_NEG_INF) return;  // both empty
  const float a = expf(m - mn);    // exp(-inf) == 0 for an empty side
  const float b = expf(m2 - mn);
  l = a * l + b * l2;
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = a * acc[i] + b * acc2[i];
  m = mn;
}

// Butterfly-merge the states held by the lane groups of one warp: lanes
// (lane ^ off) for off >= lanes_per_row hold the same feature slice of
// another group's state.  After the loop every lane holds the merged
// state of its feature slice.
template <int G, int N>
__device__ __forceinline__ void warp_merge_groups(float (&m)[G], float (&l)[G],
                                                  float (&acc)[G][N],
                                                  int lanes_per_row) {
  for (int off = lanes_per_row; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[g], off);
      float acc2[N];
#pragma unroll
      for (int i = 0; i < N; ++i)
        acc2[i] = __shfl_xor_sync(0xffffffffu, acc[g][i], off);
      merge_state<N>(m[g], l[g], acc[g], m2, l2, acc2);
    }
  }
}

// Online-softmax walk of one warp over key rows for G query heads that
// share one kv head.  The warp is split into groups of `lanes_per_row`
// lanes; each group owns one key row at a time, each lane a slice of N
// features.  Group r of the warp visits positions warp_first + r + j *
// p_step (j = 0, 1, ...) below p_end, U rows per iteration, so that 2 * U
// independent row loads are in flight per lane.  `load_row(p, kf, vf)`
// widens this lane's slice of position p's key and value rows to f32; it
// is called only for p < p_end, so a row (or a scale) at or past the
// length is never read.  The trip count depends only on warp-uniform
// values, and every lane of the warp must call this: the shuffles use the
// full mask.
template <int G, int N, int U, typename LoadRow>
__device__ __forceinline__ void attend_rows_with(
    const float (&q)[G][N], LoadRow load_row, int lanes_per_row,
    int warp_first, int row_in_warp, int p_end, int p_step, float sm_scale,
    float (&m)[G], float (&l)[G], float (&acc)[G][N]) {
  for (int w0 = warp_first; w0 < p_end; w0 += U * p_step) {
    float kf[U][N], vf[U][N];
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = w0 + row_in_warp + u * p_step;
      valid[u] = p < p_end;
      if (valid[u]) {
        load_row(p, kf[u], vf[u]);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) { kf[u][i] = 0.f; vf[u][i] = 0.f; }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i) d = fmaf(q[g][i], kf[u][i], d);
        for (int off = lanes_per_row >> 1; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        s[u] = valid[u] ? d * sm_scale : DSTT_NEG_INF;
      }
      float mx = s[0];
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, s[u]);
      const float m_new = fmaxf(m[g], mx);
      if (m_new != DSTT_NEG_INF) {  // else: no valid row seen yet
        const float alpha = expf(m[g] - m_new);
        float psum = 0.f;
        float p[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          p[u] = expf(s[u] - m_new);  // 0 for masked rows
          psum += p[u];
        }
        l[g] = alpha * l[g] + psum;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          float a = alpha * acc[g][i];
#pragma unroll
          for (int u = 0; u < U; ++u) a = fmaf(p[u], vf[u][i], a);
          acc[g][i] = a;
        }
        m[g] = m_new;
      }
    }
  }
}

// attend_rows_with over rows of T: lane slices of N = 16 / sizeof(T)
// elements at element offset `lane_off` of the row that `row_offset(p)`
// gives, one 16-byte load each.
template <typename T, int G, int U, typename RowOffset>
__device__ __forceinline__ void attend_rows(
    const float (&q)[G][VecWidth<T>::N], const T* __restrict__ k,
    const T* __restrict__ v, RowOffset row_offset, int lane_off,
    int lanes_per_row, int warp_first, int row_in_warp, int p_end,
    int p_step, float sm_scale, float (&m)[G], float (&l)[G],
    float (&acc)[G][VecWidth<T>::N]) {
  constexpr int N = VecWidth<T>::N;
  attend_rows_with<G, N, U>(
      q,
      [=](int p, float (&kf)[N], float (&vf)[N]) {
        const size_t off = row_offset(p) + lane_off;
        load_vec(k + off, kf);
        load_vec(v + off, vf);
      },
      lanes_per_row, warp_first, row_in_warp, p_end, p_step, sm_scale, m,
      l, acc);
}

// Eight features of one row of an int8 or packed-int4 KV pool, widened to
// f32 and multiplied by the row's scale: the in-kernel decode of
// ops/quantizer/quantizer.py::kv_dequantize (sign-extended ints, one f32
// product each).  int8: bytes [p, p + 8) are eight consecutive features.
// int4, split by feature: bytes [p, p + 4) of a row hold features j .. j + 3
// in their low nibbles (out[0..3]) and j + D/2 .. j + D/2 + 3 in their high
// nibbles (out[4..7]); both are sign-extended by arithmetic shifts.
template <int KV_BITS>
__device__ __forceinline__ void load_quant_vec(const int8_t* p, float scale,
                                               float (&out)[8]);

template <>
__device__ __forceinline__ void load_quant_vec<8>(const int8_t* p,
                                                  float scale,
                                                  float (&out)[8]) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[i] = static_cast<float>(static_cast<int>(w.x << (24 - 8 * i)) >> 24)
             * scale;
    out[4 + i] =
        static_cast<float>(static_cast<int>(w.y << (24 - 8 * i)) >> 24) *
        scale;
  }
}

template <>
__device__ __forceinline__ void load_quant_vec<4>(const int8_t* p,
                                                  float scale,
                                                  float (&out)[8]) {
  const unsigned w = __ldg(reinterpret_cast<const unsigned*>(p));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[i] = static_cast<float>(static_cast<int>(w << (28 - 8 * i)) >> 28) *
             scale;
    out[4 + i] =
        static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 28) * scale;
  }
}

// The row feature that element i of a lane's 8-feature slice holds, for
// the lane at slice index `slice` of a quantized row of D features
// (load_quant_vec's layout).
template <int KV_BITS>
__device__ __forceinline__ int quant_feature(int slice, int i, int D) {
  if (KV_BITS == 4) return i < 4 ? slice * 4 + i : D / 2 + slice * 4 + i - 4;
  return slice * 8 + i;
}

}  // namespace dstt

// Every library exports its own error-string helper so the Python
// wrapper can name a failed launch.
#define DSTT_DEFINE_ERROR_STRING(prefix)                              \
  extern "C" const char* prefix##_error_string(int code) {            \
    return cudaGetErrorString(static_cast<cudaError_t>(code));        \
  }

// The two tensor-core walks of the bf16 block-sparse attention backward:
// B9 (dq pass) and B10 (dk/dv pass).  They are B3's and B4's walks
// (flash_bwd_mma.cuh) over one row of a layout's tile lists in place of a
// dense range of tiles, with a sub-block mask on the tile pairs that a
// layout covers only in part, on the same flash_mma.cuh primitives.
//
// They are written apart from flash_bwd_mma.cuh: one template with the
// tile source as a compile-time policy, dense for B2-B4 and a list here,
// gave B2-B4 their bits but not their code (on an H100 it moved B2's and
// B3's register counts and slowed B4 by more than 3 %), and B2-B4 are
// held to their code.
//
// With p = exp(q k^T * sm_scale - lse) and ds = p * (dO v^T - delta) *
// sm_scale (lse and delta of the query row), 0 outside the layout and,
// when causal, above the diagonal:
//   bsa_dq_walk:  dq = ds k over the kv tiles of a query tile's list;
//   bsa_dkv_walk: dv = p^T dO and dk = ds^T q over the query tiles of a
//                 kv tile's (transposed) list.
// p is rounded to bf16 before the dv product and ds before the dq and dk
// products (the JAX kernels' rounding points); every sum is f32.  No
// atomics: each output row is written once by one block, so two launches
// give the same bits.
//
// A pair is masked element by element only where it needs it: the causal
// diagonal pair, a pair holding rows at or past T, or a pair whose
// sub-block mask is not full.  Every other pair keeps every element.  The
// designs are described where the kernels are
// (blocksparse_flash_bwd_{dq,dkv}.cu).  Rows at or past T are zero-filled
// by cp.async and never read.
#pragma once

#include "flash_bwd_mma.cuh"

namespace dstt {
namespace mma {

// One row of a block-sparse layout's tile lists (B9: the kv tiles of query
// tile `own`; B10: the query tiles that read kv tile `own`), in increasing
// order: entry i is tile idx[off + i], with the mask bits[off + i] of its
// sub-blocks of 1 << shift rows (shift 4, 5 or 6).  In both lists bit
// 4 a + b is QUERY sub-block a and KEY sub-block b: the transposed lists
// transpose the tile grid, not the bits inside a pair.  idx, bits and
// shift are the kernel's own arguments and the row an offset into them,
// so the walk holds one index, not two moving pointers.
struct TileList {
  const int* idx;
  const int* bits;
  int off, n, own, shift;
  __device__ __forceinline__ int tile(int i) const { return idx[off + i]; }
  __device__ __forceinline__ unsigned mask(int i) const {
    return static_cast<unsigned>(bits[off + i]);
  }
  // whether a pair with mask m lacks some sub-block of the layout
  __device__ __forceinline__ bool partial(unsigned m) const {
    return m != (shift == 6 ? 0x1u : shift == 5 ? 0x33u : 0xFFFFu);
  }
  // Causal: leave out the pairs whose every element is above the
  // diagonal, which a layout block of 128 rows or more lists on its
  // diagonal (they would add p = ds = 0): kv tiles past the query tile, at
  // the end of a dq list, or query tiles before the kv tile, at the start
  // of a dk/dv list.
  __device__ __forceinline__ void drop_after(int last) {
    while (n > 0 && tile(n - 1) > last) --n;
  }
  __device__ __forceinline__ void drop_before(int first) {
    while (n > 0 && tile(0) < first) {
      ++off;
      --n;
    }
  }
  // The columns a warp keeps in a pair with mask m: bit g of the result
  // stands for columns 8 g .. 8 g + 7 of the tile (the columns of C tile g
  // of an m16n8 product row).  A warp's 16 rows lie in one sub-block, row
  // block m0 >> shift, so the element loop tests one bit at a constant
  // position (a sub-block index a column cost B10 registers it lacks).
  // dq walk: the rows are query rows and the columns key rows.
  __device__ __forceinline__ unsigned dq_columns(unsigned m, int m0) const {
    return groups((m >> ((m0 >> shift) << 2)) & 0xFu);
  }
  // dk/dv walk: the rows are key rows and the columns query rows, bit 4 a
  // of m >> (key block) for query block a.
  __device__ __forceinline__ unsigned dkv_columns(unsigned m, int m0) const {
    const unsigned x = (m >> (m0 >> shift)) & 0x1111u;
    return groups((x | (x >> 3) | (x >> 6) | (x >> 9)) & 0xFu);
  }
  // bit a of c (column sub-block a set) spread over the 8-column groups
  // of sub-block a: 8, 4 or 2 of them at shift 6, 5 or 4
  __device__ __forceinline__ unsigned groups(unsigned c) const {
    if (shift == 6) return (c & 1u) * 0xFFu;
    if (shift == 5) return (c & 1u) * 0x0Fu | ((c >> 1) & 1u) * 0xF0u;
    const unsigned t = (c & 1u) | ((c & 2u) << 1) | ((c & 4u) << 2) |
                       ((c & 8u) << 3);
    return t * 3u;
  }
};

// dq of query tile walk.own of head row bh over the kv tiles of `walk`
// (B3's dq_walk at g = 1 over a list).  q/k/v/dout/dq [BH, T, D], lse and
// delta [BH, T].  An empty walk loads nothing and writes zeros.
template <int D, typename ET = bf16>
__device__ __forceinline__ void bsa_dq_walk(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int t_len, float sm_scale, int causal,
    size_t bh, const TileList& walk, unsigned char* smem_raw) {
  constexpr int E = Tile<D>::kElems, T64 = kTile;
  constexpr int NT = D / 8;        // C tiles across the head dim
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][D + 8]
  bf16* dos = qs + E;                            // [64][D + 8]
  bf16* kvs = dos + E;  // 2 stages of K then V, [64][D + 8] each

  const size_t base = bh * t_len * D;
  const int qt = walk.own, q0 = qt * T64;
  const int n_walk = walk.n;
  const int m0 = 16 * (threadIdx.x >> 5);  // this warp's rows in the tile
  const float scale2 = sm_scale * kLog2e;

  if (n_walk > 0) {
    load_tile_async<D>(q + base, q0, t_len, qs);
    load_tile_async<D>(dout + base, q0, t_len, dos);
    load_tile_async<D>(k + base, walk.tile(0) * T64, t_len, kvs);
    load_tile_async<D>(v + base, walk.tile(0) * T64, t_len, kvs + E);
  }
  cp_async_commit();

  // lse (times log2 e) and delta of this lane's rows g and g + 8
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + m0 + frag_row(2 * h);
    const bool ok = row < t_len;
    lse2[h] = ok ? lse[bh * t_len + row] * kLog2e : 0.f;
    dlt[h] = ok ? delta[bh * t_len + row] : 0.f;
  }
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  RowFrags<D, (D <= 64)> qf, dof;

  for (int w = 0; w < n_walk; ++w) {
    if (w + 1 < n_walk) {  // the next tile into the other stage
      bf16* nxt = kvs + ((w + 1) & 1) * 2 * E;
      const int k_next = walk.tile(w + 1) * T64;
      load_tile_async<D>(k + base, k_next, t_len, nxt);
      load_tile_async<D>(v + base, k_next, t_len, nxt + E);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and, at w 0, Q and dO) landed
    __syncthreads();
    if (w == 0) {
      qf.fill(qs, m0);
      dof.fill(dos, m0);
    }
    const int kt = walk.tile(w), k0 = kt * T64;
    const unsigned sub = walk.mask(w);
    const unsigned cols = walk.dq_columns(sub, m0);
    const bf16* ks = kvs + (w & 1) * 2 * E;
    const bf16* vs = ks + E;

    // S = Q K^T and dP = dO V^T: 16 rows x 64 kv columns a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], ad[4];
      qf.get(a, qs, m0, kk);
      dof.get(ad, dos, m0, kk);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        load_b_nk<D>(b, ks, 16 * jp, 16 * kk);
        mma_pair<ET>(s[2 * jp], s[2 * jp + 1], a, b);
        load_b_nk<D>(b, vs, 16 * jp, 16 * kk);
        mma_pair<ET>(dp[2 * jp], dp[2 * jp + 1], ad, b);
      }
    }

    // p and ds on the fragments; masks only on the diagonal / ragged
    // pairs and those the layout holds in part
    const bool edge = (causal && kt == qt) || k0 + T64 > t_len ||
                      q0 + T64 > t_len || walk.partial(sub);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + m0 + frag_row(i);
        const int col = k0 + 8 * j + frag_col(i);
        const bool keep = !edge || (row < t_len && col < t_len &&
                                    (!causal || col <= row) &&
                                    ((cols >> j) & 1u));
        softmax_grad(s[j][i], dp[j][i], lse2[i >> 1], dlt[i >> 1], scale2,
                     sm_scale, keep);
      }

    // dQ += dS K: ds (now in dp) packed to bf16 A fragments, K by .trans
#pragma unroll
    for (int kk = 0; kk < T64 / 16; ++kk) {
      uint32_t a[4];
      c_to_a<ET>(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) {
        uint32_t b[4];
        load_b_kn<D>(b, ks, 16 * kk, 16 * jj);
        mma_pair<ET>(acc[2 * jj], acc[2 * jj + 1], a, b);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  store_acc<D, ET>(dq + base, q0 + m0, t_len, acc);
}

// dk and dv of kv tile walk.own of head row bh over the query tiles of
// `walk` (B4's dkv_walk at g = 1 over a list).  q/k/v/dout/dk/dv [BH, T,
// D], lse and delta [BH, T].  An empty walk loads nothing and writes
// zeros.  kOut: both outputs, or (above D 128) only dV or only dK, as in
// dkv_walk.
template <int D, typename ET = bf16, int kOut = kDkDv>
__device__ __forceinline__ void bsa_dkv_walk(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int t_len,
    float sm_scale, int causal, size_t bh, const TileList& walk,
    unsigned char* smem_raw) {
  constexpr int E = Tile<D>::kElems, T64 = kTile;
  constexpr int NT = D / 8;        // C tiles across the head dim
  constexpr int kChunk = kDkvChunk;
  constexpr bool kDk = kOut != kDvOnly, kDv = kOut != kDkOnly;
  // bf16 elements of one ring stage: Q, dO, then 2 x 64 f32 statistics
  constexpr int kStage = 2 * E + 4 * T64;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [64][D + 8]
  bf16* vs = ks + E;                             // [64][D + 8]
  // 2 stages of Q [64][D + 8], dO [64][D + 8], lse [64], delta [64] (f32)
  bf16* ring = vs + E;

  const size_t base = bh * t_len * D;
  const int kt = walk.own, k0 = kt * T64;
  const int n_walk = walk.n;
  const int m0 = 16 * (threadIdx.x >> 5);  // this warp's rows in the tile
  const float scale2 = sm_scale * kLog2e;

  // stage entry i: query tile walk.tile(i)
  auto load_entry = [&](int i) {
    bf16* st = ring + (i & 1) * kStage;
    float* stats = reinterpret_cast<float*>(st + 2 * E);
    const int q0 = walk.tile(i) * T64;
    load_tile_async<D>(q + base, q0, t_len, st);
    load_tile_async<D>(dout + base, q0, t_len, st + E);
    load_stats_async(lse + bh * t_len, delta + bh * t_len, q0, t_len, stats,
                     stats + T64);
  };
  if (n_walk > 0) {
    load_tile_async<D>(k + base, k0, t_len, ks);
    load_tile_async<D>(v + base, k0, t_len, vs);
    load_entry(0);
  }
  cp_async_commit();

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[j][i] = dv_acc[j][i] = 0.f;
  RowFrags<D, (D <= 64)> kf;
  RowFrags<D, false> vf;  // V from shared memory at each use, as in B4

  for (int i = 0; i < n_walk; ++i) {
    if (i + 1 < n_walk) load_entry(i + 1);  // into the other stage
    cp_async_commit();
    cp_async_wait<1>();  // this entry (and, at i 0, K and V) landed
    __syncthreads();
    if (i == 0) {
      kf.fill(ks, m0);
      vf.fill(vs, m0);
    }
    const bf16* qs = ring + (i & 1) * kStage;
    const bf16* dos = qs + E;
    const float* lse_s = reinterpret_cast<const float*>(qs + 2 * E);
    const float* delta_s = lse_s + T64;
    const int qt = walk.tile(i), q0 = qt * T64;
    const unsigned sub = walk.mask(i);
    const unsigned cols = walk.dkv_columns(sub, m0);
    const bool edge = (causal && qt == kt) || q0 + T64 > t_len ||
                      k0 + T64 > t_len || walk.partial(sub);

    // The two chunks stay a loop: unrolled, the chunk and sub-block state
    // outgrew the 168 registers of three blocks an SM and spilled at D 64.
#pragma unroll 1
    for (int qc = 0; qc < T64; qc += kChunk) {
      // S^T = K Q^T and dP^T = V dO^T: 16 kv rows x 32 query columns
      float s[kChunk / 8][4], dp[kChunk / 8][4];
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4], av[4];
        kf.get(a, ks, m0, kk);
        if constexpr (kDk) vf.get(av, vs, m0, kk);
#pragma unroll
        for (int jp = 0; jp < kChunk / 16; ++jp) {
          uint32_t b[4];
          load_b_nk<D>(b, qs, qc + 16 * jp, 16 * kk);
          mma_pair<ET>(s[2 * jp], s[2 * jp + 1], a, b);
          if constexpr (kDk) {
            load_b_nk<D>(b, dos, qc + 16 * jp, 16 * kk);
            mma_pair<ET>(dp[2 * jp], dp[2 * jp + 1], av, b);
          }
        }
      }

      // p^T and ds^T; lse and delta by column (query row).  A fragment's
      // row is a KV row and its column a QUERY row (dkv_columns).
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = qc + 8 * j + frag_col(e);  // column in the tile
          const int row = k0 + m0 + frag_row(e), col = q0 + c;
          const bool keep = !edge || (row < t_len && col < t_len &&
                                      (!causal || row <= col) &&
                                      ((cols >> (qc / 8 + j)) & 1u));
          softmax_grad(s[j][e], dp[j][e], lse_s[c] * kLog2e, delta_s[c],
                       scale2, sm_scale, keep);
        }

      // dV += p^T dO and dK += ds^T Q over this chunk's query rows
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        uint32_t pa[4], da[4];
        c_to_a<ET>(pa, s[2 * kk], s[2 * kk + 1]);
        c_to_a<ET>(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int jj = 0; jj < D / 16; ++jj) {
          uint32_t b[4];
          if constexpr (kDv) {
            load_b_kn<D>(b, dos, qc + 16 * kk, 16 * jj);
            mma_pair<ET>(dv_acc[2 * jj], dv_acc[2 * jj + 1], pa, b);
          }
          if constexpr (kDk) {
            load_b_kn<D>(b, qs, qc + 16 * kk, 16 * jj);
            mma_pair<ET>(dk_acc[2 * jj], dk_acc[2 * jj + 1], da, b);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  if constexpr (kDk) store_acc<D, ET>(dk + base, k0 + m0, t_len, dk_acc);
  if constexpr (kDv) store_acc<D, ET>(dv + base, k0 + m0, t_len, dv_acc);
}

}  // namespace mma
}  // namespace dstt

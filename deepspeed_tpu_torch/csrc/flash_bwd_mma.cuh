// The two tensor-core walks of the bf16 and f16 flash-attention backward,
// shared by B3 (dq pass), B4 (dk/dv pass) and B2 (the fused backward,
// both walks in one launch at g = 1).  Each is the whole body of one block; the
// kernels that call it only pick the block's head row and tile from the
// grid and hand over their dynamic shared memory.
//
// With p = exp(q k^T * sm_scale - lse) and ds = p * (dO v^T - delta) *
// sm_scale (lse and delta of the query row):
//   dq_walk:  dq = ds k over the kv tiles a query tile sees;
//   dkv_walk: dv = sum of p^T dO and dk = sum of ds^T q over the query
//             heads of a kv head's group and the query tiles that see the
//             kv tile.
// p is rounded to dO's dtype before the dv product and ds to q's before
// the dq and dk products (the JAX kernels' rounding points); every sum is
// f32.  No atomics: each output row is written once by one block, so two
// launches give the same bits.
//
// The designs are described where the kernels are: dq_walk in
// flash_attention_bwd_dq.cu (B3), dkv_walk in flash_attention_bwd_dkv.cu
// (B4).  Rows at or past T are zero-filled by cp.async and never read.
#pragma once

#include "flash_mma.cuh"

namespace dstt {
namespace mma {

// dynamic shared memory of each walk, in bytes
template <int D> constexpr size_t dq_walk_smem() {
  return sizeof(bf16) * 6 * Tile<D>::kElems;
}
template <int D> constexpr size_t dkv_walk_smem() {
  return sizeof(bf16) * 6 * Tile<D>::kElems + sizeof(float) * 4 * kTile;
}

// dq of query tile n_tiles - 1 - qx (the last tiles, with the longest
// causal walks, first) of query head row bh, whose kv head row is
// bh / group.  q/dout/dq [BH, T, D], k/v [BH / group, T, D], lse and
// delta [BH, T]; ET (bf16 or __half) is the operands' type.
template <int D, typename ET = bf16>
__device__ __forceinline__ void dq_walk(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int t_len, int group, float sm_scale, int causal,
    size_t bh, int qx, unsigned char* smem_raw) {
  constexpr int E = Tile<D>::kElems, T64 = kTile;
  constexpr int NT = D / 8;        // C tiles across the head dim
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][D + 8]
  bf16* dos = qs + E;                            // [64][D + 8]
  bf16* kvs = dos + E;  // 2 stages of K then V, [64][D + 8] each

  const int n_tiles = (t_len + T64 - 1) / T64;
  const size_t base = bh * t_len * D;
  const size_t kv_base = (bh / group) * t_len * D;
  const int qt = n_tiles - 1 - qx, q0 = qt * T64;
  const int m0 = 16 * (threadIdx.x >> 5);  // this warp's rows in the tile
  const float scale2 = sm_scale * kLog2e;

  load_tile_async<D>(q + base, q0, t_len, qs);
  load_tile_async<D>(dout + base, q0, t_len, dos);
  load_tile_async<D>(k + kv_base, 0, t_len, kvs);
  load_tile_async<D>(v + kv_base, 0, t_len, kvs + E);
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

  const int last_kt = causal ? qt : n_tiles - 1;
  for (int kt = 0; kt <= last_kt; ++kt) {
    if (kt < last_kt) {  // the next tile into the other stage
      bf16* nxt = kvs + ((kt + 1) & 1) * 2 * E;
      load_tile_async<D>(k + kv_base, (kt + 1) * T64, t_len, nxt);
      load_tile_async<D>(v + kv_base, (kt + 1) * T64, t_len, nxt + E);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and, at kt 0, Q and dO) landed
    __syncthreads();
    if (kt == 0) {
      qf.fill(qs, m0);
      dof.fill(dos, m0);
    }
    const bf16* ks = kvs + (kt & 1) * 2 * E;
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

    // p and ds on the fragments; masks only on the diagonal / ragged tiles
    const int k0 = kt * T64;
    const bool edge = (causal && kt == qt) || k0 + T64 > t_len ||
                      q0 + T64 > t_len;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + m0 + frag_row(i);
        const int col = k0 + 8 * j + frag_col(i);
        const bool keep = !edge || (row < t_len && col < t_len &&
                                    (!causal || col <= row));
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

// query columns of one S^T / dP^T chunk in dkv_walk (the fragments of 32
// columns leave room for dK, dV and K in registers at D = 64)
constexpr int kDkvChunk = 32;

// Which outputs a dkv walk accumulates: both (every head dim up to 128),
// or, above 128, where dK and dV together would need 2 x D / 2 f32
// accumulators a thread, one of them a block (the kernels launch one
// block of each kind per kv tile: the dV block skips the dP product, the
// dK block the P^T dO product, so the pair does five products where one
// walk does four).
enum DkvOut { kDkDv = 0, kDvOnly = 1, kDkOnly = 2 };

// Blocks of a kv tile at head dim D: one kDkDv block up to 128, else a
// kDvOnly and a kDkOnly block (blockIdx.z picks).
template <int D> __host__ __device__ constexpr int dkv_outs() {
  return D <= 128 ? 1 : 2;
}

// dk and dv of kv tile kt of kv head row kvh, summed over query head rows
// kvh * group .. kvh * group + group - 1.  q/dout [BKV * group, T, D],
// k/v/dk/dv [BKV, T, D], lse and delta [BKV * group, T]; ET (bf16 or
// __half) is the operands' type, kOut the outputs this block writes.
template <int D, typename ET = bf16, int kOut = kDkDv>
__device__ __forceinline__ void dkv_walk(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int t_len, int group,
    float sm_scale, int causal, size_t kvh, int kt,
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

  const int n_tiles = (t_len + T64 - 1) / T64;
  const size_t kv_base = kvh * t_len * D;
  const int k0 = kt * T64;
  const int m0 = 16 * (threadIdx.x >> 5);  // this warp's rows in the tile
  const float scale2 = sm_scale * kLog2e;
  const int qt0 = causal ? kt : 0, nq = n_tiles - qt0;
  const int n_pairs = group * nq;  // (query head, q tile) pairs to walk

  // stage pair i: query head kvh * g + i / nq, q tile qt0 + i % nq
  auto load_pair = [&](int i) {
    bf16* st = ring + (i & 1) * kStage;
    float* stats = reinterpret_cast<float*>(st + 2 * E);
    const size_t bh = kvh * group + i / nq;
    const int q0 = (qt0 + i % nq) * T64;
    load_tile_async<D>(q + bh * t_len * D, q0, t_len, st);
    load_tile_async<D>(dout + bh * t_len * D, q0, t_len, st + E);
    load_stats_async(lse + bh * t_len, delta + bh * t_len, q0, t_len, stats,
                     stats + T64);
  };
  load_tile_async<D>(k + kv_base, k0, t_len, ks);
  load_tile_async<D>(v + kv_base, k0, t_len, vs);
  load_pair(0);
  cp_async_commit();

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[j][i] = dv_acc[j][i] = 0.f;
  RowFrags<D, (D <= 64)> kf;
  RowFrags<D, false> vf;  // see the note at the top

  for (int i = 0; i < n_pairs; ++i) {
    if (i + 1 < n_pairs) load_pair(i + 1);  // into the other stage
    cp_async_commit();
    cp_async_wait<1>();  // this pair (and, at i 0, K and V) landed
    __syncthreads();
    if (i == 0) {
      kf.fill(ks, m0);
      vf.fill(vs, m0);
    }
    const bf16* qs = ring + (i & 1) * kStage;
    const bf16* dos = qs + E;
    const float* lse_s = reinterpret_cast<const float*>(qs + 2 * E);
    const float* delta_s = lse_s + T64;
    const int qt = qt0 + i % nq, q0 = qt * T64;
    const bool edge = (causal && qt == kt) || q0 + T64 > t_len ||
                      k0 + T64 > t_len;

#pragma unroll
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

      // p^T and ds^T; lse and delta by column (query row)
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = qc + 8 * j + frag_col(e);  // column in the tile
          const int row = k0 + m0 + frag_row(e), col = q0 + c;
          const bool keep = !edge || (row < t_len && col < t_len &&
                                      (!causal || row <= col));
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
  if constexpr (kDk) store_acc<D, ET>(dk + kv_base, k0 + m0, t_len, dk_acc);
  if constexpr (kDv) store_acc<D, ET>(dv + kv_base, k0 + m0, t_len, dv_acc);
}

}  // namespace mma
}  // namespace dstt

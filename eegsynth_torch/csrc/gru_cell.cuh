// The GRU cell's device code that K1's forward (gru_seq.cu) and K2
// (multigru.cu) share, and with them K1's cluster kernels
// (gru_seq_cluster.cu, gru_seq_cluster_bwd.cu): the sigmoid, the instances'
// block sizes and row groups, the shuffle butterfly over the S lanes of a
// dot product and the rows a lane holds after it, and one step of K1
// forward's row group. gru_seq.cu's header describes the design;
// both kernels compile this code as it stands, so K1's arithmetic is the
// same wherever it runs.

#pragma once

#include <cuda_runtime.h>

namespace {

// The sigmoid of both kernels, 1/2 + tanh(x/2)/2: the accurate tanhf and no
// division, whose correctly rounded reciprocal costs the gates a longer
// chain (16-17 % of the forward at every shape measured; PERF.md).
__device__ __forceinline__ float sigmoid_fwd(float x) {
  return fmaf(0.5f, tanhf(0.5f * x), 0.5f);
}

// An instance (KL, S, HM) of either kernel takes H <= HM. Its launch bound
// is its largest block, HM S threads rounded up to a warp; the registers
// that leaves a thread beside its 3 KL weights fix how many rows' sums it
// keeps at once (RG): 4 at KL 16, 2 at KL 32 (384 threads: 170 registers),
// 1 at KL 64.
template <int S, int HM>
constexpr int kBlockThreads = (HM * S + 31) / 32 * 32;

template <int KL>
constexpr int kRowGroup = KL == 16 ? 4 : KL == 32 ? 2 : 1;

// Adds the S lanes' partial sums of N rows (a[0..N), NV values a row: K1
// forward's three gates, its backward's one sum, K2's gates beside their
// projections) across the lanes at xor
// distance M, M / 2, ..., 1. While a lane holds more than one row, each
// round also halves its rows: the lane whose M bit is set keeps the upper
// half, its partner the lower, and `off` counts the rows passed over. Once
// one row is left, the rounds add it in place.
template <int RG, int M, int N, int NV>
__device__ __forceinline__ void reduce_rows(float (&a)[RG][NV], int s, int& off) {
  if constexpr (M >= 1) {
    if constexpr (N > 1) {
      constexpr int N2 = N / 2;
      const bool hi = (s & M) != 0;
#pragma unroll
      for (int i = 0; i < N2; ++i) {
#pragma unroll
        for (int g = 0; g < NV; ++g) {
          const float send = hi ? a[i][g] : a[i + N2][g];
          const float keep = hi ? a[i + N2][g] : a[i][g];
          a[i][g] = keep + __shfl_xor_sync(0xffffffffu, send, M);
        }
      }
      if (hi) off += N2;
      reduce_rows<RG, M / 2, N2>(a, s, off);
    } else {
#pragma unroll
      for (int g = 0; g < NV; ++g) a[0][g] += __shfl_xor_sync(0xffffffffu, a[0][g], M);
      reduce_rows<RG, M / 2, 1>(a, s, off);
    }
  }
}

// The first of the rows that lane s holds after reduce_rows<RG, M, N>: the
// lane whose M bit is set keeps the upper half of the rows each round.
template <int M, int N>
__device__ __forceinline__ int held_offset(int s) {
  if constexpr (M >= 1 && N > 1) {
    return ((s & M) ? N / 2 : 0) + held_offset<M / 2, N / 2>(s);
  } else {
    return 0;
  }
}

// One step of rows [g0, g0 + RG) of the tile's n rows: rows past n repeat
// row n - 1 (so every load is in bounds) and are not written.
template <int KL, int S, int RG>
__device__ __forceinline__ void fwd_rows(const float (&w)[3][KL], const float (&bias)[3],
                                         const float* __restrict__ h_cur,
                                         float* __restrict__ h_next,
                                         const float* __restrict__ x_cur,
                                         float* __restrict__ ys_t, int g0, int n,
                                         int s, int j, int hj, int H) {
  constexpr int P = S * (KL + 4);
  float a[RG][3];
#pragma unroll
  for (int u = 0; u < RG; ++u) {
    const float4* hv = reinterpret_cast<const float4*>(
        h_cur + min(g0 + u, n - 1) * P + s * (KL + 4));
    a[u][0] = a[u][1] = a[u][2] = 0.f;
#pragma unroll
    for (int q = 0; q < KL / 4; ++q) {
      const float4 h4 = hv[q];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        a[u][g] = fmaf(h4.x, w[g][4 * q], a[u][g]);
        a[u][g] = fmaf(h4.y, w[g][4 * q + 1], a[u][g]);
        a[u][g] = fmaf(h4.z, w[g][4 * q + 2], a[u][g]);
        a[u][g] = fmaf(h4.w, w[g][4 * q + 3], a[u][g]);
      }
    }
  }
  int off = 0;
  reduce_rows<RG, S / 2, RG>(a, s, off);
  constexpr int kHeld = RG >= S ? RG / S : 1;   // rows a lane holds
  constexpr int kShare = RG >= S ? 1 : S / RG;  // lanes holding the same row
  if (j < H && (s & (kShare - 1)) == 0) {
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      const int r = g0 + off + i;
      if (r < n) {
        const float* x = x_cur + r * 3 * H + j;
        const float h = h_cur[r * P + hj];
        const float rg = sigmoid_fwd(x[0] + (a[i][0] + bias[0]));
        const float zg = sigmoid_fwd(x[H] + (a[i][1] + bias[1]));
        const float ng = tanhf(x[2 * H] + rg * (a[i][2] + bias[2]));
        const float hn = (1.0f - zg) * ng + zg * h;
        h_next[r * P + hj] = hn;
        ys_t[r * H + j] = hn;
      }
    }
  }
}

}  // namespace

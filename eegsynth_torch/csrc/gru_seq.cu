// GRU sequence kernel (K1) for Hopper, sm_90a: forward and backward, with a
// leading bucket axis.
//
// Replaces the TPU kernel eegsynth/nn/pallas_gru.py:_gru_seq_pallas (Pallas
// body _gru_seq_kernel) and its custom VJP _gru_seq_bwd (an XLA reverse scan
// in the JAX package): the whole recurrence of one GRU layer in one launch,
// for nb independent models (buckets) at once.
//
//   xp (nb, T, B, 3H)  hoisted input projection x W_ih^T + b_ih, gates [r, z, n]
//   w_hh_t (nb, H, 3H) = W_hh^T,  b_hh (nb, 3H),  h0 (nb, B, H)
//   -> ys (nb, T, B, H), f32
//
//   hp = h W_hh^T + b_hh
//   r  = sigmoid(xp_r + hp_r)      z = sigmoid(xp_z + hp_z)
//   n  = tanh(xp_n + r * hp_n)     h' = (1 - z) n + z h
//
// What bounds it on this card: a chain of T dependent small products, each a
// (rows x H) @ (H x 3H) with an H-deep dot product per output (56 at the
// serving width), then the gates. Reading xp and writing ys is the only HBM
// traffic, spread evenly over the run, and the arithmetic is a few MFLOP a
// step, so neither bandwidth nor FLOP/s bounds it: one step's latency,
// times T, does. clock64() timers on an H100 (PERF.md) put a step at
// the serving shape at about 1,100 cycles: a third the gates, a quarter
// the sums, a third the copies, the wait and the barrier. At the training
// shape (9 rows a block, 7 warps on the SM's 4 schedulers) a step takes
// about 3,500 cycles, most of it issuing the sums and the gates of its
// three groups of rows.
//
// Batch rows and buckets are independent, so the grid runs over (tile of
// `rows` batch rows, bucket) and each block walks all T steps in a loop; no
// block ever waits on another. rows = ceil(nb B / #SMs) gives one tile per
// SM: B = 256, nb = 1 (serving) is 2 rows x 128 blocks; B = 63, nb = 18
// (training) is 9 rows x 7 tiles x 18 buckets = 126 blocks.
//
// Forward: weights stationary, the dot product split across lanes.
//  - Thread (j, s), s < S, holds the KL-long k-slice s of W_hh^T's columns
//    j, H + j and 2H + j in 3 KL registers, loaded once before the time loop
//    (zeros at k >= H, and at j >= H for the threads that pad the block to
//    whole warps). KL is 16 up to H 64, 32 up to H 96 and 64 up to H 128;
//    S, the power of two at or above ceil(H / KL), is at most 4, and the S
//    lanes of one j are neighbours in one warp. The block has H S threads
//    rounded up to a warp: 224 at H 56.
//  - Registers: each instance (KL, S, largest H) has its largest block as
//    its launch bound, so a thread may hold 65,536 / bound registers. KL 16:
//    48 weights under 255; KL 32 to H 96: 96 weights under 170 (384
//    threads); KL 64 to H 128: 192 weights under 255 (256 threads). KL 32
//    at H 128 would need 512 threads and leave 128 registers, and spilled.
//    ptxas must report no spills for any instance (chip_smoke.py checks).
//  - h lies in shared memory, double-buffered, in slices of KL values at a
//    pitch of KL + 4 floats (so the S slices a quarter warp reads lie in
//    distinct banks), zeros past H: a thread reads its slice of a row as
//    float4s with no bound check.
//  - Each thread serves every row of its block, a group of RG rows at a time
//    (RG = 4 at KL 16, 2 at KL 32, 1 at KL 64; the ragged tail takes a
//    group of RG / 2 where that covers it). For each row of a group it sums
//    its slice into three accumulators, a fully unrolled chain of KL
//    multiply-adds each, so 3 RG chains run side by side. Registers do not
//    grow with rows, so rows needs no register cap; shared memory is its
//    only cap. (One group of all of a step's rows was slower: its rows did
//    not spread over the lanes, so the gates ran deeper on fewer lanes.)
//  - The S partial sums are added with __shfl_xor_sync, log2 S rounds that
//    also scatter the group's rows over the lanes (lane s ends up with row
//    s of a 4-row group). Every row is summed in the same order: slices k
//    and k + S/2 first, then their sums at distance S/4, and so on
//    (tests/test_torch_gru.py emulates it).
//  - The lane holding a row's sums computes its gates, writes h' to the
//    next h buffer and to ys: one barrier a step. The transcendentals are
//    spread over the lanes.
//  - xp arrives through a ring of kRing steps in shared memory, filled by
//    cp.async kRing - 1 steps ahead: a block's rows of one step are rows x 3H
//    contiguous floats, copied 16 bytes at a time where 3H % 4 == 0 and xp is
//    16-byte aligned, 4 bytes otherwise.
//  - No tensor cores: a step's product is at most (9 x 56) @ (56 x 168), and
//    split-TF32 mma.sync would put a chain of about 21 dependent products on
//    each step, which does not shorten the latency that bounds the kernel.
// Backward (exact reverse-time BPTT of _gru_seq_bwd): one thread owns one
//    (row, j), keeps W_hh^T in shared memory and carries dh[row, j] in a
//    register from t = T-1 down to 0. Each step recomputes r, z, n from
//    h_prev (ys[t-1] or h0) with the forward's product, writes dxp[t] and
//    the n-gate part of dhp (dn_pre * r; the r and z parts equal dxp's),
//    then takes the second product dh_prev = dh z + dhp W_hh. That product
//    reads W_hh^T by row (stride 3H): the shared copy is stored with a pitch
//    of 3H + 1 floats, so 32 neighbouring threads hit 32 different banks.
//    Two barriers per step: after h_prev is in shared memory, and after the
//    dhp row is. dW_hh^T = h_prev^T dhp and db_hh = sum dhp are left to one
//    batched matrix product after the kernel (no atomics across blocks,
//    deterministic).
// The accurate expf and tanhf (not the fast-math intrinsics, and no
// --use_fast_math) keep the kernels within 1e-4 of the plain PyTorch
// versions over 1024 dependent steps; the forward's sigmoid is
// 1/2 + tanhf(x/2)/2 (sigmoid_fwd), the backward's 1/(1 + expf(-x)).
// The kernels allocate nothing and do not synchronise: the caller owns the
// outputs and the stream.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "tf32_wgmma.cuh"  // cp_async4, cp_async16, cp_async_commit, cp_async_wait

namespace {

constexpr int kMaxHidden = 128;
constexpr int kMaxThreads = 1024;
constexpr int kRing = 16;  // steps of xp in the forward's ring (8 and 16 measured)

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The forward's sigmoid, 1/2 + tanh(x/2)/2: the accurate tanhf and no
// division, whose correctly rounded reciprocal costs the gates a longer
// chain (16-17 % of the forward at every shape measured; PERF.md).
__device__ __forceinline__ float sigmoid_fwd(float x) {
  return fmaf(0.5f, tanhf(0.5f * x), 0.5f);
}

// An instance (KL, S, HM) takes H <= HM. Its launch bound is its largest
// block, HM S threads rounded up to a warp; the registers that leaves a
// thread beside its 3 KL weights fix how many rows' sums it keeps at once
// (RG): 4 at KL 16, 2 at KL 32 (384 threads: 170 registers), 1 at KL 64.
template <int S, int HM>
constexpr int kFwdThreads = (HM * S + 31) / 32 * 32;

template <int KL>
constexpr int kFwdGroup = KL == 16 ? 4 : KL == 32 ? 2 : 1;

// Adds the S lanes' partial sums of N rows (a[0..N)) across the lanes at
// xor distance M, M / 2, ..., 1. While a lane holds more than one row, each
// round also halves its rows: the lane whose M bit is set keeps the upper
// half, its partner the lower, and `off` counts the rows passed over. Once
// one row is left, the rounds add it in place.
template <int RG, int M, int N>
__device__ __forceinline__ void reduce_rows(float (&a)[RG][3], int s, int& off) {
  if constexpr (M >= 1) {
    if constexpr (N > 1) {
      constexpr int N2 = N / 2;
      const bool hi = (s & M) != 0;
#pragma unroll
      for (int i = 0; i < N2; ++i) {
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const float send = hi ? a[i][g] : a[i + N2][g];
          const float keep = hi ? a[i + N2][g] : a[i][g];
          a[i][g] = keep + __shfl_xor_sync(0xffffffffu, send, M);
        }
      }
      if (hi) off += N2;
      reduce_rows<RG, M / 2, N2>(a, s, off);
    } else {
#pragma unroll
      for (int g = 0; g < 3; ++g) a[0][g] += __shfl_xor_sync(0xffffffffu, a[0][g], M);
      reduce_rows<RG, M / 2, 1>(a, s, off);
    }
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

template <int KL, int S, int HM>
__global__ void __launch_bounds__((kFwdThreads<S, HM>))
gru_seq_fwd_kernel(const float* __restrict__ xp, const float* __restrict__ w_hh_t,
                   const float* __restrict__ b_hh, const float* __restrict__ h0,
                   float* __restrict__ ys, int T, int B, int H, int rows, int vec) {
  constexpr int P = S * (KL + 4);  // row pitch of h in shared memory
  constexpr int RG = kFwdGroup<KL>;
  extern __shared__ __align__(16) float fwd_smem[];
  const int G = 3 * H;
  const size_t bucket = blockIdx.y;
  xp += bucket * T * B * G;
  ys += bucket * T * B * H;
  w_hh_t += bucket * H * G;
  b_hh += bucket * G;
  h0 += bucket * B * H;

  const int b0 = blockIdx.x * rows;
  const int n = min(rows, B - b0);       // rows of this tile
  float* h_s = fwd_smem;                 // two buffers of (rows, P)
  float* x_s = fwd_smem + 2 * rows * P;  // kRing steps of (rows, 3H)

  const int j = threadIdx.x / S;
  const int s = threadIdx.x % S;
  const int hj = (j / KL) * (KL + 4) + j % KL;  // h[., j] within a row
  float w[3][KL], bias[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    bias[g] = j < H ? b_hh[g * H + j] : 0.f;
#pragma unroll
    for (int kk = 0; kk < KL; ++kk) {
      const int k = s * KL + kk;
      w[g][kk] = j < H && k < H ? w_hh_t[(size_t)k * G + g * H + j] : 0.f;
    }
  }

  for (int i = threadIdx.x; i < 2 * rows * P; i += blockDim.x) h_s[i] = 0.f;
  __syncthreads();
  for (int i = threadIdx.x; i < n * H; i += blockDim.x) {
    const int r = i / H, c = i - r * H;
    h_s[r * P + (c / KL) * (KL + 4) + c % KL] = h0[(size_t)(b0 + r) * H + c];
  }

  // xp of step t for this tile: n 3H contiguous floats, into slot t % kRing
  const int len = n * G;
  auto fetch = [&](int t) {
    const float* src = xp + ((size_t)t * B + b0) * G;
    float* dst = x_s + (t % kRing) * rows * G;
    if (vec) {
      for (int i = 4 * threadIdx.x; i < len; i += 4 * blockDim.x)
        cp_async16(dst + i, src + i, 16);
    } else {
      for (int i = threadIdx.x; i < len; i += blockDim.x) cp_async4(dst + i, src + i, 4);
    }
  };
#pragma unroll
  for (int t = 0; t < kRing - 1; ++t) {
    if (t < T) fetch(t);
    cp_async_commit();
  }
  cp_async_wait<kRing - 2>();
  __syncthreads();  // h0 and step 0's xp are in place

  for (int t = 0; t < T; ++t) {
    // the slot refilled here was read in step t - 1, before the last barrier
    if (t + kRing - 1 < T) fetch(t + kRing - 1);
    cp_async_commit();
    const float* h_cur = h_s + (t & 1) * rows * P;
    float* h_next = h_s + ((t + 1) & 1) * rows * P;
    const float* x_cur = x_s + (t % kRing) * rows * G;
    float* ys_t = ys + ((size_t)t * B + b0) * H;
    int g0 = 0;
    for (; g0 + RG <= n; g0 += RG)
      fwd_rows<KL, S, RG>(w, bias, h_cur, h_next, x_cur, ys_t, g0, n, s, j, hj, H);
    if constexpr (RG > 1) {
      if (n - g0 > RG / 2)
        fwd_rows<KL, S, RG>(w, bias, h_cur, h_next, x_cur, ys_t, g0, n, s, j, hj, H);
      else if (n > g0)
        fwd_rows<KL, S, RG / 2>(w, bias, h_cur, h_next, x_cur, ys_t, g0, n, s, j, hj, H);
    }
    cp_async_wait<kRing - 2>();  // step t + 1's xp has landed (this thread's copies)
    __syncthreads();             // h' and step t + 1's xp are visible to all
  }
}

__global__ void __launch_bounds__(kMaxThreads)
gru_seq_bwd_kernel(const float* __restrict__ xp,
                   const float* __restrict__ w_hh_t,
                   const float* __restrict__ b_hh,
                   const float* __restrict__ h0,
                   const float* __restrict__ ys,
                   const float* __restrict__ d_ys,
                   float* __restrict__ dxp,
                   float* __restrict__ dhn,
                   float* __restrict__ dh0,
                   int T, int B, int H, int rows) {
  extern __shared__ float smem[];
  const int G = 3 * H;
  const int P = G + 1;  // row pitch of the shared W_hh^T: conflict-free column reads
  const size_t bucket = blockIdx.y;
  xp += bucket * T * B * G;
  dxp += bucket * T * B * G;
  ys += bucket * T * B * H;
  d_ys += bucket * T * B * H;
  dhn += bucket * T * B * H;
  w_hh_t += bucket * H * G;
  b_hh += bucket * G;
  h0 += bucket * B * H;
  dh0 += bucket * B * H;

  float* w_s = smem;              // (H, P)
  float* h_s = w_s + H * P;       // (rows, H): h_prev of the current step
  float* g_s = h_s + rows * H;    // (rows, 3H): dhp of the current step

  for (int i = threadIdx.x; i < H * G; i += blockDim.x) {
    const int k = i / G;
    w_s[k * P + (i - k * G)] = w_hh_t[i];
  }

  const int r = threadIdx.x / H;
  const int j = threadIdx.x - r * H;
  const int b = blockIdx.x * rows + r;
  const bool active = r < rows && b < B;

  // h_prev of step t is ys[t - 1], or h0 at t = 0
  auto h_prev_at = [&](int t) -> float {
    return t > 0 ? ys[((size_t)(t - 1) * B + b) * H + j] : h0[(size_t)b * H + j];
  };

  float bias_r = 0.f, bias_z = 0.f, bias_n = 0.f;
  float hp_j = 0.f, x_r = 0.f, x_z = 0.f, x_n = 0.f, dy = 0.f;
  if (active && T > 0) {
    bias_r = b_hh[j];
    bias_z = b_hh[H + j];
    bias_n = b_hh[2 * H + j];
    const int t = T - 1;
    hp_j = h_prev_at(t);
    const float* x0 = xp + ((size_t)t * B + b) * G;
    x_r = x0[j];
    x_z = x0[H + j];
    x_n = x0[2 * H + j];
    dy = d_ys[((size_t)t * B + b) * H + j];
  }

  float dh = 0.f;
  for (int t = T - 1; t >= 0; --t) {
    if (r < rows) h_s[r * H + j] = hp_j;
    __syncthreads();  // h_prev complete; the last step's dhp reads are done

    float n_hp = 0.f, n_x_r = 0.f, n_x_z = 0.f, n_x_n = 0.f, n_dy = 0.f;
    float zg = 0.f;
    if (active) {
      if (t > 0) {
        n_hp = h_prev_at(t - 1);
        const float* xn = xp + ((size_t)(t - 1) * B + b) * G;
        n_x_r = xn[j];
        n_x_z = xn[H + j];
        n_x_n = xn[2 * H + j];
        n_dy = d_ys[((size_t)(t - 1) * B + b) * H + j];
      }
      const float* h_row = h_s + r * H;
      float a_r = 0.f, a_z = 0.f, a_n = 0.f;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float hk = h_row[k];
        const float* w = w_s + k * P + j;
        a_r = fmaf(hk, w[0], a_r);
        a_z = fmaf(hk, w[H], a_z);
        a_n = fmaf(hk, w[2 * H], a_n);
      }
      const float rg = sigmoid(x_r + (a_r + bias_r));
      zg = sigmoid(x_z + (a_z + bias_z));
      const float hn = a_n + bias_n;
      const float ng = tanhf(x_n + rg * hn);

      dh += dy;
      const float dz = dh * (hp_j - ng);
      const float dn = dh * (1.0f - zg);
      const float dn_pre = dn * (1.0f - ng * ng);
      const float dr = dn_pre * hn;
      const float dhn_j = dn_pre * rg;
      const float dz_pre = dz * zg * (1.0f - zg);
      const float dr_pre = dr * rg * (1.0f - rg);

      float* dx = dxp + ((size_t)t * B + b) * G;
      dx[j] = dr_pre;
      dx[H + j] = dz_pre;
      dx[2 * H + j] = dn_pre;
      dhn[((size_t)t * B + b) * H + j] = dhn_j;
      float* g_row = g_s + r * G;
      g_row[j] = dr_pre;
      g_row[H + j] = dz_pre;
      g_row[2 * H + j] = dhn_j;
    }
    __syncthreads();  // the dhp row is complete

    if (active) {
      // dh_prev[j] = dh z + sum_g dhp[g] W_hh[g, j], W_hh[g, j] = W_hh^T[j, g]
      const float* g_row = g_s + r * G;
      const float* w_row = w_s + j * P;
      float acc = 0.f;
#pragma unroll 4
      for (int g = 0; g < G; ++g) acc = fmaf(g_row[g], w_row[g], acc);
      dh = dh * zg + acc;
    }
    hp_j = n_hp;
    x_r = n_x_r;
    x_z = n_x_z;
    x_n = n_x_n;
    dy = n_dy;
  }
  if (active) dh0[(size_t)b * H + j] = dh;
}

// Tiling shared by both kernels: rows per block so that the nb * ceil(B / rows)
// blocks come close to one per SM, within the thread and shared-memory limits.
cudaError_t plan(int nb, int B, int H, long long fixed_bytes,
                 long long row_bytes, int* rows_out) {
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  const int max_rows_smem = static_cast<int>((max_smem - fixed_bytes) / row_bytes);
  if (max_rows_smem < 1) return cudaErrorInvalidConfiguration;
  const long long total = (long long)nb * B;
  int rows = static_cast<int>((total + sms - 1) / sms);
  rows = std::min(rows, B);
  rows = std::min(rows, kMaxThreads / H);
  rows = std::min(rows, max_rows_smem);
  *rows_out = std::max(rows, 1);
  return cudaSuccess;
}

bool bad_dims(int nb, int T, int B, int H) {
  return nb < 0 || T < 0 || B < 0 || H <= 0 || H > kMaxHidden || nb > 65535;
}

// The forward's tile: the instance (KL, S), threads, rows per block (one
// tile per SM where shared memory allows), tiles per bucket and shared
// bytes.
struct FwdTile {
  int kl, s, threads, rows, blocks;
  size_t smem;
};

cudaError_t fwd_tile(int nb, int B, int H, FwdTile* tile) {
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  const int kl = H <= 64 ? 16 : H <= 96 ? 32 : 64;
  int s = 1;
  while (s * kl < H) s *= 2;
  const long long row_bytes =
      (2LL * s * (kl + 4) + (long long)kRing * 3 * H) * (long long)sizeof(float);
  const long long total = (long long)std::max(nb, 1) * std::max(B, 1);
  long long rows = (total + sms - 1) / sms;
  rows = std::min<long long>(rows, std::max(B, 1));
  rows = std::min<long long>(rows, max_smem / row_bytes);
  tile->kl = kl;
  tile->s = s;
  tile->threads = (H * s + 31) / 32 * 32;
  tile->rows = static_cast<int>(std::max<long long>(rows, 1));
  tile->blocks = (B + tile->rows - 1) / tile->rows;
  tile->smem = static_cast<size_t>(tile->rows * row_bytes);
  return cudaSuccess;
}

template <int KL, int S, int HM>
cudaError_t fwd_launch(const FwdTile& tile, const float* xp, const float* w_hh_t,
                       const float* b_hh, const float* h0, float* ys, int nb,
                       int T, int B, int H, cudaStream_t stream) {
  const auto kernel = gru_seq_fwd_kernel<KL, S, HM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(tile.smem));
  if (err != cudaSuccess) return err;
  const int vec = (3 * H) % 4 == 0 && reinterpret_cast<uintptr_t>(xp) % 16 == 0;
  kernel<<<dim3(tile.blocks, nb), tile.threads, tile.smem, stream>>>(
      xp, w_hh_t, b_hh, h0, ys, T, B, H, tile.rows, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gru_seq_fwd(const float* xp, const float* w_hh_t,
                           const float* b_hh, const float* h0, float* ys,
                           int nb, int T, int B, int H, cudaStream_t stream) {
  if (bad_dims(nb, T, B, H)) return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0 || T == 0 || B == 0) return 0;
  FwdTile tile;
  cudaError_t err = fwd_tile(nb, B, H, &tile);
  if (err != cudaSuccess) return static_cast<int>(err);
#define GRU_FWD_LAUNCH(KL, S, HM) \
  fwd_launch<KL, S, HM>(tile, xp, w_hh_t, b_hh, h0, ys, nb, T, B, H, stream)
  if (H <= 16) err = GRU_FWD_LAUNCH(16, 1, 16);
  else if (H <= 32) err = GRU_FWD_LAUNCH(16, 2, 32);
  else if (H <= 64) err = GRU_FWD_LAUNCH(16, 4, 64);
  else if (H <= 96) err = GRU_FWD_LAUNCH(32, 4, 96);
  else err = GRU_FWD_LAUNCH(64, 2, 128);
#undef GRU_FWD_LAUNCH
  return static_cast<int>(err);
}

// The forward's tile for (nb, B, H) on the current card, for reports:
// out = {rows, tiles per bucket, threads, KL, S, shared bytes}.
extern "C" int gru_seq_fwd_tile(int nb, int B, int H, int* out) {
  if (bad_dims(nb, 1, B, H)) return static_cast<int>(cudaErrorInvalidValue);
  FwdTile tile;
  const cudaError_t err = fwd_tile(nb, B, H, &tile);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[6] = {tile.rows, tile.blocks, tile.threads, tile.kl, tile.s,
                       static_cast<int>(tile.smem)};
  std::copy(vals, vals + 6, out);
  return 0;
}

extern "C" int gru_seq_bwd(const float* xp, const float* w_hh_t,
                           const float* b_hh, const float* h0, const float* ys,
                           const float* d_ys, float* dxp, float* dhn, float* dh0,
                           int nb, int T, int B, int H, cudaStream_t stream) {
  if (bad_dims(nb, T, B, H)) return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0 || B == 0) return 0;
  const long long w_bytes = (long long)H * (3 * H + 1) * (long long)sizeof(float);
  const long long row_bytes = 4LL * H * (long long)sizeof(float);
  int rows = 1;
  cudaError_t err = plan(nb, B, H, w_bytes, row_bytes, &rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(w_bytes + rows * row_bytes);
  const int threads = (rows * H + 31) / 32 * 32;
  const dim3 grid((B + rows - 1) / rows, nb);
  err = cudaFuncSetAttribute(gru_seq_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gru_seq_bwd_kernel<<<grid, threads, smem, stream>>>(
      xp, w_hh_t, b_hh, h0, ys, d_ys, dxp, dhn, dh0, T, B, H, rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* eegsynth_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

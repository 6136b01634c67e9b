// GRU sequence kernel K1, wide route, for Hopper, sm_90a: forward and
// backward for hidden widths past 128, with a leading bucket axis.
//
// Replaces the TPU kernel eegsynth/nn/pallas_gru.py:_gru_seq_pallas and its
// custom VJP _gru_seq_bwd at the widths neither gru_seq.cu nor the cluster
// kernels take: the JAX GRU runs at any H (bench_kernels' default sweep is
// H 56, 128, 256, 512), and a TimeGANConfig may set any h_dim. Same layouts
// and the same function as gru_seq.cu:
//
//   xp (nb, T, B, 3H), w_hh_t (nb, H, 3H) = W_hh^T, b_hh (nb, 3H),
//   h0 (nb, B, H) -> ys (nb, T, B, H), f32, gates [r, z, n].
//
// Why a second route: gru_seq.cu holds W_hh^T in registers (3 KL weights a
// thread), which stops at H 128. At H 256, W_hh^T in float32 is 768 KB and
// at H 512 3 MB: neither fits one SM's 227 KB of shared memory, let alone
// its registers. Batch rows are independent, so a block still owns a tile
// of R rows for all T steps and no block waits on another; W_hh^T is
// streamed from L2 (50 MB) every step instead of held.
//
// What bounds it: each step every block reads all of W_hh^T (3 H^2 floats)
// from L2 and does R 3 H^2 multiply-adds on it, after the step before has
// finished; T steps in a chain. At H 512 that is 3 MB of L2 traffic a block
// a step, so the per-SM L2 bandwidth, times T, bounds it, far above the HBM
// bytes of xp and ys. Up to the H a cluster's shared memory holds, both
// halves run on a cluster of blocks that splits W_hh^T's units between
// their shared memory instead: the forward in gru_seq_cluster.cu (h
// all-gathered through distributed shared memory every step), the backward
// in gru_seq_cluster_bwd.cu (dh reduce-scattered every step). Above the
// clusters' cap (H 545 to 1024 on the H100) each half runs on one
// cooperative grid whose blocks split W_hh's units between their shared
// memory and exchange one operand through L2 every step: the forward in
// gru_seq_grid.cu (h), the backward in gru_seq_grid_bwd.cu (dhp). Both
// kernels here run only where a plan asks for them (plan={"route":
// "stream"} to gru_sequence_wide or gru_sequence_bwd_wide: timing in turns,
// their card tests).
//
// Forward: thread j (one per column, the block H threads rounded up to a
// warp, so H <= 1024) computes hp[r, g H + j] for the three gates g and the
// R rows r of its tile: the k loop reads W_hh^T[k, g H + j] (a warp reads
// 32 neighbouring floats of one row: one 128-byte line) and h[r, k] from
// shared memory (one address for the whole warp: a broadcast), four k at a
// time as a float4 of h. The sums run over k in order, one fmaf each. The
// step's xp is loaded before the sums so that its latency hides behind
// them. Thread j then forms the gates of column j and writes h' to the
// other h buffer and to ys: one barrier a step.
//
// Backward (exact reverse-time BPTT of _gru_seq_bwd), as gru_seq.cu's: the
// wrapper computes hp = h_prev W_hh^T for all T B rows as one batched
// product before the kernel (the kernel adds b_hh), and dW_hh^T = h_prev^T
// dhp and db_hh = sum dhp after it (gru_sequence.py weight_grads). Only
// dh_{t-1} = dh_t z + dhp_t W_hh stays on the chain. Thread i owns column i
// of dh for the tile's rows, in registers for all T steps. The coefficients
// of a step (c_r, c_z, c_n, (1-z)(1-n^2), z) depend on xp, hp and h_prev
// alone, so step t - 1's are computed in step t, before the barrier, off
// the chain. In step t the owner forms dhp_t = dh_t (c_r, c_z, c_n), writes
// it to shared memory and over hp in HBM, and dxp_t; after the barrier
// every thread sums dhp_t[r, m] W_hh[m, i] over m < 3H, W_hh (nb, 3H, H)
// streamed from L2 the same way (the wrapper passes it contiguous), dhp_t
// broadcast from shared memory. dhp lies in two buffers: one barrier a
// step.
//
// Both kernels use gru_cell.cuh's sigmoid (1/2 + tanh(x/2)/2) and the
// accurate expf and tanhf, as gru_seq.cu does. They allocate nothing and do
// not synchronise.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

#include "gru_cell.cuh"  // sigmoid_fwd

namespace {

constexpr int kMinWideHidden = 1;
constexpr int kMaxWideHidden = 1024;  // one thread a column, 1024 threads a block
constexpr int kMaxRows = 4;           // a tile's rows: 3 R sums a thread in registers

template <int R>
__global__ void __launch_bounds__(kMaxWideHidden)
gru_wide_fwd_kernel(const float* __restrict__ xp, const float* __restrict__ w_hh_t,
                    const float* __restrict__ b_hh, const float* __restrict__ h0,
                    float* __restrict__ ys, int T, int B, int H) {
  extern __shared__ __align__(16) float wide_fwd_smem[];
  const int HP = (H + 3) & ~3;  // pitch of a row of h, zeros past H
  const int G = 3 * H;
  const size_t bucket = blockIdx.y;
  xp += bucket * T * B * G;
  ys += bucket * T * B * H;
  w_hh_t += bucket * H * G;
  b_hh += bucket * G;
  h0 += bucket * B * H;

  const int b0 = blockIdx.x * R;
  const int n = min(R, B - b0);  // rows of this tile
  float* h_s = wide_fwd_smem;    // two buffers of (R, HP)
  for (int i = threadIdx.x; i < 2 * R * HP; i += blockDim.x) h_s[i] = 0.f;
  __syncthreads();
  for (int i = threadIdx.x; i < n * H; i += blockDim.x) {
    const int r = i / H, c = i - r * H;
    h_s[r * HP + c] = h0[(size_t)(b0 + r) * H + c];
  }
  __syncthreads();

  const int j = threadIdx.x;
  const bool live = j < H;
  const int jc = live ? j : H - 1;  // lanes past H read column H - 1, store nothing
  const float br = b_hh[jc], bz = b_hh[H + jc], bn = b_hh[2 * H + jc];
  const float* wc = w_hh_t + jc;
  const int H4 = H & ~3;

  for (int t = 0; t < T; ++t) {
    const float* hc = h_s + (t & 1) * R * HP;
    float* hn = h_s + ((t + 1) & 1) * R * HP;
    float x[R][3];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float* xr = xp + ((size_t)t * B + b0 + min(r, n - 1)) * G + jc;
      x[r][0] = xr[0];
      x[r][1] = xr[H];
      x[r][2] = xr[2 * H];
    }
    float acc[R][3];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = acc[r][2] = 0.f;
    for (int k = 0; k < H4; k += 4) {
      float w[4][3];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* wk = wc + (size_t)(k + q) * G;
        w[q][0] = __ldg(wk);
        w[q][1] = __ldg(wk + H);
        w[q][2] = __ldg(wk + 2 * H);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 h4 = *reinterpret_cast<const float4*>(hc + r * HP + k);
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          acc[r][g] = fmaf(h4.x, w[0][g], acc[r][g]);
          acc[r][g] = fmaf(h4.y, w[1][g], acc[r][g]);
          acc[r][g] = fmaf(h4.z, w[2][g], acc[r][g]);
          acc[r][g] = fmaf(h4.w, w[3][g], acc[r][g]);
        }
      }
    }
    for (int k = H4; k < H; ++k) {
      const float* wk = wc + (size_t)k * G;
      const float w0 = __ldg(wk), w1 = __ldg(wk + H), w2 = __ldg(wk + 2 * H);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float h = hc[r * HP + k];
        acc[r][0] = fmaf(h, w0, acc[r][0]);
        acc[r][1] = fmaf(h, w1, acc[r][1]);
        acc[r][2] = fmaf(h, w2, acc[r][2]);
      }
    }
    if (live) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < n) {
          const float h = hc[r * HP + j];
          const float rg = sigmoid_fwd(x[r][0] + (acc[r][0] + br));
          const float zg = sigmoid_fwd(x[r][1] + (acc[r][1] + bz));
          const float ng = tanhf(x[r][2] + rg * (acc[r][2] + bn));
          const float hv = (1.0f - zg) * ng + zg * h;
          hn[r * HP + j] = hv;
          ys[((size_t)t * B + b0 + r) * H + j] = hv;
        }
      }
    }
    __syncthreads();  // h' is visible to all before step t + 1's sums
  }
}

// hp and dhp may be one buffer (written over in place), so neither is
// __restrict__. Each (t, row, column) of hp is read and then written by the
// same thread, and read by no other.
template <int R>
__global__ void __launch_bounds__(kMaxWideHidden)
gru_wide_bwd_kernel(const float* __restrict__ xp, const float* hp,
                    const float* __restrict__ h_prev, const float* __restrict__ d_ys,
                    const float* __restrict__ w_hh, const float* __restrict__ b_hh,
                    float* __restrict__ dxp, float* dhp, float* __restrict__ dh0,
                    int T, int B, int H) {
  extern __shared__ __align__(16) float wide_bwd_smem[];
  const int G = 3 * H;
  const int GP = (G + 3) & ~3;  // pitch of a row of dhp, zeros past 3H
  const size_t bucket = blockIdx.y;
  xp += bucket * T * B * G;
  hp += bucket * T * B * G;
  dxp += bucket * T * B * G;
  dhp += bucket * T * B * G;
  h_prev += bucket * T * B * H;
  d_ys += bucket * T * B * H;
  w_hh += bucket * G * H;
  b_hh += bucket * G;
  dh0 += bucket * B * H;

  const int b0 = blockIdx.x * R;
  const int n = min(R, B - b0);
  float* g_s = wide_bwd_smem;  // two buffers of (R, GP)
  for (int i = threadIdx.x; i < 2 * R * GP; i += blockDim.x) g_s[i] = 0.f;

  const int i = threadIdx.x;
  const bool live = i < H;
  const int ic = live ? i : H - 1;
  const float bias[3] = {b_hh[ic], b_hh[H + ic], b_hh[2 * H + ic]};
  const float* wc = w_hh + ic;
  const int G4 = G & ~3;

  // step u's coefficients of column ic for the tile's rows (rows past n
  // repeat row n - 1) and its d_ys
  float c[R][5], dy[R];
  auto coefficients = [&](int u) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const size_t row = (size_t)u * B + b0 + min(r, n - 1);
      const float* x = xp + row * G + ic;
      const float* p = hp + row * G + ic;
      const float hp_r = p[0] + bias[0], hp_z = p[H] + bias[1], hp_n = p[2 * H] + bias[2];
      const float rg = sigmoid_fwd(x[0] + hp_r);
      const float zg = sigmoid_fwd(x[H] + hp_z);
      const float ng = tanhf(x[2 * H] + rg * hp_n);
      const float omz = 1.0f - zg;
      const float e = omz * (1.0f - ng * ng);
      c[r][0] = (e * hp_n) * (rg * (1.0f - rg));
      c[r][1] = (h_prev[row * H + ic] - ng) * (zg * omz);
      c[r][2] = e * rg;
      c[r][3] = e;
      c[r][4] = zg;
      dy[r] = d_ys[row * H + ic];
    }
  };

  float dh[R];
#pragma unroll
  for (int r = 0; r < R; ++r) dh[r] = 0.f;
  if (T > 0) coefficients(T - 1);
  __syncthreads();  // both dhp buffers are zero

  for (int t = T - 1; t >= 0; --t) {
    float* gs = g_s + (t & 1) * R * GP;
    float st[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float d = dh[r] + dy[r];
      const float d_r = d * c[r][0], d_z = d * c[r][1], d_n = d * c[r][2];
      st[r] = d * c[r][4];
      if (live && r < n) {
        const size_t row = (size_t)t * B + b0 + r;
        float* g = gs + r * GP + i;
        g[0] = d_r;
        g[H] = d_z;
        g[2 * H] = d_n;
        float* dp = dhp + row * G + i;
        dp[0] = d_r;
        dp[H] = d_z;
        dp[2 * H] = d_n;
        float* dx = dxp + row * G + i;
        dx[0] = d_r;
        dx[H] = d_z;
        dx[2 * H] = d * c[r][3];
      }
    }
    if (t > 0) coefficients(t - 1);  // off the chain: no dependence on dh
    __syncthreads();                 // dhp_t of every column is in place
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int m = 0; m < G4; m += 4) {
      const float w0 = __ldg(wc + (size_t)m * H), w1 = __ldg(wc + (size_t)(m + 1) * H);
      const float w2 = __ldg(wc + (size_t)(m + 2) * H), w3 = __ldg(wc + (size_t)(m + 3) * H);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 g4 = *reinterpret_cast<const float4*>(gs + r * GP + m);
        acc[r] = fmaf(g4.x, w0, acc[r]);
        acc[r] = fmaf(g4.y, w1, acc[r]);
        acc[r] = fmaf(g4.z, w2, acc[r]);
        acc[r] = fmaf(g4.w, w3, acc[r]);
      }
    }
    for (int m = G4; m < G; ++m) {
      const float w = __ldg(wc + (size_t)m * H);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(gs[r * GP + m], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) dh[r] = st[r] + acc[r];
  }
  if (live) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < n) dh0[(size_t)(b0 + r) * H + i] = dh[r];
    }
  }
}

bool bad_wide_dims(int nb, int T, int B, int H) {
  return nb < 0 || T < 0 || B < 0 || H < kMinWideHidden || H > kMaxWideHidden ||
         nb > 65535;
}

// The tile: rows a block (1, 2 or 4: one tile per SM where the batch
// allows), tiles a bucket, threads, and the shared bytes of the forward and
// of the backward.
struct WideTile {
  int rows, blocks, threads;
  size_t fwd_smem, bwd_smem;
};

cudaError_t make_wide_tile(int nb, int B, int H, WideTile* tile) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long total = (long long)std::max(nb, 1) * std::max(B, 1);
  const long long want = (total + sms - 1) / sms;
  tile->rows = want <= 1 ? 1 : want <= 2 ? 2 : kMaxRows;
  tile->blocks = (B + tile->rows - 1) / tile->rows;
  tile->threads = (H + 31) / 32 * 32;
  tile->fwd_smem = sizeof(float) * 2 * tile->rows * ((H + 3) & ~3);
  tile->bwd_smem = sizeof(float) * 2 * tile->rows * ((3 * H + 3) & ~3);
  return cudaSuccess;
}

template <int R>
cudaError_t wide_fwd_launch(const WideTile& tile, const float* xp, const float* w_hh_t,
                            const float* b_hh, const float* h0, float* ys, int nb, int T,
                            int B, int H, cudaStream_t stream) {
  const auto kernel = gru_wide_fwd_kernel<R>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(tile.fwd_smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tile.blocks, nb), tile.threads, tile.fwd_smem, stream>>>(xp, w_hh_t, b_hh,
                                                                          h0, ys, T, B, H);
  return cudaGetLastError();
}

template <int R>
cudaError_t wide_bwd_launch(const WideTile& tile, const float* xp, const float* hp,
                            const float* h_prev, const float* d_ys, const float* w_hh,
                            const float* b_hh, float* dxp, float* dhp, float* dh0, int nb,
                            int T, int B, int H, cudaStream_t stream) {
  const auto kernel = gru_wide_bwd_kernel<R>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(tile.bwd_smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tile.blocks, nb), tile.threads, tile.bwd_smem, stream>>>(
      xp, hp, h_prev, d_ys, w_hh, b_hh, dxp, dhp, dh0, T, B, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gru_seq_wide_fwd(const float* xp, const float* w_hh_t, const float* b_hh,
                                const float* h0, float* ys, int nb, int T, int B, int H,
                                cudaStream_t stream) {
  if (bad_wide_dims(nb, T, B, H)) return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0 || T == 0 || B == 0) return 0;
  WideTile tile;
  cudaError_t err = make_wide_tile(nb, B, H, &tile);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tile.rows == 1) err = wide_fwd_launch<1>(tile, xp, w_hh_t, b_hh, h0, ys, nb, T, B, H, stream);
  else if (tile.rows == 2) err = wide_fwd_launch<2>(tile, xp, w_hh_t, b_hh, h0, ys, nb, T, B, H, stream);
  else err = wide_fwd_launch<kMaxRows>(tile, xp, w_hh_t, b_hh, h0, ys, nb, T, B, H, stream);
  return static_cast<int>(err);
}

// hp (nb, T, B, 3H) = h_prev W_hh^T without b_hh; h_prev (nb, T, B, H) =
// [h0, ys[:-1]]; w_hh (nb, 3H, H) = W_hh, contiguous; dhp may be hp itself.
extern "C" int gru_seq_wide_bwd(const float* xp, const float* hp, const float* h_prev,
                                const float* d_ys, const float* w_hh, const float* b_hh,
                                float* dxp, float* dhp, float* dh0, int nb, int T, int B,
                                int H, cudaStream_t stream) {
  if (bad_wide_dims(nb, T, B, H)) return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0 || B == 0) return 0;
  WideTile tile;
  cudaError_t err = make_wide_tile(nb, B, H, &tile);
  if (err != cudaSuccess) return static_cast<int>(err);
#define GRU_WIDE_BWD(R) \
  wide_bwd_launch<R>(tile, xp, hp, h_prev, d_ys, w_hh, b_hh, dxp, dhp, dh0, nb, T, B, H, stream)
  if (tile.rows == 1) err = GRU_WIDE_BWD(1);
  else if (tile.rows == 2) err = GRU_WIDE_BWD(2);
  else err = GRU_WIDE_BWD(kMaxRows);
#undef GRU_WIDE_BWD
  return static_cast<int>(err);
}

// The wide route's tile for (nb, B, H) on the current card, for reports:
// out = {rows, tiles per bucket, threads, forward shared bytes, backward
// shared bytes}.
extern "C" int gru_seq_wide_tile(int nb, int B, int H, int* out) {
  if (bad_wide_dims(nb, 1, B, H)) return static_cast<int>(cudaErrorInvalidValue);
  WideTile tile;
  const cudaError_t err = make_wide_tile(nb, B, H, &tile);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[5] = {tile.rows, tile.blocks, tile.threads, static_cast<int>(tile.fwd_smem),
                       static_cast<int>(tile.bwd_smem)};
  std::copy(vals, vals + 5, out);
  return 0;
}

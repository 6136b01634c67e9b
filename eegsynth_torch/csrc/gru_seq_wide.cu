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
// a step, at H 2048 50 MB (the whole L2, so HBM in practice), so the per-SM
// L2 bandwidth, times T, bounds it, far above the HBM bytes of xp and ys.
// Up to the H a cluster's shared memory holds, both halves run on a
// cluster of blocks that splits W_hh^T's units between their shared memory
// instead: the forward in gru_seq_cluster.cu (h all-gathered through
// distributed shared memory every step), the backward in
// gru_seq_cluster_bwd.cu (dh reduce-scattered every step). Above the
// clusters' cap (H 545 to 1024 on the H100) each half runs on one
// cooperative grid whose blocks split W_hh's units between their shared
// memory and exchange one operand through L2 every step: the forward in
// gru_seq_grid.cu (h), the backward in gru_seq_grid_bwd.cu (dhp). Past the
// H where a grid's blocks are resident at once (1024 on the H100: W_hh in
// split TF32 outgrows the card's shared memory near H 1100), both halves
// run here: nn/gru_sequence.py's wide_plan and wide_bwd_plan plan this
// route from the card's numbers.
//
// The tile (make_wide_tile, mirrored by gru_sequence.py stream_plan): R
// rows a block (1, 2 or 4: one tile per SM where the batch allows, and no
// more than the backward's two (R, 3H) buffers of dhp hold in one block's
// shared memory), min(1024, H rounded up to a warp) threads a block. Thread
// j owns the columns j, j + threads, j + 2 threads, ... below H. The cap is
// the H whose one-row backward tile, 2 x 3H floats, still fits the card's
// opt-in shared memory a block: H 9685 on the H100 (232,448 bytes).
//
// Forward: for each column c it owns, thread j computes hp[r, g H + c] for
// the three gates g and the R rows r of its tile: the k loop reads
// W_hh^T[k, g H + c] (a warp reads 32 neighbouring floats of one row: one
// 128-byte line) and h[r, k] from shared memory (one address for the whole
// warp: a broadcast), four k at a time as a float4 of h. The sums run over
// k in order, one fmaf each. The column's xp is loaded before its sums so
// that its latency hides behind them. Thread j then forms the gates of
// column c and writes h' to the other h buffer and to ys; after its last
// column, one barrier a step.
//
// Backward (exact reverse-time BPTT of _gru_seq_bwd), as gru_seq.cu's: the
// wrapper computes hp = h_prev W_hh^T for all T B rows as one batched
// product before the kernel (the kernel adds b_hh), and dW_hh^T = h_prev^T
// dhp and db_hh = sum dhp after it (gru_sequence.py weight_grads). Only
// dh_{t-1} = dh_t z + dhp_t W_hh stays on the chain. The thread owning
// column c keeps dh[r, c] for all T steps in dh0's entry, which it alone
// reads and writes (any number of columns a thread, in no register
// array). The coefficients of a step (c_r, c_z, c_n, (1-z)(1-n^2), z) and
// its d_ys depend on xp, hp and h_prev alone, so step t - 1's are formed in
// step t, before the barrier, off the chain, and staged in step t - 1's
// own dxp and dhp entries of the column (the same thread overwrites them
// with their values in step t - 1). In step t the owner forms dhp_t = d
// (c_r, c_z, c_n) with d = dh_t + d_ys_t, writes it to shared memory and
// over hp in HBM, and dxp_t, and parks d z in dh0; after the barrier it
// sums dhp_t[r, m] W_hh[m, c] over m < 3H for each of its columns, W_hh
// (nb, 3H, H) streamed from L2 the same way (the wrapper passes it
// contiguous), dhp_t broadcast from shared memory, and adds d z. dhp lies
// in two buffers: one barrier a step.
//
// Both kernels use gru_cell.cuh's sigmoid (1/2 + tanh(x/2)/2) and the
// accurate expf and tanhf, as gru_seq.cu does. They allocate nothing and do
// not synchronise.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

#include "gru_cell.cuh"  // sigmoid_fwd

namespace {

constexpr int kMaxThreads = 1024;  // threads a block; a thread owns ceil(H / threads) columns
constexpr int kMaxRows = 4;        // a tile's rows: 3 R sums a thread in registers

template <int R>
__global__ void __launch_bounds__(kMaxThreads)
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

  const int H4 = H & ~3;
  for (int t = 0; t < T; ++t) {
    const float* hc = h_s + (t & 1) * R * HP;
    float* hn = h_s + ((t + 1) & 1) * R * HP;
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float x[R][3];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float* xr = xp + ((size_t)t * B + b0 + min(r, n - 1)) * G + j;
        x[r][0] = xr[0];
        x[r][1] = xr[H];
        x[r][2] = xr[2 * H];
      }
      const float* wc = w_hh_t + j;
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
      const float br = b_hh[j], bz = b_hh[H + j], bn = b_hh[2 * H + j];
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
// __restrict__. Each (t, row, column) of hp, dhp, dxp and dh0 is read and
// written by the thread owning the column alone.
template <int R>
__global__ void __launch_bounds__(kMaxThreads)
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
  const int G4 = G & ~3;

  // step u's coefficients and d_ys of each of this thread's columns, rows
  // below n, staged in step u's dxp entries (c_r, c_z, c_n) and dhp entries
  // ((1-z)(1-n^2), z, d_ys); hp is read before dhp (maybe hp itself) is
  // written
  auto stage = [&](int u) {
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const float br = b_hh[j], bz = b_hh[H + j], bn = b_hh[2 * H + j];
      for (int r = 0; r < n; ++r) {
        const size_t row = (size_t)u * B + b0 + r;
        const float* x = xp + row * G + j;
        const float* p = hp + row * G + j;
        const float hp_r = p[0] + br, hp_z = p[H] + bz, hp_n = p[2 * H] + bn;
        const float rg = sigmoid_fwd(x[0] + hp_r);
        const float zg = sigmoid_fwd(x[H] + hp_z);
        const float ng = tanhf(x[2 * H] + rg * hp_n);
        const float omz = 1.0f - zg;
        const float e = omz * (1.0f - ng * ng);
        const float dy = d_ys[row * H + j];
        const float hv = h_prev[row * H + j];
        float* sx = dxp + row * G + j;
        float* sp = dhp + row * G + j;
        sx[0] = (e * hp_n) * (rg * (1.0f - rg));
        sx[H] = (hv - ng) * (zg * omz);
        sx[2 * H] = e * rg;
        sp[0] = e;
        sp[H] = zg;
        sp[2 * H] = dy;
      }
    }
  };

  for (int j = threadIdx.x; j < H; j += blockDim.x)
    for (int r = 0; r < n; ++r) dh0[(size_t)(b0 + r) * H + j] = 0.f;
  if (T > 0) stage(T - 1);
  __syncthreads();  // both dhp buffers are zero

  for (int t = T - 1; t >= 0; --t) {
    float* gs = g_s + (t & 1) * R * GP;
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      for (int r = 0; r < n; ++r) {
        const size_t row = (size_t)t * B + b0 + r;
        float* sx = dxp + row * G + j;
        float* sp = dhp + row * G + j;
        float* dh = dh0 + (size_t)(b0 + r) * H + j;
        const float c_r = sx[0], c_z = sx[H], c_n = sx[2 * H];
        const float e = sp[0], zg = sp[H], dy = sp[2 * H];
        const float d = *dh + dy;
        const float d_r = d * c_r, d_z = d * c_z, d_n = d * c_n;
        float* g = gs + r * GP + j;
        g[0] = d_r;
        g[H] = d_z;
        g[2 * H] = d_n;
        sp[0] = d_r;
        sp[H] = d_z;
        sp[2 * H] = d_n;
        sx[0] = d_r;
        sx[H] = d_z;
        sx[2 * H] = d * e;
        *dh = d * zg;  // d z; the sum over m is added after the barrier
      }
    }
    if (t > 0) stage(t - 1);  // off the chain: no dependence on dh
    __syncthreads();          // dhp_t of every column is in place
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const float* wc = w_hh + j;
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
      for (int r = 0; r < R; ++r) {
        if (r < n) {
          float* dh = dh0 + (size_t)(b0 + r) * H + j;
          *dh = *dh + acc[r];
        }
      }
    }
  }
}

bool bad_wide_dims(int nb, int T, int B, int H) {
  return nb < 0 || T < 0 || B < 0 || H < 1 || nb > 65535;
}

// The tile: rows a block (1, 2 or 4: one tile per SM where the batch
// allows, halved until the backward's shared bytes fit a block), tiles a
// bucket, threads, and the shared bytes of the forward and of the
// backward. Past the cap (the one-row backward tile does not fit)
// cudaErrorInvalidValue.
struct WideTile {
  int rows, blocks, threads;
  size_t fwd_smem, bwd_smem;
};

size_t fwd_smem_bytes(int rows, int H) { return sizeof(float) * 2 * rows * ((H + 3) & ~3); }
size_t bwd_smem_bytes(int rows, int H) { return sizeof(float) * 2 * rows * ((3 * H + 3) & ~3); }

cudaError_t make_wide_tile(int nb, int B, int H, WideTile* tile) {
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const long long total = (long long)std::max(nb, 1) * std::max(B, 1);
  const long long want = (total + sms - 1) / sms;
  int rows = want <= 1 ? 1 : want <= 2 ? 2 : kMaxRows;
  while (rows > 1 && bwd_smem_bytes(rows, H) > (size_t)max_smem) rows /= 2;
  if (bwd_smem_bytes(rows, H) > (size_t)max_smem) return cudaErrorInvalidValue;
  tile->rows = rows;
  tile->blocks = (B + rows - 1) / rows;
  tile->threads = std::min(kMaxThreads, (H + 31) / 32 * 32);
  tile->fwd_smem = fwd_smem_bytes(rows, H);
  tile->bwd_smem = bwd_smem_bytes(rows, H);
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

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
// serving width). Reading xp and writing ys is the only HBM traffic, spread
// evenly over the run, and the arithmetic is a few MFLOP per step, so neither
// bandwidth nor FLOP/s bound it: the latency of one step, times T, does.
//
// What the design does about that:
//  - Batch rows and buckets are independent, so the grid runs over (tile of
//    `rows` batch rows, bucket) and each block walks all T steps in a loop; no
//    block ever waits on another. rows = ceil(nb B / #SMs) gives one tile per
//    SM: B = 256, nb = 1 (serving) is 2 rows x 128 blocks; B = 63, nb = 18
//    (training) is 9 rows x 7 tiles x 18 buckets = 126 blocks.
//  - Each block keeps its own bucket's W_hh^T in shared memory for all T.
//  - Forward: one thread owns one (row, hidden unit j). It keeps its own h
//    and its three gate accumulators in registers and produces h'[row, j]
//    alone, so a step needs one barrier; h is double-buffered in shared memory
//    for the others to read. The next step's xp is loaded before this step's
//    product, so its HBM latency is off the chain.
//  - Backward (exact reverse-time BPTT of _gru_seq_bwd): the same thread owns
//    the same (row, j) and carries dh[row, j] in a register from t = T-1 down
//    to 0. Each step recomputes r, z, n from h_prev (ys[t-1] or h0) with the
//    forward's own product, writes dxp[t] and the n-gate part of dhp
//    (dn_pre * r; the r and z parts equal dxp's), then takes the second
//    product dh_prev = dh z + dhp W_hh. That product reads W_hh^T by row
//    (stride 3H): the shared copy is stored with a pitch of 3H + 1 floats, so
//    32 neighbouring threads hit 32 different banks. Two barriers per step:
//    after h_prev is in shared memory, and after the dhp row is.
//    dW_hh^T = h_prev^T dhp and db_hh = sum dhp are left to one batched
//    matrix product after the kernel (no atomics across blocks, deterministic).
//  - expf / tanhf (not the fast-math intrinsics) keep the kernels within 1e-4
//    of the plain PyTorch versions over 1024 dependent steps.
// The kernels allocate nothing and do not synchronise: the caller owns the
// outputs and the stream.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

namespace {

constexpr int kMaxHidden = 128;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// No __launch_bounds__ here: with __launch_bounds__(1024) this kernel ran
// 1.5x slower at every shape measured (2.29 vs 1.47 ms at T 768, B 256,
// H 56), at the same 32 registers. Without it ptxas still stays at 32, so
// 1024-thread blocks launch. The backward kernel keeps its bound: it needs
// 49 registers, and more than 64 would refuse a 1024-thread launch.
__global__ void gru_seq_fwd_kernel(const float* __restrict__ xp,
                                   const float* __restrict__ w_hh_t,
                                   const float* __restrict__ b_hh,
                                   const float* __restrict__ h0,
                                   float* __restrict__ ys,
                                   int T, int B, int H, int rows) {
  extern __shared__ float smem[];
  const int G = 3 * H;
  const size_t bucket = blockIdx.y;
  xp += bucket * T * B * G;
  ys += bucket * T * B * H;
  w_hh_t += bucket * H * G;
  b_hh += bucket * G;
  h0 += bucket * B * H;

  float* w_s = smem;            // (H, 3H)
  float* h_s = smem + H * G;    // two buffers of (rows, H)

  for (int i = threadIdx.x; i < H * G; i += blockDim.x) w_s[i] = w_hh_t[i];

  const int r = threadIdx.x / H;        // row within the tile
  const int j = threadIdx.x - r * H;    // hidden unit
  const int b = blockIdx.x * rows + r;  // batch row
  const bool active = r < rows && b < B;

  float h = 0.f, bias_r = 0.f, bias_z = 0.f, bias_n = 0.f;
  float x_r = 0.f, x_z = 0.f, x_n = 0.f;
  if (active) {
    h = h0[(size_t)b * H + j];
    bias_r = b_hh[j];
    bias_z = b_hh[H + j];
    bias_n = b_hh[2 * H + j];
    const float* x0 = xp + (size_t)b * G;
    x_r = x0[j];
    x_z = x0[H + j];
    x_n = x0[2 * H + j];
  }
  if (r < rows) h_s[r * H + j] = h;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* h_cur = h_s + (t & 1) * rows * H + r * H;
    float* h_next = h_s + ((t + 1) & 1) * rows * H;
    float nx_r = 0.f, nx_z = 0.f, nx_n = 0.f;
    if (active) {
      if (t + 1 < T) {
        const float* xn = xp + ((size_t)(t + 1) * B + b) * G;
        nx_r = xn[j];
        nx_z = xn[H + j];
        nx_n = xn[2 * H + j];
      }
      float a_r = 0.f, a_z = 0.f, a_n = 0.f;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float hk = h_cur[k];
        const float* w = w_s + k * G + j;
        a_r = fmaf(hk, w[0], a_r);
        a_z = fmaf(hk, w[H], a_z);
        a_n = fmaf(hk, w[2 * H], a_n);
      }
      const float rg = sigmoid(x_r + (a_r + bias_r));
      const float zg = sigmoid(x_z + (a_z + bias_z));
      const float ng = tanhf(x_n + rg * (a_n + bias_n));
      h = (1.0f - zg) * ng + zg * h;
      h_next[r * H + j] = h;
      ys[((size_t)t * B + b) * H + j] = h;
    }
    x_r = nx_r;
    x_z = nx_z;
    x_n = nx_n;
    __syncthreads();
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

}  // namespace

extern "C" int gru_seq_fwd(const float* xp, const float* w_hh_t,
                           const float* b_hh, const float* h0, float* ys,
                           int nb, int T, int B, int H, cudaStream_t stream) {
  if (bad_dims(nb, T, B, H)) return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0 || T == 0 || B == 0) return 0;
  const long long w_bytes = 3LL * H * H * (long long)sizeof(float);
  const long long row_bytes = 2LL * H * (long long)sizeof(float);
  int rows = 1;
  cudaError_t err = plan(nb, B, H, w_bytes, row_bytes, &rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(w_bytes + rows * row_bytes);
  const int threads = (rows * H + 31) / 32 * 32;
  const dim3 grid((B + rows - 1) / rows, nb);
  err = cudaFuncSetAttribute(gru_seq_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gru_seq_fwd_kernel<<<grid, threads, smem, stream>>>(xp, w_hh_t, b_hh, h0, ys,
                                                      T, B, H, rows);
  return static_cast<int>(cudaGetLastError());
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

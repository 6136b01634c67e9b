// GRU sequence kernel (K1) for Hopper, sm_90a. Forward only.
//
// Replaces the TPU kernel eegsynth/nn/pallas_gru.py:_gru_seq_pallas (Pallas
// body _gru_seq_kernel): the whole recurrence of one GRU layer in one launch.
//
//   xp (T, B, 3H)  hoisted input projection x W_ih^T + b_ih, gates [r, z, n]
//   w_hh_t (H, 3H) = W_hh^T,  b_hh (3H),  h0 (B, H)   ->   ys (T, B, H), f32
//
//   hp = h W_hh^T + b_hh
//   r  = sigmoid(xp_r + hp_r)      z = sigmoid(xp_z + hp_z)
//   n  = tanh(xp_n + r * hp_n)     h' = (1 - z) n + z h
//
// What bounds it on this card: a chain of T dependent small products, each a
// (rows x H) @ (H x 3H) with a 56-deep dot product per output at the serving
// width. Reading xp and writing ys is the only HBM traffic (4 T B H floats,
// spread evenly over the run), and the arithmetic is a few MFLOP per step, so
// neither bandwidth nor FLOP/s bound it: the latency of one step, times T, does.
//
// What the design does about that:
//  - Batch rows are independent, so the grid runs over tiles of `rows` batch
//    rows and each block walks all T steps in a loop; no block ever waits on
//    another. rows = ceil(B / #SMs) gives one tile per SM at the serving batch
//    (B = 256 on 132 SMs: 2 rows, 128 blocks of 128 threads).
//  - W_hh^T stays in shared memory for all T: 37,632 B at H = 56, 196,608 B at
//    the H = 128 cap (dynamic shared memory, opted in per launch).
//  - One thread owns one (row, hidden unit j). It keeps its own h and its three
//    gate accumulators in registers and produces h'[row, j] alone, so a step
//    needs one barrier; h is double-buffered in shared memory for the others
//    to read. The next step's xp is loaded before this step's product, so its
//    HBM latency is off the chain.
//  - expf / tanhf (not the fast-math intrinsics) keep the kernel within 1e-4
//    of the plain PyTorch version over 1024 dependent steps.
// The kernel allocates nothing and does not synchronise: the caller owns ys and
// the stream.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

namespace {

constexpr int kMaxHidden = 128;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void gru_seq_fwd_kernel(const float* __restrict__ xp,
                                   const float* __restrict__ w_hh_t,
                                   const float* __restrict__ b_hh,
                                   const float* __restrict__ h0,
                                   float* __restrict__ ys,
                                   int T, int B, int H, int rows) {
  extern __shared__ float smem[];
  const int G = 3 * H;
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

}  // namespace

extern "C" int gru_seq_fwd(const float* xp, const float* w_hh_t,
                           const float* b_hh, const float* h0, float* ys,
                           int T, int B, int H, cudaStream_t stream) {
  if (T < 0 || B < 0 || H <= 0 || H > kMaxHidden) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (T == 0 || B == 0) return 0;

  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long w_bytes = 3LL * H * H * (long long)sizeof(float);
  const long long row_bytes = 2LL * H * (long long)sizeof(float);
  const int max_rows_smem = static_cast<int>((max_smem - w_bytes) / row_bytes);
  if (max_rows_smem < 1) return static_cast<int>(cudaErrorInvalidConfiguration);

  int rows = (B + sms - 1) / sms;
  rows = std::min(rows, kMaxThreads / H);
  rows = std::min(rows, max_rows_smem);
  const size_t smem = static_cast<size_t>(w_bytes + rows * row_bytes);
  const int threads = (rows * H + 31) / 32 * 32;
  const int blocks = (B + rows - 1) / rows;

  err = cudaFuncSetAttribute(gru_seq_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gru_seq_fwd_kernel<<<blocks, threads, smem, stream>>>(xp, w_hh_t, b_hh, h0,
                                                        ys, T, B, H, rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* eegsynth_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

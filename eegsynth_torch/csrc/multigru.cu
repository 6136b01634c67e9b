// Fused multi-network GRU forward (K2) for Hopper, sm_90a: the D-step inputs
// of every stacked bucket in one launch.
//
// Replaces the TPU kernel eegsynth/nn/pallas_multigru.py:
// multigru_disc_inputs_pallas (Pallas body _make_kernel). Per time step and
// per bucket it runs
//   embedder cell    h_e = cell(xp_e[t], h_e; W_e, b_e)           -> h_real[t]
//   generator cell   h_g = cell(xp_g[t], h_g; W_g, b_g)
//   G projection     e   = h_g W_pg + b_pg
//   S input proj.    s   = e W_is + b_is
//   supervisor cell  h_s = cell(s, h_s; W_s, b_s)
//   S projection     h_fake[t] = h_s W_ps + b_ps
// with cell the torch GRU cell of gru_seq.cu (gates [r, z, n]). Forward only:
// the D step differentiates only through the discriminator.
//
//   xp_e (nb, T, B, 3He), xp_g (nb, T, B, 3Hg)   hoisted input projections
//   W_e (nb, He, 3He), W_g (nb, Hg, 3Hg), W_pg (nb, Hg, Z), W_is (nb, Z, 3Hs),
//   W_s (nb, Hs, 3Hs), W_ps (nb, Hs, Z) (all transposed: x @ W), biases (nb, n)
//   -> h_real (nb, T, B, He), h_fake (nb, T, B, Z), f32
//
// What bounds it on this card: like K1, the latency of T dependent steps; here
// each step is four dependent stages of small products, not one.
//
// What the design does about that:
//  - The grid runs over (bucket, tile of `rows` batch rows); buckets and rows
//    are independent, so each block walks all T steps alone. Each block keeps
//    its own bucket's six weight matrices and six biases in shared memory for
//    all T: 116 KB at the reference width (He = Z = 28, Hg = Hs = 56) and
//    192 KB at the T > 800 width (z 36, h 72). That allows one block per SM,
//    so the tile is chosen for at most one block per SM: nb = 18, B = 63 is
//    7 tiles of 9 rows per bucket, 126 blocks on 132 SMs.
//  - The hidden states live in shared memory (double-buffered), the stage
//    intermediates e and s too. Threads stride over the (row, unit) outputs
//    of each stage, with a barrier between dependent stages: E and G cells
//    together (independent), then the G projection, the S input projection,
//    the S cell, and the S projection, which writes only global memory: four
//    barriers per step.
//  - expf / tanhf, as in K1.
// Accepted widths: every hidden and latent width <= 128, and the weights,
// biases and one row of state within the card's opt-in shared memory per
// block (227 KB on the H100). The wrapper checks this and raises beyond it.
// The kernel allocates nothing and does not synchronise.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

namespace {

constexpr int kMaxWidth = 128;
constexpr int kThreads = 512;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// h'[j] of one row: h_row (H) and w (H, 3H) in shared memory, x_row the 3H
// input projection, bias (3H).
__device__ __forceinline__ float gru_unit(const float* h_row, const float* w,
                                          const float* bias, const float* x_row,
                                          int H, int j) {
  const int G = 3 * H;
  float a_r = 0.f, a_z = 0.f, a_n = 0.f;
#pragma unroll 4
  for (int k = 0; k < H; ++k) {
    const float hk = h_row[k];
    const float* wk = w + k * G + j;
    a_r = fmaf(hk, wk[0], a_r);
    a_z = fmaf(hk, wk[H], a_z);
    a_n = fmaf(hk, wk[2 * H], a_n);
  }
  const float rg = sigmoid(x_row[j] + (a_r + bias[j]));
  const float zg = sigmoid(x_row[H + j] + (a_z + bias[H + j]));
  const float ng = tanhf(x_row[2 * H + j] + rg * (a_n + bias[2 * H + j]));
  return (1.0f - zg) * ng + zg * h_row[j];
}

// out[k] of one row: v_row (K) @ w (K, N) + bias (N)
__device__ __forceinline__ float dense_unit(const float* v_row, const float* w,
                                            const float* bias, int K, int N,
                                            int k) {
  float acc = 0.f;
#pragma unroll 4
  for (int i = 0; i < K; ++i) acc = fmaf(v_row[i], w[i * N + k], acc);
  return acc + bias[k];
}

// Shared-memory floats: weights and biases, and per batch row of the tile.
// eegsynth_torch/nn/multigru.py:smem_bytes mirrors these two counts.
struct Dims {
  int He, Hg, Hs, Z;
  __host__ __device__ long long weight_floats() const {
    return 3LL * He * He + 3LL * Hg * Hg + (long long)Hg * Z + 3LL * Z * Hs +
           3LL * Hs * Hs + (long long)Hs * Z + 3LL * He + 3LL * Hg + Z +
           6LL * Hs + Z;
  }
  __host__ __device__ long long row_floats() const {
    return 2LL * He + 2LL * Hg + Z + 3LL * Hs + 2LL * Hs;
  }
};

__global__ void __launch_bounds__(kThreads, 1)
multigru_fwd_kernel(const float* __restrict__ xp_e, const float* __restrict__ xp_g,
                    const float* __restrict__ we, const float* __restrict__ be,
                    const float* __restrict__ wg, const float* __restrict__ bg,
                    const float* __restrict__ wpg, const float* __restrict__ bpg,
                    const float* __restrict__ wis, const float* __restrict__ bis,
                    const float* __restrict__ ws, const float* __restrict__ bs,
                    const float* __restrict__ wps, const float* __restrict__ bps,
                    float* __restrict__ h_real, float* __restrict__ h_fake,
                    int T, int B, Dims d, int rows) {
  extern __shared__ float smem[];
  const int He = d.He, Hg = d.Hg, Hs = d.Hs, Z = d.Z;
  const int Ge = 3 * He, Gg = 3 * Hg, Gs = 3 * Hs;
  const size_t n = blockIdx.y;
  const int row0 = blockIdx.x * rows;
  const int nrows = min(rows, B - row0);

  // this bucket's slices
  xp_e += n * T * B * Ge;
  xp_g += n * T * B * Gg;
  h_real += n * T * B * He;
  h_fake += n * T * B * Z;

  // shared layout: weights, biases, then the per-row state
  float* p = smem;
  auto take = [&](const float* src, long long count) {
    float* dst = p;
    for (long long i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
    p += count;
    return dst;
  };
  const float* we_s = take(we + n * He * Ge, (long long)He * Ge);
  const float* wg_s = take(wg + n * Hg * Gg, (long long)Hg * Gg);
  const float* wpg_s = take(wpg + n * Hg * Z, (long long)Hg * Z);
  const float* wis_s = take(wis + n * Z * Gs, (long long)Z * Gs);
  const float* ws_s = take(ws + n * Hs * Gs, (long long)Hs * Gs);
  const float* wps_s = take(wps + n * Hs * Z, (long long)Hs * Z);
  const float* be_s = take(be + n * Ge, Ge);
  const float* bg_s = take(bg + n * Gg, Gg);
  const float* bpg_s = take(bpg + n * Z, Z);
  const float* bis_s = take(bis + n * Gs, Gs);
  const float* bs_s = take(bs + n * Gs, Gs);
  const float* bps_s = take(bps + n * Z, Z);
  float* he_s = p;  p += 2 * rows * He;   // two buffers of (rows, He)
  float* hg_s = p;  p += 2 * rows * Hg;
  float* hs_s = p;  p += 2 * rows * Hs;
  float* e_s = p;   p += rows * Z;        // G projection of this step
  float* s_s = p;                         // S input projection, (rows, 3Hs)

  for (int i = threadIdx.x; i < rows * He; i += blockDim.x) he_s[i] = 0.f;
  for (int i = threadIdx.x; i < rows * Hg; i += blockDim.x) hg_s[i] = 0.f;
  for (int i = threadIdx.x; i < rows * Hs; i += blockDim.x) hs_s[i] = 0.f;
  __syncthreads();

  const int n_eg = nrows * (He + Hg);
  for (int t = 0; t < T; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    const float* he_cur = he_s + cur * rows * He;
    const float* hg_cur = hg_s + cur * rows * Hg;
    const float* hs_cur = hs_s + cur * rows * Hs;
    float* he_nxt = he_s + nxt * rows * He;
    float* hg_nxt = hg_s + nxt * rows * Hg;
    float* hs_nxt = hs_s + nxt * rows * Hs;
    const size_t step_row = (size_t)t * B + row0;

    // stage 1: embedder and generator cells
    for (int i = threadIdx.x; i < n_eg; i += blockDim.x) {
      if (i < nrows * He) {
        const int r = i / He, j = i - r * He;
        const float h = gru_unit(he_cur + r * He, we_s, be_s,
                                 xp_e + (step_row + r) * Ge, He, j);
        he_nxt[r * He + j] = h;
        h_real[(step_row + r) * He + j] = h;
      } else {
        const int k = i - nrows * He;
        const int r = k / Hg, j = k - r * Hg;
        hg_nxt[r * Hg + j] = gru_unit(hg_cur + r * Hg, wg_s, bg_s,
                                      xp_g + (step_row + r) * Gg, Hg, j);
      }
    }
    __syncthreads();
    // stage 2: G projection
    for (int i = threadIdx.x; i < nrows * Z; i += blockDim.x) {
      const int r = i / Z, k = i - r * Z;
      e_s[r * Z + k] = dense_unit(hg_nxt + r * Hg, wpg_s, bpg_s, Hg, Z, k);
    }
    __syncthreads();
    // stage 3: supervisor input projection
    for (int i = threadIdx.x; i < nrows * Gs; i += blockDim.x) {
      const int r = i / Gs, g = i - r * Gs;
      s_s[r * Gs + g] = dense_unit(e_s + r * Z, wis_s, bis_s, Z, Gs, g);
    }
    __syncthreads();
    // stage 4: supervisor cell
    for (int i = threadIdx.x; i < nrows * Hs; i += blockDim.x) {
      const int r = i / Hs, j = i - r * Hs;
      hs_nxt[r * Hs + j] = gru_unit(hs_cur + r * Hs, ws_s, bs_s, s_s + r * Gs,
                                    Hs, j);
    }
    __syncthreads();
    // stage 5: supervisor projection, straight to global memory. The next
    // step's stages 1-3 touch none of what it reads, and its stage 4 comes
    // after three more barriers.
    for (int i = threadIdx.x; i < nrows * Z; i += blockDim.x) {
      const int r = i / Z, k = i - r * Z;
      h_fake[(step_row + r) * Z + k] =
          dense_unit(hs_nxt + r * Hs, wps_s, bps_s, Hs, Z, k);
    }
  }
}

}  // namespace

extern "C" int multigru_fwd(const float* xp_e, const float* xp_g,
                            const float* we, const float* be,
                            const float* wg, const float* bg,
                            const float* wpg, const float* bpg,
                            const float* wis, const float* bis,
                            const float* ws, const float* bs,
                            const float* wps, const float* bps,
                            float* h_real, float* h_fake,
                            int nb, int T, int B, int He, int Hg, int Hs, int Z,
                            cudaStream_t stream) {
  const Dims d{He, Hg, Hs, Z};
  if (nb < 0 || T < 0 || B < 0 || nb > 65535 ||
      std::min(std::min(He, Hg), std::min(Hs, Z)) <= 0 ||
      std::max(std::max(He, Hg), std::max(Hs, Z)) > kMaxWidth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb == 0 || T == 0 || B == 0) return 0;

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
  const long long fixed = d.weight_floats() * (long long)sizeof(float);
  const long long per_row = d.row_floats() * (long long)sizeof(float);
  const int max_rows = static_cast<int>((max_smem - fixed) / per_row);
  if (max_rows < 1) return static_cast<int>(cudaErrorInvalidConfiguration);

  // at most one block per SM fits, so aim for nb * tiles <= #SMs
  const int tiles_per_bucket = std::max(1, sms / nb);
  int rows = (B + tiles_per_bucket - 1) / tiles_per_bucket;
  rows = std::max(1, std::min(rows, max_rows));
  const size_t smem = static_cast<size_t>(fixed + rows * per_row);
  const dim3 grid((B + rows - 1) / rows, nb);
  err = cudaFuncSetAttribute(multigru_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  multigru_fwd_kernel<<<grid, kThreads, smem, stream>>>(
      xp_e, xp_g, we, be, wg, bg, wpg, bpg, wis, bis, ws, bs, wps, bps,
      h_real, h_fake, T, B, d, rows);
  return static_cast<int>(cudaGetLastError());
}

// Flash-attention dq kernel K3b for Hopper, sm_90a: the first half of the
// backward of full (non-causal) softmax attention in float32. The forward K3a
// and the dk/dv kernel K3c run on the tensor cores and are in
// flash_attn_tc.cu; this kernel still runs FP32 FMAs on the CUDA cores.
//
// Replaces the TPU kernel of eegsynth/nn/attention.py:
//   K3b  _fa_backward's dq pallas_call (body _fa_dq_kernel)
//
//   q, k, v, do (BH, T, D) float32, lse and delta (BH, T), scale = D^-0.5
//   p = exp(s - lse), ds = p (do v^T - delta) scale, dq = ds k
// delta = rowsum(do * o) is computed by the caller, as the JAX package does
// in XLA outside its kernels.
//
// The TPU kernel zero-pads T to a multiple of 128 and picks 512/256/128-row
// blocks; the grid's last dimension walks the key blocks in order and
// carries dq in VMEM scratch. Here blocks run in no order, so each block owns
// one 64-row query tile and loops over the key tiles itself: no atomics, no
// state crosses blocks. The kernel masks the ragged edge itself instead of
// padding: key columns at or beyond T score -1e30 (exp gives 0), rows beyond
// T are neither computed into an output nor written.
//
// What bounds it on this card: three tile products per tile pair (6 B T^2 D
// FLOPs), issued here as scalar FP32 FMAs on the CUDA cores (67 TFLOP/s peak
// at 700 W), each fed from shared memory. A thread computes a 4 x 4 register
// tile of scores (4 rows x 4 columns 16 apart) and a 4 x ceil(D/16) tile of
// dq, so each shared load feeds 4 FMAs; the shared-memory bandwidth of those
// loads, not HBM, is the limit. The tensor-core design of K3a and K3c
// (split-TF32 wgmma) is the next step for it.
//
// Layout of the work:
//  - 64 x 64 tiles, 256 threads as 16 x 16: thread (ty, tx) holds score rows
//    4 ty .. 4 ty + 3 and columns tx, tx + 16, tx + 32, tx + 48, and dq rows
//    4 ty .. 4 ty + 3 at head-dimension columns tx + 16 j.
//  - D-wide tiles in shared memory have a pitch of D + 1 floats: 16
//    neighbouring rows read at the same d hit 16 different banks.
//  - lse and delta per row live in shared memory.
//  - D <= 128; a template on ceil(D / 16), rounded up to a power of two,
//    sizes the register tiles (the model's D = 64 fits exactly). Shared
//    memory goes above 48 KB, so each launch sets the dynamic shared-memory
//    attribute.
//  - expf, not the fast intrinsic, keeps the kernel within 1e-4 of the plain
//    PyTorch version.
// The kernel allocates nothing and does not synchronise: the caller owns the
// output and the stream.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <type_traits>

namespace {

constexpr int kTile = 64;            // query rows and key rows per tile
constexpr int kThreads = 256;        // 16 x 16
constexpr int kPitchS = kTile + 1;   // pitch of a 64 x 64 score tile
constexpr int kMaxD = 128;
constexpr float kNeg = -1e30f;

// Copy rows [r0, r0 + 64) of a (T, D) matrix into a tile of pitch D + 1,
// zero-filling rows at or beyond T.
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0,
                                          int T, int D) {
  const int dp = D + 1;
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    dst[r * dp + c] = (r0 + r < T) ? src[(size_t)(r0 + r) * D + c] : 0.f;
  }
}

__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0,
                                          int T) {
  if (threadIdx.x < kTile) {
    const int r = r0 + threadIdx.x;
    dst[threadIdx.x] = r < T ? src[r] : 0.f;
  }
}

// s[i][j] += a[row 4 ty + i] . b[row tx + 16 j] over d, both tiles of
// pitch D + 1.
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* a,
                                         const float* b, int D, int ty,
                                         int tx) {
  const int dp = D + 1;
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty * 4 + i) * dp + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * dp + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// The ds tile of a backward step: p = exp(s - lse) and
// ds = p (do v^T - delta) scale for rows 4 ty + i, columns tx + 16 j.
// Query rows at or beyond T give ds = 0; key columns at or beyond T score
// -1e30.
__device__ __forceinline__ void bwd_scores(float (&ds)[4][4],
                                           const float* qs, const float* dos,
                                           const float* ks, const float* vs,
                                           const float* row_lse,
                                           const float* row_dlt, int q0, int k0,
                                           int T, int D, float scale, int ty,
                                           int tx) {
  float s[4][4] = {}, dpv[4][4] = {};
  tile_dot(s, qs, ks, D, ty, tx);
  tile_dot(dpv, dos, vs, D, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const bool row_in = q0 + r < T;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float sv = (k0 + tx + 16 * j < T) ? s[i][j] * scale : kNeg;
      const float pv = row_in ? expf(sv - row_lse[r]) : 0.f;
      ds[i][j] = pv * (dpv[i][j] - row_dlt[r]) * scale;
    }
  }
}

// K3b. Grid (query tile, b h). Shared: q, do, k, v tiles (pitch D + 1), the
// ds tile, and lse, delta per row.
template <int NJ>
__global__ void flash_dq_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const float* __restrict__ d_o,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                float* __restrict__ dq, int T, int D,
                                float scale) {
  extern __shared__ float smem[];
  const int dp = D + 1;
  float* qs = smem;
  float* dos = qs + kTile * dp;
  float* ks = dos + kTile * dp;
  float* vs = ks + kTile * dp;
  float* dss = vs + kTile * dp;
  float* row_lse = dss + kTile * kPitchS;
  float* row_dlt = row_lse + kTile;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kTile;
  const size_t base = (size_t)blockIdx.y * T * D;
  const size_t rbase = (size_t)blockIdx.y * T;

  load_tile(qs, q + base, q0, T, D);
  load_tile(dos, d_o + base, q0, T, D);
  load_rows(row_lse, lse + rbase, q0, T);
  load_rows(row_dlt, delta + rbase, q0, T);
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < T; k0 += kTile) {
    __syncthreads();
    load_tile(ks, k + base, k0, T, D);
    load_tile(vs, v + base, k0, T, D);
    __syncthreads();

    float ds[4][4];
    bwd_scores(ds, qs, dos, ks, vs, row_lse, row_dlt, q0, k0, T, D, scale, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dss[(ty * 4 + i) * kPitchS + tx + 16 * j] = ds[i][j];
    __syncthreads();

    for (int kk = 0; kk < kTile; ++kk) {
      float dsv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty * 4 + i) * kPitchS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        kv[j] = c < D ? ks[kk * dp + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= T) continue;
    float* row = dq + base + (size_t)(q0 + r) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) row[c] = acc[i][j];
    }
  }
}

// D^-0.5 rounded once to float, as the JAX package's Python float is.
float head_scale(int D) {
  return static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
}

bool bad_dims(int BH, int T, int D) {
  return BH < 0 || BH > 65535 || T < 0 || D < 1 || D > kMaxD;
}

// Run f with the register-tile width NJ as a compile-time constant: the
// power of two at or above ceil(D / 16) (columns beyond D are guarded), so
// four instances per kernel cover D <= 128.
template <typename F>
int with_nj(int D, F&& f) {
  const int nj = (D + 15) / 16;
  if (nj <= 1) return f(std::integral_constant<int, 1>{});
  if (nj <= 2) return f(std::integral_constant<int, 2>{});
  if (nj <= 4) return f(std::integral_constant<int, 4>{});
  if (nj <= 8) return f(std::integral_constant<int, 8>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// Shared bytes: `d_tiles` tiles of 64 x (D + 1), `s_tiles` of 64 x 65 and
// `rows` vectors of 64.
size_t smem_bytes(int D, int d_tiles, int s_tiles, int rows) {
  return sizeof(float) * ((size_t)d_tiles * kTile * (D + 1) +
                          (size_t)s_tiles * kTile * kPitchS +
                          (size_t)rows * kTile);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int tiles, int BH, size_t smem, cudaStream_t stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(tiles, BH), kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_bwd_dq(const float* q, const float* k, const float* v,
                            const float* d_o, const float* lse,
                            const float* delta, float* dq, int BH, int T, int D,
                            cudaStream_t stream) {
  if (bad_dims(BH, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0 || T == 0) return 0;
  const float scale = head_scale(D);
  const int tiles = (T + kTile - 1) / kTile;
  return with_nj(D, [&](auto nj) {
    return launch(flash_dq_kernel<decltype(nj)::value>, tiles, BH,
                  smem_bytes(D, 4, 1, 2), stream, q, k, v, d_o, lse, delta, dq,
                  T, D, scale);
  });
}

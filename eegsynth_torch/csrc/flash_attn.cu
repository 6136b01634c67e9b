// Flash-attention kernels K3a (forward), K3b (dq) and K3c (dk, dv) for
// Hopper, sm_90a: full (non-causal) softmax attention in float32.
//
// Replaces the TPU kernels of eegsynth/nn/attention.py:
//   K3a  _fa_forward (pallas_call, body _fa_fwd_kernel)
//   K3b  _fa_backward's dq pallas_call (body _fa_dq_kernel)
//   K3c  _fa_backward's dk/dv pallas_call (body _fa_dkv_kernel)
//
//   q, k, v, do (BH, T, D) float32, lse and delta (BH, T), scale = D^-0.5
//   K3a: s = (q k^T) scale, online softmax over key tiles -> o, lse = m + log l
//   K3b: p = exp(s - lse), ds = p (do v^T - delta) scale, dq = ds k
//   K3c: dv = p^T do, dk = ds^T q
// delta = rowsum(do * o) is computed by the caller, as the JAX package does
// in XLA outside its kernels.
//
// The TPU kernels zero-pad T to a multiple of 128 and pick 512/256/128-row
// blocks; the grid's last dimension walks the other operand's blocks in
// order and carries the running state in VMEM scratch. Here blocks run in no
// order, so each block owns one output tile and loops over the other
// operand's tiles itself: no atomics, no state crosses blocks. The kernels
// mask the ragged edge themselves instead of padding: key columns at or
// beyond T score -1e30 (exp gives 0), rows beyond T are neither computed
// into an output nor written, and in K3c a query row beyond T contributes
// p = ds = 0 (the JAX package gets that from zero dO and zero delta on its
// padded rows).
//
// What bounds them on this card: the two tile products per tile pair
// (4 B T^2 D FMAs forward, 10 backward), issued here as scalar FP32 FMAs on
// the CUDA cores (67 TFLOP/s peak at 700 W), each fed from shared memory. A
// thread computes a 4 x 4 register tile of scores (4 rows x 4 columns 16
// apart) and a 4 x ceil(D/16) tile of the output, so each shared load
// feeds 4 FMAs; the shared-memory bandwidth of those loads, not HBM, is the
// limit (a kernel reads each of q, k, v, do once per tile pair it touches).
// Tensor cores (wgmma, TF32) would change the numbers against the plain
// version and are later work.
//
// Layout of the work:
//  - 64 x 64 tiles, 256 threads as 16 x 16: thread (ty, tx) holds score rows
//    4 ty .. 4 ty + 3 and columns tx, tx + 16, tx + 32, tx + 48, and output
//    rows 4 ty .. 4 ty + 3 at head-dimension columns tx + 16 j.
//  - D-wide tiles in shared memory have a pitch of D + 1 floats: 16
//    neighbouring rows read at the same d hit 16 different banks.
//  - The row statistics (m, l, alpha; lse, delta) live in shared memory,
//    and one warp reduces 8 score rows per step in the forward.
//  - D <= 128; a template on ceil(D / 16), rounded up to a power of two,
//    sizes the register tiles (the model's D = 64 fits exactly). Shared
//    memory goes above 48 KB (up to 166 KB in K3c at D = 128), so each
//    launch sets the dynamic shared-memory attribute.
//  - expf / logf, not the fast intrinsics, keep the kernels within 1e-5 of
//    the plain PyTorch versions.
// The kernels allocate nothing and do not synchronise: the caller owns the
// outputs and the stream.

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

// K3a. Grid (query tile, b h). Shared: q, k, v tiles (pitch D + 1), the
// score tile, and m, l, alpha per row.
template <int NJ>
__global__ void flash_fwd_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 float* __restrict__ o,
                                 float* __restrict__ lse, int T, int D,
                                 float scale) {
  extern __shared__ float smem[];
  const int dp = D + 1;
  float* qs = smem;
  float* ks = qs + kTile * dp;
  float* vs = ks + kTile * dp;
  float* ps = vs + kTile * dp;
  float* row_m = ps + kTile * kPitchS;
  float* row_l = row_m + kTile;
  float* row_a = row_l + kTile;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kTile;
  const size_t base = (size_t)blockIdx.y * T * D;

  load_tile(qs, q + base, q0, T, D);
  if (tid < kTile) {
    row_m[tid] = kNeg;
    row_l[tid] = 0.f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < T; k0 += kTile) {
    __syncthreads();                 // the last tile's readers are done
    load_tile(ks, k + base, k0, T, D);
    load_tile(vs, v + base, k0, T, D);
    __syncthreads();

    float s[4][4] = {};
    tile_dot(s, qs, ks, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        ps[(ty * 4 + i) * kPitchS + c] = (k0 + c < T) ? s[i][j] * scale : kNeg;
      }
    __syncthreads();

    // online softmax: warp w updates rows 8 w .. 8 w + 7
    for (int rr = 0; rr < 8; ++rr) {
      const int r = warp * 8 + rr;
      float* row = ps + r * kPitchS;
      const float x0 = row[lane], x1 = row[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        row_a[r] = alpha;
        row_l[r] = alpha * row_l[r] + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = row_a[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    for (int kk = 0; kk < kTile; ++kk) {
      float p[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * kPitchS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        vv[j] = c < D ? vs[kk * dp + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= T) continue;
    const float l = row_l[r];
    const float l_safe = l == 0.f ? 1.f : l;
    float* orow = o + base + (size_t)(q0 + r) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) orow[c] = acc[i][j] / l_safe;
    }
    if (tx == 0) lse[(size_t)blockIdx.y * T + q0 + r] = row_m[r] + logf(l_safe);
  }
}

// The score tile of a backward step: p = exp(s - lse) and
// ds = p (do v^T - delta) scale for rows 4 ty + i, columns tx + 16 j.
// Query rows at or beyond T give p = ds = 0; key columns at or beyond T
// score -1e30.
__device__ __forceinline__ void bwd_scores(float (&p)[4][4], float (&ds)[4][4],
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
      p[i][j] = pv;
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

    float p[4][4], ds[4][4];
    bwd_scores(p, ds, qs, dos, ks, vs, row_lse, row_dlt, q0, k0, T, D, scale,
               ty, tx);
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

// K3c. Grid (key tile, b h). Shared: the block's k, v tiles and each query
// step's q, do tiles (pitch D + 1), the p and ds tiles, lse and delta per
// query row. Thread (ty, tx) accumulates dk and dv for key rows 4 ty + i at
// columns tx + 16 j.
template <int NJ>
__global__ void flash_dkv_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 const float* __restrict__ d_o,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 float* __restrict__ dk,
                                 float* __restrict__ dv, int T, int D,
                                 float scale) {
  extern __shared__ float smem[];
  const int dp = D + 1;
  float* ks = smem;
  float* vs = ks + kTile * dp;
  float* qs = vs + kTile * dp;
  float* dos = qs + kTile * dp;
  float* pss = dos + kTile * dp;
  float* dss = pss + kTile * kPitchS;
  float* row_lse = dss + kTile * kPitchS;
  float* row_dlt = row_lse + kTile;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * kTile;
  const size_t base = (size_t)blockIdx.y * T * D;
  const size_t rbase = (size_t)blockIdx.y * T;

  load_tile(ks, k + base, k0, T, D);
  load_tile(vs, v + base, k0, T, D);
  float acc_k[4][NJ], acc_v[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  for (int q0 = 0; q0 < T; q0 += kTile) {
    __syncthreads();
    load_tile(qs, q + base, q0, T, D);
    load_tile(dos, d_o + base, q0, T, D);
    load_rows(row_lse, lse + rbase, q0, T);
    load_rows(row_dlt, delta + rbase, q0, T);
    __syncthreads();

    // scores with query rows 4 ty + i and key columns tx + 16 j
    float p[4][4], ds[4][4];
    bwd_scores(p, ds, qs, dos, ks, vs, row_lse, row_dlt, q0, k0, T, D, scale,
               ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pss[(ty * 4 + i) * kPitchS + tx + 16 * j] = p[i][j];
        dss[(ty * 4 + i) * kPitchS + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();

    for (int qq = 0; qq < kTile; ++qq) {
      float pv[4], dsv[4], gv[NJ], qv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = pss[qq * kPitchS + ty * 4 + i];
        dsv[i] = dss[qq * kPitchS + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        gv[j] = c < D ? dos[qq * dp + c] : 0.f;
        qv[j] = c < D ? qs[qq * dp + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc_v[i][j] = fmaf(pv[i], gv[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(dsv[i], qv[j], acc_k[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (k0 + r >= T) continue;
    float* krow = dk + base + (size_t)(k0 + r) * D;
    float* vrow = dv + base + (size_t)(k0 + r) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) {
        krow[c] = acc_k[i][j];
        vrow[c] = acc_v[i][j];
      }
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

extern "C" int flash_fwd(const float* q, const float* k, const float* v,
                         float* o, float* lse, int BH, int T, int D,
                         cudaStream_t stream) {
  if (bad_dims(BH, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0 || T == 0) return 0;
  const float scale = head_scale(D);
  const int tiles = (T + kTile - 1) / kTile;
  return with_nj(D, [&](auto nj) {
    return launch(flash_fwd_kernel<decltype(nj)::value>, tiles, BH,
                  smem_bytes(D, 3, 1, 3), stream, q, k, v, o, lse, T, D, scale);
  });
}

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

extern "C" int flash_bwd_dkv(const float* q, const float* k, const float* v,
                             const float* d_o, const float* lse,
                             const float* delta, float* dk, float* dv, int BH,
                             int T, int D, cudaStream_t stream) {
  if (bad_dims(BH, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0 || T == 0) return 0;
  const float scale = head_scale(D);
  const int tiles = (T + kTile - 1) / kTile;
  return with_nj(D, [&](auto nj) {
    return launch(flash_dkv_kernel<decltype(nj)::value>, tiles, BH,
                  smem_bytes(D, 4, 2, 2), stream, q, k, v, d_o, lse, delta, dk,
                  dv, T, D, scale);
  });
}

// GRU sequence kernel K1, wide forward on a thread-block cluster, for
// Hopper, sm_90a: hidden widths past 128 up to what a cluster's shared
// memory holds, with a leading bucket axis.
//
// Replaces the TPU kernel eegsynth/nn/pallas_gru.py:_gru_seq_pallas at the
// widths gru_seq.cu does not take, as gru_seq_wide.cu's forward does; the
// wrapper (eegsynth_torch/nn/gru_sequence.py, cluster_plan) takes this
// kernel wherever a plan fits and gru_seq_wide.cu's streaming forward above
// that. Same layouts and the same function:
//
//   xp (nb, T, B, 3H), w_hh_t (nb, H, 3H) = W_hh^T, b_hh (nb, 3H),
//   h0 (nb, B, H) -> ys (nb, T, B, H), f32, gates [r, z, n].
//
// What bounds it: T dependent steps. The Pallas kernel keeps the whole of
// W_hh^T on chip for every step (768 KB at H 256, 3 MB at H 512); one SM's
// 227 KB does not hold it, so gru_seq_wide.cu streams it from L2 every step
// (29 us a step at (1, 768, 64, 256) on the H100, 0.3 % of the bound). A
// cluster of C blocks does hold it: block c owns hidden units [c U,
// (c + 1) U), U = ceil(H / C), and keeps their three gate columns of W_hh^T
// in its shared memory, loaded once (cp.async) before step 0. A step then
// costs its sums from shared memory and one exchange of h' inside the
// cluster, not a pass over W_hh^T in L2.
//
// Design.
//  - One cluster serves one (bucket, tile of R batch rows). Each block keeps
//    the tile's whole h (R rows, two buffers) at gru_seq.cu's layout: the
//    depth cut into S slices of KL (a multiple of 4, S KL >= H), slice s at
//    s SP, SP = KL + 4 or KL + 8, whichever is 4 past a multiple of 8, so
//    that the S slices a quarter warp reads lie in distinct banks; zeros
//    past H.
//  - Thread (j, s), j < U the block's unit and s < S the slice (the S lanes
//    of a unit adjacent in a warp), sums its KL-long slice of the three
//    gates' dot products for the R rows: W_hh^T's float4 of (gate, four k,
//    unit, slice) lies at ((g KL/4 + q) U S + j S + s), so a warp reads 512
//    contiguous bytes a gate, and h's float4 is a broadcast. The sums run
//    over the slice's k in order from zero, one fmaf each; the S partial
//    sums are added by gru_cell.cuh's butterfly (distance S/2, S/4, ..., 1),
//    which leaves each lane one row (or R/S rows) of the three sums: the
//    register kernel's order at this (KL, S), so two calls give the same
//    bits and tests/test_torch_gru_wide.py emulates it on the CPU.
//  - The lanes that hold a row form its gates (gru_cell.cuh's sigmoid, the
//    accurate tanhf), write ys, and write h' into the next h buffer of
//    every block of the cluster, themselves included, with st.async: the
//    lanes that hold the same row split the C blocks between them. Each
//    store counts its 4 bytes on the receiver's mbarrier of that buffer,
//    armed with the step's n H 4 bytes, so one wait a step stands for the
//    whole exchange. A block can only send h_{t+2} into a buffer once it
//    holds all of h_{t+1}, which every block sends after its step t sums
//    have read that buffer: two buffers need no "empty" barrier.
//  - xp of step t + 1 is loaded during step t, into registers.
//  - The plan (C of 2, 4, 8 or 16; R of 1, 2, 4 or 8; S 4 for C <= 4, else
//    8; KL; U) comes from the wrapper, which picks it from the shape and the
//    card's numbers (gru_seq_cluster_card: SMs, shared bytes a block and
//    an SM, clusters resident at once for each C at one block an SM); the
//    kernel refuses a plan it
//    cannot launch with cudaErrorInvalidValue. A cluster of 16 is
//    non-portable: it needs cudaFuncAttributeNonPortableClusterSizeAllowed.
//    Nothing depends across clusters, so clusters past one wave cost time
//    but cannot deadlock.
//  - The step-chain floor (gru_seq_cluster_chain, a probe for chip_smoke.py
//    and nothing else): the same kernel, plan and set-up with each step's
//    sums and gates left out, so its T steps are the exchange of h and the
//    wait for it alone.
// The kernel allocates nothing and does not synchronise.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "cluster.cuh"     // cluster_rank, cluster_sync, remote, mbar_*, st_async
#include "gru_cell.cuh"    // sigmoid_fwd, reduce_rows, held_offset
#include "tf32_wgmma.cuh"  // cp_async4, cp_async_commit, cp_async_wait, fence_proxy_async

namespace {

constexpr int kMaxThreads = 512;  // a block: U S rounded up to a warp
constexpr int kMinHidden = 1;
constexpr int kMaxHidden = 1024;  // the grids' bound; the plan's shared memory caps it lower
constexpr int kBarBytes = 16;     // the two mbarriers, ahead of W_hh^T's slice

__host__ __device__ inline int slice_pitch(int KL) { return KL % 8 == 0 ? KL + 4 : KL + 8; }

// Where depth k of a row of h lies in its (S slices of SP) row.
__device__ __forceinline__ int h_pos(int k, int KL, int SP) { return (k / KL) * SP + k % KL; }

template <int S, int R, bool kChain = false>
__global__ void __launch_bounds__(kMaxThreads, 1)
gru_cluster_fwd_kernel(const float* __restrict__ xp, const float* __restrict__ w_hh_t,
                       const float* __restrict__ b_hh, const float* __restrict__ h0,
                       float* __restrict__ ys, int T, int B, int H, int C, int KL, int U) {
  extern __shared__ __align__(16) unsigned char cl_smem[];
  constexpr int kHeld = R >= S ? R / S : 1;   // rows a lane holds after the butterfly
  constexpr int kShare = R >= S ? 1 : S / R;  // lanes holding the same row
  uint64_t* full = reinterpret_cast<uint64_t*>(cl_smem);  // h_{t} has landed in buffer t & 1
  float* w_s = reinterpret_cast<float*>(cl_smem + kBarBytes);
  const int Q = KL / 4, US = U * S, SP = slice_pitch(KL), P = S * SP, G = 3 * H;
  float* h_s = w_s + 3 * KL * US;  // two buffers of (R, P)

  const uint32_t rank = cluster_rank();
  const int tile = blockIdx.x / C;
  const size_t bucket = blockIdx.y;
  xp += bucket * T * B * G;
  ys += bucket * T * B * H;
  w_hh_t += bucket * H * G;
  b_hh += bucket * G;
  h0 += bucket * B * H;
  const int b0 = tile * R;
  const int n = min(R, B - b0);            // rows of this tile
  const int u0 = rank * U;                 // the block's first unit
  const int nu = max(0, min(U, H - u0));   // its units (the last block's may be fewer)
  const int s = threadIdx.x % S, j = threadIdx.x / S;
  const bool live = j < nu;
  const int jc = min(j, U - 1);            // lanes past U read unit U - 1, store nothing
  const int unit = min(u0 + j, H - 1);

  if (threadIdx.x == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    fence_mbarrier_init();
  }
  // W_hh^T's slice: coalesced along the units, zeros past H and past nu
  const int KP = S * KL;
  for (int i = threadIdx.x; i < 3 * KP * U; i += blockDim.x) {
    const int jj = i % U, gk = i / U, k = gk % KP, g = gk / KP;
    const bool ok = k < H && jj < nu;
    const int kk = k % KL;
    cp_async4(&w_s[((g * Q + kk / 4) * US + jj * S + k / KL) * 4 + (kk & 3)],
              ok ? w_hh_t + (size_t)k * G + g * H + u0 + jj : w_hh_t, ok ? 4 : 0);
  }
  cp_async_commit();
  // h0 into buffer 0 at the sliced pitch, zeros elsewhere in both buffers
  for (int i = threadIdx.x; i < 2 * R * P; i += blockDim.x) {
    const int r = i / P, p = i % P, sl = p / SP, kk = p % SP, k = sl * KL + kk;
    h_s[i] = r < n && kk < KL && k < H ? h0[(size_t)(b0 + r) * H + k] : 0.f;
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  const uint32_t bytes = 4u * n * H;  // one step's h' from all C blocks
  if (threadIdx.x == 0) {
    if (T >= 2) mbar_expect(&full[1], bytes);
    if (T >= 3) mbar_expect(&full[0], bytes);
  }
  cluster_sync();  // every block's barriers armed and buffers zeroed before any st.async

  const int off = held_offset<S / 2, R>(s);
  const float bias[3] = {b_hh[unit], b_hh[H + unit], b_hh[2 * H + unit]};
  const float4* w4 = reinterpret_cast<const float4*>(w_s) + jc * S + s;
  const int hj = h_pos(unit, KL, SP);
  const int m = s & (kShare - 1);  // which of the row's lanes this is
  float x[kHeld][3], xn[kHeld][3];
  auto load_x = [&](int t, float (&v)[kHeld][3]) {
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      const float* xr = xp + ((size_t)t * B + b0 + min(off + i, n - 1)) * G + unit;
      v[i][0] = xr[0];
      v[i][1] = xr[H];
      v[i][2] = xr[2 * H];
    }
  };
  load_x(0, x);

  for (int t = 0; t < T; ++t) {
    if (t + 1 < T) load_x(t + 1, xn);
    const float* hc = h_s + (t & 1) * R * P;
    float* hn = h_s + ((t + 1) & 1) * R * P;
    if (t > 0) {
      mbar_wait(&full[t & 1], ((t - 1) >> 1) & 1);  // h_t from every block
      if (threadIdx.x == 0 && t + 2 < T) mbar_expect(&full[t & 1], bytes);  // for h_{t+2}
    }
    float a[R][3];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r][0] = a[r][1] = a[r][2] = 0.f;
#pragma unroll 2
    for (int q = 0; q < (kChain ? 0 : Q); ++q) {
      const float4 w0 = w4[q * US], w1 = w4[(Q + q) * US], w2 = w4[(2 * Q + q) * US];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 h4 = *reinterpret_cast<const float4*>(hc + r * P + s * SP + 4 * q);
        a[r][0] = fmaf(h4.x, w0.x, a[r][0]);
        a[r][0] = fmaf(h4.y, w0.y, a[r][0]);
        a[r][0] = fmaf(h4.z, w0.z, a[r][0]);
        a[r][0] = fmaf(h4.w, w0.w, a[r][0]);
        a[r][1] = fmaf(h4.x, w1.x, a[r][1]);
        a[r][1] = fmaf(h4.y, w1.y, a[r][1]);
        a[r][1] = fmaf(h4.z, w1.z, a[r][1]);
        a[r][1] = fmaf(h4.w, w1.w, a[r][1]);
        a[r][2] = fmaf(h4.x, w2.x, a[r][2]);
        a[r][2] = fmaf(h4.y, w2.y, a[r][2]);
        a[r][2] = fmaf(h4.z, w2.z, a[r][2]);
        a[r][2] = fmaf(h4.w, w2.w, a[r][2]);
      }
    }
    if constexpr (!kChain) {
      int held = 0;  // off, as held_offset gives it
      reduce_rows<R, S / 2, R>(a, s, held);
    }
    if (live) {
#pragma unroll
      for (int i = 0; i < kHeld; ++i) {
        const int r = off + i;
        if (r < n) {
          const float h = hc[r * P + hj];
          if (kChain) {  // the probe: pass h on, no gates, no ys
            if (t + 1 < T) {
              for (int p = m; p < C; p += kShare) {
                st_async(remote(hn + r * P + hj, p), h, remote(&full[(t + 1) & 1], p));
              }
            }
            continue;
          }
          const float rg = sigmoid_fwd(x[i][0] + (a[i][0] + bias[0]));
          const float zg = sigmoid_fwd(x[i][1] + (a[i][1] + bias[1]));
          const float ng = tanhf(x[i][2] + rg * (a[i][2] + bias[2]));
          const float hv = (1.0f - zg) * ng + zg * h;
          if (m == 0) ys[((size_t)t * B + b0 + r) * H + u0 + j] = hv;
          if (t + 1 < T) {
            for (int p = m; p < C; p += kShare) {
              st_async(remote(hn + r * P + hj, p), hv, remote(&full[(t + 1) & 1], p));
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      x[i][0] = xn[i][0];
      x[i][1] = xn[i][1];
      x[i][2] = xn[i][2];
    }
  }
  cluster_sync();  // no block leaves while another may still write to its shared memory
}

// S, KL and U of a plan are the wrapper's (cluster_geometry); these are the
// limits the kernel checks.
size_t cluster_smem(int R, int S, int KL, int U) {
  return kBarBytes + sizeof(float) * (3 * (size_t)KL * U * S + 2 * (size_t)R * S * slice_pitch(KL));
}

bool bad_plan(int nb, int T, int B, int H, int C, int R, int S, int KL, int U, int max_smem) {
  if (nb < 0 || T < 0 || B < 0 || nb > 65535 || H < kMinHidden || H > kMaxHidden) return true;
  if (C != 2 && C != 4 && C != 8 && C != 16) return true;
  if (R != 1 && R != 2 && R != 4 && R != 8) return true;
  if (S != 4 && S != 8) return true;
  if (KL < 4 || KL % 4 || S * KL < H || U < 1 || (C - 1) * U >= H || C * U < H) return true;
  if ((U * S + 31) / 32 * 32 > kMaxThreads) return true;
  const long long tiles = (std::max(B, 1) + R - 1) / R;
  if (tiles * C > 0x7fffffffLL) return true;
  return cluster_smem(R, S, KL, U) > static_cast<size_t>(max_smem);
}

template <int S, int R, bool kChain>
cudaError_t cluster_launch(const float* xp, const float* w_hh_t, const float* b_hh,
                           const float* h0, float* ys, int nb, int T, int B, int H, int C,
                           int KL, int U, cudaStream_t stream) {
  const auto kernel = gru_cluster_fwd_kernel<S, R, kChain>;
  const size_t smem = cluster_smem(R, S, KL, U);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess && C > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((B + R - 1) / R * C), nb);
  cfg.blockDim = dim3((U * S + 31) / 32 * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, xp, w_hh_t, b_hh, h0, ys, T, B, H, C, KL, U);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int S, bool kChain>
cudaError_t cluster_launch_rows(int R, const float* xp, const float* w_hh_t, const float* b_hh,
                                const float* h0, float* ys, int nb, int T, int B, int H, int C,
                                int KL, int U, cudaStream_t stream) {
#define GRU_CLUSTER(RR) \
  cluster_launch<S, RR, kChain>(xp, w_hh_t, b_hh, h0, ys, nb, T, B, H, C, KL, U, stream)
  switch (R) {
    case 1: return GRU_CLUSTER(1);
    case 2: return GRU_CLUSTER(2);
    case 4: return GRU_CLUSTER(4);
    default: return GRU_CLUSTER(8);
  }
#undef GRU_CLUSTER
}

cudaError_t max_smem(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return err;
}

// Clusters of C blocks resident at once, one block an SM (a block of the
// most threads, at the most shared memory a block can take: a plan's own
// launch has at least as many resident). 0 where the card cannot launch a
// cluster of C.
cudaError_t resident_clusters(int C, int smem, int* out) {
  const auto kernel = gru_cluster_fwd_kernel<8, 1>;
  *out = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (C > 8 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) != cudaSuccess) {
    cudaGetLastError();
    return cudaSuccess;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1);
  cfg.blockDim = dim3(kMaxThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cudaOccupancyMaxActiveClusters(out, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    *out = 0;
  }
  return cudaSuccess;
}

template <bool kChain>
int cluster_entry(const float* xp, const float* w_hh_t, const float* b_hh, const float* h0,
                  float* ys, int nb, int T, int B, int H, int C, int R, int S, int KL, int U,
                  cudaStream_t stream) {
  int smem = 0;
  cudaError_t err = max_smem(&smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_plan(nb, T, B, H, C, R, S, KL, U, smem)) return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0 || T == 0 || B == 0) return 0;
  err = S == 4
      ? cluster_launch_rows<4, kChain>(R, xp, w_hh_t, b_hh, h0, ys, nb, T, B, H, C, KL, U, stream)
      : cluster_launch_rows<8, kChain>(R, xp, w_hh_t, b_hh, h0, ys, nb, T, B, H, C, KL, U, stream);
  return static_cast<int>(err);
}

}  // namespace

// ys = K1's forward on a cluster plan (C, R, S, KL, U) from the wrapper;
// cudaErrorInvalidValue for a plan the kernel cannot launch.
extern "C" int gru_seq_cluster_fwd(const float* xp, const float* w_hh_t, const float* b_hh,
                                   const float* h0, float* ys, int nb, int T, int B, int H,
                                   int C, int R, int S, int KL, int U, cudaStream_t stream) {
  return cluster_entry<false>(xp, w_hh_t, b_hh, h0, ys, nb, T, B, H, C, R, S, KL, U, stream);
}

// The step-chain floor of the same plan: T steps of the exchange and the
// wait alone (ys is left as it was).
extern "C" int gru_seq_cluster_chain(const float* xp, const float* w_hh_t, const float* b_hh,
                                     const float* h0, float* ys, int nb, int T, int B, int H,
                                     int C, int R, int S, int KL, int U, cudaStream_t stream) {
  return cluster_entry<true>(xp, w_hh_t, b_hh, h0, ys, nb, T, B, H, C, R, S, KL, U, stream);
}

// The card's numbers the wrapper plans with: out = {SMs, shared bytes a
// block can take, shared bytes an SM, shared bytes the system reserves a
// block, clusters of 2, 4, 8 and 16 blocks resident at once with one block
// an SM}.
extern "C" int gru_seq_cluster_card(int* out) {
  int dev = 0, sms = 0, smem = 0, smem_sm = 0, reserved = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = max_smem(&smem);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  }
  int resident[4] = {0, 0, 0, 0};
  for (int i = 0; i < 4 && err == cudaSuccess; ++i) err = resident_clusters(2 << i, smem, &resident[i]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[8] = {sms, smem, smem_sm, reserved,
                       resident[0], resident[1], resident[2], resident[3]};
  std::copy(vals, vals + 8, out);
  return 0;
}

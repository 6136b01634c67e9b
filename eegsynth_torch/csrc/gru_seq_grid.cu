// GRU sequence kernel K1, wide forward on one cooperative grid, for Hopper,
// sm_90a: hidden widths past what a thread-block cluster holds (H 545 to
// 1024 on the H100), with a leading bucket axis.
//
// Replaces the TPU kernel eegsynth/nn/pallas_gru.py:_gru_seq_pallas at the
// widths neither gru_seq.cu nor gru_seq_cluster.cu takes; the wrapper
// (eegsynth_torch/nn/gru_sequence.py, grid_plan) takes this kernel above
// the cluster forward's cap. Same layouts and the same function:
//
//   xp (nb, T, B, 3H), w_hh_t (nb, H, 3H) = W_hh^T, b_hh (nb, 3H),
//   h0 (nb, B, H) -> ys (nb, T, B, H), f32, gates [r, z, n].
//
// What bounds it: T dependent steps. The Pallas kernel keeps the whole of
// W_hh^T in VMEM (12 MB at H 1024). No SM and no cluster of 16 SMs holds it
// (a cluster's shared memory stops at H 544); gru_seq_wide.cu's streaming
// forward reads all of it from L2 in every block every step (805 MB a step
// at (1, 768, 64, 1024) on 64 blocks: L2 bandwidth times T bounds it). The
// card's shared memory as a whole (132 x 227 KB) does hold it, hi and lo:
// block c of a bucket's G = ceil(H / 8) blocks owns units [8 c, 8 c + 8)
// and keeps the three gate columns of those units of W_hh^T, split into
// TF32 hi and lo, in its shared memory for all T steps (192 H bytes; 196 KB
// at H 1024, on 128 blocks). A step then costs a read of h_t from L2 (B
// H 4 bytes a block: 32 MB over the grid at B 64, H 1024), the block's
// product on the tensor cores and one exchange of h' between the G blocks
// through L2.
//
// Design.
//  - The launch is cooperative (cudaLaunchAttributeCooperative): every block
//    of it is resident at once, or the launch is refused and the wrapper
//    raises. It holds the buckets of one wave (grid G x buckets); the
//    wrapper launches the other waves after it.
//  - The exchange: h_t lies in a zeroed workspace (two buffers of B rows at
//    pitch Kp, H padded to 32, zeros past H; 16-byte aligned whatever
//    H is, which ys is not at odd H), h_0 copied in by each block for its
//    units before step 0. In step t a block writes h_{t+1} of its units into
//    the other buffer and into ys[t], then its thread 0 publishes with
//    st.release.gpu (after a __syncthreads and a gpu fence) the block's flag
//    = t + 2. A block starts step t when every flag of its bucket is at
//    least t + 1 (ld.acquire.gpu, one lane a flag, then a __syncthreads):
//    then all of h_t is in, and every block has finished step t - 1, so the
//    buffer step t writes is no longer read. h is never read through the
//    non-coherent path: cp.async.cg and ld.global.cg reach it in L2. A wait
//    that outlasts 2^34 clocks (seconds; a step takes microseconds) ends in
//    __trap(): a fault ends the launch with an error instead of a hang.
//  - The product: each step the block computes hp[rows, its 3U columns] =
//    h_t (64-row tiles of the batch; rows past B repeat row B - 1, their
//    results dropped) x its W slice with wgmma m64n24k8, A from
//    registers and B (the W slice) from shared memory, split-TF32 as the
//    flash kernels (tf32_wgmma.cuh): x = hi + lo, the products lo.hi, hi.lo
//    and hi.hi, float32 sums. h_t's depth streams from L2 into a ring of two
//    stages (64 rows x 64 deep, and at fewer rows proportionally deeper) by
//    cp.async.cg while the tensor cores work on the stage before (three or
//    four stages ran no faster on the H100); each thread's copies of a
//    stage are fixed for the tile, so a chunk costs one barrier and a few
//    copies. The depth is
//    permuted inside each 16-deep part so that a lane reads its A fragments
//    of a part's two k-slices as one float4 a row (W's rows are stored in
//    the same permuted order): k-slice 2 c + s, column j <-> depth 16 c +
//    4 (j % 4) + 2 s + j / 4. The block's two warpgroups take the two
//    k-slices of every part (no branch around a wgmma: ptxas would serialise
//    it), each keeping two groups of three wgmma (one part each) in flight
//    on two sets of fragment registers and of accumulators: three chains
//    (lo.hi, hi.lo, hi.hi) for each part parity, each chain summed in slice
//    order. A warpgroup's sum is hh + (lh + hl), the two sets added in
//    order; warpgroup 1's sums go through shared memory to warpgroup 0,
//    which adds them to its own. (One warpgroup taking both slices ran
//    markedly slower on the H100; four groups in flight ran no faster than
//    two: the tensor cores' rate on m64n24k8, not the wait for each
//    result, bounds the products.)
//  - The gates: column 8 j + 2 (lane % 4) + e % 2 of the accumulator is
//    gate j of unit 2 (lane % 4) + e % 2, so a lane of
//    warpgroup 0 holds all three gates of its (row, unit) pairs and forms
//    them in registers (gru_cell.cuh's sigmoid, the accurate tanhf), as
//    every K1 kernel does.
//  - The step-chain floor (gru_seq_grid_chain, a probe for chip_smoke.py
//    and nothing else): the same launch with the product and the gates left
//    out (h passed on unchanged, ys not written): T steps of the wait, the
//    read of h_t from L2 and the publication alone.
// The kernel allocates nothing and does not synchronise.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "grid.cuh"        // the grid's constants, flags, phys_k
#include "gru_cell.cuh"    // sigmoid_fwd
#include "tf32_wgmma.cuh"  // cp_async16, Wgmma, split, slice_desc, wgmma_*

namespace {

constexpr int kN = 3 * kUnits;  // a block's 8 units: N = 24 gate columns
constexpr int kSets = 2;        // parts in flight a warpgroup (fragments, chains)
constexpr int kChunk = 64;      // a stage holds 64 rows x 64 of h's depth (16 KB)
constexpr int kStages = 2;      // the ring of h chunks: one landing, one multiplied
constexpr int kStageFloats = kTileRows * kChunk;
constexpr int kCopies = kStageFloats / 4 / kGridThreads;  // 16-byte copies a thread a stage

size_t grid_smem(int H) {
  return sizeof(float) * (2 * (size_t)padded_depth(H) * kN + (size_t)kStages * kStageFloats);
}

// The workspace in int32 words: each bucket's flags, then each bucket's two
// buffers of h (B rows at pitch Kp).
size_t grid_workspace(int nb, int B, int H) {
  return (size_t)nb * flag_pitch(grid_blocks(H)) + (size_t)nb * 2 * B * padded_depth(H);
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Parts of 16 (even, at least 4) a stage holds at n rows, at most the
// depth's.
__device__ __forceinline__ int stage_parts(int n, int parts) {
  return min(parts, (kStageFloats / (kPart * n)) & ~1);
}

template <bool kChain>
__global__ void __launch_bounds__(kGridThreads, 1)
gru_grid_fwd_kernel(const float* __restrict__ xp, const float* __restrict__ w_hh_t,
                    const float* __restrict__ b_hh, const float* __restrict__ h0,
                    float* ys, int* flags, float* hx, int T, int B, int H, int Kp,
                    int FP) {
  constexpr int N = kN, NA = N / 2;
  extern __shared__ __align__(128) float grid_smem_f[];
  float* w_hi = grid_smem_f;  // (Kp / 4, N, 4): W's rows in the permuted depth
  float* w_lo = w_hi + (size_t)Kp * N;
  float* stages = w_lo + (size_t)Kp * N;  // kStages x (P parts, n rows, 16)

  const int G3 = 3 * H, G = gridDim.x, c = blockIdx.x;
  const size_t bucket = blockIdx.y;
  xp += bucket * T * B * G3;
  ys += bucket * T * B * H;
  w_hh_t += bucket * H * G3;
  b_hh += bucket * G3;
  h0 += bucket * B * H;
  flags += bucket * FP;
  hx += bucket * 2 * B * Kp;
  const int u0 = c * kUnits;
  const int tid = threadIdx.x, wg = tid / kWG, wtid = tid % kWG, lane = tid % 32;
  const int g = 16 * (wtid / 32) + lane / 4, q4 = lane % 4;

  // W_hh^T's slice of this block's units, hi and lo; zeros past H
#pragma unroll 4
  for (int i = tid; i < Kp * N; i += kGridThreads) {
    const int n = i % N, kl = i / N, unit = u0 + n % 8, k = phys_k(kl);
    const float v = k < H && unit < H ? w_hh_t[(size_t)k * G3 + (n / 8) * H + unit] : 0.f;
    uint32_t hi, lo;
    split(v, hi, lo);
    const int at = (kl / 4) * 4 * N + n * 4 + kl % 4;
    w_hi[at] = __uint_as_float(hi);
    w_lo[at] = __uint_as_float(lo);
  }
  for (int i = tid; i < kStages * kStageFloats; i += kGridThreads) stages[i] = 0.f;
  // h_0 of this block's units into buffer 0
  for (int i = tid; i < B * kUnits; i += kGridThreads) {
    const int r = i / kUnits, unit = u0 + i % kUnits;
    if (unit < H) hx[(size_t)r * Kp + unit] = h0[(size_t)r * H + unit];
  }
  float bias[3][2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int unit = u0 + 2 * q4 + e;
#pragma unroll
    for (int gate = 0; gate < 3; ++gate) bias[gate][e] = unit < H ? b_hh[gate * H + unit] : 0.f;
  }
  fence_proxy_async();  // W written by ordinary stores, read by wgmma
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    st_release(flags + c, 1);  // h_0 of these units is in
  }

  const int parts = Kp / kPart;  // even: Kp is a multiple of 32
  for (int t = 0; t < T; ++t) {
    const float* hc = hx + (size_t)(t & 1) * B * Kp;
    float* hn = hx + (size_t)((t + 1) & 1) * B * Kp;
    const float* xt = xp + (size_t)t * B * G3;
    float* yt = ys + (size_t)t * B * H;
    for (int m0 = 0; m0 < B; m0 += kTileRows) {
      const int n = min(kTileRows, B - m0);
      const int P = stage_parts(n, parts);  // parts of 16 a stage holds at n rows
      const int nch = (parts + P - 1) / P;
      // this lane's gate inputs (warpgroup 0 forms the gates): rows g, g + 8;
      // units 2 q4, 2 q4 + 1
      float xv[2][2][3], hold[2][2];
      if (wg == 0) {
#pragma unroll
        for (int er = 0; er < 2; ++er)
#pragma unroll
          for (int eu = 0; eu < 2; ++eu) {
            const int row = min(m0 + g + 8 * er, B - 1);
            const int unit = min(u0 + 2 * q4 + eu, H - 1);
            const float* xr = xt + (size_t)row * G3 + unit;
            xv[er][eu][0] = xr[0];
            xv[er][eu][1] = xr[H];
            xv[er][eu][2] = xr[2 * H];
            hold[er][eu] = __ldcg(hc + (size_t)row * Kp + unit);
          }
      }
      // this thread's copies of a chunk (a stage holds kStageFloats / 4 of 16
      // bytes): their part (P or more: none), offset in the stage and in h's
      // rows
      int cp_part[kCopies], cp_dst[kCopies], cp_src[kCopies];
#pragma unroll
      for (int j = 0; j < kCopies; ++j) {
        const int i = tid + j * kGridThreads, part = i / (n * 4), rem = i % (n * 4);
        cp_part[j] = part;
        cp_dst[j] = (part * n + rem / 4) * kPart + 4 * (rem % 4);
        cp_src[j] = (rem / 4) * Kp + part * kPart + 4 * (rem % 4);
      }
      if (m0 == 0) {  // every block has published h_t
        for (int i = tid; i < G; i += kGridThreads) {
          const long long start = clock64();
          while (ld_acquire(flags + i) < t + 1) {
            if (clock64() - start > kSpinClocks) __trap();
          }
        }
      }
      __syncthreads();  // the flags seen; every lane done with the stages

      const float* src0 = hc + (size_t)m0 * Kp;
      auto issue = [&](int ch) {  // parts [ch P, ch P + P) of the tile's rows into a stage
        if (ch < nch) {
          float* st = stages + (ch % kStages) * kStageFloats;
          const int np = min(P, parts - ch * P);
          const float* src = src0 + ch * P * kPart;
#pragma unroll
          for (int j = 0; j < kCopies; ++j) {
            if (cp_part[j] < np) cp_async16(st + cp_dst[j], src + cp_src[j], 16);
          }
        }
        cp_async_commit();
      };
      issue(0);

      // warpgroup wg takes k-slice 2 pp + wg of every part pp; set pp % 2 of
      // its chains (lo.hi, hi.lo, hi.hi), each summed in slice order
      float lh[kSets][NA], hl[kSets][NA], hh[kSets][NA];
#pragma unroll
      for (int k = 0; k < kSets; ++k) {
        zero(lh[k]);
        zero(hl[k]);
        zero(hh[k]);
      }
      const int ra = min(g, n - 1), rb = min(g + 8, n - 1);  // rows past n repeat row n - 1
      // this warpgroup's A fragment of a part, from the stage, split
      auto load_part = [&](const float* st, uint32_t (&f)[2][4]) {
        const float4 v = *reinterpret_cast<const float4*>(st + ra * kPart + 4 * q4);
        const float4 w = *reinterpret_cast<const float4*>(st + rb * kPart + 4 * q4);
        const bool odd = wg != 0;
        split(odd ? v.z : v.x, f[0][0], f[1][0]);
        split(odd ? w.z : w.x, f[0][1], f[1][1]);
        split(odd ? v.w : v.y, f[0][2], f[1][2]);
        split(odd ? w.w : w.y, f[0][3], f[1][3]);
      };
      // ... and its three products on the tensor cores (descriptors advance
      // 2 N 16-byte units a k-slice)
      const uint64_t dh0 = slice_desc<N>(w_hi, wg), dl0 = slice_desc<N>(w_lo, wg);
      uint32_t f[kSets][2][4];  // [set][hi, lo][fragment]
      const float* st = stages;
      for (int pp = 0, ch = 0, at = 0; pp < parts; pp += kSets) {  // at: pp's place in its chunk
        if (at == 0) {  // P is even: a chunk starts at an even part
          cp_async_wait<0>();
          __syncthreads();  // chunk ch has landed; the stage before it is free
          issue(ch + 1);
          st = stages + (ch % kStages) * kStageFloats;
        }
        if constexpr (!kChain) {
#pragma unroll
          for (int k = 0; k < kSets; ++k) {  // part pp + k, of set k
            load_part(st + (at + k) * n * kPart, f[k]);
            wgmma_fence();
            const uint64_t step = static_cast<uint64_t>(4 * N * (pp + k));
            Wgmma<N>::rs(lh[k], f[k][1], dh0 + step);
            Wgmma<N>::rs(hl[k], f[k][0], dl0 + step);
            Wgmma<N>::rs(hh[k], f[k][0], dh0 + step);
            wgmma_commit();
            wgmma_wait<kSets - 1>();  // the part before this one is done: its set is free
          }
        }
        at += kSets;
        if (at == P) {
          at = 0;
          ++ch;
        }
      }

      // a: warpgroup 0's sums plus warpgroup 1's, each sum hh + (lh + hl) of
      // its chains (the two sets added in order)
      float a[2][2][3];
      if constexpr (!kChain) {
        wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int gate = 0; gate < 3; ++gate) {
            const int i = 4 * gate + e;
            float sh = hh[0][i], sl = lh[0][i], sm = hl[0][i];
#pragma unroll
            for (int k = 1; k < kSets; ++k) {
              sh += hh[k][i];
              sl += lh[k][i];
              sm += hl[k][i];
            }
            a[e / 2][e % 2][gate] = sh + (sl + sm);
          }
        constexpr int kSums = 12;
        float* sums = stages;  // free once the last chunk is in registers
        cp_async_wait<0>();
        __syncthreads();
        float* v = &a[0][0][0];
        if (wg == 1) {
#pragma unroll
          for (int i = 0; i < kSums; ++i) sums[i * kWG + wtid] = v[i];
        }
        __syncthreads();
        if (wg == 0) {
#pragma unroll
          for (int i = 0; i < kSums; ++i) v[i] += sums[i * kWG + wtid];
        }
      }

      if (wg == 0) {
#pragma unroll
        for (int er = 0; er < 2; ++er)
#pragma unroll
          for (int eu = 0; eu < 2; ++eu) {
            const int r = g + 8 * er, unit = u0 + 2 * q4 + eu;
            if (r >= n || unit >= H) continue;
            const int row = m0 + r;
            float hv = hold[er][eu];
            if constexpr (!kChain) {
              const float* x = xv[er][eu];
              const float* av = a[er][eu];
              const float rg = sigmoid_fwd(x[0] + (av[0] + bias[0][eu]));
              const float zg = sigmoid_fwd(x[1] + (av[1] + bias[1][eu]));
              const float ng = tanhf(x[2] + rg * (av[2] + bias[2][eu]));
              hv = (1.0f - zg) * ng + zg * hv;
              yt[(size_t)row * H + unit] = hv;
            }
            hn[(size_t)row * Kp + unit] = hv;
          }
      }
    }
    __syncthreads();  // every lane's h_{t+1} written
    if (tid == 0) {
      __threadfence();
      st_release(flags + c, t + 2);
    }
  }
}

bool bad_plan(int nb, int T, int B, int H, int b_first, int nbw, int max_smem) {
  if (nb < 0 || T < 0 || B < 0 || H < 1 || H > kMaxHidden) return true;
  if (nbw < 1 || nbw > 65535 || b_first < 0 || b_first + nbw > std::max(nb, 1)) return true;
  return grid_smem(H) > static_cast<size_t>(max_smem);
}

template <bool kChain>
int grid_entry(const float* xp, const float* w_hh_t, const float* b_hh, const float* h0,
               float* ys, int* ws, int nb, int T, int B, int H, int b_first, int nbw,
               cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_plan(nb, T, B, H, b_first, nbw, max_smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb == 0 || T == 0 || B == 0) return 0;
  const auto kernel = gru_grid_fwd_kernel<kChain>;
  const size_t smem = grid_smem(H);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = grid_blocks(H), FP = flag_pitch(G), Kp = padded_depth(H);
  const size_t f = b_first;
  int* flags = ws + f * FP;
  float* hx = reinterpret_cast<float*>(ws + (size_t)nb * FP) + f * 2 * B * Kp;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G, nbw);
  cfg.blockDim = dim3(kGridThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, xp + f * T * B * 3 * H, w_hh_t + f * H * 3 * H,
                           b_hh + f * 3 * H, h0 + f * B * H, ys + f * T * B * H, flags, hx,
                           T, B, H, Kp, FP);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// ys = K1's forward for buckets [b_first, b_first + nbw) of nb, one wave of
// a grid plan from the wrapper; ws is the zeroed int32 workspace of
// gru_seq_grid_workspace words for all nb buckets.
// cudaErrorInvalidValue for a plan the kernel does not take,
// cudaErrorCooperativeLaunchTooLarge for one the card cannot hold resident.
extern "C" int gru_seq_grid_fwd(const float* xp, const float* w_hh_t, const float* b_hh,
                                const float* h0, float* ys, int* ws, int nb, int T, int B,
                                int H, int b_first, int nbw, cudaStream_t stream) {
  return grid_entry<false>(xp, w_hh_t, b_hh, h0, ys, ws, nb, T, B, H, b_first, nbw, stream);
}

// The step-chain floor of the same plan: T steps of the wait, the read of
// h_t and the publication alone (ys is left as it was; the workspace is
// written).
extern "C" int gru_seq_grid_chain(const float* xp, const float* w_hh_t, const float* b_hh,
                                  const float* h0, float* ys, int* ws, int nb, int T, int B,
                                  int H, int b_first, int nbw, cudaStream_t stream) {
  return grid_entry<true>(xp, w_hh_t, b_hh, h0, ys, ws, nb, T, B, H, b_first, nbw, stream);
}

// int32 words of the workspace of a call at (nb, B, H).
extern "C" long long gru_seq_grid_workspace(int nb, int B, int H) {
  if (nb < 0 || B < 0 || H < 1) return -1;
  return static_cast<long long>(grid_workspace(nb, B, H));
}

// The card's numbers the wrapper plans with: out = {cooperative launches
// supported (0 or 1), blocks of the kernel resident on an SM at no dynamic
// shared memory (its registers' and threads' limit; the shared bytes' own
// limit the wrapper applies)}.
extern "C" int gru_seq_grid_card(int* out) {
  int dev = 0, coop = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gru_grid_fwd_kernel<false>,
                                                        kGridThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = coop;
  out[1] = blocks;
  return 0;
}

// GRU sequence kernel K1, wide forward past the grid's H 1024 on one
// cooperative grid, for Hopper, sm_90a, with a leading bucket axis.
//
// Replaces the TPU kernel eegsynth/nn/pallas_gru.py:_gru_seq_pallas at the
// widths past gru_seq_grid.cu's (H 1025 up to the wide route's cap, 9685 on
// the H100); the wrapper (eegsynth_torch/nn/gru_sequence.py,
// grid_stream_plan) takes this kernel there. Same layouts and the same
// function:
//
//   xp (nb, T, B, 3H), w_hh_t (nb, H, 3H) = W_hh^T, b_hh (nb, 3H),
//   h0 (nb, B, H) -> ys (nb, T, B, H), f32, gates [r, z, n].
//
// What bounds it: T dependent steps, each a product h_t W_hh^T. The Pallas
// kernel keeps all of W_hh^T in VMEM. Past H 1024 no arrangement of the
// card's shared memory does: W_hh^T in split TF32 (hi and lo) is 24 H^2
// bytes, 56.6 MB at H 1536, against 132 x 227 KB = 30 MB. gru_seq_wide.cu's
// streaming forward reads all of W_hh^T in every block (one a batch row)
// every step: 64 x 28.3 MB = 1.81 GB a step at (1, 768, 64, 1536). Here the
// grid as a whole reads W once a step: block c of a bucket's G blocks owns
// U = 8 J units (its 3U gate columns of W_hh^T, J groups of 8 units), keeps
// the first Dr rows of its slice's depth in shared memory for all T steps
// and streams the rest of the depth every step, beside h_t. A step then
// moves (Kp - Dr) 24 J 4 bytes of W and B Kp 4 bytes of h_t a block from
// L2 (at H 1536 on 96 blocks of J 2: 442 KB and 393 KB), the block's
// product on the tensor cores and one exchange of h' between the G blocks
// through L2, as gru_seq_grid.cu's.
//
// Design.
//  - The plan (the wrapper's grid_stream_plan, checked here): the fewest
//    groups J (1 to kMaxGroups) for which a bucket's G = ceil(H / 8 J) blocks
//    are resident at once, one block an SM; Dr the most rows (a multiple of
//    32) that fit the block's shared memory beside the ring. The launch is
//    cooperative (cudaLaunchAttributeCooperative): every block is resident
//    at once, or the launch is refused and the wrapper raises. It holds the
//    buckets of one wave (grid G x buckets); the wrapper launches the other
//    waves after it.
//  - W in the form wgmma reads: a prep kernel (gru_stream_prep, launched by
//    the same entry before each wave) writes each block's slice of W_hh^T
//    into the workspace, split into TF32 hi and lo, in the layout the block
//    keeps in shared memory: (Kp / 4, 24 J, 4) floats, hi then lo, the depth
//    permuted inside each 16-deep part as gru_seq_grid.cu's (grid.cuh
//    phys_k), column 24 j + 8 gate + i holding unit 8 J c + 8 j + i of that
//    gate, zeros past H. The resident rows and each streamed chunk are then
//    plain 16-byte copies.
//  - The exchange, as gru_seq_grid.cu's: h_t lies in a zeroed workspace (two
//    buffers of B rows at pitch Kp, H padded to 32, zeros past H); a block
//    writes h_{t+1} of its units into the other buffer and into ys[t], then
//    thread 0 publishes with st.release.gpu (after a __syncthreads and a gpu
//    fence) the block's flag = t + 2; a block starts step t when every flag
//    of its bucket is at least t + 1 (ld.acquire.gpu). A wait that outlasts
//    2^34 clocks ends in __trap().
//  - The ring: the depth goes in chunks of 32 (two 16-deep parts), each
//    chunk a stage of kStages (4 up to J 8, else 3) holding the tile's rows
//    of h_t at those depths and, past Dr, the chunk's W rows hi and lo,
//    copied by cp.async.cg while the tensor cores work on an earlier stage:
//    kStages - 2 chunks in flight. The stage refilled at chunk ch is chunk
//    ch - 2's, whose wgmma every thread has waited for (wgmma.wait_group 1
//    after each part: only the part before is left in flight), so the
//    tensor cores never drain at a chunk's end.
//  - The product: hp[rows, the block's N = 24 J columns] = h_t (64-row
//    tiles of the batch; rows past B repeat row B - 1, their results
//    dropped) x the block's W slice, one wgmma m64nNk8 a k-slice
//    (wgmma_rs_wide.cuh), A from registers (h split in registers, x = hi +
//    lo), B from shared memory; split-TF32 as gru_seq_grid.cu's: lo.hi,
//    hi.lo and hi.hi, in that order, into one float32 accumulator. The
//    block's two warpgroups take the two k-slices of every part (slice 2 p
//    + wg); warpgroup 1's sums go through shared memory to warpgroup 0,
//    which adds them to its own.
//  - The gates: accumulator element 12 j + 4 gate + 2 er + eu (wgmma's
//    column 24 j + 8 gate + 2 (lane % 4) + eu, row g + 8 er) is gate `gate`
//    of unit 8 J c + 8 j + 2 (lane % 4) + eu, row g + 8 er: each group of 24
//    columns maps as gru_seq_grid.cu's one group of 8 units, so a lane of
//    warpgroup 0 holds all three gates of its (row, unit) pairs and forms
//    them in registers (gru_cell.cuh's sigmoid, the accurate tanhf).
//  - The step-chain floor (gru_seq_grid_stream_chain, a probe for
//    chip_smoke.py and nothing else): the same launch with the prep, the
//    product and the gates left out (h passed on unchanged, ys not
//    written): T steps of the wait, the copies of h_t and of W's streamed
//    rows from L2 and the publication alone.
// The kernels allocate nothing and do not synchronise.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "grid.cuh"        // the grid's constants, flags, phys_k
#include "gru_cell.cuh"    // sigmoid_fwd
#include "tf32_wgmma.cuh"  // cp_async16, Wgmma<24>, split, desc, wgmma_*
#include "wgmma_rs_wide.cuh"  // Wgmma<48> .. Wgmma<240>

namespace {

constexpr int kGroupN = 3 * kUnits;  // a group of 8 units: 24 gate columns, one wgmma n24
constexpr int kMaxGroups = 10;       // U up to 80 units: H 9685 on 132 blocks
constexpr int kChunkK = 32;          // depth of a chunk: two 16-deep parts
constexpr int kHFloats = kTileRows * kChunkK;  // a stage's h: 64 rows x 32 (8 KB)

// Stages of the ring at J groups: four where they fit a block, else three.
__host__ __device__ constexpr int stream_stages(int J) { return J <= 8 ? 4 : 3; }

__host__ __device__ constexpr int stage_floats(int J) {
  return kHFloats + 2 * kChunkK * kGroupN * J;
}

size_t stream_smem(int J, int Dr) {
  return sizeof(float) * (2 * (size_t)Dr * kGroupN * J +
                          (size_t)stream_stages(J) * stage_floats(J));
}

int stream_blocks(int H, int J) { return (H + kUnits * J - 1) / (kUnits * J); }

// The workspace in int32 words: each bucket's flags, each bucket's two
// buffers of h (B rows at pitch Kp), then each bucket's blocks' W slices (hi
// and lo, Kp x 24 J each).
size_t stream_workspace(int nb, int B, int H, int J) {
  const size_t Kp = padded_depth(H), G = stream_blocks(H, J);
  return (size_t)nb * flag_pitch((int)G) + (size_t)nb * 2 * B * Kp +
         (size_t)nb * G * 2 * Kp * kGroupN * J;
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Each block's slice of W_hh^T for buckets [0, nbw) in the kernel's layout:
// element at = (kl / 4) (24 J) 4 + n 4 + kl % 4 of the slice (hi; lo Kp 24 J
// floats after it) is W_hh^T[phys_k(kl), gate H + unit], n = 24 j + 8 gate +
// i, unit = 8 J c + 8 j + i; zeros past H. Threads walk the output in order.
__global__ void gru_stream_prep(const float* __restrict__ w_hh_t, float* __restrict__ wp,
                                int H, int Kp, int G, int J, int nbw) {
  const int NB = kGroupN * J;
  const size_t slice = (size_t)Kp * NB, total = (size_t)nbw * G * slice;
  const size_t G3 = 3 * (size_t)H;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t blk = i / slice;  // bucket * G + c
    const int at = (int)(i % slice);
    const int kr = at % 4, n = (at / 4) % NB, kq = at / (4 * NB);
    const int b = (int)(blk / G), c = (int)(blk % G);
    const int kl = 4 * kq + kr, k = phys_k(kl);
    const int j = n / kGroupN, gate = (n % kGroupN) / kUnits;
    const int unit = c * kUnits * J + j * kUnits + n % kUnits;
    const float v = k < H && unit < H ? w_hh_t[b * H * G3 + k * G3 + gate * H + unit] : 0.f;
    uint32_t hi, lo;
    split(v, hi, lo);
    float* out = wp + blk * 2 * slice + at;
    out[0] = __uint_as_float(hi);
    out[slice] = __uint_as_float(lo);
  }
}

template <int J, bool kChain>
__global__ void __launch_bounds__(kGridThreads, 1)
gru_grid_stream_kernel(const float* __restrict__ xp, const float* __restrict__ wp,
                       const float* __restrict__ b_hh, const float* __restrict__ h0,
                       float* ys, int* flags, float* hx, int T, int B, int H, int Kp, int FP,
                       int Dr) {
  constexpr int NB = kGroupN * J, S = stream_stages(J), SF = stage_floats(J);
  constexpr int kAhead = S - 2;  // chunks in flight while one is multiplied
  extern __shared__ __align__(128) float stream_smem_f[];
  float* r_hi = stream_smem_f;          // (Dr / 4, NB, 4): W's resident rows
  float* r_lo = r_hi + (size_t)Dr * NB;
  float* ring = r_lo + (size_t)Dr * NB;  // S x [h (2 parts, n rows, 16) | W hi | W lo]

  const int G3 = 3 * H, G = gridDim.x, c = blockIdx.x;
  const size_t bucket = blockIdx.y;
  const size_t slice = (size_t)Kp * NB;
  xp += bucket * T * B * G3;
  ys += bucket * T * B * H;
  wp += (bucket * G + c) * 2 * slice;
  b_hh += bucket * G3;
  h0 += bucket * B * H;
  flags += bucket * FP;
  hx += bucket * 2 * B * Kp;
  const int u0 = c * kUnits * J;
  const int tid = threadIdx.x, wg = tid / kWG, wtid = tid % kWG, lane = tid % 32;
  const int g = 16 * (wtid / 32) + lane / 4, q4 = lane % 4;

  // W's resident rows: the first Dr of the slice's depth, hi and lo
  for (int i = tid; i < Dr * NB / 4; i += kGridThreads) {
    reinterpret_cast<float4*>(r_hi)[i] = reinterpret_cast<const float4*>(wp)[i];
    reinterpret_cast<float4*>(r_lo)[i] = reinterpret_cast<const float4*>(wp + slice)[i];
  }
  for (int i = tid; i < S * SF; i += kGridThreads) ring[i] = 0.f;
  // h_0 of this block's units into buffer 0
  for (int i = tid; i < B * kUnits * J; i += kGridThreads) {
    const int r = i / (kUnits * J), unit = u0 + i % (kUnits * J);
    if (unit < H) hx[(size_t)r * Kp + unit] = h0[(size_t)r * H + unit];
  }
  fence_proxy_async();  // W written by ordinary stores, read by wgmma
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    st_release(flags + c, 1);  // h_0 of these units is in
  }

  const int nch = Kp / kChunkK, rch = Dr / kChunkK;  // chunks; the first rch resident
  for (int t = 0; t < T; ++t) {
    const float* hc = hx + (size_t)(t & 1) * B * Kp;
    float* hn = hx + (size_t)((t + 1) & 1) * B * Kp;
    const float* xt = xp + (size_t)t * B * G3;
    float* yt = ys + (size_t)t * B * H;
    for (int m0 = 0; m0 < B; m0 += kTileRows) {
      const int n = min(kTileRows, B - m0);
      if (m0 == 0) {  // every block has published h_t
        for (int i = tid; i < G; i += kGridThreads) {
          const long long start = clock64();
          while (ld_acquire(flags + i) < t + 1) {
            if (clock64() - start > kSpinClocks) __trap();
          }
        }
      }
      __syncthreads();  // the flags seen; every lane done with the ring

      const float* src0 = hc + (size_t)m0 * Kp;
      // chunk ch into stage ch % S: h's rows [m0, m0 + n) at depths
      // [32 ch, 32 ch + 32) as (2 parts, n rows, 16); past the resident rows
      // W's 32 rows of the chunk, hi then lo
      auto issue = [&](int ch) {
        if (ch < nch) {
          float* st = ring + (ch % S) * SF;
          const float* src = src0 + ch * kChunkK;
          for (int i = tid; i < n * 8; i += kGridThreads) {
            const int part = i / (n * 4), rem = i % (n * 4);
            cp_async16(st + (part * n + rem / 4) * kPart + 4 * (rem % 4),
                       src + (size_t)(rem / 4) * Kp + part * kPart + 4 * (rem % 4), 16);
          }
          if (ch >= rch) {
            const float* w = wp + (size_t)ch * kChunkK * NB;
            float* sw = st + kHFloats;
            constexpr int kW = kChunkK * NB / 4;  // 16-byte copies of hi (and of lo)
            for (int i = tid; i < 2 * kW; i += kGridThreads) {
              const int lo = i >= kW, q = i - lo * kW;
              cp_async16(sw + lo * kChunkK * NB + 4 * q, w + lo * slice + 4 * q, 16);
            }
          }
        }
        cp_async_commit();
      };
#pragma unroll
      for (int s = 0; s < kAhead; ++s) issue(s);

      float acc[12 * J];  // element 12 j + i: group j's element i
      zero(acc);
      const int ra = min(g, n - 1), rb = min(g + 8, n - 1);  // rows past n repeat row n - 1
      // this warpgroup's A fragment of a part (k-slice 2 p + wg), split
      auto load_part = [&](const float* st, uint32_t (&f)[2][4]) {
        const float4 v = *reinterpret_cast<const float4*>(st + ra * kPart + 4 * q4);
        const float4 w = *reinterpret_cast<const float4*>(st + rb * kPart + 4 * q4);
        const bool odd = wg != 0;
        split(odd ? v.z : v.x, f[0][0], f[1][0]);
        split(odd ? w.z : w.x, f[0][1], f[1][1]);
        split(odd ? v.w : v.y, f[0][2], f[1][2]);
        split(odd ? w.w : w.y, f[0][3], f[1][3]);
      };
      uint32_t f[2][2][4];  // [part][hi, lo][fragment]
      for (int ch = 0; ch < nch; ++ch) {
        cp_async_wait<kAhead - 1>();
        fence_proxy_async();  // the chunk's W, copied in, read by wgmma
        __syncthreads();      // chunk ch has landed; every thread done with the stage refilled
        issue(ch + kAhead);   // into the stage of chunk ch - 2
        if constexpr (!kChain) {
          const float* st = ring + (ch % S) * SF;
          const bool res = ch < rch;
          const float* wh = res ? r_hi + (size_t)ch * kChunkK * NB : st + kHFloats;
          const float* wl = res ? r_lo + (size_t)ch * kChunkK * NB : st + kHFloats + kChunkK * NB;
#pragma unroll
          for (int k = 0; k < 2; ++k) {  // part k of the chunk: k-slice 2 k + wg
            load_part(st + k * n * kPart, f[k]);
            wgmma_fence();
            const int off = (2 * k + wg) * 8 * NB;
            const uint64_t dh = desc(wh + off, 16 * NB, 128);
            const uint64_t dl = desc(wl + off, 16 * NB, 128);
            Wgmma<NB>::rs(acc, f[k][1], dh);
            Wgmma<NB>::rs(acc, f[k][0], dl);
            Wgmma<NB>::rs(acc, f[k][0], dh);
            wgmma_commit();
            wgmma_wait<1>();  // the part before is done: its fragments are free
          }
        }
      }
      if constexpr (!kChain) wgmma_wait<0>();
      cp_async_wait<0>();
      __syncthreads();  // every copy landed (the last groups are empty); the ring is free

      if constexpr (!kChain) {  // warpgroup 0's sums plus warpgroup 1's
        float* sums = ring;
        if (wg == 1) {
#pragma unroll
          for (int i = 0; i < 12 * J; ++i) sums[i * kWG + wtid] = acc[i];
        }
        __syncthreads();
        if (wg == 0) {
#pragma unroll
          for (int i = 0; i < 12 * J; ++i) acc[i] += sums[i * kWG + wtid];
        }
      }

      if (wg == 0) {
#pragma unroll
        for (int j = 0; j < J; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = g + 8 * (e / 2), unit = u0 + kUnits * j + 2 * q4 + e % 2;
            if (r >= n || unit >= H) continue;
            const int row = m0 + r;
            float hv = __ldcg(hc + (size_t)row * Kp + unit);
            if constexpr (!kChain) {
              const float* x = xt + (size_t)row * G3 + unit;
              const float br = __ldg(b_hh + unit), bz = __ldg(b_hh + H + unit);
              const float bn = __ldg(b_hh + 2 * H + unit);
              const float* a = acc + 12 * j;
              const float rg = sigmoid_fwd(x[0] + (a[e] + br));
              const float zg = sigmoid_fwd(x[H] + (a[4 + e] + bz));
              const float ng = tanhf(x[2 * H] + rg * (a[8 + e] + bn));
              hv = (1.0f - zg) * ng + zg * hv;
              yt[(size_t)row * H + unit] = hv;
            }
            hn[(size_t)row * Kp + unit] = hv;
          }
      }
      __syncthreads();  // warpgroup 0 done with the sums before the next tile's copies
    }
    if (tid == 0) {  // every lane's h_{t+1} written (the barrier above)
      __threadfence();
      st_release(flags + c, t + 2);
    }
  }
}

template <bool kChain>
using StreamKernel = void (*)(const float*, const float*, const float*, const float*, float*,
                              int*, float*, int, int, int, int, int, int);

template <bool kChain>
StreamKernel<kChain> stream_kernel(int J) {
  switch (J) {
    case 1: return gru_grid_stream_kernel<1, kChain>;
    case 2: return gru_grid_stream_kernel<2, kChain>;
    case 3: return gru_grid_stream_kernel<3, kChain>;
    case 4: return gru_grid_stream_kernel<4, kChain>;
    case 5: return gru_grid_stream_kernel<5, kChain>;
    case 6: return gru_grid_stream_kernel<6, kChain>;
    case 7: return gru_grid_stream_kernel<7, kChain>;
    case 8: return gru_grid_stream_kernel<8, kChain>;
    case 9: return gru_grid_stream_kernel<9, kChain>;
    case 10: return gru_grid_stream_kernel<10, kChain>;
    default: return nullptr;
  }
}
static_assert(kMaxGroups == 10, "stream_kernel instantiates J = 1 .. 10");

bool bad_plan(int nb, int T, int B, int H, int b_first, int nbw, int J, int Dr,
              int max_smem) {
  if (nb < 0 || T < 0 || B < 0 || H < 1 || J < 1 || J > kMaxGroups) return true;
  if (nbw < 1 || nbw > 65535 || b_first < 0 || b_first + nbw > std::max(nb, 1)) return true;
  if (Dr < 0 || Dr % kChunkK != 0 || Dr > padded_depth(H)) return true;
  return stream_smem(J, Dr) > static_cast<size_t>(max_smem);
}

template <bool kChain>
int stream_entry(const float* xp, const float* w_hh_t, const float* b_hh, const float* h0,
                 float* ys, int* ws, int nb, int T, int B, int H, int b_first, int nbw, int J,
                 int Dr, cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_plan(nb, T, B, H, b_first, nbw, J, Dr, max_smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb == 0 || T == 0 || B == 0) return 0;
  const auto kernel = stream_kernel<kChain>(J);
  const size_t smem = stream_smem(J, Dr);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = stream_blocks(H, J), FP = flag_pitch(G), Kp = padded_depth(H);
  const size_t f = b_first, slice2 = (size_t)2 * Kp * kGroupN * J;
  int* flags = ws + f * FP;
  float* hx = reinterpret_cast<float*>(ws + (size_t)nb * FP);
  float* wp = hx + (size_t)nb * 2 * B * Kp + f * G * slice2;
  hx += f * 2 * B * Kp;
  if (!kChain) {
    const size_t total = (size_t)nbw * G * slice2 / 2;
    const int blocks = (int)std::min<size_t>((total + 255) / 256, 132 * 16);
    gru_stream_prep<<<blocks, 256, 0, stream>>>(w_hh_t + f * H * 3 * H, wp, H, Kp, G, J, nbw);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
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
  err = cudaLaunchKernelEx(&cfg, kernel, xp + f * T * B * 3 * H, static_cast<const float*>(wp),
                           b_hh + f * 3 * H, h0 + f * B * H, ys + f * T * B * H, flags, hx, T,
                           B, H, Kp, FP, Dr);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// ys = K1's forward for buckets [b_first, b_first + nbw) of nb, one wave of
// a grid_stream_plan from the wrapper (J groups of 8 units a block, Dr
// resident rows of W's depth); ws is the zeroed int32 workspace of
// gru_seq_grid_stream_workspace words for all nb buckets at J.
// cudaErrorInvalidValue for a plan the kernel does not take,
// cudaErrorCooperativeLaunchTooLarge for one the card cannot hold resident.
extern "C" int gru_seq_grid_stream_fwd(const float* xp, const float* w_hh_t, const float* b_hh,
                                       const float* h0, float* ys, int* ws, int nb, int T,
                                       int B, int H, int b_first, int nbw, int J, int Dr,
                                       cudaStream_t stream) {
  return stream_entry<false>(xp, w_hh_t, b_hh, h0, ys, ws, nb, T, B, H, b_first, nbw, J, Dr,
                             stream);
}

// The step-chain floor of the same plan: T steps of the wait, the copies of
// h_t and of W's streamed rows and the publication alone (no prep; ys is
// left as it was; the workspace is written).
extern "C" int gru_seq_grid_stream_chain(const float* xp, const float* w_hh_t,
                                         const float* b_hh, const float* h0, float* ys, int* ws,
                                         int nb, int T, int B, int H, int b_first, int nbw,
                                         int J, int Dr, cudaStream_t stream) {
  return stream_entry<true>(xp, w_hh_t, b_hh, h0, ys, ws, nb, T, B, H, b_first, nbw, J, Dr,
                            stream);
}

// int32 words of the workspace of a call at (nb, B, H) and J groups.
extern "C" long long gru_seq_grid_stream_workspace(int nb, int B, int H, int J) {
  if (nb < 0 || B < 0 || H < 1 || J < 1 || J > kMaxGroups) return -1;
  return static_cast<long long>(stream_workspace(nb, B, H, J));
}

// The card's numbers the wrapper plans with: out = {cooperative launches
// supported (0 or 1), the fewest blocks of any instance (J 1 to 10)
// resident on an SM at no dynamic shared memory (its registers' and
// threads' limit; the shared bytes' own limit the wrapper applies)}.
extern "C" int gru_seq_grid_stream_card(int* out) {
  int dev = 0, coop = 0, fewest = 1 << 30;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  for (int J = 1; J <= kMaxGroups && err == cudaSuccess; ++J) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, stream_kernel<false>(J),
                                                        kGridThreads, 0);
    fewest = std::min(fewest, blocks);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = coop;
  out[1] = fewest;
  return 0;
}

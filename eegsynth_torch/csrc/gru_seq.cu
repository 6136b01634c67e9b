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
// serving width), then the gates. Reading xp and writing ys is the only HBM
// traffic, spread evenly over the run, and the arithmetic is a few MFLOP a
// step, so neither bandwidth nor FLOP/s bounds it: one step's latency,
// times T, does. clock64() timers on an H100 (PERF.md) put a step at
// the serving shape at about 1,100 cycles: a third the gates, a quarter
// the sums, a third the copies, the wait and the barrier. At the training
// shape (9 rows a block, 7 warps on the SM's 4 schedulers) a step takes
// about 3,500 cycles, most of it issuing the sums and the gates of its
// three groups of rows.
//
// Batch rows and buckets are independent, so the grid runs over (tile of
// `rows` batch rows, bucket) and each block walks all T steps in a loop; no
// block ever waits on another. rows = ceil(nb B / #SMs) gives one tile per
// SM: B = 256, nb = 1 (serving) is 2 rows x 128 blocks; B = 63, nb = 18
// (training) is 9 rows x 7 tiles x 18 buckets = 126 blocks.
//
// Forward: weights stationary, the dot product split across lanes.
//  - Thread (j, s), s < S, holds the KL-long k-slice s of W_hh^T's columns
//    j, H + j and 2H + j in 3 KL registers, loaded once before the time loop
//    (zeros at k >= H, and at j >= H for the threads that pad the block to
//    whole warps). KL is 16 up to H 64, 32 up to H 96 and 64 up to H 128;
//    S, the power of two at or above ceil(H / KL), is at most 4, and the S
//    lanes of one j are neighbours in one warp. The block has H S threads
//    rounded up to a warp: 224 at H 56.
//  - Registers: each instance (KL, S, largest H) has its largest block as
//    its launch bound, so a thread may hold 65,536 / bound registers. KL 16:
//    48 weights under 255; KL 32 to H 96: 96 weights under 170 (384
//    threads); KL 64 to H 128: 192 weights under 255 (256 threads). KL 32
//    at H 128 would need 512 threads and leave 128 registers, and spilled.
//    ptxas must report no spills for any instance (chip_smoke.py checks).
//  - h lies in shared memory, double-buffered, in slices of KL values at a
//    pitch of KL + 4 floats (so the S slices a quarter warp reads lie in
//    distinct banks), zeros past H: a thread reads its slice of a row as
//    float4s with no bound check.
//  - Each thread serves every row of its block, a group of RG rows at a time
//    (RG = 4 at KL 16, 2 at KL 32, 1 at KL 64; the ragged tail takes a
//    group of RG / 2 where that covers it). For each row of a group it sums
//    its slice into three accumulators, a fully unrolled chain of KL
//    multiply-adds each, so 3 RG chains run side by side. Registers do not
//    grow with rows, so rows needs no register cap; shared memory is its
//    only cap. (One group of all of a step's rows was slower: its rows did
//    not spread over the lanes, so the gates ran deeper on fewer lanes.)
//  - The S partial sums are added with __shfl_xor_sync, log2 S rounds that
//    also scatter the group's rows over the lanes (lane s ends up with row
//    s of a 4-row group). Every row is summed in the same order: slices k
//    and k + S/2 first, then their sums at distance S/4, and so on
//    (tests/test_torch_gru.py emulates it).
//  - The lane holding a row's sums computes its gates, writes h' to the
//    next h buffer and to ys: one barrier a step. The transcendentals are
//    spread over the lanes.
//  - xp arrives through a ring of kRing steps in shared memory, filled by
//    cp.async kRing - 1 steps ahead: a block's rows of one step are rows x 3H
//    contiguous floats, copied 16 bytes at a time where 3H % 4 == 0 and xp is
//    16-byte aligned, 4 bytes otherwise.
//  - No tensor cores: a step's product is at most (9 x 56) @ (56 x 168), and
//    split-TF32 mma.sync would put a chain of about 21 dependent products on
//    each step, which does not shorten the latency that bounds the kernel.
// Backward (exact reverse-time BPTT of _gru_seq_bwd): the forward's layout
// of threads and weights, transposed, on the one product left on the chain.
// What bounds it: the chain of T dependent (rows x 3H) @ (3H x H) products,
// and within a step the issue of the sums' multiply-adds and shared-memory
// loads, the coefficients and the copies (clock64() timers; PERF.md).
//  - hp = h_prev W_hh^T does not depend on dh: it needs only the saved ys
//    and h0 (h_prev = [h0, ys[:-1]]). The wrapper computes it for all T B
//    rows as one batched matrix product before the kernel, as the JAX
//    package computes it outside its Pallas kernel; the kernel adds b_hh.
//    Recomputing hp inside would need a second 3 KL set of weights a thread
//    (spills past KL 16) and double a step's multiply-adds.
//  - The serial part is dh_prev = dh z + dhp W_hh with dhp = dh (c_r, c_z,
//    c_n): c_r = (1-z)(1-n^2) hp_n r(1-r), c_z = (h_prev-n) z(1-z), c_n =
//    (1-z)(1-n^2) r, and dxp = dh (c_r, c_z, (1-z)(1-n^2)). The coefficients
//    come from xp, hp and h_prev alone, so they are computed off the chain,
//    two steps ahead (in reverse step t, step t - 2's), into a double
//    buffer in shared memory. Thread (j, s) computes column j's for rows s,
//    s + S, ...: at KL 16 with S 2 or 4 inside each row group, where their
//    loads and transcendentals issue beside the group's sums (at S 2 12 %
//    faster than a stage of their own; PERF.md), otherwise in a stage of
//    their own before the groups. On the chain stay an add and a few
//    multiplies by dh.
//  - Thread (j, s) holds row j of W_hh^T, w_hh_t[j, g H + i] for i in its
//    KL-long slice s and g in {r, z, n}: 3 KL registers, the forward's
//    instances (KL 16 with S 1, 2, 4 up to H 64, KL 32 with S 4 up to H 96,
//    KL 64 with S 2 up to H 128, each bound at its largest block). Groups
//    of 4 rows at KL 16 and of 1 at KL 32 and 64 (two rows a group spilled
//    at KL 32).
//  - dhp of a step lies in shared memory, double-buffered, each gate's row
//    in slices of KL at the forward's pitch of KL + 4 floats, zeros past H.
//    For each row of a group a lane sums its three KL-long chains (one a
//    gate, from zero), adds them as (r + z) + n, and the forward's
//    butterfly adds the S lanes' sums and spreads the group's rows over the
//    lanes (tests/test_torch_gru_bwd.py emulates this order). The lane
//    holding row r's sum for j owns (r, j): it keeps st =
//    dh[r, j] z + d_ys in shared memory, loads st, the step's coefficients
//    and d_ys before the sums, forms dh_prev = st + sum, and writes dhp of
//    the step before to the next buffer and to HBM, dxp to HBM. One barrier
//    a step.
//  - xp, hp, h_prev and d_ys of a step (8H floats a row) arrive through a
//    ring of kBwdRing steps in shared memory, filled by cp.async kBwdRing
//    steps ahead (16-byte copies where H % 4 == 0 and all four are 16-byte
//    aligned, 4-byte otherwise); the tile's rows are capped by shared
//    memory.
//  - The kernel writes dhp over hp in place (the wrapper passes one buffer
//    for both): each (t, row) belongs to one block, whose copy of hp[t] has
//    landed before the owner writes dhp[t]. dW_hh^T = h_prev^T dhp and
//    db_hh = sum dhp are batched products and a sum after the kernel (no
//    atomics across blocks, deterministic).
//  - Both kernels use the sigmoid 1/2 + tanhf(x/2)/2 (sigmoid_fwd): no
//    division, and the function the forward's ys were made with. The
//    backward with 1/(1 + expf(-x)) was 5-28 % slower (PERF.md).
// The accurate expf and tanhf (not the fast-math intrinsics, and no
// --use_fast_math) keep the kernels within 1e-4 of the plain PyTorch
// versions over 1024 dependent steps.
// The kernels allocate nothing and do not synchronise: the caller owns the
// outputs and the stream.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "gru_cell.cuh"     // sigmoid_fwd, kBlockThreads, kRowGroup, reduce_rows, fwd_rows
#include "tf32_wgmma.cuh"  // cp_async4, cp_async16, cp_async_commit, cp_async_wait

namespace {

constexpr int kMaxHidden = 128;
constexpr int kRing = 16;  // steps of xp in the forward's ring (8 and 16 measured)
constexpr int kBwdRing = 8;  // steps of inputs in the backward's ring

// The backward's groups: one row at KL 32, where two rows' sums beside the
// owners' pointers spilled at the 384-thread bound (168 registers).
template <int KL>
constexpr int kBwdRowGroup = KL == 16 ? 4 : 1;

template <int KL, int S, int HM>
__global__ void __launch_bounds__((kBlockThreads<S, HM>))
gru_seq_fwd_kernel(const float* __restrict__ xp, const float* __restrict__ w_hh_t,
                   const float* __restrict__ b_hh, const float* __restrict__ h0,
                   float* __restrict__ ys, int T, int B, int H, int rows, int vec) {
  constexpr int P = S * (KL + 4);  // row pitch of h in shared memory
  constexpr int RG = kRowGroup<KL>;
  extern __shared__ __align__(16) float fwd_smem[];
  const int G = 3 * H;
  const size_t bucket = blockIdx.y;
  xp += bucket * T * B * G;
  ys += bucket * T * B * H;
  w_hh_t += bucket * H * G;
  b_hh += bucket * G;
  h0 += bucket * B * H;

  const int b0 = blockIdx.x * rows;
  const int n = min(rows, B - b0);       // rows of this tile
  float* h_s = fwd_smem;                 // two buffers of (rows, P)
  float* x_s = fwd_smem + 2 * rows * P;  // kRing steps of (rows, 3H)

  const int j = threadIdx.x / S;
  const int s = threadIdx.x % S;
  const int hj = (j / KL) * (KL + 4) + j % KL;  // h[., j] within a row
  float w[3][KL], bias[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    bias[g] = j < H ? b_hh[g * H + j] : 0.f;
#pragma unroll
    for (int kk = 0; kk < KL; ++kk) {
      const int k = s * KL + kk;
      w[g][kk] = j < H && k < H ? w_hh_t[(size_t)k * G + g * H + j] : 0.f;
    }
  }

  for (int i = threadIdx.x; i < 2 * rows * P; i += blockDim.x) h_s[i] = 0.f;
  __syncthreads();
  for (int i = threadIdx.x; i < n * H; i += blockDim.x) {
    const int r = i / H, c = i - r * H;
    h_s[r * P + (c / KL) * (KL + 4) + c % KL] = h0[(size_t)(b0 + r) * H + c];
  }

  // xp of step t for this tile: n 3H contiguous floats, into slot t % kRing
  const int len = n * G;
  auto fetch = [&](int t) {
    const float* src = xp + ((size_t)t * B + b0) * G;
    float* dst = x_s + (t % kRing) * rows * G;
    if (vec) {
      for (int i = 4 * threadIdx.x; i < len; i += 4 * blockDim.x)
        cp_async16(dst + i, src + i, 16);
    } else {
      for (int i = threadIdx.x; i < len; i += blockDim.x) cp_async4(dst + i, src + i, 4);
    }
  };
#pragma unroll
  for (int t = 0; t < kRing - 1; ++t) {
    if (t < T) fetch(t);
    cp_async_commit();
  }
  cp_async_wait<kRing - 2>();
  __syncthreads();  // h0 and step 0's xp are in place

  for (int t = 0; t < T; ++t) {
    // the slot refilled here was read in step t - 1, before the last barrier
    if (t + kRing - 1 < T) fetch(t + kRing - 1);
    cp_async_commit();
    const float* h_cur = h_s + (t & 1) * rows * P;
    float* h_next = h_s + ((t + 1) & 1) * rows * P;
    const float* x_cur = x_s + (t % kRing) * rows * G;
    float* ys_t = ys + ((size_t)t * B + b0) * H;
    int g0 = 0;
    for (; g0 + RG <= n; g0 += RG)
      fwd_rows<KL, S, RG>(w, bias, h_cur, h_next, x_cur, ys_t, g0, n, s, j, hj, H);
    if constexpr (RG > 1) {
      if (n - g0 > RG / 2)
        fwd_rows<KL, S, RG>(w, bias, h_cur, h_next, x_cur, ys_t, g0, n, s, j, hj, H);
      else if (n > g0)
        fwd_rows<KL, S, RG / 2>(w, bias, h_cur, h_next, x_cur, ys_t, g0, n, s, j, hj, H);
    }
    cp_async_wait<kRing - 2>();  // step t + 1's xp has landed (this thread's copies)
    __syncthreads();             // h' and step t + 1's xp are visible to all
  }
}

// The backward's coefficients of one (row, j) of a step, from its inputs in
// the ring: x = xp[row, j] and p = (h_prev W_hh^T)[row, j], gates at stride
// H, b = b_hh[j] of the three gates, h = h_prev[row, j]. Returns c_r, c_z,
// c_n, (1-z)(1-n^2) and z.
__device__ __forceinline__ void bwd_coefficients(const float* __restrict__ x,
                                                 const float* __restrict__ p,
                                                 const float (&b)[3], float h, float (&c)[5],
                                                 int H) {
  const float hp_r = p[0] + b[0], hp_z = p[H] + b[1], hp_n = p[2 * H] + b[2];
  const float r = sigmoid_fwd(x[0] + hp_r);
  const float z = sigmoid_fwd(x[H] + hp_z);
  const float n = tanhf(x[2 * H] + r * hp_n);
  const float omz = 1.0f - z;
  const float e = omz * (1.0f - n * n);
  c[0] = (e * hp_n) * (r * (1.0f - r));
  c[1] = (h - n) * (z * omz);
  c[2] = e * r;
  c[3] = e;
  c[4] = z;
}

// The first of the rows that lane s holds after reduce_rows<RG, M, N>.
template <int M, int N>
__device__ __forceinline__ int first_held(int s) {
  if constexpr (M >= 1 && N > 1) {
    return ((s & M) ? N / 2 : 0) + first_held<M / 2, N / 2>(s);
  } else {
    return 0;
  }
}

// Reverse step t of rows [g0, g0 + RG) of the tile's n rows (rows past n
// repeat row n - 1, so every load is in bounds, and are not written):
//  - the owners load their operands first: st = dh_t z_t + d_ys[t - 1],
//    step t - 1's coefficients (c_cur, planes of cn floats) and d_ys[t - 2]
//    (in2: the ring's slot of step t - 2);
//  - with kInGroup, lane s computes step t - 2's coefficients of the
//    group's rows g0 + s, g0 + s + S, ... into c_next (t >= 2);
//  - each row's sum dhp_t W_hh over the lanes' slices, reduced over the S
//    lanes;
//  - the owner of (r, j): dh_{t-1} = st + sum; for t >= 1 dhp_{t-1} to
//    g_next and HBM, dxp_{t-1} to HBM, st = dh_{t-1} z_{t-1} + d_ys[t - 2];
//    at t = 0 dh0.
// None of the loads and coefficients depends on the sums: they are issued
// while the sums' multiply-adds are.
template <int KL, int S, int RG, bool kInGroup>
__device__ __forceinline__ void bwd_rows(const float (&w)[3][KL], const float (&bias)[3],
                                         const float* __restrict__ g_cur,
                                         float* __restrict__ g_next,
                                         const float* __restrict__ c_cur,
                                         float* __restrict__ c_next,
                                         const float* __restrict__ in2,
                                         float* __restrict__ st_s,
                                         float* __restrict__ dxp_t,
                                         float* __restrict__ dhp_t,
                                         float* __restrict__ dh0, int g0, int n, int cn,
                                         int s, int j, int hj, int H, int t) {
  constexpr int P = S * (KL + 4);
  constexpr int kHeld = RG >= S ? RG / S : 1;   // rows a lane holds
  constexpr int kShare = RG >= S ? 1 : S / RG;  // lanes holding the same row
  const int G = 3 * H;
  const int jc = min(j, H - 1);  // lanes past H read column H - 1 and store nothing
  const int first = first_held<S / 2, RG>(s);
  float st[kHeld], co[kHeld][5], dy[kHeld];
#pragma unroll
  for (int i = 0; i < kHeld; ++i) {
    const int r = min(g0 + first + i, n - 1);
    st[i] = st_s[r * H + jc];
#pragma unroll
    for (int k = 0; k < 5; ++k) co[i][k] = c_cur[k * cn + r * H + jc];
    dy[i] = t >= 2 ? in2[7 * cn + r * H + jc] : 0.f;
  }
  if constexpr (kInGroup) {
#pragma unroll
    for (int k = 0; k < (RG + S - 1) / S; ++k) {
      const int u = s + k * S;
      const int row = g0 + u;
      const int r = min(row, n - 1);
      float cv[5];
      bwd_coefficients(in2 + r * G + jc, in2 + 3 * cn + r * G + jc, bias,
                       in2[6 * cn + r * H + jc], cv, H);
      if (t >= 2 && u < RG && row < n && j < H) {
#pragma unroll
        for (int q = 0; q < 5; ++q) c_next[q * cn + row * H + j] = cv[q];
      }
    }
  }
  float a[RG][1];
#pragma unroll
  for (int u = 0; u < RG; ++u) {
    const float* gv = g_cur + min(g0 + u, n - 1) * 3 * P + s * (KL + 4);
    float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < KL / 4; ++q) {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float4 d4 = reinterpret_cast<const float4*>(gv + g * P)[q];
        acc[g] = fmaf(d4.x, w[g][4 * q], acc[g]);
        acc[g] = fmaf(d4.y, w[g][4 * q + 1], acc[g]);
        acc[g] = fmaf(d4.z, w[g][4 * q + 2], acc[g]);
        acc[g] = fmaf(d4.w, w[g][4 * q + 3], acc[g]);
      }
    }
    a[u][0] = (acc[0] + acc[1]) + acc[2];
  }
  int off = 0;  // equals first
  reduce_rows<RG, S / 2, RG>(a, s, off);
  if (j < H && (s & (kShare - 1)) == 0) {
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      const int r = g0 + first + i;
      if (r < n) {
        const float dh = st[i] + a[i][0];
        if (t == 0) {
          dh0[r * H + j] = dh;
          continue;
        }
        const float d_r = dh * co[i][0], d_z = dh * co[i][1], d_n = dh * co[i][2];
        float* gn = g_next + r * 3 * P + hj;
        gn[0] = d_r;
        gn[P] = d_z;
        gn[2 * P] = d_n;
        float* dp = dhp_t + r * G + j;
        dp[0] = d_r;
        dp[H] = d_z;
        dp[2 * H] = d_n;
        float* dx = dxp_t + r * G + j;
        dx[0] = d_r;
        dx[H] = d_z;
        dx[2 * H] = dh * co[i][3];
        st_s[r * H + j] = fmaf(dh, co[i][4], dy[i]);
      }
    }
  }
}

// hp and dhp may be one buffer (see the header), so neither is __restrict__.
template <int KL, int S, int HM>
__global__ void __launch_bounds__((kBlockThreads<S, HM>))
gru_seq_bwd_kernel(const float* __restrict__ xp, const float* hp,
                   const float* __restrict__ h_prev, const float* __restrict__ d_ys,
                   const float* __restrict__ w_hh_t, const float* __restrict__ b_hh,
                   float* __restrict__ dxp, float* dhp, float* __restrict__ dh0, int T,
                   int B, int H, int rows, int vec) {
  constexpr int P = S * (KL + 4);  // pitch of one gate's dhp in shared memory
  constexpr int RG = kBwdRowGroup<KL>;
  // KL 16 with S 2 or 4 computes the coefficients inside the row groups,
  // beside the sums; KL 32 and 64, whose weights leave no registers for
  // that, and S 1 (four rows a lane, which spilled), in a stage of their own
  // before them
  constexpr bool kInGroup = KL == 16 && S > 1;
  extern __shared__ __align__(16) float bwd_smem[];
  const int G = 3 * H;
  const size_t bucket = blockIdx.y;
  xp += bucket * T * B * G;
  hp += bucket * T * B * G;
  dxp += bucket * T * B * G;
  dhp += bucket * T * B * G;
  h_prev += bucket * T * B * H;
  d_ys += bucket * T * B * H;
  w_hh_t += bucket * H * G;
  b_hh += bucket * G;
  dh0 += bucket * B * H;

  const int b0 = blockIdx.x * rows;
  const int n = min(rows, B - b0);  // rows of this tile
  const int cn = rows * H;          // one plane of (rows, H)
  const int slot = 8 * cn;          // one step of the ring: xp, hp, h_prev, d_ys
  float* g_s = bwd_smem;            // two buffers of (rows, 3P): dhp
  float* c_s = g_s + 6 * rows * P;  // two buffers of 5 planes: the coefficients
  float* st_s = c_s + 10 * cn;      // (rows, H): dh z + d_ys, the owners'
  float* x_s = st_s + cn;           // kBwdRing steps

  const int j = threadIdx.x / S;
  const int s = threadIdx.x % S;
  const int hj = (j / KL) * (KL + 4) + j % KL;  // dhp[., g, j] within a gate's row
  float w[3][KL], bias[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    bias[g] = j < H ? b_hh[g * H + j] : 0.f;
#pragma unroll
    for (int kk = 0; kk < KL; ++kk) {
      const int i = s * KL + kk;
      w[g][kk] = j < H && i < H ? w_hh_t[(size_t)j * G + g * H + i] : 0.f;
    }
  }
  for (int i = threadIdx.x; i < 6 * rows * P; i += blockDim.x) g_s[i] = 0.f;

  // the inputs of step u for this tile into slot u % kBwdRing: four runs of
  // contiguous floats, n 3H of xp and of hp, n H of h_prev and of d_ys
  auto fetch = [&](int u) {
    float* dst = x_s + (u % kBwdRing) * slot;
    const size_t row0 = (size_t)u * B + b0;
    const float* src[4] = {xp + row0 * G, hp + row0 * G, h_prev + row0 * H,
                           d_ys + row0 * H};
    const int at[4] = {0, 3 * cn, 6 * cn, 7 * cn};
    const int len[4] = {n * G, n * G, n * H, n * H};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (vec) {
        for (int i = 4 * threadIdx.x; i < len[k]; i += 4 * blockDim.x)
          cp_async16(dst + at[k] + i, src[k] + i, 16);
      } else {
        for (int i = threadIdx.x; i < len[k]; i += blockDim.x)
          cp_async4(dst + at[k] + i, src[k] + i, 4);
      }
    }
  };
  // step u's coefficients of the tile, thread (j, s) taking rows s, s + S, ...
  auto coefficients = [&](int u) {
    if (j >= H) return;
    const float* in = x_s + (u % kBwdRing) * slot;
    float* c = c_s + (u & 1) * 5 * cn;
    for (int r = s; r < n; r += S) {
      float cv[5];
      bwd_coefficients(in + r * G + j, in + 3 * cn + r * G + j, bias,
                       in[6 * cn + r * H + j], cv, H);
#pragma unroll
      for (int q = 0; q < 5; ++q) c[q * cn + r * H + j] = cv[q];
    }
  };

  // steps T - 1 down to T - kBwdRing, one group each
#pragma unroll
  for (int k = 0; k < kBwdRing; ++k) {
    if (T - 1 - k >= 0) fetch(T - 1 - k);
    cp_async_commit();
  }
  cp_async_wait<kBwdRing - 2>();
  __syncthreads();  // steps T - 1 and T - 2 have landed; dhp is zero
  if (T > 0) coefficients(T - 1);
  const float* dy_last = x_s + ((T + kBwdRing - 1) % kBwdRing) * slot + 7 * cn;
  for (int i = threadIdx.x; i < n * H; i += blockDim.x) st_s[i] = T > 0 ? dy_last[i] : 0.f;
  __syncthreads();  // step T - 1's coefficients and st

  // Step t takes dhp_t to dh_{t-1}; at t = T, dhp_T is the zeroed buffer.
  for (int t = T; t >= 0; --t) {
    // the slot refilled here held step t - 1, last read before the last barrier
    if (t - kBwdRing - 1 >= 0) fetch(t - kBwdRing - 1);
    cp_async_commit();
    if constexpr (!kInGroup) {
      if (t >= 2) coefficients(t - 2);
    }
    // the step's row groups
    const float* g_cur = g_s + (t & 1) * 3 * rows * P;
    float* g_next = g_s + ((t + 1) & 1) * 3 * rows * P;
    const float* c_cur = c_s + ((t + 1) & 1) * 5 * cn;
    float* c_next = c_s + (t & 1) * 5 * cn;
    const float* in2 = x_s + ((t + kBwdRing - 2) % kBwdRing) * slot;
    const size_t o = ((size_t)max(t - 1, 0) * B + b0) * G;
    float* dxp_t = dxp + o;
    float* dhp_t = dhp + o;
    float* dh0_t = dh0 + (size_t)b0 * H;
    int g0 = 0;
    for (; g0 + RG <= n; g0 += RG)
      bwd_rows<KL, S, RG, kInGroup>(w, bias, g_cur, g_next, c_cur, c_next, in2, st_s,
                                    dxp_t, dhp_t, dh0_t, g0, n, cn, s, j, hj, H, t);
    if constexpr (RG > 1) {
      if (n - g0 > RG / 2)
        bwd_rows<KL, S, RG, kInGroup>(w, bias, g_cur, g_next, c_cur, c_next, in2, st_s,
                                      dxp_t, dhp_t, dh0_t, g0, n, cn, s, j, hj, H, t);
      else if (n > g0)
        bwd_rows<KL, S, RG / 2, kInGroup>(w, bias, g_cur, g_next, c_cur, c_next, in2,
                                          st_s, dxp_t, dhp_t, dh0_t, g0, n, cn,
                                          s, j, hj, H, t);
    }
    cp_async_wait<kBwdRing - 2>();
    __syncthreads();  // dhp of step t - 1, its coefficients and step t - 3's inputs
  }
}

bool bad_dims(int nb, int T, int B, int H) {
  return nb < 0 || T < 0 || B < 0 || H <= 0 || H > kMaxHidden || nb > 65535;
}

// A kernel's tile: the instance (KL, S), threads, rows per block (one tile
// per SM where shared memory allows), tiles per bucket and shared bytes.
struct Tile {
  int kl, s, threads, rows, blocks;
  size_t smem;
};

cudaError_t make_tile(int nb, int B, int H, bool bwd, Tile* tile) {
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
  const int kl = H <= 64 ? 16 : H <= 96 ? 32 : 64;
  int s = 1;
  while (s * kl < H) s *= 2;
  // a row's floats: the forward's two h buffers and xp ring; the
  // backward's two dhp buffers, two sets of five coefficient planes, st
  // and its ring of xp, hp, h_prev and d_ys
  const long long floats =
      bwd ? 6LL * s * (kl + 4) + 11LL * H + (long long)kBwdRing * 8 * H
          : 2LL * s * (kl + 4) + (long long)kRing * 3 * H;
  const long long row_bytes = floats * (long long)sizeof(float);
  const long long total = (long long)std::max(nb, 1) * std::max(B, 1);
  long long rows = (total + sms - 1) / sms;
  rows = std::min<long long>(rows, std::max(B, 1));
  rows = std::min<long long>(rows, max_smem / row_bytes);
  tile->kl = kl;
  tile->s = s;
  tile->threads = (H * s + 31) / 32 * 32;
  tile->rows = static_cast<int>(std::max<long long>(rows, 1));
  tile->blocks = (B + tile->rows - 1) / tile->rows;
  tile->smem = static_cast<size_t>(tile->rows * row_bytes);
  return cudaSuccess;
}

template <int KL, int S, int HM>
cudaError_t fwd_launch(const Tile& tile, const float* xp, const float* w_hh_t,
                       const float* b_hh, const float* h0, float* ys, int nb,
                       int T, int B, int H, cudaStream_t stream) {
  const auto kernel = gru_seq_fwd_kernel<KL, S, HM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(tile.smem));
  if (err != cudaSuccess) return err;
  const int vec = (3 * H) % 4 == 0 && reinterpret_cast<uintptr_t>(xp) % 16 == 0;
  kernel<<<dim3(tile.blocks, nb), tile.threads, tile.smem, stream>>>(
      xp, w_hh_t, b_hh, h0, ys, T, B, H, tile.rows, vec);
  return cudaGetLastError();
}

template <int KL, int S, int HM>
cudaError_t bwd_launch(const Tile& tile, const float* xp, const float* hp,
                       const float* h_prev, const float* d_ys, const float* w_hh_t,
                       const float* b_hh, float* dxp, float* dhp, float* dh0, int nb,
                       int T, int B, int H, cudaStream_t stream) {
  const auto kernel = gru_seq_bwd_kernel<KL, S, HM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(tile.smem));
  if (err != cudaSuccess) return err;
  const auto aligned = [](const float* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = H % 4 == 0 && aligned(xp) && aligned(hp) && aligned(h_prev) && aligned(d_ys);
  kernel<<<dim3(tile.blocks, nb), tile.threads, tile.smem, stream>>>(
      xp, hp, h_prev, d_ys, w_hh_t, b_hh, dxp, dhp, dh0, T, B, H, tile.rows, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gru_seq_fwd(const float* xp, const float* w_hh_t,
                           const float* b_hh, const float* h0, float* ys,
                           int nb, int T, int B, int H, cudaStream_t stream) {
  if (bad_dims(nb, T, B, H)) return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0 || T == 0 || B == 0) return 0;
  Tile tile;
  cudaError_t err = make_tile(nb, B, H, false, &tile);
  if (err != cudaSuccess) return static_cast<int>(err);
#define GRU_FWD_LAUNCH(KL, S, HM) \
  fwd_launch<KL, S, HM>(tile, xp, w_hh_t, b_hh, h0, ys, nb, T, B, H, stream)
  if (H <= 16) err = GRU_FWD_LAUNCH(16, 1, 16);
  else if (H <= 32) err = GRU_FWD_LAUNCH(16, 2, 32);
  else if (H <= 64) err = GRU_FWD_LAUNCH(16, 4, 64);
  else if (H <= 96) err = GRU_FWD_LAUNCH(32, 4, 96);
  else err = GRU_FWD_LAUNCH(64, 2, 128);
#undef GRU_FWD_LAUNCH
  return static_cast<int>(err);
}

// The forward's tile for (nb, B, H) on the current card, for reports:
// out = {rows, tiles per bucket, threads, KL, S, shared bytes}.
extern "C" int gru_seq_fwd_tile(int nb, int B, int H, int* out) {
  if (bad_dims(nb, 1, B, H)) return static_cast<int>(cudaErrorInvalidValue);
  Tile tile;
  const cudaError_t err = make_tile(nb, B, H, false, &tile);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[6] = {tile.rows, tile.blocks, tile.threads, tile.kl, tile.s,
                       static_cast<int>(tile.smem)};
  std::copy(vals, vals + 6, out);
  return 0;
}

// hp (nb, T, B, 3H) = h_prev W_hh^T (without b_hh, which the kernel adds),
// h_prev (nb, T, B, H) = [h0, ys[:-1]]; dhp may be hp itself (written over
// it in place).
extern "C" int gru_seq_bwd(const float* xp, const float* hp, const float* h_prev,
                           const float* d_ys, const float* w_hh_t, const float* b_hh,
                           float* dxp, float* dhp, float* dh0, int nb, int T, int B,
                           int H, cudaStream_t stream) {
  if (bad_dims(nb, T, B, H)) return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0 || B == 0) return 0;
  Tile tile;
  cudaError_t err = make_tile(nb, B, H, true, &tile);
  if (err != cudaSuccess) return static_cast<int>(err);
#define GRU_BWD_LAUNCH(KL, S, HM)                                                   \
  bwd_launch<KL, S, HM>(tile, xp, hp, h_prev, d_ys, w_hh_t, b_hh, dxp, dhp, dh0, nb, T, \
                        B, H, stream)
  if (H <= 16) err = GRU_BWD_LAUNCH(16, 1, 16);
  else if (H <= 32) err = GRU_BWD_LAUNCH(16, 2, 32);
  else if (H <= 64) err = GRU_BWD_LAUNCH(16, 4, 64);
  else if (H <= 96) err = GRU_BWD_LAUNCH(32, 4, 96);
  else err = GRU_BWD_LAUNCH(64, 2, 128);
#undef GRU_BWD_LAUNCH
  return static_cast<int>(err);
}

extern "C" const char* eegsynth_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

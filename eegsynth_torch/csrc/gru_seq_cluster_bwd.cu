// GRU sequence kernel K1, wide backward on a thread-block cluster, for
// Hopper, sm_90a: hidden widths past 128 up to what a cluster's shared
// memory holds, with a leading bucket axis.
//
// Replaces the custom VJP of the TPU kernel, eegsynth/nn/pallas_gru.py
// _gru_seq_bwd (exact reverse-time BPTT), at the widths gru_seq.cu does not
// take; the wrapper (eegsynth_torch/nn/gru_sequence.py, cluster_bwd_plan)
// takes this kernel wherever a plan fits and gru_seq_wide.cu's streaming
// backward above that. Same contract as that backward:
//
//   xp (nb, T, B, 3H), hp (nb, T, B, 3H) = h_prev W_hh^T without b_hh,
//   h_prev (nb, T, B, H) = [h0, ys[:-1]], d_ys (nb, T, B, H),
//   w_hh_t (nb, H, 3H) = W_hh^T, b_hh (nb, 3H)
//   -> dxp (nb, T, B, 3H), dhp (nb, T, B, 3H; may be hp itself), dh0 (nb, B, H).
//
// The wrapper computes hp before the kernel and dW_hh^T = h_prev^T dhp and
// db_hh = sum dhp after it, as batched products; only dh_{t-1} = dh_t z +
// dhp_t W_hh stays on the chain of T dependent steps.
//
// What bounds it: that chain. The streaming kernel reads all of W_hh (3 H^2
// floats: 768 KB at H 256) from L2 in every block every step. A cluster of
// C blocks holds it instead: block c owns hidden units [c U, (c + 1) U),
// U = ceil(H / C), and keeps the same slice of W_hh^T as the cluster forward
// (the three gate columns of its units, 12 H U bytes), loaded once with
// cp.async from w_hh_t as given. The forward all-gathers h'; the backward
// reduce-scatters dh.
//
// Design.
//  - One cluster serves one (bucket, tile of R batch rows). Thread (r, j),
//    r < R the row and j < U the block's unit (the first R U threads), holds
//    dh of its (row, unit) in a register for all T steps, with the step's
//    coefficients (c_r, c_z, c_n, (1 - z)(1 - n^2), z). The coefficients
//    depend on xp, hp and h_prev alone: step t - 1's are loaded during
//    step t + 1 and formed during step t while the block waits for the
//    exchange, off the chain.
//  - Each step t, thread (r, j) forms d = dh_t + d_ys_t, its three entries
//    of dhp_t (d c_r, d c_z, d c_n) and dxp_t, writes them to HBM (dhp over
//    hp), and writes dhp_t to shared memory: the block's 3U entries
//    e = g U + j (gate g) of each row, cut into S slices of KE entries (KE
//    a multiple of 4, S KE >= 3U, zeros past 3U and past the last block's
//    units), slice s at s SP, SP = KE or KE + 4, whichever is 4 past a
//    multiple of 8, so that the S slices a quarter warp reads lie in
//    distinct banks. Two buffers: one barrier a step.
//  - The block's partial product P_c[r, i] = sum over its entries e of
//    dhp_t[r, e] W_hh[m(e), i], for all H outputs i: thread (o, s), o <
//    ceil(H / 4) an output quad (i = 4o .. 4o + 3) and s < S the slice (the
//    S lanes of a quad adjacent in a warp), sums its KE entries in order
//    from zero, one fmaf each, for the R rows. W_hh's float4 of (entry,
//    quad) lies at ((k NO + o) S + s), k < KE the entry in the slice, so a
//    warp reads 512 contiguous bytes; dhp's entries are read four at a time,
//    a float4 broadcast (read one at a time, they cost a shared-memory
//    wavefront an entry and row, as many as W_hh's reads at R 4). The S
//    partial sums are added by gru_cell.cuh's butterfly (distance S/2,
//    S/4, ..., 1), which leaves each lane one row (or R/S rows) of the quad.
//  - Exchange (a reduce-scatter): the lane that holds a row sends its quad
//    with one 16-byte st.async to the receive buffer of the block that owns
//    those units, or of both blocks where a quad straddles two (U is not a
//    multiple of 4); block c's buffer keeps, for each source block and row,
//    the quads [c U / 4, (c U + nu - 1) / 4] of its units. Each buffer has
//    an mbarrier armed with the step's C n nq 16 bytes (nq the block's
//    quads), so one wait a step stands for the whole exchange. Two buffers
//    need no "empty" barrier: a block sends step t - 2's quads into a
//    buffer only once it holds all of step t - 1's, which every block sends
//    after its step t reads of that buffer. The remote addresses of a
//    lane's one or two destinations are mapped (mapa) once, before step 0.
//  - Reduce: thread (r, j) adds the C partials of its (row, unit) in the
//    fixed order of the source blocks, 0 to C - 1, then adds dh_t z: the
//    result is dh_{t-1} of its unit. No broadcast of dh is needed. A fixed
//    order throughout, so two calls give the same bits and
//    tests/test_torch_gru_wide.py emulates it on the CPU.
//  - The plan (C of 2, 4, 8 or 16; R of 1, 2, 4 or 8; S of 1, 2, 4 or 8;
//    KE; U) comes from the wrapper, which picks it from the shape and the
//    card's numbers (gru_seq_cluster_card); the kernel refuses a plan it
//    cannot launch with cudaErrorInvalidValue. A cluster of 16 is
//    non-portable. Nothing depends across clusters, so clusters past one
//    wave cost time but cannot deadlock.
//  - The step-chain floor (gru_seq_cluster_bwd_chain, a probe for
//    chip_smoke.py and nothing else): the same kernel, plan and set-up with
//    each step's coefficients, dhp and sums left out, so its T steps are
//    the exchange of the (zero) partials and the wait for them alone; it
//    writes nothing.
// It uses gru_cell.cuh's sigmoid (1/2 + tanh(x/2)/2) and the accurate
// tanhf, as every K1 kernel does. It allocates nothing and does not
// synchronise.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "cluster.cuh"     // cluster_rank, cluster_sync, remote, mbar_*, st_async_v4
#include "gru_cell.cuh"    // sigmoid_fwd, reduce_rows, held_offset
#include "tf32_wgmma.cuh"  // cp_async4, cp_async_commit, cp_async_wait, fence_proxy_async

namespace {

constexpr int kMaxThreads = 512;  // a block: ceil(H / 4) S rounded up to a warp
constexpr int kMaxHidden = 1024;  // the grids' bound; the plan's shared memory caps it lower
constexpr int kBarBytes = 16;     // the two mbarriers, ahead of W_hh's slice

__host__ __device__ inline int quads(int H) { return (H + 3) / 4; }
__host__ __device__ inline int recv_pitch(int U) { return ((U + 3) / 4 + 1) * 4; }
__host__ __device__ inline int entry_pitch(int KE) { return KE % 8 == 0 ? KE + 4 : KE; }

template <int S, int R>
__global__ void __launch_bounds__(kMaxThreads, 1)
gru_cluster_bwd_kernel(const float* __restrict__ xp, const float* hp,
                       const float* __restrict__ h_prev, const float* __restrict__ d_ys,
                       const float* __restrict__ w_hh_t, const float* __restrict__ b_hh,
                       float* __restrict__ dxp, float* dhp, float* __restrict__ dh0,
                       int T, int B, int H, int C, int KE, int U, bool chain) {
  extern __shared__ __align__(16) unsigned char cb_smem[];
  constexpr int kHeld = R >= S ? R / S : 1;   // rows a lane holds after the butterfly
  constexpr int kShare = R >= S ? 1 : S / R;  // lanes holding the same row
  uint64_t* full = reinterpret_cast<uint64_t*>(cb_smem);  // step t's partials, buffer t & 1
  const int NO = quads(H), NQW = recv_pitch(U), SP = entry_pitch(KE), RP = S * SP;
  const int G = 3 * H;
  float* w_s = reinterpret_cast<float*>(cb_smem + kBarBytes);  // (KE, NO, S) float4s
  float* recv = w_s + 4 * (size_t)KE * NO * S;                 // (2, C, R, NQW)
  float* g_s = recv + 2 * C * R * NQW;                         // (2, R, S SP)
  const int RECV = C * R * NQW;                                // one receive buffer

  const uint32_t rank = cluster_rank();
  const int tile = blockIdx.x / C;
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
  const int b0 = tile * R;
  const int n = min(R, B - b0);            // rows of this tile
  const int u0 = rank * U;                 // the block's first unit
  const int nu = max(0, min(U, H - u0));   // its units (the last block's may be fewer)
  const int qa = u0 / 4;                   // its first quad
  const int nq = (u0 + nu - 1) / 4 - qa + 1;

  // the (row, unit) thread
  const int ri = threadIdx.x / U, ji = threadIdx.x % U;
  const bool holder = threadIdx.x < R * U;  // thread 0 always
  const bool live = holder && ri < n && ji < nu;
  const int unit = u0 + min(ji, nu - 1);
  // the (quad, slice) thread
  const int s = threadIdx.x % S, o = threadIdx.x / S;
  const int oc = min(o, NO - 1);           // lanes past the last quad read it, send nothing

  if (threadIdx.x == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    fence_mbarrier_init();
  }
  // W_hh's slice: W_hh[m(e), i] = w_hh_t[i, m(e)], m(e) = g H + u0 + j for
  // entry e = g U + j; coalesced along the units, zeros past 3U, past nu
  // and past H
  const int SK = S * KE;
  for (int idx = threadIdx.x; idx < SK * 4 * NO; idx += blockDim.x) {
    const int e = idx % SK, i = idx / SK, g = e / U, j = e % U;
    const bool ok = g < 3 && j < nu && i < H;
    cp_async4(&w_s[(((e % KE) * NO + i / 4) * S + e / KE) * 4 + (i & 3)],
              ok ? w_hh_t + (size_t)i * G + g * H + u0 + j : w_hh_t, ok ? 4 : 0);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < 2 * R * RP; i += blockDim.x) g_s[i] = 0.f;
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  const uint32_t bytes = 16u * C * n * nq;  // one step's partials from all C blocks
  if (threadIdx.x == 0) {
    if (T >= 1) mbar_expect(&full[(T - 1) & 1], bytes);
    if (T >= 2) mbar_expect(&full[(T - 2) & 1], bytes);
  }
  cluster_sync();  // every block's barriers armed before any st.async

  // the quad's one or two destination blocks, their receive slots and barriers
  const int ca = 4 * oc / U, cb = min(4 * oc + 3, H - 1) / U;
  const uint32_t to_a = remote(recv + rank * R * NQW + (oc - ca * U / 4) * 4, ca);
  const uint32_t to_b = remote(recv + rank * R * NQW + (oc - cb * U / 4) * 4, cb);
  const uint32_t bar_a0 = remote(&full[0], ca), bar_a1 = remote(&full[1], ca);
  const uint32_t bar_b0 = remote(&full[0], cb), bar_b1 = remote(&full[1], cb);
  const bool sends = o < NO && (s & (kShare - 1)) == 0;
  const int off = held_offset<S / 2, R>(s);

  const float bias[3] = {b_hh[unit], b_hh[H + unit], b_hh[2 * H + unit]};
  const int pos[3] = {(ji / KE) * SP + ji % KE, ((U + ji) / KE) * SP + (U + ji) % KE,
                      ((2 * U + ji) / KE) * SP + (2 * U + ji) % KE};
  // raw: a step's inputs, loaded two steps ahead of its coefficients, so
  // that the loads' latency hides behind a whole step
  float raw[8], ahead[8] = {}, cf[5], dy = 0.f;
  auto load_raw = [&](int t, float (&v)[8]) {
    const size_t row = (size_t)t * B + b0 + ri;
    const float* x = xp + row * G + unit;
    const float* p = hp + row * G + unit;
    v[0] = x[0];
    v[1] = x[H];
    v[2] = x[2 * H];
    v[3] = p[0];
    v[4] = p[H];
    v[5] = p[2 * H];
    v[6] = h_prev[row * H + unit];
    v[7] = d_ys[row * H + unit];
  };
  auto coefficients = [&]() {
    const float hp_r = raw[3] + bias[0], hp_z = raw[4] + bias[1], hp_n = raw[5] + bias[2];
    const float rg = sigmoid_fwd(raw[0] + hp_r);
    const float zg = sigmoid_fwd(raw[1] + hp_z);
    const float ng = tanhf(raw[2] + rg * hp_n);
    const float omz = 1.0f - zg;
    const float e = omz * (1.0f - ng * ng);
    cf[0] = (e * hp_n) * (rg * (1.0f - rg));
    cf[1] = (raw[6] - ng) * (zg * omz);
    cf[2] = e * rg;
    cf[3] = e;
    cf[4] = zg;
    dy = raw[7];
  };
  const bool work = live && !chain;
  if (work && T > 0) {
    load_raw(T - 1, raw);
    coefficients();
    if (T > 1) load_raw(T - 2, raw);
  }

  float dh = 0.f;
  for (int t = T - 1; t >= 0; --t) {
    const int par = t & 1;
    float* gs = g_s + par * R * RP;
    float st = 0.f;
    if (work) {
      const float d = dh + dy;
      const float d_r = d * cf[0], d_z = d * cf[1], d_n = d * cf[2];
      st = d * cf[4];
      float* g = gs + ri * RP;
      g[pos[0]] = d_r;
      g[pos[1]] = d_z;
      g[pos[2]] = d_n;
      const size_t row = (size_t)t * B + b0 + ri;
      float* dp = dhp + row * G + unit;
      dp[0] = d_r;
      dp[H] = d_z;
      dp[2 * H] = d_n;
      float* dx = dxp + row * G + unit;
      dx[0] = d_r;
      dx[H] = d_z;
      dx[2 * H] = d * cf[3];
      if (t > 1) load_raw(t - 2, ahead);  // off the chain: no dependence on dh
    }
    __syncthreads();  // dhp_t of every (row, entry) is in place
    float a[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r][0] = a[r][1] = a[r][2] = a[r][3] = 0.f;
    if (!chain) {
      const float4* wp = reinterpret_cast<const float4*>(w_s) + oc * S + s;
      const float* gp = gs + s * SP;
const size_t WK = (size_t)NO * S;  // one entry's stride in W_hh's slice
      for (int k = 0; k < KE; k += 4) {
        const float4 w0 = wp[k * WK], w1 = wp[(k + 1) * WK];
        const float4 w2 = wp[(k + 2) * WK], w3 = wp[(k + 3) * WK];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 d = *reinterpret_cast<const float4*>(gp + r * RP + k);
          a[r][0] = fmaf(d.w, w3.x, fmaf(d.z, w2.x, fmaf(d.y, w1.x, fmaf(d.x, w0.x, a[r][0]))));
          a[r][1] = fmaf(d.w, w3.y, fmaf(d.z, w2.y, fmaf(d.y, w1.y, fmaf(d.x, w0.y, a[r][1]))));
          a[r][2] = fmaf(d.w, w3.z, fmaf(d.z, w2.z, fmaf(d.y, w1.z, fmaf(d.x, w0.z, a[r][2]))));
          a[r][3] = fmaf(d.w, w3.w, fmaf(d.z, w2.w, fmaf(d.y, w1.w, fmaf(d.x, w0.w, a[r][3]))));
        }
      }
      int held = 0;  // off, as held_offset gives it
      reduce_rows<R, S / 2, R>(a, s, held);
    }
    if (sends) {
#pragma unroll
      for (int i = 0; i < kHeld; ++i) {
        const int r = off + i;
        if (r < n) {
          const float4 v = make_float4(a[i][0], a[i][1], a[i][2], a[i][3]);
          const uint32_t at = 4u * (par * RECV + r * NQW);
          st_async_v4(to_a + at, v, par ? bar_a1 : bar_a0);
          if (cb != ca) st_async_v4(to_b + at, v, par ? bar_b1 : bar_b0);
        }
      }
    }
    if (work && t > 0) {
      coefficients();  // step t - 1's, from the inputs loaded in step t + 1
#pragma unroll
      for (int i = 0; i < 8; ++i) raw[i] = ahead[i];
    }
    if (holder) {
      mbar_wait(&full[par], ((T - 1 - t) >> 1) & 1);  // step t's partials from every block
      if (threadIdx.x == 0 && t >= 2) mbar_expect(&full[par], bytes);  // for step t - 2's
    }
    if (live) {
      const float* rv = recv + par * RECV + ri * NQW + (u0 + ji - 4 * qa);
      float acc = rv[0];
      for (int c = 1; c < C; ++c) acc += rv[c * R * NQW];
      dh = st + acc;
    }
  }
  if (work) dh0[(size_t)(b0 + ri) * H + unit] = dh;
  cluster_sync();  // no block leaves while another may still write to its shared memory
}

// S, KE and U of a plan are the wrapper's (cluster_bwd_geometry); these are
// the limits the kernel checks.
int block_threads(int H, int S) { return (quads(H) * S + 31) / 32 * 32; }

size_t cluster_bwd_smem(int H, int C, int R, int S, int KE, int U) {
  return kBarBytes + sizeof(float) * (4 * (size_t)KE * quads(H) * S
                                      + 2 * (size_t)C * R * recv_pitch(U)
                                      + 2 * (size_t)R * S * entry_pitch(KE));
}

bool bad_plan(int nb, int T, int B, int H, int C, int R, int S, int KE, int U, int max_smem) {
  if (nb < 0 || T < 0 || B < 0 || nb > 65535 || H < 1 || H > kMaxHidden) return true;
  if (C != 2 && C != 4 && C != 8 && C != 16) return true;
  if (R != 1 && R != 2 && R != 4 && R != 8) return true;
  if (S != 1 && S != 2 && S != 4 && S != 8) return true;
  if (U < 4 || (C - 1) * U >= H || C * U < H || KE < 4 || KE % 4 || S * KE < 3 * U) return true;
  const int threads = block_threads(H, S);
  if (threads > kMaxThreads || R * U > threads) return true;
  const long long tiles = (std::max(B, 1) + R - 1) / R;
  if (tiles * C > 0x7fffffffLL) return true;
  return cluster_bwd_smem(H, C, R, S, KE, U) > static_cast<size_t>(max_smem);
}

template <int S, int R>
cudaError_t cluster_bwd_launch(const float* xp, const float* hp, const float* h_prev,
                               const float* d_ys, const float* w_hh_t, const float* b_hh,
                               float* dxp, float* dhp, float* dh0, int nb, int T, int B,
                               int H, int C, int KE, int U, bool chain, cudaStream_t stream) {
  const auto kernel = gru_cluster_bwd_kernel<S, R>;
  const size_t smem = cluster_bwd_smem(H, C, R, S, KE, U);
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
  cfg.blockDim = dim3(block_threads(H, S));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, xp, hp, h_prev, d_ys, w_hh_t, b_hh, dxp, dhp, dh0,
                           T, B, H, C, KE, U, chain);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int S>
cudaError_t cluster_bwd_rows(int R, const float* xp, const float* hp, const float* h_prev,
                             const float* d_ys, const float* w_hh_t, const float* b_hh,
                             float* dxp, float* dhp, float* dh0, int nb, int T, int B, int H,
                             int C, int KE, int U, bool chain, cudaStream_t stream) {
#define GRU_CLUSTER_BWD(RR)                                                                 \
  cluster_bwd_launch<S, RR>(xp, hp, h_prev, d_ys, w_hh_t, b_hh, dxp, dhp, dh0, nb, T, B, H, \
                            C, KE, U, chain, stream)
  switch (R) {
    case 1: return GRU_CLUSTER_BWD(1);
    case 2: return GRU_CLUSTER_BWD(2);
    case 4: return GRU_CLUSTER_BWD(4);
    default: return GRU_CLUSTER_BWD(8);
  }
#undef GRU_CLUSTER_BWD
}

int cluster_bwd_entry(const float* xp, const float* hp, const float* h_prev, const float* d_ys,
                      const float* w_hh_t, const float* b_hh, float* dxp, float* dhp,
                      float* dh0, int nb, int T, int B, int H, int C, int R, int S, int KE,
                      int U, bool chain, cudaStream_t stream) {
  int dev = 0, smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_plan(nb, T, B, H, C, R, S, KE, U, smem)) return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0 || B == 0) return 0;
#define GRU_CLUSTER_BWD_S(SS)                                                              \
  cluster_bwd_rows<SS>(R, xp, hp, h_prev, d_ys, w_hh_t, b_hh, dxp, dhp, dh0, nb, T, B, H, \
                       C, KE, U, chain, stream)
  switch (S) {
    case 1: err = GRU_CLUSTER_BWD_S(1); break;
    case 2: err = GRU_CLUSTER_BWD_S(2); break;
    case 4: err = GRU_CLUSTER_BWD_S(4); break;
    default: err = GRU_CLUSTER_BWD_S(8); break;
  }
#undef GRU_CLUSTER_BWD_S
  return static_cast<int>(err);
}

}  // namespace

// (dxp, dhp, dh0) = K1's backward recurrence on a cluster plan (C, R, S,
// KE, U) from the wrapper; dhp may be hp itself. cudaErrorInvalidValue for
// a plan the kernel cannot launch.
extern "C" int gru_seq_cluster_bwd(const float* xp, const float* hp, const float* h_prev,
                                   const float* d_ys, const float* w_hh_t, const float* b_hh,
                                   float* dxp, float* dhp, float* dh0, int nb, int T, int B,
                                   int H, int C, int R, int S, int KE, int U,
                                   cudaStream_t stream) {
  return cluster_bwd_entry(xp, hp, h_prev, d_ys, w_hh_t, b_hh, dxp, dhp, dh0, nb, T, B, H, C,
                           R, S, KE, U, false, stream);
}

// The step-chain floor of the same plan: T steps of the exchange and the
// wait alone (nothing is read past W_hh^T and b_hh, nothing is written).
extern "C" int gru_seq_cluster_bwd_chain(const float* xp, const float* hp, const float* h_prev,
                                         const float* d_ys, const float* w_hh_t,
                                         const float* b_hh, float* dxp, float* dhp,
                                         float* dh0, int nb, int T, int B, int H, int C, int R,
                                         int S, int KE, int U, cudaStream_t stream) {
  return cluster_bwd_entry(xp, hp, h_prev, d_ys, w_hh_t, b_hh, dxp, dhp, dh0, nb, T, B, H, C,
                           R, S, KE, U, true, stream);
}

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
// with cell the torch GRU cell of gru_seq.cu (gates [r, z, n]) from h = 0.
// Forward only: the D step differentiates only through the discriminator.
//
//   xp_e (nb, T, B, 3He), xp_g (nb, T, B, 3Hg)   hoisted input projections
//   W_e (nb, He, 3He), W_g (nb, Hg, 3Hg), W_pg (nb, Hg, Z), W_is (nb, Z, 3Hs),
//   W_s (nb, Hs, 3Hs), W_ps (nb, Hs, Z) (all transposed: x @ W), biases (nb, n)
//   -> h_real (nb, T, B, He), h_fake (nb, T, B, Z), f32; every width <= 128
//
// What bounds it on this card: as K1's forward, the latency of T dependent
// steps, not bytes or FLOPs. Here a step is three recurrences, two of them
// chained through the projections: 29,008 multiply-adds a batch row at the
// reference width (He = Z = 28, Hg = Hs = 56), 3.1 times K1's.
//
// Design: K1 forward's (gru_seq.cu; the code both use is in gru_cell.cuh),
// with the three cells on the three blocks of a thread-block cluster.
//  - One cluster serves one (bucket, tile of `rows` batch rows): block rank
//    0 runs the generator (G), rank 1 the supervisor (S), rank 2 the
//    embedder (E). Each holds its cell's W_hh^T in registers as K1 forward
//    does (thread (j, s): 3 KL values of columns j, H + j, 2H + j), with KL
//    and S of K1's instance for the widest of He, Hg, Hs and Z; h lies in
//    shared memory, double-buffered at K1's pitch of KL + 4 a slice; a
//    step's rows are summed in groups of RG and the S lanes' partial sums
//    added by K1's butterfly. One block a role, because one block of all
//    three cells does not fit: at z36/h72 their threads at K1's registers
//    need more than an SM's 65,536, and at h128 G alone takes 256 threads x
//    255 registers.
//  - The projections ride on the cells' steps as KL-long chains over the
//    same slices (or over e), with their weights in the block's shared
//    memory at the same pitch, added by the same butterfly:
//      G's step t: its cell, then e[t-1] = h_g[t-1] W_pg + b_pg;
//      S's step t: s_in[t] = e[t] W_is + b_is beside its cell's sums (the
//        depth Z cut into S slices of KLZ = ceil(Z / S) rounded up to 4), so
//        the lane that owns (row, j) holds both for the gates;
//      E's step t: its cell, then h_fake[t-1] = h_s[t-1] W_ps + b_ps.
//    G's and E's projections are a pass of their own beside the cell's,
//    with its own butterfly, run only by the warps that hold a column
//    j < Z. Every block has one barrier a step. A row-step's multiply-adds split G 10,976, S 14,112 and E 3,920
//    at the reference width. E takes S's output projection because W_is
//    and W_ps do not fit one block's 227 KB together at Z = Hs = 128, and E
//    has cycles to spare.
//  - G sends e[t] to S, and S sends h_s[t] to E, through rings of kERing
//    steps in the receiver's shared memory. The lane that owns (row, j)
//    writes its value into the other block with st.async (distributed
//    shared memory), which counts its bytes on the slot's "full" mbarrier
//    there. The receiver arms each slot with the step's byte count and,
//    once it has read the step, arrives on the sender's "empty" mbarrier of
//    the slot. So S's step t runs beside G's step t + 1 or later, E trails
//    S, and a step costs the slowest role's step, not the three in a row.
//    Nothing depends across clusters, so clusters in a later wave cost time
//    but cannot deadlock.
//  - xp_e and xp_g arrive through K1's cp.async ring (kXRing steps).
//  - The tile: the fewest rows at which every cluster of the launch is
//    resident at once (cudaOccupancyMaxActiveClusters), within the block's
//    shared memory; the launches' blocks all take the largest role's.
//  - sigmoid_fwd and the accurate expf / tanhf, as K1. No tensor cores: a
//    step's products are (rows x 56) @ (56 x 168) and smaller.
// The kernel allocates nothing and does not synchronise.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <mutex>

#include "gru_cell.cuh"     // sigmoid_fwd, kBlockThreads, kRowGroup, reduce_rows
#include "tf32_wgmma.cuh"  // smem_addr, cp_async4, cp_async16, cp_async_commit, cp_async_wait

namespace {

constexpr int kMaxWidth = 128;
constexpr int kXRing = 2;         // steps of xp_e / xp_g in the E and G blocks' rings
constexpr int kERing = 4;         // steps of e (G to S) and of h_s (S to E) in the rings
constexpr bool kTimers = false;   // clock64() per role (eegsynth_torch/tools/k2_variants.py)
constexpr int kCluster = 3;       // the blocks of a cluster: G, S, E
constexpr uint32_t kRankG = 0, kRankS = 1, kRankE = 2;
constexpr int kBarFloats = 64;    // room for the 4 kERing mbarriers
constexpr uint32_t kWaitTries = 1u << 28;   // try_waits before a wait is taken as lost
static_assert(4 * kERing * 2 <= kBarFloats, "the mbarriers do not fit their room");

// Per role (E, G, S): cycles of the whole steps, of the waits on the other
// blocks, of the row groups, and the steps; thread 0 of the role's first
// block, with kTimers.
__device__ long long g_phase[12];

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of the cluster's blocks arrives (release) and waits (acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The distributed shared memory address of p's offset in block `rank`.
__device__ __forceinline__ uint32_t remote(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// The one arrival of a receiver's slot, with the bytes its step brings.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Waits for the phase of the given parity to complete. A step that never
// arrives fails the launch (a trap after some seconds) instead of hanging it.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (tries == kWaitTries) __trap();
  }
}

// Arrive on the mbarrier at bar's offset in block `rank` (a slot read).
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, uint32_t rank) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n"
               :: "r"(remote(bar, rank)) : "memory");
}

// Write v at the distributed shared memory address `addr`; its 4 bytes
// complete on the mbarrier at `bar` (same block).
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n"
               :: "r"(addr), "f"(v), "r"(bar) : "memory");
}

__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// klz: the slice of e W_is's depth Z a lane sums; zp: its pitch in shared
// memory, klz + 4 or klz + 8, whichever is 4 past a multiple of 8, so that
// the S slices a quarter warp reads lie in distinct banks.
struct Dims {
  int T, B, He, Hg, Hs, Z, rows, klz, zp, vec_e, vec_g;
};

// Shared-memory floats of a block of role `rank` (the launch gives every
// block the largest): the mbarriers; the ring a receiver holds (S: e at
// pitch PZ, E: h_s at pitch P; G none), at the same offset in both; then h
// (two buffers), the role's weights in shared memory (G: W_pg^T, S:
// W_is^T, E: W_ps^T), its biases (the cell's 3H, then G's b_pg, S's b_is or
// E's b_ps) and its xp ring.
struct Layout {
  int ring, h, w, b, x, end;
};

__host__ __device__ inline Layout layout(uint32_t rank, int rows, int P, int PZ,
                                         const Dims& d) {
  Layout l;
  l.ring = kBarFloats;
  l.h = l.ring + (rank == kRankS ? kERing * rows * PZ : rank == kRankE ? kERing * rows * P : 0);
  l.w = l.h + 2 * rows * P;
  if (rank == kRankS) {
    l.b = l.w + 3 * d.Hs * PZ;
    l.x = l.end = l.b + (6 * d.Hs + 3) / 4 * 4;
  } else {
    const int H = rank == kRankG ? d.Hg : d.He;
    l.b = l.w + d.Z * P;
    l.x = l.b + (3 * H + d.Z + 3) / 4 * 4;
    l.end = l.x + kXRing * rows * 3 * H;
  }
  return l;
}

// Per-role step timers (kTimers): thread 0 of the role's first block.
struct Timers {
  long long t[3] = {0, 0, 0};
  int steps = 0;
  bool on;
  __device__ explicit Timers(bool first) : on(kTimers && first && threadIdx.x == 0) {}
  __device__ __forceinline__ long long now() const { return on ? clock64() : 0; }
  __device__ __forceinline__ void step(long long c0, long long c1, long long c2) {
    if (on) {
      t[0] += clock64() - c0;
      t[1] += c1 - c0;
      t[2] += c2 - c1;
      ++steps;
    }
  }
  __device__ __forceinline__ void store(int role) const {
    if (on) {
      g_phase[4 * role] = t[0];
      g_phase[4 * role + 1] = t[1];
      g_phase[4 * role + 2] = t[2];
      g_phase[4 * role + 3] = steps;
    }
  }
};

// W_hh^T (H, 3H)'s slice of thread (j, s), zeros past H, through shared
// memory a gate at a time (H x H floats at `stage`): coalesced loads, and
// each thread reads its 3 KL values at 32-bit shared addresses. Loaded
// straight from global memory, the 3 KL guarded loads' 64-bit addresses
// spilled at KL 64.
template <int KL, int S>
__device__ __forceinline__ void load_cell(const float* __restrict__ w_t, float (&w)[3][KL],
                                          float* __restrict__ stage, int H, int j, int s) {
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    for (int i = threadIdx.x; i < H * H; i += blockDim.x) {
      const int k = i / H, c = i - k * H;
      stage[i] = w_t[(size_t)k * 3 * H + g * H + c];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KL; ++kk) {
      const int k = s * KL + kk;
      w[g][kk] = j < H && k < H ? stage[k * H + j] : 0.f;
    }
    __syncthreads();
  }
}

// Ends a block's set-up: a receiver (S, E) zeroes its ring (the padding past
// Z or Hs stays zero) and arms each slot's first step with its bytes; then
// every block of the cluster waits for all to be ready before any remote use.
__device__ __forceinline__ void cluster_ready(uint32_t rank, float* smem, const Layout& l,
                                              uint64_t* full, uint32_t bytes, int T) {
  if (rank != kRankG) {
    for (int i = l.ring + threadIdx.x; i < l.h; i += blockDim.x) smem[i] = 0.f;
    fence_proxy_async();
  }
  __syncthreads();
  if (threadIdx.x == 0 && rank != kRankG) {
    for (int k = 0; k < min(kERing, T); ++k) mbar_expect(&full[k], bytes);
  }
  cluster_sync();
}

// A block's biases into shared memory: the cell's b (n1), then the other (n2).
__device__ __forceinline__ void stage_biases(float* __restrict__ dst, const float* __restrict__ b1,
                                             int n1, const float* __restrict__ b2, int n2) {
  for (int i = threadIdx.x; i < n1 + n2; i += blockDim.x) dst[i] = i < n1 ? b1[i] : b2[i - n1];
}

// The transposed rows of w (K, N): row c < N of w^T at dst + c * pitch, in
// slices of kl values sp apart, zeros past K up to slices * kl.
__device__ __forceinline__ void stage_transposed(float* __restrict__ dst,
                                                 const float* __restrict__ w, int K,
                                                 int N, int slices, int kl, int sp,
                                                 int pitch) {
  for (int i = threadIdx.x; i < N * slices * kl; i += blockDim.x) {
    const int c = i / (slices * kl), k = i % (slices * kl);
    dst[c * pitch + (k / kl) * sp + k % kl] = k < K ? w[(size_t)k * N + c] : 0.f;
  }
}

// One step of the cell for rows [g0, g0 + RG) of G or E: K1 forward's sums,
// butterfly and gates (gru_cell.cuh's fwd_rows, with b_hh from shared
// memory); writes h' to h_next and, for E, to ys_t. Rows past n repeat row
// n - 1 and are not written.
template <int KL, int S, int RG, bool kEmbedder>
__device__ __forceinline__ void cell_rows(const float (&w)[3][KL], const float* __restrict__ bias,
                                          const float* __restrict__ h_cur,
                                          float* __restrict__ h_next,
                                          const float* __restrict__ x_cur,
                                          float* __restrict__ ys_t, int g0, int n, int s,
                                          int j, int hj, int H) {
  constexpr int P = S * (KL + 4);
  float a[RG][3];
#pragma unroll
  for (int u = 0; u < RG; ++u) {
    const float4* hv = reinterpret_cast<const float4*>(
        h_cur + min(g0 + u, n - 1) * P + s * (KL + 4));
    a[u][0] = a[u][1] = a[u][2] = 0.f;
#pragma unroll
    for (int q = 0; q < KL / 4; ++q) {
      const float4 h4 = hv[q];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        a[u][g] = fmaf(h4.x, w[g][4 * q], a[u][g]);
        a[u][g] = fmaf(h4.y, w[g][4 * q + 1], a[u][g]);
        a[u][g] = fmaf(h4.z, w[g][4 * q + 2], a[u][g]);
        a[u][g] = fmaf(h4.w, w[g][4 * q + 3], a[u][g]);
      }
    }
  }
  int off = 0;
  reduce_rows<RG, S / 2, RG>(a, s, off);
  constexpr int kHeld = RG >= S ? RG / S : 1;   // rows a lane holds
  constexpr int kShare = RG >= S ? 1 : S / RG;  // lanes holding the same row
  if (j < H && (s & (kShare - 1)) == 0) {
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      const int r = g0 + off + i;
      if (r < n) {
        const float* x = x_cur + r * 3 * H + j;
        const float h = h_cur[r * P + hj];
        const float rg = sigmoid_fwd(x[0] + (a[i][0] + bias[j]));
        const float zg = sigmoid_fwd(x[H] + (a[i][1] + bias[H + j]));
        const float ng = tanhf(x[2 * H] + rg * (a[i][2] + bias[2 * H + j]));
        const float hn = (1.0f - zg) * ng + zg * h;
        h_next[r * P + hj] = hn;
        if (kEmbedder) ys_t[r * H + j] = hn;
      }
    }
  }
}

// Column j of a projection for rows [g0, g0 + RG): the sums over the KL-long
// slices of v_cur (G: e = h_g W_pg over its own h; E: h_fake = h_s W_ps over
// S's ring) with the slice of W^T at wp_j, the butterfly, + bias_p[j]. G's
// owner lanes send e to S's ring; E's write h_fake.
template <int KL, int S, int RG, bool kEmbedder>
__device__ __forceinline__ void proj_rows(const float* __restrict__ v_cur,
                                          const float* __restrict__ wp_j,
                                          const float* __restrict__ bias_p,
                                          float* __restrict__ out_t, uint32_t e_slot,
                                          uint32_t e_bar, int e_pitch, int ej, int g0, int n,
                                          int s, int j, int Z) {
  constexpr int P = S * (KL + 4);
  float a[RG][1];
#pragma unroll
  for (int u = 0; u < RG; ++u) a[u][0] = 0.f;
  const float4* wv = reinterpret_cast<const float4*>(wp_j);
  // unrolled (10-12 % of the kernel at KL 32 and 64), but one float4 at a
  // time at KL 16, where unrolled it spilled under the 128-register cap
#pragma unroll (KL == 16 ? 1 : KL / 4)
  for (int q = 0; q < KL / 4; ++q) {
    const float4 p4 = wv[q];
#pragma unroll
    for (int u = 0; u < RG; ++u) {
      const float4 v4 = reinterpret_cast<const float4*>(
          v_cur + min(g0 + u, n - 1) * P + s * (KL + 4))[q];
      a[u][0] = fmaf(v4.x, p4.x, a[u][0]);
      a[u][0] = fmaf(v4.y, p4.y, a[u][0]);
      a[u][0] = fmaf(v4.z, p4.z, a[u][0]);
      a[u][0] = fmaf(v4.w, p4.w, a[u][0]);
    }
  }
  int off = 0;
  reduce_rows<RG, S / 2, RG>(a, s, off);
  constexpr int kHeld = RG >= S ? RG / S : 1;
  constexpr int kShare = RG >= S ? 1 : S / RG;
  if (j < Z && (s & (kShare - 1)) == 0) {
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      const int r = g0 + off + i;
      if (r < n) {
        const float v = a[i][0] + bias_p[j];
        if (kEmbedder) {
          out_t[r * Z + j] = v;
        } else {
          st_async(e_slot + 4u * (r * e_pitch + ej), v, e_bar);
        }
      }
    }
  }
}

// Runs ROWS(R) over a step's n rows with g0 in scope: whole groups of RG,
// then the ragged tail in a group of RG or RG / 2 (K1 forward's split).
#define K2_ROW_GROUPS(RG, n, ROWS)                     \
  do {                                                 \
    int g0 = 0;                                        \
    for (; g0 + (RG) <= (n); g0 += (RG)) ROWS(RG);     \
    if constexpr ((RG) > 1) {                          \
      if ((n) - g0 > (RG) / 2) ROWS(RG);               \
      else if ((n) > g0) ROWS((RG) / 2);               \
    }                                                  \
  } while (0)

// One step of rows [g0, g0 + RG) of S: s_in = e W_is over the slices of
// e_cur (KLZ long, zp apart; W_is^T's rows of column j's three
// gates at wi_j, gate_stride apart) and the cell's sums over h_cur, then
// the cell fed with s_in + b_is. The owner lanes send h_s to E's ring.
template <int KL, int S, int RG>
__device__ __forceinline__ void s_rows(
    const float (&w)[3][KL], const float* __restrict__ bias,
    const float* __restrict__ h_cur, float* __restrict__ h_next,
    const float* __restrict__ e_cur, const float* __restrict__ wi_j, int gate_stride,
    int PZ, int klz, int zp, uint32_t h_slot, uint32_t h_bar, int g0, int n, int s, int j,
    int hj, int H) {
  constexpr int P = S * (KL + 4);
  float a[RG][6];   // the cell's three sums, then s_in's three (summed first)
#pragma unroll
  for (int u = 0; u < RG; ++u) a[u][3] = a[u][4] = a[u][5] = 0.f;
  const float4* iv = reinterpret_cast<const float4*>(wi_j);
  const int gs4 = gate_stride / 4;
#pragma unroll 1
  for (int q = 0; q < klz / 4; ++q) {
    const float4 i0 = iv[q], i1 = iv[gs4 + q], i2 = iv[2 * gs4 + q];
#pragma unroll
    for (int u = 0; u < RG; ++u) {
      const float4 e4 = reinterpret_cast<const float4*>(
          e_cur + min(g0 + u, n - 1) * PZ + s * zp)[q];
      a[u][3] = fmaf(e4.x, i0.x, a[u][3]);
      a[u][3] = fmaf(e4.y, i0.y, a[u][3]);
      a[u][3] = fmaf(e4.z, i0.z, a[u][3]);
      a[u][3] = fmaf(e4.w, i0.w, a[u][3]);
      a[u][4] = fmaf(e4.x, i1.x, a[u][4]);
      a[u][4] = fmaf(e4.y, i1.y, a[u][4]);
      a[u][4] = fmaf(e4.z, i1.z, a[u][4]);
      a[u][4] = fmaf(e4.w, i1.w, a[u][4]);
      a[u][5] = fmaf(e4.x, i2.x, a[u][5]);
      a[u][5] = fmaf(e4.y, i2.y, a[u][5]);
      a[u][5] = fmaf(e4.z, i2.z, a[u][5]);
      a[u][5] = fmaf(e4.w, i2.w, a[u][5]);
    }
  }
#pragma unroll
  for (int u = 0; u < RG; ++u) {
    const float4* hv = reinterpret_cast<const float4*>(
        h_cur + min(g0 + u, n - 1) * P + s * (KL + 4));
#pragma unroll
    for (int g = 0; g < 3; ++g) a[u][g] = 0.f;
#pragma unroll
    for (int q = 0; q < KL / 4; ++q) {
      const float4 h4 = hv[q];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        a[u][g] = fmaf(h4.x, w[g][4 * q], a[u][g]);
        a[u][g] = fmaf(h4.y, w[g][4 * q + 1], a[u][g]);
        a[u][g] = fmaf(h4.z, w[g][4 * q + 2], a[u][g]);
        a[u][g] = fmaf(h4.w, w[g][4 * q + 3], a[u][g]);
      }
    }
  }
  int off = 0;
  reduce_rows<RG, S / 2, RG>(a, s, off);
  constexpr int kHeld = RG >= S ? RG / S : 1;
  constexpr int kShare = RG >= S ? 1 : S / RG;
  if (j < H && (s & (kShare - 1)) == 0) {
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      const int r = g0 + off + i;
      if (r < n) {
        const float h = h_cur[r * P + hj];
        const float* bi = bias + 3 * H + j;   // b_is, after the cell's b_s
        const float rg = sigmoid_fwd((a[i][3] + bi[0]) + (a[i][0] + bias[j]));
        const float zg = sigmoid_fwd((a[i][4] + bi[H]) + (a[i][1] + bias[H + j]));
        const float ng = tanhf((a[i][5] + bi[2 * H]) + rg * (a[i][2] + bias[2 * H + j]));
        const float hn = (1.0f - zg) * ng + zg * h;
        h_next[r * P + hj] = hn;
        st_async(h_slot + 4u * (r * P + hj), hn, h_bar);
      }
    }
  }
}

// xp of step t for this tile: n rows of G contiguous floats, into slot t % kXRing.
__device__ __forceinline__ void fetch_xp(float* x_s, const float* xp, int t, int B, int b0,
                                         int n, int rows, int G, int vec) {
  const float* src = xp + ((size_t)t * B + b0) * G;
  float* dst = x_s + (t % kXRing) * rows * G;
  const int len = n * G;
  if (vec) {
    for (int i = 4 * threadIdx.x; i < len; i += 4 * blockDim.x) cp_async16(dst + i, src + i, 16);
  } else {
    for (int i = threadIdx.x; i < len; i += blockDim.x) cp_async4(dst + i, src + i, 4);
  }
}

// Steps 0 .. kXRing - 2 of xp in flight, then step 0's landed and, with the
// barrier, everything the block staged before it visible.
__device__ __forceinline__ void prime_xp(float* x_s, const float* xp, int T, int B, int b0,
                                         int n, int rows, int G, int vec) {
#pragma unroll
  for (int t = 0; t < kXRing - 1; ++t) {
    if (t < T) fetch_xp(x_s, xp, t, B, b0, n, rows, G, vec);
    cp_async_commit();
  }
  cp_async_wait<kXRing - 2>();
  __syncthreads();
}

// G: steps u = 0 .. T; step u runs the cell of step u (u < T) and sends
// e[u - 1] (u >= 1) to S's ring slot (u - 1) % kERing.
template <int KL, int S>
__device__ __forceinline__ void g_block(const float* __restrict__ xp, const float* __restrict__ w_t,
                                        const float* __restrict__ b, const float* __restrict__ wp,
                                        const float* __restrict__ bp, float* smem,
                                        uint64_t* e_full, uint64_t* e_empty, const Layout& l,
                                        const Dims& d, size_t bucket, int b0, int n, bool first) {
  constexpr int P = S * (KL + 4);
  constexpr int RG = kRowGroup<KL>;
  const int H = d.Hg, Z = d.Z, G = 3 * H, T = d.T, B = d.B, rows = d.rows;
  const int PZ = S * d.zp;
  const int j = threadIdx.x / S, s = threadIdx.x % S;
  const int hj = (j / KL) * (KL + 4) + j % KL;
  xp += bucket * T * B * G;
  w_t += bucket * H * G;
  b += bucket * G;
  wp += bucket * H * Z;
  bp += bucket * Z;
  float* hbuf = smem + l.h;
  float* x_s = smem + l.x;
  const float* bias = smem + l.b;
  float w[3][KL];
  load_cell<KL, S>(w_t, w, smem + kBarFloats, H, j, s);
  stage_biases(smem + l.b, b, G, bp, Z);
  stage_transposed(smem + l.w, wp, H, Z, S, KL, KL + 4, P);
  for (int i = threadIdx.x; i < 2 * rows * P; i += blockDim.x) hbuf[i] = 0.f;
  cluster_ready(kRankG, smem, l, nullptr, 0, T);
  const float* wp_j = smem + l.w + min(j, Z - 1) * P + s * (KL + 4);
  const int ej = (j / d.klz) * d.zp + j % d.klz;   // e[., j] in a row of S's ring
  // warps whose every j is past Hg (Z) have no cell (projection) sums to do
  const bool cell_warp = (threadIdx.x / 32) * 32 / S < H;
  const bool proj_warp = (threadIdx.x / 32) * 32 / S < Z;
  prime_xp(x_s, xp, T, B, b0, n, rows, G, d.vec_g);
  Timers tm(first);
  for (int u = 0; u <= T; ++u) {
    const long long c0 = tm.now();
    if (u + kXRing - 1 < T) fetch_xp(x_s, xp, u + kXRing - 1, B, b0, n, rows, G, d.vec_g);
    cp_async_commit();
    const int v = u - 1;                    // the step whose e this step sends
    const int k = v >= 0 ? v % kERing : 0;
    if (v >= kERing) mbar_wait(&e_empty[k], (v / kERing - 1) & 1);   // S read e[v - kERing]
    const long long c1 = tm.now();
    const float* h_cur = hbuf + (u & 1) * rows * P;
    float* h_next = hbuf + ((u + 1) & 1) * rows * P;
    const float* x_cur = x_s + (u % kXRing) * rows * G;
    if (v >= 0 && proj_warp) {   // e[u - 1], from the h_cur the cell reads
      const uint32_t e_slot = remote(smem + l.ring + k * rows * PZ, kRankS);
      const uint32_t e_bar = remote(&e_full[k], kRankS);
#define K2_PROJ(R) proj_rows<KL, S, R, false>(h_cur, wp_j, bias + G, nullptr, e_slot, e_bar, PZ, \
                                              ej, g0, n, s, j, Z)
      K2_ROW_GROUPS(RG, n, K2_PROJ);
#undef K2_PROJ
    }
    if (u < T && cell_warp) {
#define K2_CELL(R) cell_rows<KL, S, R, false>(w, bias, h_cur, h_next, x_cur, nullptr, g0, n, s, \
                                              j, hj, H)
      K2_ROW_GROUPS(RG, n, K2_CELL);
#undef K2_CELL
    }
    const long long c2 = tm.now();
    cp_async_wait<kXRing - 2>();   // step u + 1's xp has landed (this thread's copies)
    __syncthreads();               // h' and step u + 1's xp are visible to all
    tm.step(c0, c1, c2);
  }
  tm.store(1);
}

// S: steps u = 0 .. T - 1; step u waits for e[u] in its ring, runs s_in and
// the cell of step u, and sends h_s[u] to E's ring slot u % kERing.
template <int KL, int S>
__device__ __forceinline__ void s_block(const float* __restrict__ w_t, const float* __restrict__ b,
                                        const float* __restrict__ wi, const float* __restrict__ bi,
                                        float* smem, uint64_t* e_full, uint64_t* e_empty,
                                        uint64_t* h_full, uint64_t* h_empty, const Layout& l,
                                        const Dims& d, size_t bucket, int n, bool first) {
  constexpr int P = S * (KL + 4);
  constexpr int RG = kRowGroup<KL>;
  const int H = d.Hs, Z = d.Z, G = 3 * H, T = d.T, rows = d.rows, klz = d.klz, zp = d.zp;
  const int PZ = S * zp;
  const int j = threadIdx.x / S, s = threadIdx.x % S;
  const int hj = (j / KL) * (KL + 4) + j % KL;
  w_t += bucket * H * G;
  b += bucket * G;
  wi += bucket * Z * G;
  bi += bucket * G;
  float* hbuf = smem + l.h;
  const float* ring = smem + l.ring;
  const float* bias = smem + l.b;
  float w[3][KL];
  load_cell<KL, S>(w_t, w, smem + kBarFloats, H, j, s);
  stage_biases(smem + l.b, b, G, bi, G);
  stage_transposed(smem + l.w, wi, Z, G, S, klz, zp, PZ);
  for (int i = threadIdx.x; i < 2 * rows * P; i += blockDim.x) hbuf[i] = 0.f;
  const uint32_t e_bytes = 4u * n * Z;
  cluster_ready(kRankS, smem, l, e_full, e_bytes, T);
  const float* wi_j = smem + l.w + min(j, H - 1) * PZ + s * zp;
  Timers tm(first);
  for (int u = 0; u < T; ++u) {
    const long long c0 = tm.now();
    const int k = u % kERing;
    mbar_wait(&e_full[k], (u / kERing) & 1);                          // e[u] has landed
    if (u >= kERing) mbar_wait(&h_empty[k], (u / kERing - 1) & 1);    // E read h_s[u - kERing]
    const long long c1 = tm.now();
    const float* h_cur = hbuf + (u & 1) * rows * P;
    float* h_next = hbuf + ((u + 1) & 1) * rows * P;
    const float* e_cur = ring + k * rows * PZ;
    const uint32_t h_slot = remote(smem + l.ring + k * rows * P, kRankE);
    const uint32_t h_bar = remote(&h_full[k], kRankE);
#define K2_S_ROWS(R) s_rows<KL, S, R>(w, bias, h_cur, h_next, e_cur, wi_j, H * PZ, PZ, klz, zp, \
                                     h_slot, h_bar, g0, n, s, j, hj, H)
    K2_ROW_GROUPS(RG, n, K2_S_ROWS);
#undef K2_S_ROWS
    const long long c2 = tm.now();
    __syncthreads();   // h_s[u] is in place, and every thread has read e[u]
    if (threadIdx.x == 0 && u + kERing < T) {   // G will send e[u + kERing] to slot k
      mbar_expect(&e_full[k], e_bytes);
      mbar_arrive_remote(&e_empty[k], kRankG);
    }
    tm.step(c0, c1, c2);
  }
  tm.store(2);
}

// E: steps u = 0 .. T; step u runs its cell of step u (u < T) and writes
// h_fake[u - 1] (u >= 1) from h_s[u - 1] in its ring.
template <int KL, int S>
__device__ __forceinline__ void e_block(const float* __restrict__ xp, const float* __restrict__ w_t,
                                        const float* __restrict__ b, const float* __restrict__ wp,
                                        const float* __restrict__ bp, float* __restrict__ h_real,
                                        float* __restrict__ h_fake, float* smem, uint64_t* h_full,
                                        uint64_t* h_empty, const Layout& l, const Dims& d,
                                        size_t bucket, int b0, int n, bool first) {
  constexpr int P = S * (KL + 4);
  constexpr int RG = kRowGroup<KL>;
  const int H = d.He, Z = d.Z, Hs = d.Hs, G = 3 * H, T = d.T, B = d.B, rows = d.rows;
  const int j = threadIdx.x / S, s = threadIdx.x % S;
  const int hj = (j / KL) * (KL + 4) + j % KL;
  xp += bucket * T * B * G;
  w_t += bucket * H * G;
  b += bucket * G;
  wp += bucket * Hs * Z;
  bp += bucket * Z;
  h_real += bucket * T * B * H;
  h_fake += bucket * T * B * Z;
  float* hbuf = smem + l.h;
  float* x_s = smem + l.x;
  const float* ring = smem + l.ring;
  const float* bias = smem + l.b;
  float w[3][KL];
  load_cell<KL, S>(w_t, w, smem + kBarFloats, H, j, s);
  stage_biases(smem + l.b, b, G, bp, Z);
  stage_transposed(smem + l.w, wp, Hs, Z, S, KL, KL + 4, P);
  for (int i = threadIdx.x; i < 2 * rows * P; i += blockDim.x) hbuf[i] = 0.f;
  cluster_ready(kRankE, smem, l, h_full, 4u * n * Hs, T);
  const float* wp_j = smem + l.w + min(j, Z - 1) * P + s * (KL + 4);
  // warps whose every j is past He (Z) have no cell (projection) sums to do
  const bool cell_warp = (threadIdx.x / 32) * 32 / S < H;
  const bool proj_warp = (threadIdx.x / 32) * 32 / S < Z;
  const uint32_t h_bytes = 4u * n * Hs;
  prime_xp(x_s, xp, T, B, b0, n, rows, G, d.vec_e);
  Timers tm(first);
  for (int u = 0; u <= T; ++u) {
    const long long c0 = tm.now();
    if (u + kXRing - 1 < T) fetch_xp(x_s, xp, u + kXRing - 1, B, b0, n, rows, G, d.vec_e);
    cp_async_commit();
    const int v = u - 1;                    // the step of h_s this step reads
    const int k = v >= 0 ? v % kERing : 0;
    if (v >= 0) mbar_wait(&h_full[k], (v / kERing) & 1);   // h_s[v] has landed
    const long long c1 = tm.now();
    const float* h_cur = hbuf + (u & 1) * rows * P;
    float* h_next = hbuf + ((u + 1) & 1) * rows * P;
    const float* x_cur = x_s + (u % kXRing) * rows * G;
    const float* hs_cur = ring + k * rows * P;
    float* ys_t = h_real + ((size_t)min(u, T - 1) * B + b0) * H;
    float* fake_t = h_fake + ((size_t)max(v, 0) * B + b0) * Z;
    if (u < T && cell_warp) {
#define K2_CELL(R) cell_rows<KL, S, R, true>(w, bias, h_cur, h_next, x_cur, ys_t, g0, n, s, j, \
                                             hj, H)
      K2_ROW_GROUPS(RG, n, K2_CELL);
#undef K2_CELL
    }
    if (v >= 0 && proj_warp) {
#define K2_PROJ(R) proj_rows<KL, S, R, true>(hs_cur, wp_j, bias + G, fake_t, 0u, 0u, 0, 0, g0, \
                                             n, s, j, Z)
      K2_ROW_GROUPS(RG, n, K2_PROJ);
#undef K2_PROJ
    }
    const long long c2 = tm.now();
    cp_async_wait<kXRing - 2>();
    __syncthreads();   // h' and step u + 1's xp are in place; h_s[v] is read
    if (threadIdx.x == 0 && v >= 0 && v + kERing < T) {   // S will send h_s[v + kERing]
      mbar_expect(&h_full[k], h_bytes);
      mbar_arrive_remote(&h_empty[k], kRankS);
    }
    tm.step(c0, c1, c2);
  }
  tm.store(0);
}

template <int KL, int S, int HM>
__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__((kBlockThreads<S, HM>), (KL == 16 && S == 4 ? 2 : 1))
multigru_fwd_kernel(const float* __restrict__ xp_e, const float* __restrict__ xp_g,
                    const float* __restrict__ we, const float* __restrict__ be,
                    const float* __restrict__ wg, const float* __restrict__ bg,
                    const float* __restrict__ wpg, const float* __restrict__ bpg,
                    const float* __restrict__ wis, const float* __restrict__ bis,
                    const float* __restrict__ ws, const float* __restrict__ bs,
                    const float* __restrict__ wps, const float* __restrict__ bps,
                    float* __restrict__ h_real, float* __restrict__ h_fake, Dims d) {
  extern __shared__ __align__(16) float k2_smem[];
  constexpr int P = S * (KL + 4);
  const int PZ = S * d.zp;
  const uint32_t rank = cluster_rank();
  const int tile = blockIdx.x / kCluster;
  const size_t bucket = blockIdx.y;
  const int b0 = tile * d.rows;
  const int n = min(d.rows, d.B - b0);
  const Layout l = layout(rank, d.rows, P, PZ, d);
  uint64_t* bars = reinterpret_cast<uint64_t*>(k2_smem);
  uint64_t* e_full = bars;                 // in S: e of a step has landed
  uint64_t* e_empty = bars + kERing;       // in G: S has read a step's e
  uint64_t* h_full = bars + 2 * kERing;    // in E: h_s of a step has landed
  uint64_t* h_empty = bars + 3 * kERing;   // in S: E has read a step's h_s
  if (threadIdx.x == 0) {
    for (int k = 0; k < 4 * kERing; ++k) mbar_init(&bars[k], 1);
    fence_mbarrier_init();
  }
  // each role sets itself up (its weights staged through all of its shared
  // memory past the mbarriers), then cluster_ready: rings, arming, and the
  // cluster barrier before any remote use
  const bool first = tile == 0 && bucket == 0;
  if (rank == kRankG) {
    g_block<KL, S>(xp_g, wg, bg, wpg, bpg, k2_smem, e_full, e_empty, l, d, bucket, b0, n,
                   first);
  } else if (rank == kRankS) {
    s_block<KL, S>(ws, bs, wis, bis, k2_smem, e_full, e_empty, h_full, h_empty, l, d,
                   bucket, n, first);
  } else {
    e_block<KL, S>(xp_e, we, be, wps, bps, h_real, h_fake, k2_smem, h_full, h_empty, l, d,
                   bucket, b0, n, first);
  }
  cluster_sync();   // no block leaves while another may still write to its shared memory
}

using Kernel = void (*)(const float*, const float*, const float*, const float*,
                        const float*, const float*, const float*, const float*,
                        const float*, const float*, const float*, const float*,
                        const float*, const float*, float*, float*, Dims);

// A launch's instance (K1's for the widest width), tile and shared bytes.
struct Tile {
  Kernel kernel;
  int kl, s, klz, zp, threads, rows, tiles, max_clusters;
  size_t smem;
};

bool bad_dims(int nb, int T, int B, int He, int Hg, int Hs, int Z) {
  return nb < 0 || T < 0 || B < 0 || nb > 65535 ||
         std::min(std::min(He, Hg), std::min(Hs, Z)) <= 0 ||
         std::max(std::max(He, Hg), std::max(Hs, Z)) > kMaxWidth;
}

cudaError_t find_tile(int nb, int B, int He, int Hg, int Hs, int Z, Tile* t) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  const int hmax = std::max(std::max(He, Hg), std::max(Hs, Z));
  if (hmax <= 16) t->kernel = multigru_fwd_kernel<16, 1, 16>;
  else if (hmax <= 32) t->kernel = multigru_fwd_kernel<16, 2, 32>;
  else if (hmax <= 64) t->kernel = multigru_fwd_kernel<16, 4, 64>;
  else if (hmax <= 96) t->kernel = multigru_fwd_kernel<32, 4, 96>;
  else t->kernel = multigru_fwd_kernel<64, 2, 128>;
  t->kl = hmax <= 64 ? 16 : hmax <= 96 ? 32 : 64;
  t->s = 1;
  while (t->s * t->kl < hmax) t->s *= 2;
  t->klz = ((Z + t->s - 1) / t->s + 3) / 4 * 4;
  t->zp = t->klz % 8 == 0 ? t->klz + 4 : t->klz + 8;
  t->threads = (hmax * t->s + 31) / 32 * 32;
  const int P = t->s * (t->kl + 4), PZ = t->s * t->zp;
  const Dims d{0, B, He, Hg, Hs, Z, 0, t->klz, t->zp, 0, 0};
  // the fewest rows at which every cluster is resident at once; past the
  // shared memory, the most rows that fit (the clusters then run in waves)
  t->rows = 0;
  for (int tiles = std::max(B, 1), prev = 0; tiles >= 1; --tiles) {
    const int rows = (std::max(B, 1) + tiles - 1) / tiles;
    if (rows == prev) continue;
    prev = rows;
    int floats = kBarFloats + hmax * hmax;   // a gate of W_hh^T, staged
    for (uint32_t rank = 0; rank < kCluster; ++rank) {
      floats = std::max(floats, layout(rank, rows, P, PZ, d).end);
    }
    const size_t smem = sizeof(float) * static_cast<size_t>(floats);
    if (smem > static_cast<size_t>(max_smem)) break;
    const int n_tiles = (std::max(B, 1) + rows - 1) / rows;
    err = cudaFuncSetAttribute(t->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_tiles * kCluster, std::max(nb, 1));
    cfg.blockDim = dim3(t->threads);
    cfg.dynamicSmemBytes = smem;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, t->kernel, &cfg);
    if (err != cudaSuccess) return err;
    t->rows = rows;
    t->tiles = n_tiles;
    t->smem = smem;
    t->max_clusters = clusters;
    if ((long long)n_tiles * std::max(nb, 1) <= clusters) break;
  }
  return t->rows ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// find_tile's answers, kept per device and shape: the search queries the
// occupancy calculator once for each candidate.
cudaError_t make_tile(int nb, int B, int He, int Hg, int Hs, int Z, Tile* t) {
  struct Entry {
    int key[7];
    Tile tile;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int key[7] = {dev, nb, B, He, Hg, Hs, Z};
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < std::min(used, 64); ++i) {
    if (std::equal(key, key + 7, cache[i].key)) {
      *t = cache[i].tile;
      return cudaFuncSetAttribute(t->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(t->smem));
    }
  }
  err = find_tile(nb, B, He, Hg, Hs, Z, t);
  if (err != cudaSuccess) return err;
  Entry& e = cache[used++ % 64];
  std::copy(key, key + 7, e.key);
  e.tile = *t;
  return cudaSuccess;
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
  if (bad_dims(nb, T, B, He, Hg, Hs, Z)) return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0 || T == 0 || B == 0) return 0;
  Tile t;
  cudaError_t err = make_tile(nb, B, He, Hg, Hs, Z, &t);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const float* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const Dims d{T, B, He, Hg, Hs, Z, t.rows, t.klz, t.zp,
               (3 * He) % 4 == 0 && aligned(xp_e), (3 * Hg) % 4 == 0 && aligned(xp_g)};
  t.kernel<<<dim3(t.tiles * kCluster, nb), t.threads, t.smem, stream>>>(
      xp_e, xp_g, we, be, wg, bg, wpg, bpg, wis, bis, ws, bs, wps, bps, h_real, h_fake, d);
  return static_cast<int>(cudaGetLastError());
}

// The tile of (nb, B, widths) on the current card, for reports: out = {rows,
// tiles a bucket, threads a block, shared bytes a block, clusters of the
// launch, clusters resident at once, KL, S, KLZ}.
extern "C" int multigru_fwd_tile(int nb, int B, int He, int Hg, int Hs, int Z, int* out) {
  if (bad_dims(nb, 1, B, He, Hg, Hs, Z)) return static_cast<int>(cudaErrorInvalidValue);
  Tile t;
  const cudaError_t err = make_tile(nb, B, He, Hg, Hs, Z, &t);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[9] = {t.rows, t.tiles, t.threads, static_cast<int>(t.smem),
                       t.tiles * nb, t.max_clusters, t.kl, t.s, t.klz};
  std::copy(vals, vals + 9, out);
  return 0;
}

// g_phase after a launch with kTimers (zeros without).
extern "C" int multigru_fwd_phases(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase)));
}

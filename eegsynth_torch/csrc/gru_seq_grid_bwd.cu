// GRU sequence kernel K1, wide backward on one cooperative grid, for Hopper,
// sm_90a: hidden widths past what a thread-block cluster holds (H 545 to
// 1024 on the H100), with a leading bucket axis.
//
// Replaces the custom VJP of the TPU kernel, eegsynth/nn/pallas_gru.py
// _gru_seq_bwd (exact reverse-time BPTT), at the widths neither gru_seq.cu
// nor gru_seq_cluster_bwd.cu takes; the wrapper
// (eegsynth_torch/nn/gru_sequence.py, grid_bwd_plan) takes this kernel
// above the cluster backward's cap. Same contract as that backward:
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
// What bounds it: that chain. gru_seq_wide.cu's streaming backward reads all
// of W_hh (3 H^2 floats, 12.6 MB at H 1024) from L2 in every block every
// step (805 MB a step at (1, 768, 64, 1024) on 64 blocks). The grid forward
// (gru_seq_grid.cu) showed that the card's shared memory as a whole holds
// W_hh split into TF32 hi and lo; this kernel turns its scheme round: block
// c of a bucket's G = ceil(H / 8) blocks owns the output units [8 c, 8 c +
// 8) of dh and keeps W_hh's columns of those units (rows 8 c .. 8 c + 7 of
// w_hh_t, each 3H long and contiguous), hi and lo, in its shared memory for
// all T steps (192 Hp bytes, Hp = H padded to 32: 196 KB at H 1024, on 128
// blocks). A step then costs the block's entries of dhp_t written to L2, a
// read of all of dhp_t from L2 (B 3 Hp 4 bytes a block: 101 MB over the
// grid at B 64, H 1024) and the block's product on the tensor cores. The
// whole K = 3H sum of a unit is made in one block in a fixed order, so no
// sum crosses blocks and two calls give the same bits.
//
// Design.
//  - The launch is cooperative (cudaLaunchAttributeCooperative): every block
//    of it is resident at once, or the launch is refused and the wrapper
//    raises. It holds the buckets of one wave (grid G x buckets); the
//    wrapper launches the other waves after it. Where two blocks fit an
//    SM's shared memory (H up to 576 on the H100), the instance for two
//    blocks an SM runs (at most 128 registers a thread), so that a wave
//    holds up to three buckets at H 545; else the instance for a block alone.
//  - The exchange (an all-gather of dhp_t, grid.cuh): two zeroed buffers a
//    bucket of B rows, gate by gate, each gate padded to Hp: entry (g, u) of
//    a row at g Hp + u, so that a block's 8 entries of a gate are one
//    aligned 32-byte segment whatever H is (dhp's own rows are not 16-byte
//    aligned at odd H) and the padding stays zero. Before step T - 1 each
//    block forms dhp_{T-1} of its units from dh_T = 0 and publishes flag 1;
//    in step t it waits until every flag of its bucket is at least T - t
//    (all of dhp_t is in, and every block has finished step t + 1, so the
//    buffer that step t writes, dhp_{t+1}'s, is no longer read), multiplies,
//    forms dhp_{t-1} into the other buffer and publishes T - t + 1. The
//    step's dhp and dxp, which no other block reads, are stored after the
//    publication, so that it does not wait for them.
//  - The product, split-TF32 (x = hi + lo, the products lo.hi, hi.lo and
//    hi.hi, float32 sums) over the depth K = 3 Hp, on the warp-level
//    mma.sync m16n8k8: the batch goes in tiles of 64 rows cut into 16-row
//    tiles, and the block's 8 warps split evenly over a power of two of them
//    (8 warps a tile at up to 16 rows, 4 at 32, 2 at 64); warp v of a tile
//    takes the 16-deep parts p = v mod (its tile's warps), each as the two
//    k-slices 2 p and 2 p + 1. A lane reads its A fragments of a part
//    straight from L2 into registers (ld.global.cg: the rows g and g + 8 of
//    its tile, depth 4 q4 .. 4 q4 + 3 of the part, one float4 each; rows
//    past B repeat row B - 1, their results dropped), several parts ahead
//    of the one it multiplies, without a stage in shared memory and without
//    a barrier between parts; the depth is permuted inside each part as the
//    forward's (phys_k), so that the float4 holds the lane's columns q4 and
//    q4 + 4 of both k-slices. W's B fragments lie in shared memory as the
//    lanes read them, a float4 a lane a k-slice (hi of k-rows q4 and q4 + 4
//    of unit g, then their lo). Each warp keeps three chains (lo.hi, hi.lo,
//    hi.hi), each summed in slice order; its sum hh + (lh + hl) goes to
//    shared memory, and the sums of a tile's warps are added in warp order.
//    (wgmma m64n8k8 with a ring of stages, the first design, ran 31.1 ms at
//    (1, 768, 64, 1024) and 1.92 ms at (1, 101, 9, 545) on the H100, bound
//    by the warpgroup's serial wgmma issue at N 8 and by one 16 KB stage in
//    flight; PERF.md.)
//  - The coefficients: thread (r, q) forms the pairs (row r, units 2 q and 2
//    q + 1) of a 64-row tile: dh_{t-1} = d z + acc (d = dh_t + d_ys_t), then
//    d' = dh_{t-1} + d_ys_{t-1}, dhp_{t-1} = d' (c_r, c_z, c_n) and dxp_{t-1}
//    = d' (c_r, c_z, (1 - z) (1 - n^2)), as the cluster backward does
//    (gru_cell.cuh's sigmoid, the accurate tanhf). Step t - 1's inputs (xp,
//    hp, h_prev, d_ys) are loaded before step t's wait and used after its
//    product, so that their latency hides behind both. d z of a pair is kept
//    from one step to the next in dh0's place (the thread's own address), so
//    that a batch of any size needs no register a tile; at t = 0 dh0 takes
//    dh_{-1}.
//  - The step-chain floor (gru_seq_grid_bwd_chain, a probe for
//    chip_smoke.py and nothing else): the same launch with the
//    coefficients, the product and dhp left out: T steps of the wait, the
//    read of dhp_t from L2 and the publication alone; it writes only its
//    workspace.
// The kernel allocates nothing and does not synchronise.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "grid.cuh"        // the grid's constants, flags, phys_k
#include "gru_cell.cuh"    // sigmoid_fwd
#include "tf32_wgmma.cuh"  // mma_16n8k8, split, zero

namespace {

constexpr int kWarps = kGridThreads / 32;
constexpr int kSlice = 32 * 4;       // W's floats a k-slice: a float4 a lane
// Parts whose dhp rows a lane has in flight: where two blocks share an SM
// (their registers then stop at 128 a thread), and where a block has it alone.
constexpr int kAheadShared = 2;
constexpr int kAheadAlone = 8;

// The product's depth and the exchange's row pitch: three gates of Hp.
int exchange_depth(int H) { return 3 * padded_depth(H); }

// W's fragments (K / 8 k-slices of kSlice floats), then each warp's sums of
// a 16-row tile.
size_t grid_bwd_smem(int H) {
  return sizeof(float) * ((size_t)exchange_depth(H) / 8 * kSlice + kWarps * 16 * kUnits);
}

// The workspace in int32 words: each bucket's flags, then each bucket's two
// buffers of dhp (B rows at pitch 3 Hp).
size_t grid_bwd_workspace(int nb, int B, int H) {
  return (size_t)nb * flag_pitch(grid_blocks(H)) + (size_t)nb * 2 * B * exchange_depth(H);
}

// 16 bytes of the exchange from L2 (the non-coherent L1 never holds them);
// volatile, so that the step-chain probe keeps its reads.
__device__ __forceinline__ float4 ld_cg4(const float* p) {
  float4 v;
  asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p) : "memory");
  return v;
}

// Whether two blocks at H fit an SM's shared memory (smem_sm bytes, reserved
// a block): then the kernel's instance of kAheadShared parts in flight runs,
// else that of kAheadAlone.
bool two_a_sm(int H, int smem_sm, int reserved) {
  return 2 * (grid_bwd_smem(H) + reserved) <= static_cast<size_t>(smem_sm);
}

// hp and dhp may be one buffer (written over in place), so neither is
// __restrict__; each (t, row, entry) of hp is read and then written by the
// same thread. dh0 holds each pair's d z between steps.
template <bool kChain, int kAhead>
__global__ void __launch_bounds__(kGridThreads, kAhead == kAheadShared ? 2 : 1)
gru_grid_bwd_kernel(const float* __restrict__ xp, const float* hp,
                    const float* __restrict__ h_prev, const float* __restrict__ d_ys,
                    const float* __restrict__ w_hh_t, const float* __restrict__ b_hh,
                    float* __restrict__ dxp, float* dhp, float* dh0, int* flags, float* gx,
                    int T, int B, int H, int Hp, int FP) {
  const int KA = 3 * Hp;
  extern __shared__ __align__(128) float grid_bwd_smem_f[];
  float* w = grid_bwd_smem_f;  // (KA / 8, 32 lanes, 4): W's mma fragments, hi and lo
  float* sums = w + (size_t)(KA / 8) * kSlice;  // (8 warps, 16 rows, 8 units)

  const int G3 = 3 * H, G = gridDim.x, c = blockIdx.x;
  const size_t bucket = blockIdx.y;
  xp += bucket * T * B * G3;
  hp += bucket * T * B * G3;
  dxp += bucket * T * B * G3;
  dhp += bucket * T * B * G3;
  h_prev += bucket * T * B * H;
  d_ys += bucket * T * B * H;
  w_hh_t += bucket * H * G3;
  b_hh += bucket * G3;
  dh0 += bucket * B * H;
  flags += bucket * FP;
  gx += bucket * 2 * B * KA;
  const int u0 = c * kUnits;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q4 = lane % 4;  // the lane's mma fragment row and column
  // the thread's (row, unit) pairs of a 64-row tile: row tid / 4, units
  // 2 (tid % 4) and the next
  const int fr = tid / 4, fu = 2 * (tid % 4);

  // W_hh's columns of this block's units in mma B fragments: depth k = gate
  // Hp + m holds w_hh_t[u0 + n, gate H + m], zeros past H in each gate and
  // past the last unit; column j of k-slice kk (logical depth 8 kk + j,
  // physical phys_k) of unit n goes to lane (n, j % 4) of the slice, entry
  // j / 4 for hi and 2 + j / 4 for lo. Read along w_hh_t's rows.
  for (int i = tid; i < KA * kUnits; i += kGridThreads) {
    const int n = i / KA, kl = i % KA, k = phys_k(kl), gate = k / Hp, m = k % Hp;
    const int unit = u0 + n;
    const float v = m < H && unit < H ? w_hh_t[(size_t)unit * G3 + gate * H + m] : 0.f;
    uint32_t hi, lo;
    split(v, hi, lo);
    const int j = kl % 8;
    float* at = w + (size_t)(kl / 8) * kSlice + (n * 4 + j % 4) * 4 + j / 4;
    at[0] = __uint_as_float(hi);
    at[2] = __uint_as_float(lo);
  }
  float bias[3][2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int unit = u0 + fu + e;
#pragma unroll
    for (int gate = 0; gate < 3; ++gate) bias[gate][e] = unit < H ? b_hh[gate * H + unit] : 0.f;
  }

  // rows past B and units past H read row B - 1 and unit H - 1 and write
  // nothing
  auto pair_row = [&](int m0) { return min(m0 + fr, B - 1); };
  auto pair_unit = [&](int eu) { return min(u0 + fu + eu, H - 1); };
  auto live = [&](int m0, int eu) { return m0 + fr < B && u0 + fu + eu < H; };
  // step u's inputs of a pair: xp's and hp's three gates, h_prev, d_ys
  auto load_raw = [&](int u, int row, int unit, float (&v)[8]) {
    const size_t at = ((size_t)u * B + row) * G3 + unit;
    const size_t ah = ((size_t)u * B + row) * H + unit;
    v[0] = xp[at];
    v[1] = xp[at + H];
    v[2] = xp[at + 2 * H];
    v[3] = hp[at];
    v[4] = hp[at + H];
    v[5] = hp[at + 2 * H];
    v[6] = h_prev[ah];
    v[7] = d_ys[ah];
  };
  // the pair's step u from dh_u: dhp_u into the exchange buffer of step u,
  // d z kept in dh0's place, and o = (dhp_u, dxp_u's last gate) for store
  auto form = [&](int u, int row, int unit, int eu, float dh, const float (&v)[8],
                  float (&o)[4]) {
    const float hp_r = v[3] + bias[0][eu], hp_z = v[4] + bias[1][eu];
    const float hp_n = v[5] + bias[2][eu];
    const float rg = sigmoid_fwd(v[0] + hp_r);
    const float zg = sigmoid_fwd(v[1] + hp_z);
    const float ng = tanhf(v[2] + rg * hp_n);
    const float omz = 1.0f - zg;
    const float e = omz * (1.0f - ng * ng);
    const float d = dh + v[7];
    const float d_r = d * ((e * hp_n) * (rg * (1.0f - rg)));
    const float d_z = d * ((v[6] - ng) * (zg * omz));
    const float d_n = d * (e * rg);
    float* gr = gx + (size_t)(u & 1) * B * KA + (size_t)row * KA + unit;
    gr[0] = d_r;
    gr[Hp] = d_z;
    gr[2 * Hp] = d_n;
    dh0[(size_t)row * H + unit] = d * zg;
    o[0] = d_r;
    o[1] = d_z;
    o[2] = d_n;
    o[3] = d * e;
  };
  // dhp_u over hp and dxp_u: no other block reads them, so that the last
  // tile's wait until its step is published
  auto store = [&](int u, int row, int unit, const float (&o)[4]) {
    const size_t at = ((size_t)u * B + row) * G3 + unit;
    dhp[at] = o[0];
    dhp[at + H] = o[1];
    dhp[at + 2 * H] = o[2];
    dxp[at] = o[0];
    dxp[at + H] = o[1];
    dxp[at + 2 * H] = o[3];
  };

  // step T - 1 from dh_T = 0
  if (!kChain && T > 0) {
    for (int m0 = 0; m0 < B; m0 += kTileRows) {
#pragma unroll
      for (int eu = 0; eu < 2; ++eu) {
        if (!live(m0, eu)) continue;
        float v[8], o[4];
        load_raw(T - 1, pair_row(m0), pair_unit(eu), v);
        form(T - 1, pair_row(m0), pair_unit(eu), eu, 0.f, v, o);
        store(T - 1, pair_row(m0), pair_unit(eu), o);
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    st_release(flags + c, 1);  // dhp_{T-1} of these units is in
  }

  const int parts = KA / kPart, last = (B - 1) / kTileRows * kTileRows;
  for (int t = T - 1; t >= 0; --t) {
    const float* gc = gx + (size_t)(t & 1) * B * KA;
    float held[2][4];  // the last tile's pairs' dhp_{t-1}, stored after the publication
    for (int m0 = 0; m0 < B; m0 += kTileRows) {
      const int n = min(kTileRows, B - m0);
      const int nt = (n + 15) / 16;  // 16-row tiles of the mma
      // the warps split evenly over a power of two of tiles: warp (way,
      // ti) takes tile ti's parts p = way mod ways
      const int tiles = nt == 1 ? 1 : nt == 2 ? 2 : 4, ways = kWarps / tiles;
      const int ti = warp % tiles, way = warp / tiles;
      // this thread's pairs: d z of step t, and step t - 1's inputs
      float st[2], raw[2][8];
      if (!kChain) {
#pragma unroll
        for (int eu = 0; eu < 2; ++eu) {
          const int row = pair_row(m0), unit = pair_unit(eu);
          st[eu] = dh0[(size_t)row * H + unit];
          if (t > 0) load_raw(t - 1, row, unit, raw[eu]);
        }
      }
      if (m0 == 0) {  // every block has published dhp_t
        for (int i = tid; i < G; i += kGridThreads) {
          const long long start = clock64();
          while (ld_acquire(flags + i) < T - t) {
            if (clock64() - start > kSpinClocks) __trap();
          }
        }
      }
      __syncthreads();  // the flags seen; the sums of the tile before read

      // the lane's rows 16 ti + g and 16 ti + g + 8 (past n: row n - 1),
      // depth 4 q4 .. 4 q4 + 3 of each part: columns q4 and q4 + 4 of the
      // part's two k-slices
      const float* pa = gc + (size_t)(m0 + min(16 * ti + g, n - 1)) * KA + 4 * q4;
      const float* pb = gc + (size_t)(m0 + min(16 * ti + g + 8, n - 1)) * KA + 4 * q4;
      const int count = ti < nt ? (parts - way + ways - 1) / ways : 0;
      // one chain for each product (lo.hi, hi.lo, hi.hi), each summed in
      // slice order: slices 2 p and 2 p + 1 of each part p in order
      float acc[3][4];
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) zero(acc[pass]);
      float4 va[kAhead], vb[kAhead];
#pragma unroll
      for (int d = 0; d < kAhead; ++d) {
        if (d < count) {
          va[d] = ld_cg4(pa + (way + d * ways) * kPart);
          vb[d] = ld_cg4(pb + (way + d * ways) * kPart);
        }
      }
      for (int k0 = 0; k0 < count; k0 += kAhead) {
#pragma unroll
        for (int d = 0; d < kAhead; ++d) {
          const int k = k0 + d;
          if (k >= count) break;
          const float4 v = va[d], u = vb[d];
          if (k + kAhead < count) {  // the part kAhead on, into the freed registers
            va[d] = ld_cg4(pa + (way + (k + kAhead) * ways) * kPart);
            vb[d] = ld_cg4(pb + (way + (k + kAhead) * ways) * kPart);
          }
          if constexpr (kChain) {
            acc[0][0] += v.x + u.x;  // the step-chain floor waits for the reads too
          } else {
            const int p = way + k * ways;
            const float col[2][4] = {{v.x, u.x, v.y, u.y}, {v.z, u.z, v.w, u.w}};
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              const float4 b = *reinterpret_cast<const float4*>(w + (size_t)(2 * p + s) * kSlice
                                                                + lane * 4);
              const uint32_t bh[2] = {__float_as_uint(b.x), __float_as_uint(b.y)};
              const uint32_t bl[2] = {__float_as_uint(b.z), __float_as_uint(b.w)};
              uint32_t ah[4], al[4];
#pragma unroll
              for (int r = 0; r < 4; ++r) split(col[s][r], ah[r], al[r]);
              mma_16n8k8(acc[0], al, bh);
              mma_16n8k8(acc[1], ah, bl);
              mma_16n8k8(acc[2], ah, bh);
            }
          }
        }
      }

      // each warp's sum hh + (lh + hl) into shared memory, then each pair's
      // sum over its tile's warps in order
      if (ti < nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sums[(warp * 16 + g + 8 * (e / 2)) * kUnits + 2 * q4 + e % 2] =
              acc[2][e] + (acc[0][e] + acc[1][e]);
        }
      }
      __syncthreads();
      if constexpr (!kChain) {
        if (m0 + fr < B) {
          const int at = (fr / 16) * 16 + fr % 16;  // warp fr / 16 (way 0), row fr % 16
          float2 a = *reinterpret_cast<const float2*>(sums + at * kUnits + fu);
          for (int k = 1; k < ways; ++k) {
            const float2 b = *reinterpret_cast<const float2*>(
                sums + (at + k * tiles * 16) * kUnits + fu);
            a.x += b.x;
            a.y += b.y;
          }
          const float sum[2] = {a.x, a.y};
#pragma unroll
          for (int eu = 0; eu < 2; ++eu) {
            if (!live(m0, eu)) continue;
            const int row = pair_row(m0), unit = pair_unit(eu);
            const float dh = st[eu] + sum[eu];
            if (t > 0) {
              form(t - 1, row, unit, eu, dh, raw[eu], held[eu]);
              if (m0 != last) store(t - 1, row, unit, held[eu]);
            } else {
              dh0[(size_t)row * H + unit] = dh;
            }
          }
        }
      }
    }
    __syncthreads();  // every thread's dhp_{t-1} written
    if (tid == 0) {
      __threadfence();
      st_release(flags + c, T - t + 1);
    }
    if (!kChain && t > 0) {
#pragma unroll
      for (int eu = 0; eu < 2; ++eu) {
        if (live(last, eu)) store(t - 1, pair_row(last), pair_unit(eu), held[eu]);
      }
    }
  }
}

bool bad_plan(int nb, int T, int B, int H, int b_first, int nbw, int max_smem) {
  if (nb < 0 || T < 0 || B < 0 || H < 1 || H > kMaxHidden) return true;
  if (nbw < 1 || nbw > 65535 || b_first < 0 || b_first + nbw > std::max(nb, 1)) return true;
  return grid_bwd_smem(H) > static_cast<size_t>(max_smem);
}

template <bool kChain, int kAhead>
cudaError_t grid_bwd_launch(const cudaLaunchConfig_t& cfg, const float* xp, const float* hp,
                            const float* h_prev, const float* d_ys, const float* w_hh_t,
                            const float* b_hh, float* dxp, float* dhp, float* dh0, int* flags,
                            float* gx, int T, int B, int H, int Hp, int FP) {
  const auto kernel = gru_grid_bwd_kernel<kChain, kAhead>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(cfg.dynamicSmemBytes));
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, kernel, xp, hp, h_prev, d_ys, w_hh_t, b_hh, dxp, dhp, dh0,
                            flags, gx, T, B, H, Hp, FP);
}

template <bool kChain>
int grid_bwd_entry(const float* xp, const float* hp, const float* h_prev, const float* d_ys,
                   const float* w_hh_t, const float* b_hh, float* dxp, float* dhp, float* dh0,
                   int* ws, int nb, int T, int B, int H, int b_first, int nbw,
                   cudaStream_t stream) {
  int dev = 0, max_smem = 0, smem_sm = 0, reserved = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_plan(nb, T, B, H, b_first, nbw, max_smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb == 0 || T == 0 || B == 0) return 0;
  const int G = grid_blocks(H), FP = flag_pitch(G), Hp = padded_depth(H);
  const size_t f = b_first, big = (size_t)T * B * 3 * H, small = (size_t)T * B * H;
  int* flags = ws + f * FP;
  float* gx = reinterpret_cast<float*>(ws + (size_t)nb * FP) + f * 2 * B * 3 * Hp;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G, nbw);
  cfg.blockDim = dim3(kGridThreads);
  cfg.dynamicSmemBytes = grid_bwd_smem(H);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const auto launch = two_a_sm(H, smem_sm, reserved) ? grid_bwd_launch<kChain, kAheadShared>
                                                     : grid_bwd_launch<kChain, kAheadAlone>;
  err = launch(cfg, xp + f * big, hp + f * big, h_prev + f * small, d_ys + f * small,
               w_hh_t + f * H * 3 * H, b_hh + f * 3 * H, dxp + f * big, dhp + f * big,
               dh0 + f * B * H, flags, gx, T, B, H, Hp, FP);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// (dxp, dhp, dh0) = K1's backward recurrence for buckets [b_first, b_first +
// nbw) of nb, one wave of a grid plan from the wrapper; dhp may be hp
// itself; ws is the zeroed int32 workspace of gru_seq_grid_bwd_workspace
// words for all nb buckets. T = 0 launches nothing (dh0 is left as it was).
// cudaErrorInvalidValue for a plan the kernel does not take,
// cudaErrorCooperativeLaunchTooLarge for one the card cannot hold resident.
extern "C" int gru_seq_grid_bwd(const float* xp, const float* hp, const float* h_prev,
                                const float* d_ys, const float* w_hh_t, const float* b_hh,
                                float* dxp, float* dhp, float* dh0, int* ws, int nb, int T,
                                int B, int H, int b_first, int nbw, cudaStream_t stream) {
  return grid_bwd_entry<false>(xp, hp, h_prev, d_ys, w_hh_t, b_hh, dxp, dhp, dh0, ws, nb, T,
                               B, H, b_first, nbw, stream);
}

// The step-chain floor of the same plan: T steps of the wait, the read of
// dhp_t from L2 and the publication alone (only the workspace is written).
extern "C" int gru_seq_grid_bwd_chain(const float* xp, const float* hp, const float* h_prev,
                                      const float* d_ys, const float* w_hh_t,
                                      const float* b_hh, float* dxp, float* dhp, float* dh0,
                                      int* ws, int nb, int T, int B, int H, int b_first,
                                      int nbw, cudaStream_t stream) {
  return grid_bwd_entry<true>(xp, hp, h_prev, d_ys, w_hh_t, b_hh, dxp, dhp, dh0, ws, nb, T,
                              B, H, b_first, nbw, stream);
}

// int32 words of the workspace of a call at (nb, B, H).
extern "C" long long gru_seq_grid_bwd_workspace(int nb, int B, int H) {
  if (nb < 0 || B < 0 || H < 1) return -1;
  return static_cast<long long>(grid_bwd_workspace(nb, B, H));
}

// The card's numbers the wrapper plans with, as gru_seq_grid_card's for the
// forward: out = {cooperative launches supported (0 or 1), blocks of the
// kernel's instance for two blocks an SM resident on an SM at no dynamic
// shared memory (the other instance runs only where the shared memory holds
// one block an SM)}.
extern "C" int gru_seq_grid_bwd_card(int* out) {
  int dev = 0, coop = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, gru_grid_bwd_kernel<false, kAheadShared>, kGridThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = coop;
  out[1] = blocks;
  return 0;
}

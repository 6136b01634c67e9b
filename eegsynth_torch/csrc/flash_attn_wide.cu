// Flash-attention forward (K3a) for head dims over 128, for Hopper, sm_90a,
// on the tensor cores: full (non-causal) softmax attention in float32, with
// split-TF32 wgmma (tf32_wgmma.cuh). The backward for these heads (K3b,
// K3c) is flash_attn_wide_bwd.cu.
//
// Replaces, for D > 128, the same TPU kernel of eegsynth/nn/attention.py as
// flash_attn_tc.cu's flash_fwd, whose kernel holds whole rows of D columns
// in shared memory and registers and stops at D = 128:
//   K3a  _fa_forward (pallas_call, body _fa_fwd_kernel)
// The same formulas and layout: q, k, v (BH, T, D) float32, lse (BH, T),
// scale = D^-0.5 rounded once to float; s = (q k^T) scale, an online
// softmax over key tiles (keys at or beyond T masked), o = acc / l and
// lse = m + log l, with l = 0 read as 1.
//
// Layout. A block of two warpgroups owns 64 query rows of one b h and one
// group of 256 output columns; warpgroup w owns columns [256 g + 128 w,
// 256 g + 128 w + 128). The grid is (column group, query tile, b h) in one
// dimension, groups fastest, so B H has no limit of its own. Any D >= 1
// (the dispatch gives D > 128) and any T, ragged edges included: rows at
// or beyond T and columns at or beyond D arrive as zeros (cp.async's zero
// fill), nothing is padded in memory, and rows past T and columns past D
// are not written; lse is written by warpgroup 0 of column group 0 alone.
// No atomics: o and lse are the same bits on every run.
//
// Per key tile of kBN = 64 rows:
//  - s = q k^T over D in 64-column chunks, the two warpgroups each taking
//    half of the chunks (a zero chunk pads an odd count); each chunk's
//    product goes into a fresh accumulator added to the warpgroup's partial
//    sum in float32, and the two partial sums are added through shared
//    memory, so both warpgroups hold the same bits of s (x + y is y + x);
//  - both run the same online softmax on their fragment in registers, in
//    base 2 (a thread holds 2 rows, a quad of 4 threads a whole row), so
//    both apply the same alpha and p;
//  - p is split in registers and fed to p v as the register A operand
//    (the accumulator's fragment is the A fragment); v comes as hi/lo col
//    tiles, 64 output columns a step, each step's product into a fresh
//    accumulator folded into the o sums (64 a thread, in registers) after
//    they are scaled by alpha.
// Steps. Each warpgroup copies the raw tiles its own products read with
// cp.async into its one raw stage, splits them, starts the next step's
// copies and multiplies, between named barriers of its own (1 + warpgroup),
// as flash_attn_wide_bwd.cu does: the copies run during the products, and
// the two warpgroups run apart except where they add s. Up to D = 256 the
// own rows' q chunks (two a warpgroup) are copied once and stay raw in
// shared memory; past it they are copied again beside k's for every key
// tile, and a block per column group recomputes s. Either way q's chunk
// goes from its raw tile straight into the thread's A fragments, split in
// registers, and k's chunk becomes a hi/lo row tile. No wgmma sits in a
// branch (ptxas serializes them there): the tiles are picked by offset.
//
// Memory. No scratch. Dynamic shared memory 169,984 bytes: for each
// warpgroup a raw stage of 64 x 68 floats, q's two resident chunks (or,
// past D = 256, q's chunk of the step) and the split tiles of a step
// (2 x 64 x 64 floats; the partial sums of s are swapped through them). At
// (B, H, T, D) = (64, 2, 768, 256): 1,536 blocks, each reading its q rows
// once (64 KB) and 12 key tiles of k and v (128 KB each) from L2, 1.6 MB a
// block, 2.5 GB in all; q, k and v are 101 MB each.
//
// What bounds it: 2 products of 2 B H T^2 D FLOPs, 0.1562 ms at 495 TFLOP/s
// (TF32 dense, H100 SXM at 700 W) at (64, 2, 768, 256); the split triples
// the tensor-core work, so the ceiling there is 0.469 ms. Below that, each
// warpgroup waits for its copies, splits and multiplies in turn, two
// warpgroups (8 warps) a SM hide each other's latencies, and they meet
// twice a key tile to add s. Timers in a probe build showed the copies'
// wait hidden, but the splits and the issue of the copies together longer
// than the wgmma: their shared-memory traffic beside the wgmma's own
// reads is the next limit.
// Tried on an H100 in probe builds and slower or no faster (PERF.md): q
// copied again for every key tile at every D (with the partial sums of s
// in a double-buffered area of their own, one block barrier a tile); q
// split once into resident hi/lo row tiles (A from shared memory); the o
// sums in shared memory; q's chunk split into row tiles each step; two
// copy stages a warpgroup; the next copies issued while the wgmma runs
// (255 registers, spills); the tile loops unrolled to a fixed count.
//
// ptxas (-Xptxas=-v, on the H100 build): 226 registers a thread, no spills.
// The kernel allocates nothing and does not synchronise: the caller owns
// the outputs and the stream.

#include "tf32_wgmma.cuh"

namespace {

constexpr int kThreads = 2 * kWG;               // two warpgroups, one column half each
constexpr int kBN = 64;                         // key rows per tile
constexpr int kDC = 64;                         // columns of D per contraction step
constexpr int kGW = 128;                        // output columns of a warpgroup
constexpr int kCC = 64;                         // output columns per accumulation step
constexpr int kAccSteps = kGW / kCC;
constexpr int kDotRaw = kRows * (kDC + 4);      // floats of one raw chunk tile
constexpr int kAccRaw = kBN * (kCC + 4);        // of one raw v slice
constexpr int kDotTile = kRows * kDC;           // one hi or lo row tile of a chunk
constexpr int kAccTile = kCC * kBN;             // one hi or lo col tile
constexpr int kSwap = kBN / 2 * kWG;            // one warpgroup's partial s
static_assert(kBN == kRows, "the key tile is the query tile's height");
static_assert(kAccRaw <= kDotRaw, "a v slice does not fit the raw stage");

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNeg = -1e30f;

// A warpgroup's shared memory: three raw chunk tiles (the raw stage, k's
// chunk or a v slice, then q's two resident chunks, or past D = 256 q's
// chunk of the step), then the split tiles of one step.
constexpr int kRawF = 3 * kDotRaw;
constexpr int kWgF = kRawF + 2 * kDotTile;
constexpr size_t kSmem = sizeof(float) * 2 * kWgF;
static_assert(kAccTile <= kDotTile, "v's col tiles do not fit the split area");
static_assert(kSwap <= 2 * kDotTile, "a partial s does not fit the split area");

// Column groups of 256 output columns, a block each.
__host__ __device__ __forceinline__ int col_groups(int D) {
  return (D + 2 * kGW - 1) / (2 * kGW);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wide_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int T, int D, float scale, bool vec) {
  const int wg = threadIdx.x / kWG, tid = threadIdx.x % kWG;
  const int warp = tid / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  extern __shared__ __align__(128) float smem[];
  float* raw = smem + wg * kWgF;                // this warpgroup's raw tiles
  float* mine = raw + kRawF;                    // its split tiles
  const float* other = smem + (1 - wg) * kWgF + kRawF;

  const int tiles = (T + kRows - 1) / kRows;
  const int groups = col_groups(D);
  const int grp = blockIdx.x % groups;
  const int r0 = blockIdx.x / groups % tiles * kRows;
  const size_t bh = blockIdx.x / groups / tiles;
  const size_t base = bh * T * D;
  const int col0 = grp * 2 * kGW + wg * kGW;    // this warpgroup's output columns
  // the warpgroups share the contraction over D: warpgroup 0 the first half
  // of the chunks, warpgroup 1 the rest; past nd, zero chunks
  const int nd = (D + kDC - 1) / kDC;
  const int n_dot = (nd + 1) / 2;
  const int c_first = wg * n_dot;
  const int per = n_dot + kAccSteps;
  const int total = (T + kBN - 1) / kBN * per;
  const float scale2 = scale * kLog2e;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;
  // up to 256 columns (two chunks a warpgroup) the own rows' q chunks stay
  // in shared memory, raw, for the whole loop; past that they are copied
  // again beside k's for every key tile
  const bool resident = n_dot <= 2;
  float* qres = raw + kDotRaw;

  // step s's raw tiles of this warpgroup into its stage
  auto issue = [&](int s) {
    const int j0 = s / per * kBN, i = s % per;
    if (i < n_dot) {
      const int c = (c_first + i) * kDC;
      if (!resident) load_cols<kRows, kDC, kWG>(raw + kDotRaw, qb, r0, c, T, D, vec, tid);
      load_cols<kBN, kDC, kWG>(raw, kb, j0, c, T, D, vec, tid);
    } else {
      load_cols<kBN, kCC, kWG>(raw, vb, j0, col0 + (i - n_dot) * kCC, T, D, vec, tid);
    }
  };
  int step = 0;
  // wait for this step's copies
  auto begin = [&]() {
    cp_async_wait<0>();
    bar_sync(kWG, 1 + wg);   // this step's tiles are in; the last step's products are done
  };
  // once the step's tiles are split (and the raw stage read): the next
  // step's copies, which run during this step's products
  auto split_done = [&]() {
    fence_proxy_async();
    bar_sync(kWG, 1 + wg);
    if (step + 1 < total) issue(step + 1);
    cp_async_commit();
  };

  if (resident) {
    for (int i = 0; i < n_dot; ++i)
      load_cols<kRows, kDC, kWG>(qres + i * kDotRaw, qb, r0, (c_first + i) * kDC, T, D, vec,
                                 tid);
  }
  issue(0);
  cp_async_commit();

  float oacc[kGW / 2];
  zero(oacc);
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  for (int j0 = 0; j0 < T; j0 += kBN) {
    // this warpgroup's half of s = q k^T over D, chunk by chunk
    float x[kBN / 2];
    zero(x);
    for (int i = 0; i < n_dot; ++i, ++step) {
      begin();
      // the own rows' chunk from its raw tile straight into the thread's A
      // fragments (rows g, g + 8 of the warp's 16; columns 8 kk + t4,
      // 8 kk + t4 + 4), split in registers; k's chunk as row tiles
      const float* ar = (resident ? qres + i * kDotRaw : raw + kDotRaw) +
                        (16 * warp + g) * (kDC + 4) + t4;
      uint32_t ah[kDC / 8][4], al[kDC / 8][4];
#pragma unroll
      for (int kk = 0; kk < kDC / 8; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split(ar[(8 * (j & 1)) * (kDC + 4) + 8 * kk + 4 * (j >> 1)], ah[kk][j], al[kk][j]);
      split_rows<kBN, kDC, kWG>(raw, mine, mine + kDotTile, tid);
      split_done();
      float part[kBN / 2];
      zero(part);
      fence_regs(part);
      fence_regs(ah);
      fence_regs(al);
      wgmma_fence();
      mma_rs<kBN, kDC / 8>(part, ah, al, mine, mine + kDotTile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(part);
      fence_regs(ah);
      fence_regs(al);
#pragma unroll
      for (int e = 0; e < kBN / 2; ++e) x[e] += part[e];
    }

    // s = the two halves' sum, the same bits in both warpgroups (x + y is
    // y + x)
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) mine[e * kWG + tid] = x[e];
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) x[e] += other[e * kWG + tid];
    __syncthreads();                            // the other warpgroup has read this one's

    // online softmax over the tile in base 2, rows g and g + 8 of the warp's
    // 16; keys at or beyond T are masked
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) {
      const int col = j0 + 8 * (e / 4) + 2 * t4 + (e & 1);
      x[e] = col < T ? x[e] * scale2 : kNeg;
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x[e]);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) {
      const int h = (e >> 1) & 1;
      x[e] = exp2f(x[e] - m[h]);
      sum[h] += x[e];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = alpha[h] * l[h] + sum[h];
    }

    // p v for the warpgroup's 128 columns, 64 at a time, each into a fresh
    // accumulator folded into o after o is scaled by alpha
    uint32_t ph[kBN / 8][4], pl[kBN / 8][4];
    acc_to_frags<kBN / 2>(x, ph, pl);
#pragma unroll
    for (int a = 0; a < kAccSteps; ++a, ++step) {
      begin();
      split_cols<kBN, kCC, kWG>(raw, mine, mine + kAccTile, tid);
      split_done();
      float part[kCC / 2];
      zero(part);
      fence_regs(part);
      fence_regs(ph);
      fence_regs(pl);
      wgmma_fence();
      mma_rs<kCC, kBN / 8>(part, ph, pl, mine, mine + kAccTile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(part);
      fence_regs(ph);
      fence_regs(pl);
#pragma unroll
      for (int e = 0; e < kCC / 2; ++e)
        oacc[kCC / 2 * a + e] = fmaf(oacc[kCC / 2 * a + e], alpha[(e >> 1) & 1], part[e]);
    }
  }

  // o = sums / l and lse = m + log l (l = 0 read as 1); rows at or beyond T
  // and columns at or beyond D are not written, lse by one warpgroup of
  // column group 0
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * warp + g + 8 * h;
    if (r >= T) continue;
    const float l_safe = l[h] == 0.f ? 1.f : l[h];
    float* row = o + base + (size_t)r * D;
#pragma unroll
    for (int e = 0; e < kGW / 2; ++e) {
      if (((e >> 1) & 1) != h) continue;
      const int c = col0 + kCC * (e / (kCC / 2)) + 8 * (e % (kCC / 2) / 4) + 2 * t4 + (e & 1);
      if (c < D) row[c] = oacc[e] / l_safe;
    }
    if (grp == 0 && wg == 0 && t4 == 0)
      lse[bh * T + r] = m[h] * kLn2 + logf(l_safe);
  }
}

// Blocks of the one grid dimension, column groups x query tiles x b h; -1
// for dimensions it does not take.
int blocks(int BH, int T, int D) {
  if (BH < 0 || T < 0 || D < 1) return -1;
  const long long n = (long long)BH * ((T + kRows - 1) / kRows) * col_groups(D);
  return n > INT_MAX ? -1 : static_cast<int>(n);
}

}  // namespace

extern "C" int flash_fwd_wide(const float* q, const float* k, const float* v, float* o,
                              float* lse, int BH, int T, int D, cudaStream_t stream) {
  const int n = blocks(BH, T, D);
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const bool vec = D % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  return launch(flash_fwd_wide_tc_kernel, n, kThreads, kSmem, stream, q, k, v, o, lse, T, D,
                head_scale(D), vec);
}

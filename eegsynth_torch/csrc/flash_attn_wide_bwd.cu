// Flash-attention dq (K3b) and dk/dv (K3c) for head dims over 128, for
// Hopper, sm_90a, on the tensor cores: full (non-causal) softmax attention
// in float32, with split-TF32 wgmma (tf32_wgmma.cuh).
//
// Replaces, for D > 128, the same TPU kernels of eegsynth/nn/attention.py as
// flash_attn_tc.cu, whose kernels hold whole rows of D columns in shared
// memory and registers and stop at D = 128:
//   K3b  _fa_backward's dq pallas_call (body _fa_dq_kernel)
//   K3c  _fa_backward's dk/dv pallas_call (body _fa_dkv_kernel)
// The same formulas and layout: q, k, v, do (BH, T, D) float32, lse and
// delta (BH, T), scale = D^-0.5; p = exp(s - lse), ds = p (do v^T - delta)
// scale; K3b: dq = ds k; K3c: dv = p^T do, dk = ds^T q.
//
// Why D is split two ways. At D = 256 a 64-row tile's q and do as hi/lo
// take 256 KB of shared memory (a block may have 227 KB), and a 64 x 256
// float32 accumulator takes 128 registers a thread, twice that with the
// fresh per-tile accumulator beside it (the limit is 255). So the
// contractions over D (s = q k^T, dp = do v^T) are streamed in chunks of
// kDC = 64 columns, and each warpgroup owns kGW = 128 output columns.
//
// One body, two kernels. A block owns 64 output rows ("own" rows: query
// rows in K3b, key rows in K3c) and walks over the other side in tiles of
// kBN = 64 rows ("streamed": key rows in K3b, query rows in K3c). It has
// two warpgroups, one per role, as K3c in flash_attn_tc.cu:
//  - warpgroup 0 computes s over the chunks of D and p = exp(s - lse) (0
//    for streamed rows at or beyond T); warpgroup 1 computes dp;
//  - they swap p and dp through shared memory (thread t of one warpgroup
//    holds the same elements as thread t of the other) and form
//    ds = p (dp - delta) scale, both the same bits;
//  - K3b: each warpgroup adds ds k to its 128 columns of dq (warpgroup 0
//    columns [256 g, 256 g + 128), warpgroup 1 the next 128), so the block
//    covers 256 columns and S and dP are computed once for both: 3 products
//    per tile pair up to D = 256;
//  - K3c: warpgroup 0 adds p^T do to dv and warpgroup 1 ds^T q to dk, both
//    over the block's 128 columns [128 g, 128 g + 128). The blocks of a key
//    tile's column groups 2c and 2c + 1 form a cluster of two: each
//    computes half of the chunks of s^T and dp^T (a zero chunk pads an odd
//    count), and they add their partial sums through distributed shared
//    memory, so the pair runs 4 products per tile pair and not 6. The
//    partial sums go through the second half of the split area, and the
//    barrier that frees it again is split: a block arrives once it has read
//    the other's sums and waits only before its next split overwrites
//    them. (Four warpgroups in one block would leave 128 registers a
//    thread, too few for a warpgroup's sums, partial and fragments.)
// The grid is (column group, own tile, b h) in one dimension, groups
// fastest (K3c's clusters are neighbouring blocks), so B H has no limit of
// its own; any D >= 1 (the dispatch gives D > 128), ragged D and T
// included: rows at or beyond T and columns at or beyond D arrive as zeros
// (cp.async's zero fill), nothing is padded in memory, and columns past D
// are not written. Each block writes its rows' columns once: no atomics,
// dq, dk, dv are the same bits on every run.
//
// Steps. Per streamed tile the block runs ceil(D / 64) contraction steps
// (K3c: half of them) and 2 accumulation steps of 64 output columns. Each
// warpgroup copies the raw tiles its own products read with cp.async into
// its one raw stage, splits them, starts the next step's copies and
// multiplies, between named barriers of its own (1 + warpgroup): the
// copies run during the products, and the two warpgroups run apart between
// swaps, so one splits while the other's products run:
//  - contraction step: the own rows' chunk of q or do (K3b), k or v (K3c)
//    goes from its raw tile straight into the thread's A fragments, split
//    in registers; the streamed rows' chunk of k or v (K3b), q or do (K3c)
//    is split into a hi/lo row tile; the 64 x 64 product of the chunk goes
//    into a fresh accumulator that is added to s (or dp) in float32, so no
//    tensor-core sum runs over more than 8 k-steps x 3 passes;
//  - accumulation step: the streamed rows' 64 columns of k (K3b) or of do
//    and q (K3c) as a hi/lo col tile; ds (or p) from the registers as the
//    A operand (the accumulator's fragment is the A fragment), into a
//    fresh accumulator added to the warpgroup's output sums in float32.
//    The sums live in shared memory, each thread's 64 at its own
//    addresses: held in registers they pushed the kernels to 255 registers
//    with spills.
// No wgmma sits in a branch (ptxas serializes them there): each warpgroup
// picks its tiles by offset, and the roles differ only in data.
//
// Memory. No scratch. Dynamic shared memory 200,704 bytes: for each
// warpgroup a raw stage of 2 x 64 x 68 floats, the split tiles of one step
// (2 x 64 x 64 floats; p and dp, and K3c's partial sums, are swapped
// through them) and the output sums (64 x 128 floats). At (B, H, T, D) = (64, 2, 768, 256) a
// K3b block reads 320 KB per streamed tile from L2 (256 KB of chunks,
// 64 KB of output-column slices), 3.84 MB over its 12 tiles, 5.9 GB over
// its 1,536 blocks; a K3c block 192 KB per tile, 7.1 GB over 3,072 blocks;
// q, k, v and do are 101 MB each.
//
// What bounds them: the split triples the tensor-core work, so the ceiling
// at (64, 2, 768, 256) is 3 x the products x 0.0781 ms (one product,
// 2 B H T^2 D FLOPs, at 495 TFLOP/s TF32 dense, H100 SXM at 700 W): 0.703 ms
// for K3b (3 products), 0.937 ms for K3c (4). Below that, each warpgroup
// waits for its copies, splits and multiplies in turn, with two
// warpgroups (8 warps) on an SM to hide the latencies; the own rows'
// chunks are copied again for every streamed tile; and the L2 reads above
// are of the order of the products' time. Tried on an H100 and slower
// (PERF.md): with 32-column chunks, three or four copy stages in place of
// two, and 32-column accumulation steps; fetching the tiles through
// registers into double buffers; and the transposed accumulation product
// (the column slice as the register operand, ds as the shared one) was no
// faster.
//
// ptxas (-Xptxas=-v, on the H100 build): 212 registers a thread for K3b,
// 197 for K3c; no spills.
// The kernels allocate nothing and do not synchronise: the caller owns the
// outputs and the stream.

#include "tf32_wgmma.cuh"

namespace {

constexpr int kThreads = 2 * kWG;               // two warpgroups, one per role
constexpr int kBN = 64;                         // streamed rows per tile
constexpr int kDC = 64;                         // columns of D per contraction step
constexpr int kGW = 128;                        // output columns of a warpgroup
constexpr int kCC = 64;                         // output columns per accumulation step
constexpr int kAccSteps = kGW / kCC;
constexpr int kDotRaw = kRows * (kDC + 4);      // floats of one raw chunk tile
constexpr int kAccRaw = kBN * (kCC + 4);        // of one raw column slice
constexpr int kStage = 2 * kDotRaw;             // a warpgroup's raw stage: 2 chunk tiles
constexpr int kDotTile = kRows * kDC;           // one hi or lo row tile of a chunk
constexpr int kAccTile = kCC * kBN;             // one hi or lo col tile
constexpr int kSplit = 2 * kDotTile;            // a warpgroup's split tiles of a step
constexpr int kSwap = kBN / 2 * kWG;            // one warpgroup's p or dp
constexpr int kOut = kGW / 2 * kWG;             // one warpgroup's output sums
constexpr size_t kSmem = sizeof(float) * 2 * (kStage + kSplit + kOut);
static_assert(kBN == kRows, "the streamed tile is the own tile's height");
static_assert(kAccRaw <= kStage, "a column slice does not fit a stage");
static_assert(2 * kAccTile <= kSplit, "two col tiles do not fit the split area");
static_assert(2 * kSwap <= kSplit, "p or dp and K3c's partial sums do not fit");

constexpr float kLog2e = 1.4426950408889634f;

// ---- the K3c cluster: two blocks, one key tile, two column groups -------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The cluster barrier in two halves: every thread of both blocks arrives
// (shared memory written before it is visible to the other block after the
// wait), and waits for all to have arrived.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The float at p's offset in the shared memory of cluster block `rank`.
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_addr(p)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// Column groups a block's output columns fall into: K3b's blocks each
// cover 256, K3c's 128, their count rounded up to the cluster of two (a
// block past D computes its half of the contraction and writes nothing).
template <bool kDkv>
__host__ __device__ __forceinline__ int block_groups(int D) {
  return kDkv ? 2 * ((D + 2 * kGW - 1) / (2 * kGW)) : (D + 2 * kGW - 1) / (2 * kGW);
}

// The block's own rows are read from a0 (warpgroup 0's A: q in K3b, k in
// K3c) and a1 (do, v); the streamed rows from b0 (warpgroup 0's B: k, q)
// and b1 (v, do) for the contractions, and from c0 and c1 (warpgroup 0's
// and 1's B of the accumulation: k and k, do and q). Warpgroup w writes
// out_w (dq and dq; dv and dk). kDkv: K3c (p^T and ds^T are over the
// streamed query rows' lse and delta; one 128-column group a block).
template <bool kDkv>
__device__ __forceinline__ void wide_bwd(
    const float* __restrict__ a0, const float* __restrict__ a1,
    const float* __restrict__ b0, const float* __restrict__ b1,
    const float* __restrict__ c0, const float* __restrict__ c1,
    const float* __restrict__ lse, const float* __restrict__ delta, float* out0,
    float* out1, int T, int D, float scale, bool vec) {
  constexpr int kSpan = kDkv ? kGW : 2 * kGW;   // output columns of a block
  const int wg = threadIdx.x / kWG, tid = threadIdx.x % kWG;
  const int warp = tid / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  // Each warpgroup copies, splits and multiplies its own tiles between
  // barriers of its own (named barrier 1 + wg), so the two run apart
  // between swaps: one splits while the other's products run.
  extern __shared__ __align__(128) float smem[];
  float* raw = smem + wg * kStage;              // this warpgroup's raw stage
  float* sp = smem + 2 * kStage;                // [warpgroup][kSplit]: a step's hi/lo tiles
  float* mine = sp + wg * kSplit;               // this warpgroup's, and its p or dp
  const float* other = sp + (1 - wg) * kSplit;
  // the warpgroup's output sums, [element][thread]: each thread owns its
  // fragment's 64 values, so they take no registers between tiles
  float* acc = sp + 2 * kSplit + wg * kOut;

  const int tiles = (T + kRows - 1) / kRows;
  const int groups = block_groups<kDkv>(D);
  const int grp = blockIdx.x % groups;
  const int r0 = blockIdx.x / groups % tiles * kRows;
  const size_t bh = blockIdx.x / groups / tiles;
  const size_t base = bh * T * D, rbase = bh * T;
  const int col0 = grp * kSpan + (kDkv ? 0 : wg * kGW);   // this warpgroup's columns
  // K3c: the cluster's two blocks share the contraction, rank 0 the first
  // half of the chunks, rank 1 the rest; K3b: a block takes them all
  const int nd = (D + kDC - 1) / kDC;
  const uint32_t rank = kDkv ? cluster_rank() : 0;
  const int n_dot = kDkv ? (nd + 1) / 2 : nd;   // steps a tile; past nd, zero chunks
  const int c_first = rank * n_dot;
  const int per = n_dot + kAccSteps;
  const int total = (T + kBN - 1) / kBN * per;
  const float scale2 = scale * kLog2e;
  const float* own = (wg == 0 ? a0 : a1) + base;
  const float* strm = (wg == 0 ? b0 : b1) + base;
  const float* slices = (wg == 0 ? c0 : c1) + base;

  // step s's raw tiles of this warpgroup into its stage s % 2
  auto issue = [&](int s) {
    float* dst = raw;
    const int j0 = s / per * kBN, i = s % per;
    if (i < n_dot) {
      const int c = (c_first + i) * kDC;
      load_cols<kRows, kDC, kWG>(dst, own, r0, c, T, D, vec, tid);
      load_cols<kBN, kDC, kWG>(dst + kDotRaw, strm, j0, c, T, D, vec, tid);
    } else {
      load_cols<kBN, kCC, kWG>(dst, slices, j0, col0 + (i - n_dot) * kCC, T, D, vec, tid);
    }
  };
  // start the next step's copies, wait for this step's
  int step = 0;
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

  // K3b: lse (base 2) and delta of rows g and g + 8 of the warp's 16 own
  // rows; rows at or beyond T take 0, and with q = do = 0 their ds is 0
  float lse2[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};
  if constexpr (!kDkv) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 16 * warp + g + 8 * h;
      lse2[h] = r < T ? lse[rbase + r] * kLog2e : 0.f;
      dlt[h] = r < T ? delta[rbase + r] : 0.f;
    }
  }

#pragma unroll
  for (int e = 0; e < kGW / 2; ++e) acc[e * kWG + tid] = 0.f;
  issue(0);
  cp_async_commit();
  for (int j0 = 0; j0 < T; j0 += kBN) {
    // s (warpgroup 0) or dp (1) over the chunks of D: rows are own rows,
    // columns the streamed rows j0 + 8 (i / 4) + 2 t4 + i % 2
    float x[kBN / 2];
    zero(x);
    for (int i = 0; i < n_dot; ++i, ++step) {
      begin();
      const float* rs = raw;
      // the own rows' chunk straight from the raw tile into the thread's A
      // fragments (rows g, g + 8 of the warp's 16; columns 8 kk + t4,
      // 8 kk + t4 + 4), split in registers; the streamed rows' as row tiles
      uint32_t ah[kDC / 8][4], al[kDC / 8][4];
      const float* ar = rs + (16 * warp + g) * (kDC + 4) + t4;
#pragma unroll
      for (int kk = 0; kk < kDC / 8; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split(ar[(8 * (j & 1)) * (kDC + 4) + 8 * kk + 4 * (j >> 1)], ah[kk][j], al[kk][j]);
      split_rows<kBN, kDC, kWG>(rs + kDotRaw, mine, mine + kDotTile, tid);
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

    // p (warpgroup 0; 0 for streamed rows at or beyond T) and dp swapped
    // through the split areas, once both warpgroups' products are done;
    // then ds = p (dp - delta) scale in both
    if constexpr (kDkv) {
      // s^T and dp^T: this block's chunks plus the other block's, through
      // the second half of the split area (p and dp go to the first); the
      // barrier is also the block's
      float* partial = mine + kSwap;
#pragma unroll
      for (int e = 0; e < kBN / 2; ++e) partial[e * kWG + tid] = x[e];
      cluster_arrive();
      cluster_wait();
#pragma unroll
      for (int e = 0; e < kBN / 2; ++e) x[e] += ld_cluster(partial + e * kWG + tid, rank ^ 1);
      cluster_arrive();                         // read; waited for before the next split
    } else {
      __syncthreads();
    }
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) {
      const int col = j0 + 8 * (e / 4) + 2 * t4 + (e & 1);
      const bool in = col < T;
      const float l2 = kDkv ? (in ? lse[rbase + col] * kLog2e : 0.f) : lse2[(e >> 1) & 1];
      const float p = in ? exp2f(fmaf(x[e], scale2, -l2)) : 0.f;
      x[e] = wg == 0 ? p : x[e];
      mine[e * kWG + tid] = x[e];
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) {
      const int col = j0 + 8 * (e / 4) + 2 * t4 + (e & 1);
      const float d = kDkv ? (col < T ? delta[rbase + col] : 0.f) : dlt[(e >> 1) & 1];
      const float y = other[e * kWG + tid];
      const float p = wg == 0 ? x[e] : y, dp = wg == 0 ? y : x[e];
      const float ds = p * (dp - d) * scale;
      x[e] = kDkv && wg == 0 ? p : ds;
    }
    __syncthreads();                            // the other warpgroup has read this one's

    // this tile's ds k (K3b), p^T do or ds^T q (K3c) for the warpgroup's
    // columns, 64 at a time, each into a fresh accumulator
    uint32_t fh[kBN / 8][4], fl[kBN / 8][4];
    acc_to_frags<kBN / 2>(x, fh, fl);
#pragma unroll
    for (int a = 0; a < kAccSteps; ++a, ++step) {
      begin();
      // K3c: the other block has read this one's partial sums once the
      // cluster barrier is complete
      if (kDkv && a == 0) cluster_wait();
      split_cols<kBN, kCC, kWG>(raw, mine, mine + kAccTile, tid);
      split_done();
      float part[kCC / 2];
      zero(part);
      fence_regs(part);
      fence_regs(fh);
      fence_regs(fl);
      wgmma_fence();
      mma_rs<kCC, kBN / 8>(part, fh, fl, mine, mine + kAccTile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(part);
      fence_regs(fh);
      fence_regs(fl);
#pragma unroll
      for (int e = 0; e < kCC / 2; ++e) acc[(kCC / 2 * a + e) * kWG + tid] += part[e];
    }
  }

  float* out = wg == 0 ? out0 : out1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * warp + g + 8 * h;
    if (r >= T) continue;
    float* row = out + base + (size_t)r * D;
#pragma unroll
    for (int e = 0; e < kGW / 2; ++e) {
      if (((e >> 1) & 1) != h) continue;
      const int c = col0 + 8 * (e / 4) + 2 * t4 + (e & 1);
      if (c < D) row[c] = acc[e * kWG + tid];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_dq_wide_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ d_o,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* dq, int T, int D, float scale, bool vec) {
  wide_bwd<false>(q, d_o, k, v, k, k, lse, delta, dq, dq, T, D, scale, vec);
}

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
flash_dkv_wide_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ d_o,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* dk, float* dv, int T, int D, float scale, bool vec) {
  wide_bwd<true>(k, v, q, d_o, d_o, q, lse, delta, dv, dk, T, D, scale, vec);
}

// Blocks of the one grid dimension, column groups x own tiles x b h; -1
// for dimensions it does not take.
template <bool kDkv>
int blocks(int BH, int T, int D) {
  if (BH < 0 || T < 0 || D < 1) return -1;
  const long long n = (long long)BH * ((T + kRows - 1) / kRows) * block_groups<kDkv>(D);
  return n > INT_MAX ? -1 : static_cast<int>(n);
}

template <typename Kernel, typename... Args>
int launch_wide(Kernel kernel, int n, const float* q, const float* k, const float* v,
                const float* d_o, int D, cudaStream_t stream, Args... args) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const bool vec = D % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                   aligned16(d_o);
  return launch(kernel, n, kThreads, kSmem, stream, q, k, v, d_o, args..., D,
                head_scale(D), vec);
}

}  // namespace

extern "C" int flash_bwd_dq_wide(const float* q, const float* k, const float* v,
                                 const float* d_o, const float* lse, const float* delta,
                                 float* dq, int BH, int T, int D, cudaStream_t stream) {
  return launch_wide(flash_dq_wide_tc_kernel, blocks<false>(BH, T, D), q, k, v, d_o, D,
                     stream, lse, delta, dq, T);
}

extern "C" int flash_bwd_dkv_wide(const float* q, const float* k, const float* v,
                                  const float* d_o, const float* lse, const float* delta,
                                  float* dk, float* dv, int BH, int T, int D,
                                  cudaStream_t stream) {
  return launch_wide(flash_dkv_wide_tc_kernel, blocks<true>(BH, T, D), q, k, v, d_o, D,
                     stream, lse, delta, dk, dv, T);
}

// Flash-attention forward (K3a), dq (K3b) and dk/dv (K3c) for Hopper,
// sm_90a, on the tensor cores: full (non-causal) softmax attention in float32.
//
// Replaces the TPU kernels of eegsynth/nn/attention.py:
//   K3a  _fa_forward (pallas_call, body _fa_fwd_kernel)
//   K3b  _fa_backward's dq pallas_call (body _fa_dq_kernel)
//   K3c  _fa_backward's dk/dv pallas_call (body _fa_dkv_kernel)
//
//   q, k, v, do (BH, T, D) float32, lse and delta (BH, T), scale = D^-0.5
//   K3a: s = (q k^T) scale, online softmax over key tiles -> o, lse = m + log l
//   K3b, K3c: p = exp(s - lse), ds = p (do v^T - delta) scale,
//        K3b: dq = ds k; K3c: dv = p^T do, dk = ds^T q
// delta = rowsum(do * o) is computed by the caller, as the JAX package does
// in XLA outside its kernels. The primitives below (cp.async tile loads,
// the split, the layouts, wgmma) live in tf32_wgmma.cuh, shared with the
// wide backward kernels.
//
// Products. Every tile product is a warpgroup MMA (wgmma, m64nNk8, TF32
// inputs, float32 sums). TF32 keeps 10 mantissa bits, far outside the 1e-5
// the kernels are held to, so each operand is split as x = hi + lo, hi = x
// and lo = x - hi each rounded to TF32 (to nearest, ties away, on the bits:
// two integer operations, where cvt.rna.tf32.f32 runs at a fraction of the
// rate), and each product is lo.hi + hi.lo + hi.hi: about 2^-21 relative,
// float32's order. The tensor core truncates as it sums, about an ulp per
// k-step, so no accumulator lives across tiles: each tile's P V, dS^T Q or
// P^T dO goes into a fresh accumulator that is folded into the running one
// in float32 (one accumulator over all T / 8 x 3 k-steps would drift by their
// count in ulps).
//
// Layouts. TF32 wgmma takes only K-major operands from shared memory (no
// transpose flag), here in the no-swizzle "core matrix" layout: 8 rows x 16
// bytes contiguous, 8-row groups SBO = 128 bytes apart, 4-value chunks along
// K LBO bytes apart.
//  - "row" tiles (R rows, the D values of a row along K): q and k in K3a;
//    q, do (the A operands), k and v (B of s = q k^T and dp = do v^T) in
//    K3b; k, v (the A operands), q and do (B of s^T = k q^T and
//    dp^T = v do^T) in K3c. Element (r, d) at (d / 4) 4R + 4r + d % 4 floats.
//  - "col" tiles (the transpose: D rows, the R rows along K): v in K3a (B of
//    o += p v), k in K3b (B of dq += ds k), q and do in K3c (B of
//    dk += ds^T q and dv += p^T do).
//    Element (d, r) at (s / 4) 4D + 4d + s % 4 with s the slot of row r:
//    in each group of 8 rows, row 2t sits in slot t and row 2t + 1 in slot
//    t + 4. The accumulator fragment of a wgmma holds columns 2t, 2t + 1 of
//    each group of 8, and the register A fragment wants columns t, t + 4: with
//    the slots permuted the same way in B, the scores' accumulator registers
//    are the next product's A fragment as they are, with no shuffle.
// Tiles land with cp.async (16 bytes a copy when D % 4 == 0 and the rows are
// 16-byte aligned, else 4). Rows at or beyond T and columns at or beyond D
// arrive as zeros (cp.async's zero fill): nothing is padded in memory. D is
// rounded up to DP in {16, 32, 64, 128}, a template parameter; heads wider
// than 128 take flash_attn_wide.cu (K3a) and flash_attn_wide_bwd.cu (K3b,
// K3c). Every grid below, (tile,
// b h), is laid out in one dimension, tiles fastest, so that B H has no
// limit of its own.
//
// K3a: grid (query tile of BM = 128 rows, b h), two warpgroups of 64 rows
// (one at DP = 128, for shared memory). The query tile's hi/lo stay in
// shared memory. Per key tile of BN rows (64; 32 at DP = 128), loaded two
// stages deep as raw rows and split once for both warpgroups: S = Q K^T into
// a 64 x BN accumulator, the online softmax on that fragment in registers
// (in base 2; a thread holds 2 rows, a quad of 4 threads a whole row: two
// shuffles per row for the max and the sum), then P split in registers and
// fed to P V as the register A operand.
//
// K3b: K3a's structure with a second product where the softmax was. Grid
// (query tile of BM = 128 rows, b h), two warpgroups of 64 rows (one at
// DP = 128, for shared memory); the block owns its rows' dq, keeps it in
// registers over the whole loop and writes it once: no atomics, so dq is
// the same bits on every run. The query tile's q and do hi/lo stay in
// shared memory, and each thread holds lse and delta of its two rows in
// registers. Per key tile of BN rows (64 at DP <= 32, 32 at DP = 64, 16 at
// DP = 128, for shared memory: 215,040 bytes at DP = 64), loaded two stages
// deep as raw rows and split once for both warpgroups into k and v row
// tiles and a k col tile: S = Q K^T and dP = dO V^T as one batch of wgmma
// into two 64 x BN accumulators, dS in registers (keys at or beyond T give
// p = 0; query rows at or beyond T have q = do = lse = delta = 0, so dS = 0,
// and are not written), then dS split in registers and fed to dS K as the
// register A operand, into a fresh accumulator folded into dq in float32.
//
// K3c: a pre-pass (flash_dkv_split_kernel) splits q and do once into the
// query tiles of BM rows (32; 16 at DP = 128) the main kernel reads, in
// scratch the caller allocates: row hi, row lo, col hi, col lo for each. The
// main kernel's grid is (64-row key tile, b h); its k and v hi/lo stay in
// shared memory, and two warpgroups split the work by role: warpgroup 0
// computes S^T = K Q^T, P^T (handed to warpgroup 1 through shared memory,
// named barrier 1) and dV += P^T dO; warpgroup 1 dP^T = V dO^T, dS^T and
// dK += dS^T Q; each keeps its accumulator in registers for the whole loop
// over query tiles (copied two stages deep; one at DP = 128) and writes it
// once: no atomics. Query rows at or beyond T give p = ds = 0. Each
// warpgroup picks its operands before the products, so that no wgmma sits
// in a branch (ptxas serializes wgmma in divergent code).
//
// What bounds them: the split triples the tensor-core work, so the ceiling
// is 3 x FLOPs at 495 TFLOP/s (TF32 dense, 700 W): 0.234 ms for K3a,
// 0.351 ms for K3b and 0.469 ms for K3c at (64, 4, 768, 64). Below that, one
// block per SM (shared memory, below) runs the tile loads, the splits, the
// products and the softmax (or dS) of a tile one after the other,
// synchronised at every tile, so the tensor cores idle while the CUDA cores
// work and the other way round; K3b splits each key tile three ways in
// every block (T / BM times per b h); and K3c's blocks each read every query
// tile of their b h (4 x the raw bytes, as hi/lo row and col tiles) from L2.
//
// ptxas (-Xptxas=-v, on the H100 build), DP = 16 / 32 / 64 / 128: K3a 185 /
// 203 / 255 / 255 registers, K3b 158 / 184 / 212 / 234, K3c 72 / 121 / 168
// / 245, its pre-pass 30; no spills. Dynamic shared memory at DP = 64 / 128:
// K3a 200,704 / 198,656 bytes (q hi/lo, k hi/lo, v^T hi/lo, raw k and v in
// two stages), K3b 215,040 / 214,016 bytes (q, do hi/lo, k, v and k^T
// hi/lo, raw k and v in two stages), K3c 205,312 / 200,832 bytes (k, v
// hi/lo, the query tiles, p^T, lse and delta).
// The kernels allocate nothing and do not synchronise: the caller owns the
// outputs, the scratch and the stream.

#include "tf32_wgmma.cuh"

namespace {

constexpr int kMaxD = 128;
constexpr float kNeg = -1e30f;

// ---- K3a ------------------------------------------------------------------------

template <int DP>
struct Fwd {
  static constexpr int NWG = DP == 128 ? 1 : 2;       // warpgroups, 64 query rows each
  static constexpr int NT = NWG * kWG;
  static constexpr int BM = NWG * kRows;               // query rows per block
  static constexpr int BN = DP == 128 ? 32 : 64;      // key rows per tile
  static constexpr int kQ = BM * DP;                   // floats of one q tile
  static constexpr int kK = BN * DP;                   // of one k or v^T tile
  static constexpr int kRaw = BN * (DP + 4);           // of one raw k or v tile
  static constexpr size_t kSmem = sizeof(float) * (2 * kQ + 4 * kK + 4 * kRaw);
  // the raw q tile goes where k and v^T go later
  static_assert(BM * (DP + 4) <= 4 * kK, "raw q tile does not fit");
};

template <int DP>
__global__ void __launch_bounds__(Fwd<DP>::NT, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int T, int D, float scale, bool vec) {
  using F = Fwd<DP>;
  constexpr int BN = F::BN, BM = F::BM, NT = F::NT;
  extern __shared__ __align__(128) float smem[];
  float* qh = smem;
  float* ql = qh + F::kQ;
  float* kh = ql + F::kQ;
  float* kl = kh + F::kK;
  float* vh = kl + F::kK;
  float* vl = vh + F::kK;
  float* raw = vl + F::kK;             // [stage][k, v][BN x (DP + 4)]

  const int wg = threadIdx.x / kWG, warp = threadIdx.x % kWG / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  int q0, bh;
  block_tile<BM>(T, q0, bh);
  const size_t base = (size_t)bh * T * D;
  const int n_tiles = (T + BN - 1) / BN;
  // s and p in base-2 units: exp(x scale - m) = exp2(x scale log2(e) - m2)
  const float scale2 = scale * 1.4426950408889634f;

  load_raw<BM, DP, NT>(kh, q + base, q0, T, D, vec);
  load_raw<BN, DP, NT>(raw, k + base, 0, T, D, vec);
  load_raw<BN, DP, NT>(raw + F::kRaw, v + base, 0, T, D, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split_rows<BM, DP, NT>(kh, qh, ql, threadIdx.x);
  // this warpgroup's 64 rows of the BM-row q tile: 4 floats a row
  const float* wqh = qh + 4 * kRows * wg;
  const float* wql = ql + 4 * kRows * wg;

  float acc[DP / 2];
  zero(acc);
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const float* rk = raw + (j & 1) * 2 * F::kRaw;
    if (j + 1 < n_tiles) {
      float* nk = raw + ((j + 1) & 1) * 2 * F::kRaw;
      load_raw<BN, DP, NT>(nk, k + base, (j + 1) * BN, T, D, vec);
      load_raw<BN, DP, NT>(nk + F::kRaw, v + base, (j + 1) * BN, T, D, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();       // tile j has landed; the last tile's products are done
    split_rows<BN, DP, NT>(rk, kh, kl, threadIdx.x);
    split_cols<BN, DP, NT>(rk + F::kRaw, vh, vl, threadIdx.x);
    fence_proxy_async();
    __syncthreads();

    float s[BN / 2];
    zero(s);
    fence_regs(s);
    wgmma_fence();
    mma_ss<BN, BM, BN, DP / 8>(s, wqh, wql, kh, kl);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // online softmax over this tile, rows g and g + 8 of the warp's 16
    const int k0 = j * BN;
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int col = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
      s[i] = col < T ? s[i] * scale2 : kNeg;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
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
    for (int i = 0; i < BN / 2; ++i) {
      const int h = (i >> 1) & 1;
      s[i] = exp2f(s[i] - m[h]);
      sum[h] += s[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = alpha[h] * l[h] + sum[h];
    }

    // this tile's P V into a fresh accumulator, folded into O in float32:
    // the tensor core truncates as it sums, so a long-lived accumulator
    // would drift by about an ulp per k-step over T / 8 x 3 steps
    uint32_t ph[BN / 8][4], pl[BN / 8][4];
    acc_to_frags<BN / 2>(s, ph, pl);
    float pv[DP / 2];
    zero(pv);
    fence_regs(pv);
    fence_regs(ph);
    fence_regs(pl);
    wgmma_fence();
    mma_rs<DP, BN / 8>(pv, ph, pl, vh, vl);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(pv);
    fence_regs(ph);
    fence_regs(pl);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], pv[i]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + kRows * wg + 16 * warp + g + 8 * h;
    if (r >= T) continue;
    const float l_safe = l[h] == 0.f ? 1.f : l[h];
    float* orow = o + base + (size_t)r * D;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) {
      if (((i >> 1) & 1) != h) continue;
      const int c = 8 * (i / 4) + 2 * t4 + (i & 1);
      if (c < D) orow[c] = acc[i] / l_safe;
    }
    if (t4 == 0)
      lse[(size_t)bh * T + r] = m[h] * 0.6931471805599453f + logf(l_safe);
  }
}

// ---- K3c ------------------------------------------------------------------------

template <int DP>
struct Dkv {
  static constexpr int NT = 2 * kWG;                   // the p/dv and the ds/dk warpgroup
  static constexpr int BM = DP == 128 ? 16 : 32;      // query rows per tile
  static constexpr int STAGES = DP == 128 ? 1 : 2;    // q-side tile buffers
  static constexpr int kKV = kRows * DP;               // floats of one k or v tile
  static constexpr int kQ = BM * DP;                   // of one q or do tile
  // one query tile as the pre-pass writes it and the kernel reads it: q's
  // row hi, row lo, col hi, col lo tiles, then do's
  static constexpr int kTile = 8 * kQ;
  static constexpr size_t kSmem = sizeof(float) * (4 * kKV + STAGES * kTile +
                                                   kRows * BM + 2 * STAGES * BM);
  // the raw k and v tiles go where the query tiles and p^T go
  static_assert(2 * kRows * (DP + 4) <= STAGES * kTile + kRows * BM, "raw k, v do not fit");
};

// K3c's pre-pass: q and do split once into the query tiles the main kernel
// copies (a block of it would otherwise split each of them T / 64 times).
// Grid (query tile x b h, q or do); scratch [q, do][b h][tile][4][BM DP].
template <int DP>
__global__ void __launch_bounds__(kWG)
flash_dkv_split_kernel(const float* __restrict__ q, const float* __restrict__ d_o,
                       float* __restrict__ scratch, int BH, int T, int D, bool vec) {
  constexpr int BM = Dkv<DP>::BM, kQ = Dkv<DP>::kQ;
  __shared__ __align__(16) float raw[BM * (DP + 4)];
  int r0, bh;
  block_tile<BM>(T, r0, bh);
  const float* src = (blockIdx.y == 0 ? q : d_o) + (size_t)bh * T * D;
  float* dst = scratch + (((size_t)blockIdx.y * BH + bh) * ((T + BM - 1) / BM) +
                          r0 / BM) * 4 * kQ;
  load_raw<BM, DP, kWG>(raw, src, r0, T, D, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split_rows<BM, DP, kWG>(raw, dst, dst + kQ, threadIdx.x);
  split_cols<BM, DP, kWG>(raw, dst + 2 * kQ, dst + 3 * kQ, threadIdx.x);
}

template <int DP>
__global__ void __launch_bounds__(Dkv<DP>::NT, 1)
flash_dkv_kernel(const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const float* __restrict__ scratch, float* __restrict__ dk,
                 float* __restrict__ dv, int BH, int T, int D, float scale, bool vec) {
  using F = Dkv<DP>;
  constexpr int BM = F::BM, NT = F::NT, kQ = F::kQ;
  extern __shared__ __align__(128) float smem[];
  float* kh = smem;
  float* kl = kh + F::kKV;
  float* vh = kl + F::kKV;
  float* vl = vh + F::kKV;
  float* tiles = vl + F::kKV;          // [stage][q, do][row hi, row lo, col hi, col lo]
  float* p_x = tiles + F::STAGES * F::kTile;     // p^T, from one warpgroup to the other
  float* rows = p_x + kRows * BM;      // [stage][lse, delta][BM]

  const int wg = threadIdx.x / kWG, tid = threadIdx.x % kWG;
  const int warp = tid / 32, lane = threadIdx.x % 32, t4 = lane % 4;
  int k0, bh;
  block_tile<kRows>(T, k0, bh);
  const size_t base = (size_t)bh * T * D;
  const size_t rbase = (size_t)bh * T;
  const int n_tiles = (T + BM - 1) / BM;
  const float scale2 = scale * 1.4426950408889634f;   // log2(e) scale

  // the block's k and v, through the query tiles' space
  load_raw<kRows, DP, NT>(tiles, k + base, k0, T, D, vec);
  load_raw<kRows, DP, NT>(tiles + kRows * (DP + 4), v + base, k0, T, D, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split_rows<kRows, DP, NT>(tiles, kh, kl, threadIdx.x);
  split_rows<kRows, DP, NT>(tiles + kRows * (DP + 4), vh, vl, threadIdx.x);
  __syncthreads();

  // query tile jj of q and of do (4 kQ floats each, contiguous in the
  // scratch and in shared memory), lse and delta, into buffer st
  auto load_tile = [&](int jj, int st) {
    float* dst = tiles + st * F::kTile;
    for (int z = 0; z < 2; ++z) {
      const float* src = scratch + (((size_t)z * BH + bh) * n_tiles + jj) * 4 * kQ;
      for (int i = threadIdx.x; i < kQ; i += NT)      // 4 kQ floats, 16 bytes a copy
        cp_async16(dst + z * 4 * kQ + 4 * i, src + 4 * i, 16);
    }
    load_vec<BM, NT>(rows + st * 2 * BM, lse + rbase, jj * BM, T);
    load_vec<BM, NT>(rows + st * 2 * BM + BM, delta + rbase, jj * BM, T);
    cp_async_commit();
  };
  load_tile(0, 0);

  float acc[DP / 2];                   // warpgroup 0: dv; warpgroup 1: dk
  zero(acc);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = F::STAGES == 2 ? (j & 1) : 0;
    cp_async_wait<0>();                // the only group in flight is tile j's
    fence_proxy_async();
    __syncthreads();                   // tile j is in; the last tile's products are done
    if (F::STAGES == 2 && j + 1 < n_tiles) load_tile(j + 1, st ^ 1);

    // Warpgroup 0 computes s^T = k q^T, p^T and dv += p^T do; warpgroup 1
    // dp^T = v do^T, ds^T and dk += ds^T q. Each picks its operands here,
    // so that no wgmma sits in a branch (ptxas would serialize them).
    const float* t = tiles + st * F::kTile;
    const float* q_t = t;
    const float* do_t = t + 4 * kQ;
    const float* a_hi = wg == 0 ? kh : vh;
    const float* a_lo = wg == 0 ? kl : vl;
    const float* b_t = wg == 0 ? q_t : do_t;     // row tiles: hi, lo
    const float* c_t = wg == 0 ? do_t : q_t;     // col tiles: hi, lo at + 2 kQ

    // lse (warpgroup 0, in base-2 units) or delta (1) of this thread's
    // query columns
    float rv[BM / 4];
#pragma unroll
    for (int i = 0; i < BM / 4; ++i) {
      rv[i] = rows[st * 2 * BM + wg * BM + 8 * (i / 2) + 2 * t4 + (i & 1)];
      if (wg == 0) rv[i] *= 1.4426950408889634f;
    }

    // s^T (warpgroup 0) or dp^T (1): rows are keys, columns the query rows
    // j BM + 8 (i / 4) + 2 t4 + i % 2
    float x[BM / 2];
    zero(x);
    fence_regs(x);
    wgmma_fence();
    mma_ss<BM, kRows, BM, DP / 8>(x, a_hi, a_lo, b_t, b_t + kQ);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(x);

    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) {
        const int c = 8 * (i / 4) + 2 * t4 + (i & 1);
        x[i] = j * BM + c < T ? exp2f(fmaf(x[i], scale2, -rv[(i / 4) * 2 + (i & 1)])) : 0.f;
        p_x[i * kWG + tid] = x[i];
      }
      bar_arrive(NT);
    } else {
      bar_sync(NT);
#pragma unroll
      for (int i = 0; i < BM / 2; ++i)
        x[i] = p_x[i * kWG + tid] * (x[i] - rv[(i / 4) * 2 + (i & 1)]) * scale;
    }

    // this tile's dv (p^T do) or dk (ds^T q) into a fresh accumulator,
    // folded in in float32 (see K3a)
    uint32_t fh[BM / 8][4], fl[BM / 8][4];
    acc_to_frags<BM / 2>(x, fh, fl);
    float part[DP / 2];
    zero(part);
    fence_regs(part);
    fence_regs(fh);
    fence_regs(fl);
    wgmma_fence();
    mma_rs<DP, BM / 8>(part, fh, fl, c_t + 2 * kQ, c_t + 3 * kQ);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(part);
    fence_regs(fh);
    fence_regs(fl);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] += part[i];

    if (F::STAGES == 1 && j + 1 < n_tiles) {
      __syncthreads();                 // both warpgroups are done with the buffer
      load_tile(j + 1, 0);
    }
  }

  float* out = wg == 0 ? dv : dk;
  const int g = lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = k0 + 16 * warp + g + 8 * h;
    if (r >= T) continue;
    float* row = out + base + (size_t)r * D;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) {
      if (((i >> 1) & 1) != h) continue;
      const int c = 8 * (i / 4) + 2 * t4 + (i & 1);
      if (c < D) row[c] = acc[i];
    }
  }
}

// ---- K3b ------------------------------------------------------------------------

template <int DP>
struct Dq {
  static constexpr int NWG = DP == 128 ? 1 : 2;       // warpgroups, 64 query rows each
  static constexpr int NT = NWG * kWG;
  static constexpr int BM = NWG * kRows;               // query rows per block
  static constexpr int BN = DP == 128 ? 16 : DP == 64 ? 32 : 64;   // key rows per tile
  static constexpr int kQ = BM * DP;                   // floats of one q or do tile
  static constexpr int kK = BN * DP;                   // of one split k or v tile
  static constexpr int kRaw = BN * (DP + 4);           // of one raw k or v tile
  static constexpr size_t kSmem = sizeof(float) * (4 * kQ + 6 * kK + 4 * kRaw);
  // the raw q and do tiles go where the key tiles go later
  static_assert(2 * BM * (DP + 4) <= 6 * kK + 4 * kRaw, "raw q, do do not fit");
};

template <int DP>
__global__ void __launch_bounds__(Dq<DP>::NT, 1)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ d_o,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int T, int D, float scale, bool vec) {
  using F = Dq<DP>;
  constexpr int BN = F::BN, BM = F::BM, NT = F::NT;
  extern __shared__ __align__(128) float smem[];
  float* qh = smem;
  float* ql = qh + F::kQ;
  float* doh = ql + F::kQ;
  float* dol = doh + F::kQ;
  float* kh = dol + F::kQ;             // k as a row tile: B of S = Q K^T
  float* kl = kh + F::kK;
  float* vh = kl + F::kK;              // v as a row tile: B of dP = dO V^T
  float* vl = vh + F::kK;
  float* kch = vl + F::kK;             // k as a col tile: B of dQ += dS K
  float* kcl = kch + F::kK;
  float* raw = kcl + F::kK;            // [stage][k, v][BN x (DP + 4)]

  const int wg = threadIdx.x / kWG, warp = threadIdx.x % kWG / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  int q0, bh;
  block_tile<BM>(T, q0, bh);
  const size_t base = (size_t)bh * T * D;
  const size_t rbase = (size_t)bh * T;
  const int n_tiles = (T + BN - 1) / BN;
  const float scale2 = scale * 1.4426950408889634f;   // log2(e) scale

  // the block's q and do, raw through the key tiles' space, split once
  load_raw<BM, DP, NT>(kh, q + base, q0, T, D, vec);
  load_raw<BM, DP, NT>(kh + BM * (DP + 4), d_o + base, q0, T, D, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split_rows<BM, DP, NT>(kh, qh, ql, threadIdx.x);
  split_rows<BM, DP, NT>(kh + BM * (DP + 4), doh, dol, threadIdx.x);
  __syncthreads();
  load_raw<BN, DP, NT>(raw, k + base, 0, T, D, vec);
  load_raw<BN, DP, NT>(raw + F::kRaw, v + base, 0, T, D, vec);
  cp_async_commit();
  // this warpgroup's 64 rows of the BM-row q and do tiles
  const float* wqh = qh + 4 * kRows * wg;
  const float* wql = ql + 4 * kRows * wg;
  const float* wdoh = doh + 4 * kRows * wg;
  const float* wdol = dol + 4 * kRows * wg;

  // lse (in base-2 units) and delta of rows g and g + 8 of the warp's 16;
  // rows at or beyond T take 0, and with q = do = 0 their ds is 0
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + kRows * wg + 16 * warp + g + 8 * h;
    lse2[h] = r < T ? lse[rbase + r] * 1.4426950408889634f : 0.f;
    dlt[h] = r < T ? delta[rbase + r] : 0.f;
  }

  float acc[DP / 2];
  zero(acc);

  for (int j = 0; j < n_tiles; ++j) {
    const float* rk = raw + (j & 1) * 2 * F::kRaw;
    if (j + 1 < n_tiles) {
      float* nk = raw + ((j + 1) & 1) * 2 * F::kRaw;
      load_raw<BN, DP, NT>(nk, k + base, (j + 1) * BN, T, D, vec);
      load_raw<BN, DP, NT>(nk + F::kRaw, v + base, (j + 1) * BN, T, D, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();       // tile j has landed; the last tile's products are done
    split_rows<BN, DP, NT>(rk, kh, kl, threadIdx.x);
    split_rows<BN, DP, NT>(rk + F::kRaw, vh, vl, threadIdx.x);
    split_cols<BN, DP, NT>(rk, kch, kcl, threadIdx.x);
    fence_proxy_async();
    __syncthreads();

    // S = Q K^T and dP = dO V^T, one batch of wgmma
    float s[BN / 2], dp[BN / 2];
    zero(s);
    zero(dp);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    mma_ss<BN, BM, BN, DP / 8>(s, wqh, wql, kh, kl);
    mma_ss<BN, BM, BN, DP / 8>(dp, wdoh, wdol, vh, vl);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // ds = p (dp - delta) scale, p = exp(s scale - lse) and 0 for keys >= T
    const int k0 = j * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int h = (i >> 1) & 1;
      const int col = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
      const float p = col < T ? exp2f(fmaf(s[i], scale2, -lse2[h])) : 0.f;
      s[i] = p * (dp[i] - dlt[h]) * scale;
    }

    // this tile's dS K into a fresh accumulator, folded in in float32 (see K3a)
    uint32_t fh[BN / 8][4], fl[BN / 8][4];
    acc_to_frags<BN / 2>(s, fh, fl);
    float part[DP / 2];
    zero(part);
    fence_regs(part);
    fence_regs(fh);
    fence_regs(fl);
    wgmma_fence();
    mma_rs<DP, BN / 8>(part, fh, fl, kch, kcl);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(part);
    fence_regs(fh);
    fence_regs(fl);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] += part[i];
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + kRows * wg + 16 * warp + g + 8 * h;
    if (r >= T) continue;
    float* row = dq + base + (size_t)r * D;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) {
      if (((i >> 1) & 1) != h) continue;
      const int c = 8 * (i / 4) + 2 * t4 + (i & 1);
      if (c < D) row[c] = acc[i];
    }
  }
}

// ---- launchers ------------------------------------------------------------------


// Past D = 128 the rows' columns no longer fit; the wide kernels take
// those. The grid's one dimension holds T / 16 (the smallest tile) x B H
// blocks at most.
bool bad_dims(int BH, int T, int D) {
  return BH < 0 || T < 0 || D < 1 || D > kMaxD ||
         (long long)BH * ((T + 15) / 16) > INT_MAX;
}


// Run f with DP, D rounded up to 16, 32, 64 or 128, as a compile-time constant.
template <typename Fn>
auto with_dp(int D, Fn&& f) {
  if (D <= 16) return f(std::integral_constant<int, 16>{});
  if (D <= 32) return f(std::integral_constant<int, 32>{});
  if (D <= 64) return f(std::integral_constant<int, 64>{});
  return f(std::integral_constant<int, 128>{});
}


}  // namespace

extern "C" int flash_fwd(const float* q, const float* k, const float* v,
                         float* o, float* lse, int BH, int T, int D,
                         cudaStream_t stream) {
  if (bad_dims(BH, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0 || T == 0) return 0;
  const bool vec = D % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  return with_dp(D, [&](auto dp) {
    using F = Fwd<decltype(dp)::value>;
    return launch(flash_fwd_kernel<decltype(dp)::value>, (T + F::BM - 1) / F::BM * BH,
                  F::NT, F::kSmem, stream, q, k, v, o, lse, T, D, head_scale(D), vec);
  });
}

extern "C" int flash_bwd_dq(const float* q, const float* k, const float* v,
                            const float* d_o, const float* lse,
                            const float* delta, float* dq, int BH, int T, int D,
                            cudaStream_t stream) {
  if (bad_dims(BH, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0 || T == 0) return 0;
  const bool vec = D % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                   aligned16(d_o);
  return with_dp(D, [&](auto dp) {
    using F = Dq<decltype(dp)::value>;
    return launch(flash_dq_kernel<decltype(dp)::value>, (T + F::BM - 1) / F::BM * BH,
                  F::NT, F::kSmem, stream, q, k, v, d_o, lse, delta, dq, T, D,
                  head_scale(D), vec);
  });
}

// Floats of scratch flash_bwd_dkv needs: q and do split into query tiles.
extern "C" size_t flash_bwd_dkv_scratch(int BH, int T, int D) {
  if (bad_dims(BH, T, D)) return 0;
  return with_dp(D, [&](auto dp) {
    using F = Dkv<decltype(dp)::value>;
    return size_t{2} * BH * ((T + F::BM - 1) / F::BM) * 4 * F::kQ;
  });
}

extern "C" int flash_bwd_dkv(const float* q, const float* k, const float* v,
                             const float* d_o, const float* lse,
                             const float* delta, float* dk, float* dv,
                             float* scratch, int BH, int T, int D,
                             cudaStream_t stream) {
  if (bad_dims(BH, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0 || T == 0) return 0;
  const bool vec = D % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                   aligned16(d_o);
  return with_dp(D, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    using F = Dkv<DP>;
    flash_dkv_split_kernel<DP><<<dim3((T + F::BM - 1) / F::BM * BH, 2), kWG, 0, stream>>>(
        q, d_o, scratch, BH, T, D, vec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch(flash_dkv_kernel<DP>, (T + kRows - 1) / kRows * BH, F::NT, F::kSmem,
                  stream, k, v, lse, delta, static_cast<const float*>(scratch), dk, dv,
                  BH, T, D, head_scale(D), vec);
  });
}

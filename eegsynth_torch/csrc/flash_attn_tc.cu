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
// in XLA outside its kernels.
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
// than 128 take the kernels of flash_attn_wide.cu. Every grid below, (tile,
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
// ptxas (-Xptxas=-v, on the H100 build), DP = 16 / 32 / 64 / 128: K3a 183 /
// 203 / 255 / 255 registers, K3b 158 / 178 / 210 / 232, K3c 69 / 121 / 168
// / 243, its pre-pass 30; no spills. Dynamic shared memory at DP = 64 / 128:
// K3a 200,704 / 198,656 bytes (q hi/lo, k hi/lo, v^T hi/lo, raw k and v in
// two stages), K3b 215,040 / 214,016 bytes (q, do hi/lo, k, v and k^T
// hi/lo, raw k and v in two stages), K3c 205,312 / 200,832 bytes (k, v
// hi/lo, the query tiles, p^T, lse and delta).
// The kernels allocate nothing and do not synchronise: the caller owns the
// outputs, the scratch and the stream.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWG = 128;             // threads of one warpgroup
constexpr int kRows = 64;            // rows of a wgmma tile: a warpgroup's query
                                     // rows in K3a, the block's key rows in K3c
constexpr int kMaxD = 128;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- cp.async: 16 or 4 bytes, zero-filled past src_bytes --------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---- wgmma ------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Named barrier 1 between K3c's two warpgroups: the producer arrives, the
// consumer waits.
__device__ __forceinline__ void bar_arrive(int threads) {
  asm volatile("bar.arrive 1, %0;\n" :: "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(threads) : "memory");
}

// Shared memory written by ordinary stores, read next by wgmma (the async
// proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of r across a wgmma batch.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// Matrix descriptor, no swizzle: start address, LBO (next 4-value chunk
// along K) and SBO (next 8-row group), all in 16-byte units.
__device__ __forceinline__ uint64_t desc(const float* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// Descriptor of k-slice kk (8 values along K) of a tile of R rows: a row
// tile of R rows or a col tile of R = DP rows.
template <int R>
__device__ __forceinline__ uint64_t slice_desc(const float* tile, int kk) {
  return desc(tile + kk * 8 * R, 16 * R, 128);
}

// D(64 x N) += A(64 x 8) B(8 x N), f32 += tf32 x tf32, A and B from shared
// memory (ss) or A from registers (rs). The thread's accumulator element
// 4 j + e is row 16 warp + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4)
// + e % 2.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4],
                                          uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4],
                                          uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// ---- split-TF32 and the tile passes -------------------------------------------

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero,
// as cvt.rna.tf32.f32 rounds; on the bits, in two integer operations at
// full rate (the conversion instruction runs at a fraction of it).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, both TF32 (the bit patterns, as wgmma reads them)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(const float4& x, float4& hi, float4& lo) {
  uint32_t h, l;
  split(x.x, h, l); hi.x = __uint_as_float(h); lo.x = __uint_as_float(l);
  split(x.y, h, l); hi.y = __uint_as_float(h); lo.y = __uint_as_float(l);
  split(x.z, h, l); hi.z = __uint_as_float(h); lo.z = __uint_as_float(l);
  split(x.w, h, l); hi.w = __uint_as_float(h); lo.w = __uint_as_float(l);
}

// Start the copies of rows [r0, r0 + R) of a (T, D) matrix into a raw
// row-major R x DP tile of pitch DP + 4; rows >= T and columns >= D are
// zero-filled. `vec`: D % 4 == 0 and the matrix is 16-byte aligned.
template <int R, int DP, int NT>
__device__ __forceinline__ void load_raw(float* dst, const float* src, int r0,
                                         int T, int D, bool vec) {
  constexpr int P = DP + 4;
  if (vec) {
    constexpr int NC = DP / 4;
    for (int i = threadIdx.x; i < R * NC; i += NT) {
      const int r = i / NC, c = i % NC;
      const bool in = r0 + r < T && 4 * c < D;
      cp_async16(dst + r * P + 4 * c, in ? src + (size_t)(r0 + r) * D + 4 * c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < R * DP; i += NT) {
      const int r = i / DP, d = i % DP;
      const bool in = r0 + r < T && d < D;
      cp_async4(dst + r * P + d, in ? src + (size_t)(r0 + r) * D + d : src, in ? 4 : 0);
    }
  }
}

// A vector of rows [r0, r0 + R) (lse or delta), zero-filled at or beyond T.
template <int R, int NT>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int r0, int T) {
  for (int i = threadIdx.x; i < R; i += NT) {
    const bool in = r0 + i < T;
    cp_async4(dst + i, in ? src + r0 + i : src, in ? 4 : 0);
  }
}

// Raw R x DP tile -> hi/lo row tiles. Eight neighbouring threads take eight
// rows of one 4-value chunk: conflict-free loads (pitch DP + 4) and one
// contiguous 128-byte store each.
template <int R, int DP, int NT>
__device__ __forceinline__ void split_rows(const float* raw, float* hi, float* lo) {
  constexpr int NC = DP / 4;
  for (int i = threadIdx.x; i < R * NC; i += NT) {
    const int r = (i & 7) | ((i / (8 * NC)) << 3);
    const int c = (i >> 3) % NC;
    float4 h, l;
    split4(*reinterpret_cast<const float4*>(raw + r * (DP + 4) + 4 * c), h, l);
    *reinterpret_cast<float4*>(hi + c * 4 * R + 4 * r) = h;
    *reinterpret_cast<float4*>(lo + c * 4 * R + 4 * r) = l;
  }
}

// Raw R x DP tile -> hi/lo col tiles (its transpose, rows slot-permuted in
// groups of 8). A thread gathers rows 8a + par + {0, 2, 4, 6} of column d,
// which are slots 4 par + {0, 1, 2, 3}: one 16-byte store each of hi and lo.
template <int R, int DP, int NT>
__device__ __forceinline__ void split_cols(const float* raw, float* hi, float* lo) {
  constexpr int P = DP + 4;
  for (int i = threadIdx.x; i < R / 4 * DP; i += NT) {
    const int d = i % DP, par = (i / DP) & 1, a = i / (2 * DP);
    const float* col = raw + (8 * a + par) * P + d;
    const float4 x = make_float4(col[0], col[2 * P], col[4 * P], col[6 * P]);
    float4 h, l;
    split4(x, h, l);
    const int chunk = 2 * a + par;
    *reinterpret_cast<float4*>(hi + chunk * 4 * DP + 4 * d) = h;
    *reinterpret_cast<float4*>(lo + chunk * 4 * DP + 4 * d) = l;
  }
}

// Accumulator columns 8 kk + 2t, 2t + 1 of rows g, g + 8 (elements
// 4 kk + 0..3) -> the split A fragment of k-slice kk: (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4) in the slot-permuted order.
template <int N>
__device__ __forceinline__ void acc_to_frags(const float (&acc)[N],
                                             uint32_t (&hi)[N / 4][4],
                                             uint32_t (&lo)[N / 4][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 4; ++kk) {
    split(acc[4 * kk + 0], hi[kk][0], lo[kk][0]);
    split(acc[4 * kk + 2], hi[kk][1], lo[kk][1]);
    split(acc[4 * kk + 1], hi[kk][2], lo[kk][2]);
    split(acc[4 * kk + 3], hi[kk][3], lo[kk][3]);
  }
}

// acc += A B over K = 8 KS values, split-TF32: A and B both hi/lo in shared
// memory (row tiles of RA and RB rows).
template <int N, int RA, int RB, int KS>
__device__ __forceinline__ void mma_ss(float (&acc)[N / 2], const float* a_hi,
                                       const float* a_lo, const float* b_hi,
                                       const float* b_lo) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t ah = slice_desc<RA>(a_hi, kk), al = slice_desc<RA>(a_lo, kk);
    const uint64_t bh = slice_desc<RB>(b_hi, kk), bl = slice_desc<RB>(b_lo, kk);
    Wgmma<N>::ss(acc, al, bh);
    Wgmma<N>::ss(acc, ah, bl);
    Wgmma<N>::ss(acc, ah, bh);
  }
}

// acc += A B, A as split register fragments (KS k-slices), B a col tile of
// N = DP rows, hi/lo.
template <int DP, int KS>
__device__ __forceinline__ void mma_rs(float (&acc)[DP / 2], const uint32_t (&a_hi)[KS][4],
                                       const uint32_t (&a_lo)[KS][4], const float* b_hi,
                                       const float* b_lo) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t bh = slice_desc<DP>(b_hi, kk), bl = slice_desc<DP>(b_lo, kk);
    Wgmma<DP>::rs(acc, a_lo[kk], bh);
    Wgmma<DP>::rs(acc, a_hi[kk], bl);
    Wgmma<DP>::rs(acc, a_hi[kk], bh);
  }
}

// The grid's one dimension runs over tiles of R rows fastest, then b h, so
// that B H has no limit of its own: this block's first row and its b h.
template <int R>
__device__ __forceinline__ void block_tile(int T, int& r0, int& bh) {
  const int tiles = (T + R - 1) / R;
  r0 = (blockIdx.x % tiles) * R;
  bh = blockIdx.x / tiles;
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

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
  split_rows<BM, DP, NT>(kh, qh, ql);
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
    split_rows<BN, DP, NT>(rk, kh, kl);
    split_cols<BN, DP, NT>(rk + F::kRaw, vh, vl);
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
  split_rows<BM, DP, kWG>(raw, dst, dst + kQ);
  split_cols<BM, DP, kWG>(raw, dst + 2 * kQ, dst + 3 * kQ);
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
  split_rows<kRows, DP, NT>(tiles, kh, kl);
  split_rows<kRows, DP, NT>(tiles + kRows * (DP + 4), vh, vl);
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
  split_rows<BM, DP, NT>(kh, qh, ql);
  split_rows<BM, DP, NT>(kh + BM * (DP + 4), doh, dol);
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
    split_rows<BN, DP, NT>(rk, kh, kl);
    split_rows<BN, DP, NT>(rk + F::kRaw, vh, vl);
    split_cols<BN, DP, NT>(rk, kch, kcl);
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

// D^-0.5 rounded once to float, as the JAX package's Python float is.
float head_scale(int D) {
  return static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
}

// Past D = 128 the rows' columns no longer fit; flash_attn_wide.cu takes
// those. The grid's one dimension holds T / 16 (the smallest tile) x B H
// blocks at most.
bool bad_dims(int BH, int T, int D) {
  return BH < 0 || T < 0 || D < 1 || D > kMaxD ||
         (long long)BH * ((T + 15) / 16) > INT_MAX;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Run f with DP, D rounded up to 16, 32, 64 or 128, as a compile-time constant.
template <typename Fn>
auto with_dp(int D, Fn&& f) {
  if (D <= 16) return f(std::integral_constant<int, 16>{});
  if (D <= 32) return f(std::integral_constant<int, 32>{});
  if (D <= 64) return f(std::integral_constant<int, 64>{});
  return f(std::integral_constant<int, 128>{});
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int tiles, int BH, int threads, size_t smem,
           cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<tiles * BH, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
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
    return launch(flash_fwd_kernel<decltype(dp)::value>, (T + F::BM - 1) / F::BM, BH,
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
    return launch(flash_dq_kernel<decltype(dp)::value>, (T + F::BM - 1) / F::BM, BH,
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
    return launch(flash_dkv_kernel<DP>, (T + kRows - 1) / kRows, BH, F::NT, F::kSmem,
                  stream, k, v, lse, delta, static_cast<const float*>(scratch), dk, dv,
                  BH, T, D, head_scale(D), vec);
  });
}

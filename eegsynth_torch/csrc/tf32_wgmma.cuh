// Split-TF32 warpgroup MMA for Hopper (sm_90a): the primitives the
// tensor-core flash-attention kernels share (flash_attn_tc.cu: K3a, K3b and
// K3c for head dims to 128; flash_attn_wide.cu: K3a past 128;
// flash_attn_wide_bwd.cu: K3b and K3c past 128), K1's grid forward
// (gru_seq_grid.cu: N = 24, A from registers) and K1's grid backward
// (gru_seq_grid_bwd.cu: the warp-level mma.sync m16n8k8).
//
// - cp.async copies of raw row-major tiles into shared memory, 16 or 4
//   bytes a copy, zero-filled past the matrix's rows and columns;
// - the split x = hi + lo, both rounded to TF32 on the bits, and the passes
//   that write a raw tile as hi/lo "row" tiles (R rows, the row's values
//   along K) or "col" tiles (the transpose, rows slot-permuted in groups of
//   8 so that an accumulator fragment is the next product's A fragment);
// - matrix descriptors of the no-swizzle core-matrix layout (8 rows x 16
//   bytes contiguous, 8-row groups 128 bytes apart, 4-value chunks along K
//   LBO bytes apart) and wgmma m64nNk8 f32 += tf32 x tf32, A from shared
//   memory (ss) or registers (rs), N = 16, 32, 64 or 128 (and 24: rs);
// - mma.sync m16n8k8 f32 += tf32 x tf32, one warp, all operands in registers;
// - mma_ss and mma_rs, a product over K as three wgmma passes a k-slice
//   (lo.hi + hi.lo + hi.hi: about 2^-21 relative, float32's order);
// - the launch helpers: one grid dimension, the scale D^-0.5.
// See flash_attn_tc.cu's header for the layouts in full.

#pragma once

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

// Named barrier `id` (1 by default: between K3c's two warpgroups, the
// producer arrives, the consumer waits); 0 is __syncthreads'.
__device__ __forceinline__ void bar_arrive(int threads, int id = 1) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_sync(int threads, int id = 1) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
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

// N = 24 (A from registers only): K1's grid forward (gru_seq_grid.cu), whose
// block owns 8 units, three gate columns each.
template <>
struct Wgmma<24> {
  static __device__ __forceinline__ void rs(float (&d)[12], const uint32_t (&a)[4],
                                          uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
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

// D += A B, m16n8k8, f32 += tf32 x tf32 on one warp (mma.sync): A's registers
// hold rows g, g + 8 at column t and t + 4 (g = lane / 4, t = lane % 4), B's
// rows t and t + 4 at column g, D's row g at columns 2 t, 2 t + 1, then row
// g + 8 the same.
__device__ __forceinline__ void mma_16n8k8(float (&d)[4], const uint32_t (&a)[4],
                                           const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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

// Start the copies of rows [r0, r0 + R) x columns [c0, c0 + W) of a (T, D)
// matrix into a raw row-major R x W tile of pitch W + 4; rows >= T and
// columns >= D are zero-filled. `vec`: D % 4 == 0, c0 % 4 == 0 and the
// matrix is 16-byte aligned. NT threads share the copies; this is thread t.
template <int R, int W, int NT>
__device__ __forceinline__ void load_cols(float* dst, const float* src, int r0, int c0,
                                          int T, int D, bool vec, int t) {
  constexpr int P = W + 4;
  if (vec) {
    constexpr int NC = W / 4;
    for (int i = t; i < R * NC; i += NT) {
      const int r = i / NC, c = c0 + 4 * (i % NC);
      const bool in = r0 + r < T && c < D;
      cp_async16(dst + r * P + c - c0, in ? src + (size_t)(r0 + r) * D + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = t; i < R * W; i += NT) {
      const int r = i / W, c = c0 + i % W;
      const bool in = r0 + r < T && c < D;
      cp_async4(dst + r * P + c - c0, in ? src + (size_t)(r0 + r) * D + c : src,
                in ? 4 : 0);
    }
  }
}

// Rows [r0, r0 + R) of a (T, D) matrix, all DP columns (D <= DP).
template <int R, int DP, int NT>
__device__ __forceinline__ void load_raw(float* dst, const float* src, int r0,
                                         int T, int D, bool vec) {
  load_cols<R, DP, NT>(dst, src, r0, 0, T, D, vec, threadIdx.x);
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
// contiguous 128-byte store each. NT threads share the work; this is thread
// t.
template <int R, int DP, int NT>
__device__ __forceinline__ void split_rows(const float* raw, float* hi, float* lo, int t) {
  constexpr int NC = DP / 4;
  for (int i = t; i < R * NC; i += NT) {
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
// NT threads share the work; this is thread t.
template <int R, int DP, int NT>
__device__ __forceinline__ void split_cols(const float* raw, float* hi, float* lo, int t) {
  constexpr int P = DP + 4;
  for (int i = t; i < R / 4 * DP; i += NT) {
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

// ---- launch helpers -----------------------------------------------------------

// D^-0.5 rounded once to float, as the JAX package's Python float is.
float head_scale(int D) {
  return static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Set the kernel's dynamic shared memory, launch blocks x threads on
// the stream and return the launch's CUDA error code.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int blocks, int threads, size_t smem, cudaStream_t stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

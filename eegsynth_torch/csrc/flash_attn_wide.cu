// Flash-attention forward (K3a) for head dims over 128, for Hopper, sm_90a,
// on the CUDA cores: full (non-causal) softmax attention in float32. The
// backward for these heads (K3b, K3c) runs on the tensor cores, in
// flash_attn_wide_bwd.cu.
//
// Replaces, for D > 128, the same TPU kernel of eegsynth/nn/attention.py as
// flash_attn_tc.cu's flash_fwd, whose tensor-core kernel holds its rows' D
// columns in registers and shared memory and stops at D = 128:
//   K3a  _fa_forward (pallas_call, body _fa_fwd_kernel)
// The same formulas and layout: q, k, v (BH, T, D) float32, lse (BH, T),
// scale = D^-0.5; s = (q k^T) scale, online softmax -> o, lse = m + log l.
//
// Layout of the work: a block of 8 warps owns 32 consecutive query rows of
// one b h, 4 rows a warp, and one group of up to 256 output columns; the
// grid is (row tile, column group, b h) in one dimension, so B H has no
// limit of its own. A lane holds its 4 rows' accumulators for 8 columns
// (the group's columns lane + 32 i) in registers for the whole loop and
// writes them once. The keys stream past in tiles of 32 rows, one a lane,
// staged in shared memory 64 columns at a time (pitch 65: lane r reads row
// r without bank conflicts), with the warp's own 4 rows beside them; each
// stage is copied with cp.async while the block computes on the one before
// (two buffers). Per tile each lane first computes the full-D dot products
// s of its key with the warp's 4 rows, chunk by chunk: each staged value of
// the lane's row serves 4 multiply-adds, and the warp's rows come as
// 16-byte broadcast loads. Warp shuffles then give each row's max and sum
// over the tile for the online softmax. The tile's 32 weights a row (p) go
// to shared memory, and the lanes add weights x v tile to their
// accumulators over the group's column chunks. Past 256 columns a block per
// group recomputes the dot products, so D has no limit. No atomics, a fixed
// order of sums: the results are the same bits on every run.
//
// What bounds it: the loads from shared memory that feed the FP32
// multiply-adds (about one load for two multiply-adds), not the FP32 rate;
// 2 products (s, o) of B H T^2 D multiply-adds each, and two barriers a
// staged chunk. A later version would put the products on the tensor cores
// as flash_attn_wide_bwd.cu does, with D split across the loop.
// The kernel allocates nothing and does not synchronise: the caller owns
// the outputs and the stream.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 4;              // output rows of a warp
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kTile = 32;                    // streamed rows of a tile, one a lane
constexpr int kChunk = 64;                   // columns staged at a time
constexpr int kPitch = kChunk + 1;           // floats between a tile's staged rows
constexpr int kCols = 256;                   // output columns of a block
constexpr int kGroupChunks = kCols / kChunk;
constexpr int kLaneCols = kCols / 32;        // accumulators of a lane per row
constexpr int kTileFloats = kTile * kPitch;  // one staged tile (a multiple of 4)
constexpr int kRowFloats = kWarps * kRowsPerWarp * kChunk;   // the block's own rows
constexpr float kNeg = -1e30f;

using Acc = float[kRowsPerWarp][kLaneCols];

// Where this block and warp are: the grid's one dimension runs over row
// tiles fastest, then column groups, then b h.
struct Place {
  size_t bh;
  int row0;       // the warp's first output row
  int live;       // how many of the warp's rows are < T
  int group;      // the block's column group: columns [256 group, 256 group + 256)
};

__device__ __forceinline__ Place my_place(int T, int D) {
  const int tiles = (T + kRowsPerBlock - 1) / kRowsPerBlock;
  const int groups = (D + kCols - 1) / kCols;
  Place p;
  p.bh = blockIdx.x / tiles / groups;
  p.group = blockIdx.x / tiles % groups;
  p.row0 = (blockIdx.x % tiles) * kRowsPerBlock + threadIdx.x / 32 * kRowsPerWarp;
  p.live = max(0, min(kRowsPerWarp, T - p.row0));
  return p;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---- staging: cp.async, 4 bytes a copy, zero-filled -------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src),
                  "r"(in ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Start copying rows [r0, r0 + R) x columns [c0, c0 + n) of a (T, D) matrix
// into dst (row pitch P), NT threads (thread tid) sharing the copy; zeros at
// rows >= T and columns >= n, up to kChunk.
template <int R, int P, int NT>
__device__ __forceinline__ void stage(float* dst, const float* src, int r0, int c0, int n,
                                      int T, int D, int tid) {
  for (int i = tid; i < R * kChunk; i += NT) {
    const int r = i / kChunk, c = i % kChunk;
    const bool in = r0 + r < T && c < n;
    cp_async4(dst + r * P + c, in ? src + (size_t)(r0 + r) * D + c0 + c : src, in);
  }
}

// The block stages a tile of the streamed side.
__device__ __forceinline__ void stage_tile(float* tile, const float* src, int r0, int c0,
                                           int n, int T, int D) {
  stage<kTile, kPitch, kThreads>(tile, src, r0, c0, n, T, D, threadIdx.x);
}

// A warp stages a chunk of its own rows into its part of `rows`.
__device__ __forceinline__ void stage_rows(float* rows, const float* src, int r0, int c0,
                                           int n, int T, int D) {
  stage<kRowsPerWarp, kChunk, 32>(rows + threadIdx.x / 32 * kRowsPerWarp * kChunk, src, r0,
                                  c0, n, T, D, threadIdx.x % 32);
}

// ---- the two products ---------------------------------------------------------------

// s[r] += rows[r, :n] . tile[lane, :n] for the warp's rows r: one staged
// value of the lane's row serves kRowsPerWarp multiply-adds, the rows' four
// values come as one broadcast 16-byte load. Columns past n are zeros up to
// a multiple of 4.
__device__ __forceinline__ void dot_chunk(float (&s)[kRowsPerWarp], const float* rows,
                                          const float* tile, int n) {
  const float* mine = tile + (threadIdx.x % 32) * kPitch;
  const float* own = rows + threadIdx.x / 32 * kRowsPerWarp * kChunk;
  for (int c = 0; c < n; c += 4) {
    const float t0 = mine[c], t1 = mine[c + 1], t2 = mine[c + 2], t3 = mine[c + 3];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(own + r * kChunk + c);
      s[r] = fmaf(x.w, t3, fmaf(x.z, t2, fmaf(x.y, t1, fmaf(x.x, t0, s[r]))));
    }
  }
}

// acc[r][2 q + h] += w[r, :] . tile[:, 32 h + lane], h = 0, 1: chunk q of
// the block's column group (q picks registers, so every q is spelled out).
__device__ __forceinline__ void accumulate(Acc& acc, const float* w, const float* tile,
                                           int q) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int qq = 0; qq < kGroupChunks; ++qq) {
    if (qq != q) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* col = tile + 32 * h + lane;
      float a[kRowsPerWarp] = {};
#pragma unroll 2
      for (int j = 0; j < kTile; j += 4) {
        const float t0 = col[j * kPitch], t1 = col[(j + 1) * kPitch];
        const float t2 = col[(j + 2) * kPitch], t3 = col[(j + 3) * kPitch];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float4 x = *reinterpret_cast<const float4*>(w + r * kTile + j);
          a[r] = fmaf(x.w, t3, fmaf(x.z, t2, fmaf(x.y, t1, fmaf(x.x, t0, a[r]))));
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) acc[r][2 * qq + h] += a[r];
    }
  }
}

// The warp's live rows of acc times 1 / l[r] into out, the (T, D) matrix of
// this b h, at the block's column group.
__device__ __forceinline__ void write_rows(float* out, const Acc& acc, const Place& me,
                                           int D, const float* l) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (r >= me.live) break;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    float* row = out + (size_t)(me.row0 + r) * D + kCols * me.group;
#pragma unroll
    for (int i = 0; i < kLaneCols; ++i) {
      const int c = kChunk * (i / 2) + 32 * (i % 2) + lane;
      if (kCols * me.group + c < D) row[c] = acc[r][i] * inv;
    }
  }
}

// The loop over steps: per streamed tile, the D / 64 chunks of the dot
// products, then the column group's chunks of the accumulation. Step s
// stages into buffer s % 2 while the block computes on the other.
struct Steps {
  int dot, acc, per_tile, total;
  __device__ Steps(int T, int D, int group) {
    dot = (D + kChunk - 1) / kChunk;
    acc = min(kGroupChunks, dot - kGroupChunks * group);
    per_tile = dot + acc;
    total = (T + kTile - 1) / kTile * per_tile;
  }
  // (first streamed row, first column, columns, chunk of the group or -1
  // for a dot chunk) of step s
  __device__ void at(int s, int D, int group, int& r0, int& c0, int& n, int& q) const {
    const int i = s % per_tile;
    r0 = s / per_tile * kTile;
    q = i < dot ? -1 : i - dot;
    c0 = kChunk * (i < dot ? i : kGroupChunks * group + q);
    n = min(kChunk, D - c0);
  }
};

// ---- K3a ------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
flash_fwd_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int T, int D, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* tiles = smem;                               // [buffer][kTileFloats]
  float* rows = tiles + 2 * kTileFloats;             // [buffer][kRowFloats]
  float* w = rows + 2 * kRowFloats;                  // [warp][row][key]
  const Place me = my_place(T, D);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = me.bh * T * D;
  const Steps st(T, D, me.group);
  float* ww = w + warp * kRowsPerWarp * kTile;

  auto issue = [&](int step) {
    int r0, c0, n, qc;
    st.at(step, D, me.group, r0, c0, n, qc);
    const int b = step & 1;
    stage_tile(tiles + b * kTileFloats, (qc < 0 ? k : v) + base, r0, c0, n, T, D);
    if (qc < 0) stage_rows(rows + b * kRowFloats, q + base, me.row0, c0, n, T, D);
    cp_async_commit();
  };

  Acc acc = {};
  float m[kRowsPerWarp], l[kRowsPerWarp], s[kRowsPerWarp] = {};
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) m[r] = kNeg, l[r] = 0.f;
  issue(0);
  for (int step = 0; step < st.total; ++step) {
    if (step + 1 < st.total) {
      issue(step + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                   // step's stage has landed
    int r0, c0, n, qc;
    st.at(step, D, me.group, r0, c0, n, qc);
    const int b = step & 1;
    if (qc < 0) {
      if (c0 == 0) {
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
      }
      dot_chunk(s, rows + b * kRowFloats, tiles + b * kTileFloats, n);
      if (c0 + kChunk >= D) {
        // online softmax over the tile's 32 keys, one a lane, for each row
        const bool key = r0 + lane < T;
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float x = key ? s[r] * scale : kNeg;
          const float m_new = fmaxf(m[r], warp_max(x));
          const float alpha = expf(m[r] - m_new);
          const float p = key ? expf(x - m_new) : 0.f;
          l[r] = fmaf(alpha, l[r], warp_sum(p));
          m[r] = m_new;
          ww[r * kTile + lane] = p;
#pragma unroll
          for (int i = 0; i < kLaneCols; ++i) acc[r][i] *= alpha;
        }
        __syncwarp();
      }
    } else {
      accumulate(acc, ww, tiles + b * kTileFloats, qc);
    }
    __syncthreads();                   // buffer b is free for step + 2
  }
  write_rows(o + base, acc, me, D, l);
  if (me.group == 0 && lane == 0) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
      if (r < me.live)
        lse[me.bh * T + me.row0 + r] = m[r] + logf(l[r] == 0.f ? 1.f : l[r]);
  }
}

// ---- launchers ------------------------------------------------------------------

// Dynamic shared memory: two buffers of the staged tiles and own rows, and
// the weights.
constexpr size_t kFwdSmem = sizeof(float) * (2 * kTileFloats + 2 * kRowFloats +
                                             kWarps * kRowsPerWarp * kTile);

// D^-0.5 rounded once to float, as the JAX package's Python float is.
float head_scale(int D) {
  return static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
}

// The grid's one dimension holds row tiles x column groups x b h blocks.
int blocks(int BH, int T, int D) {
  if (BH < 0 || T < 0 || D < 1) return -1;
  const long long n = (long long)BH * ((T + kRowsPerBlock - 1) / kRowsPerBlock) *
                      ((D + kCols - 1) / kCols);
  return n > INT_MAX ? -1 : static_cast<int>(n);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int n, size_t smem, cudaStream_t stream, Args... args) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_fwd_wide(const float* q, const float* k, const float* v, float* o,
                              float* lse, int BH, int T, int D, cudaStream_t stream) {
  return launch(flash_fwd_wide_kernel, blocks(BH, T, D), kFwdSmem, stream, q, k, v, o, lse,
                T, D, head_scale(D));
}

// What K1's two cooperative-grid kernels share (gru_seq_grid.cu, the
// forward past the clusters' cap; gru_seq_grid_bwd.cu, the backward): the
// block's shape, the exchanged operand's padding and its depth's
// permutation inside a 16-deep part, and the flags through which the blocks
// of a bucket exchange one step's operand.
//
// Each bucket's G = ceil(H / 8) blocks own 8 units each. A block publishes
// the operand of its units for a step into a zeroed workspace buffer and
// then, with st.release.gpu (after a __syncthreads and a gpu fence), its
// flag; a block reads the step's operand once every flag of its bucket has
// reached the step (ld.acquire.gpu, one lane a flag), through cp.async.cg or
// ld.global.cg, which reach it in L2. A wait that outlasts kSpinClocks ends
// in __trap().

#pragma once

#include <cuda_runtime.h>

#include "tf32_wgmma.cuh"  // kWG

namespace {

constexpr int kGridThreads = 2 * kWG;  // two warpgroups (the forward: k-slices 2 pp, 2 pp + 1)
constexpr int kUnits = 8;              // a block's units
constexpr int kTileRows = 64;          // batch rows of a tile: a wgmma's M, four mma's
constexpr int kPad = 32;               // the exchanged operand's depth is padded to a multiple of this
constexpr int kPart = 16;              // depth of a lane's float4 pair (two k-slices)
constexpr int kMaxHidden = 1024;       // GRID_MAX_HIDDEN
constexpr long long kSpinClocks = 1LL << 34;

int padded_depth(int H) { return (H + kPad - 1) / kPad * kPad; }
int grid_blocks(int H) { return (H + kUnits - 1) / kUnits; }
int flag_pitch(int G) { return (G + 3) & ~3; }  // a bucket's flags, 16 bytes aligned

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" :: "l"(p), "r"(v) : "memory");
}

// Depth of the operand behind column j of k-slice kk (logical depth 8 kk + j).
__device__ __forceinline__ int phys_k(int kl) {
  const int kk = kl >> 3, j = kl & 7;
  return (kk >> 1) * kPart + (j & 3) * 4 + (kk & 1) * 2 + (j >> 2);
}

}  // namespace

// Thread-block cluster primitives for Hopper (sm_90a) that K2
// (multigru.cu) and K1's cluster route (gru_seq_cluster.cu) share: the
// block's rank in its cluster, the cluster barrier, distributed shared
// memory addresses, mbarriers with transaction counts, and st.async, a
// store into another block's shared memory that completes its bytes on an
// mbarrier there.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32_wgmma.cuh"  // smem_addr

namespace {

constexpr uint32_t kWaitTries = 1u << 28;   // try_waits before a wait is taken as lost

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

}  // namespace

// The kernels' asynchronous copies, clocks and memory-model primitives,
// each behind a small __device__ wrapper: the 1-D bulk copy of the Tensor
// Memory Accelerator (cp.async.bulk, global -> shared memory, no tensor map)
// completing on an mbarrier that counts the transaction bytes, the mbarrier
// itself, the block's dynamic shared memory, %globaltimer and an L2
// prefetch.
//
// Keeping the PTX here lets a host build of a kernel (g++ with each CUDA
// thread a std::thread) replace this one header: a copy becomes a memcpy and
// an mbarrier phase a flag, and the rest of the kernel runs as it is.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The block's dynamic shared memory (all of its shared memory: the kernel
// declares no static __shared__ variables).
__device__ __forceinline__ unsigned char* dynamic_smem() {
  extern __shared__ __align__(128) unsigned char smem_base[];
  return smem_base;
}

// An mbarrier expecting one arrival per phase; visible to the copy engine
// after mbar_fence_init() and a block barrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(1)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The one arrival of the barrier's current phase, which then completes once
// `bytes` more have landed through bulk_copy.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Order this thread's earlier shared-memory accesses, and those the block
// barrier before it published, before the copy engine's later writes.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Bring the 128-byte line at p into L2, without waiting for it.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  return v;
}

}  // namespace

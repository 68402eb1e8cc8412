// Host stand-in of csrc/serve_async.cuh, for the g++ builds of the kernels
// (tests/test_torch_*_standin.py): a bulk copy is a memcpy that lowers its
// mbarrier's pending byte count, mbar_expect_tx raises it, the barrier's
// phase flips when the count is back at zero, and mbar_wait yields to the
// other CUDA threads until the phase flips; the L2 prefetch does nothing. The same functions as the real header, with the same
// alignment rules.
#pragma once
#include <atomic>
#include <chrono>
#include <new>

#include "cuda_runtime.h"

namespace {

struct SBar {
  std::atomic<uint32_t> phase;
  int32_t pending;
};
static_assert(sizeof(SBar) == 8, "an mbarrier is 8 bytes");

inline unsigned char* dynamic_smem() { return si_smem; }

inline void mbar_init(uint64_t* bar) { new (bar) SBar{{0}, 0}; }

inline void mbar_fence_init() {}

inline void mbar_complete(SBar* b) {
  if (b->pending == 0) b->phase.fetch_add(1, std::memory_order_release);
}

inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  SBar* b = reinterpret_cast<SBar*>(bar);
  b->pending += bytes;
  mbar_complete(b);
}

inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  SBar* b = reinterpret_cast<SBar*>(bar);
  while ((b->phase.load(std::memory_order_acquire) & 1) == parity)
    si_yield();
}

inline void fence_async_smem() {}

inline void bulk_copy(void* dst, const void* src, uint32_t bytes,
                      uint64_t* bar) {
  if ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) |
       bytes) & 15)
    abort();
  memcpy(dst, src, bytes);
  SBar* b = reinterpret_cast<SBar*>(bar);
  b->pending -= bytes;
  mbar_complete(b);
}

inline void prefetch_l2(const void*) {}

inline unsigned long long globaltimer() {
  return std::chrono::steady_clock::now().time_since_epoch().count();
}

}  // namespace

// Host stand-in of the CUDA runtime for a g++ build of a kernel: a launch
// runs every CUDA thread of the grid, with barriers for __syncthreads and
// grid.sync and a per-warp exchange for the shuffles. Each CUDA thread is a
// fiber with its own stack, all of them on the launching thread, switched
// round robin wherever one waits (a barrier, an mbarrier): the run takes one
// core however many threads the grid has. x86-64 only (the stack switch).
#pragma once
#if !defined(__x86_64__)
#error "the CUDA stand-in switches stacks in x86-64 assembly"
#endif
#include <math.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>
#include <cstdlib>
#include <functional>
#include <memory>
#include <type_traits>
#include <vector>
#include <initializer_list>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __grid_constant__
#define __shared__ static
#define __align__(n) alignas(n)

struct dim3 { unsigned x = 1, y = 1, z = 1; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint3s { unsigned x, y, z; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
struct alignas(16) int4 { int x, y, z, w; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };

// si_fiber_switch(save, next): push the callee-saved registers, store the
// stack pointer in *save, continue on the stack `next` (SysV x86-64).
extern "C" void si_fiber_switch(void** save, void* next);
asm(R"(
  .text
  .p2align 4
  .hidden si_fiber_switch
  .type si_fiber_switch, @function
si_fiber_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size si_fiber_switch, .-si_fiber_switch
)");
// the launching thread's stack while a fiber runs, and the running fiber's
inline thread_local void* si_main_sp;
inline thread_local void** si_fiber_sp;
// a waiting fiber hands the thread back to the launch's round robin
inline void si_yield() { si_fiber_switch(si_fiber_sp, si_main_sp); }
// all fibers run on one thread, so a barrier is a count and a generation
struct SiBarrier {
  int n, count = 0;
  unsigned gen = 0;
  explicit SiBarrier(int n_) : n(n_) {}
  void arrive_and_wait() {
    const unsigned g = gen;
    if (++count == n) { count = 0; ++gen; return; }
    while (gen == g) si_yield();
  }
};

struct SiBlock { SiBarrier bar; std::vector<unsigned char> smem; SiBlock(int n, size_t s) : bar(n), smem(s + 256) {} };
struct SiWarp { SiBarrier bar{32}; uint32_t buf[32]; };
struct SiGrid { SiBarrier bar; SiGrid(int n) : bar(n) {} };

inline thread_local uint3s threadIdx, blockIdx;
inline thread_local dim3 blockDim, gridDim;
inline thread_local SiBlock* si_block;
inline thread_local SiWarp* si_warp;
inline thread_local SiGrid* si_grid;
inline thread_local unsigned char* si_smem;

inline void __syncthreads() { si_block->bar.arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { si_warp->bar.arrive_and_wait(); }
template <class T> inline T __shfl_xor_sync(unsigned, T v, int off) {
  static_assert(sizeof(T) == 4);
  const int lane = threadIdx.x & 31;
  memcpy(&si_warp->buf[lane], &v, 4);
  si_warp->bar.arrive_and_wait();
  T r;
  memcpy(&r, &si_warp->buf[lane ^ off], 4);
  si_warp->bar.arrive_and_wait();
  return r;
}
template <class T> inline T __shfl_sync(unsigned, T v, int src) {
  static_assert(sizeof(T) == 4);
  const int lane = threadIdx.x & 31;
  memcpy(&si_warp->buf[lane], &v, 4);
  si_warp->bar.arrive_and_wait();
  T r;
  memcpy(&r, &si_warp->buf[src & 31], 4);
  si_warp->bar.arrive_and_wait();
  return r;
}
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __ldcg(const T* p) { return *p; }
inline int __dp4a(int a, int b, int c) {
  for (int i = 0; i < 4; ++i) c += (int)(int8_t)(a >> (8 * i)) * (int)(int8_t)(b >> (8 * i));
  return c;
}
inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
inline float __uint_as_float(unsigned i) { float f; memcpy(&f, &i, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned i; memcpy(&i, &f, 4); return i; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorNotSupported = 801, cudaErrorCooperativeLaunchTooLarge = 720 };
typedef void* cudaStream_t;
enum cudaDeviceAttr { cudaDevAttrCooperativeLaunch, cudaDevAttrMultiProcessorCount, cudaDevAttrMaxSharedMemoryPerBlockOptin };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
struct cudaFuncAttributes { size_t sharedSizeBytes = 0; };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
// a card of 3 SMs with an H100's shared memory per block
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrCooperativeLaunch ? 1 : a == cudaDevAttrMultiProcessorCount ? 3 : 232448;
  return 0;
}
template <class F> cudaError_t cudaFuncSetAttribute(F*, cudaFuncAttribute, int) { return 0; }
template <class F> cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, F*) { a->sharedSizeBytes = 0; return 0; }
template <class F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F*, int, size_t) { *n = 1; return 0; }

struct SiStart { std::function<void()>* fn; SiGrid* grid; SiBlock* block; SiWarp* warp; unsigned b, t, nb, nt; };
// the CUDA thread s's view of the launch, in this OS thread's variables
inline void si_enter(const SiStart* s) {
  threadIdx = {s->t, 0, 0}; blockIdx = {s->b, 0, 0};
  blockDim = dim3(s->nt); gridDim = dim3(s->nb);
  si_grid = s->grid; si_block = s->block; si_warp = s->warp;
  si_smem = (unsigned char*)(((uintptr_t)s->block->smem.data() + 127) & ~(uintptr_t)127);
}
constexpr size_t kSiStack = 512 * 1024;
struct SiFiber { void* sp; bool done; };
inline thread_local SiFiber* si_fiber;
inline thread_local const SiStart* si_fiber_start;
// a fiber's first frame: run the kernel, then leave for good
[[noreturn]] inline void si_fiber_main() {
  (*si_fiber_start->fn)();
  si_fiber->done = true;
  si_yield();
  abort();
}
// launches so far: each launch starts its passes in the other direction
inline unsigned si_launches;
// every CUDA thread of the launch as a fiber, resumed in passes over them
// until all have returned; the passes alternate between ascending and
// descending thread order, and so does the first pass of each launch, so
// that over two launches every stretch between barriers runs once with a
// reader before its writer, whichever of the two threads comes first
inline cudaError_t si_run(std::vector<SiStart>& st) {
  const size_t n = st.size();
  char* stacks = (char*)mmap(nullptr, n * kSiStack, PROT_READ | PROT_WRITE,
                             MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
  if (stacks == MAP_FAILED) abort();
  std::vector<SiFiber> fib(n);
  for (size_t i = 0; i < n; ++i) {
    // a frame that si_fiber_switch's pops and ret enter si_fiber_main from,
    // with the stack aligned as after a call
    void** top = (void**)(stacks + (i + 1) * kSiStack);
    *--top = nullptr;
    *--top = (void*)&si_fiber_main;
    for (int r = 0; r < 6; ++r) *--top = nullptr;
    fib[i] = SiFiber{top, false};
  }
  void** save_main = &si_main_sp;
  const unsigned first = si_launches++ & 1;
  for (size_t left = n, pass = 0; left; ++pass) {
    for (size_t k = 0; k < n; ++k) {
      const size_t i = (pass ^ first) & 1 ? n - 1 - k : k;
      if (fib[i].done) continue;
      si_enter(&st[i]);
      si_fiber = &fib[i];
      si_fiber_start = &st[i];
      si_fiber_sp = &fib[i].sp;
      si_fiber_switch(save_main, fib[i].sp);
      if (fib[i].done) --left;
    }
  }
  munmap(stacks, n * kSiStack);
  return 0;
}
template <class A>
cudaError_t cudaLaunchCooperativeKernel(void (*f)(A), dim3 g, dim3 b, void** args, size_t smem, cudaStream_t);
// a plain launch runs as a cooperative one: every thread of the grid at once
template <class A>
cudaError_t cudaLaunchKernel(void (*f)(A), dim3 g, dim3 b, void** args, size_t smem, cudaStream_t s) {
  return cudaLaunchCooperativeKernel(f, g, b, args, smem, s);
}
template <class A>
cudaError_t cudaLaunchCooperativeKernel(void (*f)(A), dim3 g, dim3 b, void** args, size_t smem, cudaStream_t) {
  using AT = std::remove_cv_t<std::remove_reference_t<A>>;
  AT arg = *static_cast<AT*>(args[0]);
  std::function<void()> fn = [&] { f(arg); };
  const unsigned nb = g.x, nt = b.x;
  SiGrid grid(nb * nt);
  std::vector<std::unique_ptr<SiBlock>> blocks;
  std::vector<std::unique_ptr<SiWarp>> warps;
  for (unsigned i = 0; i < nb; ++i) blocks.emplace_back(new SiBlock(nt, smem));
  for (unsigned i = 0; i < nb * nt / 32; ++i) warps.emplace_back(new SiWarp);
  std::vector<SiStart> st(nb * nt);
  for (unsigned i = 0; i < nb * nt; ++i)
    st[i] = SiStart{&fn, &grid, blocks[i / nt].get(), warps[i / 32].get(), i / nt, i % nt, nb, nt};
  return si_run(st);
}

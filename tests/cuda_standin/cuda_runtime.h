// Host stand-in of the CUDA runtime for a g++ build of a kernel: a launch
// runs every CUDA thread of the grid as a pthread, with std::barriers for
// __syncthreads and a per-warp exchange for the shuffles.
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>
#include <pthread.h>
#include <atomic>
#include <barrier>
#include <cstdlib>
#include <functional>
#include <memory>
#include <thread>
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

struct SiBlock { std::barrier<> bar; std::vector<unsigned char> smem; SiBlock(int n, size_t s) : bar(n), smem(s + 256) {} };
struct SiWarp { std::barrier<> bar{32}; uint32_t buf[32]; };
struct SiGrid { std::barrier<> bar; SiGrid(int n) : bar(n) {} };

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
inline void* si_thread(void* p) {
  SiStart* s = (SiStart*)p;
  threadIdx = {s->t, 0, 0}; blockIdx = {s->b, 0, 0};
  blockDim = dim3(s->nt); gridDim = dim3(s->nb);
  si_grid = s->grid; si_block = s->block; si_warp = s->warp;
  si_smem = (unsigned char*)(((uintptr_t)s->block->smem.data() + 127) & ~(uintptr_t)127);
  (*s->fn)();
  return nullptr;
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
  std::vector<pthread_t> th(nb * nt);
  pthread_attr_t at; pthread_attr_init(&at); pthread_attr_setstacksize(&at, 512 * 1024);
  for (unsigned i = 0; i < nb * nt; ++i) {
    st[i] = SiStart{&fn, &grid, blocks[i / nt].get(), warps[i / 32].get(), i / nt, i % nt, nb, nt};
    if (pthread_create(&th[i], &at, si_thread, &st[i]) != 0) abort();
  }
  for (auto& t : th) pthread_join(t, nullptr);
  return 0;
}

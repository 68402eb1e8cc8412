// LSTM device code shared by the LSTM-scan and serve kernels: a warp-wide
// dot product, bf16 helpers, the gate nonlinearity and what a layer
// evaluation does with a unit's new state. Each kernel computes its units
// from shared-memory records of its own (lstm_scan.cu, serve_scan.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// x rounded to the nearest bf16 (ties to even), held in float32
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Dot product of one weight row (global, read-only for the launch) with a
// vector in shared memory, reduced across the warp; every lane gets the sum.
__device__ __forceinline__ float warp_dot(const float* __restrict__ w,
                                          const float* v, int n, int lane) {
  float acc = 0.f;
  if ((n & 3) == 0 && aligned16(w) && aligned16(v)) {
    const float4* w4 = reinterpret_cast<const float4*>(w);
    const float4* v4 = reinterpret_cast<const float4*>(v);
    for (int k = lane; k < (n >> 2); k += 32) {
      const float4 a = __ldg(w4 + k);
      const float4 b = v4[k];
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
  } else {
    for (int k = lane; k < n; k += 32) acc = fmaf(__ldg(w + k), v[k], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// The two bf16 values packed in a 32-bit word, as float32 (exact).
__device__ __forceinline__ float bf16_lo(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// What a layer evaluation does with the unit's new state.
enum Commit {
  kCommitAlways = 0,  // write the new (h, c)
  kCommitMasked = 1,  // write the new (h, c) if `mask`, else the old ones
  kCommitNever = 2,   // speculative: leave the state as it is
};

}  // namespace

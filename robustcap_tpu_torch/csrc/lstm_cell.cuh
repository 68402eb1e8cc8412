// LSTM device code shared by the LSTM-scan and serve kernels: a warp-wide
// dot product, bf16 helpers, the gate nonlinearity, and the gate and cell
// update of one hidden unit, with the caller naming where every operand is
// read from and written to.
//
// One warp computes one unit: the four gate rows (i, f, g, o) of [x ; h_prev]
// reduced across the warp, then lane 0 updates the cell. x and h_prev live in
// shared memory; the weights are read-only for the launch (read through the
// non-coherent cache); c and the outputs are global memory written by their
// unit's owner only. The serve kernel computes its units from shared-memory
// records of its own (serve_scan.cu) and takes only the helpers.

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

// One layer evaluation of one LSTM stack. Pointers are per layer.
struct LstmLayer {
  const float* wih;     // [4H, H]
  const float* whh;     // [4H, H]
  const float* bih;     // [4H]
  const float* bhh;     // [4H], or null when bih already holds b_ih + b_hh
  const float* x;       // [H] layer input (shared memory)
  const float* h_prev;  // [H] previous h (shared memory)
  const float* c_in;    // [H] previous c
  float* c_out;         // [H] committed c (may be c_in)
  float* h_out;         // [H] new h, whatever the commit, or null
  float* h_state;       // [H] committed h (the next frame's slot), or null
  const float* h_old;   // [H] the h a unit keeps when it does not commit
                        // (read only when h_state is set)
  int H;
  int commit;           // Commit
  bool mask;            // for kCommitMasked
};

// Gates and cell update of unit j, by one whole warp.
__device__ __forceinline__ void lstm_unit(const LstmLayer& L, int j,
                                          int lane) {
  const int H = L.H;
  float z[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const size_t r = static_cast<size_t>(g) * H + j;
    z[g] = warp_dot(L.wih + r * H, L.x, H, lane) +
           warp_dot(L.whh + r * H, L.h_prev, H, lane);
  }
  if (lane != 0) return;
  float b[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int r = g * H + j;
    b[g] = L.bhh ? L.bih[r] + L.bhh[r] : L.bih[r];
  }
  const float ig = sigmoidf(z[0] + b[0]);
  const float fg = sigmoidf(z[1] + b[1]);
  const float gg = tanhf(z[2] + b[2]);
  const float og = sigmoidf(z[3] + b[3]);
  const float c_old = L.c_in[j];
  const float cn = fg * c_old + ig * gg;
  const float hn = og * tanhf(cn);
  if (L.h_out) L.h_out[j] = hn;
  if (L.commit == kCommitNever) return;
  const bool keep_new = L.commit == kCommitAlways || L.mask;
  L.c_out[j] = keep_new ? cn : c_old;
  if (L.h_state) L.h_state[j] = keep_new ? hn : L.h_old[j];
}

}  // namespace

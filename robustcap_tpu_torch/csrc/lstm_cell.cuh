// LSTM device code shared by the LSTM-scan and serve kernels: warp-wide dot
// products, the gate nonlinearity, and the gate and cell update of one hidden
// unit, with the caller naming where every operand is read from and written
// to.
//
// One warp computes one unit: the four gate rows (i, f, g, o) of [x ; h_prev]
// reduced across the warp, then lane 0 updates the cell. x and h_prev live in
// shared memory; the weights are read-only for the launch (read through the
// non-coherent cache); c and the outputs are global memory written by their
// unit's owner only.
//
// The weight rows come in three types, with the arithmetic of the JAX serve
// kernel's modes (robustcap_tpu/ops/pallas_serve.py):
// - float: float32 products and sums;
// - __nv_bfloat16: the caller rounds x and h_prev to bf16 as it copies them
//   into shared memory, so every product is exact and sums, gates and state
//   stay float32;
// - int8_t: x and h_prev quantized per row by the caller (xq, hq and their
//   scales), int32 sums with __dp4a, the rescale by the row scales in
//   float32, and bf16 rounding where the JAX int8 cell rounds.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// The same for a bf16 weight row; ``v`` holds bf16 values, so each product
// is exact in float32.
__device__ __forceinline__ float warp_dot(const __nv_bfloat16* __restrict__ w,
                                          const float* v, int n, int lane) {
  float acc = 0.f;
  if ((n & 7) == 0 && aligned16(w) && aligned16(v)) {
    const uint4* w8 = reinterpret_cast<const uint4*>(w);
    const float4* v4 = reinterpret_cast<const float4*>(v);
    for (int k = lane; k < (n >> 3); k += 32) {
      const uint4 a = __ldg(w8 + k);
      const float4 b = v4[2 * k];
      const float4 c = v4[2 * k + 1];
      acc = fmaf(bf16_lo(a.x), b.x, acc);
      acc = fmaf(bf16_hi(a.x), b.y, acc);
      acc = fmaf(bf16_lo(a.y), b.z, acc);
      acc = fmaf(bf16_hi(a.y), b.w, acc);
      acc = fmaf(bf16_lo(a.z), c.x, acc);
      acc = fmaf(bf16_hi(a.z), c.y, acc);
      acc = fmaf(bf16_lo(a.w), c.z, acc);
      acc = fmaf(bf16_hi(a.w), c.w, acc);
    }
  } else {
    for (int k = lane; k < n; k += 32)
      acc = fmaf(__bfloat162float(w[k]), v[k], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// An int8 weight row against an int8 vector in shared memory: the exact
// int32 sum, reduced across the warp (|sum| <= 127 * 127 * n < 2^31).
__device__ __forceinline__ int warp_dot_i8(const int8_t* __restrict__ w,
                                           const int8_t* v, int n, int lane) {
  int acc = 0;
  if ((n & 15) == 0 && aligned16(w) && aligned16(v)) {
    const int4* w16 = reinterpret_cast<const int4*>(w);
    const int4* v16 = reinterpret_cast<const int4*>(v);
    for (int k = lane; k < (n >> 4); k += 32) {
      const int4 a = __ldg(w16 + k);
      const int4 b = v16[k];
      acc = __dp4a(a.x, b.x, acc);
      acc = __dp4a(a.y, b.y, acc);
      acc = __dp4a(a.z, b.z, acc);
      acc = __dp4a(a.w, b.w, acc);
    }
  } else {
    for (int k = lane; k < n; k += 32)
      acc += static_cast<int>(__ldg(w + k)) * static_cast<int>(v[k]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
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
template <class W>
struct LstmLayerT {
  const W* wih;         // [4H, H]
  const W* whh;         // [4H, H]
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
  // int8 rows only: per-row scales of wih and whh [4H], x and h_prev
  // quantized (shared memory) and their scales
  const float* sih;
  const float* shh;
  const int8_t* xq;
  const int8_t* hq;
  float sx, sh;
};
using LstmLayer = LstmLayerT<float>;

// Gates and cell update of unit j, by one whole warp.
template <class W>
__device__ __forceinline__ void lstm_unit(const LstmLayerT<W>& L, int j,
                                          int lane) {
  const int H = L.H;
  float c_old, cn, hn;
  if constexpr (std::is_same<W, int8_t>::value) {
    int zx[4], zh[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const size_t r = static_cast<size_t>(g) * H + j;
      zx[g] = warp_dot_i8(L.wih + r * H, L.xq, H, lane);
      zh[g] = warp_dot_i8(L.whh + r * H, L.hq, H, lane);
    }
    if (lane != 0) return;
    // the JAX int8 cell: zx and zh rescaled in float32 and rounded to bf16,
    // their sum and the bias added in bf16; transcendentals in float32
    // rounded to bf16; the cell update in bf16
    float z[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int r = g * H + j;
      const float b = L.bhh ? L.bih[r] + L.bhh[r] : L.bih[r];
      const float x = bf16r(static_cast<float>(zx[g]) * L.sx * L.sih[r]);
      const float h = bf16r(static_cast<float>(zh[g]) * L.sh * L.shh[r]);
      z[g] = bf16r(bf16r(x + h) + bf16r(b));
    }
    const float ig = bf16r(sigmoidf(z[0]));
    const float fg = bf16r(sigmoidf(z[1]));
    const float gg = bf16r(tanhf(z[2]));
    const float og = bf16r(sigmoidf(z[3]));
    c_old = L.c_in[j];
    cn = bf16r(bf16r(fg * bf16r(c_old)) + bf16r(ig * gg));
    hn = bf16r(og * bf16r(tanhf(cn)));
  } else {
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
    c_old = L.c_in[j];
    cn = fg * c_old + ig * gg;
    hn = og * tanhf(cn);
  }
  if (L.h_out) L.h_out[j] = hn;
  if (L.commit == kCommitNever) return;
  const bool keep_new = L.commit == kCommitAlways || L.mask;
  L.c_out[j] = keep_new ? cn : c_old;
  if (L.h_state) L.h_state[j] = keep_new ? hn : L.h_old[j];
}

}  // namespace

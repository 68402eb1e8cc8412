// One LSTM layer's step over B rows in one launch: z = x W_ih^T + h W_hh^T +
// b_ih + b_hh, the gates (i, f, g, o), c' = sigmoid(f) c + sigmoid(i)
// tanh(g) and h' = sigmoid(o) tanh(c'), written straight into the caller's
// rows of the new state (row l of the stack's [L, B, H] tensors).
//
// Replaces no TPU kernel: the JAX package's batched step
// (robustcap_tpu/models/sig_mp.py, vmapped) leaves the layer to XLA, which
// fuses the products' epilogue itself. In plain PyTorch the same layer is
// ~14 launches (two cuBLAS products, the bias sum, eleven elementwise ones);
// the live tick runs 16 layer evaluations at 64 rows, the exported serving
// step 16 at one row.
//
// What bounds it on an H100 at B = 64: the f32 FMAs. A layer of hidden size H
// does 2 B (4H)(2H) operations on 32 H^2 bytes of weights, B / 2 operations a
// byte, above the f32 SIMT ridge (67 TFLOP/s over 3.35 TB/s, 20 a byte) from
// B = 40 on: at H = 512 / 1024 / 1280 a layer is 4.0 / 16.0 / 25.0 us of
// operations against 2.5 / 10.0 / 15.6 us of weight bytes. cuBLAS tiles the
// 64-row product in 64 x 64 or 64 x 128 tiles, 32-80 of them for 132 SMs, and
// runs at about a quarter of the f32 peak; the cell's arithmetic then costs
// eleven more launches. At B = 1 the weight bytes bound it.
//
// Design: each block owns a run of U hidden units with all four gate rows of
// each (4U columns of z), so the cell update needs nothing from another
// block; U is 4, 8 or 10 by H (ops/lstm_cell.py::lstm_cell_plan), 128 blocks
// at H = 512 / 1024 / 1280. A block owns R rows too (8, 16, 32 or 64, the
// fewest that cover B; more rows are more blocks), and walks K = K_in + H in
// tiles of 256 k staged in shared memory, double-buffered: the R rows of
// [x | h] and the block's 4U rows of [W_ih | W_hh], each row one or two
// cp.async.bulk copies onto the stage's mbarrier (serve_async.cuh), issued by
// one thread a row, so that the copy engine and not the threads makes the
// addresses. The block's 8 warps take 32 k of each tile each; a lane holds an
// R / 8 x U tile of f32 FMA accumulators (rows rg + 8 i, columns cg + 4 j, so
// that a warp's 16-byte shared loads touch every bank once: 8 row addresses
// each read by 4 lanes, 4 column addresses each read by 8), and a 16-byte
// load of x a row and of W a column feed 4 R / 8 U FMAs, issued k by k over
// all its accumulators so that neighbouring FMAs are independent. After the
// last tile the warps' partial sums meet in shared memory and the owner
// thread of a (row, unit) adds them in warp order, adds the biases and
// updates the cell. So each output is summed in a fixed order that depends
// on H alone (each warp's k ascending, then the warps in order), with no
// split across blocks and no atomics: a row's bits depend neither on B nor
// on the row's position. Full f32 FMA: no TF32, no fast-math intrinsics.
// (PERF.md holds the variants timed on the H100: shallower tiles, deeper
// rings, per-thread 16-byte cp.async pieces.) Above a row count cuBLAS's
// own tiles fill the card, and the caller runs torch.lstm_cell instead
// (ops/lstm_cell.py::ROWS_DIRECT).
//
// Plain C interface for ctypes: lstm_cell_launch returns the CUDA error code
// of the launch (0 on success). It makes no host read and no synchronizing
// call, so a CUDA graph can capture it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_cell.cuh"
#include "serve_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // the k split inside a block
constexpr int kKw = 32;                // k of a tile a warp takes
constexpr int kKT = kWarps * kKw;      // k of a staged tile
constexpr int kKP = kKT + 4;           // floats of a staged row (padded)
constexpr int kStages = 2;

struct Args {
  const float* x;     // [B, K_in]
  const float* h;     // [B, H]
  const float* c;     // [B, H]
  const float* w_ih;  // [4H, K_in]
  const float* w_hh;  // [4H, H]
  const float* b_ih;  // [4H]
  const float* b_hh;  // [4H]
  float* h_out;       // [B, H]
  float* c_out;       // [B, H]
  int B, K_in, H;
};

__device__ __forceinline__ void cell_update(const Args& a, int b, int u,
                                            float zi, float zf, float zg,
                                            float zo) {
  const float ig = sigmoidf(zi), fg = sigmoidf(zf), gg = tanhf(zg);
  const float og = sigmoidf(zo);
  const size_t at = static_cast<size_t>(b) * a.H + u;
  const float cn = fg * a.c[at] + ig * gg;
  a.c_out[at] = cn;
  a.h_out[at] = og * tanhf(cn);
}

__device__ __forceinline__ float gate_bias(const Args& a, int n) {
  return __ldg(a.b_ih + n) + __ldg(a.b_hh + n);
}

// Issue the copies of tile t (k from t kKT, kte of them) into stage `st`:
// thread r copies row r of [x | h] (r < nr) or, after them, gate row r - nr
// of the block's [W_ih | W_hh], as one or two bulk copies (the tile may
// straddle x and h); thread 0 arms the stage's mbarrier with their bytes.
template <int R, int U>
__device__ __forceinline__ void issue_tile(const Args& a, float* st,
                                           uint64_t* bar, int t, int row0,
                                           int nr, int u0) {
  const int K = a.K_in + a.H;
  const int k0 = t * kKT;
  const int kte = min(kKT, K - k0);
  const int r = threadIdx.x;
  if (r == 0)
    mbar_expect_tx(bar, static_cast<uint32_t>((nr + 4 * U) * kte * 4));
  if (r >= nr + 4 * U) return;
  const float *src_a, *src_b;
  float* dst;
  if (r < nr) {
    const size_t b = row0 + r;
    src_a = a.x + b * a.K_in;
    src_b = a.h + b * a.H;
    dst = st + r * kKP;
  } else {
    const int n = r - nr;
    const size_t g = (n / U) * static_cast<size_t>(a.H) + u0 + n % U;
    src_a = a.w_ih + g * a.K_in;
    src_b = a.w_hh + g * a.H;
    dst = st + (R + n) * kKP;
  }
  fence_async_smem();
  const int ka = min(k0 + kte, a.K_in);
  if (ka > k0) bulk_copy(dst, src_a + k0, (ka - k0) * 4, bar);
  const int kb = max(k0, a.K_in);
  if (k0 + kte > kb)
    bulk_copy(dst + (kb - k0), src_b + (kb - a.K_in), (k0 + kte - kb) * 4,
              bar);
}

// RG = R / 8 rows and U columns of each gate a lane accumulates; R rows and U
// units a block.
template <int RG, int U>
__global__ void __launch_bounds__(kThreads, 1) lstm_cell_kernel(Args a) {
  constexpr int R = 8 * RG, NC = 4 * U, NCP = NC + 1;
  constexpr int kStageFloats = (R + NC) * kKP;
  float* stages = reinterpret_cast<float*>(dynamic_smem());
  const int n_units = a.H / U;
  const int u0 = (blockIdx.x % n_units) * U;
  const int row0 = (blockIdx.x / n_units) * R;
  const int nr = min(R, a.B - row0);
  const int K = a.K_in + a.H;
  const int nt = (K + kKT - 1) / kKT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane & 7, cg = lane >> 3;

  uint64_t* bars =
      reinterpret_cast<uint64_t*>(stages + kStages * kStageFloats);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s]);
    mbar_fence_init();
  }
  __syncthreads();
  for (int t = 0; t < kStages - 1 && t < nt; ++t)
    issue_tile<R, U>(a, stages + t * kStageFloats, &bars[t], t, row0, nr,
                     u0);

  float acc[RG][U];
#pragma unroll
  for (int i = 0; i < RG; ++i)
#pragma unroll
    for (int j = 0; j < U; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < nt; ++t) {
    // tile t has landed for every thread, and every warp is done with the
    // stage tile t - 1 used, which the next tile refills
    __syncthreads();
    const int tn = t + kStages - 1;
    if (tn < nt)
      issue_tile<R, U>(a, stages + (tn % kStages) * kStageFloats,
                       &bars[tn % kStages], tn, row0, nr, u0);
    const int s = t % kStages;
    mbar_wait(&bars[s], (t / kStages) & 1);
    const int kte = min(kKT, K - t * kKT);
    // 16-byte groups of k this warp takes of the tile (all but a last tile:
    // kKw / 4, unrolled)
    const int ng = max(0, min(kKw, kte - warp * kKw)) / 4;
    const float* xb = stages + s * kStageFloats + rg * kKP + warp * kKw;
    const float* wb = stages + s * kStageFloats + (R + cg) * kKP + warp * kKw;
    auto kgroup = [&](int q) {
      float4 wv[U], xv[RG];
#pragma unroll
      for (int j = 0; j < U; ++j)
        wv[j] = *reinterpret_cast<const float4*>(wb + 4 * j * kKP + 4 * q);
#pragma unroll
      for (int i = 0; i < RG; ++i)
        xv[i] = *reinterpret_cast<const float4*>(xb + 8 * i * kKP + 4 * q);
#pragma unroll
      for (int i = 0; i < RG; ++i)
#pragma unroll
        for (int j = 0; j < U; ++j)
          acc[i][j] = fmaf(xv[i].x, wv[j].x, acc[i][j]);
#pragma unroll
      for (int i = 0; i < RG; ++i)
#pragma unroll
        for (int j = 0; j < U; ++j)
          acc[i][j] = fmaf(xv[i].y, wv[j].y, acc[i][j]);
#pragma unroll
      for (int i = 0; i < RG; ++i)
#pragma unroll
        for (int j = 0; j < U; ++j)
          acc[i][j] = fmaf(xv[i].z, wv[j].z, acc[i][j]);
#pragma unroll
      for (int i = 0; i < RG; ++i)
#pragma unroll
        for (int j = 0; j < U; ++j)
          acc[i][j] = fmaf(xv[i].w, wv[j].w, acc[i][j]);
    };
    if (ng == kKw / 4) {
#pragma unroll
      for (int q = 0; q < kKw / 4; ++q) kgroup(q);
    } else {
      for (int q = 0; q < ng; ++q) kgroup(q);
    }
  }
  __syncthreads();  // every warp is done with the stages

  // the warps' partial sums, [warp][row][column], over the stages
  float* red = stages;
#pragma unroll
  for (int i = 0; i < RG; ++i)
#pragma unroll
    for (int j = 0; j < U; ++j)
      red[(warp * R + rg + 8 * i) * NCP + cg + 4 * j] = acc[i][j];
  __syncthreads();
  for (int p = threadIdx.x; p < nr * U; p += kThreads) {
    const int r = p / U, j = p % U, u = u0 + j;
    float z[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float* col = red + r * NCP + g * U + j;
      float sum = col[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum += col[w * R * NCP];
      z[g] = sum + gate_bias(a, g * a.H + u);
    }
    cell_update(a, row0 + r, u, z[0], z[1], z[2], z[3]);
  }
}

template <int RG, int U>
int smem_bytes() {
  return kStages * (8 * RG + 4 * U) * kKP * 4 + kStages * 8;
}

template <int RG, int U>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int R = 8 * RG;
  const int blocks = (a.H / U) * ((a.B + R - 1) / R);
  const int smem = smem_bytes<RG, U>();
  cudaError_t err = cudaFuncSetAttribute(
      lstm_cell_kernel<RG, U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  Args arg = a;
  void* kargs[] = {&arg};
  return cudaLaunchKernel(lstm_cell_kernel<RG, U>, dim3(blocks),
                          dim3(kThreads), kargs, smem, stream);
}

template <int U>
cudaError_t launch_rows(const Args& a, int row_groups, cudaStream_t stream) {
  switch (row_groups) {
    case 1: return launch<1, U>(a, stream);
    case 2: return launch<2, U>(a, stream);
    case 4: return launch<4, U>(a, stream);
    case 8: return launch<8, U>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// One layer over B rows: x [B, K_in], h and c [B, H], w_ih [4H, K_in], w_hh
// [4H, H] (x, h and the weights 16-byte aligned, K_in and H multiples of 4),
// `units` hidden units a block (4, 8 or 10, dividing H) and `row_groups` x 8
// rows a block (1, 2, 4 or 8); writes h_out and c_out [B, H].
extern "C" int lstm_cell_launch(const float* x, const float* h, const float* c,
                                const float* w_ih, const float* w_hh,
                                const float* b_ih, const float* b_hh,
                                float* h_out, float* c_out, int B, int K_in,
                                int H, int units, int row_groups,
                                void* stream) {
  Args a{x, h, c, w_ih, w_hh, b_ih, b_hh, h_out, c_out, B, K_in, H};
  if (B < 1 || H < 1 || K_in < 1 || (K_in | H) & 3 || H % units ||
      !aligned(x) || !aligned(h) || !aligned(w_ih) || !aligned(w_hh))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (units) {
    case 4: err = launch_rows<4>(a, row_groups, s); break;
    case 8: err = launch_rows<8>(a, row_groups, s); break;
    case 10: err = launch_rows<10>(a, row_groups, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// B=1 scan of one 2-layer LSTM stack (linear1 -> ReLU -> 2 LSTM layers ->
// linear2) over a chunk of T frames, with the time loop inside one launch.
//
// Replaces the TPU kernel robustcap_tpu/ops/pallas_lstm.py::_kernel (reached
// through rnn_scan_pallas / rnn_scan_pallas_chunked). That kernel keeps the
// whole stack in VMEM and loops frames inside one grid step.
//
// What bounds it on an H100: each frame is a chain of four dependent
// matrix-vector products (linear1, layer 0, layer 1, linear2). A 512-wide f32
// stack is ~17 MB, so a frame reads ~17 MB of weights and does ~8.5 MFLOP:
// far below the f32 rate, so the weight bytes and the latency of the
// dependency chain bound it, not arithmetic.
//
// Design: one persistent cooperative launch per chunk, one block per SM.
// Each warp owns whole hidden units (all four gate rows of a unit), so the
// cell update stays in the warp and c never leaves its owner. A grid-wide
// barrier follows each dependent product (linear1, layer 0, layer 1); the
// output product needs none, because nothing of the next frame reads what it
// writes. h is double-buffered in global memory (frame t reads slot t%2 and
// writes slot (t+1)%2), so no block overwrites an h that another block is
// still reading. Weights are read from global memory every frame: the stack
// fits the 50 MB L2, so after the first frame they come from L2. Keeping
// each block's weight slice in shared memory, and bf16 weights, are later
// steps.
//
// The per-unit gate and cell code is shared with the serve kernel
// (lstm_cell.cuh).
//
// Plain C interface for ctypes: lstm_scan_launch returns the CUDA error code
// of the launch (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_cell.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Args {
  const float* xs;  // [T, in]
  const float* w1;  // [H, in]
  const float* b1;  // [H]
  const float* wih[2];  // [4H, H] per layer
  const float* whh[2];  // [4H, H]
  const float* bih[2];  // [4H]
  const float* bhh[2];  // [4H]
  const float* w2;  // [out, H]
  const float* b2;  // [out]
  const float* h0;  // [2, H]
  const float* c0;  // [2, H]
  float* ys;        // [T, out]
  float* hN;        // [2, H]
  float* cN;        // [2, H], also the running c state
  float* y1;        // scratch [H]: linear1 output of the current frame
  float* hbuf;      // scratch [2 layers][2 slots][H]
  int T, in, H, out;
};

// One LSTM layer for this frame: gates of [x ; h_prev], cell update by the
// owning warp's lane 0, c updated in place. x and h_prev were written by
// other blocks before the last grid barrier, so they are read with plain
// (coherent) loads.
__device__ void lstm_layer(const Args& a, int l, const float* x,
                           const float* h_prev, float* h_next, float* sv,
                           int gw, int nw, int lane) {
  const int H = a.H;
  for (int k = threadIdx.x; k < H; k += kThreads) {
    sv[k] = x[k];
    sv[H + k] = h_prev[k];
  }
  __syncthreads();
  LstmLayer L;
  L.wih = a.wih[l];
  L.whh = a.whh[l];
  L.bih = a.bih[l];
  L.bhh = a.bhh[l];
  L.x = sv;
  L.h_prev = sv + H;
  L.c_in = a.cN + l * H;
  L.c_out = a.cN + l * H;
  L.h_out = h_next;
  L.h_state = nullptr;
  L.H = H;
  L.commit = kCommitAlways;
  L.mask = true;
  for (int j = gw; j < H; j += nw) lstm_unit(L, j, lane);
}

__global__ void __launch_bounds__(kThreads) lstm_scan_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float sv[];
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int nw = gridDim.x * kWarps;
  const int H = a.H;
  float* hb[2] = {a.hbuf, a.hbuf + 2 * H};  // per layer: [slot][H]

  // Owners seed their units: h into slot 0, c into the running state. The
  // first grid barrier (after linear1) publishes h before any block reads it.
  for (int j = gw; j < H; j += nw) {
    if (lane == 0) {
      for (int l = 0; l < 2; ++l) {
        hb[l][j] = a.h0[l * H + j];
        a.cN[l * H + j] = a.c0[l * H + j];
      }
    }
  }

  for (int t = 0; t < a.T; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;

    // linear1 -> ReLU
    const float* x = a.xs + static_cast<size_t>(t) * a.in;
    for (int k = threadIdx.x; k < a.in; k += kThreads) sv[k] = x[k];
    __syncthreads();
    for (int r = gw; r < H; r += nw) {
      const float s = warp_dot(a.w1 + static_cast<size_t>(r) * a.in, sv,
                               a.in, lane);
      if (lane == 0) a.y1[r] = fmaxf(s + a.b1[r], 0.f);
    }
    grid.sync();

    lstm_layer(a, 0, a.y1, hb[0] + cur * H, hb[0] + nxt * H, sv, gw, nw,
               lane);
    grid.sync();
    lstm_layer(a, 1, hb[0] + nxt * H, hb[1] + cur * H, hb[1] + nxt * H, sv,
               gw, nw, lane);
    grid.sync();

    // linear2 on the new top-layer h
    for (int k = threadIdx.x; k < H; k += kThreads) sv[k] = hb[1][nxt * H + k];
    __syncthreads();
    for (int r = gw; r < a.out; r += nw) {
      const float s = warp_dot(a.w2 + static_cast<size_t>(r) * H, sv, H, lane);
      if (lane == 0) a.ys[static_cast<size_t>(t) * a.out + r] = s + a.b2[r];
    }
    __syncthreads();  // sv is reloaded by the next frame's linear1
  }

  // Each owner wrote its units' last h itself, so it can read them back.
  const int fin = a.T & 1;
  for (int j = gw; j < H; j += nw) {
    if (lane == 0) {
      for (int l = 0; l < 2; ++l) a.hN[l * H + j] = hb[l][fin * H + j];
    }
  }
}

}  // namespace

extern "C" int lstm_scan_launch(
    const float* xs, const float* w1, const float* b1, const float* wih0,
    const float* whh0, const float* bih0, const float* bhh0,
    const float* wih1, const float* whh1, const float* bih1,
    const float* bhh1, const float* w2, const float* b2, const float* h0,
    const float* c0, float* ys, float* hN, float* cN, float* y1,
    float* hbuf, int T, int in, int H, int out, void* stream) {
  Args a;
  a.xs = xs;
  a.w1 = w1;
  a.b1 = b1;
  a.wih[0] = wih0;
  a.whh[0] = whh0;
  a.bih[0] = bih0;
  a.bhh[0] = bhh0;
  a.wih[1] = wih1;
  a.whh[1] = whh1;
  a.bih[1] = bih1;
  a.bhh[1] = bhh1;
  a.w2 = w2;
  a.b2 = b2;
  a.h0 = h0;
  a.c0 = c0;
  a.ys = ys;
  a.hN = hN;
  a.cN = cN;
  a.y1 = y1;
  a.hbuf = hbuf;
  a.T = T;
  a.in = in;
  a.H = H;
  a.out = out;

  const int n_shared = (in > 2 * H ? in : 2 * H);
  const size_t smem = static_cast<size_t>(n_shared) * sizeof(float);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    dev)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lstm_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, lstm_scan_kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  // one block per SM: enough warps to own every unit of a 512-wide layer
  void* kargs[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(lstm_scan_kernel), dim3(sms), dim3(kThreads),
      kargs, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

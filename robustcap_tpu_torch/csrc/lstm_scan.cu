// B=1 scan of one 2-layer LSTM stack (linear1 -> ReLU -> 2 LSTM layers ->
// linear2) over a chunk of T frames, with the time loop inside one launch.
//
// Replaces the TPU kernel robustcap_tpu/ops/pallas_lstm.py::_kernel (reached
// through rnn_scan_pallas / rnn_scan_pallas_chunked). That kernel keeps the
// whole stack in VMEM and loops frames inside one grid step.
//
// What bounds it on an H100: the two layers' recurrence, T dependent steps
// that each need every unit's h of the step before. A 512-wide stack does
// ~2.2 GFLOP per 256 frames, 33 us at the f32 peak; the serial chain of
// steps, each a grid-wide exchange of h, is what takes the time.
//
// Design: one persistent cooperative launch per chunk, one block per SM,
// each block owning a fixed run of units of each layer (ops/lstm_scan.py::
// lstm_plan) from records packed on the host (serve_scan.py::pack_stack).
// 1. What does not recur is hoisted out of the time loop and computed for
//    the whole chunk as tiled f32 products spread over the grid:
//    Y1 = relu(X W1^T + b1), then U0 = Y1 W_ih0^T + b_ih0 + b_hh0 ([T, 4H],
//    unit-major, in L2). Each output element is summed by one thread in k
//    order, so its bits depend neither on T nor on where a chunk starts:
//    chained chunks give the bits of one.
// 2. The recurrent weights stay in shared memory for the whole launch: at
//    its start each block copies its layer-0 units' W_hh rows and its
//    layer-1 units' [W_ih | W_hh] rows, each with the unit's summed biases,
//    with cp.async.bulk onto one mbarrier (serve_async.cuh), under the
//    products of step 1.
// 3. One grid barrier per step, by a wavefront over the two layers: at step
//    s layer 0 computes frame s from U0[s] and h0 of frame s-1, and layer 1
//    computes frame s-1 from h0 of frame s-1 and h1 of frame s-2; both read
//    only what the step before wrote, so T + 1 steps run T + 1 barriers. A
//    step stages the two h vectors in shared memory, gives each warp a
//    job (four gate rows of one unit against one vector, reduced across the
//    warp), and the unit's owner thread updates the cell; c never leaves
//    its owner's registers. Every frame's h of both layers is kept in
//    global memory (row 0 the seed), so no row is written twice.
// 4. linear2 runs after the loop, as a product over the stored top-layer h
//    of every frame.
// A launch runs T + 3 grid barriers (cooperative_groups' grid.sync).
//
// Optional timestamps: block 0's %globaltimer at the start, around the two
// product phases' barriers, when the weights have landed, around every
// step's barrier and at the end (kTsSteps).
//
// Plain C interface for ctypes: lstm_scan_launch returns the CUDA error code
// of the launch (0 on success); lstm_scan_device_info reports the grid and
// the shared memory a block may take.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_cell.cuh"
#include "serve_async.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxH = 2 * kThreads;    // the largest hidden size it takes
constexpr int kHv = kMaxH / kThreads;  // words of an h vector a thread stages
// product tile: kTM rows of the left operand, kTN of the right, kTK deep;
// in shared memory a row of kTS floats for each k (padded: 16-byte rows that
// spread a step's stores over the banks)
constexpr int kTM = 64, kTN = 64, kTK = 32, kTS = 68;
static_assert(kTK == 32 && kWarps * 4 == kTM && kThreads / 8 == kTN,
              "the loads: a warp's lanes on k, eight threads a row of B");
static_assert(32 * 2 == kTN, "4 x 2 outputs a thread");
constexpr int kNumPtrs = 13;
constexpr int kNumInts = 19;
// timestamp slots: start; linear1 done, its barrier passed; U0 done, its
// barrier passed; weights resident; then step s: 6 + 2 s done, 7 + 2 s its
// barrier passed; and 8 + 2 T linear2 done (9 + 2 T slots)
constexpr int kTsSteps = 6;

// Rows of a product's right operand, inside packed records: row n is
// `per`-th part of record n / per, `sub` bytes after the record's row 0; its
// bias is the float at `bias` + 4 (n % per) bytes into the record.
struct Rows {
  const unsigned char* base;
  int per, stride, sub, bias;
  int len;  // floats of a row, zero padding included (a multiple of 4)
};

__device__ __forceinline__ const float* row_of(const Rows& B, int n) {
  return reinterpret_cast<const float*>(
      B.base + static_cast<size_t>(n / B.per) * B.stride + (n % B.per) * B.sub);
}

__device__ __forceinline__ float bias_of(const Rows& B, int n) {
  return *reinterpret_cast<const float*>(
      B.base + static_cast<size_t>(n / B.per) * B.stride + B.bias +
      (n % B.per) * 4);
}

// byte offsets of the shared-memory areas (ops/lstm_scan.py::lstm_plan)
struct Layout {
  int bar, hv, part, tile, res, total;
};

struct Args {
  const float* xs;              // [T, in]
  const unsigned char* pk[4];   // packed runs: linear1, layer 0, 1, linear2
  const float* h0;              // [2, H]
  const float* c0;              // [2, H]
  float* ys;                    // [T, out]
  float* hN;                    // [2, H]
  float* cN;                    // [2, H]
  float* u0;                    // scratch [T, 4H]: layer 0's input sums
  float* y1;                    // scratch [T, H]: linear1 -> ReLU
  float* hs[2];                 // scratch [T + 1, H] per layer, row 0 the seed
  const int* starts;            // [2, nb + 1]: block b owns units
                                // [starts[l][b], starts[l][b + 1]) of layer l
  unsigned long long* ts;       // [2 T + 9] or null
  int T, in, H, out;
  int rec[4], len[4];           // record bytes, row floats per packed run
  int nb;
  Layout lay;
};

__device__ __forceinline__ void stamp(const Args& a, int k) {
  if (a.ts && blockIdx.x == 0 && threadIdx.x == 0) a.ts[k] = globaltimer();
}


// C[m][n] = act(sum_k A[m][k] B_n[k] + bias_n) for m < M, n < N, tiles of
// kTM x kTN spread over the grid. A is read through L2 (other blocks may
// have written it in this launch), a warp a row, 32 consecutive words; B
// through the read-only path, eight threads a row, 16 bytes each; both go
// to shared memory k-major, the next step's loads in flight while a step
// computes. Each element is summed by one thread, k in order, whatever its
// tile.
__device__ void product(const float* A, int lda, int M, int K, const Rows& B,
                        int N, float* C, int ldc, bool relu, float* tile) {
  float* As = tile;               // [kTK][kTS]: column m of A's tile
  float* Bs = tile + kTK * kTS;   // [kTK][kTS]: column n of B's tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int br = tid >> 3, bq = tid & 7;  // B's row, its float4
  const int tiles_m = (M + kTM - 1) / kTM, tiles_n = (N + kTN - 1) / kTN;
  for (int t = blockIdx.x; t < tiles_m * tiles_n; t += gridDim.x) {
    const int m0 = (t % tiles_m) * kTM, n0 = (t / tiles_m) * kTN;
    const float* arow[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + warp + kWarps * i;
      arow[i] = m < M ? A + static_cast<size_t>(m) * lda : nullptr;
    }
    const float* brow = n0 + br < N ? row_of(B, n0 + br) : nullptr;
    float ra[4], rb[4];
    auto load = [&](int k0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ra[i] = (arow[i] && k0 + lane < K) ? __ldcg(arow[i] + k0 + lane)
                                           : 0.f;
      const int k = k0 + 4 * bq;
      float4 w = {0.f, 0.f, 0.f, 0.f};
      if (brow && k < B.len)
        w = __ldg(reinterpret_cast<const float4*>(brow + k));
      rb[0] = w.x;
      rb[1] = w.y;
      rb[2] = w.z;
      rb[3] = w.w;
    };
    float acc[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    load(0);
    for (int k0 = 0; k0 < K; k0 += kTK) {
      __syncthreads();  // the last step's reads of the tiles are done
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        As[lane * kTS + warp + kWarps * i] = ra[i];
        Bs[(4 * bq + i) * kTS + br] = rb[i];
      }
      __syncthreads();
      if (k0 + kTK < K) load(k0 + kTK);
#pragma unroll 8
      for (int kk = 0; kk < kTK; ++kk) {
        const float4 x =
            *reinterpret_cast<const float4*>(As + kk * kTS + 4 * warp);
        const float2 y =
            *reinterpret_cast<const float2*>(Bs + kk * kTS + 2 * lane);
        const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(xv[i], y.x, acc[i][0]);
          acc[i][1] = fmaf(xv[i], y.y, acc[i][1]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + 2 * lane + j;
      if (n >= N) continue;
      const float b = bias_of(B, n);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + 4 * warp + i;
        if (m >= M) continue;
        const float v = acc[i][j] + b;
        C[static_cast<size_t>(m) * ldc + n] = relu ? fmaxf(v, 0.f) : v;
      }
    }
  }
}

// Four consecutive rows of n floats (shared memory, 16-byte aligned, n a
// multiple of 4) against v (shared memory), reduced across the warp: every
// lane gets z[0..3].
__device__ __forceinline__ void dot4(const float* w, const float* v, int n,
                                     int lane, float z[4]) {
  const float4* v4 = reinterpret_cast<const float4*>(v);
  const int n4 = n >> 2;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int q = lane; q < n4; q += 32) {
    const float4 x = v4[q];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float4 y = reinterpret_cast<const float4*>(w + g * n)[q];
      acc[g] = fmaf(y.x, x.x, acc[g]);
      acc[g] = fmaf(y.y, x.y, acc[g]);
      acc[g] = fmaf(y.z, x.z, acc[g]);
      acc[g] = fmaf(y.w, x.w, acc[g]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int g = 0; g < 4; ++g)
      acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], off);
#pragma unroll
  for (int g = 0; g < 4; ++g) z[g] = acc[g];
}

// The cell update from the four gate sums (i, f, g, o): c in place, h out.
__device__ __forceinline__ float cell(float zi, float zf, float zg, float zo,
                                      float& c) {
  c = sigmoidf(zf) * c + sigmoidf(zi) * tanhf(zg);
  return sigmoidf(zo) * tanhf(c);
}

__global__ void __launch_bounds__(kThreads, 1) lstm_scan_kernel(Args a) {
  unsigned char* sm = dynamic_smem();
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + a.lay.bar);
  float* hv = reinterpret_cast<float*>(sm + a.lay.hv);  // [2][hp]
  float* part = reinterpret_cast<float*>(sm + a.lay.part);
  float* tile = reinterpret_cast<float*>(sm + a.lay.tile);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, H = a.H, hp = a.len[1], T = a.T;
  const int j0 = a.starts[b], n0 = a.starts[b + 1] - j0;
  const int j1 = a.starts[a.nb + 1 + b], n1 = a.starts[a.nb + 2 + b] - j1;
  // resident records: layer 0's W_hh rows and biases (the second half of
  // its packed record), then layer 1's whole records
  const int r0 = 4 * hp * 4 + 16, r1 = a.rec[2];
  unsigned char* res0 = sm + a.lay.res;
  unsigned char* res1 = res0 + n0 * r0;
  cg::grid_group grid = cg::this_grid();

  stamp(a, 0);
  if (tid == 0) {
    mbar_init(bar);
    mbar_fence_init();
    mbar_expect_tx(bar, static_cast<uint32_t>(n0 * r0 + n1 * r1));
    for (int u = 0; u < n0; ++u)
      bulk_copy(res0 + u * r0,
                a.pk[1] + static_cast<size_t>(j0 + u) * a.rec[1] + 4 * hp * 4,
                r0, bar);
    if (n1 > 0)
      bulk_copy(res1, a.pk[2] + static_cast<size_t>(j1) * r1, n1 * r1, bar);
  }
  for (int k = tid; k < 2 * hp; k += kThreads) hv[k] = 0.f;  // the padding

  // thread u < n0 + n1 owns a unit: layer 0's first, then layer 1's; it
  // seeds row 0 of its layer's h and keeps c
  const int layer = tid < n0 ? 0 : (tid < n0 + n1 ? 1 : -1);
  const int unit = layer == 0 ? j0 + tid : j1 + tid - n0;
  float c = 0.f, h = 0.f;
  if (layer >= 0) {
    c = a.c0[layer * H + unit];
    h = a.h0[layer * H + unit];
    a.hs[layer][unit] = h;
  }

  // 1. the products that do not recur
  const Rows w1{a.pk[0], 1, a.rec[0], 0, a.rec[0] - 16, a.len[0]};
  product(a.xs, a.in, T, a.in, w1, H, a.y1, H, true, tile);
  stamp(a, 1);
  grid.sync();
  stamp(a, 2);
  const Rows wih0{a.pk[1], 4, a.rec[1], hp * 4, 8 * hp * 4, hp};
  product(a.y1, H, T, H, wih0, 4 * H, a.u0, 4 * H, false, tile);
  stamp(a, 3);
  grid.sync();
  stamp(a, 4);
  mbar_wait(bar, 0);
  stamp(a, 5);

  // 2. the recurrence, one step a barrier. Every load of a step is issued
  // before the first store, and the owners of layer-0 units load the next
  // step's U0 row before the barrier.
  const int njobs = n0 + 2 * n1;
  float4 u = {0.f, 0.f, 0.f, 0.f};  // layer 0's input sums of this step
  if (layer == 0) u = __ldcg(reinterpret_cast<const float4*>(a.u0) + unit);
  for (int s = 0; s <= T; ++s) {
    const bool on0 = s < T, on1 = s > 0;
    const float* h0p = a.hs[0] + static_cast<size_t>(s) * H;
    const float* h1p = a.hs[1] + static_cast<size_t>(on1 ? s - 1 : 0) * H;
    float x0[kHv], x1[kHv];
#pragma unroll
    for (int i = 0; i < kHv; ++i) {
      const int k = tid + i * kThreads;
      x0[i] = k < H ? __ldcg(h0p + k) : 0.f;
      x1[i] = on1 && k < H ? __ldcg(h1p + k) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kHv; ++i) {
      const int k = tid + i * kThreads;
      if (k < H) {
        hv[k] = x0[i];
        hv[hp + k] = x1[i];
      }
    }
    __syncthreads();
    for (int j = warp; j < njobs; j += kWarps) {
      const float* w;
      const float* v = hv;
      if (j < n0) {
        if (!on0) continue;
        w = reinterpret_cast<const float*>(res0 + j * r0);
      } else {
        if (!on1) continue;
        const int q = j - n0;
        w = reinterpret_cast<const float*>(res1 + (q >> 1) * r1) +
            (q & 1) * 4 * hp;
        v = hv + (q & 1) * hp;
      }
      float z[4];
      dot4(w, v, hp, lane, z);
      if (lane == 0)
        *reinterpret_cast<float4*>(part + 4 * j) = {z[0], z[1], z[2], z[3]};
    }
    __syncthreads();
    if (layer == 0 && on0) {
      const float* p = part + 4 * tid;
      h = cell(u.x + p[0], u.y + p[1], u.z + p[2], u.w + p[3], c);
      a.hs[0][static_cast<size_t>(s + 1) * H + unit] = h;
      if (s + 1 < T)
        u = __ldcg(reinterpret_cast<const float4*>(a.u0) +
                   static_cast<size_t>(s + 1) * H + unit);
    } else if (layer == 1 && on1) {
      const int q = tid - n0;
      const float* p = part + 4 * (n0 + 2 * q);
      const float* bias =
          reinterpret_cast<const float*>(res1 + q * r1 + 8 * hp * 4);
      h = cell(p[0] + p[4] + bias[0], p[1] + p[5] + bias[1],
               p[2] + p[6] + bias[2], p[3] + p[7] + bias[3], c);
      a.hs[1][static_cast<size_t>(s) * H + unit] = h;
    }
    stamp(a, kTsSteps + 2 * s);
    grid.sync();
    stamp(a, kTsSteps + 2 * s + 1);
  }

  // 3. linear2 over the top layer's h of every frame (rows 1..T)
  const Rows w2{a.pk[3], 1, a.rec[3], 0, a.rec[3] - 16, a.len[3]};
  product(a.hs[1] + H, H, T, H, w2, a.out, a.ys, a.out, false, tile);
  if (layer >= 0) {
    a.hN[layer * H + unit] = h;
    a.cN[layer * H + unit] = c;
  }
  stamp(a, kTsSteps + 2 * T + 2);
}

}  // namespace

// ptrs: xs, the four packed runs, h0, c0, ys, hN, cN, scratch, the block
// table, timestamps (or 0). ints: T, in, H, out, the runs' record bytes and
// row floats, the block count, the shared-memory layout (bar, hv, part,
// tile, res, total).
extern "C" int lstm_scan_launch(const int64_t* ptrs, int n_ptrs,
                                const int* ints, int n_ints, void* stream) {
  if (n_ptrs != kNumPtrs || n_ints != kNumInts) return cudaErrorInvalidValue;
  Args a;
  int p = 0, q = 0;
  auto P = [&]() { return reinterpret_cast<void*>(ptrs[p++]); };
  a.xs = static_cast<const float*>(P());
  for (int k = 0; k < 4; ++k) a.pk[k] = static_cast<const unsigned char*>(P());
  a.h0 = static_cast<const float*>(P());
  a.c0 = static_cast<const float*>(P());
  a.ys = static_cast<float*>(P());
  a.hN = static_cast<float*>(P());
  a.cN = static_cast<float*>(P());
  float* scratch = static_cast<float*>(P());
  a.starts = static_cast<const int*>(P());
  a.ts = static_cast<unsigned long long*>(P());
  a.T = ints[q++];
  a.in = ints[q++];
  a.H = ints[q++];
  a.out = ints[q++];
  for (int k = 0; k < 4; ++k) a.rec[k] = ints[q++];
  for (int k = 0; k < 4; ++k) a.len[k] = ints[q++];
  a.nb = ints[q++];
  Layout& L = a.lay;
  for (int* f : {&L.bar, &L.hv, &L.part, &L.tile, &L.res, &L.total})
    *f = ints[q++];
  const size_t TH = static_cast<size_t>(a.T) * a.H;
  a.u0 = scratch;
  a.y1 = a.u0 + 4 * TH;
  a.hs[0] = a.y1 + TH;
  a.hs[1] = a.hs[0] + TH + a.H;
  // what the kernel relies on: 16-byte records, rows and areas; the layer
  // runs' rows as long as the hidden size, padded
  if (a.T <= 0 || a.nb <= 0 || (a.rec[0] | a.rec[1] | a.rec[2] | a.rec[3] |
                                a.len[0] | a.len[1] | a.len[3]) & 3 ||
      (a.rec[0] | a.rec[1] | a.rec[2] | a.rec[3]) & 15 ||
      a.H > kMaxH || a.len[1] < a.H || a.len[3] != a.len[1] ||
      a.len[0] < a.in ||
      a.rec[1] < 8 * a.len[1] * 4 + 16 || a.rec[2] != a.rec[1] ||
      (L.bar | L.hv | L.part | L.tile | L.res) & 15 ||
      (reinterpret_cast<uintptr_t>(scratch) & 15))
    return cudaErrorInvalidValue;
  for (int k = 0; k < 4; ++k)
    if (reinterpret_cast<uintptr_t>(a.pk[k]) & 15) return cudaErrorInvalidValue;

  const size_t smem = static_cast<size_t>(L.total);
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
  if ((err = cudaFuncSetAttribute(lstm_scan_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, lstm_scan_kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1 || a.nb > sms * per_sm)
    return cudaErrorCooperativeLaunchTooLarge;
  void* kargs[] = {&a};
  err = cudaLaunchCooperativeKernel(lstm_scan_kernel, dim3(a.nb),
                                    dim3(kThreads), kargs, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The grid of the current card (its SM count: one block each) and the
// dynamic shared memory a block may take, into out[0], out[1].
extern "C" int lstm_scan_device_info(int* out) {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, lstm_scan_kernel);
  if (err != cudaSuccess) return err;
  out[1] = optin - static_cast<int>(fa.sharedSizeBytes);
  return cudaSuccess;
}

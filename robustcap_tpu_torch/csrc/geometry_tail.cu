// The per-frame geometry tail of the SigMP step for B frames in one launch
// (one block a row; B = 1 for a single stream): contact
// sigmoid, r6d -> rotation (Gram-Schmidt, eps 1e-8), IK against the parent,
// light FK as an ancestor-chain sum, feet in the camera frame, translation
// from contacts or network velocity, visual position fusion, the 11-slot
// flat-floor ring and its snap, first-frame overrides, LBS of the 33
// landmarks (pose blendshapes optional), sync_mp3d, and the live-mode reuse
// of the throttled landmarks.
//
// Replaces the TPU kernel robustcap_tpu/ops/pallas_tail.py::_kernel (math in
// tail_math, reached through geometry_tail).
//
// What bounds it on an H100: it reads at most ~100 KB (82 KB of that is the
// posedirs subset, only with pose blendshapes) and does ~50 KFLOP, so the
// latency of its serial steps and of the launch bounds it, not bytes or
// arithmetic. The design is one block of 512 threads running the body
// tail_block (tail_block.cuh), which the serve kernel runs too. As the
// block starts, one thread sends the body-model constants (packed on the
// host in the body's kTc* layout, 4 KB) and the posedirs rows (82 KB) on
// their way into shared memory with cp.async.bulk, while every thread
// stages one word of the frame's inputs and carry (~1.3 KB, the body's kIn*
// layout), all loads in flight at once; the body then reads shared memory
// only, waits for the constants after Gram-Schmidt and for the rows only in
// the blendshape product, and writes the outputs straight to global memory
// (the wrapper's buffer has the body's kOff* layout). A batch is a grid of B
// such blocks: block b reads row b of every per-frame input and carry field
// (the first-frame flags among them, read from device arrays as the TPU
// kernel reads them from its scalar vector) and writes row b of the outputs;
// the constants are shared, so that blocks after the first find them in L2.
// The rows are independent blocks, which the SMs run side by side (two a
// SM with the posedirs rows' 82 KB of shared memory). Direct indexed loads
// (parent index, ancestor chain walked through it, the 33 landmark rows
// gathered on the host once) take the place of the TPU kernel's constant
// 0/1 gather matmuls. Config flags are kernel arguments.
//
// Plain C interface for ctypes: geometry_tail_launch returns the CUDA error
// code of the launch (0 on success). It makes no host read and no
// synchronizing call, so a CUDA graph can capture it:
// cudaFuncSetAttribute sets a property of the function on the host and is
// not a stream operation.

#include <cuda_runtime.h>
#include <stdint.h>

#include "serve_async.cuh"
#include "tail_block.cuh"

namespace {

constexpr int kThreads = 512;
static_assert(kThreads >= kTailIn, "one word of the inputs a thread");

// Base pointers of row 0; row b is at b times the field's row size (kRow*).
struct Args {
  const float* out7;  // [B, 24, 6]
  const float* out8;  // [B, 2]
  const float* rcr;   // [B, 3, 3]
  const float* vr;    // [B, 3]
  const float* pc;    // [B, 3]
  const float* c;     // [B]
  const float* k_lerp;  // [B]
  const float* first_tran;  // [B, 3]
  const float* grav;  // [B, 3]
  const unsigned char* first_frame;  // [B]
  const unsigned char* first_tran_valid;  // [B]
  const float* last_pfoot;  // [B, 2, 3]
  const unsigned char* has_pfoot;  // [B]
  const float* last_tran;  // [B, 3]
  const unsigned char* has_tran;  // [B]
  const float* floor_buf;  // [B, 11, 3]
  const int* floor_cnt;  // [B]
  const int* vision_count;  // [B]
  const float* j_temp;  // [B, 33, 3]
  const float* body;  // [kTcBody]: the body-model constants, kTc* layout
  const float* pd;    // [3 x 33, kPdRow] or null
  float* out;         // [B, kTailOut], kOff* layout
  int* out_i;         // [B, 2]: floor_cnt, vision_count
  float conf_hi, contact_threshold, distance_threshold, tran_filter_num,
      height_threshold;
  int use_flat_floor, live, update_vision_freq, landmarks;
};

// Bytes of dynamic shared memory: the body's scratch, the input and
// constants areas, two mbarriers and the posedirs rows.
constexpr int kOffIn = (sizeof(TailShared) + 15) / 16 * 16;
constexpr int kOffTc = kOffIn + 4 * kTailIn;
constexpr int kOffBar = kOffTc + 4 * kTailConst;
constexpr int kOffPd = kOffBar + 16;
static_assert(kOffTc % 16 == 0 && kOffBar % 16 == 0, "16-byte areas");

__global__ void __launch_bounds__(kThreads) geometry_tail_kernel(Args a) {
  unsigned char* sm = dynamic_smem();
  TailShared& sh = *reinterpret_cast<TailShared*>(sm);
  float* in = reinterpret_cast<float*>(sm + kOffIn);
  float* tc = reinterpret_cast<float*>(sm + kOffTc);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + kOffBar);
  float* pd = reinterpret_cast<float*>(sm + kOffPd);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar);
    mbar_init(bar + 1);
    mbar_fence_init();
    mbar_expect_tx(bar, 4 * kTcBody);
    bulk_copy(tc, a.body, 4 * kTcBody, bar);
    if (a.pd) {
      mbar_expect_tx(bar + 1, kPdBytes);
      bulk_copy(pd, a.pd, kPdBytes, bar + 1);
    }
  }
  const int b = blockIdx.x;
  const Seg seg[] = {{a.out7 + 144 * b, 144, kInOut7},
                     {a.out8 + 2 * b, 2, kInOut8},
                     {a.vr + 3 * b, 3, kInVr},
                     {a.pc + 3 * b, 3, kInPc},
                     {a.rcr + 9 * b, 9, kInRcr},
                     {a.c + b, 1, kInC},
                     {a.k_lerp + b, 1, kInC + 1},
                     {a.first_tran + 3 * b, 3, kInFirstTran},
                     {a.grav + 3 * b, 3, kInGrav},
                     {a.last_pfoot + 6 * b, 6, kInLastPfoot},
                     {a.last_tran + 3 * b, 3, kInLastTran},
                     {a.floor_buf + 33 * b, 33, kInFloor},
                     {a.j_temp + 99 * b, 99, kInJtemp},
                     {a.floor_cnt + b, 1, kInInts},
                     {a.vision_count + b, 1, kInInts + 1}};
  copy_segs(seg, in);
  if (tid == kThreads - 1) {
    // the row's carry flags and frame flags, and the launch's
    unsigned char* has = reinterpret_cast<unsigned char*>(in + kInHas);
    has[0] = a.has_pfoot[b];
    has[1] = a.has_tran[b];
    int* ini = reinterpret_cast<int*>(in);
    ini[kInFirst] = a.first_frame[b] != 0;
    ini[kInFirst + 1] = a.first_tran_valid[b] != 0;
    int* tci = reinterpret_cast<int*>(tc);
    tc[kTcConfHi] = a.conf_hi;
    tc[kTcContact] = a.contact_threshold;
    tc[kTcDistance] = a.distance_threshold;
    tc[kTcFilter] = a.tran_filter_num;
    tc[kTcHeight] = a.height_threshold;
    tci[kTcFloor] = a.use_flat_floor;
    tci[kTcLive] = a.live;
    tci[kTcVisionFreq] = a.update_vision_freq;
    tci[kTcLandmarks] = a.landmarks;
  }
  __syncthreads();
  tail_block(in, tc, a.out + kTailOut * b, a.out_i + 2 * b,
             a.pd ? pd : nullptr,
             a.pd ? bar + 1 : nullptr, bar, sh);
}

}  // namespace

// B rows: the frames' inputs and flags and the carry (each a base pointer of
// row 0), the body-model constants (packed), the posedirs rows (or null: no
// blendshapes), the output buffer and counters, then the batch size and the
// configuration.
extern "C" int geometry_tail_launch(
    const float* out7, const float* out8, const float* rcr, const float* vr,
    const float* pc, const float* c, const float* k_lerp,
    const float* first_tran, const float* grav,
    const unsigned char* first_frame, const unsigned char* first_tran_valid,
    const float* last_pfoot, const unsigned char* has_pfoot,
    const float* last_tran, const unsigned char* has_tran,
    const float* floor_buf, const int* floor_cnt, const int* vision_count,
    const float* j_temp, const float* body, const float* pd, float* out,
    int* out_i, int batch, float conf_hi, float contact_threshold,
    float distance_threshold, float tran_filter_num, float height_threshold,
    int use_flat_floor, int live, int update_vision_freq, int landmarks,
    void* stream) {
  Args a;
  a.out7 = out7;
  a.out8 = out8;
  a.rcr = rcr;
  a.vr = vr;
  a.pc = pc;
  a.c = c;
  a.k_lerp = k_lerp;
  a.first_tran = first_tran;
  a.grav = grav;
  a.first_frame = first_frame;
  a.first_tran_valid = first_tran_valid;
  a.last_pfoot = last_pfoot;
  a.has_pfoot = has_pfoot;
  a.last_tran = last_tran;
  a.has_tran = has_tran;
  a.floor_buf = floor_buf;
  a.floor_cnt = floor_cnt;
  a.vision_count = vision_count;
  a.j_temp = j_temp;
  a.body = body;
  a.pd = landmarks ? pd : nullptr;
  a.out = out;
  a.out_i = out_i;
  a.conf_hi = conf_hi;
  a.contact_threshold = contact_threshold;
  a.distance_threshold = distance_threshold;
  a.tran_filter_num = tran_filter_num;
  a.height_threshold = height_threshold;
  a.use_flat_floor = use_flat_floor;
  a.live = live;
  a.update_vision_freq = update_vision_freq;
  a.landmarks = landmarks;
  if ((reinterpret_cast<uintptr_t>(body) | reinterpret_cast<uintptr_t>(a.pd)) &
      15)
    return cudaErrorInvalidValue;
  if (batch < 1) return cudaErrorInvalidValue;
  const int smem = kOffPd + (a.pd ? kPdBytes : 0);
  cudaError_t err = cudaFuncSetAttribute(
      geometry_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  void* kargs[] = {&a};
  err = cudaLaunchKernel(geometry_tail_kernel, dim3(batch), dim3(kThreads),
                         kargs, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

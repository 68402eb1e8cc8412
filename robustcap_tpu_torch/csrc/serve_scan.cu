// The whole branchless steady SigMP step for a chunk of T frames in one
// cooperative launch: rnn2; rnn3 with the speculative rnn7/rnn8 heads (they
// read the start-of-frame state and never write it); the speculative tail on
// the inertial joints; the synthetic keypoints of the occluded-frame refeed;
// rnn4 and rnn6, each once, on inputs selected by the refeed condition and
// committed under their masks; the confidence gate; the final rnn7/rnn8 with
// commit; the final tail; the one-shot IMU-updater rewrite of rnn2's (h, c)
// through init_net; and the carry. Semantics of
// models/sig_mp.py::make_step(include_first_frame_step=False,
// cond_updater=False) frame for frame.
//
// Three weight modes, one template on the mode (ops/serve_scan.py's
// prepare_serve_params builds their operands): float32 rows; bf16 rows, each
// product's activation side rounded to bf16 as it is copied into shared
// memory and everything else in float32; and int8 gate rows with per-row
// scales (cfg.int8_compute), whose x and h each block quantizes per row from
// its own shared copy (the |max| reduced in the block, so no extra grid
// barrier), summed in int32 with __dp4a and rescaled, with linear1/linear2 in
// bf16 and bf16 rounding where the JAX int8 cell rounds (lstm_cell.cuh).
//
// Replaces the TPU kernel robustcap_tpu/ops/pallas_serve.py::_make_kernel
// (reached through serve_scan, operands from prepare_serve_params).
//
// What bounds it on an H100: a frame is a chain of ~18 dependent steps. The
// bank is ~61M parameters, and rnn7/rnn8 run twice per frame, so a frame
// reads ~277 MB of weights in f32, ~139 MB in bf16 and ~71 MB with int8 gates:
// at 3.35 TB/s that is ~83, ~41 and ~21 us. The arithmetic (~139 M
// operations per frame) is far below the card's rates. Even the int8 bank
// (~60 MB) exceeds the 50 MB L2, so it streams from HBM every frame. As
// written, the kernel is far from those floors and its time follows the
// number of rows and barriers more than their bytes: a warp reads one row
// at a time and reduces it before the next (PERF.md).
//
// Memory plan: nothing is resident. Weights stay in the torch layout ([4H,
// in] rows) in global memory and are read row by row through the
// non-coherent cache. Each phase copies the vectors it multiplies (at most
// 4096 floats, 16 KB, and in int8 mode their 4 KB quantized copy) into
// dynamic shared memory; the tail's scratch is
// ~4 KB of static shared memory in block 0. Hidden states live in global
// memory: h double-buffered per frame (frame t reads slot t%2 and writes
// slot (t+1)%2, and a unit that does not commit copies its old h across),
// c updated in place by the unit's owner. Activations, head outputs and the
// two tails' outputs are small global scratch buffers.
//
// Design: one block of 256 threads per SM, a warp per hidden unit (all four
// gate rows, lstm_cell.cuh) or per output row, a grid barrier after each
// dependent product. Independent stacks share a phase: {rnn3, rnn7 spec,
// rnn8 spec} all take [in2, out2], and {rnn6, rnn7 final, rnn8 final} are
// independent once rnn4's output and the speculative tail exist. Block 0
// runs both tails (tail_block.cuh) between barriers. That is 18 barriers a
// frame, plus 2 on the frame where the IMU updater fires. Branches that
// decide which phases run (live mode's rnn4/rnn6 skip, the IMU updater) are
// taken by every block from the same device values, read after a barrier.
// Selects between real and synthetic inputs are ternaries, so a NaN in the
// unselected side (j_lm.z near 0) never leaks.
//
// Plain C interface for ctypes: serve_scan_launch takes its pointers, ints
// and floats as three arrays in the order the Python wrapper
// (ops/serve_scan.py) builds them, and returns the CUDA error code of the
// launch (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_cell.cuh"
#include "tail_block.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStacks = 6;
enum StackId { kR2 = 0, kR3, kR4, kR6, kR7, kR8 };

// f32 outputs of one tail evaluation, laid end to end
constexpr int kOffPose = 0;       // [24, 3, 3]
constexpr int kOffTran = 216;     // [3]
constexpr int kOffContact = 219;  // [2]
constexpr int kOffPfoot = 221;    // [2, 3]
constexpr int kOffFloor = 227;    // [11, 3]
constexpr int kOffJtemp = 260;    // [33, 3]
constexpr int kOffJoint = 359;    // [24, 3]
constexpr int kOffJlm = 431;      // [33, 3]

// synthetic keypoints: bbox-normalised [33, 3], raw [33, 3],
// joint[1:] - joint[0] [23, 3]
constexpr int kSynNorm = 0;
constexpr int kSynRaw = 99;
constexpr int kSynJ3 = 198;

// linear1 inputs in shared memory: rnn6's [raw72, 99, 69] at 0, the final
// heads' [in2, j3dr] at kIn7
constexpr int kIn7 = 240;

// The weight types of a mode: Dense for linear1/linear2, Gate for the LSTM
// rows; kRound: activations rounded to bf16 before every product.
struct ModeF32 {
  using Dense = float;
  using Gate = float;
  static constexpr bool kRound = false;
  static constexpr bool kInt8 = false;
};
struct ModeBf16 {
  using Dense = __nv_bfloat16;
  using Gate = __nv_bfloat16;
  static constexpr bool kRound = true;
  static constexpr bool kInt8 = false;
};
struct ModeInt8 {
  using Dense = __nv_bfloat16;
  using Gate = int8_t;
  static constexpr bool kRound = true;
  static constexpr bool kInt8 = true;
};

// An activation as the products of mode M read it
template <class M>
__device__ __forceinline__ float act(float x) {
  if constexpr (M::kRound) return bf16r(x);
  return x;
}

template <class M>
struct Stack {
  const typename M::Dense* w1;     // [H, in]
  const float* b1;                 // [H]
  const typename M::Gate* wih[2];  // [4H, H] per layer
  const typename M::Gate* whh[2];  // [4H, H]
  const float* bias[2];            // [4H] b_ih + b_hh
  const float* sih[2];             // [4H] row scales (int8 mode), or null
  const float* shh[2];
  const typename M::Dense* w2;     // [out, H]
  const float* b2;                 // [out]
  float* hs;   // state h [2 layers][2 slots][H]
  float* cs;   // state c [2 layers][H]
  float* y1;   // linear1 output [H]
  float* hn;   // new h of the current evaluation [2 layers][H]
  float* out;  // head output [out]
  int in, H, n_out;
};

template <class M>
struct Args {
  Stack<M> st[kStacks];
  // per-frame inputs
  const float* in2;    // [T, 72] IMU in the root frame (rnn2's input)
  const float* raw72;  // [T, 72] IMU in the camera frame
  const float* j2n;    // [T, 99] bbox-normalised keypoints
  const float* j2r;    // [T, 99] keypoints
  const float* rcr;    // [T, 9] root orientation
  const float* c;      // [T] frame confidence
  const float* k_lerp;  // [T]
  const int* ff;       // [T] first_frame
  const int* ftv;      // [T] first_tran_valid
  const float* first_tran;  // [T, 3]
  const float* grav;   // [T, 3]
  // carry, updated in place
  float* last_pfoot;   // [2, 3]
  unsigned char* has;  // [2] has_pfoot, has_tran
  float* last_tran;    // [3]
  float* floor_buf;    // [11, 3]
  int* ints;           // [4] floor_cnt, vision_count, first_reach, vu
  float* j_temp;       // [33, 3]
  const float* pc_first;    // [3]
  const float* out4_first;  // [69]
  // body-model constants of the tail
  const int* parent;
  const float* bone;
  const float* j0;
  const float* wsub;
  const float* v0sub;
  const float* pd;  // or null
  // rnn2's init_net: [n0, 69], [n1, n0], [n2, n1] and biases
  const float* iw[3];
  const float* ib[3];
  // scratch
  float* tail_f[2];  // [530] speculative, final
  int* tail_i[2];    // [2] floor_cnt, vision_count
  float* syn;        // [267] synthetic keypoints
  float* init_x;     // [n0 + n1] init_net activations
  // outputs
  float* pose;     // [T, 24, 3, 3]
  float* tran;     // [T, 3]
  float* contact;  // [T, 2]
  int T, use_imu, live, update_vision_freq, use_flat_floor, blendshape;
  int init_n[3];
  float lo, hi, contact_threshold, distance_threshold, tran_filter_num,
      height_threshold;
};

// One stack evaluation in a phase: its stack, its linear1 input (shared
// memory) and what it does with its state.
struct Job {
  int s;
  const float* x;
  int commit;
  bool mask;
};

__device__ __forceinline__ int align4(int n) { return (n + 3) & ~3; }
__device__ __forceinline__ int align16(int n) { return (n + 15) & ~15; }

// linear1 (int8 mode: rounded to bf16 and the bias added in bf16) -> ReLU
// of every job, rows of all jobs laid end to end
template <class M>
__device__ void phase_lin1(const Args<M>& a, const Job* jobs, int nj, int gw,
                           int nw, int lane) {
  int n[3], total = 0;
  for (int k = 0; k < nj; ++k) total += (n[k] = a.st[jobs[k].s].H);
  for (int i = gw; i < total; i += nw) {
    int k = 0, r = i;
    while (r >= n[k]) r -= n[k++];
    const Stack<M>& s = a.st[jobs[k].s];
    const float v = warp_dot(s.w1 + static_cast<size_t>(r) * s.in,
                             jobs[k].x, s.in, lane);
    if (lane != 0) continue;
    if constexpr (M::kInt8)
      s.y1[r] = fmaxf(bf16r(bf16r(v) + bf16r(s.b1[r])), 0.f);
    else
      s.y1[r] = fmaxf(v + s.b1[r], 0.f);
  }
}

// max |v[i]| over the block, every thread gets it
__device__ float block_absmax(const float* v, int n, float* red) {
  float m = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) m = fmaxf(m, fabsf(v[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = red[0];
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  __syncthreads();  // red is reused by the next call
  return m;
}

// nn.rnn.quantize_activation of v [n] into q; returns the scale
__device__ float quantize_row(const float* v, int n, int8_t* q, float* red) {
  const float scale = fmaxf(block_absmax(v, n, red), 1e-12f) / 127.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    q[i] = static_cast<int8_t>(
        fminf(fmaxf(rintf(v[i] / scale), -127.f), 127.f));
  return scale;
}

// LSTM layer l of every job: [x ; h_prev] into shared memory (as the mode's
// products read them; int8 mode also quantizes both per row), then one warp
// per hidden unit
template <class M>
__device__ void phase_layer(const Args<M>& a, int l, const Job* jobs, int nj,
                            float* sv, int cur, int nxt, int gw, int nw,
                            int lane) {
  __shared__ float red[kWarps];
  __shared__ float scales[3][2];
  float* xs[3];
  int8_t* qs[3];
  int n[3], total = 0, off = 0;
  for (int k = 0; k < nj; ++k) {
    const Stack<M>& s = a.st[jobs[k].s];
    const int H = s.H;
    const float* x = l == 0 ? s.y1 : s.hn;
    const float* h = s.hs + static_cast<size_t>(l * 2 + cur) * H;
    xs[k] = sv + off;
    for (int i = threadIdx.x; i < H; i += blockDim.x) {
      xs[k][i] = act<M>(x[i]);
      xs[k][align4(H) + i] = act<M>(h[i]);
    }
    off += 2 * align4(H);
    total += (n[k] = H);
  }
  __syncthreads();
  if constexpr (M::kInt8) {
    int8_t* q = reinterpret_cast<int8_t*>(sv + off);
    for (int k = 0; k < nj; ++k) {
      const int H = n[k];
      qs[k] = q;
      const float sx = quantize_row(xs[k], H, q, red);
      const float sh = quantize_row(xs[k] + align4(H), H, q + align16(H),
                                    red);
      if (threadIdx.x == 0) {
        scales[k][0] = sx;
        scales[k][1] = sh;
      }
      q += 2 * align16(H);
    }
    __syncthreads();
  }
  for (int i = gw; i < total; i += nw) {
    int k = 0, j = i;
    while (j >= n[k]) j -= n[k++];
    const Stack<M>& s = a.st[jobs[k].s];
    const int H = s.H;
    LstmLayerT<typename M::Gate> L;
    L.wih = s.wih[l];
    L.whh = s.whh[l];
    L.bih = s.bias[l];
    L.bhh = nullptr;
    L.x = xs[k];
    L.h_prev = xs[k] + align4(H);
    L.c_in = s.cs + l * H;
    L.c_out = s.cs + l * H;
    L.h_out = s.hn + l * H;
    L.h_state = s.hs + static_cast<size_t>(l * 2 + nxt) * H;
    L.h_old = s.hs + static_cast<size_t>(l * 2 + cur) * H;
    L.H = H;
    L.commit = jobs[k].commit;
    L.mask = jobs[k].mask;
    if constexpr (M::kInt8) {
      L.sih = s.sih[l];
      L.shh = s.shh[l];
      L.xq = qs[k];
      L.hq = qs[k] + align16(H);
      L.sx = scales[k][0];
      L.sh = scales[k][1];
    }
    lstm_unit(L, j, lane);
  }
}

// linear2 of every job on its top-layer h (int8 mode: the bias added in
// bf16)
template <class M>
__device__ void phase_out(const Args<M>& a, const Job* jobs, int nj, float* sv,
                          int gw, int nw, int lane) {
  float* xs[3];
  int n[3], total = 0, off = 0;
  for (int k = 0; k < nj; ++k) {
    const Stack<M>& s = a.st[jobs[k].s];
    xs[k] = sv + off;
    for (int i = threadIdx.x; i < s.H; i += blockDim.x)
      xs[k][i] = act<M>(s.hn[s.H + i]);
    off += align4(s.H);
    total += (n[k] = s.n_out);
  }
  __syncthreads();
  for (int i = gw; i < total; i += nw) {
    int k = 0, r = i;
    while (r >= n[k]) r -= n[k++];
    const Stack<M>& s = a.st[jobs[k].s];
    const float v = warp_dot(s.w2 + static_cast<size_t>(r) * s.H, xs[k],
                             s.H, lane);
    if (lane != 0) continue;
    if constexpr (M::kInt8)
      s.out[r] = bf16r(bf16r(v) + bf16r(s.b2[r]));
    else
      s.out[r] = v + s.b2[r];
  }
}

// The four dependent products of a group of stacks whose linear1 inputs are
// already in shared memory.
template <class M>
__device__ void run_group(const Args<M>& a, const Job* jobs, int nj, float* sv,
                          int cur, int nxt, cg::grid_group& grid, int gw,
                          int nw, int lane) {
  phase_lin1(a, jobs, nj, gw, nw, lane);
  grid.sync();
  phase_layer(a, 0, jobs, nj, sv, cur, nxt, gw, nw, lane);
  grid.sync();
  phase_layer(a, 1, jobs, nj, sv, cur, nxt, gw, nw, lane);
  grid.sync();
  phase_out(a, jobs, nj, sv, gw, nw, lane);
  grid.sync();
}

// A stack that is skipped this frame carries its h into the next slot (c
// stays where it is).
template <class M>
__device__ void keep_state(const Stack<M>& s, int cur, int nxt, int gw, int nw,
                           int lane) {
  if (lane != 0) return;
  for (int j = gw; j < s.H; j += nw)
    for (int l = 0; l < 2; ++l)
      s.hs[static_cast<size_t>(l * 2 + nxt) * s.H + j] =
          s.hs[static_cast<size_t>(l * 2 + cur) * s.H + j];
}

// The gated joints of frame t into dst [69]: out4_eff rotated by Rcr,
// lerped with the inertial joints by confidence; as a product of mode M
// reads them with ``round``, else in float32 (init_net's input).
template <class M>
__device__ void load_j3dr(const Args<M>& a, int t, float* dst, bool round) {
  const bool ff = a.ff[t] != 0;
  const float c = a.c[t];
  const float k = a.k_lerp[t];
  const float* R = a.rcr + 9 * t;
  const float* o2 = a.st[kR2].out;
  const float* o4 = ff ? a.out4_first : a.st[kR4].out;
  for (int i = threadIdx.x; i < 69; i += blockDim.x) {
    const int n = i / 3, r = i % 3;
    const float v = o4[3 * n] * R[r] + o4[3 * n + 1] * R[3 + r] +
                    o4[3 * n + 2] * R[6 + r];
    const float j =
        c >= a.hi ? v : (c > a.lo ? o2[i] * (1.f - k) + v * k : o2[i]);
    dst[i] = round ? act<M>(j) : j;
  }
}

// Tail arguments of frame t; w = 0 speculative, 1 final.
template <class M>
__device__ TailArgs tail_args(const Args<M>& a, int t, int w, const float* pc) {
  TailArgs ta;
  ta.out7 = a.st[kR7].out;
  ta.out8 = a.st[kR8].out;
  ta.rcr = a.rcr + 9 * t;
  ta.vr = a.st[kR3].out;
  ta.pc = pc;
  ta.c = a.c + t;
  ta.k_lerp = a.k_lerp + t;
  ta.first_tran = a.first_tran + 3 * t;
  ta.grav = a.grav + 3 * t;
  ta.last_pfoot = a.last_pfoot;
  ta.has_pfoot = a.has;
  ta.last_tran = a.last_tran;
  ta.has_tran = a.has + 1;
  ta.floor_buf = a.floor_buf;
  ta.floor_cnt = a.ints;
  ta.vision_count = a.ints + 1;
  ta.j_temp = a.j_temp;
  ta.parent = a.parent;
  ta.bone = a.bone;
  ta.j0 = a.j0;
  ta.wsub = a.wsub;
  ta.v0sub = a.v0sub;
  ta.pd = a.pd;
  float* f = a.tail_f[w];
  ta.pose = f + kOffPose;
  ta.tran = f + kOffTran;
  ta.contact = f + kOffContact;
  ta.pfoot = f + kOffPfoot;
  ta.floor_buf_out = f + kOffFloor;
  ta.floor_cnt_out = a.tail_i[w];
  ta.vision_count_out = a.tail_i[w] + 1;
  ta.j_temp_out = f + kOffJtemp;
  ta.joint = f + kOffJoint;
  ta.j_lm = f + kOffJlm;
  ta.first_frame = a.ff[t];
  ta.first_tran_valid = a.ftv[t];
  ta.conf_hi = a.hi;
  ta.contact_threshold = a.contact_threshold;
  ta.distance_threshold = a.distance_threshold;
  ta.tran_filter_num = a.tran_filter_num;
  ta.height_threshold = a.height_threshold;
  ta.use_flat_floor = a.use_flat_floor;
  ta.live = a.live;
  ta.update_vision_freq = a.update_vision_freq;
  ta.landmarks = 1;
  ta.blendshape = a.blendshape;
  return ta;
}

// Block 0, after the speculative tail: the refeed condition and the
// synthetic keypoints j_lm / j_lm.z (bbox-normalised for rnn4, raw for
// rnn6) and joint[1:] - joint[0].
template <class M>
__device__ void synthetic(const Args<M>& a, int t, float* s_scale) {
  const float* jl = a.tail_f[0] + kOffJlm;
  const float* joint = a.tail_f[0] + kOffJoint;
  float* syn = a.syn;
  const int tid = threadIdx.x;
  for (int i = tid; i < 99; i += blockDim.x)
    syn[kSynRaw + i] = jl[i] / jl[(i / 3) * 3 + 2];
  for (int i = tid; i < 69; i += blockDim.x)
    syn[kSynJ3 + i] = joint[3 + i] - joint[i % 3];
  __syncthreads();
  if (tid == 0) {
    const float* x = syn + kSynRaw;
    float xmin = x[0], xmax = x[0], ymin = x[1], ymax = x[1];
    for (int v = 1; v < 33; ++v) {
      xmin = fminf(xmin, x[3 * v]);
      xmax = fmaxf(xmax, x[3 * v]);
      ymin = fminf(ymin, x[3 * v + 1]);
      ymax = fmaxf(ymax, x[3 * v + 1]);
    }
    *s_scale = fmaxf(fmaxf(xmax - xmin, ymax - ymin), 1e-6f);
    const bool vu = a.c[t] <= a.lo &&
                    (!a.live || a.tail_i[0][1] == a.update_vision_freq);
    a.ints[3] = vu;
  }
  __syncthreads();
  const float scale = *s_scale;
  for (int i = tid; i < 99; i += blockDim.x) {
    const int v = i / 3, k = i % 3;
    const float raw = syn[kSynRaw + i];
    float out = raw;
    if (k < 2) {
      out = raw / scale;
      if (v != 23) out -= syn[kSynRaw + 23 * 3 + k] / scale;
    }
    syn[kSynNorm + i] = out;
  }
}

// Block 0, after the final tail: per-frame outputs and the carry.
template <class M>
__device__ void commit_frame(const Args<M>& a, int t, bool conf_full) {
  const float* f = a.tail_f[1];
  const int tid = threadIdx.x;
  for (int i = tid; i < 216; i += blockDim.x)
    a.pose[static_cast<size_t>(t) * 216 + i] = f[kOffPose + i];
  for (int i = tid; i < 99; i += blockDim.x) a.j_temp[i] = f[kOffJtemp + i];
  for (int i = tid; i < 33; i += blockDim.x)
    a.floor_buf[i] = f[kOffFloor + i];
  if (tid < 3) {
    a.tran[3 * t + tid] = f[kOffTran + tid];
    a.last_tran[tid] = f[kOffTran + tid];
  }
  if (tid < 2) a.contact[2 * t + tid] = f[kOffContact + tid];
  if (tid < 6) a.last_pfoot[tid] = f[kOffPfoot + tid];
  if (tid == 0) {
    a.ints[0] = a.tail_i[1][0];
    a.ints[1] = a.tail_i[1][1];
    a.has[0] = 1;
    a.has[1] = 1;
    if (a.use_imu && conf_full) a.ints[2] = 0;
  }
}

// One init_net layer: rows [n] of w [n, m] on x (shared memory) -> out,
// ReLU on all but the last layer. The last layer writes rnn2's state for
// the next frame: h of layer l at rows [l H, (l+1) H), c at [(2+l) H, ...).
template <class M>
__device__ void init_layer(const Args<M>& a, int li, const float* x, int m,
                           int nxt, int gw, int nw, int lane) {
  const int n = a.init_n[li];
  const Stack<M>& s2 = a.st[kR2];
  const int H = s2.H;
  for (int r = gw; r < n; r += nw) {
    const float v = warp_dot(a.iw[li] + static_cast<size_t>(r) * m, x, m,
                             lane) + a.ib[li][r];
    if (lane != 0) continue;
    if (li == 0) {
      a.init_x[r] = fmaxf(v, 0.f);
    } else if (li == 1) {
      a.init_x[a.init_n[0] + r] = fmaxf(v, 0.f);
    } else if (r < 2 * H) {
      const int l = r / H, j = r % H;
      s2.hs[static_cast<size_t>(l * 2 + nxt) * H + j] = v;
    } else {
      s2.cs[r - 2 * H] = v;
    }
  }
}

template <class M>
__global__ void __launch_bounds__(kThreads)
    serve_scan_kernel(const __grid_constant__ Args<M> a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float sv[];
  __shared__ TailShared ts;
  __shared__ float s_scale;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gw = blockIdx.x * kWarps + (tid >> 5);
  const int nw = gridDim.x * kWarps;

  for (int t = 0; t < a.T; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    // start-of-frame values every block reads before the frame's first
    // barrier; block 0 rewrites them only in the frame's last phase
    const float c = a.c[t];
    const bool ff = a.ff[t] != 0;
    const bool conf_vis = c > a.lo;
    const bool conf_full = c >= a.hi;
    const bool first_reach = a.ints[2] != 0;
    // live mode: rnn4/rnn6 are observable only on a visible frame or when
    // the refeed commits (occluded and the throttle's counter at 0)
    const bool need46 = !a.live || conf_vis || a.ints[1] == 0;
    const float* in2 = a.in2 + 72 * t;

    // rnn2 on the IMU in the root frame
    for (int i = tid; i < 72; i += kThreads) sv[i] = act<M>(in2[i]);
    __syncthreads();
    const Job j2[1] = {{kR2, sv, kCommitAlways, true}};
    run_group(a, j2, 1, sv, cur, nxt, grid, gw, nw, lane);

    // rnn3 and the speculative heads on [in2, out2]
    for (int i = tid; i < 72; i += kThreads) sv[i] = act<M>(in2[i]);
    for (int i = tid; i < 69; i += kThreads)
      sv[72 + i] = act<M>(a.st[kR2].out[i]);
    __syncthreads();
    const Job g1[3] = {{kR3, sv, kCommitAlways, true},
                       {kR7, sv, kCommitNever, false},
                       {kR8, sv, kCommitNever, false}};
    run_group(a, g1, 3, sv, cur, nxt, grid, gw, nw, lane);

    // speculative tail on the inertial joints with pc_first, then the
    // synthetic keypoints
    if (blockIdx.x == 0) {
      const TailArgs ta = tail_args(a, t, 0, a.pc_first);
      tail_block(ta, ts);
      __syncthreads();
      synthetic(a, t, &s_scale);
    }
    grid.sync();
    const bool vu = a.ints[3] != 0;
    const bool m4 = (conf_vis && !ff) || vu;
    const bool m6 = conf_vis || vu;
    const float* syn = a.syn;

    // rnn4 on [raw72, keypoints], synthetic when refeeding
    if (need46) {
      const float* kp = vu ? syn + kSynNorm : a.j2n + 99 * t;
      for (int i = tid; i < 72; i += kThreads)
        sv[i] = act<M>(a.raw72[72 * t + i]);
      for (int i = tid; i < 99; i += kThreads) sv[72 + i] = act<M>(kp[i]);
      __syncthreads();
      const Job j4[1] = {{kR4, sv, kCommitMasked, m4}};
      run_group(a, j4, 1, sv, cur, nxt, grid, gw, nw, lane);
    } else {
      keep_state(a.st[kR4], cur, nxt, gw, nw, lane);
      keep_state(a.st[kR6], cur, nxt, gw, nw, lane);
    }

    // rnn6 on [raw72, keypoints, joints] and the final heads on
    // [in2, j3dr]
    {
      const float* kp = vu ? syn + kSynRaw : a.j2r + 99 * t;
      const float* o4 = ff ? a.out4_first : a.st[kR4].out;
      for (int i = tid; i < 72; i += kThreads) {
        sv[i] = act<M>(a.raw72[72 * t + i]);
        sv[kIn7 + i] = act<M>(in2[i]);
      }
      for (int i = tid; i < 99; i += kThreads) sv[72 + i] = act<M>(kp[i]);
      for (int i = tid; i < 69; i += kThreads)
        sv[171 + i] = act<M>(vu ? syn[kSynJ3 + i] : o4[i]);
      load_j3dr(a, t, sv + kIn7 + 72, true);
      __syncthreads();
      const Job g2[3] = {{kR7, sv + kIn7, kCommitAlways, true},
                         {kR8, sv + kIn7, kCommitAlways, true},
                         {kR6, sv, kCommitMasked, m6}};
      run_group(a, g2, need46 ? 3 : 2, sv, cur, nxt, grid, gw, nw, lane);
    }

    // final tail and the carry (block 0); the IMU updater's init_net
    // (every block, only on the frame where it fires)
    const bool iu = a.use_imu && conf_full && first_reach;
    if (blockIdx.x == 0) {
      const TailArgs ta =
          tail_args(a, t, 1, conf_vis ? a.st[kR6].out : a.pc_first);
      tail_block(ta, ts);
      __syncthreads();
      commit_frame(a, t, conf_full);
      __syncthreads();
    }
    if (iu) {
      load_j3dr(a, t, sv, false);
      __syncthreads();
      init_layer(a, 0, sv, a.st[kR2].n_out, nxt, gw, nw, lane);
      grid.sync();
      for (int i = tid; i < a.init_n[0]; i += kThreads) sv[i] = a.init_x[i];
      __syncthreads();
      init_layer(a, 1, sv, a.init_n[0], nxt, gw, nw, lane);
      grid.sync();
      for (int i = tid; i < a.init_n[1]; i += kThreads)
        sv[i] = a.init_x[a.init_n[0] + i];
      __syncthreads();
      init_layer(a, 2, sv, a.init_n[1], nxt, gw, nw, lane);
    }
    grid.sync();
  }
}

constexpr int kPtrsPerStack = 19;
constexpr int kNumPtrs = kStacks * kPtrsPerStack + 40;
constexpr int kNumInts = 1 + kStacks * 3 + 9;
constexpr int kNumFloats = 6;

template <class M>
int launch(const int64_t* ptrs, const int* ints, const float* flts,
           void* stream) {
  Args<M> a;
  int p = 0, q = 1;  // ints[0] is the mode
  auto F = [&]() { return reinterpret_cast<float*>(ptrs[p++]); };
  auto I = [&]() { return reinterpret_cast<int*>(ptrs[p++]); };
  auto D = [&]() {
    return reinterpret_cast<const typename M::Dense*>(ptrs[p++]);
  };
  auto G = [&]() {
    return reinterpret_cast<const typename M::Gate*>(ptrs[p++]);
  };
  int smem_floats = 400;  // linear1 inputs: 240 + 141, aligned
  int sum_h[2] = {0, 0};
  for (int k = 0; k < kStacks; ++k) {
    Stack<M>& s = a.st[k];
    s.w1 = D();
    s.b1 = F();
    for (int l = 0; l < 2; ++l) {
      s.wih[l] = G();
      s.whh[l] = G();
      s.bias[l] = F();
      s.sih[l] = F();
      s.shh[l] = F();
    }
    s.w2 = D();
    s.b2 = F();
    s.hs = F();
    s.cs = F();
    s.y1 = F();
    s.hn = F();
    s.out = F();
    s.in = ints[q++];
    s.H = ints[q++];
    s.n_out = ints[q++];
    // [x ; h] as floats, and in int8 mode their quantized copy
    const int h2 = 2 * ((s.H + 3) & ~3) + (M::kInt8 ? ((s.H + 15) & ~15) / 2
                                                    : 0);
    if (k == kR3 || k == kR7 || k == kR8) sum_h[0] += h2;
    if (k == kR6 || k == kR7 || k == kR8) sum_h[1] += h2;
    if (h2 > smem_floats) smem_floats = h2;
  }
  for (int g = 0; g < 2; ++g)
    if (sum_h[g] > smem_floats) smem_floats = sum_h[g];
  a.in2 = F();
  a.raw72 = F();
  a.j2n = F();
  a.j2r = F();
  a.rcr = F();
  a.c = F();
  a.k_lerp = F();
  a.ff = I();
  a.ftv = I();
  a.first_tran = F();
  a.grav = F();
  a.last_pfoot = F();
  a.has = reinterpret_cast<unsigned char*>(ptrs[p++]);
  a.last_tran = F();
  a.floor_buf = F();
  a.ints = I();
  a.j_temp = F();
  a.pc_first = F();
  a.out4_first = F();
  a.parent = I();
  a.bone = F();
  a.j0 = F();
  a.wsub = F();
  a.v0sub = F();
  a.pd = F();
  for (int l = 0; l < 3; ++l) {
    a.iw[l] = F();
    a.ib[l] = F();
  }
  a.tail_f[0] = F();
  a.tail_f[1] = F();
  a.tail_i[0] = I();
  a.tail_i[1] = I();
  a.syn = F();
  a.init_x = F();
  a.pose = F();
  a.tran = F();
  a.contact = F();
  a.T = ints[q++];
  a.use_imu = ints[q++];
  a.live = ints[q++];
  a.update_vision_freq = ints[q++];
  a.use_flat_floor = ints[q++];
  a.blendshape = ints[q++];
  for (int l = 0; l < 3; ++l) a.init_n[l] = ints[q++];
  a.lo = flts[0];
  a.hi = flts[1];
  a.contact_threshold = flts[2];
  a.distance_threshold = flts[3];
  a.tran_filter_num = flts[4];
  a.height_threshold = flts[5];
  if (p != kNumPtrs || q != kNumInts) return cudaErrorInvalidValue;
  for (int l = 0; l < 2; ++l)
    if (a.init_n[l] > smem_floats) smem_floats = a.init_n[l];
  if (a.T <= 0) return cudaSuccess;

  const size_t smem = static_cast<size_t>(smem_floats) * sizeof(float);
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
    err = cudaFuncSetAttribute(serve_scan_kernel<M>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, serve_scan_kernel<M>, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* kargs[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(serve_scan_kernel<M>), dim3(sms),
      dim3(kThreads), kargs, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// ints[0] picks the weight mode: 0 float32, 1 bf16, 2 int8 gates
extern "C" int serve_scan_launch(const int64_t* ptrs, int n_ptrs,
                                 const int* ints, int n_ints,
                                 const float* flts, int n_flts,
                                 void* stream) {
  if (n_ptrs != kNumPtrs || n_ints != kNumInts || n_flts != kNumFloats)
    return cudaErrorInvalidValue;
  switch (ints[0]) {
    case 0:
      return launch<ModeF32>(ptrs, ints, flts, stream);
    case 1:
      return launch<ModeBf16>(ptrs, ints, flts, stream);
    case 2:
      return launch<ModeInt8>(ptrs, ints, flts, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

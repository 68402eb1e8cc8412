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
// barrier), summed exactly in int32 with __dp4a and rescaled, with
// linear1/linear2 in bf16 and bf16 rounding where the JAX int8 cell rounds.
//
// Replaces the TPU kernel robustcap_tpu/ops/pallas_serve.py::_make_kernel
// (reached through serve_scan, operands from prepare_serve_params).
//
// What bounds it on an H100: a frame is a chain of up to 18 dependent steps
// (one grid barrier each) and two geometry tails, over a bank of ~61M
// parameters of which a frame reads ~277 MB in f32, ~139 MB in bf16 and
// ~71 MB with int8 gates (rnn7/rnn8 twice): ~83, ~41 and ~21 us at
// 3.35 TB/s. The arithmetic (~139 M multiply-adds a frame) is far below the
// card's rates, and at B=1 tensor cores would not help: bytes in flight and
// the chain of barriers are the levers. The design, from the in-launch
// timestamps of the previous kernel (PERF.md), which read one weight row at
// a time per warp and spent ~80% of a frame waiting on those reads, and
// from plan sweeps on the card:
//
// - Fixed row ownership, planned on the host (ops/serve_scan.py,
//   serve_plan). Every block owns a fixed, balanced run of records (units of
//   a layer: their eight gate rows, four biases and int8 row scales side by
//   side; or rows of linear1/linear2) per stack and phase kind, the same for
//   every frame and chunk. The weights are packed so that each run is one
//   contiguous, 16-byte-aligned range (pack_stack).
// - Asynchronous weight streaming into a shared-memory ring. One thread per
//   block (kProducer) walks the launch's schedule of pieces ahead of the
//   block and starts each as one cp.async.bulk (serve_async.cuh) completing
//   on an mbarrier, as far ahead as the ring allows: the next phase's
//   weights, and across the tails the next frame's, are in flight while the
//   grid waits at a barrier. Weights never depend on the data; which phases
//   run does, and the walker decides it as the block does: the speculative
//   heads from the frame's confidence, and live mode's rnn4/rnn6 from the
//   throttle's counter, known once the frame has begun, so the walker waits
//   there. The copying thread is a lane of a computing warp and takes part
//   in every grid barrier, so no warp is held out of cg::grid.sync and no
//   counter barrier is needed. The ring is cut into two pieces in flight
//   (serve_scan.py's _PIECES): on the card more, smaller pieces cost more of
//   the chain (a wait, a batch and a finish each) than the bytes they kept
//   in flight saved, and never less. Prefetching the
//   pieces beyond the ring into L2 (cp.async.bulk.prefetch.L2) was measured
//   and not kept: it competed with the ring's own copies.
// - Consumers read shared memory only. A warp, or G warps splitting a row,
//   accumulates all eight rows of a unit against [x ; h] in 16-byte chunks
//   and reduces the eight sums together (9 shuffles, not 40); per-warp
//   partial sums meet in shared memory and are added in a fixed order; four
//   lanes finish a unit, one gate each. 512 threads a block.
// - Residency where it pays (serve_plan): a run stays in shared memory for
//   the whole launch only while the ring keeps a mode's least size, which
//   the card's sweeps set: in int8 mode rnn7 and rnn8 (and small runs of
//   rnn2/rnn3) beside a ~96 KB ring, and only rnn4 and rnn6 and part of
//   rnn2/rnn3 stream; in bf16 mode small runs beside a ~180 KB ring;
//   float32 streams everything. Keeping all four 512-wide int8 stacks
//   resident (a 48 KB ring) was measured, and slower.
// - Less dead work: on a frame with c > lo the refeed cannot fire, so the
//   speculative heads, the speculative tail and its barrier are skipped by
//   every block alike (vu = 0 is still written), and rnn4 runs beside rnn2
//   and rnn3 beside the final heads: 9 barriers a frame instead of 17.
// - int8 mode quantizes a phase's inputs from the registers they are
//   loaded into, all rows' |max| in one block reduction.

// Determinism: no float atomics and no sums split across blocks; each row is
// summed in an order fixed by the plan, so 100 + 156 chained frames give the
// bits of 256.
//
// Memory plan: shared memory (all dynamic; offsets from serve_plan) holds the
// ring's mbarriers, the linear1 inputs, the layer inputs [x ; h] of a phase's
// jobs (int8: with their quantized copy), the partial sums, the tail's
// scratch, the resident runs and the ring. Hidden states live in global
// memory: h double-buffered per frame (frame t reads slot t%2 and writes
// slot (t+1)%2, and a unit that does not commit copies its old h across), c
// updated in place by the unit's owner. Activations, head outputs and the
// two tails' outputs are small global scratch buffers. Branches that decide
// which phases run are taken by every block from the same device values.
// Selects between real and synthetic inputs are ternaries, so a NaN in the
// unselected side (j_lm.z near 0) never leaks.
//
// Plain C interface for ctypes: serve_scan_launch takes its pointers, ints
// and floats as three arrays in the order the Python wrapper
// (ops/serve_scan.py) builds them, and returns the CUDA error code of the
// launch (0 on success); serve_scan_device_info reports the grid and shared
// memory the plan is made for.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "lstm_cell.cuh"
#include "serve_async.cuh"
#include "tail_block.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kStacks = 6;
constexpr int kKinds = 4;     // linear1, layer 0, layer 1, linear2
constexpr int kBars = 16;     // mbarriers of the ring (pieces in flight)
constexpr int kTailSmem = 4352;
constexpr int kPartF = kWarps * 20;  // floats of one partial-sum buffer
constexpr int kTsSlots = 56;         // timestamps per frame
// The thread that starts the ring's copies: lane 0 of the last warp, which
// finishes no record (a batch of kWarps records is finished by threads
// 0..4 kWarps - 1), so that its copying overlaps the finishes.
constexpr int kProducer = kThreads - 32;
enum StackId { kR2 = 0, kR3, kR4, kR6, kR7, kR8 };

static_assert(sizeof(TailShared) <= kTailSmem, "tail scratch");

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

// linear1 inputs: rnn6's [raw72, 99, 69] at 0, the final heads' [in2, j3dr]
// at kIn7
constexpr int kIn7 = 240;
// where the refeed cannot fire: rnn4's [raw72, keypoints] beside rnn2's
// input, rnn3's [in2, out2] beside the final heads'
constexpr int kIn4 = 80;
constexpr int kIn3 = 384;

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

struct Stack {
  const unsigned char* pk[kKinds];  // packed records of each kind
  float* hs;   // state h [2 layers][2 slots][H]
  float* cs;   // state c [2 layers][H]
  float* y1;   // linear1 output [H]
  float* hn;   // new h of the current evaluation [2 layers][H]
  float* out;  // head output [out]
  int in, H, n_out;
  int mc;  // the most units of one layer that a block owns
  // per kind: record bytes, padded row length (items), resident, offset in
  // the resident area, records per piece
  int rec[kKinds], lp[kKinds], res[kKinds], res_off[kKinds], cap[kKinds];
};

// Byte offsets of the shared-memory areas (serve_plan's layout)
struct Layout {
  int bars, state, xin, act, actq, parts, red, own, tail, tconst, res,
      ring, ring_bytes, total;
};

struct Args {
  Stack st[kStacks];
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
  float* syn;        // [267] synthetic keypoints
  float* init_x;     // [n0 + n1] init_net activations
  // outputs
  float* pose;     // [T, 24, 3, 3]
  float* tran;     // [T, 3]
  float* contact;  // [T, 2]
  const int* starts;       // [6, 4, nb + 1] the plan's record runs
  unsigned long long* ts;  // [T, kTsSlots] timestamps, or null
  int T, use_imu, live, update_vision_freq, use_flat_floor, blendshape;
  int init_n[3];
  int nb;
  Layout lay;
  float lo, hi, contact_threshold, distance_threshold, tran_filter_num,
      height_threshold;
};

// ---------------------------------------------------------------------------
// The schedule: which stacks run in each phase of a frame
// ---------------------------------------------------------------------------

// Phase p = 4 g + k of a frame: group g, kind k; job q of a group. Which
// stacks a group runs depends on the frame. Where the refeed may fire
// (c <= lo), as make_step orders them: {rnn2}, {rnn3, speculative rnn7,
// rnn8}, the speculative tail, {rnn4}, {final rnn7, rnn8, rnn6}. Where it
// cannot, rnn4, whose inputs are then the frame's own, runs beside rnn2, and
// rnn3, whose output only the final tail reads, beside the final heads:
// {rnn2, rnn4}, {rnn7, rnn8, rnn6, rnn3}, 8 phases and barriers instead of
// 16. rnn4 and rnn6 run only where need46 holds.
__device__ __forceinline__ int job_stack(int g, int q, bool spec) {
  if (spec) {
    switch (g) {
      case 0:
        return q == 0 ? kR2 : -1;
      case 1:
        return q == 0 ? kR3 : q == 1 ? kR7 : q == 2 ? kR8 : -1;
      case 2:
        return q == 0 ? kR4 : -1;
      default:
        return q == 0 ? kR7 : q == 1 ? kR8 : q == 2 ? kR6 : -1;
    }
  }
  if (g == 0) return q == 0 ? kR2 : q == 1 ? kR4 : -1;
  if (g == 3) return q == 0 ? kR7 : q == 1 ? kR8 : q == 2 ? kR6 : q == 3 ? kR3
                                                                     : -1;
  return -1;
}

// What a job does with its state: the speculative heads never commit,
// rnn4 and rnn6 commit under their masks
__device__ __forceinline__ int job_commit(int g, int s) {
  if (g == 1 && (s == kR7 || s == kR8)) return kCommitNever;
  return s == kR4 || s == kR6 ? kCommitMasked : kCommitAlways;
}

// Offset of stack s's linear1 input in the xin area (linear1_inputs)
__device__ __forceinline__ int job_xin(int g, int s, bool spec) {
  if (s == kR7 || s == kR8) return g == 1 ? 0 : kIn7;
  if (s == kR3) return spec ? 0 : kIn3;
  if (s == kR4) return spec ? 0 : kIn4;
  return 0;
}

// What a block decides at the start of frame t, the same in every block
struct Frame {
  int t, cur, nxt;
  bool spec;    // the refeed may fire: speculative heads and tail run
  bool need46;  // rnn4 and rnn6 run
  bool m4, m6;  // their commit masks (on a spec frame known after its tail)
};

__device__ __forceinline__ int job_of(int g, int q, const Frame& f) {
  const int s = job_stack(g, q, f.spec);
  return s >= 0 && (f.need46 || (s != kR4 && s != kR6)) ? s : -1;
}

// A position in the schedule of streamed pieces: frame, phase, job, piece.
struct Cursor {
  int t, p, q, i;
};

// What the producer reads of each (stack, kind)
struct RunMeta {
  const unsigned char* pk;  // packed records
  int rec, cap, res;
};

// Block state in shared memory: this block's runs, and the producer's
// (kProducer's) walk of the schedule and of the ring.
struct BlockState {
  int runs[kStacks * kKinds][2];  // (first record, count) of each run
  RunMeta meta[kStacks * kKinds];
  Cursor cur;                     // the next piece to copy
  unsigned off;                   // its ring offset, before wrapping
  int seq;                        // pieces started
  unsigned long long v;           // virtual ring position (off + laps)
  unsigned long long vfree;       // virtual end of the last consumed piece
  unsigned long long vend[kBars];  // virtual end of each piece in flight
  float c_now, c_next;  // confidence of the block's frame and the next
  float qscale[8];      // int8: scales of a phase's x, h rows (2 q + side)
  // what the producer needs of the launch, so that it reads nothing else
  uint64_t* bars;
  unsigned char* ring;
  unsigned ring_bytes;
  int T, live;
  float lo;
  // offsets (floats) of each stack's owned units' c and h in the own area
  int own[kStacks];
  // block 0 with a timestamp buffer: the buffer (else null), the bytes of
  // the pieces started so far, and the (frame, phase) of the last of them
  unsigned long long* ts;
  unsigned long long issued;
  int last_tp;
};
constexpr int kStateBytes = 1152;
static_assert(sizeof(BlockState) <= kStateBytes, "block state");

__device__ __forceinline__ BlockState* block_state(const Args& a,
                                                   unsigned char* sm) {
  return reinterpret_cast<BlockState*>(sm + a.lay.state);
}

// One streamed piece: `n` records from `r0` of run idx = s * kKinds + k.
struct Piece {
  int idx, r0, n;
  uint32_t bytes;
};

// The piece at the producer's cursor, moving the cursor past phases, jobs
// and runs that stream nothing. False at the end of the chunk, or where
// which jobs run is not known yet: beyond the next frame (whose confidence
// the block has read), and for live mode's rnn4/rnn6 on an occluded frame
// other than the block's own (they depend on the throttle's counter, known
// once that frame has begun).
__device__ __forceinline__ bool peek_piece(BlockState* bs, int t_cur,
                                           bool need46_cur, Piece& pc) {
  Cursor c = bs->cur;
  bool found = false;
  const float lo = bs->lo;
  while (c.t < bs->T && c.t <= t_cur + 1) {
    if (c.q == 4) {
      c.q = 0;
      if (++c.p == 4 * kKinds) {
        c.p = 0;
        ++c.t;
      }
      continue;
    }
    const float conf = c.t == t_cur ? bs->c_now : bs->c_next;
    const int g = c.p / kKinds, k = c.p % kKinds;
    const int s = job_stack(g, c.q, conf <= lo);
    bool runs = s >= 0;
    if (runs && (s == kR4 || s == kR6) && bs->live && !(conf > lo)) {
      if (c.t != t_cur) break;
      runs = need46_cur;
    }
    const int idx = s * kKinds + k;
    if (runs && !bs->meta[idx].res) {
      const int count = bs->runs[idx][1], cap = bs->meta[idx].cap;
      if (c.i * cap < count) {
        pc.idx = idx;
        pc.r0 = bs->runs[idx][0] + c.i * cap;
        pc.n = min(cap, count - c.i * cap);
        pc.bytes = static_cast<uint32_t>(pc.n * bs->meta[idx].rec);
        found = true;
        break;
      }
    }
    ++c.q;
    c.i = 0;
  }
  bs->cur = c;
  return found;
}

// Byte counts of phase 1 (rnn2's layer 0, with rnn4's where the refeed
// cannot fire) in block 0's timestamp buffer, which tell the bytes a phase
// streams while it runs from those the ring held when it opened: slot 45,
// the bytes started before the phase's first piece; 46, before the phase
// opened (written by kProducer as it leaves the grid barrier before the
// phase); 47, after its last piece. Called as a piece at the cursor starts.
__device__ __forceinline__ void count_piece(BlockState* bs, uint32_t bytes) {
  const int tp = bs->cur.t * 4 * kKinds + bs->cur.p;
  if (tp != bs->last_tp) {
    if (bs->last_tp >= 0 && bs->last_tp % (4 * kKinds) == 1)
      bs->ts[(bs->last_tp / (4 * kKinds)) * kTsSlots + 47] = bs->issued;
    if (bs->cur.p == 1) bs->ts[bs->cur.t * kTsSlots + 45] = bs->issued;
    bs->last_tp = tp;
  }
  bs->issued += bytes;
}

// kProducer: start pieces in schedule order while the ring and its barriers
// have room; `consumed` pieces have been read. The ring is used in order, a
// piece that would cross its end starting again at 0 (consumers place
// pieces by the same rule); the pieces in flight lie in [vfree, v) of the
// virtual ring, and an empty ring takes any piece (none exceeds it). It
// reads only shared memory: on this card a load from the kernel's
// parameters or global memory costs the block's whole chain a round trip.
// Not inlined: inline, its registers pressed on the product loops it is
// called from (spills of 100-224 bytes) and the launch measured slower.
__device__ __noinline__ void pump(BlockState* bs, int consumed, int t_cur,
                                  bool need46_cur) {
  uint64_t* bars = bs->bars;
  unsigned char* ring = bs->ring;
  const unsigned R = bs->ring_bytes;
  Piece pc;
  while (bs->seq - consumed < kBars &&
         peek_piece(bs, t_cur, need46_cur, pc)) {
    unsigned off = bs->off;
    unsigned long long v = bs->v;
    if (off + pc.bytes > R) {
      v += R - off;
      off = 0;
    }
    if (bs->seq != consumed && v + pc.bytes > bs->vfree + R) return;
    uint64_t* bar = bars + (bs->seq & (kBars - 1));
    const RunMeta& m = bs->meta[pc.idx];
    mbar_expect_tx(bar, pc.bytes);
    bulk_copy(ring + off, m.pk + static_cast<size_t>(pc.r0) * m.rec,
              pc.bytes, bar);
    if (bs->ts) count_piece(bs, pc.bytes);
    bs->off = off + pc.bytes;
    bs->v = v + pc.bytes;
    bs->vend[bs->seq & (kBars - 1)] = bs->v;
    ++bs->seq;
    ++bs->cur.i;
  }
}

__device__ __forceinline__ void stamp(const Args& a, int t, int slot) {
  if (a.ts && blockIdx.x == 0 && threadIdx.x == 0)
    a.ts[static_cast<size_t>(t) * kTsSlots + slot] = globaltimer();
}

// In-phase probes of two phases, rnn2's layer 0 (p = 1) and the final
// group's layer 0 (p = 13): once the inputs are in shared memory (int8:
// quantized), and after the records.
__device__ __forceinline__ void probe(const Args& a, int t, int p, int i) {
  if (p == 1 || p == 13) stamp(a, t, (p == 1 ? 48 : 52) + i);
}

__device__ __forceinline__ void gsync(const Args& a, int t, int slot,
                                      cg::grid_group& grid) {
  stamp(a, t, slot);
  grid.sync();
  stamp(a, t, slot + 1);
}

// ---------------------------------------------------------------------------
// Products: records in shared memory against activations in shared memory
// ---------------------------------------------------------------------------

// Reduce R per-lane sums across the warp together. R = 8: halving exchanges
// (4 + 2 + 1 shuffles) then two more, after which lane l holds the sum of
// row 4 b4 + 2 b3 + b2 (bits of l); R = 1: every lane holds the sum.
template <int R, class A>
__device__ __forceinline__ void warp_reduce_rows(A* acc, int lane) {
  if constexpr (R == 8) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool up = lane & 16;
      const A send = up ? acc[k] : acc[k + 4];
      const A keep = up ? acc[k + 4] : acc[k];
      acc[k] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const bool up = lane & 8;
      const A send = up ? acc[k] : acc[k + 2];
      const A keep = up ? acc[k + 2] : acc[k];
      acc[k] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
    }
    {
      const bool up = lane & 4;
      const A send = up ? acc[0] : acc[1];
      const A keep = up ? acc[1] : acc[0];
      acc[0] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
    }
    acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 2);
    acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 1);
  } else {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], off);
  }
}

__device__ __forceinline__ float fma4(float4 w, float4 v, float acc) {
  acc = fmaf(w.x, v.x, acc);
  acc = fmaf(w.y, v.y, acc);
  acc = fmaf(w.z, v.z, acc);
  return fmaf(w.w, v.w, acc);
}

__device__ __forceinline__ float fma8(uint4 w, float4 a, float4 b,
                                      float acc) {
  acc = fmaf(bf16_lo(w.x), a.x, acc);
  acc = fmaf(bf16_hi(w.x), a.y, acc);
  acc = fmaf(bf16_lo(w.y), a.z, acc);
  acc = fmaf(bf16_hi(w.y), a.w, acc);
  acc = fmaf(bf16_lo(w.z), b.x, acc);
  acc = fmaf(bf16_hi(w.z), b.y, acc);
  acc = fmaf(bf16_lo(w.w), b.z, acc);
  return fmaf(bf16_hi(w.w), b.w, acc);
}

__device__ __forceinline__ int dp16(int4 w, int4 v, int acc) {
  acc = __dp4a(w.x, v.x, acc);
  acc = __dp4a(w.y, v.y, acc);
  acc = __dp4a(w.z, v.z, acc);
  return __dp4a(w.w, v.w, acc);
}

// The sums of n <= kWarps records of R rows (item type W, rows of lp items,
// records of `rec` bytes at `src`) against x (rows 0-3 of a unit, or the
// one row) and h (rows 4-7): G warps per record, each over every G-th
// 32-lane stretch of 16-byte chunks. Warp w writes its R sums to
// parts[8 w + r] (int32 bits for int8 rows) and the first `ntail` floats
// after the record's rows (biases, scales) to parts[8 kWarps + 12 (w / G) +
// i]. Returns G.
template <class W, int R>
__device__ __forceinline__ int record_sums(const unsigned char* src, int rec,
                                           int lp, int n, const void* xa,
                                           const void* ha, int ntail,
                                           float* parts) {
  constexpr bool kI8 = std::is_same<W, int8_t>::value;
  using A = typename std::conditional<kI8, int, float>::type;
  const int nc = lp * static_cast<int>(sizeof(W)) / 16;
  int G = 1;
  while (2 * G * n <= kWarps && 64 * G <= nc + 31) G *= 2;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r_i = w / G;
  if (r_i >= n) return G;
  const unsigned char* base = src + static_cast<size_t>(r_i) * rec;
  const int row_bytes = lp * static_cast<int>(sizeof(W));
  A acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0;
  for (int c = (w % G) * 32 + lane; c < nc; c += 32 * G) {
    if constexpr (kI8) {
      const int4 xv = reinterpret_cast<const int4*>(xa)[c];
      const int4 hv = reinterpret_cast<const int4*>(ha)[c];
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] = dp16(reinterpret_cast<const int4*>(base + r * row_bytes)[c],
                      r < 4 ? xv : hv, acc[r]);
    } else if constexpr (sizeof(W) == 2) {
      const float4* x4 = reinterpret_cast<const float4*>(xa);
      const float4* h4 = reinterpret_cast<const float4*>(R == 8 ? ha : xa);
      const float4 x0 = x4[2 * c], x1 = x4[2 * c + 1];
      const float4 h0 = h4[2 * c], h1 = h4[2 * c + 1];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint4 wv =
            reinterpret_cast<const uint4*>(base + r * row_bytes)[c];
        acc[r] = r < 4 ? fma8(wv, x0, x1, acc[r]) : fma8(wv, h0, h1, acc[r]);
      }
    } else {
      const float4 xv = reinterpret_cast<const float4*>(xa)[c];
      const float4 hv =
          reinterpret_cast<const float4*>(R == 8 ? ha : xa)[c];
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] = fma4(reinterpret_cast<const float4*>(base + r * row_bytes)[c],
                      r < 4 ? xv : hv, acc[r]);
    }
  }
  warp_reduce_rows<R>(acc, lane);
  float* sums = parts + 8 * w;
  if constexpr (R == 8) {
    if ((lane & 3) == 0) {
      const int r = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 +
                    ((lane >> 2) & 1);
      if constexpr (kI8)
        sums[r] = __int_as_float(acc[0]);
      else
        sums[r] = acc[0];
    }
  } else if (lane == 0) {
    sums[0] = acc[0];
  }
  if (w % G == 0 && lane < ntail)
    parts[8 * kWarps + 12 * r_i + lane] =
        reinterpret_cast<const float*>(base + R * row_bytes)[lane];
  return G;
}

// One job of a phase: its stack, what it does with its state; where this
// phase's inputs of its products are (x and h; int8: quantized, with their
// scales); and the committed c and h of the block's own units of the layer
// (from `start`), which the block keeps in shared memory across frames.
struct Job {
  int s, commit;
  bool mask;
  const void* xa;
  const void* ha;
  float* own_c;
  float* own_h;
  int start;
  float sx, sh;
};

// Record i of a batch of linear1 or linear2 rows, after its sums: linear1
// (int8 mode: rounded to bf16 and the bias added in bf16) -> ReLU, or
// linear2 (int8 mode: bias in bf16).
template <class M>
__device__ __forceinline__ void finish_dense(const Stack& s, int k, int r,
                                             const float* parts, int i,
                                             int G) {
  const float* tl = parts + 8 * kWarps + 12 * i;  // bias
  float v = parts[8 * (i * G)];
  for (int g = 1; g < G; ++g) v += parts[8 * (i * G + g)];
  if (k == 0) {
    if constexpr (M::kInt8)
      s.y1[r] = fmaxf(bf16r(bf16r(v) + bf16r(tl[0])), 0.f);
    else
      s.y1[r] = fmaxf(v + tl[0], 0.f);
  } else {
    if constexpr (M::kInt8)
      s.out[r] = bf16r(bf16r(v) + bf16r(tl[0]));
    else
      s.out[r] = v + tl[0];
  }
}

// The m units of a batch of layer records from unit r_first, after their
// sums: the gates and cell update of each (as lstm_cell.cuh's lstm_unit),
// four lanes a unit: lane g of a group of four (threads 4 i .. 4 i + 3 for
// unit i) merges gate g's sums and takes its nonlinearity, and the group's
// first lane updates the cell. Every lane of the calling warps takes part
// in the exchange; lanes past the batch compute unit m - 1 and store
// nothing.
template <class M>
__device__ __forceinline__ void finish_units(const Args& a, const Job& jb,
                                             int k, int r_first,
                                             const float* parts, int m, int G,
                                             const Frame& f) {
  const Stack& s = a.st[jb.s];
  const int i = min(static_cast<int>(threadIdx.x >> 2), m - 1);
  const int g = threadIdx.x & 3;
  const float* tl = parts + 8 * kWarps + 12 * i;  // biases; int8: scales
  const float* ps = parts + 8 * (i * G);
  float act;
  if constexpr (M::kInt8) {
    // the JAX int8 cell: zx and zh rescaled in float32 and rounded to bf16,
    // their sum and the bias added in bf16; transcendentals in float32
    // rounded to bf16; the cell update in bf16
    int zx = __float_as_int(ps[g]), zh = __float_as_int(ps[4 + g]);
    for (int w = 1; w < G; ++w) {
      zx += __float_as_int(ps[8 * w + g]);
      zh += __float_as_int(ps[8 * w + 4 + g]);
    }
    const float x = bf16r(static_cast<float>(zx) * jb.sx * tl[4 + g]);
    const float h = bf16r(static_cast<float>(zh) * jb.sh * tl[8 + g]);
    const float z = bf16r(bf16r(x + h) + bf16r(tl[g]));
    act = bf16r(g == 2 ? tanhf(z) : sigmoidf(z));
  } else {
    float zx = ps[g], zh = ps[4 + g];
    for (int w = 1; w < G; ++w) {
      zx += ps[8 * w + g];
      zh += ps[8 * w + 4 + g];
    }
    const float z = zx + zh + tl[g];
    act = g == 2 ? tanhf(z) : sigmoidf(z);
  }
  const int base = threadIdx.x & 28;
  const float ig = __shfl_sync(0xffffffffu, act, base);
  const float fg = __shfl_sync(0xffffffffu, act, base + 1);
  const float gg = __shfl_sync(0xffffffffu, act, base + 2);
  const float og = __shfl_sync(0xffffffffu, act, base + 3);
  if (g != 0 || static_cast<int>(threadIdx.x >> 2) >= m) return;
  const int l = k - 1, H = s.H, j = r_first + i;
  const int o = j - jb.start;
  const float c_old = jb.own_c[o];
  float cn, hn;
  if constexpr (M::kInt8) {
    cn = bf16r(bf16r(fg * bf16r(c_old)) + bf16r(ig * gg));
    hn = bf16r(og * bf16r(tanhf(cn)));
  } else {
    cn = fg * c_old + ig * gg;
    hn = og * tanhf(cn);
  }
  s.hn[l * H + j] = hn;
  if (jb.commit == kCommitNever) return;
  const bool keep_new = jb.commit == kCommitAlways || jb.mask;
  const float c_keep = keep_new ? cn : c_old;
  const float h_keep = keep_new ? hn : jb.own_h[o];
  jb.own_c[o] = c_keep;
  jb.own_h[o] = h_keep;
  s.cs[l * H + j] = c_keep;
  s.hs[static_cast<size_t>(l * 2 + f.nxt) * H + j] = h_keep;
}

// The consumer side of the ring, the same in every thread of a block: the
// next piece's offset, the pieces read, the partial-sum buffer in use.
struct Consumer {
  unsigned off;
  int seq;
  int pbuf;
};

// n records of job jb, kind k, from r0, at `src` in shared memory, in
// batches of kWarps. `streamed`: the records are the ring's current piece,
// freed after the last batch's sums (kProducer then starts more).
template <class M>
__device__ __forceinline__ void run_records(const Args& a, unsigned char* sm,
                                            Consumer& cn, const Job& jb,
                                            int k, const unsigned char* src,
                                            int r0, int n, bool streamed,
                                            const Frame& f) {
  const Stack& s = a.st[jb.s];
  const int rec = s.rec[k], lp = s.lp[k];
  const bool layer = k == 1 || k == 2;
  const int ntail = layer ? (M::kInt8 ? 12 : 4) : 1;
  float* parts0 = reinterpret_cast<float*>(sm + a.lay.parts);
  for (int b0 = 0; b0 < n; b0 += kWarps) {
    const int m = min(kWarps, n - b0);
    cn.pbuf ^= 1;
    float* parts = parts0 + cn.pbuf * kPartF;
    const unsigned char* p = src + static_cast<size_t>(b0) * rec;
    const int G =
        layer ? record_sums<typename M::Gate, 8>(p, rec, lp, m, jb.xa, jb.ha,
                                                 ntail, parts)
              : record_sums<typename M::Dense, 1>(p, rec, lp, m, jb.xa,
                                                  nullptr, ntail, parts);
    __syncthreads();
    if (streamed && b0 + m == n && threadIdx.x == kProducer) {
      BlockState* bs = block_state(a, sm);
      bs->vfree = bs->vend[cn.seq & (kBars - 1)];
      fence_async_smem();
      pump(bs, cn.seq + 1, f.t, f.need46);
    }
    if (!layer) {
      if (threadIdx.x < m)
        finish_dense<M>(s, k, r0 + b0 + threadIdx.x, parts, threadIdx.x, G);
    } else if (threadIdx.x < 32 * ((4 * m + 31) / 32)) {
      finish_units<M>(a, jb, k, r0 + b0, parts, m, G, f);
    }
  }
}

// The run of (job's stack, kind k) that this block owns: from the resident
// area, or piece by piece through the ring.
template <class M>
__device__ __forceinline__ void run_job(const Args& a, unsigned char* sm,
                                        Consumer& cn, const Job& jb, int k,
                                        const Frame& f) {
  const Stack& s = a.st[jb.s];
  const BlockState* bs = block_state(a, sm);
  const int start = bs->runs[jb.s * kKinds + k][0];
  const int count = bs->runs[jb.s * kKinds + k][1];
  if (count == 0) return;
  if (s.res[k]) {
    run_records<M>(a, sm, cn, jb, k, sm + a.lay.res + s.res_off[k], start,
                   count, false, f);
    return;
  }
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + a.lay.bars);
  const int cap = s.cap[k];
  for (int i = 0; i * cap < count; ++i) {
    const int n = min(cap, count - i * cap);
    const unsigned bytes = static_cast<unsigned>(n * s.rec[k]);
    if (cn.off + bytes > static_cast<unsigned>(a.lay.ring_bytes)) cn.off = 0;
    const unsigned char* src = sm + a.lay.ring + cn.off;
    cn.off += bytes;
    mbar_wait(bars + (cn.seq & (kBars - 1)), (cn.seq / kBars) & 1);
    run_records<M>(a, sm, cn, jb, k, src, start + i * cap, n, true, f);
    ++cn.seq;
  }
}

__device__ __forceinline__ int pad16(int n) { return (n + 15) & ~15; }
__device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }

// Floats of a job's inputs in the activation area: x and h
__device__ __forceinline__ int job_floats(const Stack& s) {
  return 2 * pad16(s.H);
}

// Stacks are at most kMaxH wide: a thread gathers a vector's elements in
// one round of kPer = kMaxH / kThreads loads
constexpr int kMaxH = 3 * kThreads;
constexpr int kPer = kMaxH / kThreads;

// int8 mode, a layer phase: each job's x and h rows quantized per row
// (nn.rnn.quantize_activation) from the values the block's threads hold in
// registers (v[q][side][u]: element threadIdx.x + u kThreads, bf16-rounded,
// zero past H): every row's |max| reduced over the block in one pass, the
// int8 rows into actq (job order, 2 pad16(H) bytes a job) and the scales
// into bs->qscale[2 q + side]. The caller's block barrier publishes them.
template <class M>
__device__ __forceinline__ void quantize_inputs(const Args& a,
                                                unsigned char* sm, int g,
                                                const Frame& f,
                                                const float (&v)[4][2][kPer]) {
  int8_t* actq = reinterpret_cast<int8_t*>(sm + a.lay.actq);
  float* red = reinterpret_cast<float*>(sm + a.lay.red);
  BlockState* bs = block_state(a, sm);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float m[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m[r] = 0.f;
#pragma unroll
    for (int u = 0; u < kPer; ++u) m[r] = fmaxf(m[r], fabsf(v[r / 2][r % 2][u]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < 8; ++r)
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], o));
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < 8; ++r) red[r * kWarps + w] = m[r];
  }
  __syncthreads();
  // every warp reduces each row's kWarps partial maxes itself
#pragma unroll
  for (int r = 0; r < 8; ++r) m[r] = red[r * kWarps + (lane & (kWarps - 1))];
#pragma unroll
  for (int o = kWarps / 2; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < 8; ++r)
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], o));
  int qoff = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int si = job_of(g, q, f);
    if (si < 0) continue;
    const int hp = pad16(a.st[si].H);
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const float scale = fmaxf(m[2 * q + side], 1e-12f) / 127.f;
      if (threadIdx.x == 0) bs->qscale[2 * q + side] = scale;
      int8_t* qv = actq + qoff + side * hp;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int i = threadIdx.x + u * kThreads;
        // zero padding quantizes to zero
        if (i < hp)
          qv[i] = static_cast<int8_t>(fminf(
              fmaxf(rintf(v[q][side][u] / scale), -127.f), 127.f));
      }
    }
    qoff += 2 * hp;
  }
}

// One phase (kind k) of group g: the inputs of the jobs that run into
// shared memory (as the mode's products read them, zero-padded to whole
// chunks; a layer's also the old c and h of the block's units; int8 mode
// quantizes [x ; h] per row), then each job's run of records.
template <class M>
__device__ __forceinline__ void phase(const Args& a, unsigned char* sm,
                                      Consumer& cn, int g, int k,
                                      const Frame& f) {
  const int p = g * kKinds + k;
  float* xin = reinterpret_cast<float*>(sm + a.lay.xin);
  float* acts = reinterpret_cast<float*>(sm + a.lay.act);
  BlockState* bs = block_state(a, sm);
  const bool layer = k == 1 || k == 2;
  int off = 0;
  if (k == 0) {
    if (threadIdx.x == kProducer) pump(bs, cn.seq, f.t, f.need46);
    // linear1: the inputs are in xin; zero the padding of each row
#pragma unroll 1
    for (int q = 0; q < 4; ++q) {
      const int si = job_of(g, q, f);
      if (si < 0) continue;
      const Stack& s = a.st[si];
      float* xi = xin + job_xin(g, si, f.spec);
      for (int i = s.in + threadIdx.x; i < s.lp[0]; i += kThreads)
        xi[i] = 0.f;
    }
  } else {
    // every job's x (and h) from global memory, as the mode's products
    // read them: all of a thread's loads first, then the producer's turn
    // while they are in flight, then the stores, so that the phase waits
    // one round trip
    float v[4][2][kPer];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int si = job_of(g, q, f);
      const Stack& s = a.st[si < 0 ? 0 : si];
      const int H = si < 0 ? 0 : s.H;
      const float* src = k == 1 ? s.y1 : (k == 2 ? s.hn : s.hn + s.H);
      const float* h = s.hs + static_cast<size_t>((k - 1) * 2 + f.cur) * s.H;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int i = threadIdx.x + u * kThreads;
        v[q][0][u] = i < H ? src[i] : 0.f;
        v[q][1][u] = layer && i < H ? h[i] : 0.f;
      }
    }
    if (threadIdx.x == kProducer) pump(bs, cn.seq, f.t, f.need46);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int side = 0; side < 2; ++side)
#pragma unroll
        for (int u = 0; u < kPer; ++u) v[q][side][u] = act<M>(v[q][side][u]);
    if (M::kInt8 && layer) {
      quantize_inputs<M>(a, sm, g, f, v);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int si = job_of(g, q, f);
        if (si < 0) continue;
        const int hp = pad16(a.st[si].H);
        float* xs = acts + off;
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int i = threadIdx.x + u * kThreads;
          if (i < hp) {
            xs[i] = v[q][0][u];
            if (layer) xs[hp + i] = v[q][1][u];
          }
        }
        off += job_floats(a.st[si]);
      }
    }
  }
  __syncthreads();
  probe(a, f.t, p, 0);
  const int8_t* actq = reinterpret_cast<const int8_t*>(sm + a.lay.actq);
  off = 0;
  int qoff = 0;
#pragma unroll 1
  for (int q = 0; q < 4; ++q) {
    const int si = job_of(g, q, f);
    if (si < 0) continue;
    const Stack& s = a.st[si];
    const int hp = pad16(s.H);
    Job jb;
    jb.s = si;
    jb.commit = job_commit(g, si);
    jb.mask = si == kR4 ? f.m4 : f.m6;
    jb.xa = k == 0 ? static_cast<const void*>(xin + job_xin(g, si, f.spec))
                   : acts + off;
    jb.ha = acts + off + hp;
    jb.own_c = reinterpret_cast<float*>(sm + a.lay.own) + bs->own[si] +
               (k == 2 ? 2 * pad4(s.mc) : 0);
    jb.own_h = jb.own_c + pad4(s.mc);
    jb.start = bs->runs[si * kKinds + k][0];
    jb.sx = jb.sh = 0.f;
    if (M::kInt8 && layer) {
      jb.xa = actq + qoff;
      jb.ha = actq + qoff + hp;
      jb.sx = bs->qscale[2 * q];
      jb.sh = bs->qscale[2 * q + 1];
    }
    run_job<M>(a, sm, cn, jb, k, f);
    off += job_floats(s);
    qoff += 2 * hp;
  }
  probe(a, f.t, p, 1);
}

// A stack that is skipped this frame carries its h into the next slot (c
// stays where it is).
__device__ void keep_state(const Stack& s, int cur, int nxt) {
  const int gt = blockIdx.x * kThreads + threadIdx.x;
  const int nt = gridDim.x * kThreads;
  for (int i = gt; i < 2 * s.H; i += nt) {
    const int l = i / s.H, j = i % s.H;
    s.hs[static_cast<size_t>(l * 2 + nxt) * s.H + j] =
        s.hs[static_cast<size_t>(l * 2 + cur) * s.H + j];
  }
}

// The gated joints of frame t into dst [69]: out4_eff rotated by Rcr,
// lerped with the inertial joints by confidence; as a product of mode M
// reads them with ``round``, else in float32 (init_net's input).
template <class M>
__device__ void load_j3dr(const Args& a, int t, float* dst, bool round) {
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

// Block 0 runs each tail on shared-memory copies of everything it reads
// (its body-model constants, copied once per launch into the tconst area;
// the frame's inputs and the carry, staged into the activation area, which
// no phase uses while a tail runs) and writes its outputs there: the tail's
// serial steps then wait on shared memory, not on L2, which the 227 KB of
// shared memory leave little L1 in front of. A frame's staging is one
// element per thread, one load each.
// Floats of the staging area: inputs, carry, outputs (kOff*), their ints.
constexpr int kStOut7 = 0;       // [144]
constexpr int kStOut8 = 144;     // [2]
constexpr int kStVr = 148;       // [3]
constexpr int kStPc = 152;       // [3]
constexpr int kStRcr = 156;      // [9]
constexpr int kStC = 168;        // c, k_lerp
constexpr int kStFirstTran = 172;  // [3]
constexpr int kStGrav = 176;     // [3]
constexpr int kStLastPfoot = 180;  // [6]
constexpr int kStLastTran = 188;   // [3]
constexpr int kStFloor = 192;    // [33]
constexpr int kStJtemp = 228;    // [99]
constexpr int kStInts = 328;     // floor_cnt, vision_count; has (2 bytes)
constexpr int kStOut = 332;      // [530] the tail's f32 outputs (kOff*)
constexpr int kStOutI = 864;     // floor_cnt, vision_count out
constexpr int kStFloats = 868;
// Floats of the tconst area: parent (int bits), bone, j0, wsub, v0sub
constexpr int kTcParent = 0, kTcBone = 24, kTcJ0 = 96, kTcWsub = 168,
              kTcV0sub = 960;

// Thread i copies element i of the segments laid end to end (4-byte
// items): one load a thread.
struct Seg {
  const void* src;
  int n, dst;
};
template <int N>
__device__ __forceinline__ void copy_segs(const Seg (&seg)[N], float* dst) {
  int i = threadIdx.x;
#pragma unroll
  for (int s = 0; s < N; ++s) {
    if (i >= 0 && i < seg[s].n)
      dst[seg[s].dst + i] = reinterpret_cast<const float*>(seg[s].src)[i];
    i -= seg[s].n;
  }
}

// Block 0, once per launch: the tail's body-model constants into tconst.
__device__ void stage_tail_constants(const Args& a, float* tc) {
  const int tid = threadIdx.x;
  for (int i = tid; i < 24; i += kThreads)
    tc[kTcParent + i] = __int_as_float(a.parent[i]);
  for (int i = tid; i < 72; i += kThreads) {
    tc[kTcBone + i] = a.bone[i];
    tc[kTcJ0 + i] = a.j0[i];
  }
  for (int i = tid; i < 33 * 24; i += kThreads) tc[kTcWsub + i] = a.wsub[i];
  for (int i = tid; i < 99; i += kThreads) tc[kTcV0sub + i] = a.v0sub[i];
}

// Block 0: tail w (0 speculative, 1 final) of frame t, with pc its
// absolute-position input; outputs in st + kStOut, st + kStOutI.
__device__ void run_tail(const Args& a, unsigned char* sm, int t,
                         const float* pc, TailShared& tsh) {
  float* st = reinterpret_cast<float*>(sm + a.lay.act);
  const float* tc = reinterpret_cast<const float*>(sm + a.lay.tconst);
  const Seg seg[] = {{a.st[kR7].out, 144, kStOut7},
                     {a.st[kR8].out, 2, kStOut8},
                     {a.st[kR3].out, 3, kStVr},
                     {pc, 3, kStPc},
                     {a.rcr + 9 * t, 9, kStRcr},
                     {a.c + t, 1, kStC},
                     {a.k_lerp + t, 1, kStC + 1},
                     {a.first_tran + 3 * t, 3, kStFirstTran},
                     {a.grav + 3 * t, 3, kStGrav},
                     {a.last_pfoot, 6, kStLastPfoot},
                     {a.last_tran, 3, kStLastTran},
                     {a.floor_buf, 33, kStFloor},
                     {a.j_temp, 99, kStJtemp},
                     {a.ints, 2, kStInts}};
  copy_segs(seg, st);
  unsigned char* has = reinterpret_cast<unsigned char*>(st + kStInts + 2);
  if (threadIdx.x == kThreads - 1) {
    has[0] = a.has[0];
    has[1] = a.has[1];
  }
  TailArgs ta;
  ta.out7 = st + kStOut7;
  ta.out8 = st + kStOut8;
  ta.rcr = st + kStRcr;
  ta.vr = st + kStVr;
  ta.pc = st + kStPc;
  ta.c = st + kStC;
  ta.k_lerp = st + kStC + 1;
  ta.first_tran = st + kStFirstTran;
  ta.grav = st + kStGrav;
  ta.last_pfoot = st + kStLastPfoot;
  ta.has_pfoot = has;
  ta.last_tran = st + kStLastTran;
  ta.has_tran = has + 1;
  ta.floor_buf = st + kStFloor;
  ta.floor_cnt = reinterpret_cast<const int*>(st + kStInts);
  ta.vision_count = reinterpret_cast<const int*>(st + kStInts + 1);
  ta.j_temp = st + kStJtemp;
  ta.parent = reinterpret_cast<const int*>(tc + kTcParent);
  ta.bone = tc + kTcBone;
  ta.j0 = tc + kTcJ0;
  ta.wsub = tc + kTcWsub;
  ta.v0sub = tc + kTcV0sub;
  ta.pd = a.pd;
  float* f = st + kStOut;
  ta.pose = f + kOffPose;
  ta.tran = f + kOffTran;
  ta.contact = f + kOffContact;
  ta.pfoot = f + kOffPfoot;
  ta.floor_buf_out = f + kOffFloor;
  ta.floor_cnt_out = reinterpret_cast<int*>(st + kStOutI);
  ta.vision_count_out = reinterpret_cast<int*>(st + kStOutI + 1);
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
  __syncthreads();
  tail_block(ta, tsh);
  __syncthreads();
}

// Block 0, after the speculative tail: the refeed condition and the
// synthetic keypoints j_lm / j_lm.z (bbox-normalised for rnn4, raw for
// rnn6) and joint[1:] - joint[0].
__device__ void synthetic(const Args& a, int t, const float* st,
                          float* s_scale) {
  const float* jl = st + kStOut + kOffJlm;
  const float* joint = st + kStOut + kOffJoint;
  const int* out_i = reinterpret_cast<const int*>(st + kStOutI);
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
                    (!a.live || out_i[1] == a.update_vision_freq);
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
__device__ void commit_frame(const Args& a, int t, const float* st,
                             bool conf_full) {
  const float* f = st + kStOut;
  const int* out_i = reinterpret_cast<const int*>(st + kStOutI);
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
    a.ints[0] = out_i[0];
    a.ints[1] = out_i[1];
    a.has[0] = 1;
    a.has[1] = 1;
    if (a.use_imu && conf_full) a.ints[2] = 0;
  }
}

// One init_net layer: rows [n] of w [n, m] (global, f32) on x (shared
// memory) -> out, ReLU on all but the last layer. The last layer writes
// rnn2's state for the next frame: h of layer l at rows [l H, (l+1) H), c at
// [(2+l) H, ...). The IMU updater fires once a stream, so this reads its
// rows straight from global memory, a warp a row.
__device__ void init_layer(const Args& a, int li, const float* x, int m,
                           int nxt) {
  const int n = a.init_n[li];
  const Stack& s2 = a.st[kR2];
  const int H = s2.H, lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kWarps + (threadIdx.x >> 5);
  for (int r = gw; r < n; r += gridDim.x * kWarps) {
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

// Items copied from global memory into shared memory: all of a thread's
// loads first, then its stores (as the mode's products read them where
// `round`), so that the copy waits one round trip.
struct Gather {
  const float* src;
  float* dst;
  int n;
  bool round;
};
template <class M, int S>
__device__ __forceinline__ void gather(const Gather (&g)[S]) {
  constexpr int U = 2;
  int total = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) total += g[s].n;
  for (int base = threadIdx.x; base < total; base += U * kThreads) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int i = base + u * kThreads;
      v[u] = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (i >= 0 && i < g[s].n) v[u] = g[s].src[i];
        i -= g[s].n;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int i = base + u * kThreads;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (i >= 0 && i < g[s].n)
          g[s].dst[i] = g[s].round ? act<M>(v[u]) : v[u];
        i -= g[s].n;
      }
    }
  }
}

// The linear1 inputs of group g of frame t into xin, as the mode's products
// read them (job_xin): rnn2 [in2]; rnn3 and the speculative heads
// [in2, out2]; rnn4 [raw72, keypoints]; rnn6 [raw72, keypoints, joints] and
// the final heads [in2, j3dr]. Keypoints and joints are the synthetic ones
// when the refeed fires (vu). Where it cannot (not spec), group 0 also has
// rnn4's and group 3 rnn3's. The gated joints j3dr (load_j3dr's arithmetic)
// come from copies staged in `st`.
template <class M>
__device__ __forceinline__ void linear1_inputs(const Args& a, float* xin,
                                               float* st, int g, int t,
                                               bool spec, bool vu) {
  const float* in2 = a.in2 + 72 * t;
  const float* raw = a.raw72 + 72 * t;
  const float* out2 = a.st[kR2].out;
  if (g != 3) {
    const bool with4 = g == 2 || (g == 0 && !spec);
    float* x4 = xin + (g == 2 ? 0 : kIn4);
    const float* kp = vu ? a.syn + kSynNorm : a.j2n + 99 * t;
    const Gather seg[] = {{in2, xin, g < 2 ? 72 : 0, true},
                          {out2, xin + 72, g == 1 ? 69 : 0, true},
                          {raw, x4, with4 ? 72 : 0, true},
                          {kp, x4 + 72, with4 ? 99 : 0, true}};
    gather<M>(seg);
    return;
  }
  const float* kp = vu ? a.syn + kSynRaw : a.j2r + 99 * t;
  const float* o4 = a.ff[t] != 0 ? a.out4_first : a.st[kR4].out;
  const Gather seg[] = {{raw, xin, 72, true},
                        {kp, xin + 72, 99, true},
                        {vu ? a.syn + kSynJ3 : o4, xin + 171, 69, true},
                        {in2, xin + kIn7, 72, true},
                        {in2, xin + kIn3, spec ? 0 : 72, true},
                        {out2, xin + kIn3 + 72, spec ? 0 : 69, true},
                        {o4, st, 69, false},
                        {out2, st + 72, 69, false},
                        {a.rcr + 9 * t, st + 144, 9, false},
                        {a.c + t, st + 156, 1, false},
                        {a.k_lerp + t, st + 157, 1, false}};
  gather<M>(seg);
  __syncthreads();
  const float c = st[156], k = st[157];
  const float* R = st + 144;
  for (int i = threadIdx.x; i < 69; i += kThreads) {
    const int n = i / 3, r = i % 3;
    const float v = st[3 * n] * R[r] + st[3 * n + 1] * R[3 + r] +
                    st[3 * n + 2] * R[6 + r];
    const float j =
        c >= a.hi ? v : (c > a.lo ? st[72 + i] * (1.f - k) + v * k
                                  : st[72 + i]);
    xin[kIn7 + 72 + i] = act<M>(j);
  }
}

// The committed c and h of the block's own units of stack `only` (-1:
// every stack), both layers, from global memory (h from slot `slot`)
__device__ void load_own(const Args& a, unsigned char* sm,
                         const BlockState* bs, int only, int slot) {
  float* own = reinterpret_cast<float*>(sm + a.lay.own);
  for (int si = 0; si < kStacks; ++si) {
    if (only >= 0 && si != only) continue;
    const Stack& s = a.st[si];
    const int mp = pad4(s.mc), H = s.H;
    for (int l = 0; l < 2; ++l) {
      const int start = bs->runs[si * kKinds + 1 + l][0];
      const int count = bs->runs[si * kKinds + 1 + l][1];
      float* oc = own + bs->own[si] + 2 * l * mp;
      for (int i = threadIdx.x; i < count; i += kThreads) {
        oc[i] = s.cs[l * H + start + i];
        oc[mp + i] = s.hs[static_cast<size_t>(l * 2 + slot) * H + start + i];
      }
    }
  }
}

template <class M>
__global__ void __launch_bounds__(kThreads, 1)
    serve_scan_kernel(const __grid_constant__ Args a) {
  cg::grid_group grid = cg::this_grid();
  unsigned char* sm = dynamic_smem();
  const int tid = threadIdx.x;
  BlockState* bs = block_state(a, sm);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + a.lay.bars);
  uint64_t* res_bar = bars + kBars;
  float* xin = reinterpret_cast<float*>(sm + a.lay.xin);
  float* s_scale = reinterpret_cast<float*>(sm + a.lay.red) + kWarps * 8;
  TailShared& tsh = *reinterpret_cast<TailShared*>(sm + a.lay.tail);
  const float* stage = reinterpret_cast<const float*>(sm + a.lay.act);
  Consumer cn{0, 0, 0};
  bool iu_prev = false;

  // this block's runs; the ring's barriers; the resident runs, copied once
  if (tid < kStacks * kKinds) {
    const int* row = a.starts + tid * (a.nb + 1) + blockIdx.x;
    const Stack& st = a.st[tid / kKinds];
    const int k = tid % kKinds;
    bs->runs[tid][0] = row[0];
    bs->runs[tid][1] = row[1] - row[0];
    bs->meta[tid] = RunMeta{st.pk[k], st.rec[k], st.cap[k], st.res[k]};
  }
  if (blockIdx.x == 0)
    stage_tail_constants(a, reinterpret_cast<float*>(sm + a.lay.tconst));
  if (tid == 0) {
    for (int i = 0; i <= kBars; ++i) mbar_init(bars + i);
    mbar_fence_init();
    bs->cur = Cursor{0, 0, 0, 0};
    bs->off = 0;
    bs->seq = 0;
    bs->v = 0;
    bs->vfree = 0;
    bs->bars = bars;
    bs->ring = sm + a.lay.ring;
    bs->ring_bytes = static_cast<unsigned>(a.lay.ring_bytes);
    bs->T = a.T;
    bs->live = a.live;
    bs->lo = a.lo;
    bs->ts = blockIdx.x == 0 ? a.ts : nullptr;
    bs->issued = 0;
    bs->last_tp = -1;
    int o = 0;
    for (int i = 0; i < kStacks; ++i) {
      bs->own[i] = o;
      o += 4 * pad4(a.st[i].mc);
    }
  }
  __syncthreads();
  load_own(a, sm, bs, -1, 0);
  if (tid == 0) {
    uint32_t total = 0;
    for (int i = 0; i < kStacks * kKinds; ++i)
      if (a.st[i / kKinds].res[i % kKinds])
        total += bs->runs[i][1] * a.st[i / kKinds].rec[i % kKinds];
    mbar_expect_tx(res_bar, total);
    for (int i = 0; i < kStacks * kKinds; ++i) {
      const Stack& st = a.st[i / kKinds];
      const int k = i % kKinds, count = bs->runs[i][1];
      if (st.res[k] && count > 0)
        bulk_copy(sm + a.lay.res + st.res_off[k],
                  st.pk[k] + static_cast<size_t>(bs->runs[i][0]) * st.rec[k],
                  count * st.rec[k], res_bar);
    }
  }

#pragma unroll 1
  for (int t = 0; t < a.T; ++t) {
    // start-of-frame values every block reads before the frame's first
    // barrier; block 0 rewrites them only in the frame's last phase
    const float c = a.c[t];
    const bool ff = a.ff[t] != 0;
    const bool conf_vis = c > a.lo;
    const bool conf_full = c >= a.hi;
    const bool first_reach = a.ints[2] != 0;
    Frame f;
    f.t = t;
    f.cur = t & 1;
    f.nxt = f.cur ^ 1;
    // live mode: rnn4/rnn6 are observable only on a visible frame or when
    // the refeed commits (occluded and the throttle's counter at 0)
    f.need46 = !a.live || conf_vis || a.ints[1] == 0;
    // the refeed can fire only on a frame with c <= lo; on any other the
    // speculative heads and tail feed nothing, vu is 0 and the masks are
    // known now
    f.spec = c <= a.lo;
    f.m4 = conf_vis && !ff;
    f.m6 = conf_vis;
    stamp(a, t, 0);
    if (tid == kProducer) {
      bs->c_now = c;
      bs->c_next = t + 1 < a.T ? a.c[t + 1] : 0.f;
      pump(bs, cn.seq, t, f.need46);
    }
    if (t == 0) mbar_wait(res_bar, 0);
    // the IMU updater rewrote rnn2's (h, c) of every unit last frame
    if (t > 0 && iu_prev) load_own(a, sm, bs, kR2, f.cur);
    if (!f.need46) {
      keep_state(a.st[kR4], f.cur, f.nxt);
      keep_state(a.st[kR6], f.cur, f.nxt);
    }
    if (!f.spec && blockIdx.x == 0 && tid == 0) a.ints[3] = 0;

    bool vu = false;
#pragma unroll 1
    for (int g = 0; g < 4; ++g) {
      if ((g == 1 || g == 2) && !f.spec) continue;
      if (g == 2 && !f.need46) continue;
      linear1_inputs<M>(a, xin, reinterpret_cast<float*>(sm + a.lay.act), g,
                        t, f.spec, vu);
#pragma unroll 1
      for (int k = 0; k < kKinds; ++k) {
        phase<M>(a, sm, cn, g, k, f);
        gsync(a, t, 1 + 2 * (g * kKinds + k), grid);
        if (g == 0 && k == 0 && tid == kProducer && bs->ts)
          bs->ts[static_cast<size_t>(t) * kTsSlots + 46] = bs->issued;
      }
      if (g != 1) continue;
      // speculative tail on the inertial joints with pc_first, then the
      // synthetic keypoints
      if (blockIdx.x == 0) {
        stamp(a, t, 33);
        run_tail(a, sm, t, a.pc_first, tsh);
        synthetic(a, t, stage, s_scale);
        __syncthreads();
        stamp(a, t, 34);
      }
      gsync(a, t, 35, grid);
      vu = a.ints[3] != 0;
      f.m4 = (conf_vis && !ff) || vu;
      f.m6 = conf_vis || vu;
    }

    // final tail and the carry (block 0); the IMU updater's init_net
    // (every block, only on the frame where it fires)
    const bool iu = a.use_imu && conf_full && first_reach;
    iu_prev = iu;
    if (blockIdx.x == 0) {
      stamp(a, t, 37);
      run_tail(a, sm, t, conf_vis ? a.st[kR6].out : a.pc_first, tsh);
      commit_frame(a, t, stage, conf_full);
      __syncthreads();
      stamp(a, t, 38);
    }
    if (iu) {
      float* sv = reinterpret_cast<float*>(sm + a.lay.act);
      load_j3dr<M>(a, t, sv, false);
      __syncthreads();
      init_layer(a, 0, sv, a.st[kR2].n_out, f.nxt);
      gsync(a, t, 41, grid);
      for (int i = tid; i < a.init_n[0]; i += kThreads) sv[i] = a.init_x[i];
      __syncthreads();
      init_layer(a, 1, sv, a.init_n[0], f.nxt);
      gsync(a, t, 43, grid);
      for (int i = tid; i < a.init_n[1]; i += kThreads)
        sv[i] = a.init_x[a.init_n[0] + i];
      __syncthreads();
      init_layer(a, 2, sv, a.init_n[1], f.nxt);
    }
    gsync(a, t, 39, grid);
  }
}

constexpr int kPtrsPerStack = kKinds + 5;
constexpr int kNumPtrs = kStacks * kPtrsPerStack + 38;
constexpr int kIntsPerStack = 4 + 5 * kKinds;
constexpr int kNumInts = 1 + kStacks * kIntsPerStack + 10 + 14;
constexpr int kNumFloats = 6;

template <class M>
int launch(const int64_t* ptrs, const int* ints, const float* flts,
           void* stream) {
  Args a;
  int p = 0, q = 1;  // ints[0] is the mode
  auto F = [&]() { return reinterpret_cast<float*>(ptrs[p++]); };
  auto I = [&]() { return reinterpret_cast<int*>(ptrs[p++]); };
  for (int k = 0; k < kStacks; ++k) {
    Stack& s = a.st[k];
    for (int i = 0; i < kKinds; ++i)
      s.pk[i] = reinterpret_cast<const unsigned char*>(ptrs[p++]);
    s.hs = F();
    s.cs = F();
    s.y1 = F();
    s.hn = F();
    s.out = F();
    s.in = ints[q++];
    s.H = ints[q++];
    s.n_out = ints[q++];
    s.mc = ints[q++];
    for (int i = 0; i < kKinds; ++i) {
      s.rec[i] = ints[q++];
      s.lp[i] = ints[q++];
      s.res[i] = ints[q++];
      s.res_off[i] = ints[q++];
      s.cap[i] = ints[q++];
    }
  }
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
  a.syn = F();
  a.init_x = F();
  a.pose = F();
  a.tran = F();
  a.contact = F();
  a.starts = I();
  a.ts = reinterpret_cast<unsigned long long*>(ptrs[p++]);
  a.T = ints[q++];
  a.use_imu = ints[q++];
  a.live = ints[q++];
  a.update_vision_freq = ints[q++];
  a.use_flat_floor = ints[q++];
  a.blendshape = ints[q++];
  for (int l = 0; l < 3; ++l) a.init_n[l] = ints[q++];
  a.nb = ints[q++];
  Layout& L = a.lay;
  for (int* f : {&L.bars, &L.state, &L.xin, &L.act, &L.actq, &L.parts, &L.red,
                 &L.own, &L.tail, &L.tconst, &L.res, &L.ring, &L.ring_bytes,
                 &L.total})
    *f = ints[q++];
  a.lo = flts[0];
  a.hi = flts[1];
  a.contact_threshold = flts[2];
  a.distance_threshold = flts[3];
  a.tran_filter_num = flts[4];
  a.height_threshold = flts[5];
  if (p != kNumPtrs || q != kNumInts) return cudaErrorInvalidValue;
  // what the kernel relies on: 16-byte records and aligned areas, a ring
  // that holds every streamed piece, pieces within an mbarrier's count
  if (L.ring + L.ring_bytes > L.total || L.ring_bytes <= 0 ||
      (L.ring | L.ring_bytes | L.res | L.xin | L.act | L.actq | L.parts |
       L.own | L.tail | L.tconst | L.bars | L.state) & 15)
    return cudaErrorInvalidValue;
  for (int k = 0; k < kStacks; ++k)
    if (a.st[k].H > kMaxH) return cudaErrorInvalidValue;
  for (int k = 0; k < kStacks; ++k)
    for (int i = 0; i < kKinds; ++i) {
      const Stack& s = a.st[k];
      if ((s.rec[i] & 15) || (s.res_off[i] & 15) ||
          (reinterpret_cast<uintptr_t>(s.pk[i]) & 15) || s.cap[i] < 1 ||
          (!s.res[i] && (s.cap[i] * s.rec[i] > L.ring_bytes ||
                         s.cap[i] * s.rec[i] >= (1 << 20))))
        return cudaErrorInvalidValue;
    }
  if (a.T <= 0) return cudaSuccess;

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
  if ((err = cudaFuncSetAttribute(serve_scan_kernel<M>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, serve_scan_kernel<M>, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1 || a.nb > sms * per_sm)
    return cudaErrorCooperativeLaunchTooLarge;
  void* kargs[] = {&a};
  err = cudaLaunchCooperativeKernel(serve_scan_kernel<M>, dim3(a.nb),
                                    dim3(kThreads), kargs, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <class M>
int device_info(int* out) {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&fa, serve_scan_kernel<M>);
  if (err != cudaSuccess) return err;
  out[1] = optin - static_cast<int>(fa.sharedSizeBytes);
  return cudaSuccess;
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

// The grid of the current card (its SM count: one block each) and the
// dynamic shared memory a block of `mode` may take, into out[0], out[1].
extern "C" int serve_scan_device_info(int mode, int* out) {
  switch (mode) {
    case 0:
      return device_info<ModeF32>(out);
    case 1:
      return device_info<ModeBf16>(out);
    case 2:
      return device_info<ModeInt8>(out);
    default:
      return cudaErrorInvalidValue;
  }
}

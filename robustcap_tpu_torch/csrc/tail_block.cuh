// The per-frame geometry tail of the SigMP step as a device function run by
// one whole block of at least two warps: contact sigmoid, r6d -> rotation
// (Gram-Schmidt, eps 1e-8), IK against the parent, light FK as an
// ancestor-chain sum, feet in the camera frame, translation from contacts or
// network velocity, visual position fusion, the 11-slot flat-floor ring and
// its snap, first-frame overrides, LBS of the 33 landmarks (pose blendshapes
// optional), sync_mp3d, and the live-mode reuse of the throttled landmarks.
//
// Used by the geometry-tail kernel (one launch per frame) and by the serve
// kernel (twice per frame, in block 0). The caller stages everything the
// body reads in shared memory first, at fixed offsets: the frame's inputs
// and the carry in an input area (kIn*, copy_segs), the body-model
// constants and the launch's flags in a constants area (kTc*). The body
// then reads shared memory only, each operand at a constant offset from one
// of two bases, so that its serial steps wait on shared memory, not on L2
// or on spilled pointers; it writes its outputs at fixed offsets (kOff*) of
// an output area, global or shared. The posedirs rows `pd` may stay in
// global memory: the body then prefetches them into L2 as it starts.
//
// Schedule, three block barriers: Gram-Schmidt of the joints (thread 0 then
// the root-fixing rotation); IK, the parent-rotated bones and the
// root-fixed global rotations; then warp 0 runs FK, the scalar translation,
// fusion and floor logic (lane 0) and the joints, while the other warps
// share the pose-blendshape product of the 99 landmark coordinates (rows of
// 208 coefficients, one warp a row, lanes on consecutive words, finished
// with shuffles); last, LBS with one thread per landmark coordinate.
// Every thread of the block must call tail_block.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "serve_async.cuh"

namespace {

constexpr int kJ = 24;       // SMPL joints
constexpr int kV = 33;       // MediaPipe landmarks
constexpr int kP = 9 * 23;   // pose-blendshape coefficients
constexpr int kPdRow = 208;  // a posedirs row, padded to 16 bytes
constexpr int kPdBytes = 3 * kV * kPdRow * 4;
constexpr float kEps = 1e-8f;
constexpr float kVelScale = 3.0f;  // config.VEL_SCALE

// Words of the input area: the frame's inputs and the carry.
constexpr int kInOut7 = 0;         // [24, 6]
constexpr int kInOut8 = 144;       // [2]
constexpr int kInVr = 148;         // [3]
constexpr int kInPc = 152;         // [3]
constexpr int kInRcr = 156;        // [3, 3]
constexpr int kInC = 168;          // the frame's confidence, its lerp weight
constexpr int kInFirstTran = 172;  // [3]
constexpr int kInGrav = 176;       // [3]
constexpr int kInLastPfoot = 180;  // [2, 3]
constexpr int kInLastTran = 188;   // [3]
constexpr int kInFloor = 192;      // [11, 3]
constexpr int kInJtemp = 228;      // [33, 3]
constexpr int kInInts = 328;       // floor_cnt, vision_count (int bits)
constexpr int kInHas = 330;        // has_pfoot, has_tran: two bytes
constexpr int kInFirst = 332;      // first_frame, first_tran_valid (ints)
constexpr int kTailIn = 336;
// Words of the constants area: the body model's, then the launch's flags.
constexpr int kTcParent = 0;       // [24] (int bits), root -> 0
constexpr int kTcBone = 24;        // [24, 3]
constexpr int kTcJ0 = 96;          // [24, 3]
constexpr int kTcWsub = 168;       // [33, 24]
constexpr int kTcV0sub = 960;      // [33, 3]
constexpr int kTcBody = 1060;      // the body model's words, padded
constexpr int kTcConfHi = 1060, kTcContact = 1061, kTcDistance = 1062,
              kTcFilter = 1063, kTcHeight = 1064;         // floats
constexpr int kTcFloor = 1065, kTcLive = 1066, kTcVisionFreq = 1067,
              kTcLandmarks = 1068;                        // ints
constexpr int kTailConst = 1072;
// Words of the output area: the f32 outputs laid end to end; the two
// counters (floor_cnt, vision_count) go to an int pair of their own.
constexpr int kOffPose = 0;       // [24, 3, 3]
constexpr int kOffTran = 216;     // [3]
constexpr int kOffContact = 219;  // [2]
constexpr int kOffPfoot = 221;    // [2, 3]
constexpr int kOffFloor = 227;    // [11, 3]
constexpr int kOffJtemp = 260;    // [33, 3]
constexpr int kOffJoint = 359;    // [24, 3]
constexpr int kOffJlm = 431;      // [33, 3]
constexpr int kTailOut = 530;

// A run of 4-byte words to stage: `n` words from `src` to word `dst` of the
// staging area.
struct Seg {
  const void* src;
  int n, dst;
};

// Stage the segments, laid end to end, with the block's threads: thread i
// copies word i (the block has at least as many threads as words), so that
// every load is in flight at once.
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

__device__ __forceinline__ float norm3(const float* v) {
  return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
}

// out = m @ v for a row-major 3x3 m
__device__ __forceinline__ void mat_vec(const float* m, const float* v,
                                        float* out) {
  for (int r = 0; r < 3; ++r)
    out[r] = m[3 * r] * v[0] + m[3 * r + 1] * v[1] + m[3 * r + 2] * v[2];
}

// landmark row overwritten by a joint in sync_mp3d, or -1
__device__ __forceinline__ int sync_joint(int v) {
  if (v >= 11 && v < 17) return 16 + (v - 11);
  if (v >= 23 && v < 25) return 1 + (v - 23);
  if (v >= 25 && v < 27) return 4 + (v - 25);
  if (v >= 27 && v < 29) return 7 + (v - 27);
  return -1;
}

// Shared-memory scratch of one tail evaluation.
struct TailShared {
  float pg[kJ * 9];    // global rotations, row-major 3x3
  float pose[kJ * 9];  // local pose, root := Rcr
  float pb[kJ * 3];    // parent rotation @ bone
  float pall[kJ * 3];  // joint positions (root-relative)
  float glb[kJ * 9];   // root-fixed global rotations
  float tj[kJ * 3];
  float joint[kJ * 3];
  float rfix[9];       // Rcr @ pg[0]^T
  float tran[3];
  float bs[3 * kV];    // pose-blendshape offsets, channel-major
  float lower[3];      // the floor ring's new entry
  int slot;            // its slot, or -1
  int fk_now;
};

// Translation, fusion, the floor ring, first-frame overrides and the
// counters: one thread, everything it reads in shared memory.
__device__ __forceinline__ void tail_scalar(const float* in, const float* tc,
                                            float* out, int* out_i,
                                            TailShared& sh) {
  const int* ini = reinterpret_cast<const int*>(in);
  const int* tci = reinterpret_cast<const int*>(tc);
  const unsigned char* has =
      reinterpret_cast<const unsigned char*>(in + kInHas);
  const float* rcr = in + kInRcr;
  const float* pc = in + kInPc;
  const float c = in[kInC];
  const float conf_hi = tc[kTcConfHi], ct = tc[kTcContact];
  const int first_frame = ini[kInFirst], first_tran_valid = ini[kInFirst + 1];
  float contact[2];
  for (int k = 0; k < 2; ++k)
    contact[k] = 1.f / (1.f + expf(-in[kInOut8 + k]));
  const float cmax = fmaxf(contact[0], contact[1]);

  // feet in the camera frame
  float pfoot[2][3];
  mat_vec(rcr, sh.pall + 10 * 3, pfoot[0]);
  mat_vec(rcr, sh.pall + 11 * 3, pfoot[1]);

  // translation from contacts / network velocity; ties go to foot 0
  float v_net[3];
  mat_vec(rcr, in + kInVr, v_net);
  const int f = (contact[0] >= contact[1]) ? 0 : 1;
  const bool use_net = (cmax < ct) || !has[0];
  float tran[3];
  for (int k = 0; k < 3; ++k) {
    const float v = use_net ? v_net[k] * (kVelScale / 60.f)
                            : in[kInLastPfoot + f * 3 + k] - pfoot[f][k];
    tran[k] = has[1] ? in[kInLastTran + k] + v : v;
  }

  // visual absolute-position fusion
  if (c >= conf_hi) {
    float d[3];
    for (int k = 0; k < 3; ++k) d[k] = pc[k] - tran[k];
    const float filter = tc[kTcFilter];
    const bool snap_far = norm3(d) > tc[kTcDistance] || filter > 1.f;
    const float tl = filter * in[kInC + 1];
    for (int k = 0; k < 3; ++k)
      tran[k] = snap_far ? pc[k] : tran[k] * (1.f - tl) + pc[k] * tl;
  }

  // flat-floor ring of contact heights and its snap; warp 0 writes the
  // ring's copy after this (sh.slot, sh.lower)
  int floor_cnt = ini[kInInts];
  sh.slot = -1;
  if (tci[kTcFloor]) {
    const float* grav = in + kInGrav;
    float p[2][3];
    for (int s = 0; s < 2; ++s) {
      float d = 0.f;
      for (int k = 0; k < 3; ++k) d += (pfoot[s][k] + tran[k]) * grav[k];
      for (int k = 0; k < 3; ++k) p[s][k] = d * grav[k];
    }
    const float n0 = norm3(p[0]), n1 = norm3(p[1]);
    const float* lower = (n0 < n1) ? p[1] : p[0];
    const bool append = floor_cnt < 11 && !first_frame && !first_tran_valid &&
                        cmax > ct && c >= conf_hi;
    if (append) {
      sh.slot = floor_cnt;
      for (int k = 0; k < 3; ++k) sh.lower[k] = lower[k];
      floor_cnt += 1;
    }
    const bool snap = floor_cnt > 10 && cmax > ct;
    float m[3] = {0.f, 0.f, 0.f};
    for (int s = 5; s < 11; ++s)
      for (int k = 0; k < 3; ++k)
        m[k] += s == sh.slot ? lower[k] : in[kInFloor + s * 3 + k];
    float d0[3], d1[3];
    for (int k = 0; k < 3; ++k) {
      m[k] /= 6.f;
      d0[k] = m[k] - p[0][k];
      d1[k] = m[k] - p[1][k];
    }
    if (snap) {
      const float height = tc[kTcHeight];
      const bool use_p1 = (n0 < n1) && norm3(d1) < height;
      const bool use_p0 = norm3(d0) < height;
      for (int k = 0; k < 3; ++k)
        tran[k] += use_p1 ? d1[k] : (use_p0 ? d0[k] : 0.f);
    }
  }

  // first-frame overrides
  for (int k = 0; k < 3; ++k) {
    if (first_tran_valid)
      tran[k] = in[kInFirstTran + k];
    else if (first_frame)
      tran[k] = pc[k];
  }

  for (int k = 0; k < 3; ++k) {
    sh.tran[k] = tran[k];
    out[kOffTran + k] = tran[k];
    out[kOffPfoot + k] = pfoot[0][k];
    out[kOffPfoot + 3 + k] = pfoot[1][k];
  }
  out[kOffContact] = contact[0];
  out[kOffContact + 1] = contact[1];
  out_i[0] = floor_cnt;

  const int vc = ini[kInInts + 1], live = tci[kTcLive];
  const bool fk_now = live && vc == 0;
  sh.fk_now = fk_now;
  out_i[1] = tci[kTcLandmarks] && live
                 ? (fk_now ? tci[kTcVisionFreq] : vc - 1)
                 : vc;
}

// Pose-blendshape offsets posedirs . (pose[1:] - I) of the 99 landmark
// coordinates into bs (channel-major), by warps 1.. of the block: a row a
// warp at a time, lane l on the float4s l and l + 32 of the row, the rows of
// four outputs loaded before any is reduced.
__device__ __forceinline__ void blendshape_product(const float* pd,
                                                   TailShared& sh) {
  constexpr int kQ = kPdRow / 4, kBatch = 4;
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) - 1;
  const int nw = (blockDim.x >> 5) - 1;
  float r[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = 4 * (lane + 32 * h) + e;
      r[h][e] = p < kP ? sh.pose[9 + p] - (p % 9 % 4 == 0 ? 1.f : 0.f) : 0.f;
    }
  for (int o0 = w; o0 < 3 * kV; o0 += kBatch * nw) {
    float acc[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int o = o0 + b * nw;
      acc[b] = 0.f;
      if (o >= 3 * kV) continue;
      const float4* row = reinterpret_cast<const float4*>(pd + o * kPdRow);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = lane + 32 * h;
        if (q >= kQ) continue;
        const float4 x = row[q];
        acc[b] = fmaf(x.x, r[h][0], acc[b]);
        acc[b] = fmaf(x.y, r[h][1], acc[b]);
        acc[b] = fmaf(x.z, r[h][2], acc[b]);
        acc[b] = fmaf(x.w, r[h][3], acc[b]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], off);
    if (lane == 0)
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (o0 + b * nw < 3 * kV) sh.bs[o0 + b * nw] = acc[b];
  }
}

// The tail of one frame from the staged areas `in` (kIn*) and `tc` (kTc*)
// into `out` (kOff*) and `out_i`. `pd`: the posedirs rows, or null without
// blendshapes; in shared memory once `pd_ready` completes its phase 0, else
// (null `pd_ready`) in global memory. `tc_ready`, or null: an mbarrier whose
// phase 0 completes when the body-model constants have landed in `tc`.
// Not inlined: inlined into the serve kernel, the body's registers made the
// whole kernel spill more (f32: 72 bytes of spill loads, against 16 in the
// kernel and 36 in the body out of line) and its final tail slower (6.5 us
// against 5.9 on a mixed chunk; H100 80GB HBM3, 700 W).
__device__ __noinline__ void tail_block(const float* in, const float* tc,
                                           float* out, int* out_i,
                                           const float* pd,
                                           const uint64_t* pd_ready,
                                           const uint64_t* tc_ready,
                                           TailShared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* tci = reinterpret_cast<const int*>(tc);
  const float* rcr = in + kInRcr;

  if (pd && !pd_ready && warp > 0)
    for (int i = tid - 32; i < (kPdBytes + 127) / 128; i += blockDim.x - 32)
      prefetch_l2(reinterpret_cast<const char*>(pd) + 128 * i);

  if (tid < kJ) {
    // Gram-Schmidt: col0 = unit(a), col1 = unit(b - <col0, b> col0),
    // col2 = col0 x col1 (normalize with the guarded eps)
    const float* r6 = in + kInOut7 + tid * 6;
    float c0[3] = {r6[0], r6[1], r6[2]};
    const float n0 = fmaxf(norm3(c0), kEps);
    for (int k = 0; k < 3; ++k) c0[k] /= n0;
    const float proj = c0[0] * r6[3] + c0[1] * r6[4] + c0[2] * r6[5];
    float c1[3] = {r6[3] - proj * c0[0], r6[4] - proj * c0[1],
                   r6[5] - proj * c0[2]};
    const float n1 = fmaxf(norm3(c1), kEps);
    for (int k = 0; k < 3; ++k) c1[k] /= n1;
    const float c2[3] = {c0[1] * c1[2] - c0[2] * c1[1],
                         c0[2] * c1[0] - c0[0] * c1[2],
                         c0[0] * c1[1] - c0[1] * c1[0]};
    float R[9];
    for (int r = 0; r < 3; ++r) {
      R[3 * r] = c0[r];
      R[3 * r + 1] = c1[r];
      R[3 * r + 2] = c2[r];
    }
    for (int k = 0; k < 9; ++k) sh.pg[tid * 9 + k] = R[k];
    if (tid == 0) {
      // Rfix = Rcr @ glb[0]^T: FK of the root-fixed pose is Rfix @ glb
      for (int r = 0; r < 3; ++r)
        for (int cc = 0; cc < 3; ++cc)
          sh.rfix[3 * r + cc] = rcr[3 * r] * R[3 * cc] +
                                rcr[3 * r + 1] * R[3 * cc + 1] +
                                rcr[3 * r + 2] * R[3 * cc + 2];
    }
  }
  if (tc_ready) mbar_wait(const_cast<uint64_t*>(tc_ready), 0);
  __syncthreads();
  const bool landmarks = tci[kTcLandmarks];
  const bool bs_on = landmarks && pd;

  if (tid < kJ) {
    // IK: local = glb[parent]^T glb[i]; root row := Rcr.
    // light FK: pb[i] = glb[parent] @ bone[i], pb[root] = 0.
    const int i = tid;
    const float* P = sh.pg + tci[kTcParent + i] * 9;
    const float* G = sh.pg + i * 9;
    float L[9];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        L[3 * r + c] = (i == 0) ? rcr[3 * r + c]
                                : P[r] * G[c] + P[3 + r] * G[3 + c] +
                                      P[6 + r] * G[6 + c];
    float pb[3] = {0.f, 0.f, 0.f};
    if (i > 0) mat_vec(P, tc + kTcBone + i * 3, pb);
    float Gf[9];
    if (landmarks)
      for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c)
          Gf[3 * r + c] = sh.rfix[3 * r] * G[c] +
                          sh.rfix[3 * r + 1] * G[3 + c] +
                          sh.rfix[3 * r + 2] * G[6 + c];
    for (int k = 0; k < 9; ++k) {
      sh.pose[i * 9 + k] = L[k];
      out[kOffPose + i * 9 + k] = L[k];
    }
    for (int k = 0; k < 3; ++k) sh.pb[i * 3 + k] = pb[k];
    if (landmarks)
      for (int k = 0; k < 9; ++k) sh.glb[i * 9 + k] = Gf[k];
  }
  __syncthreads();

  if (warp == 0) {
    if (lane < kJ) {
      // prefix sum down the tree: walk the ancestor chain to the root
      float acc[3] = {0.f, 0.f, 0.f};
      for (int j = lane; j > 0; j = tci[kTcParent + j])
        for (int k = 0; k < 3; ++k) acc[k] += sh.pb[j * 3 + k];
      for (int k = 0; k < 3; ++k) sh.pall[lane * 3 + k] = acc[k];
    }
    __syncwarp();
    if (lane == 0) tail_scalar(in, tc, out, out_i, sh);
    __syncwarp();
    for (int k = lane; k < 33; k += 32)
      out[kOffFloor + k] =
          k / 3 == sh.slot ? sh.lower[k % 3] : in[kInFloor + k];
    if (landmarks && lane < kJ) {
      const int i = lane;
      float jt[3], gj[3];
      mat_vec(sh.rfix, sh.pall + i * 3, jt);
      mat_vec(sh.glb + i * 9, tc + kTcJ0 + i * 3, gj);
      for (int k = 0; k < 3; ++k) {
        jt[k] += sh.tran[k];
        sh.joint[i * 3 + k] = jt[k];
        out[kOffJoint + i * 3 + k] = jt[k];
        sh.tj[i * 3 + k] = jt[k] - gj[k];
      }
    }
  } else if (bs_on) {
    if (pd_ready) mbar_wait(const_cast<uint64_t*>(pd_ready), 0);
    blendshape_product(pd, sh);
  }
  __syncthreads();

  const float* jtemp = in + kInJtemp;
  if (!landmarks) {
    for (int k = tid; k < kJ * 3; k += blockDim.x) out[kOffJoint + k] = 0.f;
    for (int k = tid; k < kV * 3; k += blockDim.x) {
      out[kOffJlm + k] = 0.f;
      out[kOffJtemp + k] = jtemp[k];
    }
    return;
  }

  const bool live = tci[kTcLive];
  for (int i = tid; i < 3 * kV; i += blockDim.x) {
    // coordinate r of landmark v: its joint's under sync_mp3d, else LBS,
    // (sum_j w R_j)[r] . v0 + (sum_j w t_j)[r]
    const int v = i / 3, r = i % 3;
    const int sj = sync_joint(v);
    float o;
    if (sj >= 0) {
      o = sh.joint[sj * 3 + r];
    } else {
      float Rv[3] = {0.f, 0.f, 0.f};
      float tv = 0.f;
      const float* w = tc + kTcWsub + v * kJ;
      for (int j = 0; j < kJ; ++j) {
        const float wj = w[j];
        for (int k = 0; k < 3; ++k) Rv[k] += wj * sh.glb[j * 9 + 3 * r + k];
        tv += wj * sh.tj[j * 3 + r];
      }
      const float* v0s = tc + kTcV0sub + v * 3;
      float v0[3] = {v0s[0], v0s[1], v0s[2]};
      if (bs_on)
        for (int cc = 0; cc < 3; ++cc) v0[cc] += sh.bs[cc * kV + v];
      o = Rv[0] * v0[0] + Rv[1] * v0[1] + Rv[2] * v0[2] + tv;
    }
    if (live && !sh.fk_now) o = jtemp[i];
    out[kOffJlm + i] = o;
    out[kOffJtemp + i] = live ? o : jtemp[i];
  }
}

}  // namespace

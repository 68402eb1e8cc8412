// The per-frame geometry tail of the SigMP step as a device function run by
// one whole block of at least 33 threads (one thread per joint, one per
// landmark, thread 0 for the scalar logic): contact sigmoid, r6d -> rotation
// (Gram-Schmidt, eps 1e-8), IK against the parent, light FK as an
// ancestor-chain sum, feet in the camera frame, translation from contacts or
// network velocity, visual position fusion, the 11-slot flat-floor ring and
// its snap, first-frame overrides, LBS of the 33 landmarks (pose blendshapes
// optional), sync_mp3d, and the live-mode reuse of the throttled landmarks.
//
// Used by the geometry-tail kernel (one launch per frame) and by the serve
// kernel (twice per frame, in block 0). Every thread of the block must call
// tail_block; it synchronises the block with __syncthreads. Inputs and
// outputs must not overlap.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kJ = 24;       // SMPL joints
constexpr int kV = 33;       // MediaPipe landmarks
constexpr int kP = 9 * 23;   // pose-blendshape coefficients
constexpr float kEps = 1e-8f;
constexpr float kVelScale = 3.0f;  // config.VEL_SCALE

struct TailArgs {
  // per-frame inputs
  const float* out7;  // [24, 6]
  const float* out8;  // [2]
  const float* rcr;   // [3, 3]
  const float* vr;    // [3]
  const float* pc;    // [3]
  const float* c;     // [] frame confidence
  const float* k_lerp;  // []
  const float* first_tran;  // [3]
  const float* grav;  // [3]
  // carry
  const float* last_pfoot;  // [2, 3]
  const unsigned char* has_pfoot;  // [] bool
  const float* last_tran;  // [3]
  const unsigned char* has_tran;  // [] bool
  const float* floor_buf;  // [11, 3]
  const int* floor_cnt;  // []
  const int* vision_count;  // []
  const float* j_temp;  // [33, 3]
  // body-model constants
  const int* parent;  // [24], root -> 0
  const float* bone;  // [24, 3]
  const float* j0;    // [24, 3]
  const float* wsub;  // [33, 24]
  const float* v0sub;  // [33, 3]
  const float* pd;    // [3, 207, 33] or null
  // outputs
  float* pose;  // [24, 3, 3]
  float* tran;  // [3]
  float* contact;  // [2]
  float* pfoot;  // [2, 3]
  float* floor_buf_out;  // [11, 3]
  int* floor_cnt_out;  // []
  int* vision_count_out;  // []
  float* j_temp_out;  // [33, 3]
  float* joint;  // [24, 3]
  float* j_lm;  // [33, 3]
  // flags
  int first_frame, first_tran_valid;
  float conf_hi, contact_threshold, distance_threshold, tran_filter_num,
      height_threshold;
  int use_flat_floor, live, update_vision_freq, landmarks, blendshape;
};

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
  float rcr[9];
  float pg[kJ * 9];    // global rotations, row-major 3x3
  float pose[kJ * 9];  // local pose, root := Rcr
  float pb[kJ * 3];    // parent rotation @ bone
  float pall[kJ * 3];  // joint positions (root-relative)
  float glb[kJ * 9];
  float tj[kJ * 3];
  float joint[kJ * 3];
  float rfix[9];
  float tran[3];
  float bs[3 * kV];    // pose-blendshape offsets, channel-major
  int fk_now;
};

// Pose-blendshape offsets posedirs . (pose[1:] - I) of the landmarks,
// channel-major into bs [3, 33], coefficient p = (j-1)*9 + k. One (channel,
// landmark) pair per thread: 207 loads each, not 621 per landmark thread.
// Not inlined: inside the serve kernel its unrolled loads pushed the whole
// kernel's register allocation into spilling.
__device__ __noinline__ void blendshape_offsets(const float* pd,
                                                const float* pose,
                                                float* bs) {
  for (int i = threadIdx.x; i < 3 * kV; i += blockDim.x) {
    const int cc = i / kV, v = i % kV;
    const float* pdc = pd + cc * kP * kV;
    float acc = 0.f;
    for (int p = 0; p < kP; ++p) {
      const int k = p % 9;
      const float r = pose[9 + p] - ((k == 0 || k == 4 || k == 8) ? 1.f : 0.f);
      acc += pdc[p * kV + v] * r;
    }
    bs[i] = acc;
  }
}

// Inlined so that the accesses to `sh` compile to shared-memory loads, not
// generic ones.
__device__ __forceinline__ void tail_block(const TailArgs& a,
                                           TailShared& sh) {
  const int tid = threadIdx.x;

  if (tid < 9) sh.rcr[tid] = a.rcr[tid];
  if (tid < kJ) {
    // Gram-Schmidt: col0 = unit(a), col1 = unit(b - <col0, b> col0),
    // col2 = col0 x col1 (normalize with the guarded eps)
    const float* r6 = a.out7 + tid * 6;
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
    float* R = sh.pg + tid * 9;
    for (int r = 0; r < 3; ++r) {
      R[3 * r] = c0[r];
      R[3 * r + 1] = c1[r];
      R[3 * r + 2] = c2[r];
    }
  }
  __syncthreads();

  if (tid < kJ) {
    // IK: local = glb[parent]^T glb[i]; root row := Rcr.
    // light FK: pb[i] = glb[parent] @ bone[i], pb[root] = 0.
    const int i = tid;
    const float* P = sh.pg + a.parent[i] * 9;
    const float* G = sh.pg + i * 9;
    float* L = sh.pose + i * 9;
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        L[3 * r + c] = (i == 0) ? sh.rcr[3 * r + c]
                                : P[r] * G[c] + P[3 + r] * G[3 + c] +
                                      P[6 + r] * G[6 + c];
    for (int k = 0; k < 9; ++k) a.pose[i * 9 + k] = L[k];
    float pb[3] = {0.f, 0.f, 0.f};
    if (i > 0) mat_vec(P, a.bone + i * 3, pb);
    for (int k = 0; k < 3; ++k) sh.pb[i * 3 + k] = pb[k];
  }
  __syncthreads();

  if (tid < kJ) {
    // prefix sum down the tree: walk the ancestor chain to the root
    float acc[3] = {0.f, 0.f, 0.f};
    for (int j = tid; j > 0; j = a.parent[j])
      for (int k = 0; k < 3; ++k) acc[k] += sh.pb[j * 3 + k];
    for (int k = 0; k < 3; ++k) sh.pall[tid * 3 + k] = acc[k];
  }
  if (a.blendshape) blendshape_offsets(a.pd, sh.pose, sh.bs);
  __syncthreads();

  if (tid == 0) {
    const float c = *a.c;
    float contact[2];
    for (int k = 0; k < 2; ++k) contact[k] = 1.f / (1.f + expf(-a.out8[k]));
    const float cmax = fmaxf(contact[0], contact[1]);

    // feet in the camera frame
    float pfoot[2][3];
    mat_vec(sh.rcr, sh.pall + 10 * 3, pfoot[0]);
    mat_vec(sh.rcr, sh.pall + 11 * 3, pfoot[1]);

    // translation from contacts / network velocity; ties go to foot 0
    float v_net[3];
    mat_vec(sh.rcr, a.vr, v_net);
    const int f = (contact[0] >= contact[1]) ? 0 : 1;
    const bool use_net = (cmax < a.contact_threshold) || !(*a.has_pfoot);
    float tran[3];
    for (int k = 0; k < 3; ++k) {
      const float v = use_net ? v_net[k] * (kVelScale / 60.f)
                              : a.last_pfoot[f * 3 + k] - pfoot[f][k];
      tran[k] = *a.has_tran ? a.last_tran[k] + v : v;
    }

    // visual absolute-position fusion
    if (c >= a.conf_hi) {
      float d[3];
      for (int k = 0; k < 3; ++k) d[k] = a.pc[k] - tran[k];
      const bool snap_far =
          norm3(d) > a.distance_threshold || a.tran_filter_num > 1.f;
      const float tl = a.tran_filter_num * *a.k_lerp;
      for (int k = 0; k < 3; ++k)
        tran[k] = snap_far ? a.pc[k] : tran[k] * (1.f - tl) + a.pc[k] * tl;
    }

    // flat-floor ring of contact heights and its snap
    int floor_cnt = *a.floor_cnt;
    for (int k = 0; k < 33; ++k) a.floor_buf_out[k] = a.floor_buf[k];
    if (a.use_flat_floor) {
      float p[2][3];
      for (int s = 0; s < 2; ++s) {
        float d = 0.f;
        for (int k = 0; k < 3; ++k) d += (pfoot[s][k] + tran[k]) * a.grav[k];
        for (int k = 0; k < 3; ++k) p[s][k] = d * a.grav[k];
      }
      const float n0 = norm3(p[0]), n1 = norm3(p[1]);
      const float* lower = (n0 < n1) ? p[1] : p[0];
      const bool append = floor_cnt < 11 && !a.first_frame &&
                          !a.first_tran_valid &&
                          cmax > a.contact_threshold && c >= a.conf_hi;
      if (append) {
        for (int k = 0; k < 3; ++k)
          a.floor_buf_out[floor_cnt * 3 + k] = lower[k];
        floor_cnt += 1;
      }
      const bool snap = floor_cnt > 10 && cmax > a.contact_threshold;
      float m[3] = {0.f, 0.f, 0.f};
      for (int s = 5; s < 11; ++s)
        for (int k = 0; k < 3; ++k) m[k] += a.floor_buf_out[s * 3 + k];
      float d0[3], d1[3];
      for (int k = 0; k < 3; ++k) {
        m[k] /= 6.f;
        d0[k] = m[k] - p[0][k];
        d1[k] = m[k] - p[1][k];
      }
      if (snap) {
        const bool use_p1 = (n0 < n1) && norm3(d1) < a.height_threshold;
        const bool use_p0 = norm3(d0) < a.height_threshold;
        for (int k = 0; k < 3; ++k)
          tran[k] += use_p1 ? d1[k] : (use_p0 ? d0[k] : 0.f);
      }
    }

    // first-frame overrides
    for (int k = 0; k < 3; ++k) {
      if (a.first_tran_valid)
        tran[k] = a.first_tran[k];
      else if (a.first_frame)
        tran[k] = a.pc[k];
    }

    for (int k = 0; k < 3; ++k) {
      sh.tran[k] = tran[k];
      a.tran[k] = tran[k];
      a.pfoot[k] = pfoot[0][k];
      a.pfoot[3 + k] = pfoot[1][k];
    }
    a.contact[0] = contact[0];
    a.contact[1] = contact[1];
    *a.floor_cnt_out = floor_cnt;

    // Rfix = Rcr @ glb[0]^T: FK of the root-fixed pose is Rfix @ glb
    const int vc = *a.vision_count;
    const bool fk_now = a.live && vc == 0;
    sh.fk_now = fk_now;
    if (a.landmarks) {
      for (int r = 0; r < 3; ++r)
        for (int cc = 0; cc < 3; ++cc)
          sh.rfix[3 * r + cc] = sh.rcr[3 * r] * sh.pg[3 * cc] +
                               sh.rcr[3 * r + 1] * sh.pg[3 * cc + 1] +
                               sh.rcr[3 * r + 2] * sh.pg[3 * cc + 2];
      *a.vision_count_out =
          a.live ? (fk_now ? a.update_vision_freq : vc - 1) : vc;
    } else {
      *a.vision_count_out = vc;
    }
  }
  __syncthreads();

  if (!a.landmarks) {
    for (int k = tid; k < kJ * 3; k += blockDim.x) a.joint[k] = 0.f;
    for (int k = tid; k < kV * 3; k += blockDim.x) {
      a.j_lm[k] = 0.f;
      a.j_temp_out[k] = a.j_temp[k];
    }
    return;
  }

  if (tid < kJ) {
    const int i = tid;
    float* G = sh.glb + i * 9;
    const float* P = sh.pg + i * 9;
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        G[3 * r + c] = sh.rfix[3 * r] * P[c] + sh.rfix[3 * r + 1] * P[3 + c] +
                       sh.rfix[3 * r + 2] * P[6 + c];
    float jt[3], gj[3];
    mat_vec(sh.rfix, sh.pall + i * 3, jt);
    mat_vec(G, a.j0 + i * 3, gj);
    for (int k = 0; k < 3; ++k) {
      jt[k] += sh.tran[k];
      sh.joint[i * 3 + k] = jt[k];
      a.joint[i * 3 + k] = jt[k];
      sh.tj[i * 3 + k] = jt[k] - gj[k];
    }
  }
  __syncthreads();

  if (tid < kV) {
    const int v = tid;
    float jc[3];
    const int sj = sync_joint(v);
    if (sj >= 0) {
      for (int k = 0; k < 3; ++k) jc[k] = sh.joint[sj * 3 + k];
    } else {
      // LBS of one landmark: (sum_j w R_j) @ v0 + sum_j w t_j
      float Rv[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float tv[3] = {0.f, 0.f, 0.f};
      const float* w = a.wsub + v * kJ;
      for (int j = 0; j < kJ; ++j) {
        const float wj = w[j];
        for (int k = 0; k < 9; ++k) Rv[k] += wj * sh.glb[j * 9 + k];
        for (int k = 0; k < 3; ++k) tv[k] += wj * sh.tj[j * 3 + k];
      }
      float v0[3] = {a.v0sub[v * 3], a.v0sub[v * 3 + 1], a.v0sub[v * 3 + 2]};
      if (a.blendshape)
        for (int cc = 0; cc < 3; ++cc) v0[cc] += sh.bs[cc * kV + v];
      float rv0[3];
      mat_vec(Rv, v0, rv0);
      for (int k = 0; k < 3; ++k) jc[k] = rv0[k] + tv[k];
    }
    for (int k = 0; k < 3; ++k) {
      float out = jc[k];
      if (a.live && !sh.fk_now) out = a.j_temp[v * 3 + k];
      a.j_lm[v * 3 + k] = out;
      a.j_temp_out[v * 3 + k] = a.live ? out : a.j_temp[v * 3 + k];
    }
  }
}

}  // namespace

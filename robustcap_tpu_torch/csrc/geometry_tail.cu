// The per-frame geometry tail of the SigMP step in one launch: contact
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
// launch latency bounds it, not bytes or arithmetic. The design is one block
// of 128 threads with direct indexed loads (parent index, ancestor chain
// walked through the parent index, the 33 landmark rows gathered on the host
// once) in place of the TPU kernel's constant 0/1 gather matmuls: one thread
// per joint for Gram-Schmidt, IK and the bone products, one thread per
// landmark for LBS and blendshapes, thread 0 for the scalar translation,
// floor and live logic. Config flags are kernel arguments.
//
// Plain C interface for ctypes: geometry_tail_launch returns the CUDA error
// code of the launch (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kJ = 24;       // SMPL joints
constexpr int kV = 33;       // MediaPipe landmarks
constexpr int kP = 9 * 23;   // pose-blendshape coefficients
constexpr int kThreads = 128;
constexpr float kEps = 1e-8f;
constexpr float kVelScale = 3.0f;  // config.VEL_SCALE

struct Args {
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

__global__ void __launch_bounds__(kThreads) geometry_tail_kernel(Args a) {
  __shared__ float s_rcr[9];
  __shared__ float s_pg[kJ * 9];    // global rotations, row-major 3x3
  __shared__ float s_pose[kJ * 9];  // local pose, root := Rcr
  __shared__ float s_pb[kJ * 3];    // parent rotation @ bone
  __shared__ float s_pall[kJ * 3];  // joint positions (root-relative)
  __shared__ float s_glb[kJ * 9];
  __shared__ float s_tj[kJ * 3];
  __shared__ float s_joint[kJ * 3];
  __shared__ float s_rfix[9];
  __shared__ float s_tran[3];
  __shared__ int s_fk_now;
  const int tid = threadIdx.x;

  if (tid < 9) s_rcr[tid] = a.rcr[tid];
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
    float* R = s_pg + tid * 9;
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
    const float* P = s_pg + a.parent[i] * 9;
    const float* G = s_pg + i * 9;
    float* L = s_pose + i * 9;
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        L[3 * r + c] = (i == 0) ? s_rcr[3 * r + c]
                                : P[r] * G[c] + P[3 + r] * G[3 + c] +
                                      P[6 + r] * G[6 + c];
    for (int k = 0; k < 9; ++k) a.pose[i * 9 + k] = L[k];
    float pb[3] = {0.f, 0.f, 0.f};
    if (i > 0) mat_vec(P, a.bone + i * 3, pb);
    for (int k = 0; k < 3; ++k) s_pb[i * 3 + k] = pb[k];
  }
  __syncthreads();

  if (tid < kJ) {
    // prefix sum down the tree: walk the ancestor chain to the root
    float acc[3] = {0.f, 0.f, 0.f};
    for (int j = tid; j > 0; j = a.parent[j])
      for (int k = 0; k < 3; ++k) acc[k] += s_pb[j * 3 + k];
    for (int k = 0; k < 3; ++k) s_pall[tid * 3 + k] = acc[k];
  }
  __syncthreads();

  if (tid == 0) {
    const float c = *a.c;
    float contact[2];
    for (int k = 0; k < 2; ++k) contact[k] = 1.f / (1.f + expf(-a.out8[k]));
    const float cmax = fmaxf(contact[0], contact[1]);

    // feet in the camera frame
    float pfoot[2][3];
    mat_vec(s_rcr, s_pall + 10 * 3, pfoot[0]);
    mat_vec(s_rcr, s_pall + 11 * 3, pfoot[1]);

    // translation from contacts / network velocity; ties go to foot 0
    float v_net[3];
    mat_vec(s_rcr, a.vr, v_net);
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
      s_tran[k] = tran[k];
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
    s_fk_now = fk_now;
    if (a.landmarks) {
      for (int r = 0; r < 3; ++r)
        for (int cc = 0; cc < 3; ++cc)
          s_rfix[3 * r + cc] = s_rcr[3 * r] * s_pg[3 * cc] +
                               s_rcr[3 * r + 1] * s_pg[3 * cc + 1] +
                               s_rcr[3 * r + 2] * s_pg[3 * cc + 2];
      *a.vision_count_out =
          a.live ? (fk_now ? a.update_vision_freq : vc - 1) : vc;
    } else {
      *a.vision_count_out = vc;
    }
  }
  __syncthreads();

  if (!a.landmarks) {
    for (int k = tid; k < kJ * 3; k += kThreads) a.joint[k] = 0.f;
    for (int k = tid; k < kV * 3; k += kThreads) {
      a.j_lm[k] = 0.f;
      a.j_temp_out[k] = a.j_temp[k];
    }
    return;
  }

  if (tid < kJ) {
    const int i = tid;
    float* G = s_glb + i * 9;
    const float* P = s_pg + i * 9;
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        G[3 * r + c] = s_rfix[3 * r] * P[c] + s_rfix[3 * r + 1] * P[3 + c] +
                       s_rfix[3 * r + 2] * P[6 + c];
    float jt[3], gj[3];
    mat_vec(s_rfix, s_pall + i * 3, jt);
    mat_vec(G, a.j0 + i * 3, gj);
    for (int k = 0; k < 3; ++k) {
      jt[k] += s_tran[k];
      s_joint[i * 3 + k] = jt[k];
      a.joint[i * 3 + k] = jt[k];
      s_tj[i * 3 + k] = jt[k] - gj[k];
    }
  }
  __syncthreads();

  if (tid < kV) {
    const int v = tid;
    float jc[3];
    const int sj = sync_joint(v);
    if (sj >= 0) {
      for (int k = 0; k < 3; ++k) jc[k] = s_joint[sj * 3 + k];
    } else {
      // LBS of one landmark: (sum_j w R_j) @ v0 + sum_j w t_j
      float Rv[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float tv[3] = {0.f, 0.f, 0.f};
      const float* w = a.wsub + v * kJ;
      for (int j = 0; j < kJ; ++j) {
        const float wj = w[j];
        for (int k = 0; k < 9; ++k) Rv[k] += wj * s_glb[j * 9 + k];
        for (int k = 0; k < 3; ++k) tv[k] += wj * s_tj[j * 3 + k];
      }
      float v0[3] = {a.v0sub[v * 3], a.v0sub[v * 3 + 1], a.v0sub[v * 3 + 2]};
      if (a.blendshape) {
        // v0 += posedirs . (pose[1:] - I), coefficient p = (j-1)*9 + k
        for (int cc = 0; cc < 3; ++cc) {
          float acc = 0.f;
          const float* pdc = a.pd + cc * kP * kV;
          for (int p = 0; p < kP; ++p) {
            const int k = p % 9;
            const float r = s_pose[9 + p] - ((k == 0 || k == 4 || k == 8)
                                                 ? 1.f : 0.f);
            acc += pdc[p * kV + v] * r;
          }
          v0[cc] += acc;
        }
      }
      float rv0[3];
      mat_vec(Rv, v0, rv0);
      for (int k = 0; k < 3; ++k) jc[k] = rv0[k] + tv[k];
    }
    for (int k = 0; k < 3; ++k) {
      float out = jc[k];
      if (a.live && !s_fk_now) out = a.j_temp[v * 3 + k];
      a.j_lm[v * 3 + k] = out;
      a.j_temp_out[v * 3 + k] = a.live ? out : a.j_temp[v * 3 + k];
    }
  }
}

}  // namespace

extern "C" int geometry_tail_launch(
    const float* out7, const float* out8, const float* rcr, const float* vr,
    const float* pc, const float* c, const float* k_lerp,
    const float* first_tran, const float* grav, const float* last_pfoot,
    const unsigned char* has_pfoot, const float* last_tran,
    const unsigned char* has_tran, const float* floor_buf,
    const int* floor_cnt, const int* vision_count, const float* j_temp,
    const int* parent, const float* bone, const float* j0, const float* wsub,
    const float* v0sub, const float* pd, float* pose, float* tran,
    float* contact, float* pfoot, float* floor_buf_out, int* floor_cnt_out,
    int* vision_count_out, float* j_temp_out, float* joint, float* j_lm,
    int first_frame, int first_tran_valid, float conf_hi,
    float contact_threshold, float distance_threshold, float tran_filter_num,
    float height_threshold, int use_flat_floor, int live,
    int update_vision_freq, int landmarks, int blendshape, void* stream) {
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
  a.last_pfoot = last_pfoot;
  a.has_pfoot = has_pfoot;
  a.last_tran = last_tran;
  a.has_tran = has_tran;
  a.floor_buf = floor_buf;
  a.floor_cnt = floor_cnt;
  a.vision_count = vision_count;
  a.j_temp = j_temp;
  a.parent = parent;
  a.bone = bone;
  a.j0 = j0;
  a.wsub = wsub;
  a.v0sub = v0sub;
  a.pd = pd;
  a.pose = pose;
  a.tran = tran;
  a.contact = contact;
  a.pfoot = pfoot;
  a.floor_buf_out = floor_buf_out;
  a.floor_cnt_out = floor_cnt_out;
  a.vision_count_out = vision_count_out;
  a.j_temp_out = j_temp_out;
  a.joint = joint;
  a.j_lm = j_lm;
  a.first_frame = first_frame;
  a.first_tran_valid = first_tran_valid;
  a.conf_hi = conf_hi;
  a.contact_threshold = contact_threshold;
  a.distance_threshold = distance_threshold;
  a.tran_filter_num = tran_filter_num;
  a.height_threshold = height_threshold;
  a.use_flat_floor = use_flat_floor;
  a.live = live;
  a.update_vision_freq = update_vision_freq;
  a.landmarks = landmarks;
  a.blendshape = blendshape;
  geometry_tail_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return cudaGetLastError();
}

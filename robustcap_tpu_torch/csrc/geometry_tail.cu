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
// floor and live logic. Config flags are kernel arguments. The body is the
// device function tail_block (tail_block.cuh), which the serve kernel runs
// too.
//
// Plain C interface for ctypes: geometry_tail_launch returns the CUDA error
// code of the launch (0 on success).

#include <cuda_runtime.h>

#include "tail_block.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) geometry_tail_kernel(TailArgs a) {
  __shared__ TailShared sh;
  tail_block(a, sh);
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
  TailArgs a;
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

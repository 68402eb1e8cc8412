r"""The per-frame geometry tail of the SigMP step.

Everything below the rnn7/rnn8 heads of one frame: contact sigmoid, r6d ->
rotation (Gram-Schmidt), IK against the parent, light FK, translation from
contacts or network velocity, visual position fusion, the flat-floor ring,
first-frame overrides and the 33-landmark LBS with ``sync_mp3d`` and the
live-mode throttle. :func:`geometry_tail` takes the place of the JAX
package's ``ops/pallas_tail.py::geometry_tail``: on a CUDA tensor it is one
launch of the hand-written kernel ``csrc/geometry_tail.cu``; on a CPU tensor
it runs the plain version, :func:`tail_plain`, which is also what the step
runs on any device when ``cfg.pallas_tail`` is off. The reprojection
refinement stays with the caller, as in the JAX package.

Frame flags ``first_frame`` and ``first_tran_valid`` are host booleans (the
port's frames carry them on the host); everything else is a tensor on the
frame's device. :func:`tail_batched` is the same tail over a leading batch
axis, for the batched step: there the flags are ``[B]`` bool tensors and
every decision is a ``torch.where``, as under ``jax.vmap``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import MP_VERTEX_MASK, VEL_SCALE
from ..math.angular import r6d_to_rotation_matrix
from ..math.general import lerp
from ..math.spatial import mat3_mul
from . import _build

__all__ = ["LAUNCHES", "PD_ROW", "BODY_WORDS", "tail_constants", "tail_plain",
           "tail_batched", "geometry_tail", "sync_mp3d"]

# kernel launches so far (one per call on CUDA tensors)
LAUNCHES = 0

# The kernels' layouts (csrc/tail_block.cuh): floats of a posedirs row
# (kPdRow) and words of the packed body-model constants (kTcBody)
PD_ROW = 208
BODY_WORDS = 1060


def sync_mp3d(vert_mp: torch.Tensor, joint: torch.Tensor) -> torch.Tensor:
    r"""The 33 MediaPipe 3-D landmarks from the gathered mask vertices
    ``[..., 33, 3]``, with limbs, hips, knees and ankles overwritten by the
    joint positions ``[..., 24, 3]``."""
    syn = vert_mp.clone()
    syn[..., 11:17, :] = joint[..., 16:22, :]
    syn[..., 23:25, :] = joint[..., 1:3, :]
    syn[..., 25:27, :] = joint[..., 4:6, :]
    syn[..., 27:29, :] = joint[..., 7:9, :]
    return syn


def tail_constants(body_model):
    r"""Body-model constants of the tail, on the model's device: parent
    index (int32, root -> 0), ancestor matrix, bone vectors, zero-pose
    joints, and the skinning weights and rest positions of the 33 landmark
    vertices (ids clipped to the model's
    vertex range, as the JAX package's gathers clamp them). ``body`` holds
    the parent index (int32 bits), bones, joints, weights and rest positions
    end to end as the kernels stage them (``csrc/tail_block.cuh``'s kTc*
    words, padded to 16 bytes). With pose blendshapes, ``pd`` is the
    landmarks' posedirs as ``[3, 207, 33]`` (what the plain version reads)
    and ``pd_rows`` the same as the kernels read it, ``[3 x 33, 208]``: row
    ``c * 33 + v`` holds landmark v's 207 coefficients of channel c,
    zero-padded to 16 bytes, so that a warp's lanes read consecutive words
    of one row."""
    dev = body_model.device
    tree = body_model.tree
    ids = body_model.vertex_index(MP_VERTEX_MASK)
    consts = {
        "parent": torch.as_tensor(np.asarray(tree.parent_clamped),
                                  dtype=torch.int32, device=dev),
        "anc": torch.as_tensor(tree.ancestor_matrix, dtype=torch.float32,
                               device=dev),
        "bone": body_model._bone_vector.contiguous(),
        "j0": body_model._zero_pose_joint.contiguous(),
        "wsub": body_model._skinning_weights[ids].contiguous(),
        "v0sub": body_model._zero_pose_vertex[ids].contiguous(),
        "slots": torch.arange(11, device=dev),
        "blendshape": bool(body_model.use_pose_blendshape),
        "pd": None,
        "pd_rows": None,
    }
    body = torch.cat([consts["parent"].view(torch.float32)]
                     + [consts[k].reshape(-1).to(torch.float32)
                        for k in ("bone", "j0", "wsub", "v0sub")])
    consts["body"] = torch.cat([body, body.new_zeros(BODY_WORDS
                                                     - body.numel())])
    if consts["blendshape"]:
        pd = body_model._posedirs[ids]                       # [33, 3, 207]
        consts["pd"] = pd.permute(1, 2, 0).contiguous()
        rows = torch.zeros((3 * len(ids), PD_ROW), dtype=pd.dtype, device=dev)
        rows[:, :pd.shape[2]] = pd.transpose(0, 1).reshape(-1, pd.shape[2])
        consts["pd_rows"] = rows
    return consts


def tail_plain(consts, cfg, out7, out8, carry, frame, c, Rcr, vr, pc,
               k_lerp):
    r"""The plain PyTorch version of the tail. Returns the dict of the JAX
    package's tail: contact, pose, tran, pfoot, floor_buf, floor_cnt,
    vision_count, j_temp, joint, j_lm."""
    conf_hi = cfg.conf_range[1]
    ct = cfg.contact_threshold
    parent = consts["parent"]
    contact = torch.sigmoid(out8)

    # -- pose: r6d -> global R -> local pose, root := Rcr
    poseg = r6d_to_rotation_matrix(out7).reshape(24, 3, 3)
    parent_R = poseg[parent]
    pose = torch.cat([Rcr[None], mat3_mul(parent_R.transpose(-1, -2),
                                          poseg)[1:]])

    # -- light FK: pb[i] = R_glb[parent[i]] @ bone[i], ancestor prefix sum
    pb = (parent_R * consts["bone"][:, None, :]).sum(-1)
    pb = torch.cat([torch.zeros_like(pb[:1]), pb[1:]])
    p_all = (consts["anc"][:, :, None] * pb[None, :, :]).sum(1)

    # -- translation from contacts / network velocity
    pfoot = (p_all[10:12, None, :] * Rcr[None]).sum(-1)
    cmax = contact.max()
    v_net = (Rcr * vr.reshape(1, 3)).sum(1) * (VEL_SCALE / 60.0)
    d_foot = carry["last_pfoot"] - pfoot
    # argmax(contact) == 0: the first maximum wins a tie
    v_contact = torch.where(contact[0] >= contact[1], d_foot[0], d_foot[1])
    use_net = (cmax < ct) | ~carry["has_pfoot"]
    v = torch.where(use_net, v_net, v_contact)
    tran = torch.where(carry["has_tran"], carry["last_tran"] + v, v)

    # -- visual absolute-position fusion
    snap_far = (torch.linalg.vector_norm(pc - tran) > cfg.distance_threshold) \
        | (cfg.tran_filter_num > 1)
    tran_vis = torch.where(snap_far, pc,
                           lerp(tran, pc, cfg.tran_filter_num * k_lerp))
    tran = torch.where(c >= conf_hi, tran_vis, tran)

    # -- flat-floor ring of contact heights (one-hot write) and its snap
    floor_buf, floor_cnt = carry["floor_buf"], carry["floor_cnt"]
    if cfg.use_flat_floor:
        grav = frame["gravityc"]
        p0 = torch.dot(pfoot[0] + tran, grav) * grav
        p1 = torch.dot(pfoot[1] + tran, grav) * grav
        n0 = torch.linalg.vector_norm(p0)
        n1 = torch.linalg.vector_norm(p1)
        lower = torch.where(n0 < n1, p1, p0)
        append = ((floor_cnt < 11) & (cmax > ct) & (c >= conf_hi)
                  & (not frame["first_frame"])
                  & (not frame["first_tran_valid"]))
        slot = (consts["slots"] == floor_cnt)[:, None] & append
        floor_buf = torch.where(slot, lower[None], floor_buf)
        floor_cnt = floor_cnt + append.to(floor_cnt.dtype)

        snap = (floor_cnt > 10) & (cmax > ct)
        m = floor_buf[5:11].mean(0)
        use_p1 = (n0 < n1) & (torch.linalg.vector_norm(m - p1)
                              < cfg.height_threshold)
        delta = torch.where(
            use_p1, m - p1,
            torch.where(torch.linalg.vector_norm(m - p0)
                        < cfg.height_threshold, m - p0,
                        torch.zeros_like(m)))
        tran = torch.where(snap, tran + delta, tran)

    # -- first-frame overrides
    if frame["first_tran_valid"]:
        tran = frame["first_tran"]
    elif frame["first_frame"]:
        tran = pc

    # -- landmarks: closed-form FK of the root-fixed pose + 33-vertex LBS
    vision_count = carry["vision_count"]
    j_temp = carry["j_temp"]
    joint = torch.zeros((24, 3), dtype=tran.dtype, device=tran.device)
    j_lm = torch.zeros((33, 3), dtype=tran.dtype, device=tran.device)
    if cfg.use_reproj_opt or cfg.use_vision_updater:
        rfix = mat3_mul(Rcr, poseg[0].T)
        glb = mat3_mul(rfix[None], poseg)
        joint = (p_all[:, None, :] * rfix[None]).sum(-1) + tran
        t_j = joint - (glb * consts["j0"][:, None, :]).sum(-1)
        w_sub = consts["wsub"]
        R_v = torch.einsum("vj,jrc->vrc", w_sub, glb)
        v0_eff = consts["v0sub"]
        if consts["blendshape"]:
            eye = torch.eye(3, dtype=pose.dtype, device=pose.device)
            r = (pose[1:] - eye).reshape(-1)                 # [207]
            v0_eff = v0_eff + torch.einsum("cpv,p->vc", consts["pd"], r)
        verts = (R_v * v0_eff[:, None, :]).sum(-1) + w_sub @ t_j
        j_computed = sync_mp3d(verts, joint)
        if cfg.live:
            fk_now = vision_count == 0
            j_lm = torch.where(fk_now, j_computed, j_temp)
            j_temp = j_lm
            vision_count = torch.where(
                fk_now, torch.full_like(vision_count, cfg.update_vision_freq),
                vision_count - 1)
        else:
            j_lm = j_computed

    return {"contact": contact, "pose": pose, "tran": tran, "pfoot": pfoot,
            "floor_buf": floor_buf, "floor_cnt": floor_cnt,
            "vision_count": vision_count, "j_temp": j_temp, "joint": joint,
            "j_lm": j_lm}


def tail_batched(consts, cfg, out7, out8, carry, frame, c, Rcr, vr, pc,
                 k_lerp):
    r""":func:`tail_plain` over a leading batch axis: ``out7 [B, 144]``,
    ``c [B]``, ``Rcr [B, 3, 3]``, the carry's and frame's fields with a
    leading ``B``, and ``frame["first_frame"]``/``["first_tran_valid"]``
    as ``[B]`` bool tensors. Returns the same dict, every field with a
    leading ``B``."""
    B = out7.shape[0]
    conf_hi = cfg.conf_range[1]
    ct = cfg.contact_threshold
    parent = consts["parent"]
    contact = torch.sigmoid(out8)
    full = c >= conf_hi

    # -- pose: r6d -> global R -> local pose, root := Rcr
    poseg = r6d_to_rotation_matrix(out7).reshape(B, 24, 3, 3)
    parent_R = poseg[:, parent]
    pose = torch.cat([Rcr[:, None], mat3_mul(parent_R.transpose(-1, -2),
                                             poseg)[:, 1:]], 1)

    # -- light FK: pb[i] = R_glb[parent[i]] @ bone[i], ancestor prefix sum
    pb = (parent_R * consts["bone"][:, None, :]).sum(-1)
    pb = torch.cat([torch.zeros_like(pb[:, :1]), pb[:, 1:]], 1)
    p_all = (consts["anc"][:, :, None] * pb[:, None, :, :]).sum(2)

    # -- translation from contacts / network velocity
    pfoot = (p_all[:, 10:12, None, :] * Rcr[:, None]).sum(-1)
    cmax = contact.amax(-1)
    v_net = (Rcr * vr.reshape(B, 1, 3)).sum(-1) * (VEL_SCALE / 60.0)
    d_foot = carry["last_pfoot"] - pfoot
    v_contact = torch.where((contact[:, 0] >= contact[:, 1])[:, None],
                            d_foot[:, 0], d_foot[:, 1])
    use_net = (cmax < ct) | ~carry["has_pfoot"]
    v = torch.where(use_net[:, None], v_net, v_contact)
    tran = torch.where(carry["has_tran"][:, None], carry["last_tran"] + v, v)

    # -- visual absolute-position fusion
    snap_far = (torch.linalg.vector_norm(pc - tran, dim=-1)
                > cfg.distance_threshold) | (cfg.tran_filter_num > 1)
    tran_vis = torch.where(snap_far[:, None], pc,
                           lerp(tran, pc, cfg.tran_filter_num
                                * k_lerp[:, None]))
    tran = torch.where(full[:, None], tran_vis, tran)

    # -- flat-floor ring of contact heights (one-hot write) and its snap
    floor_buf, floor_cnt = carry["floor_buf"], carry["floor_cnt"]
    first_frame = frame["first_frame"]
    first_tran_valid = frame["first_tran_valid"]
    if cfg.use_flat_floor:
        grav = frame["gravityc"]
        p0 = ((pfoot[:, 0] + tran) * grav).sum(-1, keepdim=True) * grav
        p1 = ((pfoot[:, 1] + tran) * grav).sum(-1, keepdim=True) * grav
        n0 = torch.linalg.vector_norm(p0, dim=-1)
        n1 = torch.linalg.vector_norm(p1, dim=-1)
        lower = torch.where((n0 < n1)[:, None], p1, p0)
        append = ((floor_cnt < 11) & (cmax > ct) & full & ~first_frame
                  & ~first_tran_valid)
        slot = ((consts["slots"] == floor_cnt[:, None])
                & append[:, None])[:, :, None]
        floor_buf = torch.where(slot, lower[:, None], floor_buf)
        floor_cnt = floor_cnt + append.to(floor_cnt.dtype)

        snap = (floor_cnt > 10) & (cmax > ct)
        m = floor_buf[:, 5:11].mean(1)
        use_p1 = (n0 < n1) & (torch.linalg.vector_norm(m - p1, dim=-1)
                              < cfg.height_threshold)
        near_p0 = torch.linalg.vector_norm(m - p0, dim=-1) \
            < cfg.height_threshold
        delta = torch.where(use_p1[:, None], m - p1,
                            torch.where(near_p0[:, None], m - p0,
                                        torch.zeros_like(m)))
        tran = torch.where(snap[:, None], tran + delta, tran)

    # -- first-frame overrides
    tran = torch.where(first_tran_valid[:, None], frame["first_tran"],
                       torch.where(first_frame[:, None], pc, tran))

    # -- landmarks: closed-form FK of the root-fixed pose + 33-vertex LBS
    vision_count = carry["vision_count"]
    j_temp = carry["j_temp"]
    joint = tran.new_zeros((B, 24, 3))
    j_lm = tran.new_zeros((B, 33, 3))
    if cfg.use_reproj_opt or cfg.use_vision_updater:
        rfix = mat3_mul(Rcr, poseg[:, 0].transpose(-1, -2))
        glb = mat3_mul(rfix[:, None], poseg)
        joint = (p_all[:, :, None, :] * rfix[:, None]).sum(-1) \
            + tran[:, None]
        t_j = joint - (glb * consts["j0"][:, None, :]).sum(-1)
        w_sub = consts["wsub"]
        R_v = torch.einsum("vj,bjrc->bvrc", w_sub, glb)
        v0_eff = consts["v0sub"]
        if consts["blendshape"]:
            eye = torch.eye(3, dtype=pose.dtype, device=pose.device)
            r = (pose[:, 1:] - eye).reshape(B, -1)             # [B, 207]
            v0_eff = v0_eff + torch.einsum("cpv,bp->bvc", consts["pd"], r)
        verts = (R_v * v0_eff[..., None, :]).sum(-1) \
            + torch.einsum("vj,bjc->bvc", w_sub, t_j)
        j_computed = sync_mp3d(verts, joint)
        if cfg.live:
            fk_now = vision_count == 0
            j_lm = torch.where(fk_now[:, None, None], j_computed, j_temp)
            j_temp = j_lm
            vision_count = torch.where(
                fk_now, torch.full_like(vision_count, cfg.update_vision_freq),
                vision_count - 1)
        else:
            j_lm = j_computed

    return {"contact": contact, "pose": pose, "tran": tran, "pfoot": pfoot,
            "floor_buf": floor_buf, "floor_cnt": floor_cnt,
            "vision_count": vision_count, "j_temp": j_temp, "joint": joint,
            "j_lm": j_lm}


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [_P] * 21 + [_I, _I] + [_F] * 5 + [_I] * 4 + [_P]

# f32 output fields and their shapes, laid end to end in one output buffer
# as the kernel writes them (csrc/tail_block.cuh's kOff* words)
_OUT_F32 = (("pose", (24, 3, 3)), ("tran", (3,)), ("contact", (2,)),
            ("pfoot", (2, 3)), ("floor_buf", (11, 3)), ("j_temp", (33, 3)),
            ("joint", (24, 3)), ("j_lm", (33, 3)))
_OUT_F32_SIZE = sum(int(np.prod(s)) for _, s in _OUT_F32)


def _lib():
    lib = _build.load("geometry_tail")
    fn = lib.geometry_tail_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(consts, cfg, out7, out8, carry, frame, c, Rcr, vr, pc, k_lerp):
    global LAUNCHES
    dev = out7.device
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    landmarks = bool(cfg.use_reproj_opt or cfg.use_vision_updater)
    blendshape = consts["blendshape"] and landmarks
    inputs = [
        ("out7", out7.reshape(24, 6), (24, 6), f32),
        ("out8", out8, (2,), f32),
        ("Rcr", Rcr, (3, 3), f32),
        ("vr", vr.reshape(3), (3,), f32),
        ("pc", pc.reshape(3), (3,), f32),
        ("c", c, (), f32),
        ("k_lerp", k_lerp, (), f32),
        ("first_tran", frame["first_tran"], (3,), f32),
        ("gravityc", frame["gravityc"], (3,), f32),
        ("last_pfoot", carry["last_pfoot"], (2, 3), f32),
        ("has_pfoot", carry["has_pfoot"], (), b8),
        ("last_tran", carry["last_tran"], (3,), f32),
        ("has_tran", carry["has_tran"], (), b8),
        ("floor_buf", carry["floor_buf"], (11, 3), f32),
        ("floor_cnt", carry["floor_cnt"], (), i32),
        ("vision_count", carry["vision_count"], (), i32),
        ("j_temp", carry["j_temp"], (33, 3), f32),
        ("body", consts["body"], (BODY_WORDS,), f32),
    ]
    if blendshape:
        inputs.append(("pd_rows", consts["pd_rows"], (99, PD_ROW), f32))
    for name, t, shape, dtype in inputs:
        _check(name, t, shape, dtype, dev)
    ptrs = [t.data_ptr() for _, t, _, _ in inputs]
    if not blendshape:
        ptrs.append(None)

    buf = torch.empty((_OUT_F32_SIZE,), dtype=f32, device=dev)
    counts = torch.empty((2,), dtype=i32, device=dev)
    out, off = {}, 0
    for name, shape in _OUT_F32:
        n = int(np.prod(shape))
        out[name] = buf[off:off + n].view(shape)
        off += n
    out["floor_cnt"], out["vision_count"] = counts[0], counts[1]
    ptrs += [buf.data_ptr(), counts.data_ptr()]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(
        *ptrs, int(bool(frame["first_frame"])),
        int(bool(frame["first_tran_valid"])), float(cfg.conf_range[1]),
        float(cfg.contact_threshold), float(cfg.distance_threshold),
        float(cfg.tran_filter_num), float(cfg.height_threshold),
        int(cfg.use_flat_floor), int(cfg.live), int(cfg.update_vision_freq),
        int(landmarks), stream)
    if err != 0:
        raise RuntimeError(
            f"geometry_tail kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def geometry_tail(consts, cfg, out7, out8, carry, frame, c, Rcr, vr, pc,
                  k_lerp):
    r"""The whole post-heads tail of one frame: one kernel launch on CUDA
    tensors, the plain version on CPU tensors. Same inputs and returned
    dict as :func:`tail_plain`."""
    if out7.device.type == "cpu":
        return tail_plain(consts, cfg, out7, out8, carry, frame, c, Rcr, vr,
                          pc, k_lerp)
    if out7.device.type != "cuda":
        raise ValueError(f"no geometry-tail path for device {out7.device}")
    return _launch(consts, cfg, out7, out8, carry, frame, c, Rcr, vr, pc,
                   k_lerp)

r"""The per-frame geometry tail of the SigMP step.

Everything below the rnn7/rnn8 heads of a frame: contact sigmoid, r6d ->
rotation (Gram-Schmidt), IK against the parent, light FK, translation from
contacts or network velocity, visual position fusion, the flat-floor ring,
first-frame overrides and the 33-landmark LBS with ``sync_mp3d`` and the
live-mode throttle. The reprojection refinement stays with the caller, as
in the JAX package.

:func:`tail_plain` is the plain version for one frame and
:func:`tail_batched` the same over a leading batch axis, where the flags
``first_frame`` and ``first_tran_valid`` are ``[B]`` bool tensors and every
decision is a ``torch.where``, as under ``jax.vmap``. The steps run them
when ``cfg.pallas_tail`` is off.

With ``cfg.pallas_tail`` the tail is the operator
``torch.ops.robustcap.geometry_tail``, which takes the place of the JAX
package's ``ops/pallas_tail.py::geometry_tail`` (and of that kernel under
``vmap``): on CUDA tensors one launch of the hand-written kernel
``csrc/geometry_tail.cu`` over B rows, with the flags read on the device;
on CPU tensors :func:`tail_batched`. :func:`geometry_tail_batched` calls it
for the batched step (also when exported or captured in a CUDA graph), and
:func:`geometry_tail` for one frame as a batch of one, its host flags
filled into device tensors without a copy.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

import numpy as np
import torch

from ..config import MP_VERTEX_MASK, VEL_SCALE
from ..math.angular import r6d_to_rotation_matrix
from ..math.general import lerp
from ..math.spatial import get_tree, mat3_mul
from . import _build

__all__ = ["LAUNCHES", "PD_ROW", "BODY_WORDS", "tail_constants", "tail_plain",
           "tail_batched", "geometry_tail", "geometry_tail_batched",
           "sync_mp3d"]

# kernel launches so far (one per operator call on CUDA tensors outside a
# CUDA graph's capture; a capture launches nothing and a replay does not
# come through here)
LAUNCHES = 0

# The kernels' layouts (csrc/tail_block.cuh): floats of a posedirs row
# (kPdRow) and words of the packed body-model constants (kTcBody)
PD_ROW = 208
BODY_WORDS = 1060
# the packed body-model constants: (name, first word, shape), the kTc*
# words of csrc/tail_block.cuh
_BODY_SLICES = (("parent", 0, (24,)), ("bone", 24, (24, 3)),
                ("j0", 96, (24, 3)), ("wsub", 168, (33, 24)),
                ("v0sub", 960, (33, 3)))


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
    body = torch.zeros(BODY_WORDS, dtype=torch.float32, device=dev)
    for name, off, shape in _BODY_SLICES:
        x = consts[name]
        x = x.view(torch.float32) if x.dtype == torch.int32 else x
        body[off:off + x.numel()] = x.reshape(shape).reshape(-1)
    consts["body"] = body
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
_ARGTYPES = [_P] * 23 + [_I] + [_F] * 5 + [_I] * 4 + [_P]

# f32 output fields and their shapes, laid end to end in a row of the
# operator's first output as the kernel writes them (csrc/tail_block.cuh's
# kOff* words); the second output holds floor_cnt and vision_count
_OUT_F32 = (("pose", (24, 3, 3)), ("tran", (3,)), ("contact", (2,)),
            ("pfoot", (2, 3)), ("floor_buf", (11, 3)), ("j_temp", (33, 3)),
            ("joint", (24, 3)), ("j_lm", (33, 3)))
_OUT_F32_SIZE = sum(int(np.prod(s)) for _, s in _OUT_F32)
# (name, first word, words, shape) of each field in a row
_OUT_SLICES = tuple(
    (name, int(sum(np.prod(s) for _, s in _OUT_F32[:i])), int(np.prod(shape)),
     shape) for i, (name, shape) in enumerate(_OUT_F32))

# the operator's operands, each with a leading B, in the kernel's order:
# (name, shape of a row, dtype)
_F32, _I32, _B8 = torch.float32, torch.int32, torch.bool
_FRAME_OPS = (("out7", (144,), _F32), ("out8", (2,), _F32),
              ("Rcr", (3, 3), _F32), ("vr", (3,), _F32), ("pc", (3,), _F32),
              ("c", (), _F32), ("k_lerp", (), _F32),
              ("first_tran", (3,), _F32), ("gravityc", (3,), _F32),
              ("first_frame", (), _B8), ("first_tran_valid", (), _B8))
_CARRY_OPS = (("last_pfoot", (2, 3), _F32), ("has_pfoot", (), _B8),
              ("last_tran", (3,), _F32), ("has_tran", (), _B8),
              ("floor_buf", (11, 3), _F32), ("floor_cnt", (), _I32),
              ("vision_count", (), _I32), ("j_temp", (33, 3), _F32))
_FLTS = ("conf_hi", "contact_threshold", "distance_threshold",
         "tran_filter_num", "height_threshold")
_INTS = ("use_flat_floor", "live", "update_vision_freq", "landmarks")


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


def _op_args(consts, cfg, out7, out8, carry, frame, c, Rcr, vr, pc, k_lerp):
    r"""The operator's arguments from B rows of the tail's inputs (each
    made contiguous): frame operands, carry operands, the packed body
    constants, the posedirs rows (``None`` without blendshapes or
    landmarks), and the configuration's floats and ints."""
    B = out7.shape[0]

    def rows(t, shape):
        shape = (B,) + shape
        return (t if t.shape == shape else t.reshape(shape)).contiguous()

    vals = dict(out7=out7, out8=out8, Rcr=Rcr, vr=vr, pc=pc, c=c,
                k_lerp=k_lerp)
    vals.update((k, frame[k]) for k in ("first_tran", "gravityc",
                                        "first_frame", "first_tran_valid"))
    frame_ops = [rows(vals[k], shape) for k, shape, _ in _FRAME_OPS]
    carry_ops = [rows(carry[k], shape) for k, shape, _ in _CARRY_OPS]
    landmarks = bool(cfg.use_reproj_opt or cfg.use_vision_updater)
    bs = consts["blendshape"] and landmarks
    flts = [float(cfg.conf_range[1]), float(cfg.contact_threshold),
            float(cfg.distance_threshold), float(cfg.tran_filter_num),
            float(cfg.height_threshold)]
    ints = [int(cfg.use_flat_floor), int(cfg.live),
            int(cfg.update_vision_freq), int(landmarks)]
    return (frame_ops, carry_ops, consts["body"],
            consts["pd_rows"] if bs else None, flts, ints)


def _pack(out):
    r"""The plain version's dict as the operator's two outputs."""
    B = out["tran"].shape[0]
    return (torch.cat([out[k].reshape(B, -1) for k, _ in _OUT_F32], 1),
            torch.stack([out["floor_cnt"], out["vision_count"]],
                        1).to(_I32))


def _unpack(buf, counts):
    r"""The dict of :func:`tail_batched` (or, from one row of the outputs,
    of :func:`tail_plain`) as views of the operator's outputs."""
    lead = tuple(buf.shape[:-1])
    out = {name: buf.narrow(-1, off, n).view(lead + shape)
           for name, off, n, shape in _OUT_SLICES}
    out["floor_cnt"], out["vision_count"] = counts.unbind(-1)
    return out


def _unpack_consts(body, pd_rows):
    r"""The constants :func:`tail_batched` reads, as views of the packed
    ``body`` words and posedirs rows (the ancestor matrix from the parent
    index)."""
    const = {name: body.narrow(0, off, int(np.prod(shape))).view(shape)
             for name, off, shape in _BODY_SLICES}
    parent = const["parent"].view(torch.int32)
    tree = get_tree(parent.tolist())
    const.update(parent=parent, anc=torch.as_tensor(tree.ancestor_matrix),
                 slots=torch.arange(11), blendshape=pd_rows is not None,
                 pd=None)
    if pd_rows is not None:
        const["pd"] = pd_rows[:, :207].reshape(3, 33, 207).permute(
            0, 2, 1).contiguous()
    return const


def _geometry_tail_cpu(frame_ops, carry_ops, body, pd_rows, flts, ints):
    r"""The operator on CPU tensors: :func:`tail_batched`."""
    v = {k: t for (k, _, _), t in zip(_FRAME_OPS, frame_ops)}
    frame = {k: v[k] for k in ("first_tran", "gravityc", "first_frame",
                               "first_tran_valid")}
    carry = {k: t for (k, _, _), t in zip(_CARRY_OPS, carry_ops)}
    f = dict(zip(_FLTS, flts))
    i = dict(zip(_INTS, ints))
    cfg = SimpleNamespace(
        conf_range=(None, f["conf_hi"]),
        contact_threshold=f["contact_threshold"],
        distance_threshold=f["distance_threshold"],
        tran_filter_num=f["tran_filter_num"],
        height_threshold=f["height_threshold"],
        use_flat_floor=bool(i["use_flat_floor"]), live=bool(i["live"]),
        update_vision_freq=i["update_vision_freq"],
        use_vision_updater=bool(i["landmarks"]), use_reproj_opt=False)
    return _pack(tail_batched(_unpack_consts(body, pd_rows), cfg, v["out7"],
                              v["out8"], carry, frame, v["c"], v["Rcr"],
                              v["vr"], v["pc"], v["k_lerp"]))


def _geometry_tail_cuda(frame_ops, carry_ops, body, pd_rows, flts, ints):
    r"""The operator on CUDA tensors: one launch of the kernel over the B
    rows, on the current stream, with no host read (while the stream is
    captured into a CUDA graph, the graph's node, not counted as a
    launch)."""
    global LAUNCHES
    dev = frame_ops[0].device
    B = frame_ops[0].shape[0]
    named = list(zip(_FRAME_OPS, frame_ops)) + list(zip(_CARRY_OPS,
                                                        carry_ops))
    for (name, shape, dtype), t in named:
        _check(name, t, (B,) + shape, dtype, dev)
    _check("body", body, (BODY_WORDS,), _F32, dev)
    if pd_rows is not None:
        _check("pd_rows", pd_rows, (99, PD_ROW), _F32, dev)
    buf = torch.empty((B, _OUT_F32_SIZE), dtype=_F32, device=dev)
    counts = torch.empty((B, 2), dtype=_I32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(*(t.data_ptr() for _, t in named), body.data_ptr(),
                 None if pd_rows is None else pd_rows.data_ptr(),
                 buf.data_ptr(), counts.data_ptr(), B, *flts, *ints, stream)
    if err != 0:
        raise RuntimeError(
            f"geometry_tail kernel launch failed: CUDA error {err}")
    if dev.type != "cuda" or not torch.cuda.is_current_stream_capturing():
        LAUNCHES += 1
    return buf, counts


def _geometry_tail_fake(frame_ops, carry_ops, body, pd_rows, flts, ints):
    B = frame_ops[0].shape[0]
    return (frame_ops[0].new_empty((B, _OUT_F32_SIZE)),
            frame_ops[0].new_empty((B, 2), dtype=_I32))


geometry_tail_op = torch.library.custom_op(
    "robustcap::geometry_tail", _geometry_tail_cpu, mutates_args=(),
    device_types="cpu",
    schema="(Tensor[] frame_ops, Tensor[] carry_ops, Tensor body, "
           "Tensor? pd_rows, float[] flts, int[] ints) -> (Tensor, Tensor)")
geometry_tail_op.register_kernel("cuda")(_geometry_tail_cuda)
geometry_tail_op.register_fake(_geometry_tail_fake)


def _check_device(dev):
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no geometry-tail path for device {dev}")


def _launch_batched(consts, cfg, out7, out8, carry, frame, c, Rcr, vr, pc,
                    k_lerp):
    r"""The kernel launch of :func:`geometry_tail_batched` called directly,
    on the tensors' own device, without the dispatcher: the g++ stand-in
    tests run the kernel's source on CPU tensors through it."""
    return _unpack(*_geometry_tail_cuda(*_op_args(
        consts, cfg, out7, out8, carry, frame, c, Rcr, vr, pc, k_lerp)))


def geometry_tail_batched(consts, cfg, out7, out8, carry, frame, c, Rcr, vr,
                          pc, k_lerp):
    r"""The tail of B frames, as one call of the operator
    ``torch.ops.robustcap.geometry_tail``: one kernel launch of B blocks on
    CUDA tensors, :func:`tail_batched` on CPU tensors. Same inputs and
    returned dict as :func:`tail_batched` (the flags ``[B]`` bool tensors
    on the device); the returned fields are views of the operator's two
    outputs."""
    _check_device(out7.device)
    return _unpack(*torch.ops.robustcap.geometry_tail(*_op_args(
        consts, cfg, out7, out8, carry, frame, c, Rcr, vr, pc, k_lerp)))


def _one_frame(run, consts, cfg, out7, out8, carry, frame, c, Rcr, vr, pc,
               k_lerp):
    r"""``run`` (the operator, or the kernel's direct call) on one frame as
    a batch of one; returns row 0 as views. The host flags become ``[1]``
    bool tensors filled on the device (no copy, no host sync)."""
    def flag(x):
        if isinstance(x, torch.Tensor):
            return x
        return torch.full((1,), bool(x), dtype=_B8, device=out7.device)

    frame = dict(frame, first_frame=flag(frame["first_frame"]),
                 first_tran_valid=flag(frame["first_tran_valid"]))
    buf, counts = run(*_op_args(consts, cfg, out7.reshape(1, -1), out8,
                                carry, frame, c, Rcr, vr, pc, k_lerp))
    return _unpack(buf[0], counts[0])


def _launch(consts, cfg, out7, out8, carry, frame, c, Rcr, vr, pc, k_lerp):
    r"""The kernel's direct call (:func:`_launch_batched`) on one frame, with
    the arguments of :func:`geometry_tail`."""
    return _one_frame(_geometry_tail_cuda, consts, cfg, out7, out8, carry,
                      frame, c, Rcr, vr, pc, k_lerp)


def geometry_tail(consts, cfg, out7, out8, carry, frame, c, Rcr, vr, pc,
                  k_lerp):
    r"""The whole post-heads tail of one frame: the operator on a batch of
    one, so one kernel launch on CUDA tensors and :func:`tail_batched` on
    CPU tensors. Same inputs and returned dict as :func:`tail_plain`."""
    _check_device(out7.device)
    return _one_frame(torch.ops.robustcap.geometry_tail, consts, cfg, out7,
                      out8, carry, frame, c, Rcr, vr, pc, k_lerp)

r"""The plain reference of the SigMP fusion network, in float32: six 2-layer
LSTM stacks (linear1 -> ReLU -> LSTM -> linear2, gate order i, f, g, o),
the first-frame prescan, and the branchless steady step with its geometry
tail (r6d -> rotations, IK, FK, translation from contacts or velocity,
visual fusion, the flat-floor ring, the 33-landmark skinning and the live
throttle), over a leading axis of independent rows.

It is a frozen copy of the published step's semantics (RobustCap's
``net/sig_mp.py``, arXiv 2309.00310) as the program states them, written
in plain ``torch`` operations with no kernel, cache or batching trick, and
imports nothing of the program. It computes in the arithmetic the
configuration states (its ``arithmetic``, with where the JAX serve kernel
and the port define it) for the type its weights are stored in:

* float32 weights: every product, sum, gate and state in float32
  (:func:`run` turns TF32 off, unless a control asks for it);
* bfloat16 weights (the bf16 serving mode): in the steady step the
  activation side of every product rounded to bfloat16, the weights' own
  values, sums, gates and states in float32, each gate bias the two
  biases summed in bfloat16; the first-frame prescan's stacks wholly in
  bfloat16, as a stack runs in its weights' type; the IMU re-init in
  float32 on the weights' values.

Rows are sequences that start at frame 0 of the run; a row's frames past
its own length are padding whose outputs the caller drops (the step is
causal).
"""

from __future__ import annotations

import torch

__all__ = ["OFFLINE", "LIVE", "init_carry", "prescan", "make_step", "run"]

# the configuration's flags (the published defaults, and the live demo's)
OFFLINE = dict(conf_range=(0.7, 0.8), contact_threshold=0.7,
               distance_threshold=10.0, tran_filter_num=0.05,
               height_threshold=0.15, use_flat_floor=True, live=False,
               update_vision_freq=30, use_imu_updater=True,
               use_vision_updater=True)
LIVE = dict(OFFLINE, live=True, conf_range=(0.85, 0.9), tran_filter_num=0.01)

VEL_SCALE = 3          # root-velocity scale of rnn3's output
STACKS = ("rnn2", "rnn3", "rnn4", "rnn6", "rnn7", "rnn8")
_EPS = 1e-8


# ---------------------------------------------------------------------------
# Small math
# ---------------------------------------------------------------------------


def _cast(tree, dtype):
    r"""Every leaf in ``dtype``; each LSTM layer gains ``b``, its two gate
    biases summed in their stored type."""
    if isinstance(tree, dict):
        out = {k: _cast(v, dtype) for k, v in tree.items()}
        if "b_ih" in tree:
            out["b"] = (tree["b_ih"] + tree["b_hh"]).to(dtype)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast(v, dtype) for v in tree)
    return tree.to(dtype)


def _bf(x):
    r"""``x`` rounded to bfloat16, held in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _normalize(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(
        _EPS)


def r6d_to_rotation(r6d):
    r"""``[..., 6] -> [..., 3, 3]`` by Gram-Schmidt."""
    c0 = _normalize(r6d[..., 0:3])
    c1 = _normalize(r6d[..., 3:6] - (c0 * r6d[..., 3:6]).sum(-1, True) * c0)
    c2 = torch.linalg.cross(c0, c1, dim=-1)
    return torch.stack((c0, c1, c2), dim=-1)


def _mm3(a, b):
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _lerp(a, b, t):
    return a * (1 - t) + b * t


def _rows(*xs):
    return torch.cat([x.reshape(x.shape[0], -1) for x in xs], -1)


def _bbox_normalize(j2dc):
    r"""Keypoint x/y over the bbox scale, root-centred on row 23 except row
    23 itself; the scale guarded with 1e-6."""
    xy = j2dc[..., :2]
    du = xy[..., 0].amax(-1) - xy[..., 0].amin(-1)
    dv = xy[..., 1].amax(-1) - xy[..., 1].amin(-1)
    scale = torch.clamp_min(torch.maximum(du, dv), 1e-6)[..., None, None]
    xy = xy / scale
    out = xy - xy[..., 23:24, :]
    out[..., 23, :] = xy[..., 23, :]
    return torch.cat([out, j2dc[..., 2:]], -1)


def _landmarks(vert, joint):
    syn = vert.clone()
    syn[..., 11:17, :] = joint[..., 16:22, :]
    syn[..., 23:25, :] = joint[..., 1:3, :]
    syn[..., 25:27, :] = joint[..., 4:6, :]
    syn[..., 27:29, :] = joint[..., 7:9, :]
    return syn


# ---------------------------------------------------------------------------
# The LSTM stacks
# ---------------------------------------------------------------------------


def _linear(p, x, rnd=None):
    return (x if rnd is None else rnd(x)) @ p["w"].T + p["b"]


def stack_step(p, x, state, rnd=None):
    r"""One frame of one stack: ``x [B, in]``, ``state`` (h, c) each
    ``[2, B, H]``, in the type of ``p``'s leaves; ``rnd``, where given,
    rounds the activation side of every product."""
    h, c = state
    r = (lambda v: v) if rnd is None else rnd
    inp = torch.relu(_linear(p["linear1"], x, rnd))
    hs, cs = [], []
    for l, layer in enumerate(p["layers"]):
        z = r(inp) @ layer["w_ih"].T + r(h[l]) @ layer["w_hh"].T \
            + layer["b"]
        i, f, g, o = z.chunk(4, -1)
        c_new = torch.sigmoid(f) * c[l] + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        hs.append(h_new)
        cs.append(c_new)
        inp = h_new
    return _linear(p["linear2"], inp, rnd), (torch.stack(hs),
                                              torch.stack(cs))


def _init_net(p, label):
    x = torch.relu(_linear(p["init_net"][0], label))
    x = torch.relu(_linear(p["init_net"][1], x))
    x = _linear(p["init_net"][2], x)
    L, H = len(p["layers"]), p["layers"][0]["w_hh"].shape[1]
    hc = x.reshape(x.shape[0], 2, L, H)
    return hc[:, 0].transpose(0, 1), hc[:, 1].transpose(0, 1)


def _where_state(cond, new, old):
    return tuple(torch.where(cond[:, None], n, o) for n, o in zip(new, old))


# ---------------------------------------------------------------------------
# Carry and prescan
# ---------------------------------------------------------------------------


def init_carry(params, B, device):
    def z(*shape, dt=torch.float32):
        return torch.zeros((B,) + shape, dtype=dt, device=device)

    states = {}
    for n in STACKS:
        H = params[n]["layers"][0]["w_hh"].shape[1]
        states[n] = (torch.zeros((2, B, H), device=device),
                     torch.zeros((2, B, H), device=device))
    return {"states": states, "last_pfoot": z(2, 3),
            "has_pfoot": z(dt=torch.bool), "last_tran": z(3),
            "has_tran": z(dt=torch.bool), "floor_buf": z(11, 3),
            "floor_cnt": z(dt=torch.int32),
            "first_reach": torch.ones(B, dtype=torch.bool, device=device),
            "vision_count": z(dt=torch.int32), "j_temp": z(33, 3),
            "pc_first": z(3), "out4_first": z(69)}


def prescan(params, carry, frame):
    r"""A first frame's rnn4 advance and rnn6's first-frame extra step, on
    the rows whose ``first_frame`` holds; the others keep their carry. The
    stacks run in the type of ``params``' leaves."""
    first = frame["first_frame"]
    st = carry["states"]
    dt = params["rnn4"]["linear1"]["w"].dtype

    def stack(name, x):
        out, (h, c) = stack_step(params[name], x.to(dt), tuple(
            s.to(dt) for s in st[name]))
        return out.float(), (h.float(), c.float())

    out4, st4 = stack("rnn4", _rows(
        frame["accc"], frame["oric"], _bbox_normalize(frame["j2dc"])))
    out6, st6 = stack("rnn6", _rows(
        frame["accc"], frame["oric"], frame["j2dc"], out4))
    carry = dict(carry)
    carry["states"] = dict(st, rnn4=_where_state(first, st4, st["rnn4"]),
                           rnn6=_where_state(first, st6, st["rnn6"]))
    carry["pc_first"] = torch.where(first[:, None], out6, carry["pc_first"])
    carry["out4_first"] = torch.where(first[:, None], out4,
                                      carry["out4_first"])
    return carry


# ---------------------------------------------------------------------------
# The tail
# ---------------------------------------------------------------------------


def tail(consts, cfg, out7, out8, carry, frame, c, Rcr, vr, pc, k_lerp):
    B = out7.shape[0]
    ct = cfg["contact_threshold"]
    full = c >= cfg["conf_range"][1]
    contact = torch.sigmoid(out8)

    # pose: r6d -> global rotations -> local, root := Rcr
    poseg = r6d_to_rotation(out7.reshape(B, 24, 6))
    parent_R = poseg[:, consts["parent"]]
    pose = torch.cat([Rcr[:, None],
                      _mm3(parent_R.transpose(-1, -2), poseg)[:, 1:]], 1)

    # FK of the bones under the global rotations
    pb = (parent_R * consts["bone"][:, None, :]).sum(-1)
    pb = torch.cat([torch.zeros_like(pb[:, :1]), pb[:, 1:]], 1)
    p_all = (consts["anc"][:, :, None] * pb[:, None]).sum(2)

    # translation from the foot in contact, or the network's velocity
    pfoot = (p_all[:, 10:12, None, :] * Rcr[:, None]).sum(-1)
    cmax = contact.amax(-1)
    v_net = (Rcr * vr.reshape(B, 1, 3)).sum(-1) * (VEL_SCALE / 60.0)
    d_foot = carry["last_pfoot"] - pfoot
    v_contact = torch.where((contact[:, 0] >= contact[:, 1])[:, None],
                            d_foot[:, 0], d_foot[:, 1])
    use_net = (cmax < ct) | ~carry["has_pfoot"]
    v = torch.where(use_net[:, None], v_net, v_contact)
    tran = torch.where(carry["has_tran"][:, None], carry["last_tran"] + v, v)

    # visual absolute position
    far = (torch.linalg.vector_norm(pc - tran, dim=-1)
           > cfg["distance_threshold"]) | (cfg["tran_filter_num"] > 1)
    tran_vis = torch.where(far[:, None], pc, _lerp(
        tran, pc, cfg["tran_filter_num"] * k_lerp[:, None]))
    tran = torch.where(full[:, None], tran_vis, tran)

    # flat floor: a ring of 11 contact heights, then the snap
    floor_buf, floor_cnt = carry["floor_buf"], carry["floor_cnt"]
    first, first_tv = frame["first_frame"], frame["first_tran_valid"]
    if cfg["use_flat_floor"]:
        g = frame["gravityc"]
        p0 = ((pfoot[:, 0] + tran) * g).sum(-1, keepdim=True) * g
        p1 = ((pfoot[:, 1] + tran) * g).sum(-1, keepdim=True) * g
        n0 = torch.linalg.vector_norm(p0, dim=-1)
        n1 = torch.linalg.vector_norm(p1, dim=-1)
        lower = torch.where((n0 < n1)[:, None], p1, p0)
        append = (floor_cnt < 11) & (cmax > ct) & full & ~first & ~first_tv
        slots = torch.arange(11, device=out7.device)
        slot = ((slots == floor_cnt[:, None]) & append[:, None])[:, :, None]
        floor_buf = torch.where(slot, lower[:, None], floor_buf)
        floor_cnt = floor_cnt + append.to(floor_cnt.dtype)
        snap = (floor_cnt > 10) & (cmax > ct)
        m = floor_buf[:, 5:11].mean(1)
        h = cfg["height_threshold"]
        use_p1 = (n0 < n1) & (torch.linalg.vector_norm(m - p1, dim=-1) < h)
        near_p0 = torch.linalg.vector_norm(m - p0, dim=-1) < h
        delta = torch.where(use_p1[:, None], m - p1, torch.where(
            near_p0[:, None], m - p0, torch.zeros_like(m)))
        tran = torch.where(snap[:, None], tran + delta, tran)

    tran = torch.where(first_tv[:, None], frame["first_tran"],
                       torch.where(first[:, None], pc, tran))

    # the 33 landmarks: FK of the root-fixed pose and skinning
    rfix = _mm3(Rcr, poseg[:, 0].transpose(-1, -2))
    glb = _mm3(rfix[:, None], poseg)
    joint = (p_all[:, :, None, :] * rfix[:, None]).sum(-1) + tran[:, None]
    t_j = joint - (glb * consts["j0"][:, None, :]).sum(-1)
    w = consts["wsub"]
    R_v = torch.einsum("vj,bjrc->bvrc", w, glb)
    v0 = consts["v0sub"]
    if consts["pd"] is not None:
        r = (pose[:, 1:] - torch.eye(3, device=out7.device)).reshape(B, -1)
        v0 = v0 + torch.einsum("cpv,bp->bvc", consts["pd"], r)
    verts = (R_v * v0[..., None, :]).sum(-1) \
        + torch.einsum("vj,bjc->bvc", w, t_j)
    j_new = _landmarks(verts, joint)
    vision_count, j_temp = carry["vision_count"], carry["j_temp"]
    if cfg["live"]:
        now = vision_count == 0
        j_lm = torch.where(now[:, None, None], j_new, j_temp)
        j_temp = j_lm
        vision_count = torch.where(
            now, torch.full_like(vision_count, cfg["update_vision_freq"]),
            vision_count - 1)
    else:
        j_lm = j_new
    return {"pose": pose, "tran": tran, "pfoot": pfoot,
            "floor_buf": floor_buf, "floor_cnt": floor_cnt,
            "vision_count": vision_count, "j_temp": j_temp, "joint": joint,
            "j_lm": j_lm}


# ---------------------------------------------------------------------------
# The steady step
# ---------------------------------------------------------------------------


def make_step(consts, cfg, rnd=None):
    r"""``step(params, carry, frame) -> (carry, (pose [B, 24, 3, 3],
    tran [B, 3]))`` after :func:`prescan`: the speculative heads and tail
    on the inertial joints, whose landmarks feed the occluded-frame refeed,
    one rnn4 and one rnn6 evaluation, the confidence gate, the final heads
    and tail, and the one-shot IMU re-init. ``rnd`` rounds the activation
    side of every stack's products (the bf16 serving mode)."""
    lo, hi = cfg["conf_range"]
    inv = 1.0 / (hi - lo)

    def heads_and_tail(params, carry, frame, st, c, Rcr, accr, orir, vr,
                       j3dr, pc, k):
        x = _rows(accr, orir, j3dr)
        out7, st7 = stack_step(params["rnn7"], x, st["rnn7"], rnd)
        out8, st8 = stack_step(params["rnn8"], x, st["rnn8"], rnd)
        T = tail(consts, cfg, out7, out8, carry, frame, c, Rcr, vr, pc, k)
        return dict(T, st7=st7, st8=st8)

    def step(params, carry, frame):
        st = carry["states"]
        j2dc, accc, oric = frame["j2dc"], frame["accc"], frame["oric"]
        first = frame["first_frame"]
        c = j2dc[..., 2].mean(-1)
        vis, full = c > lo, c >= hi
        Rcr = oric[:, -1]
        k = torch.clamp((c - lo) * inv, 0.0, 1.0)
        accr = (accc[..., None] * Rcr[:, None]).sum(2)
        orir = _mm3(Rcr.transpose(-1, -2)[:, None], oric)
        out2, st2 = stack_step(params["rnn2"], _rows(accr, orir), st["rnn2"],
                               rnd)
        out3, st3 = stack_step(params["rnn3"], _rows(accr, orir, out2),
                               st["rnn3"], rnd)
        pc_first = carry["pc_first"]

        spec = heads_and_tail(params, carry, frame, st, c, Rcr, accr, orir,
                              out3, out2, pc_first, k)
        refeed = c <= lo
        if cfg["live"]:
            refeed = refeed & (spec["vision_count"]
                               == cfg["update_vision_freq"])
        j2_syn = spec["j_lm"] / spec["j_lm"][..., 2:]
        j3_syn = spec["joint"][:, 1:] - spec["joint"][:, :1]
        in4 = torch.where(refeed[:, None],
                          _rows(accc, oric, _bbox_normalize(j2_syn)),
                          _rows(accc, oric, _bbox_normalize(j2dc)))
        out4, st4 = stack_step(params["rnn4"], in4, st["rnn4"], rnd)
        out4 = torch.where(first[:, None], carry["out4_first"], out4)
        st4 = _where_state((vis & ~first) | refeed, st4, st["rnn4"])

        in6 = torch.where(refeed[:, None], _rows(accc, oric, j2_syn, j3_syn),
                          _rows(accc, oric, j2dc, out4))
        out6, st6 = stack_step(params["rnn6"], in6, st["rnn6"], rnd)
        st6 = _where_state(vis | refeed, st6, st["rnn6"])
        pc = torch.where(vis[:, None], out6, pc_first)

        j3dr_v = (out4.reshape(-1, 23, 3)[..., None]
                  * Rcr[:, None]).sum(2).reshape(-1, 69)
        j3dr = torch.where(full[:, None], j3dr_v, torch.where(
            vis[:, None], _lerp(out2, j3dr_v, k[:, None]), out2))
        T = heads_and_tail(params, carry, frame, st, c, Rcr, accr, orir,
                           out3, j3dr, pc, k)

        first_reach = carry["first_reach"]
        if cfg["use_imu_updater"]:
            st2 = _where_state(full & first_reach,
                               _init_net(params["rnn2"], j3dr), st2)
            first_reach = first_reach & ~full
        ones = torch.ones_like(first_reach)
        new = {"states": {"rnn2": st2, "rnn3": st3, "rnn4": st4,
                          "rnn6": st6, "rnn7": T["st7"], "rnn8": T["st8"]},
               "last_pfoot": T["pfoot"], "has_pfoot": ones,
               "last_tran": T["tran"], "has_tran": ones,
               "floor_buf": T["floor_buf"], "floor_cnt": T["floor_cnt"],
               "first_reach": first_reach,
               "vision_count": T["vision_count"], "j_temp": T["j_temp"],
               "pc_first": pc_first, "out4_first": carry["out4_first"]}
        return new, (T["pose"], T["tran"])

    return step


def _pairs(dst, src):
    r"""``(dst leaf, src leaf)`` of two carries, matched by key."""
    if isinstance(dst, dict):
        for k in dst:
            yield from _pairs(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            yield from _pairs(d, s)
    else:
        yield dst, src


def _graphed(step, params, carry, frame):
    r"""``step`` captured once into a CUDA graph over static buffers: the
    carry's, which the graph updates in place, and a frame's, which the
    caller fills before each replay. Returns ``(replay, frame buffers,
    (pose, tran) buffers)``."""
    carry = {k: v for k, v in carry.items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(params, carry, frame)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        new, out = step(params, carry, frame)
        for dst, src in _pairs(carry, new):
            if src is not dst:
                dst.copy_(src)
    return graph.replay, frame, out


def run(params, consts, cfg, frames, tf32: bool = False):
    r"""Rows through the prescan and the steady step: ``frames`` a dict of
    ``[B, T, ...]`` tensors on one device (``j2dc``, ``accc``, ``oric``,
    ``first_tran``, ``gravityc``; ``first_frame`` and ``first_tran_valid``
    bool). Returns ``(pose [B, T, 24, 3, 3], tran [B, T, 3])`` in float32.
    ``tf32`` runs every product in TF32 instead (a control). On the card
    one step is captured into a CUDA graph and replayed frame after frame
    (the same operations, without the host launching each). The
    arithmetic follows the type the weights are stored in (see the
    module's docstring)."""
    matmul = torch.backends.cuda.matmul
    keep = (matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        stored = params["rnn2"]["linear1"]["w"].dtype
        rnd = _bf if stored == torch.bfloat16 else None
        first = _cast(params, stored)
        params = _cast(params, torch.float32)
        B, T = frames["j2dc"].shape[:2]
        dev = frames["j2dc"].device
        step = make_step(consts, cfg, rnd)
        pose = torch.empty((B, T, 24, 3, 3), device=dev)
        tran = torch.empty((B, T, 3), device=dev)
        with torch.no_grad():
            carry = prescan(first, init_carry(params, B, dev),
                            {k: v[:, 0] for k, v in frames.items()})
            frame = {k: v[:, 0].clone() for k, v in frames.items()}
            if dev.type == "cuda":
                replay, frame, out = _graphed(step, params, carry, frame)
                for t in range(T):
                    for k, v in frame.items():
                        v.copy_(frames[k][:, t])
                    replay()
                    pose[:, t].copy_(out[0])
                    tran[:, t].copy_(out[1])
            else:
                for t in range(T):
                    frame = {k: v[:, t] for k, v in frames.items()}
                    carry, (pose[:, t], tran[:, t]) = step(params, carry,
                                                           frame)
        return pose, tran
    finally:
        matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = keep

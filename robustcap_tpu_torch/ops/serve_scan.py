r"""The whole-chunk serving kernel: the branchless steady SigMP step over a
chunk of frames in one launch.

:func:`serve_scan` takes the place of the JAX package's
``ops/pallas_serve.py::serve_scan``. It runs every frame of a chunk through
rnn2, rnn3 and the speculative rnn7/rnn8 heads, the speculative tail, the
occluded-frame refeed of rnn4/rnn6, the confidence gate, the final heads and
tail, the one-shot IMU-updater rewrite and the live throttle, with the
semantics of ``make_step(include_first_frame_step=False,
cond_updater=False)``. On a CUDA tensor it is one launch of the hand-written
kernel ``csrc/serve_scan.cu``; on a CPU tensor it runs the plain version,
:func:`serve_scan_plain`, a frame loop of that step. There is no other
fallback: on any other device, or when the kernel cannot launch, it raises.

The kernel takes the weights in one of three modes, as the JAX kernel does
(:func:`prepare_serve_params`): float32; bfloat16 rows, each activation
rounded to bf16 before a product and every sum, gate and state kept in
float32; and int8 gate matrices with per-row scales under
``cfg.int8_compute``, whose activations are quantized per row as the XLA
``int8_compute`` step does, with linear1/linear2 in bf16.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..math.spatial import mat3_mul
from ..nn.rnn import (_dot_i8, _is_qtensor, dequantize_params,
                      dequantize_tensor, quantize_activation,
                      quantize_tensor)
from . import _build

__all__ = ["LAUNCHES", "MODES", "prepare_serve_params", "check_serve_cfg",
           "serve_scan_plain", "serve_scan"]

# kernel launches so far (one per chunk on CUDA tensors)
LAUNCHES = 0

# weight modes, in the order of the kernel's mode argument
MODES = ("f32", "bf16", "int8")

# stack order of the kernel's operands
_STACKS = ("rnn2", "rnn3", "rnn4", "rnn6", "rnn7", "rnn8")
_TAIL_F = 530   # f32 outputs of one tail evaluation (csrc/serve_scan.cu)
_SYN = 267      # synthetic keypoints: 99 + 99 + 69

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] * 3 + [ctypes.c_void_p]

_F32, _BF16, _I8 = torch.float32, torch.bfloat16, torch.int8


def _gate_record(w):
    r"""An int8 gate matrix and its per-row scales: the record as it is, or
    ``quantize_tensor`` of a dense matrix (what ``quantize_params``
    stores)."""
    return w if _is_qtensor(w) else quantize_tensor(w)


def prepare_serve_params(params, dtype=None, int8_gates=False):
    r"""The kernel's operands of one weight set, built once and reused
    across chunks, as the JAX ``prepare_serve_params`` builds them:

    * ``int8_gates``: int8 ``w_ih``/``w_hh`` with per-row f32 scales (a
      dense matrix is quantized here), linear1/linear2 in bf16 (int8
      records dequantized to bf16);
    * else ``dtype`` (``None``: the weights' own; a quantized tree is first
      dequantized to bf16): every weight matrix in that dtype, float32 or
      bfloat16;
    * in every mode float32 biases, the gate biases summed ``b_ih + b_hh``
      in the tree's dtype, and rnn2's ``init_net`` held in float32 (int8
      records dequantized to bf16 first).

    ``"params"`` holds the same tensors as a parameter tree for the plain
    version: the summed gate bias under ``b_ih`` and zeros under
    ``b_hh``. Raises ``ValueError`` for another dtype, for stacks that are
    not 2 layers deep, or unless rnn2/3/7/8 share one hidden size, as the
    JAX kernel requires."""
    if int8_gates:
        mode, dtype = "int8", _BF16
    else:
        params = dequantize_params(params)
        if dtype is None:
            dtype = params["rnn2"]["layers"][0]["w_ih"].dtype
        if dtype not in (_F32, _BF16):
            raise ValueError(f"serve kernel: no mode for {dtype} weights; it "
                             "takes float32, bfloat16 or int8 gates")
        mode = "f32" if dtype == _F32 else "bf16"

    def dense(w):
        w = dequantize_tensor(w, dtype) if _is_qtensor(w) else w.to(dtype)
        return w.contiguous()

    stacks, plain = {}, {}
    for name in _STACKS:
        p = params[name]
        if len(p["layers"]) != 2:
            raise ValueError("the serve kernel takes 2-layer stacks")
        w1, w2 = dense(p["linear1"]["w"]), dense(p["linear2"]["w"])
        s = {"w1": w1, "b1": p["linear1"]["b"].to(_F32).contiguous(),
             "bias": [(l["b_ih"] + l["b_hh"]).to(_F32).contiguous()
                      for l in p["layers"]],
             "w2": w2, "b2": p["linear2"]["b"].to(_F32).contiguous(),
             "in": int(w1.shape[1]), "out": int(w2.shape[0])}
        if mode == "int8":
            for k in ("w_ih", "w_hh"):
                recs = [_gate_record(l[k]) for l in p["layers"]]
                s[k] = [r["q"].contiguous() for r in recs]
                s[k + "_s"] = [r["scale"][:, 0].contiguous() for r in recs]
            gates = [{k: {"q": s[k][i], "scale": s[k + "_s"][i][:, None]}
                      for k in ("w_ih", "w_hh")} for i in range(2)]
        else:
            for k in ("w_ih", "w_hh"):
                s[k] = [dense(l[k]) for l in p["layers"]]
            gates = [{k: s[k][i] for k in ("w_ih", "w_hh")}
                     for i in range(2)]
        s["H"] = int(s["w_hh"][0].shape[1])
        stacks[name] = s
        plain[name] = {
            "linear1": {"w": w1, "b": s["b1"]},
            "layers": [dict(g, b_ih=b, b_hh=torch.zeros_like(b))
                       for g, b in zip(gates, s["bias"])],
            "linear2": {"w": w2, "b": s["b2"]},
        }
    H = {n: stacks[n]["H"] for n in _STACKS}
    if not H["rnn2"] == H["rnn3"] == H["rnn7"] == H["rnn8"]:
        raise ValueError("serve kernel packs rnn2/3/7/8 state jointly; "
                         "their hidden sizes must match")
    init = params["rnn2"].get("init_net")
    if init is not None:
        init = [((dequantize_tensor(l["w"], _BF16) if _is_qtensor(l["w"])
                  else l["w"]).to(_F32).contiguous(),
                 l["b"].to(_F32).contiguous()) for l in init]
        plain["rnn2"]["init_net"] = [{"w": w, "b": b} for w, b in init]
    return {"params": plain, "stacks": stacks, "init": init, "H": H,
            "mode": mode}


def check_serve_cfg(cfg):
    r"""Refuse what the serve path does not take: the reprojection
    refinement or a disabled vision updater (the JAX serve kernel refuses
    them too)."""
    if cfg.use_reproj_opt or not cfg.use_vision_updater:
        raise ValueError("pallas_serve supports the standard serving "
                         "configuration (vision updater on, no reproj)")


def _bf(t):
    r"""``t`` rounded to bfloat16, held in float32."""
    return t.to(_BF16).to(_F32)


def _plain_stack_step(mode):
    r"""One stack evaluation with the kernel's arithmetic in ``mode``, on a
    stack of ``prepare_serve_params(...)["params"]``: ``(params, x,
    (h, c)) -> (out, (h, c))``, all float32; ``None`` for f32, whose
    arithmetic is ``nn.rnn.rnn_step``'s (the step's default).

    * bf16: the activation side of every product rounded to bf16; sums,
      gates and state in float32.
    * int8: the rounding points of the JAX kernel's int8 cell
      (``pallas_serve.py`` ``cells``, ``lin1``, ``head_out``): x and h cast
      to bf16 and quantized per row, int32 sums, the rescale in float32 and
      bf16 ``zx``, ``zh`` and their sum with the bias; transcendentals in
      float32 rounded to bf16; the cell update in bf16; linear1 and linear2
      with bf16 bias adds."""
    if mode == "f32":
        return None

    def dense_out(lin, x):
        z = _bf(x) @ lin["w"].to(_F32).T
        return _bf(_bf(z) + _bf(lin["b"])) if mode == "int8" else z + lin["b"]

    def int8_cell(layer, x, h, c):
        def gate_half(v, rec):
            q, s = quantize_activation(_bf(v))
            return _bf(_dot_i8(q, rec["q"]).to(_F32) * s * rec["scale"][:, 0])
        z = _bf(_bf(gate_half(x, layer["w_ih"]) + gate_half(h, layer["w_hh"]))
                + _bf(layer["b_ih"]))
        i, f, g, o = z.chunk(4, dim=-1)
        i, f, o = (_bf(torch.sigmoid(v)) for v in (i, f, o))
        g = _bf(torch.tanh(g))
        c_new = _bf(_bf(f * _bf(c)) + _bf(i * g))
        h_new = _bf(o * _bf(torch.tanh(c_new)))
        return h_new, c_new

    def bf16_cell(layer, x, h, c):
        z = _bf(x) @ layer["w_ih"].to(_F32).T \
            + _bf(h) @ layer["w_hh"].to(_F32).T \
            + (layer["b_ih"] + layer["b_hh"])
        i, f, g, o = z.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, c_new

    run_cell = int8_cell if mode == "int8" else bf16_cell

    def step(params, x, state):
        h, c = state
        inp = torch.relu(dense_out(params["linear1"], x))
        new_h, new_c = [], []
        for l, layer in enumerate(params["layers"]):
            inp, cn = run_cell(layer, inp, h[l], c[l])
            new_h.append(inp)
            new_c.append(cn)
        return (dense_out(params["linear2"], inp),
                (torch.stack(new_h), torch.stack(new_c)))

    return step


def serve_scan_plain(prepped, consts, cfg, frames, carry):
    r"""The plain PyTorch version: frame after frame through the branchless
    steady step (``make_step(include_first_frame_step=False,
    cond_updater=False, fuse_spec_heads=False, output_contacts=True)``) with
    the plain tail, every stack evaluated with the kernel's arithmetic in
    the prepared mode. Returns ``(pose [T,24,3,3], tran [T,3],
    contact [T,2], new_carry)``."""
    from ..models import sig_mp   # sig_mp imports this module
    cfg = dataclasses.replace(cfg, pallas_tail=False, pallas_inertial=False,
                              pallas_serve=False)
    step = sig_mp.step_from_constants(
        consts, cfg, include_first_frame_step=False, output_contacts=True,
        fuse_spec_heads=False, cond_updater=False,
        stack_step=_plain_stack_step(prepped["mode"]))
    outs = []
    for t in range(len(frames["conf"])):
        carry, out = step(prepped["params"], carry,
                          sig_mp._frame_at(frames, t))
        outs.append(out)
    pose, tran, contact = (torch.stack(x) for x in zip(*outs))
    return pose, tran, contact, carry


def _lib():
    lib = _build.load("serve_scan")
    fn = lib.serve_scan_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _frame_operands(cfg, frames):
    r"""Per-frame kernel inputs of a chunk, as the step computes them frame
    by frame: the IMU in the root frame (rnn2's input) and in the camera
    frame, bbox-normalised and raw keypoints, the root orientation, the
    confidence and its lerp weight, the first-frame flags, first_tran and
    gravity."""
    from ..models.sig_mp import _bbox_center_normalize
    dev = frames["j2dc"].device
    f32, i32 = torch.float32, torch.int32
    j2dc, accc, oric = frames["j2dc"], frames["accc"], frames["oric"]
    T = j2dc.shape[0]
    Rcr = oric[:, -1]
    accr = (accc[:, :, :, None] * Rcr[:, None]).sum(2)
    orir = mat3_mul(Rcr.transpose(-1, -2)[:, None], oric)
    conf_lo, conf_hi = cfg.conf_range
    c = frames["c"]
    return {
        "in2": torch.cat([accr.reshape(T, 18), orir.reshape(T, 54)], 1),
        "raw72": torch.cat([accc.reshape(T, 18), oric.reshape(T, 54)], 1),
        "j2n": _bbox_center_normalize(j2dc).reshape(T, 99),
        "j2r": j2dc.reshape(T, 99),
        "rcr": Rcr.reshape(T, 9),
        "c": c,
        "k_lerp": torch.clamp((c - conf_lo) * (1.0 / (conf_hi - conf_lo)),
                              0.0, 1.0),
        "ff": torch.as_tensor(np.asarray(frames["first_frame"]), dtype=i32
                              ).to(dev),
        "ftv": torch.as_tensor(np.asarray(frames["first_tran_valid"]),
                               dtype=i32).to(dev),
        "first_tran": frames["first_tran"].to(f32),
        "grav": frames["gravityc"].to(f32),
    }


def _launch(prepped, consts, cfg, frames, carry):
    global LAUNCHES
    dev = frames["j2dc"].device
    f32, i32 = torch.float32, torch.int32
    T = int(frames["j2dc"].shape[0])
    if T < 1:
        raise ValueError("serve_scan needs at least one frame")
    keep = []   # every tensor whose pointer the kernel gets

    def ptr(t, dtype=f32, shape=None):
        if t is None:
            return 0
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"serve kernel operand: expected {dtype} on "
                             f"{dev}, got {t.dtype} on {t.device}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"serve kernel operand: expected shape "
                             f"{tuple(shape)}, got {tuple(t.shape)}")
        t = t.contiguous()
        keep.append(t)
        return t.data_ptr()

    mode = prepped["mode"]
    dense_t = _F32 if mode == "f32" else _BF16
    gate_t = {"f32": _F32, "bf16": _BF16, "int8": _I8}[mode]
    ptrs, ints = [], [MODES.index(mode)]
    states, work = carry["states"], {}
    for name in _STACKS:
        s = prepped["stacks"][name]
        H, n_out = s["H"], s["out"]
        h0, c0 = states[name]
        hs = torch.zeros((2, 2, H), dtype=f32, device=dev)  # layer, slot
        hs[:, 0] = h0
        cs = c0.to(f32).clone().contiguous()
        work[name] = (hs, cs)
        ptrs += [ptr(s["w1"], dense_t, (H, s["in"])),
                 ptr(s["b1"], shape=(H,))]
        for l in range(2):
            ptrs += [ptr(s["w_ih"][l], gate_t, (4 * H, H)),
                     ptr(s["w_hh"][l], gate_t, (4 * H, H)),
                     ptr(s["bias"][l], shape=(4 * H,))]
            ptrs += ([ptr(s["w_ih_s"][l], shape=(4 * H,)),
                      ptr(s["w_hh_s"][l], shape=(4 * H,))]
                     if mode == "int8" else [0, 0])
        ptrs += [ptr(s["w2"], dense_t, (n_out, H)),
                 ptr(s["b2"], shape=(n_out,)),
                 ptr(hs), ptr(cs, shape=(2, H)),
                 ptr(torch.empty(H, dtype=f32, device=dev)),
                 ptr(torch.empty((2, H), dtype=f32, device=dev)),
                 ptr(torch.zeros(n_out, dtype=f32, device=dev))]
        ints += [s["in"], H, n_out]

    fo = _frame_operands(cfg, frames)
    for key, width in (("in2", 72), ("raw72", 72), ("j2n", 99), ("j2r", 99),
                       ("rcr", 9)):
        ptrs.append(ptr(fo[key], shape=(T, width)))
    ptrs += [ptr(fo["c"], shape=(T,)), ptr(fo["k_lerp"], shape=(T,)),
             ptr(fo["ff"], i32, (T,)), ptr(fo["ftv"], i32, (T,)),
             ptr(fo["first_tran"], shape=(T, 3)),
             ptr(fo["grav"], shape=(T, 3))]

    last_pfoot = carry["last_pfoot"].to(f32).clone()
    has = torch.stack([carry["has_pfoot"], carry["has_tran"]]).to(
        torch.uint8)
    last_tran = carry["last_tran"].to(f32).clone()
    floor_buf = carry["floor_buf"].to(f32).clone()
    flags = torch.stack([carry["floor_cnt"].to(i32),
                         carry["vision_count"].to(i32),
                         carry["first_reach"].to(i32),
                         torch.zeros((), dtype=i32, device=dev)])
    j_temp = carry["j_temp"].to(f32).clone()
    ptrs += [ptr(last_pfoot, shape=(2, 3)), ptr(has, torch.uint8, (2,)),
             ptr(last_tran, shape=(3,)), ptr(floor_buf, shape=(11, 3)),
             ptr(flags, i32, (4,)), ptr(j_temp, shape=(33, 3)),
             ptr(carry["pc_first"], shape=(3,)),
             ptr(carry["out4_first"], shape=(prepped["stacks"]["rnn4"]["out"],
                                              ))]

    blendshape = bool(consts["blendshape"])
    ptrs += [ptr(consts["parent"], i32, (24,)),
             ptr(consts["bone"], shape=(24, 3)),
             ptr(consts["j0"], shape=(24, 3)),
             ptr(consts["wsub"], shape=(33, 24)),
             ptr(consts["v0sub"], shape=(33, 3)),
             ptr(consts["pd"] if blendshape else None, shape=(3, 207, 33))]

    use_imu = bool(cfg.use_imu_updater)
    init_n = [0, 0, 0]
    if use_imu:
        if prepped["init"] is None:
            raise ValueError("cfg.use_imu_updater needs rnn2's init_net")
        m = prepped["stacks"]["rnn2"]["out"]
        for i, (w, b) in enumerate(prepped["init"]):
            init_n[i] = int(w.shape[0])
            ptrs += [ptr(w, shape=(init_n[i], m)), ptr(b, shape=(init_n[i],))]
            m = init_n[i]
        if init_n[2] != 4 * prepped["H"]["rnn2"]:
            raise ValueError("rnn2's init_net must give (h, c) of both "
                             "layers")
    else:
        ptrs += [0] * 6

    pose = torch.empty((T, 24, 3, 3), dtype=f32, device=dev)
    tran = torch.empty((T, 3), dtype=f32, device=dev)
    contact = torch.empty((T, 2), dtype=f32, device=dev)
    tail_f = torch.empty((2, _TAIL_F), dtype=f32, device=dev)
    tail_i = torch.zeros((2, 2), dtype=i32, device=dev)
    ptrs += [ptr(tail_f[0]), ptr(tail_f[1]), ptr(tail_i[0], i32),
             ptr(tail_i[1], i32),
             ptr(torch.empty(_SYN, dtype=f32, device=dev)),
             ptr(torch.empty(max(1, init_n[0] + init_n[1]), dtype=f32,
                             device=dev)),
             ptr(pose), ptr(tran), ptr(contact)]
    ints += [T, int(use_imu), int(cfg.live), int(cfg.update_vision_freq),
             int(cfg.use_flat_floor), int(blendshape), *init_n]
    conf_lo, conf_hi = cfg.conf_range
    flts = [conf_lo, conf_hi, cfg.contact_threshold, cfg.distance_threshold,
            cfg.tran_filter_num, cfg.height_threshold]

    p_arr = np.asarray(ptrs, dtype=np.int64)
    i_arr = np.asarray(ints, dtype=np.int32)
    f_arr = np.asarray(flts, dtype=np.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(p_arr.ctypes.data, len(p_arr), i_arr.ctypes.data,
                 len(i_arr), f_arr.ctypes.data, len(f_arr), stream)
    if err != 0:
        raise RuntimeError(f"serve_scan kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1

    slot = T % 2
    new_carry = dict(carry)
    new_carry.update({
        "states": {n: (work[n][0][:, slot].contiguous(), work[n][1])
                   for n in _STACKS},
        "last_pfoot": last_pfoot, "has_pfoot": has[0].bool(),
        "last_tran": last_tran, "has_tran": has[1].bool(),
        "floor_buf": floor_buf, "floor_cnt": flags[0],
        "vision_count": flags[1], "first_reach": flags[2].bool(),
        "j_temp": j_temp,
    })
    return pose, tran, contact, new_carry


def serve_scan(prepped, consts, cfg, frames, carry):
    r"""Run a chunk through the serving step: one kernel launch on CUDA
    tensors, the plain version on CPU tensors.

    ``prepped`` from :func:`prepare_serve_params`; ``consts`` the tail
    constants (``ops.geometry_tail.tail_constants``); ``frames`` as from
    ``models.sig_mp._sequence_frames`` (the kernel reads the confidence
    ``c`` computed there and compares it in float32); ``carry`` the steady
    carry after ``prescan_first_frame``. Returns ``(pose [T,24,3,3],
    tran [T,3], contact [T,2], new_carry)``."""
    check_serve_cfg(cfg)
    dev = frames["j2dc"].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no serve path for device {dev}")
    if bool(cfg.int8_compute) != (prepped["mode"] == "int8"):
        raise ValueError("cfg.int8_compute requires int8_gates prepped "
                         "params (and vice versa)")
    if dev.type == "cpu":
        return serve_scan_plain(prepped, consts, cfg, frames, carry)
    return _launch(prepped, consts, cfg, frames, carry)

r"""SigMP: the six-LSTM camera+IMU fusion network, one frame at a time.

Port of ``robustcap_tpu/models/sig_mp.py``. The per-frame computation is a
function ``step(params, carry, frame) -> (carry, (pose [24,3,3], tran [3]))``
with the JAX package's carry and frame layouts, and ``forward_offline`` and
``StreamingNet`` drive it over a sequence or a stream. PyTorch runs eagerly,
so a scan is a Python loop over frames. ``forward_offline_batched`` and the
batched evaluation (``eval.runner.run_sequences``) run B sequences at once
through :func:`make_batched_step`, the branchless steady step over a
leading batch axis (see the last point below).

What differs from the JAX step, with the same values:

* The frame's keypoint confidence ``c`` is computed once on the host when a
  frame or sequence is built, and uploaded with it. Every branch on the
  confidence is then a Python branch on that host copy (``frame["conf"]``),
  compared in float32 as the device would, so the step never waits for the
  device to decide a branch. In particular ``cond_updater=True`` evaluates
  heads and tail once per frame, the way ``lax.cond`` does on one stream.
* ``first_frame`` and ``first_tran_valid`` are host booleans for the same
  reason. Carried flags (``has_pfoot``, ``first_reach``, ``vision_count``,
  the floor ring) stay tensors on the device, and branches on them are
  ``torch.where`` selects, as in the JAX step.
* The batched step is the exception: it computes ``c`` on the device, and
  every per-row decision (the confidence bands, the refeed, the first-frame
  and first-translation flags, given as ``[B]`` bool tensors) is a
  ``torch.where``, as ``jax.vmap`` makes of the JAX step, so a batched scan
  never waits for the device.

Network bank — all 2-layer LSTMs, torch-layout params:

  name | input                          | out   | hidden
  rnn2 | 72 imu (root frame)            | 23x3  | 512   (+ init-state MLP)
  rnn3 | 72 + 69 joints                 | 3 vel | 512
  rnn4 | 72 (cam) + 33x3 kp             | 23x3  | 1280
  rnn6 | 72 + 99 + 69                   | 3 pos | 1024
  rnn7 | 72 + 69                        | 24x6  | 512
  rnn8 | 72 + 69                        | 2     | 512

``cfg.pallas_tail`` runs the geometry tail through its CUDA kernel
(``ops/geometry_tail.py``, the operator ``robustcap::geometry_tail``) in the
per-frame and the batched step (``forward_offline_batched`` turns it off,
as the JAX one does), ``cfg.pallas_inertial`` the rnn2/rnn3 chunk
pre-scan through the LSTM-scan kernel (``ops/lstm_scan.py``), and
``cfg.pallas_serve`` the whole steady step of ``forward_offline`` and
``StreamingNet.forward_chunk`` through the serve kernel
(``ops/serve_scan.py``, one launch per chunk); the flag names are the JAX
package's. The weights may be float32, bfloat16 or int8 records
(``nn/rnn.py``); ``cfg.int8_compute`` runs the gate products of int8
records on int8 activations, and with ``pallas_serve`` picks the serve
kernel's int8-gate mode.
"""

from __future__ import annotations

import dataclasses
import weakref
from functools import partial
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import trace
from ..config import SigMPConfig
from ..device import resolve_device, tree_map
from ..math.general import lerp
from ..math.spatial import mat3_mul
from ..nn.rnn import (init_net_apply, init_rnn_params, init_state,
                      prepare_scan_params, rnn_step)
from ..ops.geometry_tail import (geometry_tail, geometry_tail_batched,
                                 sync_mp3d, tail_batched, tail_constants,
                                 tail_plain)
from ..ops.lstm_cell import rnn_step_cells
from ..ops.lstm_scan import prepare_lstm_scan, rnn_scan_chunked
from ..ops.serve_scan import check_serve_cfg, serve_params_for, serve_scan

__all__ = [
    "RNN_SPECS", "DEFAULT_GRAVITY", "init_params", "init_carry", "make_frame",
    "make_step", "step_from_constants", "make_batched_step",
    "prescan_first_frame", "forward_offline", "forward_offline_batched",
    "StreamingNet", "get_bbox_scale", "sync_mp3d",
]

# (input_size, output_size, hidden_size, dropout, with_init_net)
RNN_SPECS = {
    "rnn2": (72, 69, 512, 0.4, True),
    "rnn3": (141, 3, 512, 0.4, False),
    "rnn4": (171, 69, 1280, 0.4, False),
    "rnn6": (240, 3, 1024, 0.4, False),
    "rnn7": (141, 144, 512, 0.1, False),
    "rnn8": (141, 2, 512, 0.4, False),
}

DEFAULT_GRAVITY = np.array([-0.0029, 0.9980, -0.0273], np.float32)

# frame fields that live on the host (see the module docstring)
_HOST_KEYS = ("conf", "first_frame", "first_tran_valid")


def _check_cfg(cfg: SigMPConfig):
    if cfg.pallas_serve:
        check_serve_cfg(cfg)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(generator: torch.Generator, specs=None,
                device="cuda") -> Dict:
    r"""Random parameters drawn on the CPU from ``generator`` and moved to
    ``device``. ``specs`` overrides the layout (tests use small widths)."""
    dev = resolve_device(device)
    specs = RNN_SPECS if specs is None else specs
    params = {name: init_rnn_params(generator, i, o, h, 2, with_init)
              for name, (i, o, h, _, with_init) in specs.items()}
    return tree_map(lambda t: t.to(dev), params)


# ---------------------------------------------------------------------------
# Small helpers
# ---------------------------------------------------------------------------


def get_bbox_scale(uv: torch.Tensor) -> torch.Tensor:
    r"""max(bbox width, bbox height) over keypoint x/y."""
    du = uv[..., 0].amax(-1) - uv[..., 0].amin(-1)
    dv = uv[..., 1].amax(-1) - uv[..., 1].amin(-1)
    return torch.maximum(du, dv)


def _bbox_center_normalize(j2dc: torch.Tensor) -> torch.Tensor:
    r"""Divide keypoint x/y by the bbox scale, then root-center every row
    except row 23 around the (pre-centering) row 23; ``j2dc [..., 33, 3]``.
    The scale is guarded with 1e-6: the step also evaluates this on all-zero
    placeholder frames, and a NaN here would leak into carried state."""
    scale = torch.clamp_min(get_bbox_scale(j2dc), 1e-6)[..., None, None]
    xy = j2dc[..., :2] / scale
    xy_out = xy - xy[..., 23:24, :]
    xy_out[..., 23, :] = xy[..., 23, :]
    return torch.cat([xy_out, j2dc[..., 2:]], dim=-1)


def _cat(*xs):
    return torch.cat([x.reshape(-1) for x in xs])


def _bcat(*xs):
    r""":func:`_cat` row by row: ``[B, ...]`` pieces as one ``[B, K]``."""
    return torch.cat([x.reshape(x.shape[0], -1) for x in xs], -1)


def _state_where(cond, new, old):
    r"""``(h, c)`` states ``[L, B, H]``: ``new`` in the rows where
    ``cond [B]`` holds, else ``old``."""
    return tuple(torch.where(cond[:, None], n, o) for n, o in zip(new, old))


def _reproj_refine(cfg, j2dc, c, tran, j_lm):
    r"""Closed-form reprojection refinement (off by default): weighted
    least-squares delta for x/y then z, applied to (tran, j_lm). Takes one
    frame (``j2dc [33, 3]``, ``c []``) or a batch of them (a leading axis
    on every argument)."""
    p_conf = j2dc[..., 2]
    do_opt = (c > cfg.conf_range[0])[..., None]
    jx, jy, jz = j_lm[..., 0], j_lm[..., 1], j_lm[..., 2]
    axy = torch.sum(p_conf / jz ** 2, -1) + cfg.smooth
    bx = torch.sum(p_conf * (-jx / jz ** 2 + j2dc[..., 0] / jz), -1)
    by = torch.sum(p_conf * (-jy / jz ** 2 + j2dc[..., 1] / jz), -1)
    d_xy = torch.stack([bx / axy, by / axy, torch.zeros_like(bx)], -1)
    tran = torch.where(do_opt, tran + d_xy, tran)
    j_lm = torch.where(do_opt[..., None], j_lm + d_xy[..., None, :], j_lm)
    jx, jy, jz = j_lm[..., 0], j_lm[..., 1], j_lm[..., 2]
    az = torch.sum(p_conf * (jx ** 2 + jy ** 2) / jz ** 4, -1) + cfg.smooth
    bz = torch.sum(p_conf * ((jx / jz - j2dc[..., 0]) * jx / jz ** 2
                             + (jy / jz - j2dc[..., 1]) * jy / jz ** 2), -1)
    d_z = torch.stack([torch.zeros_like(bz), torch.zeros_like(bz), bz / az],
                      -1)
    tran = torch.where(do_opt, tran + d_z, tran)
    j_lm = torch.where(do_opt[..., None], j_lm + d_z[..., None, :], j_lm)
    return tran, j_lm


def _select(cond, new, old):
    r"""``new`` where ``cond`` else ``old``, leaf by leaf: a Python branch
    for a host bool, ``torch.where`` for a device bool."""
    if isinstance(cond, bool):
        return new if cond else old
    if isinstance(new, (list, tuple)):
        return type(new)(_select(cond, a, b) for a, b in zip(new, old))
    return torch.where(cond, new, old)


def _any(a, b):
    r"""``a | b`` for host or device bools, staying on the host when it
    can."""
    if a is True or b is True:
        return True
    if a is False:
        return b
    if b is False:
        return a
    return a | b


# ---------------------------------------------------------------------------
# Carry and frames
# ---------------------------------------------------------------------------


def _param_device(params) -> torch.device:
    return params["rnn2"]["linear1"]["b"].device


def init_carry(params, dtype=torch.float32, batch_shape=()) -> Dict:
    r"""Fresh streaming state on the parameters' device; ``batch_shape``
    ``(B,)`` gives every field a leading ``B`` (the states ``[L, B, H]``)."""
    dev = _param_device(params)
    batch_shape = tuple(batch_shape)

    def zeros(*shape, dt=dtype):
        return torch.zeros(batch_shape + shape, dtype=dt, device=dev)

    return {
        "states": {name: init_state(params[name], batch_shape, dtype)
                   for name in RNN_SPECS},
        "last_pfoot": zeros(2, 3),
        "has_pfoot": zeros(dt=torch.bool),
        "last_tran": zeros(3),
        "has_tran": zeros(dt=torch.bool),
        "floor_buf": zeros(11, 3),
        "floor_cnt": zeros(dt=torch.int32),
        "first_reach": torch.ones(batch_shape, dtype=torch.bool, device=dev),
        "vision_count": zeros(dt=torch.int32),
        "j_temp": zeros(33, 3),
        # first-frame rnn6 output and rnn4 output, stashed by the prescan
        "pc_first": zeros(3),
        "out4_first": zeros(69),
    }


def _as_f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _sequence_frames(j2dc, accc, oric, first_tran, first_frame, gravityc,
                     device):
    r"""Stacked per-frame inputs on ``device`` (tensors ``[T, ...]``) plus
    their host fields. ``first_tran``/``first_frame`` apply to frame 0
    only. The confidence ``c`` is the mean keypoint confidence, computed
    once on the host in float32 and uploaded."""
    j2dc = _as_f32(j2dc)
    T = j2dc.shape[0]
    j2dc = j2dc.reshape(T, 33, 3)
    conf = j2dc[:, :, 2].detach().cpu().mean(-1)
    if gravityc is None:
        gravityc = torch.as_tensor(DEFAULT_GRAVITY)
    first = np.arange(T) == 0
    frames = {
        "j2dc": j2dc.to(device),
        "accc": _as_f32(accc).reshape(T, 6, 3).to(device),
        "oric": _as_f32(oric).reshape(T, 6, 3, 3).to(device),
        "first_tran": (torch.zeros(3) if first_tran is None
                       else _as_f32(first_tran).reshape(3)
                       ).to(device).expand(T, 3),
        "gravityc": _as_f32(gravityc).reshape(-1, 3).to(device).expand(T, 3),
        "c": conf.to(device),
        "conf": conf.numpy(),
        "first_tran_valid": first & (first_tran is not None),
        "first_frame": first & bool(first_frame),
    }
    return frames


def _frame_at(frames, t):
    r"""Frame ``t`` of :func:`_sequence_frames` output: device views plus
    host scalars."""
    out = {k: v[t] for k, v in frames.items() if k not in _HOST_KEYS}
    out["conf"] = np.float32(frames["conf"][t])
    out["first_frame"] = bool(frames["first_frame"][t])
    out["first_tran_valid"] = bool(frames["first_tran_valid"][t])
    return out


def make_frame(j2dc, accc, oric, first_tran=None, first_frame=False,
               gravityc=None, device="cuda"):
    r"""One frame-input dict (``forward_online``'s arguments) on
    ``device``."""
    frames = _sequence_frames(
        _as_f32(j2dc).reshape(1, 33, 3), accc, oric, first_tran, first_frame,
        None if gravityc is None else _as_f32(gravityc).reshape(1, 3),
        resolve_device(device))
    return _frame_at(frames, 0)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def make_step(body_model, cfg: SigMPConfig,
              include_first_frame_step: bool = True,
              output_contacts: bool = False,
              precomputed_inertial: bool = False,
              fuse_spec_heads: bool = True,
              cond_updater: bool = False,
              output_r6d: bool = False):
    r"""Build ``step(params, carry, frame) -> (carry, (pose, tran))`` over
    the body model's constants, with the JAX package's semantics (see
    :func:`step_from_constants` for the options).
    """
    return step_from_constants(tail_constants(body_model), cfg,
                               include_first_frame_step, output_contacts,
                               precomputed_inertial, fuse_spec_heads,
                               cond_updater, output_r6d)


def step_from_constants(consts, cfg: SigMPConfig,
                        include_first_frame_step: bool = True,
                        output_contacts: bool = False,
                        precomputed_inertial: bool = False,
                        fuse_spec_heads: bool = True,
                        cond_updater: bool = False,
                        output_r6d: bool = False,
                        stack_step=None):
    r""":func:`make_step` over the tail constants of a body model
    (``ops.geometry_tail.tail_constants``).

    ``include_first_frame_step=True`` is the streaming variant with the
    reference's literal structure (two rnn4/rnn6 evaluations when the
    vision updater fires). ``False`` is the steady variant, which needs a
    carry seeded by :func:`prescan_first_frame` and evaluates rnn4/rnn6 once
    per frame. ``cond_updater`` (steady variant with the vision updater)
    evaluates heads and tail once per frame, on the branch the frame's
    confidence picks; without it the steady step runs a speculative tail on
    the inertial joints and the final tail, as the JAX branchless form
    does. ``fuse_spec_heads`` (steady variant) evaluates rnn3 and the
    speculative rnn7/rnn8 heads as one group, as the JAX step does; the port
    runs the group's stacks one after another, so the values are the same
    either way. ``precomputed_inertial`` reads rnn2/rnn3 outputs from
    ``frame["out2"]``/``frame["out3"]`` (the chunk pre-scan).
    ``output_contacts`` appends the contact probabilities ``[2]`` to the
    outputs, and ``output_r6d`` after them the raw rnn7 head ``[144]``
    before Gram-Schmidt (a diagnostic tap that changes no other value).
    ``stack_step(params, x, (h, c)) -> (out, (h, c))`` evaluates one stack;
    the default is ``nn.rnn.rnn_step`` with ``cfg.int8_compute`` (the serve
    kernel's plain version passes one with the kernel's arithmetic)."""
    _check_cfg(cfg)
    if stack_step is None:
        stack_step = partial(rnn_step, int8_compute=cfg.int8_compute)
    dev = consts["parent"].device
    tail = geometry_tail if cfg.pallas_tail else tail_plain
    conf_lo, conf_hi = cfg.conf_range
    lo32, hi32 = np.float32(conf_lo), np.float32(conf_hi)
    inv_range = 1.0 / (conf_hi - conf_lo)
    false_t = torch.zeros((), dtype=torch.bool, device=dev)
    true_t = torch.ones((), dtype=torch.bool, device=dev)

    def heads_and_tail(params, carry, frame, st, c, Rcr, accr, orir, vr,
                       j3dr, pc, k_lerp, heads_pre=None):
        r"""rnn7/rnn8 heads + the pose/translation/floor/landmark tail. Reads
        ``carry``, never writes it. ``heads_pre`` supplies already-evaluated
        ``(out7, out8, st7_new, st8_new)`` on the same input."""
        if heads_pre is None:
            x = _cat(accr, orir, j3dr)
            out7, st7_new = stack_step(params["rnn7"], x, st["rnn7"])
            out8, st8_new = stack_step(params["rnn8"], x, st["rnn8"])
        else:
            out7, out8, st7_new, st8_new = heads_pre
        T = tail(consts, cfg, out7, out8, carry, frame, c, Rcr, vr, pc,
                 k_lerp)
        if cfg.use_reproj_opt:
            T["tran"], T["j_lm"] = _reproj_refine(cfg, frame["j2dc"], c,
                                                  T["tran"], T["j_lm"])
        return dict(T, st7_new=st7_new, st8_new=st8_new, out7=out7)

    def gate(conf, j3dr_i, j3dr_v, k_lerp):
        # confidence-gated lerp of inertial and visual joints
        if conf >= hi32:
            return j3dr_v.reshape(-1)
        if conf > lo32:
            return lerp(j3dr_i.reshape(-1), j3dr_v.reshape(-1), k_lerp)
        return j3dr_i.reshape(-1)

    def refeed_inputs(accc, oric, T):
        # synthetic keypoints from the tail's landmarks for the refeed
        j2dc_syn = T["j_lm"] / T["j_lm"][:, 2:]
        j3dc_syn = T["joint"][1:] - T["joint"][:1]
        syn4_in = _cat(accc, oric, _bbox_center_normalize(j2dc_syn))
        syn6_in = _cat(accc, oric, j2dc_syn, j3dc_syn)
        return syn4_in, syn6_in

    def step(params, carry, frame):
        st = carry["states"]
        j2dc, accc, oric = frame["j2dc"], frame["accc"], frame["oric"]
        first_frame = frame["first_frame"]
        c, conf = frame["c"], frame["conf"]
        conf_vis = bool(conf > lo32)
        conf_full = bool(conf >= hi32)

        Rcr = oric[-1]
        k_lerp = torch.clamp((c - conf_lo) * inv_range, 0.0, 1.0)

        # -- inertial branch: rotate into the root frame
        accr = (accc[:, :, None] * Rcr[None]).sum(1)
        orir = mat3_mul(Rcr.T[None], oric)
        spec_heads = None
        if precomputed_inertial:
            out2, st2_new = frame["out2"], st["rnn2"]
            out3, st3_new = frame["out3"], st["rnn3"]
        else:
            out2, st2_new = stack_step(params["rnn2"], _cat(accr, orir),
                                       st["rnn2"])
            in3 = _cat(accr, orir, out2)
            out3, st3_new = stack_step(params["rnn3"], in3, st["rnn3"])
            if (fuse_spec_heads and not include_first_frame_step
                    and cfg.use_vision_updater):
                out7_s, st7_s = stack_step(params["rnn7"], in3, st["rnn7"])
                out8_s, st8_s = stack_step(params["rnn8"], in3, st["rnn8"])
                spec_heads = (out7_s, out8_s, st7_s, st8_s)
        j3dr_i = out2
        vr = out3

        j2dc_norm = _bbox_center_normalize(j2dc)

        if include_first_frame_step:
            # ---- streaming variant: the reference's literal structure ----
            out4, st4_new = stack_step(
                params["rnn4"], _cat(accc, oric, j2dc_norm), st["rnn4"])
            st4_mid = _select(conf_vis or first_frame, st4_new, st["rnn4"])
            j3dr_v = (out4.reshape(23, 3)[:, :, None] * Rcr[None]).sum(1)

            # rnn6 can step twice on a first frame
            in6 = _cat(accc, oric, j2dc, out4)
            out6_a, st6_a = stack_step(params["rnn6"], in6, st["rnn6"])
            st6_mid = _select(first_frame, st6_a, st["rnn6"])
            pc_first = out6_a.reshape(3)
            out6_b, st6_b = stack_step(params["rnn6"], in6, st6_mid)
            st6_after = _select(conf_vis, st6_b, st6_mid)
            pc = out6_b.reshape(3) if conf_vis else pc_first

            j3dr = gate(conf, j3dr_i, j3dr_v, k_lerp)
            T = heads_and_tail(params, carry, frame, st, c, Rcr, accr, orir,
                               vr, j3dr, pc, k_lerp)

            # -- occluded-frame refeed of rnn6/rnn4 with synthetic keypoints
            st6_final, st4_final = st6_after, st4_mid
            if cfg.use_vision_updater and conf <= lo32:
                vu_cond = True
                if cfg.live:
                    vu_cond = T["vision_count"] == cfg.update_vision_freq
                syn4_in, syn6_in = refeed_inputs(accc, oric, T)
                _, st6_syn = stack_step(params["rnn6"], syn6_in, st6_after)
                st6_final = _select(vu_cond, st6_syn, st6_after)
                _, st4_syn = stack_step(params["rnn4"], syn4_in, st4_mid)
                st4_final = _select(vu_cond, st4_syn, st4_mid)
            out4_first = carry["out4_first"]
        else:
            # ---- steady variant (post-prescan): single rnn4/rnn6 evals ----
            pc_first = carry["pc_first"]
            if cfg.use_vision_updater and cond_updater:
                # one tail per frame, on the branch the confidence picks:
                # occluded -> tail on the inertial joints (the speculative
                # values), then the synthetic refeed; visible -> real
                # rnn4/rnn6, then tail on the gated joints
                if not conf_vis:
                    T = heads_and_tail(params, carry, frame, st, c, Rcr,
                                       accr, orir, vr, j3dr_i.reshape(-1),
                                       pc_first, k_lerp,
                                       heads_pre=spec_heads)
                    # live throttle: the refeed counts only on frames where
                    # the mesh was just recomputed
                    refeed = (T["vision_count"] == cfg.update_vision_freq
                              if cfg.live else True)
                    syn4_in, syn6_in = refeed_inputs(accc, oric, T)
                    _, st4_syn = stack_step(params["rnn4"], syn4_in,
                                            st["rnn4"])
                    _, st6_syn = stack_step(params["rnn6"], syn6_in,
                                            st["rnn6"])
                    st4_final = _select(refeed, st4_syn, st["rnn4"])
                    st6_final = _select(refeed, st6_syn, st["rnn6"])
                    j3dr = j3dr_i.reshape(-1)
                else:
                    out4_eval, st4_eval = stack_step(
                        params["rnn4"], _cat(accc, oric, j2dc_norm),
                        st["rnn4"])
                    out4_eff = carry["out4_first"] if first_frame \
                        else out4_eval
                    j3dr_v = (out4_eff.reshape(23, 3)[:, :, None]
                              * Rcr[None]).sum(1)
                    out6_eval, st6_final = stack_step(
                        params["rnn6"], _cat(accc, oric, j2dc, out4_eff),
                        st["rnn6"])
                    j3dr = gate(conf, j3dr_i, j3dr_v, k_lerp)
                    T = heads_and_tail(params, carry, frame, st, c, Rcr,
                                       accr, orir, vr, j3dr,
                                       out6_eval.reshape(3), k_lerp)
                    st4_final = st["rnn4"] if first_frame else st4_eval
            else:
                # ---- branchless form: speculative tail + final tail ------
                if cfg.use_vision_updater:
                    # when occluded, the fused joints are the inertial ones
                    # and pc is pc_first, so the occluded tail is computable
                    # before rnn4/rnn6
                    T_spec = heads_and_tail(params, carry, frame, st, c,
                                            Rcr, accr, orir, vr,
                                            j3dr_i.reshape(-1), pc_first,
                                            k_lerp, heads_pre=spec_heads)
                    vu_cond = bool(conf <= lo32)
                    if cfg.live and vu_cond:
                        vu_cond = (T_spec["vision_count"]
                                   == cfg.update_vision_freq)
                    syn4_in, syn6_in = refeed_inputs(accc, oric, T_spec)
                else:
                    vu_cond = False
                    syn4_in = syn6_in = None

                # single rnn4 evaluation; real input unless refeeding
                real4_in = _cat(accc, oric, j2dc_norm)
                in4 = (real4_in if syn4_in is None
                       else _select(vu_cond, syn4_in, real4_in))
                out4_eval, st4_eval = stack_step(params["rnn4"], in4,
                                                 st["rnn4"])
                out4_eff = carry["out4_first"] if first_frame else out4_eval
                st4_final = _select(_any(conf_vis and not first_frame,
                                         vu_cond), st4_eval, st["rnn4"])
                j3dr_v = (out4_eff.reshape(23, 3)[:, :, None]
                          * Rcr[None]).sum(1)

                # single rnn6 evaluation (first-frame extra step prescanned)
                in6_real = _cat(accc, oric, j2dc, out4_eff)
                in6 = (in6_real if syn6_in is None
                       else _select(vu_cond, syn6_in, in6_real))
                out6_eval, st6_eval = stack_step(params["rnn6"], in6,
                                                 st["rnn6"])
                st6_final = _select(_any(conf_vis, vu_cond), st6_eval,
                                    st["rnn6"])
                pc = out6_eval.reshape(3) if conf_vis else pc_first

                j3dr = gate(conf, j3dr_i, j3dr_v, k_lerp)
                T = heads_and_tail(params, carry, frame, st, c, Rcr, accr,
                                   orir, vr, j3dr, pc, k_lerp)
            out4_first = carry["out4_first"]

        # -- one-shot inertial hidden-state re-init from vision
        if cfg.use_imu_updater and not precomputed_inertial and conf_full:
            h_i, c_i = init_net_apply(params["rnn2"], j3dr[None, :])
            st2_final = _select(carry["first_reach"],
                                (h_i[:, 0], c_i[:, 0]), st2_new)
        else:
            # precomputed-inertial chunks run only once first_reach has
            # cleared, so the rewrite cannot fire there
            st2_final = st2_new
        first_reach = (false_t if cfg.use_imu_updater and conf_full
                       else carry["first_reach"])

        new_carry = {
            "states": {"rnn2": st2_final, "rnn3": st3_new, "rnn4": st4_final,
                       "rnn6": st6_final, "rnn7": T["st7_new"],
                       "rnn8": T["st8_new"]},
            "last_pfoot": T["pfoot"],
            "has_pfoot": true_t,
            "last_tran": T["tran"],
            "has_tran": true_t,
            "floor_buf": T["floor_buf"],
            "floor_cnt": T["floor_cnt"],
            "first_reach": first_reach,
            "vision_count": T["vision_count"],
            "j_temp": T["j_temp"],
            "pc_first": pc_first,
            "out4_first": out4_first,
        }
        out = (T["pose"], T["tran"])
        if output_contacts:
            out = out + (T["contact"],)
        if output_r6d:
            out = out + (T["out7"],)
        return new_carry, out

    return step


def prescan_first_frame(params, body_model, carry, frame0,
                        int8_compute: bool = False):
    r"""Hoisted first-frame rnn4/rnn6 work: on a first frame, commit rnn4's
    real-input state advance and stash its output, and take rnn6's
    first-frame-only extra step, stashing ``pc_first``. The steady step then
    evaluates each of rnn4/rnn6 once per frame. A frame that is not a first
    frame leaves the carry as it is.

    ``frame0["first_frame"]`` is a host bool for one stream, or a ``[B]``
    bool tensor for a batch (``frame0``'s fields and the carry then have a
    leading ``B``): every row is evaluated, its stacks as the batched step
    evaluates them, and a row whose frame 0 is not a first frame keeps its
    carry by a select."""
    first = frame0["first_frame"]
    batched = isinstance(first, torch.Tensor)
    if not batched and not first:
        return carry
    cat = _bcat if batched else _cat
    stack_step = (_batched_stack_step(int8_compute) if batched
                  else partial(rnn_step, int8_compute=int8_compute))
    j2dc, accc, oric = frame0["j2dc"], frame0["accc"], frame0["oric"]
    st = carry["states"]
    out4, st4 = stack_step(params["rnn4"],
                           cat(accc, oric, _bbox_center_normalize(j2dc)),
                           st["rnn4"])
    out6, st6 = stack_step(params["rnn6"], cat(accc, oric, j2dc, out4),
                           st["rnn6"])
    carry = dict(carry)
    if batched:
        carry["states"] = dict(st, rnn4=_state_where(first, st4, st["rnn4"]),
                               rnn6=_state_where(first, st6, st["rnn6"]))
        carry["pc_first"] = torch.where(first[:, None], out6,
                                        carry["pc_first"])
        carry["out4_first"] = torch.where(first[:, None], out4,
                                          carry["out4_first"])
        return carry
    carry["states"] = dict(st, rnn4=st4, rnn6=st6)
    carry["pc_first"] = out6.reshape(3)
    carry["out4_first"] = out4.reshape(-1)
    return carry


# tail constants of each body model the batched path has met, so that a
# batched run uploads nothing once its model has been seen
_BATCHED_CONSTS = weakref.WeakKeyDictionary()


def _batched_consts(body_model):
    key = bool(body_model.use_pose_blendshape)
    hit = _BATCHED_CONSTS.get(body_model)
    if hit is None or hit[0] != key:
        hit = (key, tail_constants(body_model))
        _BATCHED_CONSTS[body_model] = hit
    return hit[1]


def _dense_f32(params) -> bool:
    r"""True if a stack's linear1 and gate matrices are float32 tensors
    (not bf16, not int8 records)."""
    ws = [params["linear1"]["w"]] + [l[k] for l in params["layers"]
                                     for k in ("w_ih", "w_hh")]
    return all(isinstance(w, torch.Tensor) and w.dtype == torch.float32
               for w in ws)


def _batched_stack_step(int8_compute: bool):
    r"""One stack of the batched step: float32 weights through
    ``ops.lstm_cell.rnn_step_cells`` (one ``robustcap::lstm_cell`` call a
    layer, the hand-written kernel on the card), bf16 weights and int8
    records through ``nn.rnn.rnn_step``."""
    def stack_step(params, x, state):
        if _dense_f32(params):
            return rnn_step_cells(params, x, state)
        return rnn_step(params, x, state, int8_compute=int8_compute)
    return stack_step


def make_batched_step(body_model, cfg: SigMPConfig):
    r"""The steady step (``include_first_frame_step=False``) over a leading
    batch axis, in the branchless form the JAX package vmaps for its batched
    paths (``fuse_spec_heads=False``, ``cond_updater=False``): the
    speculative heads and tail on the inertial joints, one rnn4 and one rnn6
    evaluation on inputs selected between the real and the refed keypoints,
    then the final heads and tail. Every stack is one product of ``[B, K]``
    rows per weight. With ``cfg.pallas_tail`` each tail is one call of the
    operator ``robustcap::geometry_tail`` over the B rows (one kernel launch
    on the card), as the JAX step runs its tail kernel under ``vmap``; the
    other kernel flags are not read here. With float32 weights each LSTM
    layer of a stack is one call of the operator ``robustcap::lstm_cell``
    (``ops/lstm_cell.py``: one kernel launch on the card up to
    ``ROWS_DIRECT`` rows, ``torch.lstm_cell`` above), whatever ``cfg``
    says; bf16 and int8 weights go through ``nn.rnn.rnn_step``.

    ``step(params, carry, frame) -> (carry, (pose [B, 24, 3, 3],
    tran [B, 3]))``: the carry from ``init_carry(params,
    batch_shape=(B,))`` seeded by :func:`prescan_first_frame`, the frame's
    fields ``[B, ...]`` with ``first_frame`` and ``first_tran_valid`` as
    ``[B]`` bool tensors. The confidence is computed on the device and no
    value is read back to the host."""
    consts = _batched_consts(body_model)
    tail = geometry_tail_batched if cfg.pallas_tail else tail_batched
    stack_step = _batched_stack_step(cfg.int8_compute)
    conf_lo, conf_hi = cfg.conf_range
    inv_range = 1.0 / (conf_hi - conf_lo)

    def heads_and_tail(params, carry, frame, st, c, Rcr, accr, orir, vr,
                       j3dr, pc, k_lerp):
        x = _bcat(accr, orir, j3dr)
        out7, st7_new = stack_step(params["rnn7"], x, st["rnn7"])
        out8, st8_new = stack_step(params["rnn8"], x, st["rnn8"])
        T = tail(consts, cfg, out7, out8, carry, frame, c, Rcr, vr, pc,
                 k_lerp)
        if cfg.use_reproj_opt:
            T["tran"], T["j_lm"] = _reproj_refine(cfg, frame["j2dc"], c,
                                                  T["tran"], T["j_lm"])
        return dict(T, st7_new=st7_new, st8_new=st8_new)

    def step(params, carry, frame):
        st = carry["states"]
        j2dc, accc, oric = frame["j2dc"], frame["accc"], frame["oric"]
        first_frame = frame["first_frame"]
        c = j2dc[..., 2].mean(-1)
        conf_vis = c > conf_lo
        full = c >= conf_hi
        Rcr = oric[:, -1]
        k_lerp = torch.clamp((c - conf_lo) * inv_range, 0.0, 1.0)

        # -- inertial branch: rotate into the root frame
        accr = (accc[..., None] * Rcr[:, None]).sum(2)
        orir = mat3_mul(Rcr.transpose(-1, -2)[:, None], oric)
        out2, st2_new = stack_step(params["rnn2"], _bcat(accr, orir),
                                   st["rnn2"])
        out3, st3_new = stack_step(params["rnn3"], _bcat(accr, orir, out2),
                                   st["rnn3"])
        pc_first = carry["pc_first"]

        # -- speculative heads and tail: when occluded, the fused joints are
        # the inertial ones and pc is pc_first, so the refeed inputs are
        # known before rnn4/rnn6 run
        in4 = _bcat(accc, oric, _bbox_center_normalize(j2dc))
        vu_cond = torch.zeros_like(conf_vis)
        if cfg.use_vision_updater:
            T_spec = heads_and_tail(params, carry, frame, st, c, Rcr, accr,
                                    orir, out3, out2, pc_first, k_lerp)
            vu_cond = c <= conf_lo
            if cfg.live:
                vu_cond = vu_cond & (T_spec["vision_count"]
                                     == cfg.update_vision_freq)
            j2dc_syn = T_spec["j_lm"] / T_spec["j_lm"][..., 2:]
            j3dc_syn = T_spec["joint"][:, 1:] - T_spec["joint"][:, :1]
            in4 = torch.where(vu_cond[:, None], _bcat(
                accc, oric, _bbox_center_normalize(j2dc_syn)), in4)

        # -- one rnn4 evaluation; the first frame's real advance and output
        # are in the prescan carry
        out4_eval, st4_eval = stack_step(params["rnn4"], in4, st["rnn4"])
        out4_eff = torch.where(first_frame[:, None], carry["out4_first"],
                               out4_eval)
        st4_final = _state_where((conf_vis & ~first_frame) | vu_cond,
                                 st4_eval, st["rnn4"])

        # -- one rnn6 evaluation (the first frame's extra step prescanned)
        in6 = _bcat(accc, oric, j2dc, out4_eff)
        if cfg.use_vision_updater:
            in6 = torch.where(vu_cond[:, None],
                              _bcat(accc, oric, j2dc_syn, j3dc_syn), in6)
        out6_eval, st6_eval = stack_step(params["rnn6"], in6, st["rnn6"])
        st6_final = _state_where(conf_vis | vu_cond, st6_eval, st["rnn6"])
        pc = torch.where(conf_vis[:, None], out6_eval, pc_first)

        # -- confidence-gated lerp of inertial and visual joints
        j3dr_v = (out4_eff.reshape(-1, 23, 3)[..., None]
                  * Rcr[:, None]).sum(2).reshape(-1, 69)
        j3dr = torch.where(
            full[:, None], j3dr_v,
            torch.where(conf_vis[:, None], lerp(out2, j3dr_v, k_lerp[:, None]),
                        out2))
        T = heads_and_tail(params, carry, frame, st, c, Rcr, accr, orir,
                           out3, j3dr, pc, k_lerp)

        # -- one-shot inertial hidden-state re-init from vision
        st2_final, first_reach = st2_new, carry["first_reach"]
        if cfg.use_imu_updater:
            h_i, c_i = init_net_apply(params["rnn2"], j3dr)
            st2_final = _state_where(full & first_reach, (h_i, c_i), st2_new)
            first_reach = first_reach & ~full

        new_carry = {
            "states": {"rnn2": st2_final, "rnn3": st3_new, "rnn4": st4_final,
                       "rnn6": st6_final, "rnn7": T["st7_new"],
                       "rnn8": T["st8_new"]},
            "last_pfoot": T["pfoot"],
            "has_pfoot": torch.ones_like(first_reach),
            "last_tran": T["tran"],
            "has_tran": torch.ones_like(first_reach),
            "floor_buf": T["floor_buf"],
            "floor_cnt": T["floor_cnt"],
            "first_reach": first_reach,
            "vision_count": T["vision_count"],
            "j_temp": T["j_temp"],
            "pc_first": pc_first,
            "out4_first": carry["out4_first"],
        }
        return new_carry, (T["pose"], T["tran"])

    return step


# ---------------------------------------------------------------------------
# Offline and streaming drivers
# ---------------------------------------------------------------------------


def _stack_outputs(outs):
    return tuple(torch.stack(x) for x in zip(*outs))


def _require_device(params, body_model, dev):
    w_dev = _param_device(params)
    if w_dev != dev or body_model.device != dev:
        raise ValueError(
            f"params on {w_dev} and body model on {body_model.device}, "
            f"but the run was asked for on {dev}")


def forward_offline(params, body_model, cfg, j2dc, accc, oric,
                    first_tran=None, first_frame=False, gravityc=None,
                    return_contacts: bool = False, return_r6d: bool = False,
                    device="cuda"):
    r"""Whole-sequence inference: the first-frame prescan, then the steady
    step (``cond_updater=True``) frame by frame, or with ``cfg.pallas_serve``
    one serve-kernel launch over the whole sequence (its int8-gate mode
    under ``cfg.int8_compute``, else the mode of the weights' dtype).
    Returns ``(pose [T,24,3,3], tran [T,3])``, plus contacts ``[T, 2]`` with
    ``return_contacts``, and then the raw rnn7 head ``[T, 144]`` with
    ``return_r6d`` (the plain step only: the serve kernel does not keep
    it). Params and body model must already be on ``device``."""
    with trace.span("offline"):
        if return_r6d and cfg.pallas_serve:
            raise ValueError("return_r6d requires the plain step "
                             "(cfg.pallas_serve=False)")
        _check_cfg(cfg)
        dev = resolve_device(device)
        _require_device(params, body_model, dev)
        with trace.span("offline.inputs"):
            params = prepare_scan_params(params, cfg.int8_compute)
            frames = _sequence_frames(j2dc, accc, oric, first_tran,
                                      first_frame, gravityc, dev)
        with trace.span("offline.prescan"):
            carry = prescan_first_frame(params, body_model,
                                        init_carry(params),
                                        _frame_at(frames, 0),
                                        cfg.int8_compute)
        if cfg.pallas_serve:
            with trace.span("offline.repack"):
                prepped = serve_params_for(params, cfg)
                consts = tail_constants(body_model)
            with trace.span("offline.launch"):
                pose, tran, contact, _ = serve_scan(prepped, consts, cfg,
                                                    frames, carry)
            return (pose, tran, contact) if return_contacts else (pose, tran)
        step = make_step(body_model, cfg, include_first_frame_step=False,
                         output_contacts=return_contacts, cond_updater=True,
                         output_r6d=return_r6d)
        with trace.span("offline.loop"):
            outs = []
            for t in range(len(frames["conf"])):
                carry, out = step(params, carry, _frame_at(frames, t))
                outs.append(out)
            return _stack_outputs(outs)


_BATCH_FIELDS = {"j2dc": torch.float32, "accc": torch.float32,
                 "oric": torch.float32, "first_tran": torch.float32,
                 "gravityc": torch.float32, "first_frame": torch.bool,
                 "first_tran_valid": torch.bool}


def _offline_batched(step, params, body_model, int8_compute, frames_batched,
                     lengths, dev):
    r"""The batched prescan, then ``step`` (a :func:`make_batched_step`)
    frame after frame up to ``max(lengths)``, outputs stacked over frames:
    the loop of :func:`forward_offline_batched` and of each bucket of
    ``eval.runner.run_sequences``. Params (already through
    ``prepare_scan_params``) and body model must be on ``dev``."""
    _require_device(params, body_model, dev)
    with trace.span("batched.upload"):
        frames = {k: torch.as_tensor(frames_batched[k], dtype=dt, device=dev)
                  for k, dt in _BATCH_FIELDS.items()}
    B, T = frames["j2dc"].shape[:2]
    if lengths is not None:
        T = max(int(n) for n in lengths)
    with trace.span("batched.prescan"):
        carry = prescan_first_frame(
            params, body_model, init_carry(params, batch_shape=(B,)),
            {k: v[:, 0] for k, v in frames.items()}, int8_compute)
    with trace.span("batched.loop"):
        poses, trans = [], []
        for t in range(T):
            carry, (pose, tran) = step(
                params, carry, {k: v[:, t] for k, v in frames.items()})
            poses.append(pose)
            trans.append(tran)
        return torch.stack(poses, 1), torch.stack(trans, 1)


def forward_offline_batched(params, body_model, cfg, frames_batched,
                            lengths: Optional[Sequence[int]] = None,
                            device="cuda"):
    r"""B sequences at once: the batched prescan, then
    :func:`make_batched_step` frame after frame over stacked frames
    ``[B, T, ...]`` (``j2dc [B, T, 33, 3]``, ``accc [B, T, 6, 3]``,
    ``oric [B, T, 6, 3, 3]``, ``first_tran``/``gravityc [B, T, 3]``,
    ``first_frame``/``first_tran_valid [B, T]`` bool), numpy arrays or
    tensors, as ``eval.runner.stack_frames`` makes them. Returns
    ``(pose [B, T', 24, 3, 3], tran [B, T', 3])`` with ``T' = max(lengths)``
    (``T`` without ``lengths``): frames past every row's length are not
    run. A row's frames past its own length are padding, which the caller
    discards; the step is causal, so they change no valid frame.

    No tail kernel runs here, as in the JAX package's
    ``forward_offline_batched``: ``cfg``'s ``pallas_tail`` is turned off
    before the step is built, and the other ``pallas_*`` flags are not read
    (float32 stacks still run their layers through ``robustcap::lstm_cell``,
    see :func:`make_batched_step`). The batched evaluation
    (``eval.runner.run_sequences``) builds its step from the caller's
    ``cfg`` instead and keeps the tail kernel, as the JAX runner does.
    Params and body model must already be on ``device``; with frames
    already there too, the run reads nothing back to the host once the
    body model has been seen."""
    dev = resolve_device(device)
    step = make_batched_step(body_model,
                             dataclasses.replace(cfg, pallas_tail=False))
    params = prepare_scan_params(params, cfg.int8_compute)
    return _offline_batched(step, params, body_model, cfg.int8_compute,
                            frames_batched, lengths, dev)


class StreamingNet:
    r"""Stateful wrapper with the reference's online API
    (``forward_online`` / ``reset_states``) plus ``forward_chunk``, around
    the steady step (each wide cell once per frame; first frames go through
    the prescan first). int8 records are dequantized once here (all but the
    gate matrices under ``cfg.int8_compute``). With ``cfg.pallas_inertial``
    rnn2 and rnn3 are packed once here for the chunk pre-scan's LSTM-scan
    kernel (``prepare_lstm_scan``). With ``cfg.pallas_serve`` the
    serve kernel's operands are prepared once here, in its int8-gate mode
    under ``cfg.int8_compute``, else bf16 for a quantized tree, else the
    weights' dtype, and every chunk is one launch."""

    def __init__(self, params, body_model, cfg: SigMPConfig = SigMPConfig(),
                 device="cuda"):
        _check_cfg(cfg)
        self.device = resolve_device(device)
        _require_device(params, body_model, self.device)
        self.params = params
        self.cfg = cfg
        self.body_model = body_model
        self._scan_params = prepare_scan_params(params, cfg.int8_compute)
        self._step = make_step(body_model, cfg,
                               include_first_frame_step=False,
                               cond_updater=True)
        self._chunk_steps = {}
        self._lstm = None
        if cfg.pallas_inertial:
            self._lstm = {n: prepare_lstm_scan(params[n])
                          for n in ("rnn2", "rnn3")}
        self._serve = None
        if cfg.pallas_serve:
            self._serve = (serve_params_for(params, cfg),
                           tail_constants(body_model))
        self.reset_states()

    def reset_states(self):
        self.carry = init_carry(self.params)
        self._first_reach_cleared = False

    def forward_online(self, j2dc, accc, oric, first_tran=None,
                       first_frame=False, gravityc=None):
        frame = make_frame(j2dc, accc, oric, first_tran, first_frame,
                           gravityc, self.device)
        if first_frame:
            self.carry = prescan_first_frame(self._scan_params,
                                             self.body_model, self.carry,
                                             frame, self.cfg.int8_compute)
        self.carry, (pose, tran) = self._step(self._scan_params, self.carry,
                                              frame)
        return pose, tran

    def forward_chunk(self, j2dc, accc, oric, gravityc=None):
        r"""Advance K frames (no first-frame flags), carrying state across
        chunks like per-frame calls; returns (pose [K, 24, 3, 3], tran
        [K, 3]).

        With ``cfg.pallas_serve`` the chunk is one launch of the serve
        kernel, IMU-updater rewrite included. Otherwise, with
        ``cfg.pallas_inertial`` the inertial pair (rnn2/rnn3) is
        pre-scanned for the whole chunk by the LSTM-scan kernel (their
        inputs are functions of the frame stream alone) and the steps read
        the precomputed outputs. The one-shot IMU-updater state rewrite can
        fire mid-chunk only in the per-frame path, so while ``first_reach``
        is pending (one host fetch per chunk until it clears) chunks take
        that path."""
        if self._serve is not None:
            frames = _sequence_frames(j2dc, accc, oric, None, False,
                                      gravityc, self.device)
            pose, tran, _, self.carry = serve_scan(
                *self._serve, self.cfg, frames, self.carry)
            return pose, tran
        use_kernel = self.cfg.pallas_inertial
        if use_kernel and self.cfg.use_imu_updater:
            if not self._first_reach_cleared:
                self._first_reach_cleared = not bool(
                    self.carry["first_reach"])
            use_kernel = self._first_reach_cleared
        if use_kernel not in self._chunk_steps:
            self._chunk_steps[use_kernel] = make_step(
                self.body_model, self.cfg, include_first_frame_step=False,
                precomputed_inertial=use_kernel, cond_updater=True)
        step = self._chunk_steps[use_kernel]

        frames = _sequence_frames(j2dc, accc, oric, None, False, gravityc,
                                  self.device)
        K = len(frames["conf"])
        carry = self.carry
        if use_kernel:
            oric_c = frames["oric"]
            Rcr = oric_c[:, -1]                                   # [K, 3, 3]
            accr = torch.einsum("tnc,tcr->tnr", frames["accc"], Rcr)
            orir = torch.einsum("tcr,tncs->tnrs", Rcr, oric_c)
            xs2 = torch.cat([accr.reshape(K, -1), orir.reshape(K, -1)], -1)
            st = carry["states"]
            out2, st2 = rnn_scan_chunked(self._lstm["rnn2"], xs2,
                                         st["rnn2"])
            xs3 = torch.cat([xs2, out2], -1)
            out3, st3 = rnn_scan_chunked(self._lstm["rnn3"], xs3,
                                         st["rnn3"])
            frames["out2"], frames["out3"] = out2, out3
        outs = []
        for t in range(K):
            carry, out = step(self._scan_params, carry, _frame_at(frames, t))
            outs.append(out)
        if use_kernel:
            carry["states"] = dict(carry["states"], rnn2=st2, rnn3=st3)
        self.carry = carry
        return _stack_outputs(outs)

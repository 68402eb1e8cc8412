#!/usr/bin/env python3
r"""Drive the PyTorch/CUDA port (``robustcap_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits nonzero):

0. the card's name and power limit, as ``nvidia-smi`` gives them;
1. build every kernel of ``robustcap_tpu_torch/csrc`` with ``nvcc`` (one
   process per source, all started together);
2. the LSTM-scan kernel against its plain PyTorch version at the rnn2 and
   rnn3 full-width shapes (T=256, and 100+156 chained against 256), timed
   beside the plain version and ``torch.nn.LSTM`` (cuDNN) as a yardstick;
3. the geometry-tail kernel against its plain version over 320 frames that
   cover every regime (confidence bands, ring append and snap, live
   throttle, no landmarks, pose blendshapes on and off), timed per launch;
4. the main path at full width (``RNN_SPECS``, a 6890-vertex procedural
   body, random weights from a seed): ``StreamingNet`` with
   ``SigMPConfig(pallas_inertial=True, pallas_tail=True)`` over a first
   frame, a confident 64-frame chunk and two mixed 256-frame chunks, held
   against the same stream with the kernels off; then ``forward_offline``
   at T=256 with the tail kernel, and a short full-width run against the
   plain path on the CPU. The launch counters are set to 0 just before each
   path and read just after; each kernel must have run on it. The serve
   path follows on the same stream: ``StreamingNet`` with
   ``SigMPConfig(pallas_serve=True)`` (one serve launch per chunk) and
   ``forward_offline`` with ``pallas_serve`` at T=256 (one launch), each
   held against the kernels-off path; then the same stream through the
   serve kernel's bf16 mode (``cast_params(params, bf16)``) and int8-gate
   mode (``quantize_params`` with ``SigMPConfig(int8_compute=True)``), whose
   deltas from the f32 serve path are printed without a bound;
5. the serve kernel against its plain version (``serve_scan_plain``, a frame
   loop of the branchless steady step with the mode's arithmetic) on the
   card at full width, in each mode (f32, bf16, int8 gates): a mixed
   256-frame chunk and a ``SigMPConfig.live_mode()`` chunk, 100+156 chained
   against 256, timed per launch beside the plain version in a CUDA graph;
   on the mixed chunk, kernel and plain version frame by frame from one
   carry, held within ``STEP_BOUNDS`` beside controls with another
   arithmetic that must fall outside them; the carried states of the
   two chained runs frame by frame, per stack, beside the plain version on
   the card against the plain version on the CPU; and one more launch per
   mode and chunk with the kernel's timestamp buffer, printed as the
   in-launch split of a frame (weight phases, barriers, tails), with the
   plan's weight bytes per frame from shared memory and through the ring.

It prints a JSON line with every kernel's numbers, and as its last line
``{"ok": true, "device": {...}}``. Without a card it exits nonzero before
printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

# peaks of one H100 SXM (NVIDIA's data sheet, dense): f32 outside the tensor
# cores, bf16 and int8 in them, and the HBM rate, for the bounds
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12


def _time_ms(fn, reps, warmup=2):
    r"""Mean device time of one ``fn()`` over ``reps`` runs (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _time_graph_ms(fn, reps):
    r"""Device time of one ``fn()``: ``reps`` calls captured in a CUDA
    graph and replayed between two events, so the host's cost of issuing
    each call (Python, argument checks) is left out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound_ms(n_bytes, n_flops, n_bf16=0, n_int8=0):
    r"""The larger of the bytes' time and the operations' time, with f32,
    bf16 and int8 operations each at their own peak."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = (n_flops / PEAK_F32_FLOPS + n_bf16 / PEAK_BF16_FLOPS
             + n_int8 / PEAK_INT8_OPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def _max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def _require(ok, what):
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Phase 2: the LSTM-scan kernel
# ---------------------------------------------------------------------------

LSTM_BOUND = 1e-4   # f32 sums in another order, compounded through (h, c)


def check_lstm(params, dev, gen):
    import torch
    from robustcap_tpu_torch.ops.lstm_scan import (rnn_scan_chunked,
                                                   rnn_scan_plain)
    rows = {}
    for name, n_in in (("rnn2", 72), ("rnn3", 141)):
        p = params[name]
        H = p["layers"][0]["w_hh"].shape[1]
        n_out = p["linear2"]["w"].shape[0]
        T = 256
        xs = torch.randn(T, n_in, generator=gen).to(dev)
        state = tuple((0.5 * torch.randn(2, H, generator=gen)).to(dev)
                      for _ in range(2))
        ys, (h, c) = rnn_scan_chunked(p, xs, state)
        ys_p, (h_p, c_p) = rnn_scan_plain(p, xs, state)
        y1, st1 = rnn_scan_chunked(p, xs[:100], state)
        y2, (h2, c2) = rnn_scan_chunked(p, xs[100:], st1)
        torch.cuda.synchronize()
        err = max(_max_err(ys, ys_p), _max_err(h, h_p), _max_err(c, c_p))
        chain = max(_max_err(torch.cat([y1, y2]), ys), _max_err(h2, h),
                    _max_err(c2, c))
        _require(bool(torch.isfinite(ys).all()), f"{name}: non-finite")
        _require(err <= LSTM_BOUND,
                 f"lstm_scan {name}: kernel vs plain {err:.3e} > "
                 f"{LSTM_BOUND:.0e}")
        _require(chain == 0.0,
                 f"lstm_scan {name}: 100+156 chained vs 256 differ by "
                 f"{chain:.3e} (the per-frame arithmetic does not depend on "
                 "where a chunk starts, so they must be equal)")

        ms = _time_ms(lambda: rnn_scan_chunked(p, xs, state), reps=20)
        plain_ms = _time_graph_ms(lambda: rnn_scan_plain(p, xs, state),
                                  reps=2)
        plain_eager_ms = _time_ms(lambda: rnn_scan_plain(p, xs, state),
                                  reps=2, warmup=1)
        # yardstick: cuDNN's 2-layer LSTM over the same chunk (the LSTM
        # layers only; linear1 is applied beforehand and linear2 not at all)
        lstm = torch.nn.LSTM(H, H, num_layers=2).to(dev)
        with torch.no_grad():
            for k, layer in enumerate(p["layers"]):
                getattr(lstm, f"weight_ih_l{k}").copy_(layer["w_ih"])
                getattr(lstm, f"weight_hh_l{k}").copy_(layer["w_hh"])
                getattr(lstm, f"bias_ih_l{k}").copy_(layer["b_ih"])
                getattr(lstm, f"bias_hh_l{k}").copy_(layer["b_hh"])
            y_in = torch.relu(xs @ p["linear1"]["w"].T
                              + p["linear1"]["b"])[:, None]
            hc = (state[0][:, None].contiguous(),
                  state[1][:, None].contiguous())
            lib_ms = _time_ms(lambda: lstm(y_in, hc), reps=20)

        n_w = sum(t.numel() for t in (
            p["linear1"]["w"], p["linear1"]["b"], p["linear2"]["w"],
            p["linear2"]["b"], *[layer[k] for layer in p["layers"]
                                 for k in ("w_ih", "w_hh", "b_ih",
                                           "b_hh")]))
        n_bytes = 4 * (n_w + xs.numel() + ys.numel() + 4 * 2 * H)
        n_flops = T * (2 * (H * n_in + 2 * 4 * H * 2 * H + n_out * H)
                       + 2 * 10 * H)
        bound, by = _bound_ms(n_bytes, n_flops)
        rows[name] = dict(max_abs_err=max(err, chain), ms=ms,
                          plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound, bound_by=by)
        print(f"[lstm_scan] {name} T={T} H={H} in={n_in} out={n_out}: "
              f"kernel vs plain {err:.3e} (bound {LSTM_BOUND:.0e}), "
              f"100+156 chained vs 256 {chain:.3e} (bound 0); kernel "
              f"{ms:.4f} ms/launch ({ms / T * 1e3:.2f} us/frame), plain "
              f"{plain_ms:.3f} ms device time in a CUDA graph "
              f"({plain_eager_ms:.3f} ms issued eagerly), cuDNN nn.LSTM "
              f"{lib_ms:.4f} ms, bound "
              f"{bound:.5f} ms ({by})", flush=True)
    return rows


# ---------------------------------------------------------------------------
# Phase 3: the geometry-tail kernel
# ---------------------------------------------------------------------------

TAIL_BOUND = 1e-4   # one frame of f32 math, sums in another order


def _tail_case(i, gen, dev):
    r"""Random inputs of one frame; ``i`` picks the regime."""
    import torch
    from robustcap_tpu_torch.math.angular import r6d_to_rotation_matrix
    from robustcap_tpu_torch.models.sig_mp import DEFAULT_GRAVITY

    def rn(*shape, s=1.0):
        return (s * torch.randn(*shape, generator=gen)).to(dev)

    conf = (0.2, 0.75, 0.95, 0.95)[i % 4]
    c = torch.tensor(conf, device=dev)
    carry = {
        "last_pfoot": rn(2, 3, s=0.5),
        "has_pfoot": torch.tensor(i % 5 != 0, device=dev),
        "last_tran": rn(3),
        "has_tran": torch.tensor(i % 7 != 0, device=dev),
        "floor_buf": rn(11, 3, s=0.05),
        "floor_cnt": torch.tensor((i * 5) % 12, dtype=torch.int32,
                                  device=dev),
        "vision_count": torch.tensor((0, 1, 30)[i % 3], dtype=torch.int32,
                                     device=dev),
        "j_temp": rn(33, 3),
    }
    frame = {"first_tran": rn(3),
             "gravityc": torch.as_tensor(DEFAULT_GRAVITY).to(dev),
             "first_frame": i % 29 == 0, "first_tran_valid": i % 31 == 0}
    Rcr = r6d_to_rotation_matrix(torch.randn(1, 6, generator=gen)
                                 ).reshape(3, 3).to(dev).contiguous()
    args = dict(out7=rn(144), out8=rn(2, s=2.0), carry=carry, frame=frame,
                c=c, Rcr=Rcr, vr=rn(3), pc=rn(3, s=0.3),
                k_lerp=torch.clamp((c - 0.7) * 10.0, 0.0, 1.0))
    return args


def check_tail(models, dev, gen):
    import torch
    from robustcap_tpu_torch.config import SigMPConfig
    from robustcap_tpu_torch.ops.geometry_tail import (geometry_tail,
                                                       tail_constants,
                                                       tail_plain)
    cfgs = [SigMPConfig(),
            SigMPConfig(contact_threshold=0.2, height_threshold=5.0),
            SigMPConfig.live_mode(),
            SigMPConfig(use_vision_updater=False, use_flat_floor=False),
            SigMPConfig(tran_filter_num=2.0, distance_threshold=0.5)]
    consts = [tail_constants(m) for m in models]   # blendshape off, on
    err, frames, appended, snapped, live_fk = 0.0, 0, 0, 0, 0
    for i in range(320):
        cfg = cfgs[i % len(cfgs)]
        k = (i // len(cfgs)) % 2
        a = _tail_case(i, gen, dev)
        got = geometry_tail(consts[k], cfg, **a)
        want = tail_plain(consts[k], cfg, **a)
        for field, w in want.items():
            g = got[field]
            _require(g.shape == w.shape, f"tail {field}: shape {g.shape} "
                     f"vs {w.shape}")
            if w.dtype in (torch.int32, torch.int64):
                _require(bool((g == w).all()),
                         f"tail frame {i} {field}: {g} vs {w}")
            else:
                e = _max_err(g, w)
                _require(e <= TAIL_BOUND,
                         f"tail frame {i} ({cfg}) {field}: {e:.3e} > "
                         f"{TAIL_BOUND:.0e}")
                err = max(err, e)
        frames += 1
        appended += int(got["floor_cnt"] > a["carry"]["floor_cnt"])
        snapped += int(got["floor_cnt"] == 11 and float(
            torch.sigmoid(a["out8"]).max()) > cfg.contact_threshold)
        live_fk += int(cfg.live and int(a["carry"]["vision_count"]) == 0)
    torch.cuda.synchronize()
    _require(appended > 0 and snapped > 0 and live_fk > 0,
             f"tail regimes not all reached: append {appended}, snap "
             f"{snapped}, live recompute {live_fk}")

    a = _tail_case(2, gen, dev)
    cfg = SigMPConfig()
    ms = _time_graph_ms(lambda: geometry_tail(consts[1], cfg, **a), reps=100)
    ms_nobs = _time_graph_ms(lambda: geometry_tail(consts[0], cfg, **a),
                             reps=100)
    plain_ms = _time_graph_ms(lambda: tail_plain(consts[1], cfg, **a),
                              reps=20)
    call_ms = _time_ms(lambda: geometry_tail(consts[1], cfg, **a), reps=200)
    plain_call_ms = _time_ms(lambda: tail_plain(consts[1], cfg, **a),
                             reps=20)
    # bytes: every input and constant read once, every output written once
    # (blendshape on); operations: ~8K for rotations, IK, FK and
    # translation, 33 landmarks x (24 x 24 LBS + 3 x 207 x 2 blendshape)
    tensors = [a["out7"], a["out8"], a["Rcr"], a["vr"], a["pc"], a["c"],
               a["k_lerp"], *a["carry"].values(), a["frame"]["first_tran"],
               a["frame"]["gravityc"]]
    tensors += [consts[1][k] for k in ("parent", "bone", "j0", "wsub",
                                       "v0sub", "pd")]
    out = geometry_tail(consts[1], cfg, **a)
    n_bytes = sum(t.numel() * t.element_size() for t in tensors) + sum(
        t.numel() * t.element_size() for t in out.values())
    n_flops = 8000 + 33 * (24 * 24 + 3 * 207 * 2)
    bound, by = _bound_ms(n_bytes, n_flops)
    print(f"[geometry_tail] {frames} frames, every field within "
          f"{TAIL_BOUND:.0e} (max {err:.3e}); ring appends {appended}, "
          f"snaps {snapped}, live recomputes {live_fk}; device time in a "
          f"CUDA graph: kernel {ms * 1e3:.2f} us/launch with blendshapes, "
          f"{ms_nobs * 1e3:.2f} us without, plain {plain_ms * 1e3:.1f} us; "
          f"per call issued from Python: kernel {call_ms * 1e3:.1f} us, "
          f"plain {plain_call_ms * 1e3:.1f} us; "
          f"bound {bound * 1e3:.4f} us ({by}, {n_bytes} bytes)", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound, bound_by=by)


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

# Bounds of the main path, kernels against the plain path. Rounding
# differences of ~1e-7 grow through the random weights: Gram-Schmidt of
# near-degenerate r6d amplifies them in a few frames, and translation
# integrates them over the stream. The plain path alone, on the card against
# the CPU, differs on this stream by a pose p95 of 2.6e-4 and a translation
# of 6.5 mm after 577 frames (the "control" line; H100 80GB HBM3, 700 W), so
# the bounds sit a few times above that. A lasting change of meaning (a
# contact or floor decision flipped) moves translation by centimetres per
# frame and would cross the translation bound.
POSE_MEDIAN_BOUND = 1e-4   # per-frame max abs of rotation-matrix entries
POSE_P95_BOUND = 1e-3
TRAN_BOUND = 2e-2          # metres


def _stream_inputs(seed, conf):
    r"""Keypoints, IMU accelerations and orientations of a synthetic stream
    whose per-frame confidence is ``conf``."""
    import torch
    from robustcap_tpu_torch.math.angular import r6d_to_rotation_matrix
    rng = np.random.RandomState(seed)
    T = len(conf)
    j2dc = rng.uniform(0.2, 0.9, (T, 33, 3)).astype(np.float32)
    j2dc[:, :, 2] = np.asarray(conf, np.float32)[:, None]
    accc = rng.randn(T, 6, 3).astype(np.float32)
    oric = r6d_to_rotation_matrix(torch.from_numpy(
        rng.randn(T * 6, 6).astype(np.float32))).reshape(T, 6, 3, 3).numpy()
    return j2dc, accc, oric


def _mixed(T, seed):
    r"""Mixed confidence with an occluded run in the middle."""
    rng = np.random.RandomState(seed)
    conf = rng.choice([0.2, 0.75, 0.95, 0.95], T).astype(np.float32)
    conf[T // 3:T // 3 + 40] = 0.1
    return conf


def _compare(name, a, b, marks=(), bounds=(POSE_MEDIAN_BOUND, POSE_P95_BOUND,
                                           TRAN_BOUND)):
    r"""Print pose per-frame max-abs median/p95 and translation max abs of
    two runs; return whether they are within ``bounds`` (``None``: printed
    only). ``marks`` are frame counts at which the running translation
    error is printed too."""
    import torch
    (pose_a, tran_a), (pose_b, tran_b) = a, b
    for x in (pose_a, tran_a, pose_b, tran_b):
        _require(bool(torch.isfinite(x).all()), f"{name}: non-finite")
    per_frame = (pose_a - pose_b).abs().flatten(1).amax(1).double()
    med = float(per_frame.median())
    p95 = float(torch.quantile(per_frame, 0.95))
    tran_err = (tran_a.double() - tran_b.double()).abs().amax(1)
    tmax = float(tran_err.max())
    growth = ", ".join(f"{float(tran_err[:n].max()):.2e} by frame {n}"
                       for n in marks)
    if bounds is None:
        ok, lim = True, ("", "", "")
    else:
        ok = med <= bounds[0] and p95 <= bounds[1] and tmax <= bounds[2]
        lim = tuple(f" (bound {b:.1e})" for b in bounds)
    print(f"[main] {name}: pose per-frame max-abs median {med:.3e}{lim[0]}, "
          f"p95 {p95:.3e}{lim[1]}; tran max abs {tmax:.3e} m{lim[2]}"
          + (f"; tran error {growth}" if growth else "")
          + ("" if ok else "  <-- OUTSIDE"), flush=True)
    return ok


def run_stream(net, first, chunks):
    import torch
    times, outs = [], []
    sync = torch.cuda.synchronize if net.device.type == "cuda" else (
        lambda: None)
    sync()
    t0 = time.perf_counter()
    pose, tran = net.forward_online(first[0][0], first[1][0], first[2][0],
                                    first_tran=np.zeros(3, np.float32),
                                    first_frame=True)
    sync()
    times.append(("first frame", 1, time.perf_counter() - t0))
    outs.append((pose[None], tran[None]))
    for label, chunk in chunks:
        t0 = time.perf_counter()
        out = net.forward_chunk(*chunk)
        sync()
        times.append((label, len(chunk[0]), time.perf_counter() - t0))
        outs.append(out)
    return (tuple(torch.cat(x).cpu() for x in zip(*outs)), times)


def check_main(params, model, dev):
    import torch
    from robustcap_tpu_torch.config import SigMPConfig
    from robustcap_tpu_torch.device import tree_map
    from robustcap_tpu_torch.models import sig_mp
    from robustcap_tpu_torch.ops import geometry_tail, lstm_scan, serve_scan
    from robustcap_tpu_torch.smpl import ParametricModel

    first = _stream_inputs(1, [0.2])
    chunks = [("confident chunk", _stream_inputs(2, [0.95] * 64)),
              ("mixed chunk 1", _stream_inputs(3, _mixed(256, 3))),
              ("mixed chunk 2", _stream_inputs(4, _mixed(256, 4)))]
    n_frames = 1 + sum(len(c[1][0]) for c in chunks)
    marks = (65, 321, 577)
    ok = True

    on_cfg = SigMPConfig(pallas_inertial=True, pallas_tail=True)
    net = sig_mp.StreamingNet(params, model, on_cfg, device=dev)
    lstm_scan.LAUNCHES = 0
    geometry_tail.LAUNCHES = 0
    on, t_on = run_stream(net, first, chunks)
    launches = {"lstm_scan": lstm_scan.LAUNCHES,
                "geometry_tail": geometry_tail.LAUNCHES}
    print(f"[main] StreamingNet (pallas_inertial, pallas_tail): launches "
          f"{launches} over {n_frames} frames", flush=True)
    _require(list(net._chunk_steps) == [False, True],
             "the stream did not reach the LSTM-scan path")
    _require(launches["lstm_scan"] == 4,
             "expected 4 LSTM-scan launches (rnn2 and rnn3 in each of the "
             "two chunks after first_reach cleared)")
    _require(launches["geometry_tail"] == n_frames,
             "expected one tail launch per frame")

    off, t_off = run_stream(sig_mp.StreamingNet(params, model, SigMPConfig(),
                                                device=dev), first, chunks)

    # the serve path: one launch per chunk
    serve_net = sig_mp.StreamingNet(params, model,
                                    SigMPConfig(pallas_serve=True),
                                    device=dev)
    serve_scan.LAUNCHES = 0
    serve, t_serve = run_stream(serve_net, first, chunks)
    launches["serve_scan"] = serve_scan.LAUNCHES
    print(f"[main] StreamingNet (pallas_serve): {launches['serve_scan']} "
          f"serve launches over {len(chunks)} chunks", flush=True)
    _require(launches["serve_scan"] == len(chunks),
             "expected one serve launch per chunk")
    for (label, n, s_on), (_, _, s_off), (_, _, s_sv) in zip(t_on, t_off,
                                                             t_serve):
        print(f"[main] {label} ({n} frames): {s_on / n * 1e3:.3f} ms/frame "
              f"kernels on, {s_off / n * 1e3:.3f} ms/frame kernels off, "
              f"{s_sv / n * 1e3:.3f} ms/frame serve kernel "
              "(host clock, synchronized)", flush=True)
    inertial, _ = run_stream(sig_mp.StreamingNet(
        params, model, SigMPConfig(pallas_inertial=True), device=dev),
        first, chunks)
    tail_only, _ = run_stream(sig_mp.StreamingNet(
        params, model, SigMPConfig(pallas_tail=True), device=dev),
        first, chunks)

    # control: the same stream through the plain path on the CPU, full width
    cpu = torch.device("cpu")
    params_cpu = tree_map(lambda t: t.cpu(), params)
    model_cpu = ParametricModel(data=model.data, device=cpu)
    t0 = time.perf_counter()
    ref, _ = run_stream(sig_mp.StreamingNet(params_cpu, model_cpu,
                                            SigMPConfig(), device=cpu),
                        first, chunks)
    print(f"[main] CPU plain stream: {time.perf_counter() - t0:.1f} s",
          flush=True)

    ok &= _compare("stream, kernels on vs off (card)", on, off, marks)
    ok &= _compare("stream, LSTM-scan kernel only vs off (card)", inertial,
                   off, marks)
    ok &= _compare("stream, tail kernel only vs off (card)", tail_only, off,
                   marks)
    ok &= _compare("stream, serve kernel vs off (card)", serve, off, marks)
    _compare("control: stream, plain on the card vs plain on the CPU", off,
             ref, marks)
    ok &= _compare("stream, kernels on (card) vs plain on the CPU", on, ref,
                   marks)

    # the serve kernel's bf16 and int8-gate modes on the same stream; their
    # deltas from the f32 serve path are printed without a bound (random
    # weights make them large)
    for mode, p, cfg in _serve_modes(params)[1:]:
        net = sig_mp.StreamingNet(p, model, dataclasses.replace(
            cfg, pallas_serve=True), device=dev)
        serve_scan.LAUNCHES = 0
        out, t_mode = run_stream(net, first, chunks)
        key = f"serve_scan_{mode}"
        launches[key] = serve_scan.LAUNCHES
        _require(launches[key] == len(chunks),
                 f"{mode} serve path: {launches[key]} launches, expected one "
                 "per chunk")
        _require(all(bool(torch.isfinite(x).all()) for x in out),
                 f"{mode} serve path: non-finite pose or translation")
        print(f"[main] StreamingNet (pallas_serve, {mode}): "
              f"{launches[key]} serve launches; "
              + ", ".join(f"{label} {sec / n * 1e3:.3f} ms/frame"
                          for label, n, sec in t_mode[1:])
              + " (host clock, synchronized)", flush=True)
        _compare(f"stream, serve kernel {mode} vs serve kernel f32 (card)",
                 out, serve, marks, bounds=None)

    # forward_offline with the tail kernel, T=256
    seq = _stream_inputs(5, _mixed(256, 5))
    tail_cfg = SigMPConfig(pallas_tail=True)
    geometry_tail.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    off_on = sig_mp.forward_offline(params, model, tail_cfg, *seq,
                                    first_frame=True, device=dev)
    torch.cuda.synchronize()
    s_on = time.perf_counter() - t0
    tail_launches = geometry_tail.LAUNCHES
    _require(tail_launches == 256, f"forward_offline: {tail_launches} tail "
             "launches, expected 256")
    t0 = time.perf_counter()
    off_off = sig_mp.forward_offline(params, model, SigMPConfig(), *seq,
                                     first_frame=True, device=dev)
    torch.cuda.synchronize()
    s_off = time.perf_counter() - t0
    ok &= _compare("forward_offline T=256, tail kernel on vs off",
                   tuple(x.cpu() for x in off_on),
                   tuple(x.cpu() for x in off_off), (64, 128, 256))
    serve_scan.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    off_serve = sig_mp.forward_offline(params, model,
                                       SigMPConfig(pallas_serve=True), *seq,
                                       first_frame=True, device=dev)
    torch.cuda.synchronize()
    s_serve = time.perf_counter() - t0
    launches["serve_scan_offline"] = serve_scan.LAUNCHES
    _require(launches["serve_scan_offline"] == 1,
             f"forward_offline: {launches['serve_scan_offline']} serve "
             "launches, expected 1")
    ok &= _compare("forward_offline T=256, serve kernel vs plain step",
                   tuple(x.cpu() for x in off_serve),
                   tuple(x.cpu() for x in off_off), (64, 128, 256))
    print(f"[main] forward_offline: {tail_launches} tail launches, "
          f"{launches['serve_scan_offline']} serve launch; "
          f"{s_on / 256 * 1e3:.3f} ms/frame tail kernel, "
          f"{s_serve / 256 * 1e3:.3f} ms/frame serve kernel, "
          f"{s_off / 256 * 1e3:.3f} ms/frame plain", flush=True)
    _require(ok, "main path outside its bounds (see the lines above)")
    return launches


# ---------------------------------------------------------------------------
# Phase 5: the serve kernel
# ---------------------------------------------------------------------------


def _serve_modes(params):
    r"""(mode, weights, config) of the serve kernel's three modes."""
    import torch
    from robustcap_tpu_torch.config import SigMPConfig
    from robustcap_tpu_torch.nn.rnn import cast_params, quantize_params
    return (("f32", params, SigMPConfig()),
            ("bf16", cast_params(params, torch.bfloat16), SigMPConfig()),
            ("int8", quantize_params(params),
             SigMPConfig(int8_compute=True)))


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _stack_weights(s):
    return [s["w1"], *s["w_ih"], *s["w_hh"], s["w2"]]


def _serve_work(prepped, frames, n_iu, n_spec):
    r"""(bytes, f32 operations, bf16 operations, int8 operations) the serve
    function needs on a non-live chunk: every weight (in its mode's type),
    frame input and carry field read once, every output written once; six
    stack evaluations per frame, and on the ``n_spec`` frames where the
    refeed may fire (c <= lo) the speculative rnn7/rnn8 and tail as well;
    one final tail per frame, and init_net on the ``n_iu`` frames where the
    IMU updater fires. Products with bf16 or int8 weights count at their
    type's rate, the gate arithmetic, the quantization and the tails at the
    f32 rate."""
    T = len(frames["conf"])
    mode = prepped["mode"]
    n_bytes, f32, bf16, int8 = 0, 0, 0, 0
    for name, s in prepped["stacks"].items():
        H, n_in, n_out = s["H"], s["in"], s["out"]
        n_bytes += _nbytes(*_stack_weights(s), s["b1"], *s["bias"], s["b2"],
                           *s.get("w_ih_s", ()), *s.get("w_hh_s", ()))
        reps = T + (n_spec if name in ("rnn7", "rnn8") else 0)
        dense = 2 * (H * n_in + n_out * H)
        gates = 2 * 2 * 4 * H * 2 * H
        f32 += reps * 2 * 10 * H
        if mode == "f32":
            f32 += reps * (dense + gates)
        elif mode == "bf16":
            bf16 += reps * (dense + gates)
        else:
            bf16 += reps * dense
            int8 += reps * gates
            f32 += reps * 2 * 2 * 3 * 2 * H   # two quantized rows a layer
    for w, b in prepped["init"]:
        n_bytes += _nbytes(w, b)
        f32 += n_iu * 2 * w.numel()
    f32 += (T + n_spec) * (8000 + 33 * 24 * 24)
    # frame inputs (in2, raw72, keypoints twice, Rcr, c, k, flags, first
    # tran, gravity), outputs (pose, tran, contact), carry in and out
    n_frame = T * (72 + 72 + 99 + 99 + 9 + 1 + 1 + 2 + 3 + 3)
    n_out = T * (216 + 3 + 2)
    n_carry = 2 * sum(2 * 2 * s["H"] for s in prepped["stacks"].values()) \
        + 2 * (6 + 3 + 33 + 99 + 4)
    return n_bytes + 4 * (n_frame + n_out + n_carry), f32, bf16, int8


def _serve_bytes(S, prepped, dev, conf, lo):
    r"""Weight bytes a frame of a non-live chunk reads, on average, from
    the runs resident in shared memory and through the ring (from L2 or
    HBM: the card's counters are not read here), as the kernel's plan
    places them; and the size of the streamed set, which could stay in the
    50 MB L2 only if it is smaller. rnn7/rnn8 count twice on the frames
    where the refeed may fire."""
    plan = S._device_plan(prepped, dev)[0]
    spec = float(np.mean(np.asarray(conf) <= np.float32(lo)))
    res = stream = streamed_set = 0
    for si, name in enumerate(S._STACKS):
        st = prepped["stacks"][name]
        rec = st["packed"][2]
        uses = 1 + spec if name in ("rnn7", "rnn8") else 1
        for k in range(4):
            b = (st["out"] if k == 3 else st["H"]) * rec[k]
            if plan["resident"][si][k]:
                res += uses * b
            else:
                stream += uses * b
                streamed_set += b
    return res, stream, streamed_set, plan


def _stream_ms(prepped, T):
    r"""The weight-streaming floor: the bank is larger than the 50 MB L2 in
    every mode, so a chunk's serial frames read every weight once per frame,
    rnn7/rnn8 twice."""
    per_frame = sum(_nbytes(*_stack_weights(s))
                    * (2 if n in ("rnn7", "rnn8") else 1)
                    for n, s in prepped["stacks"].items())
    return T * per_frame / PEAK_BYTES * 1e3


STATE_MARK = 1e-3   # a carried state's departure that phase 5 dates
INT8_CONTROL_FRAMES = 32

# How phase 5 holds the kernel against its plain version. Chained over a
# chunk, the f32 mode is held like the main path (pose per-frame max-abs
# median and p95, translation max abs). In the bf16 and int8 modes every
# activation is rounded to bf16 (and in int8 mode quantized) before a
# product, so two float32 sums in another order now and then fall on the two
# sides of a rounding boundary, and the one-ulp step then grows through the
# random-weight recurrence like any perturbation: chained, those modes part
# as far as the mode is from float32, and their chained runs are printed
# only. So every mode is also held frame by frame, where nothing compounds:
# each frame, kernel and plain version start from one carry (the plain
# version's), and that frame's pose, translation and carried states are
# compared. ``STEP_BOUNDS``: pose per-frame max-abs median and p95,
# translation max abs, and the median over frames of the mean carried-state
# gap. The medians are what tell a right kernel from a wrong one: on most
# frames no sum crosses a rounding boundary, and kernel and plain version
# agree to float32 order (pose 2e-7 to 5e-7, mean state gap 4e-9 to 3e-7 in
# the three modes; H100 80GB HBM3, 700 W), while arithmetic without the
# mode's rounding moves every frame (pose 3.5e-3 to 1.2e-2, mean state gap
# 6e-5 to 3e-4). The bounds sit at least 10x above the first and 20x below
# the second. The p95 and the translation take the frames where a rounding
# flipped and its one-ulp step ran on through the frame's later stacks;
# they are bounded at four bf16 ulps of a rotation entry (2^-6) and 0.1 mm.
# A control shows that the bounds catch a kernel that leaves out the mode's
# rounding: the plain version with float32 arithmetic on the mode's weights
# (and, for int8, with bf16 arithmetic and no quantization) must fall
# outside them.
STEP_BOUNDS = {"f32": (1e-5, 1e-4, 1e-6, 3e-6),
               "bf16": (1e-5, 2.0 ** -6, 1e-4, 3e-6),
               "int8": (1e-5, 2.0 ** -6, 1e-4, 3e-6)}


def _frame_by_frame(runs, frames, carry):
    r"""Every frame of ``frames`` through each serve function of ``runs``
    (``fn(frames, carry) -> (pose, tran, contact, carry)``) from one carry,
    the first run's. Returns, per run, its ``(pose, tran)`` over the frames
    and, per frame, the gaps of its carried states from the first run's:
    the largest per stack, and the mean over every state entry."""
    import torch
    dev = frames["j2dc"].device
    outs = [([], []) for _ in runs]
    gaps, means = [[] for _ in runs], [[] for _ in runs]
    for t in range(len(frames["conf"])):
        fr = _frame_slice(frames, t, dev)
        res = [fn(fr, carry) for fn in runs]
        ref = res[0][3]["states"]
        for k, (pose, tran, _, c) in enumerate(res):
            outs[k][0].append(pose.cpu())
            outs[k][1].append(tran.cpu())
            d = {n: torch.cat([(c["states"][n][i].double()
                                - ref[n][i].double()).abs().flatten()
                               for i in (0, 1)]) for n in ref}
            gaps[k].append({n: float(v.max()) for n, v in d.items()})
            means[k].append(float(torch.cat(list(d.values())).mean()))
        carry = res[0][3]
    return ([(torch.cat(p), torch.cat(tr)) for p, tr in outs], gaps,
            means)


def _hold_frame_by_frame(S, mode, prepped, consts, cfg, frames, carry):
    r"""The kernel against its plain version frame by frame from one carry,
    within ``STEP_BOUNDS[mode]``; and the controls, which must fall outside
    them. Returns whether the kernel is within them."""
    import torch
    from robustcap_tpu_torch.device import tree_map
    from robustcap_tpu_torch.nn.rnn import dequantize_params

    def plain_as(arith, params):
        p = dict(prepped, mode=arith, params=params)
        return lambda fr, c: S.serve_scan_plain(p, consts, cfg, fr, c)

    runs = {"plain": plain_as(mode, prepped["params"]),
            "kernel": lambda fr, c: S.serve_scan(prepped, consts, cfg, fr, c)}
    if mode != "f32":
        dense = tree_map(lambda t: t.float(), dequantize_params(
            prepped["params"], torch.float32))
        runs["control: plain with f32 arithmetic"] = plain_as("f32", dense)
        if mode == "int8":
            runs["control: plain with bf16 arithmetic, no quantization"] = \
                plain_as("bf16", dense)
    outs, gaps, means = _frame_by_frame(list(runs.values()), frames, carry)
    bounds = STEP_BOUNDS[mode]
    ok = True
    for k, name in enumerate(runs):
        if k == 0:
            continue
        per_max = torch.tensor([max(g.values()) for g in gaps[k]],
                               dtype=torch.float64)
        per_mean = torch.tensor(means[k], dtype=torch.float64)
        mean_med = float(per_mean.median())
        what = f"serve_scan {mode} mixed, frame by frame from one carry, " \
               f"{name} vs plain"
        within = _compare(what, outs[k], outs[0], bounds=bounds[:3])
        within &= mean_med <= bounds[3]
        past = [(t, [n for n, e in g.items() if e > STATE_MARK])
                for t, g in enumerate(gaps[k]) if max(g.values())
                > STATE_MARK]
        print(f"[serve_scan] {what}: carried states, per-frame mean gap "
              f"median {mean_med:.3e} (bound {bounds[3]:.0e}), p95 "
              f"{float(torch.quantile(per_mean, 0.95)):.3e}; per-frame max "
              f"gap median {float(per_max.median()):.3e}, p95 "
              f"{float(torch.quantile(per_max, 0.95)):.3e}, max "
              f"{float(per_max.max()):.3e}; {len(past)} frames past "
              f"{STATE_MARK:.0e}: {past[:12]}"
              + ("" if within else "  <-- OUTSIDE"), flush=True)
        if name == "kernel":
            ok &= within
        else:
            _require(not within, f"{what}: the control is within the bounds "
                     "the kernel is held to, so they cannot tell a kernel "
                     "that leaves out the mode's rounding from a right one")
    return ok


def _frame_slice(frames, t, dev):
    import torch
    return {k: v[t:t + 1].to(dev) if torch.is_tensor(v) else v[t:t + 1]
            for k, v in frames.items()}


def _to(tree, dev):
    import torch
    from robustcap_tpu_torch.device import tree_map
    return tree_map(lambda x: x.to(dev) if torch.is_tensor(x) else x, tree)


def _state_divergence(run_a, run_b, frames, carry):
    r"""Two serve functions chained frame by frame from ``carry`` (one-frame
    chunks give the same bits as one launch, as the chaining check shows).
    ``run_*`` is ``(fn(frames, carry) -> (pose, tran, contact, carry),
    device)``. Returns the per-frame gaps of the carried states, ``{(stack,
    "h" or "c", layer): [T floats]}``, and both runs' pose and
    translation."""
    import torch
    T = len(frames["conf"])
    (fa, da), (fb, db) = run_a, run_b
    ca, cb = _to(carry, da), _to(carry, db)
    gaps, outs = {}, ([], [])
    for t in range(T):
        *oa, ca = fa(_frame_slice(frames, t, da), ca)
        *ob, cb = fb(_frame_slice(frames, t, db), cb)
        outs[0].append([x.cpu() for x in oa[:2]])
        outs[1].append([x.cpu() for x in ob[:2]])
        for n in ca["states"]:
            for i, hc in enumerate("hc"):
                d = (ca["states"][n][i].cpu().double()
                     - cb["states"][n][i].cpu().double()).abs()
                for l in range(d.shape[0]):
                    gaps.setdefault((n, hc, l), []).append(float(d[l].max()))
    runs = tuple(tuple(torch.cat(x) for x in zip(*o)) for o in outs)
    return gaps, runs


def _print_divergence(what, gaps):
    r"""Per stack and for h and c: the largest gap, the first frame past
    ``STATE_MARK``; then, for the stack that passes it first, the gaps of
    each layer on the frames around that one."""
    per = {}
    for (n, hc, l), g in gaps.items():
        m, first = per.get((n, hc), (0.0, None))
        past = next((t for t, e in enumerate(g) if e > STATE_MARK), None)
        if past is not None and (first is None or past < first):
            first = past
        per[(n, hc)] = (max(m, max(g)), first)
    print(f"[serve_scan] {what}, carried states frame by frame (max; first "
          f"frame past {STATE_MARK:.0e}): " + ", ".join(
              f"{n}.{hc} {m:.2e}; {first}"
              for (n, hc), (m, first) in per.items()), flush=True)
    departed = [(first, n) for (n, _), (_, first) in per.items()
                if first is not None]
    if departed:
        t0, n = min(departed)
        lo, hi = max(0, t0 - 3), t0 + 3
        print(f"[serve_scan] {what}: {n} around frame {t0}, per layer, "
              f"frames {lo}..{hi - 1}: " + "; ".join(
                  f"{hc}{l} " + " ".join(f"{e:.1e}" for e in g[lo:hi])
                  for (m, hc, l), g in gaps.items() if m == n), flush=True)


def _serve_divergence(S, mode, p, prepped, consts, cfg, frames, carry,
                      model):
    r"""Where the carried states of kernel and plain version part, chained
    over the chunk: per stack, the largest gap and the first frame past
    ``STATE_MARK``; beside it the same for the plain version on the card
    against the plain version on the CPU, which differ only in the order of
    their float32 sums (the int8 mode's on the first ``INT8_CONTROL_FRAMES``
    frames: its exact int32 products are slow on the CPU)."""
    import torch
    from robustcap_tpu_torch.ops.geometry_tail import tail_constants
    from robustcap_tpu_torch.smpl import ParametricModel
    dev = frames["j2dc"].device
    kernel = (lambda fr, c: S.serve_scan(prepped, consts, cfg, fr, c), dev)
    plain = (lambda fr, c: S.serve_scan_plain(prepped, consts, cfg, fr, c),
             dev)
    gaps, _ = _state_divergence(kernel, plain, frames, carry)
    _print_divergence(f"{mode} mixed, kernel vs plain", gaps)
    T = INT8_CONTROL_FRAMES if mode == "int8" else len(frames["conf"])
    frames = {k: v[:T] for k, v in frames.items()}
    cpu = torch.device("cpu")
    prepped_cpu = S.prepare_serve_params(_to(p, cpu),
                                         int8_gates=mode == "int8")
    consts_cpu = tail_constants(ParametricModel(data=model.data,
                                                device=cpu))
    plain_cpu = (lambda fr, c: S.serve_scan_plain(prepped_cpu, consts_cpu,
                                                  cfg, fr, c), cpu)
    t0 = time.perf_counter()
    gaps, runs = _state_divergence(plain, plain_cpu, frames, carry)
    what = (f"{mode} mixed, first {T} frames, control: plain on the card vs "
            f"plain on the CPU ({time.perf_counter() - t0:.1f} s)")
    _print_divergence(what, gaps)
    _compare(what, *runs, (8, 16, 32) if T < 64 else (64, 128, 256),
             bounds=None)


# The serve kernel's in-launch timestamps (``serve_scan(...,
# timestamps=...)``): per frame, ``TS_SLOTS`` values of %globaltimer (ns)
# written by block 0's thread 0, 0 where nothing was stamped. Slot 0: the
# frame's start; 1 + 2p and 2 + 2p: arrival at and departure from the grid
# barrier after weight phase p (p = 4 g + k: group g of _SPLIT_GROUPS, kind
# k of _SPLIT_KINDS); 33/34 the speculative tail (with the synthetic
# keypoints) begins/ends, 35/36 its barrier; 37/38 the final tail (with the
# carry) begins/ends, 39/40 the frame's last barrier; 41..44 the IMU
# updater's two barriers; 48/49 and 52/53 inside phases 1 and 13, once the
# inputs are in shared memory and after the records (_PROBES). On a frame
# where the refeed cannot fire (c > lo) groups 1 and 2 do not run: rnn4
# runs in group 0 and rnn3 in group 3 (the bracketed stacks). Slots 45..47
# hold byte counts, not times (_BYTE_SLOTS): block 0's bytes of ring pieces
# started before phase 1's first piece, before phase 1 opened, and after its
# last piece.
_BYTE_SLOTS = (45, 46, 47)
_SPLIT_GROUPS = ("rnn2 [+ rnn4]", "rnn3 + speculative heads", "rnn4",
                 "final heads + rnn6 [+ rnn3]")
_SPLIT_KINDS = ("linear1", "layer 0", "layer 1", "linear2")
_PROBES = ("inputs", "records")


def _split_frame(row):
    r"""One frame's stamps as ``{part: ns}``: each interval between two
    consecutive stamps goes to the part that its closing stamp ends. Slots
    48.. (where the kernel has them) probe phases 1 and 13 inside."""
    ev = sorted((int(v), k) for k, v in enumerate(row)
                if v and k not in _BYTE_SLOTS)
    parts = {"frame": ev[-1][0] - ev[0][0], "barriers": 0}
    for (t0, _), (t1, k) in zip(ev, ev[1:]):
        if k >= 48:
            key = f"in phase {1 if k < 52 else 13}: {_PROBES[(k - 48) % 4]}"
            parts[key] = parts.get(key, 0) + t1 - t0
            part = "phase " + _SPLIT_GROUPS[0 if k < 52 else 3]
            parts["kind layer 0"] = parts.get("kind layer 0", 0) + t1 - t0
        elif 1 <= k <= 32 and k % 2 == 1:
            part = "phase " + _SPLIT_GROUPS[(k - 1) // 8]
            kind = "kind " + _SPLIT_KINDS[((k - 1) // 2) % 4]
            parts[kind] = parts.get(kind, 0) + t1 - t0
        elif k in range(2, 33, 2) or k in (36, 40, 42, 44):
            part = "barriers"
            parts["n_barriers"] = parts.get("n_barriers", 0) + 1
        elif k == 34:
            part = "speculative tail"
        elif k == 38:
            part = "final tail"
        else:
            part = "other"
        parts[part] = parts.get(part, 0) + t1 - t0
    return parts


def serve_split(S, prepped, consts, cfg, frames, carry, what):
    r"""One launch of the serve kernel with its timestamp buffer; prints
    the per-frame median of each part of a frame (weight phases by group and
    by kind, barriers, the two tails) in microseconds and as a share of the
    frame, and returns those medians."""
    import torch
    T = len(frames["conf"])
    ts = torch.zeros((T, S.TS_SLOTS), dtype=torch.int64,
                     device=frames["j2dc"].device)
    S.serve_scan(prepped, consts, cfg, frames, carry, timestamps=ts)
    torch.cuda.synchronize()
    rows = [_split_frame(r) for r in ts.cpu().tolist()]
    _require(all(r["frame"] > 0 for r in rows),
             f"{what}: a frame without timestamps")
    keys = sorted({k for r in rows for k in r}, key=lambda k: (
        k != "frame", k.startswith("kind"), k))
    med = {k: float(np.median([r.get(k, 0) for r in rows])) for k in keys}
    share = {k: float(np.median([r.get(k, 0) / r["frame"] for r in rows]))
             for k in keys if k not in ("frame", "n_barriers")}
    print(f"[serve_scan] {what}, in-launch split (block 0's %globaltimer, "
          f"median over {T} frames): frame {med['frame'] / 1e3:.2f} us "
          f"(mean {np.mean([r['frame'] for r in rows]) / 1e3:.2f}), "
          f"{med.get('n_barriers', 0):.0f} barriers; " + ", ".join(
              f"{k} {med[k] / 1e3:.2f} us ({100 * share[k]:.1f}%)"
              for k in keys if k in share), flush=True)
    _phase1_stream(S, prepped, cfg, frames, ts.cpu().numpy(), what)
    return med


def _phase1_stream(S, prepped, cfg, frames, ts, what):
    r"""Phase 1's stream in block 0 on the frames where the refeed cannot
    fire (rnn2's and rnn4's layer 0), from the byte slots: its bytes, those
    started before the phase opened (the ring may have held them already),
    and the rate over the grid between the phase's opening and its barrier,
    counting every byte (an upper bound) and only the bytes started after
    the opening (a lower bound), as if every block streamed block 0's
    bytes."""
    nb = S._device_plan(prepped, frames["j2dc"].device)[0]["blocks"]
    lo = np.float32(cfg.conf_range[0])
    rows = [r for r, c in zip(ts, frames["c"].cpu().numpy())
            if c > lo and r[47] and r[2] and r[3]]
    if not rows:
        return
    total = np.array([r[47] - r[45] for r in rows], np.float64)
    before = np.clip([r[46] - r[45] for r in rows], 0, total)
    dt = np.array([r[3] - r[2] for r in rows], np.float64)
    print(f"[serve_scan] {what}, phase 1 in block 0 on the {len(rows)} "
          f"frames with c > lo (median): {np.median(total) / 1e3:.1f} KB, "
          f"{np.median(before) / 1e3:.1f} KB of it started before the phase "
          f"opened, {np.median(dt) / 1e3:.2f} us from its opening to its "
          f"barrier: {np.median((total - before) * nb / dt) / 1e3:.2f} TB/s "
          f"over the {nb} blocks counting only the bytes started after the "
          f"opening, {np.median(total * nb / dt) / 1e3:.2f} TB/s counting "
          f"every byte", flush=True)


def _serve_chunk(label, seed, T, mode_cfg, scan_p, model, dev):
    r"""(config, confidence, frames, carry) of one phase-5 chunk: ``mixed``
    or ``live`` confidence from ``seed``, the carry after the first frame;
    the IMU updater fires on the first confident frame."""
    from robustcap_tpu_torch.config import SigMPConfig
    from robustcap_tpu_torch.models import sig_mp
    cfg = mode_cfg if label == "mixed" else dataclasses.replace(
        SigMPConfig.live_mode(), int8_compute=mode_cfg.int8_compute)
    conf = _mixed(T, seed)
    conf[:4] = 0.2
    frames = sig_mp._sequence_frames(
        *_stream_inputs(seed, conf), np.zeros(3, np.float32), True, None,
        dev)
    carry = sig_mp.prescan_first_frame(
        scan_p, model, sig_mp.init_carry(scan_p),
        sig_mp._frame_at(frames, 0), cfg.int8_compute)
    return cfg, conf, frames, carry


def serve_split_modes(params, model, dev):
    r"""Only the in-launch split of the serve kernel, in each mode, on the
    mixed and the live chunk of phase 5 (``chip_ab.py --split``)."""
    from robustcap_tpu_torch.models import sig_mp
    from robustcap_tpu_torch.ops import serve_scan as S
    from robustcap_tpu_torch.ops.geometry_tail import tail_constants
    consts = tail_constants(model)
    for mode, p, mode_cfg in _serve_modes(params):
        prepped = S.prepare_serve_params(p, int8_gates=mode_cfg.int8_compute)
        scan_p = sig_mp.prepare_scan_params(p, mode_cfg.int8_compute)
        for label, seed in (("mixed", 6), ("live", 7)):
            cfg, _, frames, carry = _serve_chunk(label, seed, 256, mode_cfg,
                                                 scan_p, model, dev)
            S.serve_scan(prepped, consts, cfg, frames, carry)   # warm-up
            serve_split(S, prepped, consts, cfg, frames, carry,
                        f"{mode} {label} T=256")


def check_serve(params, model, dev):
    import torch
    from robustcap_tpu_torch.models import sig_mp
    from robustcap_tpu_torch.ops import serve_scan as S
    from robustcap_tpu_torch.ops.geometry_tail import tail_constants

    consts = tail_constants(model)
    T, ok, rows = 256, True, {}
    for mode, p, mode_cfg in _serve_modes(params):
        prepped = S.prepare_serve_params(p, int8_gates=mode_cfg.int8_compute)
        _require(prepped["mode"] == mode, f"prepared {prepped['mode']}, "
                 f"expected {mode}")
        scan_p = sig_mp.prepare_scan_params(p, mode_cfg.int8_compute)
        for label, seed in (("mixed", 6), ("live", 7)):
            cfg, conf, frames, carry = _serve_chunk(label, seed, T, mode_cfg,
                                                    scan_p, model, dev)
            got = S.serve_scan(prepped, consts, cfg, frames, carry)
            want = S.serve_scan_plain(prepped, consts, cfg, frames, carry)
            first = {k: v[:100] for k, v in frames.items()}
            rest = {k: v[100:] for k, v in frames.items()}
            a = S.serve_scan(prepped, consts, cfg, first, carry)
            b = S.serve_scan(prepped, consts, cfg, rest, a[3])
            torch.cuda.synchronize()
            name = f"serve_scan {mode} {label} T={T}"
            ok &= _compare(f"{name}, kernel vs plain (card)",
                           (got[0].cpu(), got[1].cpu()),
                           (want[0].cpu(), want[1].cpu()), (64, 128, 256),
                           (POSE_MEDIAN_BOUND, POSE_P95_BOUND, TRAN_BOUND)
                           if mode == "f32" else None)
            err = max(_max_err(x, y) for x, y in zip(got[:3], want[:3]))
            st_err = max(_max_err(got[3]["states"][n][i],
                                  want[3]["states"][n][i])
                         for n in want[3]["states"] for i in (0, 1))
            chain = max(_max_err(torch.cat([x, y]), z)
                        for x, y, z in zip(a[:3], b[:3], got[:3]))
            chain = max([chain] + [
                _max_err(b[3]["states"][n][i], got[3]["states"][n][i])
                for n in got[3]["states"] for i in (0, 1)])
            _require(chain == 0.0,
                     f"{name}: 100+156 chained vs 256 differ by {chain:.3e} "
                     "(the per-frame arithmetic does not depend on where a "
                     "chunk starts, so they must be equal)")
            _require(all(bool(torch.isfinite(x).all()) for x in got[:3]),
                     f"{name}: non-finite output")
            flags = {k: (int(got[3][k]), int(want[3][k]))
                     for k in ("floor_cnt", "vision_count", "first_reach")}
            ms = _time_ms(lambda: S.serve_scan(prepped, consts, cfg, frames,
                                               carry), reps=3, warmup=1)
            plain_ms = _time_graph_ms(
                lambda: S.serve_scan_plain(prepped, consts, cfg, frames,
                                           carry), reps=1)
            # a fresh carry: the IMU updater fires on the first confident
            # frame
            n_iu = int((conf >= np.float32(cfg.conf_range[1])).any())
            n_spec = int((conf <= np.float32(cfg.conf_range[0])).sum())
            n_bytes, *n_ops = _serve_work(prepped, frames, n_iu, n_spec)
            bound, by = _bound_ms(n_bytes, *n_ops)
            stream_ms = _stream_ms(prepped, T)
            print(f"[serve_scan] {mode} {label} T={T}: kernel vs plain "
                  f"pose/tran/contact max {err:.3e}, states max "
                  f"{st_err:.3e}, carry flags (kernel, plain) {flags}; "
                  f"100+156 chained vs 256 {chain:.3e} (bound 0); kernel "
                  f"{ms:.3f} ms/launch ({ms / T * 1e3:.2f} us/frame), plain "
                  f"{plain_ms:.3f} ms device time in a CUDA graph; bound "
                  f"{bound:.4f} ms ({by}, {n_bytes} bytes, operations f32 "
                  f"{n_ops[0]}, bf16 {n_ops[1]}, int8 {n_ops[2]}); weights "
                  f"streamed once per frame would take {stream_ms:.3f} ms",
                  flush=True)
            serve_split(S, prepped, consts, cfg, frames, carry, name)
            if label == "mixed":
                res_b, str_b, str_set, plan = _serve_bytes(
                    S, prepped, dev, conf, cfg.conf_range[0])
                lay = plan["layout"]
                print(f"[serve_scan] {mode} plan: {plan['blocks']} blocks, "
                      f"{lay['total']} bytes of shared memory each: ring "
                      f"{lay['ring_bytes']}, resident {plan['res_bytes']}; "
                      f"weights per frame of the mixed chunk ({n_spec} of "
                      f"{T} frames with the speculative heads): "
                      f"{res_b / 1e6:.2f} MB from shared memory, "
                      f"{str_b / 1e6:.2f} MB streamed through the ring "
                      f"(a streamed set of {str_set / 1e6:.2f} MB against the "
                      f"50 MB L2)", flush=True)
                rows[mode] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  library_ms=None, bound_ms=bound,
                                  bound_by=by)
                ok &= _hold_frame_by_frame(S, mode, prepped, consts, cfg,
                                           frames, carry)
                _serve_divergence(S, mode, p, prepped, consts, cfg, frames,
                                  carry, model)
    _require(ok, "serve kernel outside its bounds (see the lines above)")
    return rows


# ---------------------------------------------------------------------------


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "drives the port on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from robustcap_tpu_torch.models import sig_mp
    from robustcap_tpu_torch.ops import _build
    from robustcap_tpu_torch.smpl import ParametricModel, synthetic_smpl_data

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {len(libs)} kernels built from csrc/ in "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{[os.path.basename(p) for p in libs]}", flush=True)

    gen = torch.Generator().manual_seed(0)
    params = sig_mp.init_params(gen, device=dev)
    data = synthetic_smpl_data()
    model = ParametricModel(data=data, device=dev)
    model_bs = ParametricModel(data=data, use_pose_blendshape=True,
                               device=dev)

    lstm = check_lstm(params, dev, gen)
    tail = check_tail([model, model_bs], dev, gen)
    launches = check_main(params, model, dev)
    serve = check_serve(params, model, dev)

    kernels = [
        dict(name="lstm_scan", route="cuda",
             source="robustcap_tpu_torch/csrc/lstm_scan.cu",
             replaces="robustcap_tpu/ops/pallas_lstm.py:166",
             launches=launches["lstm_scan"],
             max_abs_err=max(r["max_abs_err"] for r in lstm.values()),
             **{k: v for k, v in lstm["rnn2"].items() if k != "max_abs_err"}),
        dict(name="geometry_tail", route="cuda",
             source="robustcap_tpu_torch/csrc/geometry_tail.cu",
             replaces="robustcap_tpu/ops/pallas_tail.py:468",
             launches=launches["geometry_tail"], **tail),
    ]
    kernels += [
        dict(name="serve_scan" if mode == "f32" else f"serve_scan_{mode}",
             mode=mode, route="cuda",
             source="robustcap_tpu_torch/csrc/serve_scan.cu",
             replaces="robustcap_tpu/ops/pallas_serve.py:930",
             launches=launches["serve_scan" if mode == "f32"
                               else f"serve_scan_{mode}"], **row)
        for mode, row in serve.items()]
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

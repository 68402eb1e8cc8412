#!/usr/bin/env python3
r"""Drive the PyTorch/CUDA port (``robustcap_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits nonzero):

0. the card's name and power limit, as ``nvidia-smi`` gives them;
1. build every kernel of ``robustcap_tpu_torch/csrc`` with ``nvcc`` (one
   process per source, all started together);
2. the LSTM-scan kernel against its plain PyTorch version at the rnn2 and
   rnn3 full-width shapes (T=256, and 100+156 chained against 256), on the
   stack prepared once (``prepare_lstm_scan``) as the main path runs it,
   timed beside the plain version and ``torch.nn.LSTM`` (cuDNN) as a
   yardstick; one more launch with the kernel's timestamp buffer, printed
   as the in-launch split (pre-pass, steps with their barrier waits,
   linear2) and the grid barriers a launch runs;
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
   plan's weight bytes per frame from shared memory and through the ring;
6. the batched step (``forward_offline_batched``, plain torch, no kernel):
   B=4 rows of up to 256 frames (a ground-truth first translation, a first
   frame, neither; one row shorter and padded) held row by row against the
   single-stream ``forward_offline`` on the card within phase 4's bounds,
   run under ``torch.cuda.set_sync_debug_mode("error")``; then timed at
   B=512, T=512 in f32, bf16 and int8 (``int8_compute``) with CUDA events,
   and the int8 mode's exact gate products (float64 matmuls) alone;
7. the offline evaluation: ``evaluate_sequences`` over a fixture corpus
   (the batched runner), and ``serve_end_metric_deltas`` in bf16 and int8,
   whose single-stream runs go through the serve kernel (its launches of
   this phase are counted into the kernel line) and whose MPJPE, PVE and
   PA-MPJPE must stay within ``END_METRIC_BOUND_MM`` (2 mm) of float32;
8. serving (``serving.py``, ``streaming/``): bundles exported with
   ``pallas_serve`` and chunk programs of 128 and 256 frames in f32, bf16
   and int8, loaded afresh (export and load seconds, file sizes; ``step.pt2``
   must not hold the weights); each bundle over a first frame and a 128-
   and a 256-frame chunk, equal bit for bit to ``StreamingNet(pallas_serve)``
   from the same carry (the serve kernel through ``robustcap::serve_scan``;
   its launches counted into the kernel line); ``forward_online`` over 256
   frames replayed through a CUDA graph against the eager exported step
   (within ``GRAPH_BOUND``), timed beside the eager ``StreamingNet``; the f32
   bundle against the plain ``StreamingNet`` within phase 4's bounds; the
   multiplexer at capacity 8 for 128 ticks, one slot reset at tick 64, each
   row against its own plain ``StreamingNet`` within phase 4's bounds, and
   its tick timed graphed and eager at capacity 8 and 64; the latency
   harness over 600 frames with ``live_mode()`` and the tail kernel (its
   launches counted) and with the kernels off; the live server over
   loopback with the f32 bundle, 120 detector packets of a fixture
   sequence, one frame back for each;
9. SMPLify (``smplify/``, ``ops/lbfgs.py``, plain torch, no kernel): one
   fixture sequence through ``forward_offline`` with the serve kernel (its
   launch counted into the kernel line), then ``smplify_runner`` at lr 1.0
   and 0.001 on the card and on the CPU from that output (float32: the
   card's move and its gap from the CPU printed, with evaluations and host
   reads), and the same fit in float64 on both, held within a tenth of the
   card's move (the unrefined start outside); the reprojection loss must
   not rise; ``evaluate_sequences`` with and without SMPLify on phase 7's
   corpus; ``make_smplify_fit`` timed at the JAX bench's shape (16 lanes x
   128 frames): frames/s, evaluations and host reads a fit, the
   synchronizing calls under ``torch.cuda.set_sync_debug_mode``, kernels
   and device time from ``torch.profiler``, beside ``nvidia-smi``'s name
   and power limit;
10. training (``train/``, ``nn.rnn.rnn_forward_padded`` on ``nn.LSTM``,
   i.e. cuDNN; no kernel of ours): (a) one train step per module of
   ``RNN_SPECS`` at full width and the reference's training shape (B=256,
   T=200, lengths drawn from 100-200), with the module's own loss
   (``init_net`` for rnn2): with dropout 0 its loss and gradients through
   cuDNN held against the per-frame plain path on the card, and at B=8,
   T=64 against float64 on the CPU, within ``TRAIN_AGREE``; then the whole
   step (forward, loss, backward, clip, Adam, the module's dropout) timed
   with CUDA events (median of 10 after 3 warm-ups) in ms, sequences/s and
   valid frames/s, with ``torch.profiler``'s kernels, device time (held
   within ``TRAIN_BUSY_MARGIN`` of the step), idle share and top three
   kernels, the synchronizing calls a step, the step's memory over what
   was held before it and the whole peak; then timed again with the LSTM
   weights kept in cuDNN's layout (an ``nn.LSTM``'s parameters), against
   cuDNN's copy of the tree's tensors at each call; (b) ``train_rnn2`` ... ``train_rnn8`` for one epoch each on
   a fixture corpus, ``train_rnn3`` resumed from its files for a second
   epoch, ``merge_weights``, ``forward_offline`` of the merged weights
   through the serve kernel (its launch counted into the kernel line;
   finite outputs), and ``python -m robustcap_tpu_torch train --rnn 3``
   in-process on ``.pt`` files written from the corpus;
11. data parallelism and preprocessing (``parallel/``, ``preprocess/``, no
   kernel): (a) NCCL at one rank (``initialize_distributed`` with a
   localhost coordinator, ``make_mesh``): ``train(mesh=)``'s DP step of
   rnn4 and rnn2 at phase 10's shape, dropout 0, against the plain step
   on the same batch (loss equal, parameters within ``DP_AGREE`` of the
   step's move), both timed, with the NCCL all-reduce's device time
   (``torch.profiler``) and the gradient bytes; (b) two ranks sharing the
   card over gloo (this script run twice with ``--gloo-child``, within
   ``CHILD_TIMEOUT_S``): rnn2's DP step with unequal lengths against one
   process on the whole batch, ``run_sequences(mesh=)`` and the float64
   ``refine_sequences_batched(mesh=)`` against unsharded, gloo's own times,
   and full-width rnn2 through ``train(mesh=)`` (early stop and the
   plateau on rank 0's validation, then a resume) with the same parameters
   on both ranks and one metrics line a validation; and two processes asking NCCL for two ranks on the card, which must be
   refused; (c) raw AIST++, TotalCapture, 3DPW(-OCC) and AMASS trees from
   the port's fixtures, ``python -m robustcap_tpu_torch preprocess`` over
   every ``--dataset`` choice on the card, the work dicts held against the
   CPU's, and ``amass_sequence_to_work`` timed on one 12,000-frame motion
   on the card and the CPU with its synchronizing calls;
12. live capture (``sensors/``, ``streaming/{native,sync,detector,unity}``),
   in-process with threads over loopback on free ports, at full width
   (``live_mode()`` with the tail kernel): six ``FakeDotTransport``s playing
   a fixture motion's IMUs at 60 Hz feed ``run_imu_bridge``'s
   ``XsensDotSet`` (native rings); a receiver decodes the UDP packets,
   calibrates with ``tpose_calibration`` on the first 2 s and feeds
   ``ImuCamStream``; ``run_detector`` with a ``mediapipe`` stand-in (the
   fixture's keypoints as pixel fractions, some frames without a detection,
   the first three among them, so that all-zero keypoints at confidence 0
   reach the tail kernel) sends 240 packets through a recording relay to ``run_live_demo``, and a
   Unity client reads one frame per packet. Held: the native datapath in
   use, no ring drops, one ``geometry_tail`` launch per frame (counted into
   the kernel line), finite frames from a zero translation, the keypoints
   against the fixture within ``UV_BOUND``, and the frames against a replay
   of the recorded packets through ``LiveServer.process`` with the plain
   tail on the card and on the CPU within phase 4's bounds widened by the
   Unity text's rounding; then a ``MotionViewer`` round trip. Prints frames
   per second, the relay-to-Unity latency, ``ImuCamStream.tick``'s host
   time, IMU packets against resampler ticks, and the ring drops;
13. dynamics and display (``dynamics/``, ``viz/``, ``eval/visualize.py``,
   ``compat``): (a) ``RigidBodyDynamics`` (``torch.func``) on the
   6890-vertex body at three seeded states in float32 and float64, card
   against CPU (float64 within ``DYN_F64_REL``, float32 ``M`` and ``h``
   within ``DYN_F32_REL``, forward dynamics by its residual), ``M``
   symmetric and positive definite, free fall near -9.81, each function's
   ms and synchronizing calls a call; (b) ``run_single_view`` with the
   serve kernel on phase 7's fixture sequence against the kernels off
   within phase 4's bounds (its launches counted into the kernel line),
   then refined by SMPLify, and ``view_aist`` at 1920x1080 over two frames
   (default configuration) with the skinning's and the host renderer's
   seconds a frame; (c) ``view_aist_unity`` against the same call on the
   CPU, through the Unity text; (d) the ``compat`` facade's calls on the
   card.

It prints a JSON line with every kernel's numbers, and as its last line
``{"ok": true, "device": {...}}``. Without a card it exits nonzero before
printing any result.
"""

from __future__ import annotations

import dataclasses
import functools
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


def lstm_split(ts, T):
    r"""One launch's timestamps (``lstm_scan.ts_slots``, block 0's
    %globaltimer in ns) as microseconds: the pre-pass (linear1 and U0, each
    with its barrier), when the resident weights had landed (from the
    start), the steps (median of a step, of its work and of its barrier's
    wait), linear2 and the launch."""
    ts = np.asarray(ts, np.float64)
    done, passed = ts[6:6 + 2 * (T + 1):2], ts[7:7 + 2 * (T + 1):2]
    step = np.diff(np.concatenate([ts[5:6], passed]))
    return {"prepass": (ts[4] - ts[0]) / 1e3,
            "linear1": (ts[1] - ts[0]) / 1e3,
            "u0": (ts[3] - ts[2]) / 1e3,
            "weights_landed": (ts[5] - ts[0]) / 1e3,
            "weights_wait": (ts[5] - ts[4]) / 1e3,
            "step": float(np.median(step)) / 1e3,
            "step_work": float(np.median(done - np.concatenate(
                [ts[5:6], passed[:-1]]))) / 1e3,
            "step_barrier": float(np.median(passed - done)) / 1e3,
            "steps": (passed[-1] - ts[5]) / 1e3,
            "linear2": (ts[8 + 2 * T] - passed[-1]) / 1e3,
            "launch": (ts[8 + 2 * T] - ts[0]) / 1e3,
            "barriers": 2 + (T + 1)}


def check_lstm(params, dev, gen):
    import torch
    from robustcap_tpu_torch.ops import lstm_scan as L
    rows = {}
    for name, n_in in (("rnn2", 72), ("rnn3", 141)):
        p = params[name]
        ops = L.prepare_lstm_scan(p)   # as StreamingNet prepares it
        H = p["layers"][0]["w_hh"].shape[1]
        n_out = p["linear2"]["w"].shape[0]
        T = 256
        xs = torch.randn(T, n_in, generator=gen).to(dev)
        state = tuple((0.5 * torch.randn(2, H, generator=gen)).to(dev)
                      for _ in range(2))
        ys, (h, c) = L.rnn_scan_chunked(ops, xs, state)
        ys_p, (h_p, c_p) = L.rnn_scan_plain(p, xs, state)
        y1, st1 = L.rnn_scan_chunked(ops, xs[:100], state)
        y2, (h2, c2) = L.rnn_scan_chunked(ops, xs[100:], st1)
        raw = L.rnn_scan_chunked(p, xs, state)
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
        _require(all(torch.equal(a, b) for a, b in
                     ((raw[0], ys), (raw[1][0], h), (raw[1][1], c))),
                 f"lstm_scan {name}: raw params and prepare_lstm_scan give "
                 "other bits")

        ms = _time_ms(lambda: L.rnn_scan_chunked(ops, xs, state), reps=20)
        plain_ms = _time_graph_ms(lambda: L.rnn_scan_plain(p, xs, state),
                                  reps=2)
        plain_eager_ms = _time_ms(lambda: L.rnn_scan_plain(p, xs, state),
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

        # one more launch with the timestamp buffer: the in-launch split
        ts = torch.zeros(L.ts_slots(T), dtype=torch.int64, device=dev)
        L.rnn_scan_chunked(ops, xs, state, timestamps=ts)
        torch.cuda.synchronize()
        sp = lstm_split(ts.cpu().tolist(), T)
        plan = L._device_plan(ops, dev)[0]
        print(f"[lstm_scan] {name} T={T}, in-launch split (block 0's "
              f"%globaltimer): launch {sp['launch']:.1f} us, "
              f"{sp['barriers']} grid barriers; pre-pass {sp['prepass']:.1f} "
              f"us (linear1 {sp['linear1']:.1f}, U0 {sp['u0']:.1f}); resident "
              f"weights landed {sp['weights_landed']:.1f} us after the start "
              f"(waited {sp['weights_wait']:.1f}); {T + 1} steps "
              f"{sp['steps']:.1f} us, a step median {sp['step']:.2f} us = "
              f"work {sp['step_work']:.2f} + barrier {sp['step_barrier']:.2f};"
              f" linear2 {sp['linear2']:.1f} us; plan {plan['blocks']} blocks, "
              f"{int(plan['resident'].max())} bytes of weights resident a "
              f"block (copied once a launch), {plan['layout']['total']} bytes "
              f"of shared memory", flush=True)
        rows[name]["split"] = sp
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
# Phase 6: the batched step
# ---------------------------------------------------------------------------

# rows of the phase-6 batch: (seed, length, ground-truth first translation,
# first_frame)
_BATCH_ROWS = ((11, 256, True, False), (12, 256, False, True),
               (13, 256, False, False), (14, 200, False, False))
BATCH_B, BATCH_T = 512, 512      # the timed shape at full width


def _batched_frames(rows, T, dev):
    r"""Stacked frames ``[B, T, ...]`` on ``dev`` (a row's padding repeats
    its last frame) and each row's (inputs, first_tran, first_frame)."""
    import torch
    from robustcap_tpu_torch.models.sig_mp import DEFAULT_GRAVITY
    out = {k: [] for k in ("j2dc", "accc", "oric", "first_tran",
                           "first_tran_valid", "first_frame", "gravityc")}
    singles = []
    for seed, n, gt, first in rows:
        inputs = _stream_inputs(seed, _mixed(n, seed))
        ft = np.asarray([0.1, -0.2, 3.0], np.float32) if gt else None
        singles.append((inputs, ft, first))
        for k, x in zip(("j2dc", "accc", "oric"), inputs):
            out[k].append(np.concatenate([x, np.repeat(x[-1:], T - n, 0)]))
        out["first_tran"].append(np.tile(ft if gt else np.zeros(3,
                                                               np.float32),
                                         (T, 1)))
        out["first_tran_valid"].append((np.arange(T) == 0) & gt)
        out["first_frame"].append((np.arange(T) == 0) & first)
        out["gravityc"].append(np.tile(DEFAULT_GRAVITY, (T, 1)))
    frames = {k: torch.from_numpy(np.stack(v)).to(dev)
              for k, v in out.items()}
    return frames, singles


def _time_batched(sig_mp, params, model, cfg, frames, dev):
    r"""Device time of one ``forward_offline_batched`` run under
    ``set_sync_debug_mode("error")`` (CUDA events; a run that reads a value
    back to the host raises), after a warm-up of 8 frames."""
    import torch
    warm = {k: v[:, :8] for k, v in frames.items()}
    sig_mp.forward_offline_batched(params, model, cfg, warm, device=dev)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        start.record()
        pose, tran = sig_mp.forward_offline_batched(params, model, cfg,
                                                    frames, device=dev)
        end.record()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return start.elapsed_time(end), pose, tran


def _profile_batched(sig_mp, params, model, cfg, frames, dev):
    r"""Kernel launches, device busy time and the four kernels with the
    most device time, per frame-step of ``forward_offline_batched``, from
    ``torch.profiler`` (the device-side events only, each kernel's time
    once): the difference between runs over 12 and 4 frames, over 8, so
    that the prescan and the set-up cancel. ``None`` where the profiler
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def totals(n):
        short = {k: v[:, :n] for k, v in frames.items()}
        sig_mp.forward_offline_batched(params, model, cfg, short, device=dev)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sig_mp.forward_offline_batched(params, model, cfg, short,
                                           device=dev)
            torch.cuda.synchronize()
        events = prof.key_averages()
        # the operators that launch kernels carry their kernels' time too:
        # count the device-side events alone
        by_op = {e.key: getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0))
                 for e in events if str(e.device_type).endswith("CUDA")
                 and not getattr(e, "is_user_annotation", False)}
        launches = sum(e.count for e in events
                       if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                    "cuLaunchKernel", "cuLaunchKernelEx"))
        return launches, by_op

    (k4, ops4), (k12, ops12) = totals(4), totals(12)
    per_op = {k: (v - ops4.get(k, 0)) / 1e3 / 8 for k, v in ops12.items()}
    busy = sum(per_op.values())
    if busy <= 0:
        return None
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:4]
    return (k12 - k4) / 8, busy, top


def _int8_product_ms(qparams, B, dev):
    r"""Device time of one frame-step's exact int8 gate products at batch
    ``B`` (``nn.rnn._dot_i8``, a float64 matmul on the card): every gate
    matrix of the stacks the batched step evaluates, rnn7 and rnn8 twice
    (speculative and final heads)."""
    import torch
    from robustcap_tpu_torch.nn.rnn import _dot_i8
    evals = ("rnn2", "rnn3", "rnn4", "rnn6", "rnn7", "rnn8", "rnn7", "rnn8")
    gen = torch.Generator(device=dev).manual_seed(0)
    ops = []
    for name in evals:
        for layer in qparams[name]["layers"]:
            for w in (layer["w_ih"], layer["w_hh"]):
                x = torch.randint(-127, 128, (B, w["q"].shape[1]),
                                  generator=gen, device=dev,
                                  dtype=torch.int8)
                ops.append((x, w["q"]))
    ms = _time_ms(lambda: [_dot_i8(x, w) for x, w in ops], reps=5)
    n_ops = sum(2 * x.shape[0] * w.shape[0] * w.shape[1] for x, w in ops)
    return ms, n_ops


def check_batched(params, model, dev):
    r"""Phase 6: the batched step against the single-stream path on the
    card, then its rate at full width in each weight mode."""
    import torch
    from robustcap_tpu_torch.config import SigMPConfig
    from robustcap_tpu_torch.models import sig_mp

    T = max(n for _, n, _, _ in _BATCH_ROWS)
    frames, singles = _batched_frames(_BATCH_ROWS, T, dev)
    lengths = [n for _, n, _, _ in _BATCH_ROWS]
    sig_mp.forward_offline_batched(params, model, SigMPConfig(),
                                   {k: v[:, :2] for k, v in frames.items()},
                                   device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pose_b, tran_b = sig_mp.forward_offline_batched(
            params, model, SigMPConfig(), frames, lengths=lengths,
            device=dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ok = True
    for b, ((inputs, ft, first), (_, n, _, _)) in enumerate(
            zip(singles, _BATCH_ROWS)):
        one = sig_mp.forward_offline(params, model, SigMPConfig(), *inputs,
                                     first_tran=ft, first_frame=first,
                                     device=dev)
        seeded = ("GT first translation" if ft is not None
                  else "first frame" if first else "no seed")
        ok &= _compare(
            f"batched B={len(_BATCH_ROWS)} row {b} (T={n}, {seeded}) vs "
            "forward_offline (card, plain)",
            (pose_b[b, :n].cpu(), tran_b[b, :n].cpu()),
            tuple(x.cpu() for x in one), (64, 128, n))
    _require(ok, "batched step outside its bounds against the single-stream "
             "path (see the lines above)")

    # the rate at full width, each weight mode
    big, _ = _batched_frames(
        [(20 + i % 4, BATCH_T, i % 3 == 0, i % 3 == 1)
         for i in range(BATCH_B)], BATCH_T, dev)
    rates = {}
    for mode, p, cfg in _serve_modes(params):
        torch.cuda.reset_peak_memory_stats()
        ms, pose, tran = _time_batched(sig_mp, p, model, cfg, big, dev)
        _require(bool(torch.isfinite(pose).all())
                 and bool(torch.isfinite(tran).all()),
                 f"batched {mode}: non-finite output")
        fps = BATCH_B * BATCH_T / (ms / 1e3)
        rates[mode] = dict(ms=ms, frames_per_s=fps)
        print(f"[batched] {mode}: B={BATCH_B} T={BATCH_T} in {ms:.1f} ms "
              f"(CUDA events, no host sync: set_sync_debug_mode('error')): "
              f"{fps:.1f} frames/s, {ms / BATCH_T:.3f} ms per frame-step; "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
              "GiB", flush=True)
        del pose, tran
        prof = _profile_batched(sig_mp, p, model, cfg, big, dev)
        if prof is None:
            print(f"[batched] {mode}: device busy time not measured (the "
                  "profiler recorded no device time)", flush=True)
        else:
            n_k, busy, top = prof
            print(f"[batched] {mode}: {n_k:.0f} kernel launches and "
                  f"{busy:.3f} ms of device time per frame-step "
                  f"(torch.profiler); device idle "
                  f"{(1 - busy / (ms / BATCH_T)) * 100:.1f}% of the timed "
                  "frame-step; most device time: "
                  + "; ".join(f"{name[:60]} {t:.3f} ms" for name, t in top),
                  flush=True)
    q = _serve_modes(params)[2][1]
    i8_ms, i8_ops = _int8_product_ms(q, BATCH_B, dev)
    print(f"[batched] int8 at B={BATCH_B}: the exact gate products "
          f"(float64 matmuls, {i8_ops / 1e9:.1f} G operations) "
          f"take {i8_ms:.3f} ms a frame-step, "
          f"{i8_ms / (rates['int8']['ms'] / BATCH_T) * 100:.1f}% of the int8 "
          "step", flush=True)
    rates["int8_product_ms_per_step"] = i8_ms
    return rates


# ---------------------------------------------------------------------------
# Phase 7: the offline evaluation and the serving modes' end-metric contract
# ---------------------------------------------------------------------------

EVAL_SEQ, EVAL_CAM, EVAL_T, EVAL_SEED = 1, 2, 64, 5
# batched and single-stream trajectories scored by the same code: their
# metrics may differ by the float32 paths' disagreement only
EVAL_AGREE_MM = 0.5


def check_eval(params, model, dev):
    r"""Phase 7: ``evaluate_sequences`` (the batched runner) on a fixture
    corpus, then ``serve_end_metric_deltas`` in bf16 and int8, whose
    changes from float32 must stay inside ``END_METRIC_BOUND_MM``. Returns
    the serve-kernel launches of the phase by mode."""
    import warnings

    import torch
    from robustcap_tpu_torch.eval import (END_METRIC_BOUND_MM,
                                          build_aist_sequences,
                                          evaluate_sequences,
                                          serve_end_metric_deltas)
    from robustcap_tpu_torch.ops import serve_scan
    from robustcap_tpu_torch.preprocess import build_fixture_dataset

    ds = build_fixture_dataset(model, n_seq=EVAL_SEQ, T=EVAL_T, n_cam=EVAL_CAM,
                               seed=EVAL_SEED)
    seqs = build_aist_sequences(ds, num_cameras=EVAL_CAM)
    with warnings.catch_warnings():
        # the procedural body's regressor stands in for the H36M asset
        warnings.simplefilter("ignore")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = evaluate_sequences(seqs, params, model,
                                 pad_to_multiple=EVAL_T, device=dev)
        secs = time.perf_counter() - t0
        metrics = {k: out[k] * 1e3 for k in ("mpjpe", "pve", "pampjpe")}
        _require(all(np.isfinite(v) for v in metrics.values()),
                 f"evaluate_sequences: non-finite metrics {metrics}")
        print(f"[eval] evaluate_sequences on {len(seqs)} fixture sequences "
              f"of {EVAL_T} frames (seed {EVAL_SEED}, random weights): "
              + ", ".join(f"{k} {v:.3f} mm" for k, v in metrics.items())
              + f"; tran error {out['tran_error'] * 1e3:.3f} mm; "
              f"{secs:.2f} s with scoring (host clock)", flush=True)

        # one mode a call, so that each mode's serve launches are counted
        launches, deltas = {}, {}
        for mode in ("bf16", "int8"):
            serve_scan.LAUNCHES = 0
            q = serve_end_metric_deltas(params, model, eval_frames=EVAL_T,
                                        n_seq=EVAL_SEQ, n_cam=EVAL_CAM,
                                        modes=(mode,), seed=EVAL_SEED,
                                        device=dev)
            launches[f"serve_scan_{mode}"] = serve_scan.LAUNCHES
            deltas[mode] = q[f"pallas_serve_{mode}_delta_mm"]
    print(f"[eval] serve_end_metric_deltas: float32 {q['f32_mm']} mm; "
          f"bf16 delta {deltas['bf16']} mm, int8 delta {deltas['int8']} mm "
          f"(bound {END_METRIC_BOUND_MM} mm); serve launches {launches}",
          flush=True)
    for mode, delta in deltas.items():
        _require(launches[f"serve_scan_{mode}"] == len(seqs),
                 f"serve kernel {mode}: expected one launch per sequence, "
                 f"got {launches[f'serve_scan_{mode}']}")
        for k, v in delta.items():
            _require(abs(v) < END_METRIC_BOUND_MM,
                     f"serve kernel {mode}: {k} moved {v} mm from float32, "
                     f"outside the {END_METRIC_BOUND_MM} mm contract")
    for k, v in q["f32_mm"].items():
        _require(abs(v - metrics[k]) < EVAL_AGREE_MM,
                 f"{k}: batched {metrics[k]:.3f} mm against single-stream "
                 f"{v:.3f} mm (bound {EVAL_AGREE_MM} mm)")
    return launches


# ---------------------------------------------------------------------------
# Phase 8: serving on the card
# ---------------------------------------------------------------------------

BUNDLE_DIR = "_serving_bundles"     # gitignored, removed after the phase
CHUNKS = (128, 256)
GRAPH_BOUND = 1e-6    # a graph replays the same kernels on the same inputs
STEP_FILE_MAX = 16 << 20   # step.pt2 holds the program, not the weights
MUX_CAP, MUX_TICKS, MUX_RESET = 8, 128, (64, 3)   # reset slot 3 at tick 64
LIVE_FRAMES = 120


def _sync_time(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _profile_top(fn, n, k=5):
    r"""``(kernels and copies, device ms summed, device ms busy, top k by
    device time as (name, ms, calls))`` per call of ``fn`` over ``n``
    calls (``torch.profiler``); "busy" is the union of the kernels' time
    ranges, which overlap where work runs on several streams. ``None``
    where the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()

    def on_device(e):
        return (str(e.device_type).endswith("CUDA")
                and not getattr(e, "is_user_annotation", False))

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    events = [e for e in prof.key_averages() if on_device(e)]
    summed = sum(dev_us(e) for e in events) / 1e3 / n
    if summed <= 0:
        return None
    busy, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events() if on_device(e)):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    top = sorted(events, key=dev_us, reverse=True)[:k]
    return (sum(e.count for e in events) / n, summed, busy / 1e3 / n,
            [(e.key[:56], round(dev_us(e) / 1e3 / n, 3), e.count // n)
             for e in top])


def _device_busy(fn, n):
    r"""``(kernels, device ms)`` per call of ``fn`` over ``n`` calls, from
    ``torch.profiler``'s device-side events (each kernel and copy once,
    summed), or ``None`` where the profiler records no device time."""
    prof = _profile_top(fn, n)
    return None if prof is None else prof[:2]


def _busy_text(prof, host_ms):
    if prof is None:
        return "device time not measured (no device events)"
    n, busy = prof
    return (f"{n:.0f} kernels and copies, {busy:.3f} ms of device time a "
            f"call (torch.profiler): device idle "
            f"{max(0.0, 1 - busy / host_ms) * 100:.1f}%")


def _export_and_load(mode, p, cfg, model, dev, root):
    r"""Phase 8 (a): one bundle exported and loaded, with its seconds and
    file sizes printed; ``step.pt2`` must not hold the weights."""
    from robustcap_tpu_torch.serving import (ServingBundle,
                                             export_serving_bundle)
    path = os.path.join(root, mode)
    _, t_exp = _sync_time(lambda: export_serving_bundle(
        p, model, cfg, path, chunk_len=CHUNKS[0],
        extra_chunk_lens=CHUNKS[1:], device=dev))
    bundle, t_load = _sync_time(lambda: ServingBundle.load(path, device=dev))
    sizes = {f: os.path.getsize(os.path.join(path, f))
             for f in sorted(os.listdir(path))}
    print(f"[serving] {mode} bundle: export {t_exp:.2f} s, load {t_load:.2f} "
          f"s; files (bytes) {sizes}", flush=True)
    _require(sizes["step.pt2"] < min(STEP_FILE_MAX, sizes["weights.pt"] / 8),
             f"{mode} bundle: step.pt2 ({sizes['step.pt2']} bytes) grows "
             "with the weights")
    return bundle


def _bundle_chunks(mode, bundle, p, cfg, model, dev, stream):
    r"""Phase 8 (b): a first frame (seeded as ``run_stream`` seeds it), then
    the 128- and 256-frame chunk programs, each bit for bit
    ``StreamingNet(pallas_serve)`` from the same carry. Returns the
    stream's outputs and the serve launches."""
    import torch
    from robustcap_tpu_torch.device import tree_map
    from robustcap_tpu_torch.models import sig_mp
    from robustcap_tpu_torch.ops import serve_scan
    from robustcap_tpu_torch.serving import _unbatch
    first, chunks = stream
    bundle.reset_states()
    pose0, tran0 = bundle.forward_online(first[0][0], first[1][0],
                                         first[2][0],
                                         first_tran=np.zeros(3, np.float32),
                                         first_frame=True)
    net = sig_mp.StreamingNet(p, model, cfg, device=dev)
    net.carry = tree_map(torch.clone, _unbatch(bundle.carry))
    outs, times = [(pose0[None], tran0[None])], []
    serve_scan.LAUNCHES = 0
    for _, chunk in chunks:
        out, sec = _sync_time(lambda: bundle.forward_chunk(*chunk))
        outs.append(out)
        times.append(sec)
    launches = serve_scan.LAUNCHES
    _require(launches == len(chunks), f"{mode} bundle: {launches} serve "
             f"launches over {len(chunks)} chunk programs")
    for (_, chunk), got in zip(chunks, outs[1:]):
        want = net.forward_chunk(*chunk)
        _require(all(torch.equal(g, w) for g, w in zip(got, want)),
                 f"{mode} bundle: a {len(chunk[0])}-frame chunk program "
                 "differs from StreamingNet(pallas_serve) on the same carry")
    print(f"[serving] {mode} bundle chunks "
          + ", ".join(f"{len(c[0])} frames {t * 1e3:.3f} ms"
                      for (_, c), t in zip(chunks, times))
          + f" (host clock, synchronized; {launches} serve launches), equal "
          "bit for bit to StreamingNet(pallas_serve)", flush=True)
    return tuple(torch.cat(x).cpu() for x in zip(*outs)), launches


def _bundle_online(mode, bundle, p, cfg, model, dev, seq):
    r"""Phase 8 (c): ``forward_online`` over the sequence, graphed, against
    the eager exported step; the three ways timed (host clock,
    synchronized, the frames after the first). Returns the graphed
    outputs."""
    import torch
    from robustcap_tpu_torch.device import tree_map
    from robustcap_tpu_torch.models import sig_mp
    from robustcap_tpu_torch.serving import _online_frame
    j2, ac, orc = seq
    T = len(j2)

    def graphed():
        return [bundle.forward_online(j2[t], ac[t], orc[t],
                                      first_frame=t == 0) for t in range(T)]

    def eager():
        carry = sig_mp.init_carry(bundle.params, batch_shape=(1,))
        outs = []
        for t in range(T):
            frame = tree_map(lambda x: x.to(dev), _online_frame(
                j2[t], ac[t], orc[t], first_frame=t == 0))
            if t == 0:
                carry = bundle.prescan_fn(bundle.scan_params, carry, frame)
            carry, (pose, tran) = bundle.step_fn(bundle.scan_params, carry,
                                                 frame)
            outs.append((pose[0], tran[0]))
        return outs

    def streaming():
        net = sig_mp.StreamingNet(p, model, cfg, device=dev)
        return [net.forward_online(j2[t], ac[t], orc[t], first_frame=t == 0)
                for t in range(T)]

    bundle.reset_states()
    res = {}
    for name, fn in (("graphed step", graphed), ("eager exported step",
                                                 eager),
                     ("eager StreamingNet", streaming)):
        outs, sec = _sync_time(fn)
        res[name] = (tuple(torch.stack(x).cpu() for x in zip(*outs)), sec)
    gap = max(_max_err(a, b) for a, b in zip(res["graphed step"][0],
                                             res["eager exported step"][0]))
    prof = _device_busy(lambda: bundle.forward_online(j2[1], ac[1], orc[1]),
                        16)
    print(f"[serving] {mode} forward_online, {T} frames: "
          + ", ".join(f"{k} {sec / T * 1e3:.3f} ms/frame"
                      for k, (_, sec) in res.items())
          + f" (host clock, synchronized, graph captured before); graphed vs "
          f"eager exported max abs {gap:.3e} (bound {GRAPH_BOUND:.0e}); "
          "graphed frame: " + _busy_text(
              prof, res["graphed step"][1] / T * 1e3), flush=True)
    _require(gap <= GRAPH_BOUND, f"{mode} bundle: graphed and eager steps "
             f"differ by {gap:.3e}")
    return res["graphed step"][0]


def _check_multiplexer(params, model, dev):
    r"""Phase 8 (d): capacity 8 for 128 ticks over 8 mixed streams, slot 3
    reset at tick 64 with a new first frame, each row held against its own
    plain ``StreamingNet``; ms per tick, eager and graphed, at capacity 8
    and 64."""
    import torch
    from robustcap_tpu_torch.config import SigMPConfig
    from robustcap_tpu_torch.models import sig_mp
    from robustcap_tpu_torch.nn.rnn import prepare_scan_params
    from robustcap_tpu_torch.streaming import StreamingMultiplexer
    cfg = SigMPConfig()
    tick_r, slot_r = MUX_RESET
    streams = [_stream_inputs(30 + k, _mixed(MUX_TICKS, 30 + k))
               for k in range(MUX_CAP)]
    late = _stream_inputs(40, _mixed(MUX_TICKS - tick_r, 40))
    mux = StreamingMultiplexer(params, model, cfg, capacity=MUX_CAP,
                               device=dev)
    _require([mux.open_slot() for _ in range(MUX_CAP)]
             == list(range(MUX_CAP)), "multiplexer slots out of order")
    poses, trans = [], []
    for t in range(MUX_TICKS):
        rows = [s if not (k == slot_r and t >= tick_r) else None
                for k, s in enumerate(streams)]
        first = np.zeros(MUX_CAP, bool)
        if t == tick_r:
            mux.close_slot(slot_r)
            _require(mux.open_slot() == slot_r, "the reset slot moved")
            first[slot_r] = True
        first |= t == 0
        batch = [np.stack([(r[i][t] if r is not None else
                            late[i][t - tick_r]) for r in rows])
                 for i in range(3)]
        pose, tran = mux.step(*batch, first_frame=first if first.any()
                              else None)
        poses.append(pose)
        trans.append(tran)
    poses, trans = np.stack(poses), np.stack(trans)
    ok = True
    refs = [(k, 0, s) for k, s in enumerate(streams)] + [(slot_r, tick_r,
                                                          late)]
    for k, t0, (j2, ac, orc) in refs:
        t1 = tick_r if (k == slot_r and t0 == 0) else MUX_TICKS
        net = sig_mp.StreamingNet(params, model, cfg, device=dev)
        outs = [net.forward_online(j2[t], ac[t], orc[t], first_frame=t == 0)
                for t in range(t1 - t0)]
        ref = tuple(torch.stack(x).cpu() for x in zip(*outs))
        got = (torch.from_numpy(poses[t0:t1, k]),
               torch.from_numpy(trans[t0:t1, k]))
        ok &= _compare(f"multiplexer row {k}, ticks {t0}-{t1 - 1}, vs plain "
                       "StreamingNet (card)", got, ref)
    _require(ok, "multiplexer rows outside their bounds")

    sp = prepare_scan_params(params, cfg.int8_compute)
    step = sig_mp.make_batched_step(model, cfg)
    for cap in (MUX_CAP, 64):
        m = StreamingMultiplexer(params, model, cfg, capacity=cap, device=dev)
        ins = [_stream_inputs(50 + k, _mixed(9, 50 + k)) for k in range(cap)]
        batch = [lambda t, i=i: np.stack([s[i][t] for s in ins])
                 for i in range(3)]
        m.step(*(b(0) for b in batch), first_frame=np.ones(cap, bool))
        m.step(*(b(1) for b in batch))
        _, g_sec = _sync_time(lambda: [m.step(*(b(t) for b in batch))
                                       for t in range(2, 9)])
        prof = _device_busy(lambda: m.step(*(b(8) for b in batch)), 8)
        frames = {k: v.to(dev) for k, v in {
            "j2dc": torch.from_numpy(batch[0](2)),
            "accc": torch.from_numpy(batch[1](2)),
            "oric": torch.from_numpy(batch[2](2)),
            "first_tran": torch.zeros(cap, 3),
            "gravityc": torch.from_numpy(np.tile(sig_mp.DEFAULT_GRAVITY,
                                                 (cap, 1))),
            "first_frame": torch.zeros(cap, dtype=torch.bool),
            "first_tran_valid": torch.zeros(cap, dtype=torch.bool)}.items()}
        carry = m.carries
        step(sp, carry, frames)
        _, e_sec = _sync_time(lambda: [step(sp, carry, frames)
                                       for _ in range(7)])
        print(f"[serving] multiplexer capacity {cap}: graphed tick "
              f"{g_sec / 7 * 1e3:.3f} ms (frames up, pose and tran back to "
              f"the host), eager step {e_sec / 7 * 1e3:.3f} ms (host clock, "
              "synchronized); graphed tick: "
              + _busy_text(prof, g_sec / 7 * 1e3), flush=True)


def _check_latency(params, model, dev, root):
    r"""Phase 8 (e): ``measure_streaming_latency`` with ``live_mode()`` and
    the tail kernel, 600 frames, then with the kernels off; a short traced
    run. Returns the tail launches."""
    from robustcap_tpu_torch.config import SigMPConfig
    from robustcap_tpu_torch.ops import geometry_tail
    from robustcap_tpu_torch.streaming import measure_streaming_latency
    on = dataclasses.replace(SigMPConfig.live_mode(), pallas_tail=True)
    geometry_tail.LAUNCHES = 0
    stats_on = measure_streaming_latency(params, model, cfg=on, n_frames=600,
                                         device=dev)
    launches = geometry_tail.LAUNCHES
    _require(launches == 630, f"latency harness: {launches} tail launches, "
             "expected one per frame (30 warm-up + 600)")
    stats_off = measure_streaming_latency(params, model, n_frames=600,
                                          device=dev)
    for name, st in (("live_mode + pallas_tail", stats_on),
                     ("live_mode, kernels off", stats_off)):
        _require(all(np.isfinite(v) for v in st.values()),
                 f"latency {name}: {st}")
        print(f"[serving] latency {name}, 600 frames: p50 "
              f"{st['p50_ms']:.3f} ms, p95 {st['p95_ms']:.3f}, p99 "
              f"{st['p99_ms']:.3f}, mean {st['mean_ms']:.3f}, "
              f"{st['fps']:.1f} fps (host clock, tran read back)", flush=True)
    trace_dir = os.path.join(root, "trace")
    measure_streaming_latency(params, model, cfg=on, n_frames=8, warmup=2,
                              trace_dir=trace_dir, device=dev)
    with open(os.path.join(trace_dir, "trace.json")) as f:
        trace = json.load(f)
    kernels = sum(1 for e in trace.get("traceEvents", [])
                  if e.get("cat") == "kernel")
    print(f"[serving] latency trace of 8 frames: {kernels} kernel events",
          flush=True)
    _require(kernels > 0, "the latency trace holds no kernel event")
    return launches


def _check_live_server(bundle, model, dev):
    r"""Phase 8 (f): ``run_live_demo`` in a thread on free local ports with
    the bundle as its net; detector packets from a fixture sequence, one
    frame back for each."""
    import socket
    import threading
    from robustcap_tpu_torch.config import LiveConfig
    from robustcap_tpu_torch.eval import build_aist_sequences
    from robustcap_tpu_torch.preprocess import build_fixture_dataset
    from robustcap_tpu_torch.streaming import (encode_detector_packet,
                                               parse_unity_frame,
                                               run_live_demo)

    def free(kind):
        with socket.socket(socket.AF_INET, kind) as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    seq = build_aist_sequences(build_fixture_dataset(
        model, n_seq=1, T=LIVE_FRAMES, n_cam=1, seed=EVAL_SEED),
        num_cameras=1)[0]
    live = LiveConfig(detector_udp_port=free(socket.SOCK_DGRAM),
                      unity_tcp_port=free(socket.SOCK_STREAM))
    server = threading.Thread(target=run_live_demo, daemon=True, kwargs=dict(
        net=bundle, live=live, max_frames=LIVE_FRAMES, device=dev))
    server.start()
    unity, deadline = None, time.time() + 60
    while unity is None:
        try:
            unity = socket.create_connection(
                ("127.0.0.1", live.unity_tcp_port), timeout=10)
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.1)
    rcm = np.eye(3, dtype=np.float32)
    frames, buf = [], b""
    with unity, socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
        unity.settimeout(60)
        t0 = time.perf_counter()
        for t in range(LIVE_FRAMES):
            tx.sendto(encode_detector_packet(seq.j2dc[t], seq.oric[t],
                                             seq.accc[t], rcm),
                      ("127.0.0.1", live.detector_udp_port))
            while b"$" not in buf:
                chunk = unity.recv(65536)
                _require(bool(chunk), "the live server closed the stream")
                buf += chunk
            frame, _, buf = buf.partition(b"$")
            frames.append(parse_unity_frame(frame + b"$"))
        sec = time.perf_counter() - t0
    server.join(timeout=60)
    _require(not server.is_alive(), "the live server did not stop")
    _require(len(frames) == LIVE_FRAMES, f"live server: {len(frames)} "
             f"frames back for {LIVE_FRAMES} packets")
    trans = np.stack([f[1] for f in frames])
    _require(np.isfinite(trans).all() and np.isfinite(
        np.stack([f[0] for f in frames])).all(), "live server: non-finite")
    _require(float(np.abs(trans[0]).max()) <= 1e-4,
             f"live server: first translation {trans[0]}, expected 0")
    print(f"[serving] live server over loopback (bundle f32, graphed): "
          f"{LIVE_FRAMES} packets -> {len(frames)} frames, first translation "
          f"{trans[0].tolist()}, {LIVE_FRAMES / sec:.1f} fps (packet out to "
          "frame back, one at a time)", flush=True)


def check_serving(params, model, dev):
    r"""Phase 8: serving bundles in f32, bf16 and int8 exported and loaded
    (a), their chunk programs against ``StreamingNet(pallas_serve)`` (b),
    ``forward_online`` graphed against eager (c), the multiplexer (d), the
    latency harness (e), the live server over loopback (f). Returns the
    phase's serve launches by mode and its tail launches."""
    import shutil

    import torch
    from robustcap_tpu_torch.config import SigMPConfig
    from robustcap_tpu_torch.models import sig_mp
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        BUNDLE_DIR)
    shutil.rmtree(root, ignore_errors=True)
    t_start = time.perf_counter()
    launches, bundles = {}, {}
    stream = (_stream_inputs(21, [0.95]),
              [(f"chunk {K}", _stream_inputs(21 + K, _mixed(K, 21 + K)))
               for K in CHUNKS])
    seq = _stream_inputs(24, _mixed(256, 24))
    try:
        for mode, p, mode_cfg in _serve_modes(params):
            cfg = dataclasses.replace(mode_cfg, pallas_serve=True)
            bundle = _export_and_load(mode, p, cfg, model, dev, root)
            bundles[mode] = bundle
            out, n = _bundle_chunks(mode, bundle, p, cfg, model, dev, stream)
            launches["serve_scan" if mode == "f32"
                     else f"serve_scan_{mode}"] = n
            online = _bundle_online(mode, bundle, p, mode_cfg, model, dev,
                                    seq)
            if mode == "f32":
                plain, _ = run_stream(sig_mp.StreamingNet(
                    params, model, SigMPConfig(), device=dev), stream[0],
                    stream[1])
                ok = _compare("f32 bundle, first frame + chunks vs plain "
                              "StreamingNet (card)", out, plain, CHUNKS)
                net = sig_mp.StreamingNet(params, model, SigMPConfig(),
                                          device=dev)
                ref = [net.forward_online(seq[0][t], seq[1][t], seq[2][t],
                                          first_frame=t == 0)
                       for t in range(len(seq[0]))]
                ok &= _compare("f32 bundle, forward_online graphed vs plain "
                               "StreamingNet (card)", online,
                               tuple(torch.stack(x).cpu() for x in zip(*ref)),
                               (64, 128, 256))
                _require(ok, "f32 bundle outside its bounds")
        _check_multiplexer(params, model, dev)
        launches["geometry_tail"] = _check_latency(params, model, dev, root)
        _check_live_server(bundles["f32"], model, dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[serving] phase 8 in {time.perf_counter() - t_start:.1f} s; "
          f"launches {launches}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 9: SMPLify on the card
# ---------------------------------------------------------------------------

# a float64 refinement on the card against the same on the CPU: within a
# tenth of the card's own move (in float32 a start moved by one ulp can
# move the result by more than that, so float32 runs are printed, not held)
SMPLIFY_SHARE = 0.1
# the JAX bench's SMPLify shape (bench.py, run_smplify) and this run's seed
SMPLIFY_LANES, SMPLIFY_T, SMPLIFY_SEED, SMPLIFY_REPS = 16, 128, 7, 5


def _refine_shares(got, want, start):
    r"""(median per-joint angle between ``got`` and ``want`` over the median
    angle ``want`` moved from ``start``, and the same of the per-frame
    translations); each a list of ``(pose [T, 24, 3, 3], tran [T, 3])``."""
    import torch
    from robustcap_tpu_torch.math import angle_between

    def ang(a, b):
        return angle_between(
            torch.as_tensor(np.array(a, np.float64)).reshape(-1, 3, 3),
            torch.as_tensor(np.array(b, np.float64)).reshape(-1, 3, 3)
        ).numpy()

    def dist(a, b):
        return np.linalg.norm(np.asarray(a, np.float64)
                              - np.asarray(b, np.float64), axis=-1)

    gap = np.concatenate([ang(g[0], w[0]) for g, w in zip(got, want)])
    move = np.concatenate([ang(s[0], w[0]) for s, w in zip(start, want)])
    tgap = np.concatenate([dist(g[1], w[1]) for g, w in zip(got, want)])
    tmove = np.concatenate([dist(s[1], w[1]) for s, w in zip(start, want)])
    return (float(np.median(gap) / np.median(move)),
            float(np.median(tgap) / np.median(tmove)))


def _on_manifold(pose):
    r = np.asarray(pose, np.float64).reshape(-1, 3, 3)
    return float(np.abs(np.einsum("nab,nac->nbc", r, r) - np.eye(3)).max())


def _bench_smplify_inputs(dev, seed):
    r"""The inputs of the JAX bench's SMPLify timing: 16 lanes of 128
    frames, random poses (0.2 rad), translations near 3 m, keypoints
    around pixel 300 with confidence 0.9, identity IMUs, one camera."""
    import torch
    from robustcap_tpu_torch.math import axis_angle_to_rotation_matrix
    rng = np.random.RandomState(seed)
    B, T = SMPLIFY_LANES, SMPLIFY_T
    aa = (rng.randn(B * T * 24, 3) * 0.2).astype(np.float32)
    pose0 = axis_angle_to_rotation_matrix(torch.from_numpy(aa)).reshape(
        B, T, 24, 3, 3)
    tran0 = rng.randn(B, T, 3).astype(np.float32) * 0.1 + [0, 0, 3]
    kp = (rng.randn(B, T, 33, 3) * 50 + 300).astype(np.float32)
    kp[..., 2] = 0.9
    ori = np.broadcast_to(np.eye(3, dtype=np.float32), (B, T, 6, 3, 3))
    cam = np.broadcast_to(np.asarray([[600.0, 0, 320], [0, 600, 240],
                                      [0, 0, 1]], np.float32), (B, 3, 3))
    return [torch.as_tensor(np.ascontiguousarray(x, np.float32), device=dev)
            for x in (pose0, tran0, kp, ori, cam, np.ones((B, T)))]


def _count_syncs(fn):
    r"""The synchronizing CUDA calls during ``fn()``, as
    ``torch.cuda.set_sync_debug_mode`` reports them, counted by the source
    line that made them: ``{"file.py:line": n}``."""
    import collections
    import warnings

    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in seen
        if "synchroniz" in str(w.message))


def check_smplify(params, model, dev):
    r"""Phase 9: (a) one fixture sequence through ``forward_offline`` with
    the serve kernel, then ``smplify_runner`` on the card and on the CPU
    from that output, and the fit in float64 on both, held; (b)
    ``evaluate_sequences`` with and without SMPLify on phase 7's corpus;
    (c) the fit timed at the JAX bench's shape. Returns the serve launches
    of the phase."""
    import warnings

    import torch
    from robustcap_tpu_torch.config import SigMPConfig
    from robustcap_tpu_torch.eval import (build_aist_sequences,
                                          evaluate_sequences)
    from robustcap_tpu_torch.models import sig_mp
    from robustcap_tpu_torch.ops import lbfgs, serve_scan
    from robustcap_tpu_torch.preprocess import build_fixture_dataset
    from robustcap_tpu_torch.smpl import ParametricModel
    from robustcap_tpu_torch.smplify import (MaxMixturePrior,
                                             make_smplify_fit, smplify_runner)

    t_start = time.perf_counter()
    cpu = torch.device("cpu")
    ds = build_fixture_dataset(model, n_seq=EVAL_SEQ, T=EVAL_T, n_cam=EVAL_CAM,
                               seed=EVAL_SEED)
    seqs = build_aist_sequences(ds, num_cameras=EVAL_CAM)
    seq = seqs[0]

    # (a) the network's output for one sequence, refined on both devices
    serve_scan.LAUNCHES = 0
    pose, tran = sig_mp.forward_offline(
        params, model, SigMPConfig(pallas_serve=True), seq.j2dc, seq.accc,
        seq.oric, first_tran=seq.first_tran, gravityc=seq.gravityc,
        device=dev)
    launches = serve_scan.LAUNCHES
    _require(launches == 1, f"forward_offline: {launches} serve launches, "
             "expected 1")
    start = (pose.cpu().numpy(), tran.cpu().numpy())
    models = {"card": (model, MaxMixturePrior(device=dev), dev),
              "cpu": (ParametricModel(data=model.data, device=cpu),
                      MaxMixturePrior(device=cpu), cpu)}
    models64 = {k: (ParametricModel(data=model.data, dtype=torch.float64,
                                    device=d),
                    MaxMixturePrior(device=d, dtype=torch.float64), d)
                for k, (_, _, d) in models.items()}
    T = seq.length
    lanes = [np.asarray(x, np.float64)[None] for x in
             (start[0], start[1], seq.j2dc_px, seq.oric, seq.cam_K,
              np.ones(T))]
    for lr in (1.0, 0.001):
        runs, counts = {}, {}
        for where, (m, prior, d) in models.items():
            lbfgs.HOST_READS = lbfgs.EVALUATIONS = 0
            runs[where] = smplify_runner(
                start[0], start[1], seq.j2dc_px, seq.oric, batch_size=T,
                cam_k=seq.cam_K, lr=lr, model=m, prior=prior, device=d)
            counts[where] = (lbfgs.EVALUATIONS, lbfgs.HOST_READS)
            p, t, update = runs[where]
            _require(np.isfinite(p).all() and np.isfinite(t).all()
                     and update is not None,
                     f"smplify_runner on the {where}: non-finite or gated")
            _require(_on_manifold(p) < 1e-4, f"smplify_runner on the "
                     f"{where}: rotations off the manifold")
        f32 = _refine_shares([runs["cpu"][:2]], [runs["card"][:2]], [start])
        _, _, before, after = make_smplify_fit(
            model, models["card"][1], lr=lr)(
            *(torch.as_tensor(x, dtype=torch.float32, device=dev)
              for x in lanes))
        before, after = float(before.mean()), float(after.mean())
        _require(after <= before, f"lr {lr}: loss after {after} above loss "
                 f"before {before} on the card")
        fits = {}
        for where, (m, prior, d) in models64.items():
            pose_r, tran_r, b64, a64 = make_smplify_fit(m, prior, lr=lr)(
                *(torch.as_tensor(x, device=d) for x in lanes))
            _require(float(a64.mean()) <= float(b64.mean()),
                     f"lr {lr}, float64 on the {where}: loss after above "
                     "loss before")
            fits[where] = (pose_r[0].cpu().numpy(), tran_r[0].cpu().numpy())
        start64 = (lanes[0][0], lanes[1][0])
        f64 = _refine_shares([fits["cpu"]], [fits["card"]], [start64])
        ctl = _refine_shares([start64], [fits["card"]], [start64])
        print(f"[smplify] (a) lr {lr}: smplify_runner on the card, "
              f"{counts['card'][0]} evaluations, {counts['card'][1]} host "
              f"reads (CPU: {counts['cpu'][0]}, {counts['cpu'][1]}); "
              f"reprojection loss {before:.1f} -> {after:.1f}; float32 card "
              f"vs CPU (not held, set by rounding): pose {f32[0]:.4f}, "
              f"translation {f32[1]:.4f} of the card's move; float64 card "
              f"vs CPU: {f64[0]:.3g}, {f64[1]:.3g} (bound {SMPLIFY_SHARE}; "
              f"unrefined start {ctl[0]:.3f}, {ctl[1]:.3f})", flush=True)
        _require(max(f64) <= SMPLIFY_SHARE < min(ctl),
                 f"lr {lr}: float64 refinement on the card {f64} of its move "
                 f"from the CPU's (bound {SMPLIFY_SHARE}, control {ctl})")

    # (b) the evaluation, refined and not
    metrics = {}
    with warnings.catch_warnings():
        # the procedural body's regressor stands in for the H36M asset
        warnings.simplefilter("ignore")
        for smplify in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = evaluate_sequences(seqs, params, model,
                                     pad_to_multiple=EVAL_T,
                                     run_smplify=smplify, device=dev)
            secs = time.perf_counter() - t0
            metrics[smplify] = {k: out[k] * 1e3 for k in
                                ("mpjpe", "pve", "pampjpe", "tran_error")}
            _require(all(np.isfinite(v) for v in metrics[smplify].values()),
                     f"evaluate_sequences(run_smplify={smplify}): "
                     f"{metrics[smplify]}")
            print(f"[smplify] (b) evaluate_sequences run_smplify={smplify} "
                  f"on {len(seqs)} fixture sequences of {EVAL_T} frames: "
                  + ", ".join(f"{k} {v:.3f} mm"
                              for k, v in metrics[smplify].items())
                  + f"; {secs:.2f} s (host clock)", flush=True)
    _require(metrics[True] != metrics[False],
             "evaluate_sequences: SMPLify changed no metric")

    # (c) the fit at the JAX bench's shape
    fit = make_smplify_fit(model, models["card"][1], lr=0.001)
    inputs = _bench_smplify_inputs(dev, SMPLIFY_SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fit(*inputs)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    lbfgs.HOST_READS = lbfgs.EVALUATIONS = 0
    t0 = time.perf_counter()
    for _ in range(SMPLIFY_REPS):
        out = fit(*inputs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / SMPLIFY_REPS * 1e3
    evals = lbfgs.EVALUATIONS / SMPLIFY_REPS
    reads = lbfgs.HOST_READS / SMPLIFY_REPS
    _require(all(bool(torch.isfinite(x).all()) for x in out),
             "bench-shape fit: non-finite output")
    lbfgs.HOST_READS = 0
    syncs = _count_syncs(lambda: fit(*inputs))
    flag_reads = lbfgs.HOST_READS
    prof = _device_busy(lambda: fit(*inputs), 2)
    frames = SMPLIFY_LANES * SMPLIFY_T
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"[smplify] (c) make_smplify_fit, {SMPLIFY_LANES} lanes x "
          f"{SMPLIFY_T} frames (lr 0.001, seed {SMPLIFY_SEED}): {ms:.1f} ms "
          f"a fit (first {first_s * 1e3:.1f} ms), {frames / ms * 1e3:.1f} "
          f"frames/s (host clock, synchronized); {evals:.0f} batched "
          f"evaluations and {reads:.0f} host reads a fit; "
          f"{sum(syncs.values())} synchronizing calls in one fit under "
          f"sync debug ({flag_reads} of them flag reads), by line: "
          f"{dict(syncs.most_common(8))}; {_busy_text(prof, ms)}; {smi}",
          flush=True)
    print(f"[smplify] phase 9 in {time.perf_counter() - t_start:.1f} s; "
          f"{launches} serve launch", flush=True)
    return {"serve_scan": launches}


# ---------------------------------------------------------------------------
# Phase 10: training on the card
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_T = 256, 200     # the reference's batch and chunk length
TRAIN_LENGTHS = (100, 200)      # each row's length, drawn from this range
TRAIN_SMALL = (8, 64)           # B, T of the float64 check on the CPU
TRAIN_SEED = 10
# cuDNN against the per-frame plain path (float32, dropout 0), and float32
# on the card against float64 on the CPU: the loss relative to itself, each
# gradient against its largest entry (float32 sums in another order over
# 200 recurrent steps; a wrong mask or gate is off by O(1))
TRAIN_AGREE = 1e-4
TRAIN_REPS, TRAIN_WARMUP = 10, 3
# the device's busy time a step (two profiled steps) may pass the step's
# median (ten timed steps) by this share before the count is held wrong
TRAIN_BUSY_MARGIN = 0.05
E2E_T, E2E_SEED = 64, 12        # the fixture corpus of the end-to-end run


def _train_inputs(name, B, T, lengths_range, seed):
    r"""Host inputs of one module's train step: ``(xs [T, B, in], labels
    [T, B, out], lengths [B], init [B, out] or None)``, zero past each
    row's length like ``padded_batches``."""
    from robustcap_tpu_torch.models.sig_mp import RNN_SPECS
    n_in, n_out, _, _, with_init = RNN_SPECS[name]
    rng = np.random.RandomState(seed)
    lengths = rng.randint(lengths_range[0], lengths_range[1] + 1,
                          B).astype(np.int32)
    lengths[0] = T
    valid = (np.arange(T)[:, None] < lengths[None])[..., None]
    xs = (rng.randn(T, B, n_in) * 0.5 * valid).astype(np.float32)
    if name == "rnn8":
        labels = (rng.rand(T, B, n_out) < 0.4).astype(np.float32)
    else:
        labels = rng.randn(T, B, n_out).astype(np.float32) * 0.5
    labels *= valid
    init = labels[0].copy() if with_init else None
    return xs, labels, lengths, init


def _train_loss(name, model):
    from robustcap_tpu_torch.train import losses
    if name == "rnn3":
        return losses.velocity_horizon_loss
    if name == "rnn7":
        return losses.make_fk_pose_loss(model)
    if name == "rnn8":
        return losses.masked_bce_pos_weight(np.array([1.5, 0.7], np.float32))
    return losses.masked_mse


def _loss_and_grads(forward, params, loss_fn, inputs, dev, dtype):
    r"""A module's loss and the gradients of every parameter, with dropout
    0, through ``forward`` (``rnn_forward_padded`` or its plain loop)."""
    import torch
    from robustcap_tpu_torch.device import tree_map
    from robustcap_tpu_torch.nn.rnn import init_net_apply
    from robustcap_tpu_torch.train.loop import _tensor_leaves
    p = tree_map(lambda t: t.detach().to(dev, dtype, copy=True)
                 .requires_grad_(), params)
    xs, labels, lengths, init = inputs
    state0 = None
    if init is not None:
        state0 = init_net_apply(p, torch.from_numpy(init).to(dev, dtype))
    ys, _ = forward(p, torch.from_numpy(xs).to(dev, dtype), lengths, state0)
    loss = loss_fn(ys, torch.from_numpy(labels).to(dev, dtype),
                   torch.from_numpy(lengths))
    leaves = _tensor_leaves(p)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.double().cpu() for g in grads]


def _train_gap(a, b):
    r"""(loss gap relative to the loss, largest gradient gap relative to
    that gradient's largest entry)."""
    (la, ga), (lb, gb) = a, b
    share = max(float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
                for x, y in zip(ga, gb))
    return abs(la - lb) / abs(lb), share


def _lstm_flops(H, n_in, n_out, valid_frames):
    r"""Forward and backward FLOPs of one module over ``valid_frames``
    row-frames: linear1, two LSTM layers, linear2, each 2 FLOP a
    multiply-add forward and twice that backward."""
    per_frame = 2 * (n_in * H + 2 * 4 * H * (H + H) + H * n_out)
    return 3 * per_frame * valid_frames


def _time_train_step(step, name):
    r"""``(median ms, [least, most] ms, bytes, peak bytes)`` of ``step``
    over ``TRAIN_REPS`` calls after ``TRAIN_WARMUP``, with CUDA events;
    bytes is the peak allocation above what was held before the warm-ups
    (the gradients, Adam's moments and the step's activations), peak the
    whole peak allocation."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for _ in range(TRAIN_WARMUP):
        step()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
             for _ in range(TRAIN_REPS)]
    losses = []
    for a, b in marks:
        a.record()
        losses.append(step().detach())
        b.record()
    torch.cuda.synchronize()
    times = [a.elapsed_time(b) for a, b in marks]
    peak = torch.cuda.max_memory_allocated()
    _require(all(bool(torch.isfinite(x)) for x in losses),
             f"train step {name}: non-finite loss")
    return (float(np.median(times)), [round(min(times), 3),
                                      round(max(times), 3)],
            peak - base, peak)


def _cudnn_flat_tree(params, dev):
    r"""``params`` on ``dev`` as leaves to train, its LSTM tensors the
    parameters of an ``nn.LSTM``: one buffer in cuDNN's layout, which cuDNN
    reads as it is instead of copying the weights in at each call."""
    import torch
    from robustcap_tpu_torch.device import tree_map
    layers = params["layers"]
    lstm = torch.nn.LSTM(layers[0]["w_ih"].shape[1],
                         layers[0]["w_hh"].shape[1], len(layers), device=dev)
    tree = tree_map(lambda t: t.to(dev).requires_grad_(),
                    {k: v for k, v in params.items() if k != "layers"})
    tree["layers"] = []
    with torch.no_grad():
        for i, layer in enumerate(layers):
            tree["layers"].append({})
            for key, name in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                              ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
                tree["layers"][i][key] = getattr(lstm, f"{name}_l{i}")
                tree["layers"][i][key].copy_(layer[key])
    buffers = {t.untyped_storage().data_ptr()
               for layer in tree["layers"] for t in layer.values()}
    _require(len(buffers) == 1, f"nn.LSTM kept its weights in {len(buffers)}"
             " buffers, not one")
    return tree


def check_training_steps(model, dev):
    r"""Phase 10 (a): one train step per module at full width, held against
    the plain path on the card and float64 on the CPU, then timed."""
    import torch
    from robustcap_tpu_torch.device import tree_map
    from robustcap_tpu_torch.models.sig_mp import RNN_SPECS
    from robustcap_tpu_torch.nn.rnn import (init_rnn_params,
                                            rnn_forward_padded,
                                            rnn_forward_padded_plain)
    from robustcap_tpu_torch.smpl import ParametricModel
    from robustcap_tpu_torch.train import make_forward_fn
    from robustcap_tpu_torch.train.loop import (_clip_by_global_norm,
                                                _tensor_leaves)
    cpu = torch.device("cpu")
    model64 = ParametricModel(data=model.data, dtype=torch.float64,
                              device=cpu)
    rows = {}
    for k, (name, (n_in, n_out, H, dropout, with_init)) in enumerate(
            RNN_SPECS.items()):
        params = init_rnn_params(torch.Generator().manual_seed(k), n_in,
                                 n_out, H, 2, with_init)
        loss_fn = _train_loss(name, model)
        big = _train_inputs(name, TRAIN_B, TRAIN_T, TRAIN_LENGTHS,
                            TRAIN_SEED + k)
        cudnn = _loss_and_grads(rnn_forward_padded, params, loss_fn, big,
                                dev, torch.float32)
        plain = _loss_and_grads(rnn_forward_padded_plain, params, loss_fn,
                                big, dev, torch.float32)
        gap_plain = _train_gap(cudnn, plain)
        small = _train_inputs(name, *TRAIN_SMALL, (TRAIN_SMALL[1] // 2,
                                                   TRAIN_SMALL[1]),
                              TRAIN_SEED + k)
        card = _loss_and_grads(rnn_forward_padded, params, loss_fn, small,
                               dev, torch.float32)
        ref = _loss_and_grads(rnn_forward_padded, params,
                              _train_loss(name, model64), small, cpu,
                              torch.float64)
        gap_f64 = _train_gap(card, ref)
        for what, gap in (("plain path on the card", gap_plain),
                          ("float64 on the CPU", gap_f64)):
            _require(max(gap) < TRAIN_AGREE,
                     f"train step {name}: cuDNN against the {what}: loss "
                     f"{gap[0]:.2e}, gradients {gap[1]:.2e} (bound "
                     f"{TRAIN_AGREE})")

        # the whole step, as train's loop runs it, with the module's dropout:
        # on the tree's own tensors (cuDNN copies the LSTM weights into its
        # layout at each call), then on weights kept in that layout
        forward = make_forward_fn(dropout, with_init)
        xs, labels, lengths, init = big
        xs_d = torch.from_numpy(xs).to(dev)
        labels_d = torch.from_numpy(labels).to(dev)
        init_d = None if init is None else torch.from_numpy(init).to(dev)
        lengths_h = torch.from_numpy(lengths)

        def make_step(tree):
            leaves = _tensor_leaves(tree)
            opt = torch.optim.Adam(leaves, lr=1e-3)
            gen = torch.Generator(device=dev).manual_seed(k)

            def step():
                loss = loss_fn(forward(tree, xs_d, lengths_h, init_d, gen),
                               labels_d, lengths_h)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                _clip_by_global_norm(leaves, 1.0)
                opt.step()
                return loss
            return step

        step = make_step(tree_map(lambda t: t.to(dev).requires_grad_(),
                                  params))
        ms, spread, step_mem, peak = _time_train_step(step, name)
        prof = _profile_top(step, 2)
        syncs = _count_syncs(step)
        del step
        ms_flat, spread_flat, _, _ = _time_train_step(
            make_step(_cudnn_flat_tree(params, dev)), name + " (flat)")
        n_valid = int(lengths.sum())
        flops = _lstm_flops(H, n_in, n_out, n_valid)
        bound, _ = _bound_ms(0, flops)
        rows[name] = dict(
            H=H, ms=round(ms, 3), ms_range=spread,
            seq_per_s=round(TRAIN_B / ms * 1e3, 1),
            frames_per_s=round(n_valid / ms * 1e3), bound_ms=round(bound, 3),
            ms_flat=round(ms_flat, 3), ms_flat_range=spread_flat,
            gap_plain=[float(f"{g:.3g}") for g in gap_plain],
            gap_f64=[float(f"{g:.3g}") for g in gap_f64],
            step_gb=round(step_mem / 2**30, 3),
            peak_gb=round(peak / 2**30, 3), syncs=sum(syncs.values()))
        busy = "device time not measured (no device events)"
        if prof is not None:
            n_k, summed, dev_ms, top = prof
            _require(dev_ms <= ms * (1 + TRAIN_BUSY_MARGIN),
                     f"train step {name}: device busy {dev_ms:.3f} ms a step "
                     f"against a step of {ms:.3f} ms: the busy time or its "
                     "window is wrong")
            idle = 1 - dev_ms / ms
            rows[name].update(kernels=round(n_k), device_ms=round(dev_ms, 3),
                              summed_ms=round(summed, 3), idle=round(idle, 4),
                              top=top)
            busy = (f"{n_k:.0f} kernels and copies, device busy "
                    f"{dev_ms:.3f} ms a step ({summed:.3f} ms summed over "
                    f"overlapping streams), idle {idle * 100:.1f}%; top "
                    f"(name, ms, calls) {top}")
        print(f"[train] {name} (H {H}) B={TRAIN_B} T={TRAIN_T}, {n_valid} "
              f"valid frames: {ms:.3f} ms a step (median of {TRAIN_REPS}, "
              f"CUDA events; range {spread}), {TRAIN_B / ms * 1e3:.1f} "
              f"sequences/s, {n_valid / ms * 1e3:.0f} frames/s; bound "
              f"{bound:.3f} ms ({flops / 1e12:.3f} TFLOP f32); {busy}; "
              f"{sum(syncs.values())} synchronizing calls a step "
              f"{dict(syncs)}; memory {step_mem / 2**30:.3f} GiB for the "
              f"step over what was held before it, peak {peak / 2**30:.3f} "
              f"GiB in all; weights in cuDNN's layout {ms_flat:.3f} ms "
              f"(range {spread_flat}); cuDNN against "
              f"the plain path: loss {gap_plain[0]:.2e}, gradients "
              f"{gap_plain[1]:.2e}; against float64 on the CPU (B=8, T=64): "
              f"loss {gap_f64[0]:.2e}, gradients {gap_f64[1]:.2e}", flush=True)
    print("[train] steps " + json.dumps(rows), flush=True)
    return rows


def check_training_e2e(model, dev):
    r"""Phase 10 (b): the six trainers for one epoch on a fixture corpus, a
    resume, the merge, ``forward_offline`` of the merged weights through
    the serve kernel, and the ``train`` command. Returns the serve
    launches of the phase."""
    import shutil
    import tempfile

    import torch
    from robustcap_tpu_torch.__main__ import main as cli
    from robustcap_tpu_torch.config import Paths, SigMPConfig
    from robustcap_tpu_torch.eval import build_aist_sequences
    from robustcap_tpu_torch.models import sig_mp
    from robustcap_tpu_torch.ops import serve_scan
    from robustcap_tpu_torch.preprocess import build_fixture_dataset
    from robustcap_tpu_torch.train import trainers

    t_start = time.perf_counter()
    corpus = build_fixture_dataset(model, n_seq=2, T=E2E_T, n_cam=2,
                                   seed=E2E_SEED)
    saved_paths, train_rnn3 = trainers.paths, trainers.train_rnn3
    with tempfile.TemporaryDirectory() as root:
        trainers.paths = Paths(data_root=root)
        try:
            wdir = os.path.join(root, "weights", "sig_mp")
            secs = {}
            for name in ("rnn2", "rnn3", "rnn4", "rnn6", "rnn7", "rnn8"):
                t0 = time.perf_counter()
                fn = getattr(trainers, f"train_{name}")
                if name == "rnn8":
                    fn(corpus, corpus, num_epoch=1, device=dev)
                else:
                    fn(corpus, corpus, corpus, corpus, num_epoch=1,
                       device=dev,
                       **({"body_model": model} if name == "rnn7" else {}))
                secs[name] = round(time.perf_counter() - t0, 2)
                _require(os.path.exists(os.path.join(
                    wdir, name, "best_weights.pkl")), f"{name}: no weights")
            trainers.train_rnn3(corpus, corpus, corpus, corpus, num_epoch=2,
                                device=dev)
            with open(os.path.join(wdir, "rnn3", "train_info.json")) as f:
                info = json.load(f)
            _require(info["epoch"] == 1 and info["total_it"] == 2,
                     f"rnn3 resume: train_info {info}")
            merged = trainers.merge_weights(device=dev)
            seq = build_aist_sequences(corpus, num_cameras=2)[0]
            serve_scan.LAUNCHES = 0
            pose, tran = sig_mp.forward_offline(
                merged, model, SigMPConfig(pallas_serve=True), seq.j2dc,
                seq.accc, seq.oric, first_tran=seq.first_tran,
                gravityc=seq.gravityc, device=dev)
            launches = serve_scan.LAUNCHES
            _require(launches == 1, f"forward_offline: {launches} serve "
                     "launches, expected 1")
            _require(bool(torch.isfinite(pose).all())
                     and bool(torch.isfinite(tran).all()),
                     "forward_offline of the merged weights: not finite")
            aist = os.path.join(root, "aist")
            os.makedirs(aist)
            for kind in ("train", "val"):
                torch.save(corpus, os.path.join(aist, f"{kind}.pt"))
            shutil.rmtree(os.path.join(wdir, "rnn3"))
            # the command runs the trainer as it is, cut to one epoch
            trainers.train_rnn3 = functools.partial(train_rnn3, num_epoch=1)
            t0 = time.perf_counter()
            cli(["train", "--rnn", "3", "--aist", aist, "--device", str(dev)])
            secs["cli rnn3"] = round(time.perf_counter() - t0, 2)
            _require(os.path.exists(os.path.join(wdir, "rnn3",
                                                 "best_weights.pkl")),
                     "train CLI: no weights")
        finally:
            trainers.paths = saved_paths
            trainers.train_rnn3 = train_rnn3
    print(f"[train] end to end on a fixture corpus (2 motions x 2 cameras x "
          f"{E2E_T} frames): one epoch each in {secs} s, rnn3 resumed to a "
          f"second epoch, merged; forward_offline of the merged weights "
          f"through the serve kernel ({launches} launch) finite over "
          f"{seq.length} frames; phase 10 (b) in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    return {"serve_scan": launches}


# ---------------------------------------------------------------------------
# Phase 11: data parallelism and corpus preprocessing
# ---------------------------------------------------------------------------

DP_MODULES = ("rnn4", "rnn2")   # H=1280 and one H=512 module
DP_AGREE = 1e-6        # one rank: parameters against the step's move
# two ranks over gloo against one process, the DP step in float64 (in
# float32 the ranks' partial sums of ~25,000 row-frames round apart by
# ~1e-5 of the largest gradient: printed, not held): the loss relative to
# itself, the parameters after SGD against the step's move (Adam's first
# step divides each gradient by its own size, so near-zero entries would
# turn rounding into whole moves)
GLOO_LOSS = 1e-6
GLOO_PARAMS = 1e-5
GLOO_EVAL = 1e-5       # sharded run_sequences against unsharded
GLOO_SHARE = 0.1       # sharded refinement: share of the refinement's move
GLOO_SGD_LR = 0.1
GLOO_MODULE = "rnn2"
GLOO_SEED = 14
# train(mesh=) in the gloo children: rank 0's validation values improve
# twice, then rise, so early stop (threshold 2) ends the first run at the
# fourth validation and the plateau (patience 0) scales the lr at the third;
# rank 1's own values keep falling. 12 sequences at batch 4: 3 steps an
# epoch, then a resume to the end of epoch 2 (9 steps in all)
GLOO_VALD_RANK0 = (3.0, 2.0, 2.5, 2.6, 2.7)
GLOO_TRAIN_SEQS = 12
CHILD_TIMEOUT_S = 300
PRE_N, PRE_T = 4, 600            # motions and frames of the raw trees
AMASS_FRAMES = 12000             # one 120 fps motion (100 s) for the timing
PRE_ATOL = 1e-5                  # positions, rotations, keypoints (card/CPU)
EPS32 = float(np.finfo(np.float32).eps)


def _free_port(udp=False):
    import socket
    with socket.socket(type=socket.SOCK_DGRAM if udp
                       else socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_module(name):
    r"""``(params on the CPU, forward, host inputs)`` of one module at phase
    10's shape (B=256, T=200, lengths 100-200, dropout 0)."""
    import torch
    from robustcap_tpu_torch.models.sig_mp import RNN_SPECS
    from robustcap_tpu_torch.nn.rnn import init_rnn_params
    from robustcap_tpu_torch.train import make_forward_fn
    k = list(RNN_SPECS).index(name)
    n_in, n_out, H, _, with_init = RNN_SPECS[name]
    params = init_rnn_params(torch.Generator().manual_seed(k), n_in, n_out,
                             H, 2, with_init)
    return (params, make_forward_fn(0.0, with_init),
            _train_inputs(name, TRAIN_B, TRAIN_T, TRAIN_LENGTHS,
                          TRAIN_SEED + k))


def _on(params, dev, dtype=None):
    import torch
    from robustcap_tpu_torch.device import tree_map
    dtype = dtype or torch.float32
    return tree_map(lambda t: t.detach().to(dev, dtype, copy=True)
                    .requires_grad_(), params)


def _inputs_as(inputs, dtype):
    return tuple(x if x is None or x.dtype.kind == "i" else
                 x.astype(dtype) for x in inputs)


def _plain_step(forward, loss_fn, tree, opt, inputs, dev, clip=1.0):
    r"""The single-device loop's step: the batch uploaded from the host,
    forward, loss, backward, the clip, the optimizer."""
    import torch
    from robustcap_tpu_torch.train.loop import (_clip_by_global_norm,
                                                _tensor_leaves, _upload)
    xs, labels, lengths, init = inputs
    leaves = _tensor_leaves(tree)
    lengths_h = torch.from_numpy(lengths)

    def step():
        loss = loss_fn(forward(tree, _upload(xs, dev), lengths_h,
                               _upload(init, dev), None),
                       _upload(labels, dev), lengths_h)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if clip:
            _clip_by_global_norm(leaves, clip)
        opt.step()
        return loss.detach()
    return step


def _leaf_gap(a, b):
    return max(float((x.detach() - y.detach()).abs().max())
               for x, y in zip(a, b))


def check_parallel_nccl(model, dev, card):
    r"""Phase 11 (a): NCCL at one rank. ``train(mesh=)``'s DP step of rnn4
    and rnn2 at full width against the plain step on the same batch, both
    timed; the NCCL all-reduce's device time and the bytes it moves."""
    import torch
    import torch.distributed as dist
    from robustcap_tpu_torch.parallel import (initialize_distributed,
                                              make_dp_train_step, make_mesh)
    from robustcap_tpu_torch.train.loop import _tensor_leaves
    ctx = initialize_distributed(f"localhost:{_free_port()}", 1, 0,
                                 device=dev)
    _require(ctx.enabled and ctx.process_count == 1
             and dist.get_backend() == "nccl",
             f"NCCL at one rank did not come up: {ctx}")
    mesh = make_mesh(dev)
    rows = {}
    try:
        for name in DP_MODULES:
            params, forward, inputs = _dp_module(name)
            loss_fn = _train_loss(name, model)
            xs, labels, lengths, init = inputs
            tree_dp, tree_pl = _on(params, dev), _on(params, dev)
            before = [t.detach().clone() for t in _tensor_leaves(tree_dp)]
            dp = make_dp_train_step(
                forward, loss_fn,
                torch.optim.Adam(_tensor_leaves(tree_dp), lr=1e-3), mesh,
                clip_grad_norm=1.0)

            def dp_step(tree=tree_dp):
                return dp(tree, xs, labels, lengths, init)
            plain = _plain_step(forward, loss_fn, tree_pl, torch.optim.Adam(
                _tensor_leaves(tree_pl), lr=1e-3), inputs, dev)
            loss_dp, loss_pl = float(dp_step()), float(plain())
            move = _leaf_gap(_tensor_leaves(tree_pl), before)
            gap = _leaf_gap(_tensor_leaves(tree_dp), _tensor_leaves(tree_pl))
            _require(loss_dp == loss_pl and gap <= DP_AGREE * move,
                     f"DP step {name} at one rank: loss {loss_dp} against "
                     f"{loss_pl}, parameters {gap:.3e} of a move {move:.3e}")
            ms_dp, spread_dp, _, _ = _time_train_step(dp_step, name + " DP")
            ms_pl, spread_pl, _, _ = _time_train_step(plain, name)
            grads = torch.cat([t.grad.reshape(-1)
                               for t in _tensor_leaves(tree_dp)])
            # NCCL's in-place all-reduce at one rank may launch nothing:
            # its device time from the profiler (None: no device event)
            # and the call's time between CUDA events
            prof = _profile_top(lambda: mesh.all_reduce_(grads), 10, k=3)
            ar_call = _time_ms(lambda: mesh.all_reduce_(grads), 10)
            step_prof = _profile_top(dp_step, 2, k=10 ** 4)
            nccl_in_step = (None if step_prof is None else round(sum(
                ms for n, ms, _ in step_prof[3] if "nccl" in n.lower()), 3))
            ar_ms = None if prof is None else round(prof[1], 4)
            rows[name] = dict(
                ms_dp=round(ms_dp, 3), ms_dp_range=spread_dp,
                ms_plain=round(ms_pl, 3), ms_plain_range=spread_pl,
                grad_bytes=grads.numel() * 4, allreduce_ms=ar_ms,
                allreduce_call_ms=round(ar_call, 4),
                allreduce_top=None if prof is None else prof[3],
                nccl_ms_in_step=nccl_in_step, loss=loss_dp,
                param_gap_share=gap / move)
            gb = grads.numel() * 4 / 1e9
            ar = ("no device event" if ar_ms is None
                  else f"{ar_ms} ms of device time") + \
                f", {ar_call:.4f} ms a call between CUDA events (mean of 10)"
            print(f"[parallel] (a) NCCL, one rank, {card}: {name} DP step "
                  f"B={TRAIN_B} T={TRAIN_T} {ms_dp:.3f} ms (median of "
                  f"{TRAIN_REPS}, CUDA events; range {spread_dp}) against "
                  f"the plain step's {ms_pl:.3f} ms (range {spread_pl}); "
                  f"loss equal ({loss_dp:.6f}), parameters {gap:.2e} of a "
                  f"move of {move:.2e}; gradients {gb:.4f} GB a step; the "
                  f"NCCL all-reduce alone (torch.profiler): {ar}; nccl "
                  f"kernels in a profiled step {nccl_in_step} ms",
                  flush=True)
            del dp, plain, tree_dp, tree_pl, grads
    finally:
        dist.destroy_process_group()
    return rows


def _gloo_world(dev):
    r"""What the two gloo ranks and the parent share: full-width params
    (seed 0, as ``main``), the 6890-vertex body, three one-camera fixture
    sequences of 64 frames, and the float64 body and prior."""
    import torch
    from robustcap_tpu_torch.eval import build_aist_sequences
    from robustcap_tpu_torch.models import sig_mp
    from robustcap_tpu_torch.preprocess import build_fixture_dataset
    from robustcap_tpu_torch.smpl import ParametricModel, synthetic_smpl_data
    from robustcap_tpu_torch.smplify.prior import MaxMixturePrior
    data = synthetic_smpl_data()
    model = ParametricModel(data=data, device=dev)
    params = sig_mp.init_params(torch.Generator().manual_seed(0), device=dev)
    seqs = build_aist_sequences(build_fixture_dataset(
        model, n_seq=3, T=64, n_cam=1, seed=GLOO_SEED))
    model64 = ParametricModel(data=data, dtype=torch.float64, device=dev)
    prior64 = MaxMixturePrior(None, device=dev, dtype=torch.float64)
    return params, model, seqs, model64, prior64


def _gloo_run(params, model, seqs, model64, prior64, dev, mesh=None):
    r"""``run_sequences`` then the float64 refinement of its output (one
    group of four lanes: three sequences and a padded one)."""
    from robustcap_tpu_torch.config import SigMPConfig
    from robustcap_tpu_torch.eval import run_sequences
    from robustcap_tpu_torch.smplify import refine_sequences_batched
    res = run_sequences(params, model, SigMPConfig(), seqs, device=dev,
                        mesh=mesh)
    refined = refine_sequences_batched(res, seqs, model=model64,
                                       prior=prior64, group_size=4,
                                       device=dev, mesh=mesh)
    return res, refined


def _gloo_train(mesh, save_dir):
    r"""Full-width rnn2 through ``train(mesh=)`` on a small corpus: a run
    ended by early stop, then its resume. Returns each run's parameters
    (flat, host) and ``train_info``."""
    import torch
    from robustcap_tpu_torch.models.sig_mp import RNN_SPECS
    from robustcap_tpu_torch.train import (SeqDataset, make_forward_fn,
                                           masked_mse, train)
    from robustcap_tpu_torch.train.loop import _tensor_leaves
    params, _, _ = _dp_module(GLOO_MODULE)
    n_in, n_out, _, dropout, _ = RNN_SPECS[GLOO_MODULE]
    rng = np.random.RandomState(GLOO_SEED)
    data = [rng.randn(int(n), n_in).astype(np.float32)
            for n in rng.randint(40, 81, GLOO_TRAIN_SEQS)]
    ds = SeqDataset(data, [d[:, :n_out] * 0.5 for d in data])
    calls = []

    def vald(ys, labels, lengths):
        calls.append(None)
        k = len(calls) - 1
        return torch.tensor(GLOO_VALD_RANK0[k] if mesh.rank == 0
                            else -float(k))

    got = {}
    for run, kw in (("first", dict(num_epoch=5, eval_fn=vald,
                                   early_stop_threshold=2,
                                   lr_scheduler_patience=0)),
                    ("resumed", dict(num_epoch=3))):
        out = train(params, make_forward_fn(dropout), masked_mse, ds, ds,
                    save_dir, batch_size=4, learning_rate=1e-3,
                    num_iter_between_vald=1, mesh=mesh, **kw)
        got[f"train_{run}"] = torch.cat(
            [t.detach().reshape(-1) for t in _tensor_leaves(out)]
        ).cpu().numpy()
        with open(os.path.join(save_dir, "train_info.json")) as f:
            got[f"info_{run}"] = json.dumps(json.load(f), sort_keys=True)
        mesh.barrier()          # both ranks have read before the resume
    return got


def gloo_child(port, rank, out, device):
    r"""One of the two ranks of phase 11 (b), on ``device`` over gloo: the DP
    step of rnn2 at full width on its rows (SGD, and Adam for the ranks'
    agreement), timed with the all-reduce alone; ``run_sequences`` and the
    float64 refinement sharded. Writes its results to ``out`` (npz)."""
    import torch
    from robustcap_tpu_torch.parallel import (initialize_distributed,
                                              make_dp_train_step, make_mesh)
    from robustcap_tpu_torch.train.loop import _tensor_leaves
    from robustcap_tpu_torch.smpl import ParametricModel, synthetic_smpl_data
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    ctx = initialize_distributed(f"127.0.0.1:{port}", 2, rank, device=dev,
                                 backend="gloo")
    mesh = make_mesh(dev)
    got = {"rank": ctx.process_index, "size": ctx.process_count}
    body = ParametricModel(data=synthetic_smpl_data(), device=dev)
    params, forward, inputs = _dp_module(GLOO_MODULE)
    loss_fn = _train_loss(GLOO_MODULE, body)
    for label, opt_cls, lr, dtype in (
            ("sgd64", torch.optim.SGD, GLOO_SGD_LR, torch.float64),
            ("sgd32", torch.optim.SGD, GLOO_SGD_LR, torch.float32),
            ("adam32", torch.optim.Adam, 1e-3, torch.float32)):
        tree = _on(params, dev, dtype)
        leaves = _tensor_leaves(tree)
        step = make_dp_train_step(forward, loss_fn, opt_cls(leaves, lr=lr),
                                  mesh, clip_grad_norm=1.0)
        host = _inputs_as(inputs, np.float64 if dtype == torch.float64
                          else np.float32)
        got[f"{label}_loss"] = float(step(tree, *host))
        got[f"{label}_params"] = torch.cat(
            [t.detach().reshape(-1) for t in leaves]).cpu().numpy()
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(tree, *inputs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    grads = torch.cat([t.grad.reshape(-1) for t in leaves])
    ar = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh.all_reduce_(grads)
        torch.cuda.synchronize()
        ar.append((time.perf_counter() - t0) * 1e3)
    got["step_ms"] = float(np.median(times[1:]))
    got["allreduce_ms"] = float(np.median(ar[1:]))
    got["grad_bytes"] = grads.numel() * 4
    del tree, leaves, step, grads
    t0 = time.perf_counter()
    got.update(_gloo_train(mesh, os.path.join(os.path.dirname(out),
                                              "train")))
    got["train_s"] = time.perf_counter() - t0
    world = _gloo_world(dev)
    res, refined = _gloo_run(*world, dev, mesh)
    for i, ((p, t), (rp, rt)) in enumerate(zip(res, refined)):
        got[f"pose{i}"], got[f"tran{i}"] = p, t
        got[f"rpose{i}"], got[f"rtran{i}"] = rp, rt
    np.savez(out, **got)
    return 0


def nccl_shared_card_child(port, rank):
    r"""One of two ranks asking NCCL on the same card: the mesh's check
    must refuse it with a clear error (exit 0 if it does)."""
    import torch
    from robustcap_tpu_torch.parallel import initialize_distributed
    try:
        initialize_distributed(f"127.0.0.1:{port}", 2, rank,
                               device=torch.device("cuda", 0))
    except RuntimeError as e:
        if "one card per rank" in str(e):
            print(f"refused: {e}", flush=True)
            return 0
        raise
    print("NCCL put two ranks on one card", flush=True)
    return 1


def _spawn(args_list, timeout):
    r"""Run the child commands together; each must end within ``timeout``
    seconds (all are killed otherwise). Returns their (rc, stdout,
    stderr)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__)),
         os.environ.get("PYTHONPATH", "")]))
    for k in ("MASTER_ADDR", "MASTER_PORT", "ROBUSTCAP_COORDINATOR"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               *map(str, a)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for a in args_list]
    deadline = time.monotonic() + timeout
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def check_parallel_gloo(model, dev, card):
    r"""Phase 11 (b): two ranks sharing the card over gloo (two spawned
    processes, with a timeout), held against one process: the DP step of
    rnn2 with unequal lengths, ``run_sequences(mesh=)`` and the float64
    ``refine_sequences_batched(mesh=)``; two more processes that ask NCCL
    for two ranks on the card must be refused."""
    import tempfile

    import torch
    from robustcap_tpu_torch.train.loop import _tensor_leaves
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        import threading
        results = {}
        port, port2 = _free_port(), _free_port()
        runner = threading.Thread(target=lambda: results.update(spawned=_spawn(
            [["--gloo-child", port, r, os.path.join(d, f"r{r}.npz"), dev]
             for r in range(2)]
            + [["--nccl-shared-card-child", port2, r] for r in range(2)],
            CHILD_TIMEOUT_S)))
        runner.start()
        # the one-process references, meanwhile
        params, forward, inputs = _dp_module(GLOO_MODULE)
        loss_fn = _train_loss(GLOO_MODULE, model)
        ref = {}
        for label, dtype in (("sgd64", torch.float64),
                             ("sgd32", torch.float32)):
            tree = _on(params, dev, dtype)
            before = torch.cat([t.detach().reshape(-1)
                                for t in _tensor_leaves(tree)])
            step = _plain_step(forward, loss_fn, tree, torch.optim.SGD(
                _tensor_leaves(tree), lr=GLOO_SGD_LR), _inputs_as(
                    inputs, np.float64 if dtype == torch.float64
                    else np.float32), dev)
            loss = float(step())
            after = torch.cat([t.detach().reshape(-1)
                               for t in _tensor_leaves(tree)])
            ref[label] = (loss, after.cpu().numpy(),
                          float((after - before).abs().max()))
        world = _gloo_world(dev)
        res, refined = _gloo_run(*world, dev)
        start = [(p.astype(np.float64), t.astype(np.float64))
                 for p, t in res]
        runner.join()
        spawned = results["spawned"]
        for rc, o, e in spawned:
            _require(rc == 0, f"phase 11 (b) child failed ({rc}):\n"
                     f"{o[-2000:]}\n{e[-4000:]}")
        ranks = [dict(np.load(os.path.join(d, f"r{r}.npz")))
                 for r in range(2)]
        with open(os.path.join(d, "train", "metrics.jsonl")) as f:
            train_its = [json.loads(line)["total_it"] for line in f]
    out = {}
    for got in ranks:
        r = int(got["rank"])
        gaps = {}
        for label in ("sgd64", "sgd32"):
            loss, after, move = ref[label]
            gaps[label] = (abs(float(got[f"{label}_loss"]) - loss) / abs(loss),
                           float(np.abs(got[f"{label}_params"] - after).max())
                           / move)
        loss_gap, p_gap = gaps["sgd64"]
        _require(loss_gap <= GLOO_LOSS and p_gap <= GLOO_PARAMS,
                 f"gloo rank {r}: DP step (float64) against one process: "
                 f"loss {loss_gap:.2e}, parameters {p_gap:.2e} of the move")
        _require(float(got["adam32_loss"]) == float(got["sgd32_loss"]),
                 "gloo: the Adam and SGD steps' losses differ")
        eval_gap = max(max(float(np.abs(got[f"pose{i}"] - p).max()),
                           float(np.abs(got[f"tran{i}"] - t).max()))
                       for i, (p, t) in enumerate(res))
        _require(eval_gap <= GLOO_EVAL, f"gloo rank {r}: run_sequences "
                 f"sharded against unsharded {eval_gap:.2e}")
        shares = []
        for i, ((rp, rt), (p0, t0_)) in enumerate(zip(refined, start)):
            moved = max(float(np.abs(rp - p0).max()),
                        float(np.abs(rt - t0_).max()))
            gap = max(float(np.abs(got[f"rpose{i}"] - rp).max()),
                      float(np.abs(got[f"rtran{i}"] - rt).max()))
            _require(moved > 0 and gap <= GLOO_SHARE * moved,
                     f"gloo rank {r}: refinement {i} sharded against "
                     f"unsharded {gap:.2e} of a move {moved:.2e}")
            shares.append(gap / moved)
        out[r] = dict(loss_gap=loss_gap, param_share=p_gap,
                      f32_gaps=gaps["sgd32"],
                      eval_gap=eval_gap, refine_share=max(shares),
                      step_ms=float(got["step_ms"]),
                      allreduce_ms=float(got["allreduce_ms"]),
                      grad_bytes=int(got["grad_bytes"]))
    _require(np.array_equal(ranks[0]["adam32_params"],
                            ranks[1]["adam32_params"]),
             "gloo: the ranks' parameters differ after the Adam step")
    for run in ("first", "resumed"):
        _require(np.array_equal(ranks[0][f"train_{run}"],
                                ranks[1][f"train_{run}"])
                 and str(ranks[0][f"info_{run}"])
                 == str(ranks[1][f"info_{run}"]),
                 f"gloo: train(mesh=), {run} run: the ranks differ")
    first = json.loads(str(ranks[0]["info_first"]))
    _require((first["epoch"], first["it"], first["total_it"],
              first["lr_scale"]) == (1, 1, 4, 0.1)
             and train_its == list(range(1, 10))
             and not np.array_equal(ranks[0]["train_first"],
                                    ranks[0]["train_resumed"]),
             f"gloo: train(mesh=) did not follow rank 0's validation: "
             f"{first}, metrics lines {train_its}")
    f32 = [[float(f"{g:.2e}") for g in v["f32_gaps"]] for v in out.values()]
    print(f"[parallel] (b) gloo, two ranks sharing the card, {card}: "
          f"{GLOO_MODULE} DP step B={TRAIN_B} T={TRAIN_T}, unequal lengths "
          f"(rows 0-127: {int(inputs[2][:128].sum())}, 128-255: "
          f"{int(inputs[2][128:].sum())} valid frames) against one process "
          f"on the whole batch, float64: loss "
          f"{max(v['loss_gap'] for v in out.values()):.2e} (bound "
          f"{GLOO_LOSS}), parameters after SGD "
          f"{max(v['param_share'] for v in out.values()):.2e} of the move "
          f"(bound {GLOO_PARAMS}); float32 (not held): loss, parameters "
          f"{f32}; "
          f"Adam's parameters (float32) equal on both ranks; "
          f"run_sequences sharded (3 sequences, padded to 4) "
          f"{max(v['eval_gap'] for v in out.values()):.2e} from unsharded "
          f"(bound {GLOO_EVAL}); float64 refinement sharded "
          f"{max(v['refine_share'] for v in out.values()):.2e} of its move "
          f"(bound {GLOO_SHARE}); train(mesh=) of full-width "
          f"{GLOO_MODULE}: early stop and the plateau at rank 0's "
          f"validation, resumed, 9 steps, one metrics line a validation, "
          f"parameters equal on both ranks "
          f"({[round(float(g['train_s']), 1) for g in ranks]} s); "
          f"gloo's own times (through the host, no "
          f"NCCL figure): a DP step "
          f"{[round(v['step_ms'], 2) for v in out.values()]} ms, the "
          f"all-reduce of {out[0]['grad_bytes'] / 1e6:.1f} MB "
          f"{[round(v['allreduce_ms'], 2) for v in out.values()]} ms "
          f"(host clock, median of 5); NCCL with two ranks on the card "
          f"refused: {[o.strip()[9:80] for rc, o, _ in spawned[2:]]}; "
          f"phase 11 (b) in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def _imu_vertices(model, R, tran, shape=None):
    r"""The IMU vertices ``[T, 6, 3]`` of a posed motion as the drivers
    skin them, on the model's device, as float64 numpy."""
    import torch
    from robustcap_tpu_torch.preprocess import datasets as D
    dev = model.device
    _, _, v = model.forward_kinematics(
        torch.as_tensor(np.asarray(R, np.float32), device=dev),
        tran=torch.as_tensor(np.asarray(tran, np.float32), device=dev),
        shape=None if shape is None else torch.as_tensor(
            np.asarray(shape, np.float32), device=dev),
        calc_mesh=True, vertex_ids=D.NEED_VERTS)
    return v[:, list(D._VI)].double().cpu().numpy()


def _acc_bound(card_model, cpu_model, motions):
    r"""``3600 (4 delta + 2 eps32 max|v|)``: an acceleration is a second
    difference of positions times at most fps^2 = 3600, so a position gap
    delta (measured: the card's IMU vertices against the CPU's on the same
    motions) moves it by at most 4 delta 3600, and each device's float32
    sum v[t-1] + v[t+1] rounds by at most eps32 max|v|. Returns (bound,
    delta)."""
    delta = vmax = 0.0
    for R_card, R_cpu, tran, shape in motions:
        a = _imu_vertices(card_model, R_card, tran, shape)
        b = _imu_vertices(cpu_model, R_cpu, tran, shape)
        delta = max(delta, float(np.abs(a - b).max()))
        vmax = max(vmax, float(np.abs(a).max()))
    return 3600.0 * (4 * delta + 2 * EPS32 * vmax), delta


def _work_gaps(a, b, path="", gaps=None):
    r"""The largest gap of each key of two work dicts (same structure,
    shapes and dtypes required)."""
    gaps = {} if gaps is None else gaps
    if isinstance(a, dict):
        _require(set(a) == set(b), f"work dict keys {path}")
        for k in a:
            _work_gaps(a[k], b[k], k, gaps)
    elif isinstance(a, (list, tuple)):
        _require(len(a) == len(b), f"work dict {path}: lengths")
        for x, y in zip(a, b):
            _work_gaps(x, y, path, gaps)
    elif a is None or isinstance(a, str):
        _require(a == b, f"work dict {path}: {a!r} against {b!r}")
    else:
        x, y = np.asarray(a), np.asarray(b)
        _require(x.shape == y.shape and x.dtype == y.dtype,
                 f"work dict {path}: {x.shape} {x.dtype} against {y.shape} "
                 f"{y.dtype}")
        gap = float(np.abs(x.astype(np.float64) - y).max()) if x.size else 0.
        gaps[path] = max(gaps.get(path, 0.0), gap)
    return gaps


def _hold_work(what, card, cpu, bound):
    gaps = _work_gaps(card, cpu)
    for k, g in gaps.items():
        limit = bound if k in ("imu_acc", "imu_accc", "acc") else PRE_ATOL
        _require(g <= limit, f"preprocess {what}: {k} card against CPU "
                 f"{g:.3e} (bound {limit:.3e})")
    return max((g for k, g in gaps.items()
                if k not in ("imu_acc", "imu_accc", "acc")), default=0.0)


def _amass_tree(root, rng):
    r"""``<corpus>/<subject>/*_poses.npz`` at 120 fps: three train motions
    (ACCAD, CMU) and one val (HumanEva), each ``2 PRE_T`` frames."""
    from robustcap_tpu_torch.preprocess import smooth_random_motion
    for i, corpus in enumerate(("ACCAD", "ACCAD", "CMU", "HumanEva")):
        d = os.path.join(root, corpus, f"s{i}")
        os.makedirs(d, exist_ok=True)
        aa, tran = smooth_random_motion(rng, 2 * PRE_T)
        np.savez(os.path.join(d, f"m{i}_poses.npz"),
                 poses=np.concatenate([aa.reshape(len(aa), 72),
                                       np.zeros((len(aa), 84), np.float32)],
                                      1), trans=tran, mocap_framerate=120.0)


def check_preprocess(model, dev, card):
    r"""Phase 11 (c): raw AIST++, TotalCapture, 3DPW(-OCC) and AMASS trees
    (``PRE_N`` motions of ``PRE_T`` frames) written by the port's
    fixtures, ``python -m robustcap_tpu_torch preprocess`` over every
    ``--dataset`` choice on the card (in-process), the same drivers on the
    CPU, the work dicts held card against CPU; then
    ``amass_sequence_to_work`` timed on one 12,000-frame 120 fps motion on
    the card and the CPU, with the card's synchronizing calls."""
    import shutil
    import tempfile

    import torch
    from robustcap_tpu_torch.__main__ import main as cli
    from robustcap_tpu_torch.config import AmassSplits
    from robustcap_tpu_torch.preprocess import (amass_sequence_to_work,
                                                corpus, fixtures_raw,
                                                preprocess_amass,
                                                smooth_random_motion)
    from robustcap_tpu_torch.preprocess.datasets import rotations
    from robustcap_tpu_torch.smpl import ParametricModel, default_body_model

    t_start = time.perf_counter()
    cpu = torch.device("cpu")
    body = default_body_model(dev)          # what the command poses with
    body_cpu = ParametricModel(data=body.data, device=cpu)

    def rot(aa, m):
        return rotations(aa, m.device).cpu().numpy().reshape(-1, 24, 3, 3)

    def load(path):
        return torch.load(path, map_location="cpu", weights_only=False)

    root = tempfile.mkdtemp()
    try:
        raw = {k: os.path.join(root, "raw", k)
               for k in ("aist", "tc", "pw3d", "pw3d_occ", "amass")}
        work = os.path.join(root, "work")
        t0 = time.perf_counter()
        fixtures_raw.build_raw_aist(raw["aist"], body, n_seq=PRE_N, T=PRE_T,
                                    misaligned_cam=3)
        fixtures_raw.build_raw_totalcapture(raw["tc"], body, n_seq=PRE_N,
                                            T=PRE_T)
        fixtures_raw.build_raw_pw3d(raw["pw3d"], body, n_seq=PRE_N,
                                    T60=PRE_T)
        fixtures_raw.build_raw_pw3d(raw["pw3d_occ"], body, n_seq=PRE_N,
                                    T60=PRE_T, occ=True)
        _amass_tree(raw["amass"], np.random.RandomState(15))
        t_build = time.perf_counter() - t0

        secs, printed = {}, {}
        tc_pre = os.path.join(raw["tc"], "total_capture_data.pt")
        for dataset, src, out in (
                ("aist", "aist", "aist"), ("aist_pre", "aist", "na.txt"),
                ("tc_pre", "tc", None), ("totalcapture_pre", "tc", None),
                ("tc", "tc", "tc"), ("totalcapture", "tc", "tc2"),
                ("pw3d", "pw3d", "pw3d"), ("pw3d_occ", "pw3d_occ", "pwocc"),
                ("amass", "amass", "amass")):
            args = ["preprocess", "--dataset", dataset, "--raw", raw[src],
                    "--device", str(dev)]
            if out is not None:
                args += ["--out", os.path.join(work, "card", out)]
            t0 = time.perf_counter()
            cli(args)
            torch.cuda.synchronize()
            secs[dataset] = round(time.perf_counter() - t0, 2)
            if dataset == "totalcapture_pre":
                shutil.copy(tc_pre, os.path.join(work, "tc_pre_card.pt"))

        # the same drivers on the CPU
        t0 = time.perf_counter()
        kw = dict(model=body_cpu, device=cpu)
        counts = corpus.preprocess_aist(raw["aist"],
                                        os.path.join(work, "cpu", "aist"),
                                        **kw)
        flagged = corpus.write_not_aligned(
            raw["aist"], out_path=os.path.join(work, "na_cpu.txt"), **kw)
        corpus.preprocess_totalcapture_pre(raw["tc"], **kw)
        n_tc = corpus.preprocess_totalcapture(
            raw["tc"], os.path.join(work, "cpu", "tc"), **kw)
        for occ, name in ((False, "pw3d"), (True, "pwocc")):
            corpus.preprocess_3dpw(raw["pw3d_occ" if occ else "pw3d"],
                                   os.path.join(work, "cpu", name), occ=occ,
                                   **kw)
        preprocess_amass(body_cpu, raw["amass"],
                         os.path.join(work, "cpu", "amass"),
                         {"train": AmassSplits.train,
                          "val": AmassSplits.val}, device=cpu)
        t_cpu = time.perf_counter() - t0

        def card_cpu(rel):
            return (load(os.path.join(work, "card", rel)),
                    load(os.path.join(work, "cpu", rel)))

        held = {}
        a, b = card_cpu("aist/test.pt")
        _require(counts == {"test": PRE_N} and len(a["name"]) == PRE_N,
                 f"aist: {counts}")
        bound, delta = _acc_bound(body, body_cpu, [
            (rot(p, body), rot(p, body_cpu), t, None)
            for p, t in zip(a["pose"], a["tran"])])
        held["aist"] = (_hold_work("aist", a, b, bound), bound, delta)
        with open(os.path.join(work, "card", "na.txt")) as f:
            na_card = f.read().split()
        _require(na_card == flagged and any("c04" in n for n in flagged),
                 f"aist_pre: {na_card} against {flagged}")
        _require(_hold_work("tc_pre", load(os.path.join(
            work, "tc_pre_card.pt")), load(tc_pre), 0.0) <= PRE_ATOL,
            "tc_pre")
        for rel in ("tc", "tc2"):
            a, b = (load(os.path.join(work, "card", rel, "test.pt")),
                    load(os.path.join(work, "cpu", "tc", "test.pt")))
            # the default skip list drops motions 2, 12 and 42
            _require(len(a["name"]) == n_tc == sum(
                i not in (2, 12, 42) for i in range(PRE_N)),
                     f"tc: {len(a['name'])} sequences, CPU {n_tc}")
            held["tc"] = (_hold_work("tc", a, b, 0.0), 0.0, 0.0)
        for name, fname in (("pw3d", "test.pt"), ("pwocc", "test_occ.pt")):
            a, b = card_cpu(f"{name}/{fname}")
            bound, delta = _acc_bound(body, body_cpu, [
                (pa, pb, t, s) for pa, pb, t, s in
                zip(a["posec"], b["posec"], a["tranc"], a["shape"])])
            held[name] = (_hold_work(name, a, b, bound), bound, delta)
        for kind in ("train", "val"):
            a, b = card_cpu(f"amass/{kind}.pt")
            _require(len(a["pose"]) == (3 if kind == "train" else 1),
                     f"amass {kind}: {len(a['pose'])} motions")
            bound, delta = _acc_bound(body, body_cpu, [
                (rot(p, body), rot(p, body_cpu), t, None)
                for p, t in zip(a["pose"], a["tran"])])
            held[f"amass {kind}"] = (_hold_work("amass", a, b, bound), bound,
                                     delta)

        # amass_sequence_to_work on one long motion: card, CPU, syncs
        aa, tran = smooth_random_motion(np.random.RandomState(16),
                                        AMASS_FRAMES)
        aa = aa.reshape(AMASS_FRAMES, 72)
        amass_sequence_to_work(body, aa[:240], tran[:240], 120.0,
                               device=dev)
        timed = {}
        for what, m, d in (("card", body, dev), ("CPU", body_cpu, cpu)):
            runs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                entry = amass_sequence_to_work(m, aa, tran, 120.0, device=d)
                runs.append(time.perf_counter() - t0)
            timed[what] = float(np.median(runs))
        n_out = len(entry["pose"])
        syncs = _count_syncs(lambda: amass_sequence_to_work(
            body, aa, tran, 120.0, device=dev))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    fps = {k: n_out / v for k, v in timed.items()}
    print(f"[preprocess] (c) {card}: raw trees ({PRE_N} motions x {PRE_T} "
          f"frames each of AIST++ (9 cameras), TotalCapture (8), 3DPW, "
          f"3DPW-OCC; AMASS {PRE_N} x {2 * PRE_T} frames at 120 fps) built "
          f"in {t_build:.1f} s; the preprocess command on the card per "
          f"--dataset {secs} s; the CPU's drivers {t_cpu:.1f} s; card "
          f"against CPU (positions, rotations, keypoints within "
          f"{PRE_ATOL}; accelerations within 3600 (4 delta + 2 eps32 "
          f"max|v|)): " + ", ".join(
              f"{k} {g:.2e} (acc bound {bnd:.2e}, delta {dl:.2e})"
              for k, (g, bnd, dl) in held.items())
          + f"; not_aligned {flagged}", flush=True)
    print(f"[preprocess] amass_sequence_to_work, {AMASS_FRAMES} frames at "
          f"120 fps -> {n_out} at 60 fps, {card}: card "
          f"{timed['card'] * 1e3:.2f} ms ({fps['card']:.0f} frames/s), CPU "
          f"{timed['CPU'] * 1e3:.2f} ms ({fps['CPU']:.0f} frames/s), "
          f"median of 3 (host clock, synchronized); "
          f"{sum(syncs.values())} synchronizing calls on the card "
          f"{dict(syncs)}; phase 11 (c) in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    return dict(secs=secs, held=held, fps=fps, syncs=sum(syncs.values()))


# ---------------------------------------------------------------------------
# Phase 12: live capture
# ---------------------------------------------------------------------------

LIVE_CAPTURE_FRAMES = 240   # 4 s of detector ticks at 60 Hz
LIVE_CALIB_SAMPLES = 120    # the fakes' first 2 s at 60 Hz, for the T-pose
LIVE_FIXTURE_T = 120        # the fixture motion the fakes and stand-in loop
LIVE_SEED = 31
# KeypointNormalizer (float32: pixel fractions times the image size, then
# K^-1) against the fixture's normalized keypoints: a few float32 roundings
# of pixel coordinates up to ~640, over a focal length of ~620
UV_BOUND = 1e-6
# rotation matrices axis-angle -> matrix -> MotionViewer's axis-angle ->
# 6-digit text -> matrix: float32 conversions and the text's rounding
VIEWER_BOUND = 1e-4
VIEWER_FRAMES = 8
# latency is also summarized from this frame on: the first frame's warm-up
# queues the packets behind it, which the following frames drain
LIVE_STEADY_FROM = 60


def _mediapipe_standin(landmarks):
    r"""A ``mediapipe`` module whose ``Pose().process(frame)`` returns
    ``landmarks[int(frame[0, 0, 0])]`` as MediaPipe's landmark list, or no
    detection where that entry is ``None``."""
    import types
    from types import SimpleNamespace as NS

    def process(frame):
        lm = landmarks[int(frame[0, 0, 0])]
        if lm is None:
            return NS(pose_landmarks=None)
        return NS(pose_landmarks=NS(landmark=[
            NS(x=float(x), y=float(y), visibility=float(v))
            for x, y, v in lm]))

    mp = types.ModuleType("mediapipe")
    mp.solutions = NS(pose=NS(Pose=lambda **kw: NS(process=process)))
    return mp


def _thread(target, errors, **kw):
    import threading

    def run():
        try:
            target(**kw)
        except Exception as e:   # reported by the caller after the join
            errors.append(f"{getattr(target, '__name__', target)}: "
                          f"{type(e).__name__}: {e}")
    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th


def _pose_R(pose_aa):
    r"""Axis-angle poses [T, 24, 3] -> rotation matrices [T, 24, 3, 3] on
    the CPU, in float64."""
    import torch
    from robustcap_tpu_torch.math.angular import axis_angle_to_rotation_matrix
    aa = torch.as_tensor(np.asarray(pose_aa, np.float64))
    return axis_angle_to_rotation_matrix(aa).reshape(len(aa), 24, 3, 3)


def check_live_capture(params, model, dev, card,
                       frames=LIVE_CAPTURE_FRAMES, calib=LIVE_CALIB_SAMPLES,
                       rate=60.0):
    r"""Phase 12: the live-capture chain in-process, threads over loopback
    on free ports. Six ``FakeDotTransport``s playing a fixture motion's IMUs
    (pumped at ``rate``) feed ``run_imu_bridge``'s ``XsensDotSet``; a
    receiver decodes the bridge's UDP packets, calibrates with
    ``tpose_calibration`` on the first ``calib`` of them and pushes the rest
    into ``ImuCamStream``; ``run_detector`` (a ``mediapipe`` stand-in giving
    the fixture's keypoints as pixel fractions, some frames without a
    detection) sends ``frames`` packets to a relay that records them and
    forwards them to ``run_live_demo`` (``live_mode()`` with the tail
    kernel); a Unity client reads the frames. Then the recorded packets are
    replayed through ``LiveServer.process`` with the plain tail on ``dev``
    and on the CPU and held against the frames received, and a short
    ``MotionViewer`` round trip sends the replay's poses to a client.
    Returns ``{"geometry_tail": launches}``."""
    import socket
    import sys
    import threading

    import torch
    from robustcap_tpu_torch.config import LiveConfig, SigMPConfig
    from robustcap_tpu_torch.device import tree_map
    from robustcap_tpu_torch.eval import build_aist_sequences
    from robustcap_tpu_torch.math.angular import (
        axis_angle_to_rotation_matrix, rotation_matrix_to_quaternion)
    from robustcap_tpu_torch.ops import geometry_tail
    from robustcap_tpu_torch.preprocess import build_fixture_dataset
    from robustcap_tpu_torch.sensors import FakeDotTransport, bridge
    from robustcap_tpu_torch.smpl import ParametricModel
    from robustcap_tpu_torch.streaming import (
        ImuCamStream, LiveServer, MotionViewer, encode_detector_packet,
        encode_unity_frame, native_available, parse_detector_packet,
        parse_imu_packet, parse_unity_frame, run_live_demo,
        tpose_calibration)
    from robustcap_tpu_torch.streaming.detector import (KeypointNormalizer,
                                                        run_detector)

    t_start = time.perf_counter()
    _require(native_available(), "live capture: the native datapath did "
             "not build (native_available() is False)")
    ds = build_fixture_dataset(model, n_seq=1, T=LIVE_FIXTURE_T, n_cam=1,
                               seed=LIVE_SEED)
    seq = build_aist_sequences(ds, num_cameras=1)[0]
    ori = np.asarray(ds["imu_ori"][0], np.float32)
    acc = np.asarray(ds["imu_acc"][0], np.float32)
    T = len(ori)
    quats = rotation_matrix_to_quaternion(torch.from_numpy(
        ori.reshape(-1, 3, 3))).numpy().reshape(T, 6, 4)

    # the camera's view: fixture keypoints as pixel fractions, with frames
    # the camera drops (None from the reader) and frames without a
    # detection (None from the stand-in); the first three have none, so the
    # normalizer sends all-zero keypoints at confidence 0
    live0 = LiveConfig()
    K = np.asarray(live0.camera_intrinsic, np.float64)
    size = np.asarray([live0.camera_width, live0.camera_height], np.float64)
    landmarks, dropped = [], set()
    for k in range(frames):
        j = seq.j2dc[k % len(seq.j2dc)].astype(np.float64)
        px = np.concatenate([j[:, :2], np.ones((33, 1))], 1) @ K.T
        lm = np.concatenate([px[:, :2] / size, j[:, 2:]], 1)
        landmarks.append(None if k < 3 or k % 23 == 11
                         else lm.astype(np.float32))
        if k % 17 == 5:
            dropped.add(k)
    norm = KeypointNormalizer(K, live0.camera_width, live0.camera_height)
    expected_uv, uv_gap, reused, zeros = [], 0.0, 0, 0
    for k in range(frames):
        lm = None if k in dropped else landmarks[k]
        expected_uv.append(norm(lm).copy())
        if lm is None:
            if expected_uv[-1].any():
                reused += 1
            else:
                zeros += 1
        else:
            uv_gap = max(uv_gap, float(np.abs(
                expected_uv[-1] - seq.j2dc[k % len(seq.j2dc)]).max()))
    _require(zeros > 0, "live capture: no frame sends all-zero keypoints")
    _require(uv_gap <= UV_BOUND, f"live capture: KeypointNormalizer "
             f"{uv_gap:.2e} from the fixture's keypoints (bound {UV_BOUND})")

    live = LiveConfig(imu_udp_port=_free_port(udp=True),
                      detector_udp_port=_free_port(udp=True),
                      unity_tcp_port=_free_port(), fps=rate)
    relay_port = _free_port(udp=True)
    cfg = dataclasses.replace(SigMPConfig.live_mode(), pallas_tail=True)
    n_bridge = calib + int(frames * rate / 60.0) + int(rate)

    transports, sets, errors = [], [], []

    def factory(addr):
        i = len(transports)
        tr = FakeDotTransport(address=addr, signal_fn=lambda f, i=i: (
            quats[f % T, i], acc[f % T, i]))
        transports.append(tr)
        return tr

    class KeptDotSet(bridge.XsensDotSet):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            sets.append(self)

    stop_pump, stop_rx = threading.Event(), threading.Event()
    stream_ready = threading.Event()
    box = {"rx": 0, "calib_q": []}

    def pump():
        nxt = time.perf_counter()
        while not stop_pump.is_set():
            for tr in list(transports):
                tr.pump(1)
            nxt += 1.0 / rate
            stop_pump.wait(max(0.0, nxt - time.perf_counter()))

    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", live.imu_udp_port))
    rx.settimeout(0.2)

    def receive():
        while not stop_rx.is_set():
            try:
                buf = rx.recv(4096)
            except socket.timeout:
                continue
            t, q, a = parse_imu_packet(buf)
            box["rx"] += 1
            if not stream_ready.is_set():
                box["calib_q"].append(q)
                if len(box["calib_q"]) == calib:
                    cq = np.stack(box["calib_q"])          # [K, 6, 4]
                    box["calib"] = tpose_calibration(
                        cq[:, 5], cq.transpose(1, 0, 2), device=dev)
                    box["stream"] = ImuCamStream(box["calib"], device=dev)
                    stream_ready.set()
                continue
            for i in range(6):
                box["stream"].push(i, t, q[i], a[i])

    class TimedStream:
        def __init__(self, stream):
            self.stream, self.ms, self.R_CB = stream, [], []

        def tick(self):
            t0 = time.perf_counter()
            out = self.stream.tick()
            if out is not None:
                self.ms.append((time.perf_counter() - t0) * 1e3)
                self.R_CB.append(out[1])
            return out

    relay = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    relay.bind(("127.0.0.1", relay_port))
    relay.settimeout(60)
    recorded = []

    def forward():
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as out:
            for _ in range(frames):
                buf = relay.recv(65536)
                recorded.append((time.perf_counter(), buf))
                out.sendto(buf, ("127.0.0.1", live.detector_udp_port))

    def reader(k):
        return None if k in dropped else np.full((1, 1, 3), k, np.float32)

    cam_k = iter(range(frames))
    saved_mp = sys.modules.get("mediapipe")
    sys.modules["mediapipe"] = _mediapipe_standin(landmarks)
    bridge_cls = bridge.XsensDotSet
    bridge.XsensDotSet = KeptDotSet
    threads, out_frames, out_t, buf = {}, [], [], b""
    try:
        geometry_tail.LAUNCHES = 0
        threads["server"] = _thread(
            run_live_demo, errors, params=params, model=model, cfg=cfg,
            live=live, max_frames=frames, device=dev)
        unity, deadline = None, time.time() + 60
        while unity is None:
            try:
                unity = socket.create_connection(
                    ("127.0.0.1", live.unity_tcp_port), timeout=10)
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.1)
        threads["relay"] = _thread(forward, errors)
        threads["receiver"] = _thread(receive, errors)
        threads["pump"] = _thread(pump, errors)
        n_sent = []
        threads["bridge"] = _thread(
            lambda: n_sent.append(bridge.run_imu_bridge(
                addresses=[f"D0:7A:00:00:00:0{i}" for i in range(6)],
                live=live, dest=("127.0.0.1", live.imu_udp_port),
                max_packets=n_bridge, transport_factory=factory)), errors)
        _require(stream_ready.wait(60), f"live capture: no calibration "
                 f"after 60 s ({box['rx']} IMU packets; {errors})")
        timed = TimedStream(box["stream"])
        threads["detector"] = _thread(
            run_detector, errors, sync_stream=timed,
            camera_reader=lambda: reader(next(cam_k)),
            rcm=box["calib"].R_CM, live=live,
            server_addr=("127.0.0.1", relay_port), max_frames=frames)
        with unity:
            unity.settimeout(60)
            while len(out_frames) < frames:
                while b"$" not in buf:
                    chunk = unity.recv(65536)
                    _require(bool(chunk), f"live capture: the server closed "
                             f"the stream after {len(out_frames)} frames "
                             f"({errors})")
                    buf += chunk
                out_t.append(time.perf_counter())
                frame, _, buf = buf.partition(b"$")
                out_frames.append(parse_unity_frame(frame + b"$"))
        for name in ("detector", "relay", "server", "bridge"):
            threads[name].join(timeout=60)
        launches = geometry_tail.LAUNCHES
    finally:
        bridge.XsensDotSet = bridge_cls
        if saved_mp is None:
            sys.modules.pop("mediapipe", None)
        else:
            sys.modules["mediapipe"] = saved_mp
        stop_pump.set()
        stop_rx.set()
        for th in threads.values():
            th.join(timeout=10)
        rx.close()
        relay.close()
    alive = [k for k, th in threads.items() if th.is_alive()]
    _require(not alive and not errors,
             f"live capture: threads {alive} still running, errors {errors}")
    rings = sets[0]._buffers
    drops = sum(r.dropped for r in rings)
    native = all(r._lib is not None for r in rings) and \
        timed.stream.resampler._lib is not None
    _require(native, "live capture: the rings or the resampler run the "
             "Python fallback")
    _require(drops == 0, f"live capture: the rings dropped {drops} records")
    _require(len(recorded) == frames and len(out_frames) == frames,
             f"live capture: {len(recorded)} packets, {len(out_frames)} "
             f"frames for {frames} detector ticks")
    _require(launches == frames, f"live capture: {launches} geometry_tail "
             f"launches for {frames} frames, expected one per frame")
    pose_rx = np.stack([f[0] for f in out_frames])
    tran_rx = np.stack([f[1] for f in out_frames])
    _require(np.isfinite(pose_rx).all() and np.isfinite(tran_rx).all(),
             "live capture: non-finite frames")
    _require(float(np.abs(tran_rx[0]).max()) <= 1e-4,
             f"live capture: first translation {tran_rx[0]}, expected 0")
    packets = [parse_detector_packet(b) for _, b in recorded]
    # each packet's keypoints are the normalizer's, through the text format
    _require(all(np.array_equal(p[0], parse_detector_packet(
        encode_detector_packet(expected_uv[k], *p[1:]))[0])
        for k, p in enumerate(packets)),
        "live capture: the detector's keypoints are not the normalizer's")
    uv_text = max(float(np.abs(p[0] - expected_uv[k]).max())
                  for k, p in enumerate(packets))
    R_CB = np.stack(timed.R_CB)
    orth = float(np.abs(np.einsum("tnij,tnkj->tnik", R_CB, R_CB)
                        - np.eye(3)).max())
    _require(orth <= 1e-5, f"live capture: R_CB not orthonormal ({orth:.2e})")

    # replay the recorded packets with the plain tail, on dev and the CPU
    cpu = torch.device("cpu")
    plain = SigMPConfig.live_mode()
    replays = {}
    for what, p, m, d in (
            ("card" if dev.type == "cuda" else str(dev), params, model, dev),
            ("CPU", tree_map(lambda x: x.to(cpu), params),
             ParametricModel(data=model.data, device=cpu), cpu)):
        srv = LiveServer(p, m, plain, device=d)
        out = [srv.process(*pk) for pk in packets]
        replays[what] = (np.stack([o[0] for o in out]),
                         np.stack([o[1] for o in out]))
    ref_pose, ref_tran = next(iter(replays.values()))
    rounded = [parse_unity_frame(encode_unity_frame(a, t))
               for a, t in zip(ref_pose, ref_tran)]
    r_pose = float((_pose_R(np.stack([r[0] for r in rounded]))
                    - _pose_R(ref_pose)).abs().max())
    r_tran = float(np.abs(np.stack([r[1] for r in rounded])
                          - ref_tran).max())
    bounds = (POSE_MEDIAN_BOUND + r_pose, POSE_P95_BOUND + r_pose,
              TRAN_BOUND + r_tran)
    got = (_pose_R(pose_rx), torch.as_tensor(tran_rx, dtype=torch.float64))
    ok = True
    for what, (pa, ta) in replays.items():
        ok &= _compare(f"live capture: frames received (tail kernel) vs "
                       f"replay with the plain tail ({what})", got,
                       (_pose_R(pa), torch.as_tensor(ta, dtype=torch.float64)),
                       tuple(m for m in (60, 120) if m < frames) + (frames,),
                       bounds)
    _require(ok, "live capture: frames outside their bounds")

    # MotionViewer: the replay's poses as rotation matrices from dev to a
    # client, back through axis-angle and text
    viewer = MotionViewer(n=1, port=_free_port(), device=dev)
    v_errors = []
    th = _thread(viewer.connect, v_errors)
    client, deadline = None, time.time() + 30
    while client is None:
        try:
            client = socket.create_connection(("127.0.0.1", viewer.port),
                                              timeout=10)
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.05)
    v_gap, vbuf = 0.0, b""
    try:
        with client:
            client.settimeout(30)

            def read_msg():
                nonlocal vbuf
                while b"$" not in vbuf:
                    chunk = client.recv(65536)
                    _require(bool(chunk), "MotionViewer closed the stream")
                    vbuf += chunk
                msg, _, vbuf = vbuf.partition(b"$")
                return msg + b"$"

            hello = read_msg().decode()
            th.join(timeout=10)
            _require(not v_errors and hello.startswith("1#")
                     and hello.endswith("#subject0$"),
                     f"MotionViewer handshake {hello!r} ({v_errors})")
            R_dev = axis_angle_to_rotation_matrix(torch.as_tensor(
                ref_pose[:VIEWER_FRAMES], device=dev)).reshape(-1, 24, 3, 3)
            for k in range(VIEWER_FRAMES):
                viewer.update_all([R_dev[k].cpu().numpy()], [ref_tran[k]])
                aa, tr = parse_unity_frame(read_msg())
                v_gap = max(v_gap, float((_pose_R(aa[None])[0] - R_dev[k]
                                          .cpu().double()).abs().max()),
                            float(np.abs(tr - ref_tran[k]).max()))
    finally:
        viewer.close()
    _require(v_gap <= VIEWER_BOUND, f"MotionViewer round trip {v_gap:.2e} "
             f"(bound {VIEWER_BOUND})")

    lat = (np.asarray(out_t) - np.asarray([t for t, _ in recorded])) * 1e3
    steady = lat[LIVE_STEADY_FROM:] if frames > LIVE_STEADY_FROM else lat
    tick_ms = np.asarray(timed.ms)
    fps = (frames - 1) / (out_t[-1] - out_t[0])

    def pq(x, scale=1.0, unit="ms"):
        return (f"p50 {np.median(x) * scale:.3f} {unit}, p95 "
                f"{np.percentile(x, 95) * scale:.3f} {unit}")
    print(f"[live] phase 12, {card}: {frames} frames through the chain "
          f"(fake DOTs -> XsensDotSet -> run_imu_bridge -> UDP -> "
          f"ImuCamStream -> run_detector -> relay -> run_live_demo, "
          f"live_mode + tail kernel -> Unity): {fps:.2f} frames/s at the "
          f"Unity client; latency packet-in at the relay to frame-out at "
          f"Unity {pq(lat)}, first frame {lat[0]:.3f} ms, from frame "
          f"{LIVE_STEADY_FROM} on {pq(steady)} (host clock); "
          f"ImuCamStream.tick host time {pq(tick_ms, 1e3, 'us')} over "
          f"{len(tick_ms)} ticks; "
          f"IMU packets sent {n_sent[0]}, received {box['rx']} "
          f"({calib} for the T-pose calibration), resampler ticks "
          f"{len(tick_ms)}; ring drops {drops}; native datapath {native}; "
          f"geometry_tail launches {launches} for {frames} frames; "
          f"keypoints: normalizer vs fixture {uv_gap:.2e} (bound "
          f"{UV_BOUND}), the packets' are the normalizer's through the "
          f"text ({uv_text:.2e}), "
          f"{zeros} frames before the first detection sent all-zero "
          f"keypoints, {reused} later ones without a detection reused the "
          f"last; R_CB "
          f"orthonormal within {orth:.2e}; text rounding widens the bounds "
          f"by pose {r_pose:.2e}, tran {r_tran:.2e} m; MotionViewer round "
          f"trip {v_gap:.2e} over {VIEWER_FRAMES} frames (bound "
          f"{VIEWER_BOUND}); phase 12 in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    return {"geometry_tail": launches}


# ---------------------------------------------------------------------------
# Phase 13: dynamics, display and the facade on the card
# ---------------------------------------------------------------------------

DYN_STATES = 3
DYN_SEED = 41
DYN_JOINT = 18               # the point Jacobian's joint (left elbow)
DYN_F64_REL = 1e-9           # card against CPU, float64: other sum orders
DYN_F32_REL = 1e-4           # float32 M and h (second derivatives of FK)
DYN_RESIDUAL = 1e-4          # |(M + 1e-6 I) qdd - (tau - h)| / |tau - h|
DYN_REPS = 5
VIEW_FRAMES = 2
# 4 and 5 decimals in the Unity text: the axis-angle's rounding moves a
# rotation-matrix entry by at most about 2.2e-4, the translation by 5e-6 m
UNITY_POSE_TEXT = 2.5e-4
UNITY_TRAN_TEXT = 1e-5


def _dyn_quantities(dyn, q, qd, qdd, tau):
    return {"M": dyn.mass_matrix(q), "h": dyn.bias_force(q, qd),
            "inverse": dyn.inverse_dynamics(q, qd, qdd),
            "forward": dyn.forward_dynamics(q, qd, tau),
            "jacobian": dyn.point_jacobian(q, DYN_JOINT), "com": dyn.com(q),
            "zmp": dyn.zmp(q, qd, qdd)}


def check_dynamics(model, dev, card):
    r"""Phase 13 (a): ``RigidBodyDynamics`` on the full-width body on the
    card at ``DYN_STATES`` seeded states in float32 and float64, against
    the same on the CPU: float64 within ``DYN_F64_REL`` of each quantity's
    largest magnitude; float32 ``M`` and ``h`` within ``DYN_F32_REL``,
    forward dynamics by its residual (``M + 1e-6 I`` has a condition number
    near 1e5); ``M`` symmetric and positive definite, free fall within 0.5
    of -9.81. Prints each function's ms a call (host clock around
    synchronized calls) and its synchronizing calls a call."""
    import torch
    from robustcap_tpu_torch.dynamics import RigidBodyDynamics
    from robustcap_tpu_torch.smpl import ParametricModel

    cpu = torch.device("cpu")
    t_start = time.perf_counter()
    for dtype in (torch.float32, torch.float64):
        on_card = (model if dtype == torch.float32 else ParametricModel(
            data=model.data, dtype=dtype, device=dev))
        dyn = RigidBodyDynamics(on_card)
        ref = RigidBodyDynamics(ParametricModel(data=model.data, dtype=dtype,
                                                device=cpu))
        eye = torch.eye(dyn.num_q, dtype=torch.float64)
        zero = torch.zeros(dyn.num_q, dtype=dtype, device=dev)
        fall = float(dyn.forward_dynamics(zero, zero, zero)[1])
        _require(abs(fall + 9.81) < 0.5, f"dynamics {dtype}: free fall "
                 f"{fall:.4f}, expected -9.81 within 0.5")
        worst, resid, asym, eig_min = {}, 0.0, 0.0, np.inf
        rng = np.random.RandomState(DYN_SEED)
        for _ in range(DYN_STATES):
            # q, qdot, qddot from N(0, 0.1), tau from N(0, 5)
            state = [rng.normal(0, s, dyn.num_q) for s in (0.1, 0.1, 0.1,
                                                            5.0)]
            got = _dyn_quantities(dyn, *(torch.as_tensor(
                x, dtype=dtype, device=dev) for x in state))
            want = _dyn_quantities(ref, *(torch.as_tensor(x, dtype=dtype)
                                          for x in state))
            for k, v in got.items():
                _require(bool(torch.isfinite(v).all()),
                         f"dynamics {dtype}: {k} not finite")
                rel = float((v.cpu() - want[k]).abs().max()
                            / want[k].abs().max())
                worst[k] = max(worst.get(k, 0.0), rel)
            Mm = got["M"].double().cpu()
            asym = max(asym, float((Mm - Mm.T).abs().max() / Mm.abs().max()))
            eig_min = min(eig_min, float(torch.linalg.eigvalsh(
                Mm + 1e-6 * eye).min()))
            rhs = torch.as_tensor(state[3]) - got["h"].double().cpu()
            resid = max(resid, float(((Mm + 1e-6 * eye) @ got["forward"]
                                      .double().cpu() - rhs).norm()
                                     / rhs.norm()))
        held = (worst if dtype == torch.float64
                else {k: worst[k] for k in ("M", "h")})
        bound = DYN_F64_REL if dtype == torch.float64 else DYN_F32_REL
        _require(all(v <= bound for v in held.values()),
                 f"dynamics {dtype}: card against CPU {held} (bound {bound})")
        _require(resid <= DYN_RESIDUAL, f"dynamics {dtype}: forward "
                 f"dynamics residual {resid:.2e} (bound {DYN_RESIDUAL})")
        _require(asym <= (1e-12 if dtype == torch.float64 else 1e-5)
                 and eig_min > 0, f"dynamics {dtype}: M asymmetric by "
                 f"{asym:.2e} or not positive definite ({eig_min:.3e})")

        q, qd, qdd, tau = (torch.as_tensor(x, dtype=dtype, device=dev)
                           for x in state)
        calls = {"mass_matrix": lambda: dyn.mass_matrix(q),
                 "bias_force": lambda: dyn.bias_force(q, qd),
                 "inverse_dynamics": lambda: dyn.inverse_dynamics(q, qd,
                                                                  qdd),
                 "forward_dynamics": lambda: dyn.forward_dynamics(q, qd, tau),
                 "point_jacobian": lambda: dyn.point_jacobian(q, DYN_JOINT),
                 "com": lambda: dyn.com(q),
                 "zmp": lambda: dyn.zmp(q, qd, qdd)}
        timing = []
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DYN_REPS):
                fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / DYN_REPS
            syncs = sum(_count_syncs(fn).values())
            timing.append(f"{name} {ms:.2f} ms, {syncs} syncs")
        print(f"[dynamics] phase 13 (a), {card}, {dtype}, "
              f"{model.num_verts}-vertex body, {DYN_STATES} seeded states: "
              f"card vs CPU max relative "
              + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
              + f" (held: {', '.join(held)} within {bound}); forward "
              f"dynamics residual {resid:.2e} (bound {DYN_RESIDUAL}); M "
              f"asymmetry {asym:.2e}, least eigenvalue of M + 1e-6 I "
              f"{eig_min:.3e}; free fall {fall:.4f} m/s^2; a call (host "
              f"clock, {DYN_REPS} synchronized calls): " + "; ".join(timing),
              flush=True)
    print(f"[dynamics] phase 13 (a) in {time.perf_counter() - t_start:.1f} s",
          flush=True)


def _unity_files(out_dir):
    def read(name):
        with open(os.path.join(out_dir, name)) as f:
            return np.array([[float(v) for v in line.split(",")]
                             for line in f.read().split("\n")])
    return read("pose.txt").reshape(-1, 24, 3), read("tran.txt")


def check_views(params, model, dev, card):
    r"""Phase 13 (b)-(d): ``run_single_view`` with the serve kernel on phase
    7's fixture sequence against the kernels off, within phase 4's bounds
    (its serve launches counted into the kernel line), then refined by
    SMPLify; ``view_aist`` at 1920x1080 over ``VIEW_FRAMES`` frames with
    the default configuration, the skinning's and the software renderer's
    seconds a frame apart; ``view_aist_unity`` on the card against the same
    call on the CPU; the facade's calls on the card. Returns
    ``{"serve_scan": launches}``."""
    import tempfile

    import torch
    from robustcap_tpu_torch import compat as art
    from robustcap_tpu_torch.config import SigMPConfig
    from robustcap_tpu_torch.device import tree_map
    from robustcap_tpu_torch.eval import (build_aist_sequences,
                                          run_single_view, view_aist,
                                          view_aist_unity)
    from robustcap_tpu_torch.ops import serve_scan
    from robustcap_tpu_torch.preprocess import build_fixture_dataset
    from robustcap_tpu_torch.smpl import ParametricModel, synthetic_smpl_data
    from robustcap_tpu_torch.viz import render as R

    t_start = time.perf_counter()
    ds = build_fixture_dataset(model, n_seq=EVAL_SEQ, T=EVAL_T, n_cam=EVAL_CAM,
                               seed=EVAL_SEED)
    seq = build_aist_sequences(ds, num_cameras=EVAL_CAM)[0]
    serve_scan.LAUNCHES = 0
    kernel = run_single_view(params, model, seq,
                             cfg=SigMPConfig(pallas_serve=True),
                             run_smplify=False)
    refined = run_single_view(params, model, seq,
                              cfg=SigMPConfig(pallas_serve=True))
    launches = serve_scan.LAUNCHES
    _require(launches == 2, f"run_single_view: {launches} serve launches "
             "for two calls with pallas_serve, expected one each")
    plain = run_single_view(params, model, seq, run_smplify=False)

    def as_t(x):
        return tuple(torch.as_tensor(a, dtype=torch.float64) for a in x)
    ok = _compare("run_single_view, serve kernel vs kernels off",
                  as_t(kernel), as_t(plain), (EVAL_T,))
    _require(ok, "run_single_view: the serve kernel's view outside phase "
             "4's bounds")
    _require(all(np.isfinite(x).all() for x in refined),
             "run_single_view: non-finite SMPLify output")
    move = float(np.abs(refined[0] - kernel[0]).max())

    # the overlay at 1080p: time the skinning (calc_mesh FK) and the renderer
    fk_s, render_s = [], []
    real_render = R.Renderer.render
    real_fk = type(model).forward_kinematics

    def timed_render(self, *a, **k):
        t0 = time.perf_counter()
        out = real_render(self, *a, **k)
        render_s.append(time.perf_counter() - t0)
        return out

    def timed_fk(*a, **k):
        if not k.get("calc_mesh"):
            return real_fk(model, *a, **k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_fk(model, *a, **k)
        torch.cuda.synchronize()
        fk_s.append(time.perf_counter() - t0)
        return out

    R.Renderer.render = timed_render
    model.forward_kinematics = timed_fk
    try:
        t0 = time.perf_counter()
        frames = view_aist(0, 0, params=params, model=model, dataset=ds,
                           max_frames=VIEW_FRAMES)
        view_s = time.perf_counter() - t0
    finally:
        R.Renderer.render = real_render
        del model.forward_kinematics
    _require(len(frames) == VIEW_FRAMES and all(
        f.shape == (1080, 1920, 3) and f.dtype == np.uint8 and f.any()
        for f in frames), "view_aist: expected non-empty 1080p frames")

    # Unity export on the card and on the CPU
    cpu = torch.device("cpu")
    with tempfile.TemporaryDirectory() as d:
        card_dir = view_aist_unity(0, 1, params=params, model=model,
                                   dataset=ds, out_dir=os.path.join(d, "c"))
        cpu_dir = view_aist_unity(
            0, 1, params=tree_map(lambda x: x.to(cpu), params),
            model=ParametricModel(data=model.data, device=cpu), dataset=ds,
            out_dir=os.path.join(d, "h"))
        (aa_c, tr_c), (aa_h, tr_h) = _unity_files(card_dir), \
            _unity_files(cpu_dir)
    _require(aa_c.shape == (EVAL_T, 24, 3) and tr_c.shape == (EVAL_T, 3),
             f"view_aist_unity: files of shape {aa_c.shape}, {tr_c.shape}")
    ok = _compare("view_aist_unity, card vs CPU (Unity text)",
                  (_pose_R(aa_c), torch.as_tensor(tr_c)),
                  (_pose_R(aa_h), torch.as_tensor(tr_h)), (EVAL_T,),
                  (POSE_MEDIAN_BOUND + UNITY_POSE_TEXT,
                   POSE_P95_BOUND + UNITY_POSE_TEXT,
                   TRAN_BOUND + UNITY_TRAN_TEXT))
    _require(ok, "view_aist_unity: card outside its bounds from the CPU")
    _require(float(np.abs(tr_c[0]).max()) <= 1e-4,
             "view_aist_unity: first translation not zeroed")

    # the facade, as tests/test_filters_compat.py calls it, on the card
    Rm = art.math.axis_angle_to_rotation_matrix(
        torch.tensor([[0.1, 0, 0]], device=dev))
    body = art.ParametricModel(data=synthetic_smpl_data(num_verts=100),
                               device=dev)
    lp = art.LowPassFilterRotation(0.5, device=dev)
    for _ in range(3):
        smooth = torch.as_tensor(lp(Rm[0].cpu().numpy()), device=dev)
    img = art.Renderer(resolution=(64, 48), model=model).render(
        None, model._v_template + torch.tensor([0, 0, 3.0], device=dev),
        np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]]))
    err = float(art.PositionErrorEvaluator()(torch.zeros(2, 3, device=dev),
                                             torch.zeros(2, 3, device=dev)))
    _require(Rm.shape == (1, 3, 3) and Rm.device.type == dev.type
             and err == 0.0 and art.SMPLJoint.LELBOW.value == 18
             and body.num_joints == 24 and body.device.type == dev.type
             and float((smooth - Rm[0]).abs().max()) < 1e-5 and img.any(),
             "compat: the facade's calls on the card")
    print(f"[views] phase 13 (b)-(d), {card}: run_single_view (phase 7's "
          f"fixture, {EVAL_T} frames) with the serve kernel held against "
          f"the kernels off; SMPLify moves its pose entries by up to "
          f"{move:.3e}; serve launches {launches}; view_aist at 1920x1080, "
          f"{VIEW_FRAMES} frames with SMPLify in {view_s:.2f} s: skinning "
          f"(one calc_mesh FK for the frames) {sum(fk_s):.4f} s, "
          f"{sum(fk_s) / VIEW_FRAMES:.4f} s a frame; software renderer "
          f"{np.mean(render_s):.2f} s a frame over {model.face.shape[0]} "
          f"faces (host); view_aist_unity card vs CPU held; compat on the "
          f"card held; phase 13 (b)-(d) in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    return {"serve_scan": launches}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "drives the port on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:2] == ["--gloo-child"]:
        return gloo_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                          sys.argv[5])
    if sys.argv[1:2] == ["--nccl-shared-card-child"]:
        return nccl_shared_card_child(int(sys.argv[2]), int(sys.argv[3]))
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
    check_batched(params, model, dev)
    for key, n in check_eval(params, model, dev).items():
        launches[key] += n
    for key, n in check_serving(params, model, dev).items():
        launches[key] += n
    for key, n in check_smplify(params, model, dev).items():
        launches[key] += n
    t10 = time.perf_counter()
    check_training_steps(model, dev)
    for key, n in check_training_e2e(model, dev).items():
        launches[key] += n
    print(f"[train] phase 10 in {time.perf_counter() - t10:.1f} s",
          flush=True)
    t11 = time.perf_counter()
    card = smi.stdout.strip()
    check_parallel_nccl(model, dev, card)
    check_parallel_gloo(model, dev, card)
    check_preprocess(model, dev, card)
    print(f"[parallel] phase 11 in {time.perf_counter() - t11:.1f} s",
          flush=True)
    for key, n in check_live_capture(params, model, dev, card).items():
        launches[key] += n
    t13 = time.perf_counter()
    check_dynamics(model, dev, card)
    for key, n in check_views(params, model, dev, card).items():
        launches[key] += n
    print(f"[dynamics] phase 13 in {time.perf_counter() - t13:.1f} s",
          flush=True)

    kernels = [
        dict(name="lstm_scan", route="cuda",
             source="robustcap_tpu_torch/csrc/lstm_scan.cu",
             replaces="robustcap_tpu/ops/pallas_lstm.py:166",
             launches=launches["lstm_scan"],
             max_abs_err=max(r["max_abs_err"] for r in lstm.values()),
             **{k: v for k, v in lstm["rnn2"].items()
                if k not in ("max_abs_err", "split")}),
        dict(name="geometry_tail", route="cuda",
             source="robustcap_tpu_torch/csrc/geometry_tail.cu",
             replaces="robustcap_tpu/ops/pallas_tail.py:468",
             launches=launches["geometry_tail"], **tail),
    ]
    kernels += [
        dict(name="serve_scan" if mode == "f32" else f"serve_scan_{mode}",
             mode=mode, route="cuda", operator="robustcap::serve_scan",
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

r"""The port's streaming modules (``robustcap_tpu_torch/streaming/``) and
its ``LiveConfig`` and ``default_body_model``, against the port's
``StreamingNet`` and the JAX package, mirroring ``tests/test_multiplexer.py``,
``tests/test_streaming.py`` and ``tests/test_live_pipeline_e2e.py``.

Both packages get the same numpy frames and the same weights (JAX
``init_params`` at the small ``SPECS``, carried across with
``params_from_numpy``). Tolerances: each multiplexer row against the port's
``StreamingNet`` 3e-5, the JAX test's bound (and with ``pallas_tail``
against the port's multiplexer without it); against JAX's multiplexer and
server 5e-4, as ``tests/test_torch_batched.py`` holds float32 against JAX
(XLA and PyTorch sum in other orders, compounded through the carried
states). The live server's pose is compared as rotation matrices, since
axis-angle is unstable near an angle of pi. Every socket and thread join
has a timeout, so that no test can hang.
"""

import dataclasses
import os
import socket
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robustcap_tpu.math as JM
from robustcap_tpu.config import LiveConfig as JaxLiveConfig
from robustcap_tpu.config import SigMPConfig as JaxConfig
from robustcap_tpu.streaming import LiveServer as JaxLiveServer
from robustcap_tpu.streaming import StreamingMultiplexer as JaxMultiplexer
from robustcap_tpu.streaming import protocol as jproto
from robustcap_tpu_torch.config import LiveConfig, SigMPConfig
from robustcap_tpu_torch.math.angular import axis_angle_to_rotation_matrix
from robustcap_tpu_torch.models import sig_mp as tsig
from robustcap_tpu_torch.smpl import default_body_model
from robustcap_tpu_torch.streaming import (LiveServer, StreamingMultiplexer,
                                           measure_streaming_latency,
                                           protocol, run_live_demo)
from test_torch_tail import make_inputs, make_models, make_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL_PORT = 3e-5
ATOL_JAX = 5e-4
LIVE_CFG = dict(live=True, conf_range=(0.85, 0.9), tran_filter_num=0.01,
                update_vision_freq=5)
# per stream: occluded, mid-confidence and confident frames
CONFS = ([0.95, 0.2, 0.75, 0.1, 0.95, 0.92], [0.2, 0.1, 0.95, 0.95, 0.3, 0.9],
         [0.75, 0.95, 0.05, 0.72, 0.95, 0.95])


@pytest.fixture(scope="module")
def world():
    jm, tm = make_models(num_verts=300)
    jp, tp = make_params(5)
    return jm, tm, jp, tp


def _tick(streams, slots, t, capacity):
    j = np.zeros((capacity, 33, 3), np.float32)
    a = np.zeros((capacity, 6, 3), np.float32)
    o = np.tile(np.eye(3, dtype=np.float32), (capacity, 6, 1, 1))
    for k, (j2, ac, orc) in enumerate(streams):
        j[slots[k]], a[slots[k]], o[slots[k]] = j2[t], ac[t], orc[t]
    return j, a, o


def test_multiplexer_matches_streams_and_jax(world):
    r"""Three sessions in a capacity-4 multiplexer: each row as an
    independent ``StreamingNet``, and as JAX's multiplexer."""
    jm, tm, jp, tp = world
    T, cap = 6, 4
    streams = [make_inputs(40 + k, c) for k, c in enumerate(CONFS)]
    mux = StreamingMultiplexer(tp, tm, SigMPConfig(), capacity=cap,
                               device="cpu")
    jmux = JaxMultiplexer(jp, jm, JaxConfig(), capacity=cap)
    slots = [mux.open_slot() for _ in streams]
    assert slots == [jmux.open_slot() for _ in streams]
    first = np.arange(cap) < len(streams)
    got, want_j = [], []
    for t in range(T):
        batch = _tick(streams, slots, t, cap)
        ff = first if t == 0 else None
        got.append(mux.step(*batch, first_frame=ff))
        want_j.append(jmux.step(*batch, first_frame=ff))
        assert got[-1][0].shape == (cap, 24, 3, 3)
        assert got[-1][1].shape == (cap, 3)
    for k, (j2, ac, orc) in enumerate(streams):
        net = tsig.StreamingNet(tp, tm, SigMPConfig(), device="cpu")
        for t in range(T):
            pose, tran = net.forward_online(j2[t], ac[t], orc[t],
                                            first_frame=t == 0)
            for g, w, wj in zip(got[t], (pose, tran), want_j[t]):
                np.testing.assert_allclose(g[slots[k]], w.numpy(),
                                           atol=ATOL_PORT)
                np.testing.assert_allclose(g[slots[k]],
                                           np.asarray(wj)[slots[k]],
                                           atol=ATOL_JAX)


def test_slot_reset_mid_session(world):
    r"""A new subject joins a slot mid-session: the slot restarts as a
    first-frame stream, and the other keeps its own."""
    _, tm, _, tp = world
    mux = StreamingMultiplexer(tp, tm, SigMPConfig(), capacity=2,
                               device="cpu")
    s0 = mux.open_slot()
    j2, ac, orc = make_inputs(9, CONFS[0][:4])

    def batch(t):
        return (np.repeat(j2[t][None], 2, 0), np.repeat(ac[t][None], 2, 0),
                np.repeat(orc[t][None], 2, 0))

    mux.step(*batch(0), first_frame=np.array([True, False]))
    mux.step(*batch(1))
    s1 = mux.open_slot()
    assert s1 != s0
    p, tr = mux.step(*batch(2), first_frame=np.array([False, True]))
    net = tsig.StreamingNet(tp, tm, SigMPConfig(), device="cpu")
    p_ref, t_ref = net.forward_online(j2[2], ac[2], orc[2], first_frame=True)
    np.testing.assert_allclose(p[s1], p_ref.numpy(), atol=ATOL_PORT)
    np.testing.assert_allclose(tr[s1], t_ref.numpy(), atol=ATOL_PORT)
    old = tsig.StreamingNet(tp, tm, SigMPConfig(), device="cpu")
    for t in range(3):
        p_old, t_old = old.forward_online(j2[t], ac[t], orc[t],
                                          first_frame=t == 0)
    np.testing.assert_allclose(tr[s0], t_old.numpy(), atol=ATOL_PORT)


def test_capacity_limit(world):
    _, tm, _, tp = world
    mux = StreamingMultiplexer(tp, tm, SigMPConfig(), capacity=1,
                               device="cpu")
    mux.open_slot()
    with pytest.raises(RuntimeError, match="full"):
        mux.open_slot()
    mux.close_slot(0)
    assert mux.open_slot() == 0


def test_multiplexer_with_tail_kernel_matches_jax(world):
    r"""``pallas_tail``: three sessions in a capacity-3 multiplexer, each
    tick's tails through the tail operator (its CPU implementation), against
    JAX's multiplexer with its tail kernel (Pallas interpret mode, under
    ``vmap``) and against the port's multiplexer without the flag."""
    jm, tm, jp, tp = world
    T, cap = 4, 3
    streams = [make_inputs(60 + k, c[:T]) for k, c in enumerate(CONFS)]
    muxes = [StreamingMultiplexer(tp, tm, SigMPConfig(pallas_tail=flag),
                                  capacity=cap, device="cpu")
             for flag in (True, False)]
    jmux = JaxMultiplexer(jp, jm, JaxConfig(pallas_tail=True), capacity=cap)
    slots = [jmux.open_slot() for _ in streams]
    for mux in muxes:
        assert [mux.open_slot() for _ in streams] == slots
    for t in range(T):
        batch = _tick(streams, slots, t, cap)
        ff = np.ones(cap, bool) if t == 0 else None
        got, plain = (mux.step(*batch, first_frame=ff) for mux in muxes)
        want = jmux.step(*batch, first_frame=ff)
        for g, p, w in zip(got, plain, want):
            np.testing.assert_allclose(g, np.asarray(w), atol=ATOL_JAX)
            np.testing.assert_allclose(g, p, atol=ATOL_PORT)


def _drive_schedule(world, cap, T, resets, firsts, seed, jax_too=True):
    r"""``cap`` sessions over ``T`` ticks: at tick t the slots in
    ``resets[t]`` are reset before the tick and the rows in ``firsts[t]``
    carry a first frame (tick 0: every row). Each row is held against a
    ``StreamingNet`` of its own driven the same way (``reset_states`` at a
    reset), and with ``jax_too`` every tick against JAX's multiplexer."""
    jm, tm, jp, tp = world
    streams = [make_inputs(seed + k, (CONFS[k % 3] * T)[:T])
               for k in range(cap)]
    mux = StreamingMultiplexer(tp, tm, SigMPConfig(), capacity=cap,
                               device="cpu")
    jmux = JaxMultiplexer(jp, jm, JaxConfig(), capacity=cap) if jax_too \
        else None
    nets = [tsig.StreamingNet(tp, tm, SigMPConfig(), device="cpu")
            for _ in range(cap)]
    assert [mux.open_slot() for _ in range(cap)] == list(range(cap))
    if jmux is not None:
        [jmux.open_slot() for _ in range(cap)]
    for t in range(T):
        batch = _tick(streams, range(cap), t, cap)
        first = np.zeros(cap, bool)
        first[list(firsts.get(t, range(cap) if t == 0 else ()))] = True
        for s in resets.get(t, ()):
            mux.reset_slot(s)
            nets[s].reset_states()
            if jmux is not None:
                jmux.reset_slot(s)
        ff = first if first.any() else None
        got = mux.step(*batch, first_frame=ff)
        for k, net in enumerate(nets):
            want = net.forward_online(*(x[k] for x in batch),
                                      first_frame=bool(first[k]))
            for g, w in zip(got, want):
                np.testing.assert_allclose(g[k], w.numpy(), atol=ATOL_PORT)
        if jmux is not None:
            for g, w in zip(got, jmux.step(*batch, first_frame=ff)):
                np.testing.assert_allclose(g, np.asarray(w), atol=ATOL_JAX)
    return mux


def test_two_resets_and_a_first_frame_in_one_tick(world):
    r"""Two slots reset in one tick, each starting a session there, and a
    first frame on a third row that was not reset: one opening tick, held
    row by row against ``StreamingNet`` and against JAX's multiplexer."""
    _drive_schedule(world, cap=4, T=5, resets={2: (0, 2)},
                    firsts={2: (0, 2, 3)}, seed=80)


def test_reset_with_first_frame_a_tick_later(world):
    r"""A slot reset on one tick whose first frame comes on the next: the
    reset tick steps the fresh row without a prescan, the next one
    prescans it."""
    _drive_schedule(world, cap=3, T=5, resets={2: (1,)}, firsts={3: (1,)},
                    seed=90)


def test_returned_arrays_survive_the_next_tick(world):
    r"""The arrays a tick returns are its own: the next tick (an opening
    one and a steady one) leaves them as they were."""
    _, tm, _, tp = world
    cap = 2
    mux = StreamingMultiplexer(tp, tm, SigMPConfig(), capacity=cap,
                               device="cpu")
    streams = [make_inputs(100 + k, CONFS[k][:3]) for k in range(cap)]
    outs = []
    for t in range(3):
        outs.append(mux.step(*_tick(streams, range(cap), t, cap),
                             first_frame=np.ones(cap, bool) if t == 0
                             else None))
        if t == 0:
            kept = [x.copy() for x in outs[0]]
    for got, was in zip(outs[0], kept):
        np.testing.assert_array_equal(got, was)
    for a, b in zip(outs[0], outs[1]):
        assert not np.shares_memory(a, b)
        assert not np.array_equal(a, b)


def _rows(carry):
    r"""Every leaf of a carry with its row axis (1 for the states)."""
    for k, v in carry.items():
        if k == "states":
            yield from ((x, 1) for hc in v.values() for x in hc)
        else:
            yield v, 0


def test_carries_after_reset_show_the_fresh_row(world):
    r"""``carries`` read after ``reset_slot`` shows the reset row fresh
    and the others as they were; the ticks after the read give what they
    give without it, bit for bit."""
    _, tm, _, tp = world
    cap = 3
    streams = [make_inputs(110 + k, CONFS[k][:4]) for k in range(cap)]
    muxes = [StreamingMultiplexer(tp, tm, SigMPConfig(), capacity=cap,
                                  device="cpu") for _ in range(2)]
    outs = [[], []]
    for t in range(4):
        batch = _tick(streams, range(cap), t, cap)
        if t == 2:
            before = [x.clone() for x, _ in _rows(muxes[0].carries)]
            for mux in muxes:
                mux.reset_slot(1)
            after = list(_rows(muxes[0].carries))
            fresh = [x for x, _ in _rows(tsig.init_carry(tp))]
            assert len(after) == len(before) == len(fresh)
            for (x, axis), b, f in zip(after, before, fresh):
                torch.testing.assert_close(x.select(axis, 1), f, rtol=0,
                                           atol=0)
                for row in (0, 2):
                    torch.testing.assert_close(x.select(axis, row),
                                               b.select(axis, row), rtol=0,
                                               atol=0)
        for mux, out in zip(muxes, outs):
            out.append(mux.step(*batch, first_frame=(
                np.ones(cap, bool) if t == 0 else None)))
    for a, b in zip(*outs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("flag", ["pallas_inertial", "pallas_serve"])
def test_multiplexer_refuses_kernel_flags(world, flag):
    r"""The batched tick runs no LSTM-scan or serve kernel: either flag
    raises rather than being ignored."""
    _, tm, _, tp = world
    with pytest.raises(ValueError, match="pallas_"):
        StreamingMultiplexer(tp, tm, SigMPConfig(**{flag: True}),
                             device="cpu")


def _sensor_frames(n, seed):
    r"""Detector frames: keypoints, IMU orientations and accelerations, and
    a camera rotation R_CM away from the identity."""
    j2, ac, orc = make_inputs(seed, ([0.95, 0.5, 0.95, 0.1] * n)[:n])
    rcm = np.asarray(JM.axis_angle_to_rotation_matrix(
        jnp.asarray([[0.1, -0.3, 0.2]], jnp.float32)))[0]
    return j2, ac, orc, rcm


def test_live_server_process_matches_jax(world):
    r"""``LiveServer.process`` against the JAX server's on the same frames:
    translation within 5e-4 m (zero at the start), pose as rotation
    matrices; then after a reset."""
    jm, tm, jp, tp = world
    srv = LiveServer(tp, tm, SigMPConfig(**LIVE_CFG), device="cpu")
    jsrv = JaxLiveServer(jp, jm, JaxConfig(**LIVE_CFG))
    j2, ac, orc, rcm = _sensor_frames(8, 11)
    for t in range(8):
        if t == 6:
            srv.reset()
            jsrv.reset()
        pose, tran = srv.process(j2[t], orc[t], ac[t], rcm)
        pose_j, tran_j = jsrv.process(j2[t], orc[t], ac[t], rcm)
        assert pose.shape == (24, 3)
        np.testing.assert_allclose(tran, tran_j, atol=ATOL_JAX)
        if t in (0, 6):
            np.testing.assert_allclose(tran, 0.0, atol=1e-6)
        R = axis_angle_to_rotation_matrix(torch.from_numpy(pose)).numpy()
        R_j = np.asarray(JM.axis_angle_to_rotation_matrix(
            jnp.asarray(pose_j))).reshape(R.shape)
        np.testing.assert_allclose(R, R_j, atol=ATOL_JAX)


def _free_port(kind):
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_run_live_demo_over_loopback(world):
    r"""Detector packets over UDP -> the server -> Unity frames over TCP,
    on free local ports: one frame back per packet, the first at the
    origin."""
    _, tm, _, tp = world
    live = LiveConfig(detector_udp_port=_free_port(socket.SOCK_DGRAM),
                      unity_tcp_port=_free_port(socket.SOCK_STREAM))
    n = 6
    server = threading.Thread(
        target=run_live_demo,
        kwargs=dict(params=tp, model=tm, cfg=SigMPConfig(**LIVE_CFG),
                    live=live, max_frames=n, device="cpu"),
        daemon=True)
    server.start()
    unity, deadline = None, time.time() + 30
    while unity is None:
        try:
            unity = socket.create_connection(
                ("127.0.0.1", live.unity_tcp_port), timeout=10)
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.1)
    j2, ac, orc, rcm = _sensor_frames(n, 12)
    frames, buf = [], b""
    with unity, socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
        unity.settimeout(60)
        for t in range(n):
            tx.sendto(protocol.encode_detector_packet(j2[t], orc[t], ac[t],
                                                      rcm),
                      ("127.0.0.1", live.detector_udp_port))
            while b"$" not in buf:
                chunk = unity.recv(65536)
                assert chunk, "the server closed the connection"
                buf += chunk
            frame, _, buf = buf.partition(b"$")
            frames.append(protocol.parse_unity_frame(frame + b"$"))
    server.join(timeout=30)
    assert not server.is_alive()
    assert len(frames) == n
    assert frames[0][0].shape == (24, 3)
    np.testing.assert_allclose(frames[0][1], 0.0, atol=1e-4)
    assert np.isfinite(np.stack([f[1] for f in frames])).all()


def test_protocol_bytes_equal_jax():
    rng = np.random.RandomState(0)
    uv = rng.rand(33, 3).astype(np.float32)
    ori = rng.randn(6, 3, 3).astype(np.float32)
    acc = (rng.randn(6, 3) * 1e-4).astype(np.float32)
    rcm = np.eye(3, dtype=np.float32)
    pose = (rng.randn(24, 3) * 1e3).astype(np.float64)
    tran = rng.randn(3)
    pkt = protocol.encode_detector_packet(uv, ori, acc, rcm)
    assert pkt == jproto.encode_detector_packet(uv, ori, acc, rcm)
    for a, b in zip(protocol.parse_detector_packet(pkt),
                    jproto.parse_detector_packet(pkt)):
        np.testing.assert_array_equal(a, b)
    frame = protocol.encode_unity_frame(pose, tran)
    assert frame == jproto.encode_unity_frame(pose, tran)
    for a, b in zip(protocol.parse_unity_frame(frame),
                    jproto.parse_unity_frame(frame)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="malformed"):
        protocol.parse_detector_packet(b"1,2#3")


def test_live_config_equals_jax():
    assert dataclasses.asdict(LiveConfig()) == \
        dataclasses.asdict(JaxLiveConfig())


def test_default_body_model_is_kept_per_device():
    model = default_body_model("cpu")
    assert default_body_model("cpu") is model
    assert model.device == torch.device("cpu")
    assert model.num_verts == 6890


def test_measure_streaming_latency(world, tmp_path):
    r"""The harness returns finite statistics and writes its trace."""
    _, tm, _, tp = world
    stats = measure_streaming_latency(tp, tm, n_frames=5, warmup=3,
                                      trace_dir=str(tmp_path), device="cpu")
    assert set(stats) == {"p50_ms", "p95_ms", "p99_ms", "mean_ms", "fps"}
    assert all(np.isfinite(v) and v > 0 for v in stats.values())
    assert stats["p50_ms"] <= stats["p95_ms"] <= stats["p99_ms"]
    assert os.path.getsize(tmp_path / "trace.json") > 0

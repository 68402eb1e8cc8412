r"""The port's live-capture path against the JAX package: the math names it
needs, ``utils/``, the native datapath and its fallback, IMU-camera sync,
the Unity viewer, the detector, the IMU bridge and the ``imu-bridge``
command; then the whole chain end to end on loopback.

Both packages get the same numpy inputs from a seed. Tolerances: the math
names 1e-6 absolute (float32 conversions of unit-scale rotations, summed in
another order by XLA and PyTorch), the filters and the resamplers 1e-6
(float32 records; the native resampler interpolates in float32, the
fallbacks in float64), the calibration and the combiner's ticks 1e-5
(products of three float32 rotations). The JAX package's own datapath
compiles into the source tree, so its ``load_native`` is patched to return
``None`` here: the JAX side runs its pure-Python fallback, and no port test
writes into ``native/``. Sockets bind free ports; every join and receive
has a timeout.
"""

import os
import socket
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robustcap_tpu.math as JM
import robustcap_tpu_torch.math as TM
from robustcap_tpu.streaming import native as jnative
from robustcap_tpu.streaming import sync as jsync
from robustcap_tpu_torch.ops import _build
from robustcap_tpu_torch.streaming import native as tnative
from robustcap_tpu_torch.streaming import sync as tsync

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (phase 12 and its mediapipe stand-in)

ATOL_MATH = 1e-6
ATOL_NATIVE = 1e-6
ATOL_SYNC = 1e-5
SMPL_PARENT = [None, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
               16, 17, 18, 19, 20, 21]


@pytest.fixture(autouse=True)
def jax_fallback_datapath(monkeypatch):
    monkeypatch.setattr(jnative, "load_native", lambda: None)


def _rotations(rng, n):
    return np.array(JM.r6d_to_rotation_matrix(
        jnp.asarray(rng.randn(n, 6).astype(np.float32))))


def _unit_quats(rng, *shape):
    q = rng.randn(*shape, 4).astype(np.float32)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _to(kind, x):
    if isinstance(x, (list, tuple)):
        return [_to(kind, v) for v in x]
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x.copy()) if kind == "torch" \
            else jnp.asarray(x)
    return x


def _math_cases():
    rng = np.random.RandomState(0)
    ang = rng.uniform(-10, 10, 256).astype(np.float32)
    # keep clear of the wrap at pi, where one rounding flips the branch
    ang = ang[np.abs(np.abs(np.mod(ang, 2 * np.pi) - np.pi)) > 1e-3]
    q = rng.randn(40, 4).astype(np.float32)
    q[:20, 0] = -np.abs(q[:20, 0]) - 2.0        # pivot column 0, half flip
    q[20:, 0] = np.abs(q[20:, 0]) + 2.0
    q[5, 0] = 0.0                               # a pivot component of 0
    R = _rotations(rng, 2 * 24)
    p = rng.randn(2 * 24, 3).astype(np.float32)
    T = np.concatenate([np.concatenate([R, p[:, :, None]], 2),
                        np.tile([[[0, 0, 0, 1.0]]], (48, 1, 1))], 1)
    T = T.astype(np.float32).reshape(2, 24, 4, 4)
    return {
        "normalize_angle": ((ang,), {}),
        "angle_difference": ((ang, ang[::-1].copy()), {}),
        "quaternion_product": ((rng.randn(8, 5, 4).astype(np.float32),
                                rng.randn(8, 5, 4).astype(np.float32)), {}),
        "quaternion_inverse": ((rng.randn(7, 4).astype(np.float32),), {}),
        "quaternion_mean": ((q,), {}),
        "block_diagonal_matrix": (([rng.randn(2, 3).astype(np.float32),
                                    rng.randn(1, 1).astype(np.float32),
                                    rng.randn(3, 2).astype(np.float32)],),
                                  {}),
        "transformation_matrix": ((R[:6], p[:6]), {}),
        "decode_transformation_matrix": ((T[0],), {}),
        "inverse_transformation_matrix": ((T[0],), {}),
        "forward_kinematics_T": ((T,), {"parent": SMPL_PARENT}),
        "inverse_kinematics_T": ((T,), {"parent": SMPL_PARENT}),
        "rotation_matrix_to_euler_angle": ((R,), {"seq": "YXZ"}),
    }


@pytest.mark.parametrize("name", sorted(_math_cases()))
def test_math_names_match_jax(name):
    args, kw = _math_cases()[name]
    got = getattr(TM, name)(*_to("torch", list(args)), **kw)
    want = getattr(JM, name)(*_to("jax", list(args)), **kw)
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == np.shape(w), name
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL_MATH, rtol=0)


def test_quaternion_mean_keeps_a_zero_pivot_sample():
    r"""A sample whose pivot component is exactly 0 is kept, not zeroed (a
    ``sign()`` flip would drop it from the mean)."""
    q = torch.tensor([[0.0, 1.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0],
                      [0.0, 0.8, 0.6, 0.0]])
    np.testing.assert_allclose(TM.quaternion_mean(q).numpy(),
                               np.asarray(JM.quaternion_mean(
                                   jnp.asarray(q.numpy()))), atol=ATOL_MATH)
    assert float(TM.quaternion_mean(q)[2]) > 0.1


def test_model_transform_kinematics_and_skeleton_constants():
    from robustcap_tpu import config as jconfig
    from robustcap_tpu.smpl import ParametricModel as JaxModel
    from robustcap_tpu.smpl import armature as jarm
    from robustcap_tpu.smpl import synthetic_smpl_data as jax_synthetic
    from robustcap_tpu_torch import config as tconfig
    from robustcap_tpu_torch.smpl import (MANOJoint, ParametricModel,
                                          SMPLHJoint, SMPLJoint,
                                          synthetic_smpl_data)
    T = _math_cases()["forward_kinematics_T"][0][0]
    jm = JaxModel(data=jax_synthetic(num_verts=100))
    tm = ParametricModel(data=synthetic_smpl_data(num_verts=100),
                         device="cpu")
    for fn in ("forward_kinematics_T", "inverse_kinematics_T"):
        np.testing.assert_allclose(
            getattr(tm, fn)(torch.from_numpy(T)).numpy(),
            np.asarray(getattr(jm, fn)(jnp.asarray(T))), atol=ATOL_MATH)
    back = tm.inverse_kinematics_T(tm.forward_kinematics_T(
        torch.from_numpy(T)))
    np.testing.assert_allclose(back.numpy(), T, atol=1e-5)
    for ours, theirs in ((SMPLJoint, jarm.SMPLJoint),
                         (MANOJoint, jarm.MANOJoint),
                         (SMPLHJoint, jarm.SMPLHJoint)):
        assert [(m.name, m.value) for m in ours] == \
            [(m.name, m.value) for m in theirs]
        assert dict(ours.__members__).keys() == \
            dict(theirs.__members__).keys()
    for attr in ("n_keypoints", "labels", "parents", "extended_keypoints"):
        assert getattr(tconfig.HUMBIBody33, attr) == \
            getattr(jconfig.HUMBIBody33, attr)


# ---------------------------------------------------------------------------
# utils/
# ---------------------------------------------------------------------------


def test_kalman_and_low_pass_match_jax():
    from robustcap_tpu.utils import KalmanFilter as JKalman
    from robustcap_tpu.utils import LowPassFilter as JLow
    from robustcap_tpu_torch.utils import KalmanFilter, LowPassFilter
    dt = 0.1
    args = (np.array([[1, dt], [0, 1]]), np.array([[1.0, 0]]),
            np.zeros((2, 1)))
    kw = dict(Q=1e-4 * np.eye(2), R=0.04 * np.eye(1),
              x0=np.array([0.0, 0.0]))
    ours, theirs = KalmanFilter(*args, **kw), JKalman(*args, **kw)
    rng = np.random.RandomState(0)
    for t in range(1, 80):
        y = np.array([2.0 * t * dt + rng.normal(0, 0.2)])
        np.testing.assert_array_equal(ours.predict(np.zeros(1)),
                                      theirs.predict(np.zeros(1)))
        np.testing.assert_array_equal(ours.correct(y), theirs.correct(y))
    assert abs(ours.x.ravel()[1] - 2.0) < 0.3
    lp, jlp = LowPassFilter(a=0.5), JLow(a=0.5)
    for x in ([2.0], [4.0], [1.0]):
        np.testing.assert_array_equal(lp(np.asarray(x)), jlp(np.asarray(x)))
    assert lp.x[0] == 2.0      # 2, then 3, then 2


def test_rotation_low_pass_matches_jax():
    from robustcap_tpu.utils import LowPassFilterRotation as JLowRot
    from robustcap_tpu_torch.utils import LowPassFilterRotation
    rng = np.random.RandomState(1)
    ours, theirs = LowPassFilterRotation(a=0.3, device="cpu"), JLowRot(a=0.3)
    for _ in range(6):
        R = _rotations(rng, 2)
        out = ours(R)
        np.testing.assert_allclose(out, theirs(R), atol=ATOL_NATIVE)
    np.testing.assert_allclose(np.einsum("nij,nik->njk", out, out),
                               np.broadcast_to(np.eye(3), (2, 3, 3)),
                               atol=1e-5)
    single = LowPassFilterRotation(a=0.5, device="cpu")
    single(np.eye(3, dtype=np.float32))
    R = TM.axis_angle_to_rotation_matrix(torch.tensor([[0.7, 0.1, -0.2]]))
    for _ in range(30):
        out = single(R[0].numpy())
    assert out.shape == (3, 3)
    assert float(TM.angle_between(torch.from_numpy(out), R)[0]) < 1e-2


def test_text_io_and_print_helpers(tmp_path, capsys):
    from robustcap_tpu.utils import load_txt_mat as jload
    from robustcap_tpu_torch.utils import (load_txt_mat, print_green,
                                           save_txt_mat)
    mat = np.random.RandomState(2).randn(4, 3)
    save_txt_mat(mat, str(tmp_path / "m.txt"))
    np.testing.assert_array_equal(load_txt_mat(str(tmp_path / "m.txt")),
                                  jload(str(tmp_path / "m.txt")))
    print_green("hello")
    assert capsys.readouterr().out == "\033[32mhello\n\033[0m"


# ---------------------------------------------------------------------------
# the native datapath and its fallback
# ---------------------------------------------------------------------------


@pytest.fixture(params=["native", "fallback"])
def impl(request, monkeypatch):
    if request.param == "fallback":
        monkeypatch.setattr(tnative, "load_native", lambda: None)
    else:
        assert tnative.native_available()
    return request.param


def test_native_library_builds_under_the_port(impl):
    r"""The port's library is its own, keyed by the source's hash under
    ``robustcap_tpu_torch/_build/``; the shared source tree is not
    written."""
    if impl == "fallback":
        assert tnative.RingBuffer(2, 1)._lib is None
        return
    lib = tnative.load_native()
    assert os.path.dirname(lib._name) == _build.BUILD_DIR
    assert lib._name == _build.host_library(tnative._SRC)
    assert tnative.RingBuffer(2, 1)._lib is lib


def test_ring_drop_oldest(impl):
    rb = tnative.RingBuffer(3, 2)
    for i in range(5):
        assert rb.push(np.full(2, i, np.float32)) == (i >= 3)
    assert len(rb) == 3 and rb.dropped == 2
    np.testing.assert_array_equal(rb.pop(), [2, 2])
    np.testing.assert_array_equal(rb.pop(), [3, 3])
    rb.clear()
    assert len(rb) == 0 and rb.pop() is None
    with pytest.raises(ValueError, match="3 floats"):
        rb.push(np.zeros(3, np.float32))


def test_ring_threaded(impl):
    r"""More producers than cores, a short switch interval: no push is
    lost (kept + dropped equals pushed) and no record is torn."""
    rb = tnative.RingBuffer(1000, 2)
    n_threads = 2 * len(os.sched_getaffinity(0))
    per = 16000 // n_threads
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def producer(k):
            for i in range(per):
                rb.push(np.asarray([k, i], np.float32))
        ts = [threading.Thread(target=producer, args=(k,))
              for k in range(n_threads)]
        [t.start() for t in ts]
        [t.join(timeout=30) for t in ts]
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert len(rb) == 1000
    assert rb.dropped == per * n_threads - 1000
    last = {}
    for k, i in (rb.pop() for _ in range(1000)):
        assert i > last.get(k, -1)     # each producer's order kept
        last[k] = i


def _resampler_script(rng):
    r"""(pushes, ticks) for 3 sensors: first samples, an interpolated
    tick, a sign flip (dot < 0), a near-identical pair (the lerp branch), a
    gap of more than two ticks (the clock jumps), unequal counts."""
    q = _unit_quats(rng, 12)
    a = rng.randn(12, 3).astype(np.float32)
    near = q[3] + 1e-3 * rng.randn(4).astype(np.float32)
    near /= np.linalg.norm(near)
    flip = -q[4] * 0.6 + q[5] * 0.2
    flip /= np.linalg.norm(flip)
    ops = [("tick",),
           ("push", 0, 0.0, q[0], a[0]), ("push", 1, 0.0, q[1], a[1]),
           ("tick",),
           ("push", 2, 0.005, q[2], a[2]), ("tick",),
           ("push", 0, 1 / 30, q[3], a[3]), ("push", 1, 1 / 30, q[4], a[4]),
           ("push", 2, 1 / 30, q[5], a[5]), ("tick",), ("tick",),
           ("push", 0, 2 / 30, near.astype(np.float32), a[6]),
           ("push", 1, 2 / 30, flip.astype(np.float32), a[7]), ("tick",),
           ("push", 2, 0.5, q[8], a[8]), ("tick",), ("tick",),
           ("push", 0, 0.52, q[9], a[9]), ("push", 1, 0.51, q[10], a[10]),
           ("tick",), ("tick",), ("tick",)]
    return ops


def _run_resampler(cls, ops):
    rs = cls(3, 60.0)
    out = []
    for op in ops:
        if op[0] == "push":
            rs.push(*op[1:])
        else:
            out.append(rs.tick())
    return out


def test_resampler_native_fallback_and_jax_agree(monkeypatch):
    ops = _resampler_script(np.random.RandomState(3))
    native = _run_resampler(tnative.ImuResampler, ops)
    assert tnative.ImuResampler(3)._lib is not None
    jax_fb = _run_resampler(jnative.ImuResampler, ops)
    monkeypatch.setattr(tnative, "load_native", lambda: None)
    fallback = _run_resampler(tnative.ImuResampler, ops)
    assert native[0] is None and native[1] is None
    assert [o is None for o in native] == [o is None for o in fallback] \
        == [o is None for o in jax_fb]
    for n, f, j in zip(native, fallback, jax_fb):
        if n is None:
            continue
        for x in (f, j):
            assert abs(n[0] - x[0]) < 1e-9
            np.testing.assert_allclose(n[1], x[1], atol=ATOL_NATIVE)
            np.testing.assert_allclose(n[2], x[2], atol=ATOL_NATIVE)
    # the clock jumped to one tick behind the newest sample after the gap
    t_after_gap = [o[0] for o in native if o is not None][4]
    assert abs(t_after_gap - (0.5 - 1 / 60)) < 1e-9
    # the interpolated tick sits halfway between the sign-aligned samples
    q, q0, q1 = native[3][1][1], ops[2][3], ops[8][3]
    assert float(np.dot(q, q0)) > 0 and float(np.dot(q, q1)) > 0


def test_resampler_rejects_malformed_samples(impl):
    rs = tnative.ImuResampler(1)
    with pytest.raises(ValueError, match="quaternion"):
        rs.push(0, 0.0, np.zeros(3, np.float32), np.zeros(3, np.float32))


def test_imu_packet_codec_equals_jax():
    rng = np.random.RandomState(0)
    q, a = rng.randn(6, 4).astype(np.float32), rng.randn(6, 3)
    pkt = tnative.encode_imu_packet(1.25, q, a)
    assert pkt == jnative.encode_imu_packet(1.25, q, a)
    for x, y in zip(tnative.parse_imu_packet(pkt),
                    jnative.parse_imu_packet(pkt)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="short IMU packet"):
        tnative.parse_imu_packet(pkt[:40])


# ---------------------------------------------------------------------------
# sync
# ---------------------------------------------------------------------------


def _calibration_inputs(rng):
    base = _unit_quats(rng, 7)
    noisy = base[:, None] + 0.02 * rng.randn(7, 30, 4).astype(np.float32)
    noisy *= np.where(rng.rand(7, 30, 1) < 0.3, -1.0, 1.0)   # sign flips
    return noisy[0].astype(np.float32), noisy[1:].astype(np.float32)


@pytest.mark.parametrize("up", [None, [0.1, -0.9, 0.2], [-1.0, 0.0, 0.0]])
def test_tpose_calibration_matches_jax(up, tmp_path):
    flat, tpose = _calibration_inputs(np.random.RandomState(4))
    ours = tsync.tpose_calibration(flat, tpose, camera_up_in_cam=up,
                                   device="cpu")
    theirs = jsync.tpose_calibration(flat, tpose, camera_up_in_cam=up)
    for k in ("R_MI", "R_SB", "R_CI", "R_CM"):
        got = getattr(ours, k)
        assert got.dtype == np.float32 and np.isfinite(got).all()
        np.testing.assert_allclose(got, getattr(theirs, k), atol=ATOL_SYNC)
    np.testing.assert_allclose(ours.R_CM @ ours.R_CM.T, np.eye(3), atol=1e-5)
    if up is not None:      # up maps to the requested camera direction
        np.testing.assert_allclose(
            ours.R_CM[:, 2], np.asarray(up) / np.linalg.norm(up), atol=1e-5)
    ours.save(str(tmp_path / "c.npz"))
    back = tsync.CalibrationResult.load(str(tmp_path / "c.npz"))
    np.testing.assert_array_equal(back.R_SB, ours.R_SB)


def test_imu_cam_stream_matches_jax():
    rng = np.random.RandomState(5)
    flat, tpose = _calibration_inputs(rng)
    calib = tsync.tpose_calibration(flat, tpose, device="cpu")
    ours = tsync.ImuCamStream(calib, device="cpu")
    theirs = jsync.ImuCamStream(jsync.CalibrationResult(
        calib.R_MI, calib.R_SB, calib.R_CI, calib.R_CM))
    assert ours.tick() is None and theirs.tick() is None
    for k in range(8):
        q, a = _unit_quats(rng, 6), rng.randn(6, 3).astype(np.float32)
        for i in range(6):
            ours.push(i, k / 50, q[i], a[i])
            theirs.push(i, k / 50, q[i], a[i])
        got, want = ours.tick(), theirs.tick()
        assert abs(got[0] - want[0]) < 1e-9
        np.testing.assert_allclose(got[1], want[1], atol=ATOL_SYNC)
        np.testing.assert_allclose(got[2], want[2], atol=ATOL_SYNC)
        np.testing.assert_allclose(np.einsum("nij,nkj->nik", got[1], got[1]),
                                   np.tile(np.eye(3), (6, 1, 1)), atol=1e-5)


def test_spikes_and_jump_sync_match_jax():
    imu_t = np.arange(0, 3, 1 / 60)
    acc = np.full_like(imu_t, 1.0)
    acc[np.searchsorted(imu_t, [1.0, 2.0])] = 20
    cam_t = np.arange(0, 3, 1 / 30)
    sharp = np.full_like(cam_t, 100.0)
    sharp[np.searchsorted(cam_t, [0.85, 1.85])] = 10
    assert tsync.detect_spikes(acc, 9.0) == jsync.detect_spikes(acc, 9.0)
    for two in (True, False):
        off = tsync.detect_jump_sync(acc, imu_t, sharp, cam_t,
                                     require_two=two)
        assert off == jsync.detect_jump_sync(acc, imu_t, sharp, cam_t,
                                             require_two=two)
        assert abs(off - 0.15) < 0.05
    assert tsync.detect_jump_sync(acc * 0, imu_t, sharp, cam_t) is None


# ---------------------------------------------------------------------------
# the Unity viewer, the detector and the bridge
# ---------------------------------------------------------------------------


def _free(kind):
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _connect(port):
    deadline = time.time() + 30
    while True:
        try:
            return socket.create_connection(("127.0.0.1", port), timeout=10)
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.05)


def _read_msg(conn, buf):
    while b"$" not in buf:
        chunk = conn.recv(65536)
        assert chunk, "the peer closed the stream"
        buf += chunk
    msg, _, rest = buf.partition(b"$")
    return msg.decode(), rest


def test_motion_viewer_round_trip_matches_jax():
    from robustcap_tpu.streaming.unity import MotionViewer as JViewer
    from robustcap_tpu_torch.streaming import MotionViewer
    rng = np.random.RandomState(6)
    viewer = MotionViewer(n=2, names=["a", "b"], port=_free(
        socket.SOCK_STREAM), device="cpu")
    th = threading.Thread(target=viewer.connect, daemon=True)
    th.start()
    R = _rotations(rng, 24).reshape(24, 3, 3)
    aa = rng.randn(24, 3).astype(np.float32) * 0.3
    trans = [rng.randn(3), rng.randn(3)]
    try:
        with _connect(viewer.port) as client:
            client.settimeout(30)
            hello, buf = _read_msg(client, b"")
            th.join(timeout=10)
            assert not th.is_alive()
            colors = ",".join("%g,%g,%g" % c for c in JViewer(n=2).colors)
            assert hello == f"2#{colors}#a,b"
            viewer.update_all([R, aa], trans)
            frame, buf = _read_msg(client, buf)
    finally:
        viewer.close()
    parts = [np.asarray([float(v) for v in p.split(",")]) for p in
             frame.split("#")]
    want = np.asarray(JM.rotation_matrix_to_axis_angle(jnp.asarray(R)))
    np.testing.assert_allclose(parts[0].reshape(24, 3), want, atol=1e-5)
    np.testing.assert_allclose(parts[2].reshape(24, 3), aa, atol=1e-5)
    np.testing.assert_allclose(parts[1], trans[0], atol=1e-5)


class _Ticks:
    def __init__(self, n, seed):
        rng = np.random.RandomState(seed)
        self.out = [None] + [(k / 60, _rotations(rng, 6), rng.randn(6, 3))
                             for k in range(n)]

    def tick(self):
        return self.out.pop(0) if self.out else None


def _detector_packets(run_detector, landmarks, n):
    port = _free(socket.SOCK_DGRAM)
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as rx:
        rx.bind(("127.0.0.1", port))
        rx.settimeout(10)
        ks = iter(range(n))

        def reader():
            k = next(ks)
            return None if k == 3 else np.full((1, 1, 3), k, np.float32)

        run_detector(_Ticks(n, 7), reader, np.eye(3, dtype=np.float32),
                     server_addr=("127.0.0.1", port), max_frames=n)
        return [rx.recv(65536) for _ in range(n)]


def test_detector_matches_jax(monkeypatch):
    r"""The same landmarks, camera drops and ticks through both detector
    loops give the same packets byte for byte; a frame without a detection
    (the camera's drop, frame 3, or the detector's, frame 5) reuses the
    last keypoints, and the normalizer matches JAX's."""
    from robustcap_tpu.streaming import detector as jdet
    from robustcap_tpu_torch.config import LiveConfig
    from robustcap_tpu_torch.streaming import detector as tdet
    from robustcap_tpu_torch.streaming.protocol import parse_detector_packet
    rng = np.random.RandomState(8)
    n = 7
    lms = [np.concatenate([rng.rand(33, 2), rng.rand(33, 1)], 1)
           .astype(np.float32) for _ in range(n)]
    lms[5] = None
    monkeypatch.setitem(sys.modules, "mediapipe",
                        chip_smoke._mediapipe_standin(lms))
    ours = _detector_packets(tdet.run_detector, lms, n)
    assert ours == _detector_packets(jdet.run_detector, lms, n)
    live = LiveConfig()
    norm = tdet.KeypointNormalizer(live.camera_intrinsic, live.camera_width,
                                   live.camera_height)
    jnorm = jdet.KeypointNormalizer(np.asarray(live.camera_intrinsic),
                                    live.camera_width, live.camera_height)
    assert norm(None).shape == (33, 3) and not norm(None).any()
    uv = [parse_detector_packet(p)[0] for p in ours]
    for k in range(n):
        lm = None if k in (3, 5) else lms[k]
        want = norm(lm)
        np.testing.assert_array_equal(want, jnorm(lm))
        np.testing.assert_allclose(uv[k], want, atol=5e-6)
    np.testing.assert_array_equal(uv[3], uv[2])
    np.testing.assert_array_equal(uv[5], uv[4])


def test_detector_without_mediapipe_raises_as_jax(monkeypatch):
    from robustcap_tpu.streaming import detector as jdet
    from robustcap_tpu_torch.streaming import detector as tdet
    monkeypatch.setitem(sys.modules, "mediapipe", None)
    msgs = []
    for run in (tdet.run_detector, jdet.run_detector):
        with pytest.raises(ImportError) as e:
            run(None, None, np.eye(3))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "requires mediapipe" in msgs[0]


def test_synthetic_source_and_bridge_match_jax(monkeypatch):
    from robustcap_tpu.sensors import SyntheticImuSource as JSource
    from robustcap_tpu_torch.config import LiveConfig
    from robustcap_tpu_torch.sensors import (SyntheticImuSource,
                                             run_imu_bridge)
    rng = np.random.RandomState(9)
    ori = _rotations(rng, 10 * 6).reshape(10, 6, 3, 3)
    acc = rng.randn(10, 6, 3).astype(np.float32)
    clock = [1000.0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    ours, theirs = SyntheticImuSource(ori, acc, device="cpu"), \
        JSource(ori, acc)
    np.testing.assert_allclose(ours.quats, theirs.quats, atol=ATOL_MATH)
    for dt in (0.0, 0.05, 0.4):
        clock[0] = 1000.0 + dt
        got, want = ours.read(), theirs.read()
        assert got[0] == want[0]
        np.testing.assert_allclose(got[1], want[1], atol=ATOL_MATH)
        np.testing.assert_array_equal(got[2], want[2])
    monkeypatch.undo()
    src = SyntheticImuSource(ori, acc, device="cpu")
    port = _free(socket.SOCK_DGRAM)
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as rx:
        rx.bind(("127.0.0.1", port))
        rx.settimeout(5)
        assert run_imu_bridge(source=src, live=LiveConfig(fps=200),
                              dest=("127.0.0.1", port), max_packets=5) == 5
        pkts = [rx.recv(4096) for _ in range(5)]
    t, q, a = tnative.parse_imu_packet(pkts[-1])
    assert q.shape == (6, 4) and a.shape == (6, 3)
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1, atol=1e-5)


def test_cli_imu_bridge_without_bleak_fails_as_jax(monkeypatch, capsys):
    from robustcap_tpu.__main__ import main as jmain
    from robustcap_tpu_torch.__main__ import main
    monkeypatch.setitem(sys.modules, "bleak", None)
    msgs = []
    for cli in (main, jmain):
        with pytest.raises(ImportError) as e:
            cli(["imu-bridge"])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "bleak" in msgs[0]
    with pytest.raises(SystemExit):
        main(["imu-bridge", "--device", "cpu"])    # no flag the JAX lacks
    assert "unrecognized arguments" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the chain end to end
# ---------------------------------------------------------------------------


def test_live_chain_end_to_end(monkeypatch, tmp_path):
    r"""``chip_smoke.py``'s phase 12 at small widths on the CPU: fake DOTs
    -> ``XsensDotSet`` -> ``run_imu_bridge`` -> UDP -> calibration and
    ``ImuCamStream`` -> ``run_detector`` (a ``mediapipe`` stand-in) ->
    relay -> ``run_live_demo`` -> a Unity client, on free ports. The
    server's tail runs the kernel's own source through its host build
    (``tests/cuda_standin/``; on the CPU the wrapper itself would run its
    plain version), the first frames' all-zero keypoints at confidence 0
    included. It holds one frame per packet, finite from a zero
    translation, the native rings with no drop, one launch per frame, the
    keypoints, and the frames against a replay of the recorded packets
    through ``LiveServer.process`` with the plain tail; then a
    ``MotionViewer`` round trip."""
    from cuda_standin import standin
    from robustcap_tpu_torch.models import sig_mp
    from robustcap_tpu_torch.ops import geometry_tail
    from robustcap_tpu_torch.smpl import ParametricModel, synthetic_smpl_data
    from test_torch_tail import SMALL_SPECS

    standin.use(monkeypatch, "geometry_tail",
                standin.build("geometry_tail", tmp_path))
    monkeypatch.setattr(sig_mp, "geometry_tail", geometry_tail._launch)
    monkeypatch.setattr(geometry_tail, "LAUNCHES", 0)
    cpu = torch.device("cpu")
    params = sig_mp.init_params(torch.Generator().manual_seed(0),
                                SMALL_SPECS, device=cpu)
    model = ParametricModel(data=synthetic_smpl_data(num_verts=300),
                            device=cpu)
    assert chip_smoke.check_live_capture(
        params, model, cpu, "CPU", frames=12, calib=20, rate=200.0) == {
        "geometry_tail": 12}

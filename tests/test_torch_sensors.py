r"""The port's sensor drivers (``robustcap_tpu_torch/sensors/``) against
the JAX package, mirroring ``tests/test_xsens_codec.py``,
``tests/test_noitom_ffi.py`` and the sensor cases of
``tests/test_viz_sensors.py``.

These modules are numpy, ``struct`` and ``ctypes`` code, so the port must
give the JAX package's bytes and arrays exactly: every encoder's bytes are
compared, ``read_mvnx``'s output dicts are compared key by key. The
Noitom mock vendor library is built with ``g++`` into a temporary
directory. The JAX package's datapath compiles into the source tree, so its
``load_native`` is patched to return ``None`` (its rings run their
pure-Python fallback); the port's rings run the native library.
"""

import asyncio
import os
import shutil
import socket
import subprocess
import threading
import time

import numpy as np
import pytest

from robustcap_tpu.sensors import xdc_codec as JX
from robustcap_tpu.streaming import native as jnative
from robustcap_tpu_torch.sensors import xdc_codec as X
from robustcap_tpu_torch.sensors.xsens import (XsensDotSet,
                                               encode_complete_quaternion,
                                               parse_complete_quaternion)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SIZES = {
    X.PayloadMode.EXTENDED_QUATERNION: 36,
    X.PayloadMode.COMPLETE_QUATERNION: 32,
    X.PayloadMode.ORIENTATION_EULER: 16,
    X.PayloadMode.ORIENTATION_QUATERNION: 20,
    X.PayloadMode.FREE_ACCELERATION: 16,
    X.PayloadMode.EXTENDED_EULER: 32,
    X.PayloadMode.COMPLETE_EULER: 28,
    X.PayloadMode.DELTA_QUANTITIES_WITH_MAG: 38,
    X.PayloadMode.DELTA_QUANTITIES: 32,
    X.PayloadMode.RATE_QUANTITIES_WITH_MAG: 34,
    X.PayloadMode.RATE_QUANTITIES: 28,
    X.PayloadMode.CUSTOM_MODE_1: 40,
    X.PayloadMode.CUSTOM_MODE_2: 34,
    X.PayloadMode.CUSTOM_MODE_3: 32,
}


@pytest.fixture(autouse=True)
def jax_fallback_datapath(monkeypatch):
    monkeypatch.setattr(jnative, "load_native", lambda: None)


def _run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


# ---------------------------------------------------------------------------
# the codecs, byte for byte
# ---------------------------------------------------------------------------


def test_tables_equal_jax():
    def public(cls):
        return {k: v for k, v in vars(cls).items() if not k.startswith("_")}
    assert public(X.UUIDS) == public(JX.UUIDS)
    assert public(X.PayloadMode) == public(JX.PayloadMode)
    assert X.PAYLOAD_FORMATS == JX.PAYLOAD_FORMATS
    for mode, size in SIZES.items():
        assert X.payload_size(mode) == JX.payload_size(mode) == size
        assert X.payload_characteristic(mode) == \
            JX.payload_characteristic(mode)


@pytest.mark.parametrize("mode", sorted(SIZES))
def test_payload_roundtrip_and_bytes(mode):
    rng = np.random.RandomState(mode)
    fields = {
        "timestamp": 12.345678,
        "quaternion": rng.randn(4).astype(np.float32),
        "euler": rng.randn(3).astype(np.float32),
        "free_acceleration": rng.randn(3).astype(np.float32),
        "dq": rng.randn(4).astype(np.float32),
        "dv": rng.randn(3).astype(np.float32),
        "acceleration": rng.randn(3).astype(np.float32),
        "angular_velocity": rng.randn(3).astype(np.float32),
        "magnetic_field": rng.randint(-2000, 2000, 3),
        "status": 7, "clip_count_acc": 1, "clip_count_gyr": 2,
    }
    data = X.encode_payload(mode, **fields)
    assert data == JX.encode_payload(mode, **fields)
    assert len(data) == SIZES[mode]
    out, jout = X.parse_payload(mode, data), JX.parse_payload(mode, data)
    assert out.keys() == jout.keys() == set(X.PAYLOAD_FORMATS[mode])
    for name, v in out.items():
        np.testing.assert_array_equal(v, jout[name])
        if name == "timestamp":
            np.testing.assert_allclose(v, 12.345678, atol=1e-6)
        elif isinstance(v, (int, np.integer)):
            assert v == fields[name]
        else:
            np.testing.assert_allclose(v, fields[name], atol=1e-6)


def test_complete_quaternion_codec_and_errors():
    quat = np.asarray([0.5, 0.5, -0.5, 0.5], np.float32)
    acc = np.asarray([0.1, -0.2, 9.8], np.float32)
    data = encode_complete_quaternion(1.5, quat, acc)
    assert data == X.encode_payload(X.PayloadMode.COMPLETE_QUATERNION,
                                    timestamp=1.5, quaternion=quat,
                                    free_acceleration=acc)
    from robustcap_tpu.sensors.xsens import parse_complete_quaternion as jp
    p, q = parse_complete_quaternion(data), jp(data)
    assert p.timestamp == q.timestamp
    np.testing.assert_array_equal(p.quat_wxyz, quat)
    np.testing.assert_array_equal(p.free_acc, q.free_acc)
    with pytest.raises(ValueError, match="short payload"):
        parse_complete_quaternion(b"\0" * 10)
    with pytest.raises(ValueError, match="unsupported payload mode"):
        X.parse_payload(99, b"\0" * 64)
    with pytest.raises(ValueError, match="short payload"):
        X.parse_payload(X.PayloadMode.COMPLETE_QUATERNION, b"\0" * 10)


def test_characteristic_codecs_equal_jax():
    info = dict(address=b"\xaa\xbb\xcc\xdd\xee\xff", version_major=2,
                version_minor=1, build_year=2022, serial_number=987654321,
                short_product_code=b"XS-T01")
    dc = dict(output_rate=120, filter_profile_index=1,
              device_tag=b"my tag".ljust(16, b"\0"))
    cases = [("device_info", "DeviceInfo", info),
             ("device_control", "DeviceControl", dc),
             ("measurement_control", "MeasurementControl",
              dict(Type=1, action=1, payload_mode=19)),
             ("battery", "Battery", dict(battery_level=42,
                                         charging_status=1))]
    for name, cls, kw in cases:
        data = getattr(X, f"encode_{name}")(getattr(X, cls)(**kw))
        assert data == getattr(JX, f"encode_{name}")(getattr(JX, cls)(**kw))
        assert getattr(X, f"parse_{name}")(data) == getattr(X, cls)(**kw)
    for kw in (dict(typeid=1), dict(typeid=4),
               dict(typeid=5, length=4, timestamp=123456),
               dict(typeid=5, length=8, timestamp=2 ** 40)):
        data = X.encode_device_report(X.DeviceReport(**kw))
        assert data == JX.encode_device_report(JX.DeviceReport(**kw))
        rep = X.parse_device_report(data)
        assert rep.typeid == kw["typeid"]
        assert rep.timestamp == kw.get("timestamp")
    assert X.parse_orientation_reset_control(
        X.encode_orientation_reset_control(X.HEADING_RESET)) == 1
    assert X.encode_orientation_reset_status(1) == \
        JX.encode_orientation_reset_status(1)


# ---------------------------------------------------------------------------
# DotClient and XsensDotSet over the fake radio
# ---------------------------------------------------------------------------


def test_dot_client_protocol():
    tr = X.FakeDotTransport()
    dot = X.DotClient(tr)

    async def go():
        await dot.set_output_rate(120)
        assert (await dot.device_control()).output_rate == 120
        with pytest.raises(ValueError, match="invalid output rate"):
            await dot.set_output_rate(55)
        with pytest.raises(RuntimeError, match="requires streaming"):
            await dot.reset_heading()
        assert not await dot.is_streaming()
        await dot.start_streaming(X.PayloadMode.DELTA_QUANTITIES)
        assert await dot.is_streaming()
        assert tr.payload_mode == X.PayloadMode.DELTA_QUANTITIES
        await dot.start_streaming()
        assert await dot.reset_heading()
        assert await dot.is_heading_reset()
        await dot.revert_heading_to_default()
        assert not await dot.is_heading_reset()
        await dot.stop_streaming()
        assert not await dot.is_streaming()

    _run(go())


def test_fake_routes_short_modes_by_characteristic():
    tr = X.FakeDotTransport()
    dot = X.DotClient(tr)
    got, medium = [], []

    async def go():
        await tr.start_notify(X.UUIDS.medium_payload,
                              lambda _, d: medium.append(d))
        await dot.start_streaming(X.PayloadMode.ORIENTATION_QUATERNION)

    _run(go())
    assert tr.pump(3) == 0 and medium == []
    _run(dot.start_payload_notify(lambda _, d: got.append(bytes(d))))
    assert tr.pump(3) == 3
    assert "quaternion" in X.parse_payload(
        X.PayloadMode.ORIENTATION_QUATERNION, got[0])


def _dot_set(n=2):
    transports = {}

    def factory(addr):
        transports[addr] = X.FakeDotTransport(address=addr)
        return transports[addr]

    addrs = [f"FA:KE:00:00:00:0{i}" for i in range(n)]
    return XsensDotSet(addrs, transport_factory=factory), transports, addrs


def test_dot_set_connect_stream_heading_and_errors():
    ds, transports, addrs = _dot_set()
    assert all(b._lib is not None for b in ds._buffers)   # native rings
    ds.connect(timeout=10)
    try:
        assert ds.is_connected() and ds.battery_levels == [88, 88]
        for tr in transports.values():
            writes = [u for u, _ in tr.write_log]
            assert X.UUIDS.device_control in writes
            assert X.UUIDS.measurement_control in writes
        with pytest.raises(RuntimeError, match="requires streaming"):
            ds.reset_heading()           # the loop survives the error
        ds.start_streaming()
        assert ds.is_started()
        for tr in transports.values():
            assert tr.streaming and tr.pump(5) == 5
        t0, quat, acc = ds.get(0, timeout=2.0)
        assert quat.shape == (4,) and acc.shape == (3,)
        np.testing.assert_allclose(np.linalg.norm(quat), 1.0, atol=1e-5)
        assert ds.get(0, timeout=2.0)[0] > t0
        ds.reset_heading()
        tr = transports[addrs[0]]
        assert X.parse_orientation_reset_status(
            tr._state[X.UUIDS.orientation_reset_status]) == 1
        ds.revert_heading_to_default()
        assert X.parse_orientation_reset_control(
            tr._state[X.UUIDS.orientation_reset_control]) == 0
        tr.emit_report(X.DeviceReport(typeid=5, length=4, timestamp=999))
        deadline = time.time() + 5
        while not ds.reports and time.time() < deadline:
            time.sleep(0.01)
        assert ds.reports[0][0] == 0
        assert ds.reports[0][1].timestamp == 999
        ds.stop_streaming()
        assert not ds.is_started()
        assert all(tr.pump(3) == 0 for tr in transports.values())
    finally:
        ds.shutdown()
    assert not ds.is_connected()


def test_dot_set_ring_and_modes():
    ds, _, _ = _dot_set(n=1)
    for k in range(200):    # over the capacity of 180
        ds.feed(0, X.encode_payload(
            X.PayloadMode.COMPLETE_QUATERNION, timestamp=float(k),
            quaternion=[1, 0, 0, 0], free_acceleration=[0, 0, 0]))
    assert ds._buffers[0].dropped == 20
    assert ds.get(0, timeout=0.5)[0] == pytest.approx(20.0)
    ds.clear(0)
    assert not ds.is_available(0)
    ds.feed(0, X.encode_payload(
        X.PayloadMode.CUSTOM_MODE_3, timestamp=1.0, quaternion=[0, 1, 0, 0],
        angular_velocity=[1, 2, 3]), mode=X.PayloadMode.CUSTOM_MODE_3)
    t, quat, acc = ds.get(0, timeout=0.5)
    np.testing.assert_array_equal(quat, [0, 1, 0, 0])
    np.testing.assert_array_equal(acc, 0.0)
    with pytest.raises(ValueError, match="no quaternion"):
        ds.feed(0, X.encode_payload(X.PayloadMode.FREE_ACCELERATION,
                                    timestamp=0.0),
                mode=X.PayloadMode.FREE_ACCELERATION)
    with pytest.raises(TimeoutError, match="no data"):
        ds.get(0, timeout=0.05)


def test_bridge_hardware_path_over_fake_radio():
    r"""``run_imu_bridge`` with no source: connect, start streaming, pop
    each sensor's samples and send them as UDP packets, then shut the set
    down; the packets carry the fakes' signal."""
    from robustcap_tpu_torch.config import LiveConfig
    from robustcap_tpu_torch.sensors import run_imu_bridge
    from robustcap_tpu_torch.streaming.native import parse_imu_packet
    transports = []

    def factory(addr):
        transports.append(X.FakeDotTransport(address=addr))
        return transports[-1]

    stop = threading.Event()

    def pump():
        while not stop.is_set():
            for tr in list(transports):
                tr.pump(1)
            stop.wait(0.002)

    pumper = threading.Thread(target=pump, daemon=True)
    pumper.start()
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as rx:
        rx.bind(("127.0.0.1", 0))
        rx.settimeout(5.0)
        try:
            n = run_imu_bridge(
                addresses=[f"D0:7A:00:00:00:0{i}" for i in range(6)],
                live=LiveConfig(fps=200), dest=rx.getsockname(),
                max_packets=5, transport_factory=factory)
            pkts = [rx.recv(4096) for _ in range(5)]
        finally:
            stop.set()
            pumper.join(timeout=5)
    assert n == 5 and not pumper.is_alive()
    t, quats, accs = parse_imu_packet(pkts[0])
    want_q, want_a = X.FakeDotTransport._default_signal(0)
    np.testing.assert_allclose(quats, np.tile(want_q, (6, 1)), atol=1e-6)
    np.testing.assert_allclose(accs, np.tile(want_a, (6, 1)), atol=1e-6)
    assert parse_imu_packet(pkts[-1])[0] > t


# ---------------------------------------------------------------------------
# MVNX, the DOT exporter's CSVs, camera calibration
# ---------------------------------------------------------------------------


def _fmt(a):
    return " ".join("%.8f" % v for v in np.asarray(a).reshape(-1))


MINIMAL_MVNX = """<?xml version="1.0"?>
<mvnx xmlns="http://www.xsens.com/mvn/mvnx">
  <subject frameRate="60">
    <segments>
      <segment id="1" label="Pelvis"/><segment id="2" label="Head"/>
    </segments>
    <sensors><sensor label="imu1"/></sensors>
    <frames>
      <frame time="0" type="normal">
        <orientation>1 0 0 0 1 0 0 0</orientation>
        <position>0 0 1 0 0 2</position>
      </frame>
      <frame time="16" type="normal">
        <orientation>1 0 0 0 1 0 0 0</orientation>
        <position>0 0 1.1 0 0 2.1</position>
      </frame>
    </frames>
  </subject>
</mvnx>"""


def _full_mvnx(T=24):
    rng = np.random.RandomState(0)
    segs, sens, cons = ["Pelvis", "Head", "LeftForeArm"], ["Pelvis", "Head"], \
        ["LeftFoot_Heel"]

    def quat(n):
        q = rng.normal(size=(n, 4))
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    frames = [f'<frame index="" type="{k}"><orientation>{_fmt(quat(3))}'
              f'</orientation><position>{_fmt(rng.normal(size=(3, 3)))}'
              f'</position></frame>' for k in ("identity", "tpose")]
    for t in range(T):
        body = "".join(
            f"<{tag}>{_fmt(v)}</{tag}>" for tag, v in (
                ("orientation", quat(3)), ("position", rng.normal(size=9)),
                ("velocity", rng.normal(size=9)),
                ("acceleration", rng.normal(size=9)),
                ("angularVelocity", rng.normal(size=9)),
                ("angularAcceleration", rng.normal(size=9)),
                ("footContacts", rng.randint(0, 2, 1)),
                ("sensorFreeAcceleration", rng.normal(size=6)),
                ("sensorMagneticField", rng.normal(size=6)),
                ("sensorOrientation", quat(2)),
                ("centerOfMass", rng.normal(size=3))))
        frames.append(f'<frame time="{t * 16}" index="{t}" type="normal">'
                      f"{body}</frame>")
    return ('<?xml version="1.0"?><mvnx version="4">'
            '<subject frameRate="60" label="s1"><segments>'
            + "".join(f'<segment id="{i + 1}" label="{s}"/>'
                      for i, s in enumerate(segs))
            + "</segments><sensors>"
            + "".join(f'<sensor label="{s}"/>' for s in sens)
            + "</sensors><footContactDefinition>"
            + "".join(f'<contactDefinition index="{i}" label="{c}"/>'
                      for i, c in enumerate(cons))
            + f"</footContactDefinition><frames>{''.join(frames)}</frames>"
            "</subject></mvnx>")


def _same(a, b, path="out"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("doc", ["minimal", "full"])
def test_read_mvnx_matches_jax(doc, tmp_path):
    from robustcap_tpu.sensors import read_mvnx as jread
    from robustcap_tpu_torch.sensors import read_mvnx
    p = tmp_path / "a.mvnx"
    p.write_text(MINIMAL_MVNX if doc == "minimal" else _full_mvnx())
    out = read_mvnx(str(p))
    _same(out, jread(str(p)))
    if doc == "minimal":
        assert out["segment_names"] == ["Pelvis", "Head"]
        assert out["orientation"].shape == (2, 2, 4)
    else:
        assert out["imu"]["calibrated orientation"].shape == (24, 2, 4)
        assert set(out["tpose"]) == {"identity", "tpose"}


def test_dot_export_csvs_match_jax(tmp_path):
    from robustcap_tpu.sensors import read_dot_export_csvs as jread
    from robustcap_tpu_torch.sensors import read_dot_export_csvs
    for sid in ("AAA111", "BBB222"):
        lines = ["sep=,", "PacketCounter,Quat_W,Quat_X,Quat_Y,Quat_Z,"
                 "Acc_X,Acc_Y,Acc_Z"]
        lines += [f"{t},1,0,0,0,{0.1 * t:.2f},0,9.8" for t in range(5)]
        (tmp_path / f"20230124_{sid}_v1.csv").write_text(
            "\n".join(lines) + "\n")
    data = read_dot_export_csvs(str(tmp_path))
    _same(data, jread(str(tmp_path)))
    assert set(data) == {"AAA111", "BBB222"}
    np.testing.assert_allclose(data["BBB222"]["a"][3, 0], 0.3, atol=1e-6)


def test_zhang_intrinsics_match_jax():
    from robustcap_tpu.sensors import calibrate_intrinsics_zhang as jzhang
    from robustcap_tpu_torch.sensors import calibrate_intrinsics_zhang
    K = np.array([[620.0, 0, 320], [0, 615.0, 240], [0, 0, 1]])
    rng = np.random.RandomState(3)
    board = np.mgrid[0:6, 0:5].T.reshape(-1, 2).astype(np.float64) * 25.0
    obj, img = [], []
    for _ in range(4):
        from scipy.spatial.transform import Rotation
        R = Rotation.from_rotvec(rng.uniform(-0.4, 0.4, 3)).as_matrix()
        t = np.array([-60.0, -50.0, 600.0]) + rng.uniform(-20, 20, 3)
        X3 = np.concatenate([board, np.zeros((len(board), 1))], 1)
        uvw = (X3 @ R.T + t) @ K.T
        obj.append(board)
        img.append(uvw[:, :2] / uvw[:, 2:])
    got = calibrate_intrinsics_zhang(obj, img)
    np.testing.assert_array_equal(got, jzhang(obj, img))
    np.testing.assert_allclose(got, K, rtol=1e-3, atol=0.5)


# ---------------------------------------------------------------------------
# Noitom MocapApi on the mock vendor library
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mock_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the mock vendor library")
    out = str(tmp_path_factory.mktemp("noitom") / "libMocapApi.so")
    subprocess.run(["g++", "-O1", "-shared", "-fPIC", "-o", out,
                    os.path.join(ROOT, "native", "mock_mocap_api.cpp")],
                   check=True)
    return out


def test_noitom_lifecycle_and_errors(mock_lib):
    from robustcap_tpu_torch.sensors import noitom as N
    with pytest.raises(FileNotFoundError, match="vendor library"):
        N.MocapLib("/nonexistent/libMocapApi.so")
    lib = N.MocapLib(mock_lib)

    class Bogus(N._ApplicationTable):
        VERSION = b"PROC_TABLE:IMCPBogus_001"

    with pytest.raises(N.MocapApiError, match="NotSupported"):
        lib.table(Bogus)
    app = N.MCPApplication(lib)
    with pytest.raises(N.MocapApiError, match="ServerNotReady"):
        app.open()
    settings = N.MCPSettings(lib)
    settings.set_udp(7777)
    settings.set_calc_data()
    settings.set_bvh_rotation(N.MCPBvhRotation.YXZ)
    app.set_settings(settings)
    app.open()
    try:
        assert app.is_opened()
        sensors = app.get_sensor_modules()
        assert [s.get_id() for s in sensors] == [1, 2, 3, 4, 5, 6]
        assert sensors[0].get_temperature() == pytest.approx(36.5)
        assert sensors[0].get_compass_value() == (1.0, 0.0, 0.0)
        av = app.get_avatars()[0]
        assert av.get_name() == "MockAvatar"
        root = av.get_root_joint()
        assert root.get_tag() == N.MCPJointTag.Hips
        assert sorted(j.get_name() for j in root.get_children()) == \
            ["RightUpLeg", "Spine"]
        assert 1 <= root.get_sensor_module().get_id() <= 6
    finally:
        app.close()
        app.destroy()
    from robustcap_tpu.sensors import noitom as JN
    for enum in ("MCPError", "MCPJointTag", "MCPEventType", "MCPBvhRotation"):
        assert [(m.name, int(m)) for m in getattr(N, enum)] == \
            [(m.name, int(m)) for m in getattr(JN, enum)]


def test_noitom_sensor_set_matches_jax(mock_lib, tmp_path):
    r"""The 6-IMU polling loop on the mock: discovery, then frames that
    advance; the same polls through the JAX package's set (a second copy
    of the library, so that the two do not share the mock's state) give the
    same frames."""
    from robustcap_tpu.sensors import noitom as JN
    from robustcap_tpu_torch.sensors import noitom as N
    second = str(tmp_path / "libMocapApi2.so")
    shutil.copy(mock_lib, second)
    frames = []
    for mod, path in ((N, mock_lib), (JN, second)):
        s = mod.NoitomSensorSet(path, udp_port=7777).connect()
        try:
            frames.append([s.poll() for _ in range(3)])
        finally:
            s.close()
    ours, theirs = frames
    for f, g in zip(ours, theirs):
        assert f.timestamp == g.timestamp
        np.testing.assert_array_equal(f.quat_wxyz, g.quat_wxyz)
        np.testing.assert_array_equal(f.acc, g.acc)
    np.testing.assert_allclose(np.linalg.norm(ours[1].quat_wxyz, axis=1), 1.0,
                               atol=1e-5)
    assert not np.allclose(ours[0].quat_wxyz, ours[1].quat_wxyz)
    assert ours[1].timestamp > ours[0].timestamp
    np.testing.assert_allclose(ours[1].acc[:, 2], 9.8, atol=1e-5)
    api = N.MocapApi(mock_lib).connect(port=7777)
    try:
        assert api.poll().quat_wxyz.shape == (6, 4)
    finally:
        api.close()
    with pytest.raises(RuntimeError, match="not connected"):
        N.MocapApi(mock_lib).poll()

r"""The port's corpus preprocessing against the JAX package's: the numpy
modules (bbox smoothing, occlusion, detector crops, repairs, parsers), the
per-sequence conversions, the corpus drivers run by both packages on one
raw tree written by the JAX fixtures, the port's own raw trees, each
package reading the other's work dicts, the AMASS driver and the
``preprocess`` command.

Bounds: what numpy computes is equal; rotations, positions and keypoints
from the two packages' float32 body math within 1e-5. Accelerations are
second differences of IMU-vertex positions times fps^2 (3600 on frames 1
and T-2, 3600/4 inside), so a position gap delta between the packages'
FKs gives at most 3600 * 4 * delta, and each package's float32 sum
v[t-1] + v[t+1] rounds by at most eps32 * max|v| more: the bound is
3600 * (4 delta + 2 eps32 max|v|), with delta and max|v| measured on the
same motions.
"""

import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robustcap_tpu.math as JM
from robustcap_tpu.eval import datasets as jds
from robustcap_tpu.preprocess import aist as jaist
from robustcap_tpu.preprocess import corpus as jcorpus
from robustcap_tpu.preprocess import datasets as jdatasets
from robustcap_tpu.preprocess import detectors as jdet
from robustcap_tpu.preprocess import fixtures_raw as jfr
from robustcap_tpu.preprocess import occlusion as jocc
from robustcap_tpu.preprocess import smooth_bbox as jbox
from robustcap_tpu_torch.config import AmassSplits
from robustcap_tpu_torch.eval import datasets as tds
from robustcap_tpu_torch.math.angular import axis_angle_to_rotation_matrix
from robustcap_tpu_torch.preprocess import aist as taist
from robustcap_tpu_torch.preprocess import corpus as tcorpus
from robustcap_tpu_torch.preprocess import datasets as tdatasets
from robustcap_tpu_torch.preprocess import detectors as tdet
from robustcap_tpu_torch.preprocess import fixtures_raw as tfr
from robustcap_tpu_torch.preprocess import occlusion as tocc
from robustcap_tpu_torch.preprocess import smooth_bbox as tbox
from robustcap_tpu_torch.preprocess import synthesis as tsyn
from robustcap_tpu_torch.preprocess.fixtures import smooth_random_motion
from robustcap_tpu_torch.smpl import ParametricModel
from test_torch_tail import make_models

ATOL = 1e-5
EPS32 = float(np.finfo(np.float32).eps)
ACC_KEYS = ("imu_acc", "imu_accc")


@pytest.fixture(scope="module")
def models():
    return make_models(num_verts=400)


# ---------------------------------------------------------------------------
# The acceleration bound
# ---------------------------------------------------------------------------


def _imu_vertices(model, R, tran, shape=None):
    r"""The IMU vertices ``[T, 6, 3]`` of a posed motion, skinned as the
    drivers skin them (the vertex union, then the IMU rows), by either
    package's model."""
    need, vi = tdatasets.NEED_VERTS, tdatasets._VI
    if isinstance(model, ParametricModel):
        _, _, v = model.forward_kinematics(
            torch.as_tensor(R), tran=torch.as_tensor(tran),
            shape=None if shape is None else torch.as_tensor(shape),
            calc_mesh=True, vertex_ids=need)
        return v[:, list(vi)].numpy()
    _, _, v = model.forward_kinematics(
        jnp.asarray(R), tran=jnp.asarray(tran),
        shape=None if shape is None else jnp.asarray(shape),
        calc_mesh=True, vertex_ids=need)
    return np.asarray(v)[:, vi]


def _rot_jax(aa):
    return np.array(JM.axis_angle_to_rotation_matrix(
        jnp.asarray(np.asarray(aa, np.float32).reshape(-1, 3)))
    ).reshape(-1, 24, 3, 3)


def _rot_port(aa):
    return axis_angle_to_rotation_matrix(torch.from_numpy(
        np.asarray(aa, np.float32).reshape(-1, 3))).numpy().reshape(
        -1, 24, 3, 3)


def acc_bound(models, motions):
    r"""``3600 (4 delta + 2 eps32 max|v|)`` over ``motions``, each ``(R_jax,
    R_port, tran, shape)``: delta the largest gap of the two packages' IMU
    vertices, max|v| their largest coordinate. Returns (bound, delta)."""
    jm, tm = models
    delta = vmax = 0.0
    for R_j, R_t, tran, shape in motions:
        vj = _imu_vertices(jm, R_j, tran, shape)
        vt = _imu_vertices(tm, R_t, tran, shape)
        delta = max(delta, float(np.abs(vj - vt).max()))
        vmax = max(vmax, float(np.abs(vj).max()))
    return 3600.0 * (4 * delta + 2 * EPS32 * vmax), delta


def _walk(a, b, path, gaps):
    r"""Same structure, shapes and dtypes; the largest gap per key."""
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for x, y in zip(a, b):
            _walk(x, y, path, gaps)
    elif a is None:
        assert b is None, path
    elif isinstance(a, str):
        assert a == b, path
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape and x.dtype == y.dtype, \
            (path, x.shape, y.shape, x.dtype, y.dtype)
        gap = float(np.abs(x.astype(np.float64) - y).max()) if x.size else 0.
        gaps[path] = max(gaps.get(path, 0.0), gap)


def compare_work(want, got, bound):
    r"""Key by key: equal keys, shapes and dtypes; accelerations within
    ``bound``, everything else within ``ATOL``."""
    assert set(want) == set(got)
    gaps = {}
    for k in want:
        _walk(want[k], got[k], k, gaps)
    for k, gap in gaps.items():
        assert gap <= (bound if k in ACC_KEYS else ATOL), (k, gap, bound)
    return gaps


# ---------------------------------------------------------------------------
# The numpy modules, the parsers and the per-sequence conversions
# ---------------------------------------------------------------------------


def _kps(T=40, J=18, seed=0):
    rng = np.random.RandomState(seed)
    kp = np.zeros((T, J, 3), np.float32)
    kp[..., 0] = 960 + rng.randn(T, J) * 80
    kp[..., 1] = 540 + rng.randn(T, J) * 150
    kp[..., 2] = rng.uniform(0.2, 1.0, (T, J))
    kp[10:13, :, 2] = 0.0
    kp[:2, :, 2] = 0.0
    return kp


def _case_bbox(mod):
    kp = _kps()
    out = [mod.kp_to_bbox_param(kp[t], 0.3) for t in range(len(kp))]
    track, start, end = mod.get_smooth_bbox_params(kp, vis_thresh=0.3,
                                                   sigma=8)
    return out, (track, start, end), mod.get_all_bbox_params(kp, 0.3), \
        mod.pw3d_crop_windows(track, 1080, 1920), \
        mod.pw3d_crop_windows(track, 1920, 1080, num_people=2), \
        mod.get_bbox(kp[5, :, :2], 1080, 1920)


def _case_occlusion(mod):
    occs = mod.random_occluders(np.random.RandomState(0), n=3)
    im = np.random.RandomState(1).randint(0, 255, (64, 80, 3)).astype(
        np.uint8)
    return occs, mod.resize_by_factor(occs[0], 0.7), \
        mod.paste_over(occs[1], im, (10, 70)), \
        mod.occlude_with_objects(im, occs, np.random.RandomState(5)), \
        mod.occlude_with_objects(im, occs, np.random.RandomState(5),
                                 centers=[(32, 32), (0, 0)])


def _stub_detector(frame):
    r"""A detector stand-in: landmarks from the frame's mean colour, None
    on a dark frame."""
    m = float(np.asarray(frame, np.float32).mean())
    if m < 20:
        return None
    return np.full((33, 3), m / 255.0, np.float32)


def _case_detectors(mod):
    rng = np.random.RandomState(2)
    frames = [rng.randint(0, 255, (90, 120, 3)).astype(np.uint8)
              for _ in range(6)]
    frames[2] = np.zeros_like(frames[2])
    gt = _kps(T=6, J=33, seed=3)
    gt[..., 0] = gt[..., 0] / 16
    gt[..., 1] = gt[..., 1] / 12
    occs = jocc.random_occluders(np.random.RandomState(4), n=2,
                                 size_range=(10, 30))
    return mod.detect_sequence(frames, _stub_detector), \
        mod.detect_sequence_cropped(frames, gt, _stub_detector), \
        mod.detect_sequence_occluded(frames, occs, _stub_detector, seed=3,
                                     frame_size=(120, 90))


def _case_repairs(mod):
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    frames = [np.ones((33, 4), np.float32), None, np.zeros((0,)),
              torch.ones(33, 4)]
    return [mod.splice_repair(x[:n], 20) for n in (20, 19, 18, 17, 16, 25)], \
        mod.fill_missing_frames(frames, rng=np.random.RandomState(3)), \
        mod.fill_missing_frames([]), mod.splice_repair(None, 3)


def _case_resampling(mod):
    rng = np.random.RandomState(4)
    x = rng.randn(37, 5).astype(np.float32)
    ori = rng.randn(5, 6, 3, 3).astype(np.float32)
    acc = rng.randn(5, 6, 3).astype(np.float32)
    return [mod.resample_sequence(x, f, g) for f, g in
            ((60, 60), (120, 60), (30, 60), (100, 60))], \
        mod.interpolate_keypoints(x.reshape(37, 5, 1), 2), \
        mod.interpolate_keypoints(x[:9].reshape(9, 1, 5), 3), \
        mod.totalcapture_align_imus(ori, acc)


def _case_aist_helpers(mod):
    rng = np.random.RandomState(5)
    kp = rng.rand(10, 33, 3).astype(np.float32)
    cams = [{"matrix": np.diag([1200.0, 1100.0, 1.0]).tolist(),
             "rotation": (rng.randn(3) * 0.5).tolist(),
             "translation": (rng.randn(3) * 300).tolist()} for _ in range(3)]
    return [mod.repair_frame_count(kp, n) for n in (10, 12, 8, 20)], \
        mod.repair_frame_count(None, 3), mod.aist_camera_params(cams)


NUMPY_CASES = {
    "smooth_bbox": (_case_bbox, jbox, tbox),
    "occlusion": (_case_occlusion, jocc, tocc),
    "detectors": (_case_detectors, jdet, tdet),
    "repairs": (_case_repairs, jcorpus, tcorpus),
    "resampling": (_case_resampling, jdatasets, tdatasets),
    "aist_helpers": (_case_aist_helpers, jaist, taist),
}


def _assert_same(a, b, atol=0.0):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y, atol)
    elif a is None or isinstance(a, (int, str)):
        assert a == b
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape and x.dtype == y.dtype
        if atol:
            np.testing.assert_allclose(y, x, atol=atol)
        else:
            np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("case", sorted(NUMPY_CASES))
def test_numpy_functions_match_jax(case):
    r"""The same inputs give the same outputs, equal to the bit (the camera
    rotations of ``aist_camera_params`` come from either package's
    Rodrigues formula: within 1e-6)."""
    fn, jmod, tmod = NUMPY_CASES[case]
    _assert_same(fn(jmod), fn(tmod), 1e-6 if case == "aist_helpers" else 0)


def test_mediapipe_detector_without_mediapipe():
    try:
        import mediapipe  # noqa: F401
        pytest.skip("mediapipe is installed")
    except ImportError:
        pass
    for mod in (jdet, tdet):
        with pytest.raises(ImportError, match="MediaPipe is an external"):
            mod.MediaPipeDetector()


def test_parsers_match_jax(models, tmp_path):
    r"""``calibration.cal`` and the Vicon text file as both packages read
    them, on the files the TotalCapture fixture writes."""
    jm, _ = models
    jfr.build_raw_totalcapture(str(tmp_path), jm, n_seq=1, T=12)
    cal = str(tmp_path / "calibration.cal")
    _assert_same(jcorpus.parse_calibration(cal),
                 tcorpus.parse_calibration(cal))
    vicon = str(tmp_path / "Vicon_GroundTruth" / "S1" / "acting1" /
                "gt_skel_gbl_pos.txt")
    _assert_same(jcorpus.parse_vicon_positions(vicon),
                 tcorpus.parse_vicon_positions(vicon))


def test_sequence_conversions_match_jax(models):
    r"""``amass_sequence_to_work`` (at 120 fps, resampled, and with the
    length aligned), ``check_real_vs_synthetic_imu``,
    ``preprocess_3dpw_sequence`` and ``aist_sequence_to_work``."""
    jm, tm = models
    rng = np.random.RandomState(6)
    aa, tran = smooth_random_motion(rng, 50)
    aa = aa.reshape(50, 72)
    for fps, align in ((120.0, None), (60.0, 16)):
        want = jdatasets.amass_sequence_to_work(jm, aa, tran, fps, align)
        got = tdatasets.amass_sequence_to_work(tm, aa, tran, fps, align,
                                               device="cpu")
        pose = want["pose"]
        bound, _ = acc_bound(models, [(_rot_jax(pose), _rot_port(pose),
                                       want["tran"], None)])
        compare_work(want, got, bound)
    with pytest.raises(ValueError, match="too short"):
        tdatasets.amass_sequence_to_work(tm, aa[:9], tran[:9], device="cpu")

    real = jdatasets.amass_sequence_to_work(jm, aa, tran)
    res = tdatasets.check_real_vs_synthetic_imu(tm, aa, tran, real["imu_ori"],
                                                real["imu_acc"], device="cpu")
    assert res["ok"] and res["mean_angle_deg"] < 0.05

    K = np.array([[1200.0, 0, 960], [0, 1200.0, 540], [0, 0, 1]], np.float32)
    cam_T = np.tile(np.eye(4, dtype=np.float32), (25, 1, 1))
    kp = rng.rand(25, 33, 3).astype(np.float32)
    want = jdatasets.preprocess_3dpw_sequence(jm, aa[:25], tran[:25], kp, K,
                                              cam_T)
    got = tdatasets.preprocess_3dpw_sequence(tm, aa[:25], tran[:25], kp, K,
                                             cam_T, device="cpu")
    pose60 = tdatasets.resample_sequence(aa[:25], 30.0)[:len(want["posec"])]
    bound, _ = acc_bound(models, [(_rot_jax(pose60), _rot_port(pose60),
                                   want["tranc"], None)])
    compare_work({k.replace("imu_accc", "imu_acc"): v
                  for k, v in want.items()},
                 {k.replace("imu_accc", "imu_acc"): v
                  for k, v in got.items()}, bound)

    motion = {"smpl_poses": aa[:24], "smpl_trans": tran[:24] * 100.0,
              "smpl_scaling": np.asarray([100.0])}
    cams = [{"matrix": np.diag([1200.0, 1200.0, 1.0]).tolist(),
             "rotation": [0.1, 0.2, 0.0], "translation": [0.0, 0.0, 400.0]}]
    kps = [kp[:22]]
    want = jaist.aist_sequence_to_work(jm, motion, cams, kps, name="s_cAll")
    got = taist.aist_sequence_to_work(tm, motion, cams, kps, name="s_cAll",
                                      device="cpu")
    bound, _ = acc_bound(models, [(_rot_jax(aa[:24]), _rot_port(aa[:24]),
                                   want["tran"], None)])
    compare_work(want, got, bound)
    assert jaist.compute_not_aligned(want) == taist.compute_not_aligned(got)


def test_random_camera_and_confidence():
    r"""JAX's keyed draws cannot be matched: the draws are held by law
    (rotations within the angle ranges, the pool's confidences, jitter
    that shrinks with them) and by determinism under a seed."""
    g = torch.Generator().manual_seed(3)
    Rs = torch.stack([tsyn.random_camera(g, yaw=(-90.0, 90.0))
                      for _ in range(200)])
    eye = torch.eye(3).expand(200, 3, 3)
    assert torch.allclose(Rs @ Rs.transpose(1, 2), eye, atol=1e-5)
    assert torch.allclose(torch.linalg.det(Rs), torch.ones(200), atol=1e-5)
    # Rcw = (diag(-1, -1, 1) Rc0c)^T: Rc0c = Ry(yaw) Rx(pitch) Rz(roll), so
    # its third column is the camera's optical axis, yaw and pitch of it
    Rc0c = torch.diag(torch.tensor([-1.0, -1.0, 1.0])) @ Rs.transpose(1, 2)
    z = Rc0c[:, :, 2]
    pitch = torch.rad2deg(torch.asin(-z[:, 1]))
    yaw = torch.rad2deg(torch.atan2(z[:, 0], z[:, 2]))
    assert pitch.abs().max() <= 30.0 + 1e-3 and yaw.abs().max() <= 90 + 1e-3
    assert yaw.min() < -60 and yaw.max() > 60      # the range is covered
    again = tsyn.random_camera(torch.Generator().manual_seed(3),
                               yaw=(-90.0, 90.0))
    assert torch.equal(again, Rs[0])

    pool = torch.linspace(0.1, 1.0, 50)
    j2dc = torch.rand(20, 33, 3, generator=torch.Generator().manual_seed(1))
    out = tsyn.synthesize_confidence(torch.Generator().manual_seed(2), j2dc,
                                     pool)
    assert out.shape == (20, 33, 3)
    p = out[:, 0, 2]
    assert torch.all(out[..., 2] == p[:, None])      # one per frame
    assert len(set(p.tolist())) == 20                # without replacement
    assert all(bool((pool == v).any()) for v in p)
    err = (out[..., :2] - j2dc[..., :2]).abs().amax((1, 2))
    assert torch.all(err <= 6 * 0.003 * (1 - p) + 1e-7)
    assert torch.equal(out, tsyn.synthesize_confidence(
        torch.Generator().manual_seed(2), j2dc, pool))
    few = tsyn.synthesize_confidence(torch.Generator().manual_seed(2), j2dc,
                                     pool[:5].reshape(5, 1))
    assert set(few[:, 0, 2].tolist()) <= set(pool[:5].tolist())


# ---------------------------------------------------------------------------
# The corpus drivers on one raw tree written by the JAX fixtures
# ---------------------------------------------------------------------------


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=False)


@pytest.fixture(scope="module")
def corpora(models, tmp_path_factory):
    r"""Both packages' work dicts from the same JAX-built raw trees (the
    JAX tests' sizes)."""
    jm, tm = models
    root = tmp_path_factory.mktemp("corpora")
    out = {}

    raw = str(root / "aist_raw")
    jfr.build_raw_aist(raw, jm, n_seq=2, T=24, misaligned_cam=3)
    jcorpus.preprocess_aist(raw, str(root / "aist_j"), model=jm)
    tcorpus.preprocess_aist(raw, str(root / "aist_t"), model=tm,
                            device="cpu")
    out["aist"] = (raw, str(root / "aist_j" / "test.pt"),
                   str(root / "aist_t" / "test.pt"))

    raw = str(root / "tc_raw")
    jfr.build_raw_totalcapture(raw, jm, n_seq=2, T=24)
    pre = jcorpus.preprocess_totalcapture_pre(raw, model=jm)
    pre_j = str(root / "tc_pre_j.pt")
    os.replace(pre, pre_j)
    tcorpus.preprocess_totalcapture_pre(raw, model=tm, device="cpu")
    tcorpus.preprocess_totalcapture(raw, str(root / "tc_t"), model=tm,
                                    skip=(), device="cpu")
    os.replace(pre, str(root / "tc_pre_t.pt"))
    os.replace(pre_j, pre)
    jcorpus.preprocess_totalcapture(raw, str(root / "tc_j"), model=jm,
                                    skip=())
    out["tc"] = (raw, str(root / "tc_j" / "test.pt"),
                 str(root / "tc_t" / "test.pt"))
    out["tc_pre"] = (raw, pre, str(root / "tc_pre_t.pt"))

    for occ in (False, True):
        name = "pw3d_occ" if occ else "pw3d"
        raw = str(root / f"{name}_raw")
        jfr.build_raw_pw3d(raw, jm, n_seq=1 if occ else 2, T60=24, occ=occ)
        jcorpus.preprocess_3dpw(raw, str(root / f"{name}_j"), occ=occ,
                                model=jm)
        tcorpus.preprocess_3dpw(raw, str(root / f"{name}_t"), occ=occ,
                                model=tm, device="cpu")
        fname = "test_occ.pt" if occ else "test.pt"
        out[name] = (raw, str(root / f"{name}_j" / fname),
                     str(root / f"{name}_t" / fname))
    return out


def _motions(name, want, got):
    r"""The motions a dict's IMUs were synthesized from, as ``acc_bound``
    takes them (each package's rotations from its own dict)."""
    if name == "aist":
        return [(_rot_jax(p), _rot_port(p), t, None)
                for p, t in zip(want["pose"], want["tran"])]
    return [(np.asarray(pj), np.asarray(pt), t, s) for pj, pt, t, s in
            zip(want["posec"], got["posec"], want["tranc"], want["shape"])]


@pytest.mark.parametrize("name", ["aist", "tc_pre", "tc", "pw3d",
                                  "pw3d_occ"])
def test_driver_matches_jax(models, corpora, name):
    r"""Same keys, shapes and dtypes; positions, rotations and keypoints
    within 1e-5, accelerations within the bound derived from the two FKs'
    measured IMU-vertex gap (TotalCapture's IMUs are the real ones of the
    raw pickles: equal)."""
    _, want_path, got_path = corpora[name]
    want, got = _load(want_path), _load(got_path)
    bound = 0.0
    if name in ("aist", "pw3d", "pw3d_occ"):
        bound, delta = acc_bound(models, _motions(name, want, got))
        assert delta < ATOL
    gaps = compare_work(want, got, bound)
    if name == "tc":
        assert gaps["imu_acc"] == 0.0 and gaps["imu_ori"] == 0.0


def test_not_aligned_matches_jax(models, corpora):
    jm, tm = models
    raw = corpora["aist"][0]
    want = jcorpus.write_not_aligned(raw, out_path=raw + "/na_j.txt",
                                     model=jm)
    got = tcorpus.write_not_aligned(raw, out_path=raw + "/na_t.txt",
                                    model=tm, device="cpu")
    assert got == want and any("c04" in n for n in got)
    with open(raw + "/na_j.txt") as a, open(raw + "/na_t.txt") as b:
        assert a.read() == b.read()


def test_tc_assert_trips_on_corruption(models, corpora, tmp_path):
    r"""Real IMUs turned away from the synthetic ones stop the port's TC
    driver, as the JAX one."""
    _, tm = models
    data = _load(corpora["tc_pre"][2])
    rot = _rot_port(np.array([2.0, 0.5, 0.0] * 24))[0, 0]
    data["ori"] = list(data["ori"])
    data["ori"][0] = np.einsum("ij,tnjk->tnik", rot, data["ori"][0])
    torch.save(data, tmp_path / "total_capture_data.pt")
    with pytest.raises(AssertionError, match="IMU disagreement"):
        tcorpus.preprocess_totalcapture(str(tmp_path), str(tmp_path / "o"),
                                        model=tm, skip=(), device="cpu")
    assert tcorpus.preprocess_totalcapture(str(tmp_path),
                                           str(tmp_path / "o2"), model=tm,
                                           skip=(0,), device="cpu") == 1


# each writer and the bound of its keypoint caches: fractions of the frame,
# or (3DPW) pixels, where a position gap is scaled by the image width
BUILDERS = {
    "aist": (lambda fr, root, m: fr.build_raw_aist(
        root, m, n_seq=2, T=24, misaligned_cam=3), ATOL),
    "tc": (lambda fr, root, m: fr.build_raw_totalcapture(
        root, m, n_seq=2, T=24), ATOL),
    "pw3d": (lambda fr, root, m: fr.build_raw_pw3d(root, m, n_seq=2, T60=24),
             tfr.IMG_W * ATOL),
}


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _file_gap(a, b):
    r"""The largest gap between two raw files' numbers (0 if equal)."""
    if a.endswith(".pt"):
        x, y = _load(a), _load(b)
        pairs = zip(x, y) if isinstance(x, list) else [(x, y)]
        return max(float(np.abs(np.asarray(p, np.float64)
                                - np.asarray(q)).max())
                   for p, q in pairs if p is not None)
    if a.endswith(".pkl"):
        with open(a, "rb") as f, open(b, "rb") as g:
            x, y = pickle.load(f), pickle.load(g)
        return max(float(np.abs(np.asarray(x[k], np.float64)
                                - np.asarray(y[k])).max()) for k in x
                   if not isinstance(x[k], (float, int)))
    if a.endswith(".txt"):     # Vicon positions in inches
        with open(a) as f, open(b) as g:
            x, y = (np.array([list(map(float, row.split())) for row in
                              h.read().replace("\t", " ").splitlines()[1:]])
                    for h in (f, g))
        return float(np.abs(x - y).max()) * 0.0254
    raise AssertionError(f"{a} differs")


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_fixtures_raw_write_the_jax_tree(models, tmp_path, name):
    r"""The port's raw fixtures write the JAX package's tree: the same
    files, those made of numpy draws equal byte for byte, those posed
    through the body model within 1e-5 (Vicon text in metres; pixel
    keypoints the image width times that; accelerations within the derived
    bound)."""
    jm, tm = models
    build, kp_atol = BUILDERS[name]
    ja, tb = str(tmp_path / "j"), str(tmp_path / "t")
    meta_j, meta_t = build(jfr, ja, jm), build(tfr, tb, tm)
    assert _tree(ja) == _tree(tb)
    differ = []
    for rel in _tree(ja):
        a, b = os.path.join(ja, rel), os.path.join(tb, rel)
        with open(a, "rb") as f, open(b, "rb") as g:
            if f.read() == g.read():
                continue
        differ.append(rel)
        if "TotalCapture_60FPS_Original" in rel:
            with open(a, "rb") as f, open(b, "rb") as g:
                x, y = pickle.load(f), pickle.load(g)
            for k in ("ori", "gt"):
                np.testing.assert_allclose(y[k], x[k], atol=ATOL)
            aa = [e[0] for e in meta_j["entries"].values()]
            bound, _ = acc_bound(models, [
                (_rot_jax(p), _rot_port(p), e[1], None)
                for p, e in zip(aa, meta_j["entries"].values())])
            assert float(np.abs(y["acc"] - x["acc"]).max()) <= bound
            continue
        gap = _file_gap(a, b)
        assert gap <= (kp_atol if rel.endswith(".pt") else ATOL), (rel, gap)
    # what numpy draws is equal: the motions, the 17-joint keypoints, the
    # split lists, the sequence pickles of 3DPW, the camera files
    for rel in _tree(ja):
        if rel.startswith(("motions", "keypoints2d/", "splits",
                           "sequenceFiles")) or rel.endswith(
                               ("mapping.txt", "calibration.cal")):
            assert rel not in differ, rel
    assert list(meta_j["entries"]) == list(meta_t["entries"])


@pytest.mark.parametrize("name", ["aist", "tc", "pw3d", "pw3d_occ"])
def test_work_dicts_load_across_packages(corpora, name):
    r"""A dict the port wrote loads in the JAX package's
    ``eval/datasets.py``, and the reverse, giving the sequences each
    package builds from its own."""
    _, jax_path, port_path = corpora[name]
    build = {"aist": "build_aist_sequences", "tc": "build_tc_sequences",
             "pw3d": "build_pw3d_sequences",
             "pw3d_occ": "build_pw3d_sequences"}[name]
    for mod in (jds, tds):
        own = getattr(mod, build)(mod.load_torch_file(port_path if mod is tds
                                                      else jax_path))
        other = getattr(mod, build)(mod.load_torch_file(jax_path if mod is tds
                                                        else port_path))
        assert len(own) == len(other) > 0
        for a, b in zip(own, other):
            assert (a.name, a.length, a.valid) == (b.name, b.length, b.valid)
            for k in ("j2dc", "oric", "pose_gt", "tran_gt"):
                np.testing.assert_allclose(getattr(a, k), getattr(b, k),
                                           atol=1e-4)


# ---------------------------------------------------------------------------
# AMASS and the preprocess command
# ---------------------------------------------------------------------------


def _amass_tree(root):
    r"""``<corpus>/<subject>/*_poses.npz`` at 120 fps in a train and a val
    corpus, one sequence too short to keep."""
    rng = np.random.RandomState(8)
    for corpus, subject, n in (("ACCAD", "s1", 2), ("CMU", "s7", 1),
                               ("HumanEva", "s2", 1)):
        d = os.path.join(root, corpus, subject)
        os.makedirs(d)
        for i in range(n):
            aa, tran = smooth_random_motion(rng, 48 + 8 * i)
            poses = np.concatenate([aa.reshape(len(aa), 72),
                                    np.zeros((len(aa), 84), np.float32)], 1)
            np.savez(os.path.join(d, f"m{i}_poses.npz"), poses=poses,
                     trans=tran, mocap_framerate=120.0)
    np.savez(os.path.join(root, "ACCAD", "s1", "short_poses.npz"),
             poses=np.zeros((12, 156), np.float32),
             trans=np.zeros((12, 3), np.float32), mocap_framerate=120.0)


def test_preprocess_amass_matches_jax_and_cli(models, tmp_path):
    r"""JAX's ``preprocess_amass`` with the AMASS splits against the
    port's, the port's ``preprocess --dataset amass`` command against its
    function, and the JAX command's ``TypeError`` (it drops ``splits``)."""
    from robustcap_tpu.__main__ import main as jax_cli
    from robustcap_tpu.smpl import default_body_model as jax_body
    from robustcap_tpu_torch.__main__ import main as port_cli
    from robustcap_tpu_torch.smpl import default_body_model as port_body
    jm, tm = models
    raw = str(tmp_path / "amass")
    _amass_tree(raw)
    splits = {"train": AmassSplits.train, "val": AmassSplits.val}
    want = jdatasets.preprocess_amass(jm, raw, str(tmp_path / "j"), splits)
    got = tdatasets.preprocess_amass(tm, raw, str(tmp_path / "t"), splits,
                                     device="cpu")
    assert [len(want[k]["pose"]) for k in ("train", "val")] == [3, 1]
    for kind in ("train", "val"):
        bound, _ = acc_bound(models, [
            (_rot_jax(p), _rot_port(p), t, None)
            for p, t in zip(want[kind]["pose"], want[kind]["tran"])])
        compare_work(_load(str(tmp_path / "j" / f"{kind}.pt")),
                     _load(str(tmp_path / "t" / f"{kind}.pt")), bound)

    with pytest.raises(TypeError, match="splits"):
        jax_cli(["preprocess", "--dataset", "amass", "--raw", raw,
                 "--out", str(tmp_path / "jcli")])
    port_cli(["preprocess", "--dataset", "amass", "--raw", raw,
              "--out", str(tmp_path / "tcli"), "--device", "cpu"])
    body = port_body("cpu")
    direct = tdatasets.preprocess_amass(body, raw, str(tmp_path / "t2"),
                                        splits, device="cpu")
    for kind in ("train", "val"):
        gaps = compare_work(direct[kind],
                            _load(str(tmp_path / "tcli" / f"{kind}.pt")), 0.0)
        assert max(gaps.values()) == 0.0
    jbody = jax_body()
    full = jdatasets.preprocess_amass(jbody, raw, str(tmp_path / "j2"),
                                      splits, save=False)
    bound, _ = acc_bound((jbody, body), [
        (_rot_jax(p), _rot_port(p), t, None)
        for p, t in zip(full["train"]["pose"], full["train"]["tran"])])
    compare_work(full["train"], direct["train"], bound)


@pytest.mark.parametrize("dataset", ["aist", "aist_pre", "tc_pre", "tc",
                                     "pw3d", "pw3d_occ"])
def test_cli_preprocess(models, tmp_path, dataset, capsys):
    r"""``python -m robustcap_tpu_torch preprocess`` over each corpus
    choice writes what the driver writes and prints its counts."""
    from robustcap_tpu_torch.__main__ import main as port_cli
    from robustcap_tpu_torch.smpl import default_body_model
    body = default_body_model("cpu")
    raw, out = str(tmp_path / "raw"), str(tmp_path / "out")
    if dataset.startswith("aist"):
        tfr.build_raw_aist(raw, body, n_seq=1, T=16, misaligned_cam=2)
    elif dataset.startswith("tc"):
        tfr.build_raw_totalcapture(raw, body, n_seq=1, T=16)
        if dataset == "tc":
            tcorpus.preprocess_totalcapture_pre(raw, model=body,
                                                device="cpu")
    else:
        tfr.build_raw_pw3d(raw, body, n_seq=1, T60=16,
                           occ=dataset == "pw3d_occ")
    args = ["preprocess", "--dataset", dataset, "--raw", raw,
            "--device", "cpu"]
    if dataset != "tc_pre":
        args += ["--out", out if dataset != "aist_pre"
                 else str(tmp_path / "na.txt")]
    port_cli(args)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    if dataset == "aist":
        assert printed == {"test": 1}
        assert len(_load(os.path.join(out, "test.pt"))["name"]) == 1
    elif dataset == "aist_pre":
        assert any("c03" in n for n in printed["not_aligned"])
        with open(tmp_path / "na.txt") as f:
            assert f.read().split() == printed["not_aligned"]
    elif dataset == "tc_pre":
        assert os.path.exists(printed["out"])
    elif dataset == "tc":
        # the default skip list names motions 2, 12 and 42
        assert printed == {"sequences": 1}
    else:
        assert printed == {"person_sequences": 1}
        name = "test_occ.pt" if dataset == "pw3d_occ" else "test.pt"
        assert len(_load(os.path.join(out, name))["posec"]) == 1

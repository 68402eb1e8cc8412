r"""The port's offline evaluation against the JAX package's: fixture corpora,
sequence building, bucketing and padding, Procrustes, the metric suite,
``evaluate_sequences`` with its caches, the runner under ``pallas_tail``,
the contact evaluation, and the serve kernel's end-metric contract.

Both packages get the same numpy inputs and the same weights (JAX
``init_params``, carried across with ``params_from_numpy``); the JAX serve
and tail kernels run in Pallas interpret mode, the port's serve path its
plain version and its tail operator its CPU implementation. Tolerances
are stated where they are used: what numpy computes on the host is held
equal; what the body math computes in float32 within 1e-5 (positions,
metres) or one float32 rounding of a rotation entry (1e-6); metrics
within 1e-5 m; PA-MPJPE (float64 on the host on both sides) within rtol
1e-9.
"""

import collections
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from robustcap_tpu import config as JC
from robustcap_tpu.eval import contacts as jcontacts
from robustcap_tpu.eval import datasets as jdata
from robustcap_tpu.eval import evaluate as jeval
from robustcap_tpu.eval import evaluator as jev
from robustcap_tpu.eval import runner as jrunner
from robustcap_tpu.eval.quality import serve_end_metric_deltas as jquality
from robustcap_tpu.ops import procrustes as jproc
from robustcap_tpu.preprocess import fixtures as jfix
from robustcap_tpu_torch import config as TC
from robustcap_tpu_torch.__main__ import main
from robustcap_tpu_torch.eval import contacts as tcontacts
from robustcap_tpu_torch.eval import datasets as tdata
from robustcap_tpu_torch.eval import evaluate as teval
from robustcap_tpu_torch.eval import evaluator as tev
from robustcap_tpu_torch.eval import runner as trunner
from robustcap_tpu_torch.eval.quality import (END_METRIC_BOUND_MM,
                                              serve_end_metric_deltas)
from robustcap_tpu_torch.models import sig_mp as tsig
from robustcap_tpu_torch.ops import procrustes as tproc
from robustcap_tpu_torch.preprocess import fixtures as tfix
from robustcap_tpu_torch.smpl import ParametricModel, synthetic_smpl_data
from test_torch_smplify import one_torch_thread
from test_torch_tail import make_models, make_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the procedural body's regressor stands in for the absent H36M asset
pytestmark = pytest.mark.filterwarnings(
    "ignore:H36M joint regressor not found")

ATOL_M = 1e-5
SEQ_FIELDS = ("j2dc", "j2dc_px", "accc", "oric", "tran_gt", "gravityc",
              "cam_K")


@pytest.fixture(scope="module")
def world():
    jm, tm = make_models(num_verts=400)
    jp, tp = make_params(1)
    ds = tfix.build_fixture_dataset(tm, n_seq=1, T=32, n_cam=2, seed=9)
    return jm, tm, jp, tp, ds


def _seqs_equal(js, ts):
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        assert (a.name, a.first_frame, a.valid, a.length) == \
            (b.name, b.first_frame, b.valid, b.length)
        for k in SEQ_FIELDS:
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
        # Rodrigues in float32: the two packages' sin/cos may round apart
        np.testing.assert_allclose(b.pose_gt, a.pose_gt, atol=1e-6)
        if a.first_tran is None:
            assert b.first_tran is None
        else:
            np.testing.assert_array_equal(b.first_tran, a.first_tran)


# ---------------------------------------------------------------------------
# Config, fixtures, sequences
# ---------------------------------------------------------------------------


def test_config_values_equal_jax():
    assert TC.TRAN_OFFSET == JC.TRAN_OFFSET
    assert TC.IMU_VERTEX_MASK == JC.IMU_VERTEX_MASK
    assert TC.PW3D_OCCLUDED_SEQUENCES == JC.PW3D_OCCLUDED_SEQUENCES
    for root in ("data", "/x/y"):
        jp, tp = JC.Paths(data_root=root), TC.Paths(data_root=root)
        for name in ("smpl_file", "smpl_file_female", "work_dir", "aist_dir",
                     "amass_dir", "totalcapture_dir", "pw3d_dir",
                     "weight_dir", "j_regressor_file", "gmm_prior_file",
                     "syn_conf_file", "temp_dir"):
            assert getattr(tp, name) == getattr(jp, name), name
    assert TC.paths == TC.Paths()


@pytest.mark.parametrize("num_verts", [400, 6890])
def test_fixture_matches_jax(num_verts):
    r"""The same ``RandomState`` draws in the same order: what numpy makes
    is equal, what the body math makes within 1e-5 (accelerations are
    second differences times fps^2 / n^2 = 900, so they get 900 x that,
    and pixel keypoints the image width times it)."""
    jm, tm = make_models(num_verts=num_verts)
    want = jfix.build_fixture_dataset(jm, n_seq=2, T=24, n_cam=2, seed=5)
    got = tfix.build_fixture_dataset(tm, n_seq=2, T=24, n_cam=2, seed=5)
    assert got["name"] == want["name"]
    for k in ("pose", "tran", "cam_K"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    for k in ("joint3d", "joint2d_mp", "cam_T", "imu_ori", "sync_3d_mp"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   atol=ATOL_M)
    np.testing.assert_allclose(np.asarray(got["imu_acc"]),
                               np.asarray(want["imu_acc"]), atol=900 * ATOL_M)

    want = jfix.build_fixture_dataset_pw3d(jm, n_seq=1, T=16, seed=5)
    got = tfix.build_fixture_dataset_pw3d(tm, n_seq=1, T=16, seed=5)
    for k in ("posec", "tranc", "imu_oric", "cam_K", "cam_T"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   atol=ATOL_M)
    np.testing.assert_allclose(np.asarray(got["imu_accc"]),
                               np.asarray(want["imu_accc"]),
                               atol=900 * ATOL_M)
    np.testing.assert_allclose(np.asarray(got["joint2d_mp"]),
                               np.asarray(want["joint2d_mp"]),
                               atol=tfix.IMG_W * ATOL_M)


def test_sequence_building_matches_jax(world):
    r"""From one dataset dict, each builder gives the JAX package's
    sequences; the rotations of the ground-truth pose within one float32
    rounding, every other field equal."""
    _, tm, _, _, ds = world
    _seqs_equal(jdata.build_aist_sequences(ds, ["synth_seq_0_c02"]),
                tdata.build_aist_sequences(ds, ["synth_seq_0_c02"]))
    _seqs_equal(jdata.build_tc_sequences(ds, num_cameras=1),
                tdata.build_tc_sequences(ds, num_cameras=1))
    pw = tfix.build_fixture_dataset_pw3d(tm, n_seq=2, T=12, seed=3)
    pw["joint2d_mp"][1] = None
    _seqs_equal(jdata.build_pw3d_sequences(pw),
                tdata.build_pw3d_sequences(pw))


def _varied(ds, lengths):
    seqs = tdata.build_aist_sequences(ds)
    out = []
    for i, n in enumerate(lengths):
        s = seqs[i % len(seqs)]
        out.append(tdata.EvalSequence(
            name=f"{s.name}_{i}", j2dc=s.j2dc[:n], j2dc_px=s.j2dc_px[:n],
            accc=s.accc[:n], oric=s.oric[:n], pose_gt=s.pose_gt[:n],
            tran_gt=s.tran_gt[:n], gravityc=s.gravityc[:n], cam_K=s.cam_K,
            first_tran=s.first_tran if i % 3 else None,
            first_frame=i % 3 == 0))
    return out


def test_buckets_and_stacking_match_jax(world):
    r"""Buckets, and the padded frames of each (the last frame repeated),
    equal to the JAX package's."""
    seqs = _varied(world[4], [32, 5, 17, 32, 9, 1, 20])
    for max_bucket, multiple in ((32, 8), (2, 16), (3, 128)):
        want = jdata.bucket_sequences(seqs, max_bucket, multiple)
        assert tdata.bucket_sequences(seqs, max_bucket, multiple) == want
    for indices, pad_len in jdata.bucket_sequences(seqs, 4, 8):
        batch = [seqs[i] for i in indices]
        for mode in ("gt", "first_frame"):
            want = jrunner.stack_frames(batch, pad_len, mode)
            got = trunner.stack_frames(batch, pad_len, mode)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))


def test_synthesis_matches_jax():
    r"""The virtual sensors and the camera plumbing of
    ``preprocess/synthesis.py`` on the same inputs: within float32
    rounding (accelerations 900 x, as in the fixtures)."""
    from robustcap_tpu.preprocess import synthesis as jsyn
    from robustcap_tpu_torch.preprocess import synthesis as tsyn
    rng = np.random.RandomState(7)
    verts = rng.randn(20, 6890, 3).astype(np.float32)
    glb = _poses(8, 20)
    K = np.array([[1200.0, 0, 960], [0, 1100.0, 540], [0, 0, 1]], np.float32)
    pts = (rng.randn(20, 33, 3) + [0, 0, 5]).astype(np.float32)
    for smooth_n in (1, 2, 4):
        np.testing.assert_allclose(
            tsyn.syn_acc(torch.from_numpy(verts[:, :50]), smooth_n).numpy(),
            np.asarray(jsyn.syn_acc(jnp.asarray(verts[:, :50]), smooth_n)),
            atol=900 * 1e-6)
    ori, acc = tsyn.synthesize_imu(torch.from_numpy(glb),
                                   torch.from_numpy(verts))
    jori, jacc = jsyn.synthesize_imu(jnp.asarray(glb), jnp.asarray(verts))
    np.testing.assert_array_equal(ori.numpy(), np.asarray(jori))
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), atol=900 * 1e-6)
    uv = tsyn.project_points(torch.from_numpy(pts), torch.from_numpy(K))
    np.testing.assert_allclose(
        uv.numpy(), np.asarray(jsyn.project_points(jnp.asarray(pts),
                                                   jnp.asarray(K))),
        rtol=1e-6)
    np.testing.assert_allclose(
        tsyn.normalize_keypoints(uv, torch.from_numpy(K)).numpy(),
        np.asarray(jsyn.normalize_keypoints(jnp.asarray(uv.numpy()),
                                            jnp.asarray(K))), atol=1e-6)
    joints = rng.randn(20, 24, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tsyn.sync_3d_mp(torch.from_numpy(pts), torch.from_numpy(joints)
                        ).numpy(),
        np.asarray(jsyn.sync_3d_mp(jnp.asarray(pts), jnp.asarray(joints))))


@pytest.mark.parametrize("rep", ["AXIS_ANGLE", "ROTATION_MATRIX",
                                 "QUATERNION", "R6D", "EULER_ANGLE"])
def test_rotation_conversions_match_jax(rep):
    r"""``to_rotation_matrix`` from each representation, the conversions
    back (axis-angle through the quaternion, r6d), ``append_*``, and
    ``angle_between`` in each representation, within float32 rounding."""
    import robustcap_tpu.math as JM
    import robustcap_tpu_torch.math as TM
    rng = np.random.RandomState(9)
    x = {"AXIS_ANGLE": rng.randn(64, 3) * 1.5,
         "ROTATION_MATRIX": _poses(10, 2).reshape(-1, 3, 3)[:40],
         "QUATERNION": rng.randn(64, 4),
         "R6D": rng.randn(64, 6),
         "EULER_ANGLE": rng.randn(64, 3)}[rep].astype(np.float32)
    jrep = getattr(JM.RotationRepresentation, rep)
    trep = getattr(TM.RotationRepresentation, rep)
    R_t = TM.to_rotation_matrix(torch.from_numpy(x), trep)
    R_j = np.array(JM.to_rotation_matrix(jnp.asarray(x), jrep))
    np.testing.assert_allclose(R_t.numpy(), R_j, atol=2e-6)
    for name in ("rotation_matrix_to_axis_angle",
                 "rotation_matrix_to_quaternion", "rotation_matrix_to_r6d"):
        np.testing.assert_allclose(
            getattr(TM, name)(torch.from_numpy(R_j)).numpy(),
            np.asarray(getattr(JM, name)(jnp.asarray(R_j))), atol=1e-5,
            err_msg=name)
    y = np.roll(x, 1, axis=0)
    np.testing.assert_allclose(
        TM.angle_between(torch.from_numpy(x), torch.from_numpy(y),
                         trep).numpy(),
        np.asarray(JM.angle_between(jnp.asarray(x), jnp.asarray(y), jrep)),
        atol=1e-4)
    np.testing.assert_allclose(
        TM.radian_to_degree(TM.degree_to_radian(torch.from_numpy(x))).numpy(),
        x, rtol=1e-6)
    for fn in ("append_zero", "append_one"):
        for dim in (0, -1):
            np.testing.assert_array_equal(
                getattr(TM, fn)(torch.from_numpy(x), dim).numpy(),
                np.asarray(getattr(JM, fn)(jnp.asarray(x), dim)))


# ---------------------------------------------------------------------------
# Procrustes and the metric suite
# ---------------------------------------------------------------------------


def test_procrustes_matches_jax():
    rng = np.random.RandomState(0)
    S2 = rng.randn(20, 14, 3).astype(np.float32)
    R = np.linalg.qr(rng.randn(20, 3, 3))[0]
    S1 = (1.3 * S2 @ R + rng.randn(20, 1, 3) + 0.05 * rng.randn(20, 14, 3)
          ).astype(np.float32)
    S1[3] = S1[3, :, ::-1]          # a reflection: the determinant's sign
    for reduction in ("mean", "sum", "none"):
        np.testing.assert_allclose(
            tproc.reconstruction_error_np(S1, S2, reduction),
            jproc.reconstruction_error_np(S1, S2, reduction), rtol=1e-9)
        np.testing.assert_allclose(
            tproc.reconstruction_error(torch.from_numpy(S1),
                                       torch.from_numpy(S2),
                                       reduction).numpy(),
            np.asarray(jproc.reconstruction_error(jnp.asarray(S1),
                                                  jnp.asarray(S2),
                                                  reduction)), atol=ATOL_M)


def _poses(seed, n):
    import robustcap_tpu.math as JM
    rng = np.random.RandomState(seed)
    return np.array(JM.axis_angle_to_rotation_matrix(jnp.asarray(
        rng.randn(n * 24, 3).astype(np.float32) * 0.4))).reshape(n, 24, 3, 3)


def test_evaluators_match_jax(world):
    r"""The metric battery on the same poses: angles in degrees and
    positions in metres within 1e-4 relative (float32 FK and SVDs), the
    counts of the classification metrics equal."""
    jm, tm = world[0], world[1]
    n = 70                               # > fps, for the 1-s drift
    pose_p, pose_t = _poses(1, n), _poses(2, n)
    tran_p = np.cumsum(np.random.RandomState(3).randn(n, 3) * 0.01,
                       0).astype(np.float32)
    tran_t = tran_p[::-1].copy()

    def close(got, want):
        np.testing.assert_allclose(np.asarray(got.cpu()), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)

    close(tev.PositionErrorEvaluator()(tran_p, tran_t),
          jev.PositionErrorEvaluator()(tran_p, tran_t))
    close(tev.RotationErrorEvaluator()(pose_p, pose_t),
          jev.RotationErrorEvaluator()(pose_p, pose_t))
    for align in (0, -1):
        close(tev.MeanPerJointErrorEvaluator(align_joint=align,
                                             model=tm)(pose_p, pose_t),
              jev.MeanPerJointErrorEvaluator(align_joint=align,
                                             model=jm)(pose_p, pose_t))
        close(tev.MeshErrorEvaluator(align_joint=align, model=tm)(pose_p,
                                                                  pose_t),
              jev.MeshErrorEvaluator(align_joint=align, model=jm)(pose_p,
                                                                  pose_t))
    close(tev.FullMotionEvaluator(model=tm, joint_mask=[1, 4, 7])(
        pose_p, pose_t, tran_p=tran_p, tran_t=tran_t),
        jev.FullMotionEvaluator(model=jm, joint_mask=[1, 4, 7])(
            pose_p, pose_t, tran_p=tran_p, tran_t=tran_t))
    rng = np.random.RandomState(4)
    p, t = rng.uniform(0, 1, 200), (rng.uniform(0, 1, 200) > 0.4) * 1.0
    for sig in (False, True):
        np.testing.assert_array_equal(
            tev.BinaryConfusionMatrixEvaluator(sig)(p - 0.5 * (not sig),
                                                    t).numpy(),
            np.asarray(jev.BinaryConfusionMatrixEvaluator(sig)(
                p - 0.5 * (not sig), t)))
        close(tev.BinaryClassificationErrorEvaluator(sig)(p, t),
              jev.BinaryClassificationErrorEvaluator(sig)(p, t))


def test_cal_mpjpe_matches_jax(world):
    jm, tm = world[0], world[1]
    pose_p, pose_t = _poses(5, 12), _poses(6, 12)
    want = np.asarray(jeval.cal_mpjpe(pose_p, pose_t, True, model=jm))
    got = teval.cal_mpjpe(pose_p, pose_t, True, model=tm, device="cpu")
    np.testing.assert_allclose(got[:2], want[:2], atol=ATOL_M)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    assert teval.cal_mpjpe(pose_p, pose_t, model=tm, device="cpu").shape \
        == (2,)


# ---------------------------------------------------------------------------
# evaluate_sequences, its caches and entry points
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def evaluated(world):
    jm, tm, jp, tp, ds = world
    js = jdata.build_aist_sequences(ds, ["synth_seq_0_c02"])
    ts = tdata.build_aist_sequences(ds, ["synth_seq_0_c02"])
    kw = dict(pad_to_multiple=16, max_bucket=1)
    want = jeval.evaluate_sequences(js, params=jp, model=jm,
                                    extended_metrics=True, **kw)
    got = teval.evaluate_sequences(ts, params=tp, model=tm,
                                   extended_metrics=True, device="cpu", **kw)
    return js, ts, want, got


def test_evaluate_sequences_matches_jax(evaluated):
    r"""Batched inference (two buckets of one, padded past their length)
    and scoring: every metric within 1e-5 m, the invalid view skipped."""
    _, _, want, got = evaluated
    assert got["valid"].tolist() == [True, False]
    for k in ("mpjpe", "pve", "pampjpe", "tran_error"):
        np.testing.assert_allclose(got[k], want[k], atol=ATOL_M)
    np.testing.assert_allclose(got["errors"], np.asarray(want["errors"]),
                               atol=ATOL_M)
    for a, b in zip(want["pose_p"], got["pose_p"]):
        np.testing.assert_allclose(b, np.asarray(a), atol=5e-4)
    np.testing.assert_allclose(got["full_motion"],
                               np.asarray(want["full_motion"]),
                               rtol=1e-3, atol=1e-3)


class _OpCounts(TorchDispatchMode):
    r"""Counts the operators dispatched under it, by name."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func.name()] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("pallas_tail", [False, True])
def test_runner_keeps_pallas_tail(world, evaluated, pallas_tail):
    r"""``run_sequences`` and ``evaluate_sequences`` build their step from
    the caller's ``cfg``, as the JAX runner does: with ``pallas_tail`` one
    bucket of both views (32 frames, ``max_bucket=2``) dispatches the tail
    operator ``robustcap::geometry_tail`` twice a frame-step (speculative
    and final tail), 64 times, where the JAX runner runs its Pallas tail
    under ``vmap`` (interpret mode here, one bucket of two); without it,
    none, against the JAX run of ``evaluated`` (buckets of one: the rows
    are independent). JAX's trajectories are its runner's, as its
    ``evaluate_sequences`` returns them: translation within 1e-5 m,
    rotation entries within 5e-4, metrics within 1e-5 m. On the CPU the
    operator is ``tail_batched``, so either run is
    ``forward_offline_batched``'s (which turns the flag off) bit for bit:
    the flag-off route is unchanged."""
    jm, tm, jp, tp, ds = world
    js, ts, want, _ = evaluated
    kw = dict(pad_to_multiple=16, max_bucket=2)
    if pallas_tail:
        want = jeval.evaluate_sequences(
            js, params=jp, model=jm, cfg=JC.SigMPConfig(pallas_tail=True),
            **kw)
    cfg = TC.SigMPConfig(pallas_tail=pallas_tail)
    with _OpCounts() as ops:
        runs = trunner.run_sequences(tp, tm, cfg, ts, device="cpu", **kw)
    assert ops.n["robustcap::geometry_tail"] == (64 if pallas_tail else 0)
    for (pose, tran), wp, wt in zip(runs, want["pose_p"], want["tran_p"]):
        np.testing.assert_allclose(tran, np.asarray(wt), atol=ATOL_M)
        np.testing.assert_allclose(pose, np.asarray(wp), atol=5e-4)
    plain = tsig.forward_offline_batched(
        tp, tm, cfg, trunner.stack_frames(ts, 32), lengths=[32, 32],
        device="cpu")
    for b, (pose, tran) in enumerate(runs):
        np.testing.assert_array_equal(pose, plain[0][b].numpy())
        np.testing.assert_array_equal(tran, plain[1][b].numpy())
    got = teval.evaluate_sequences(ts, params=tp, model=tm, cfg=cfg,
                                   device="cpu", **kw)
    for k in ("mpjpe", "pve", "pampjpe", "tran_error"):
        np.testing.assert_allclose(got[k], want[k], atol=ATOL_M)


@pytest.mark.parametrize("layout", ["result4", "result2"])
def test_each_side_reads_the_others_cache(evaluated, world, tmp_path,
                                          monkeypatch, layout):
    r"""A cache written by either package scores the same in the other,
    with no params (both ``.pt`` layouts). The JAX side writes the
    trajectories it already ran (its runner returns them again)."""
    js, ts, want, got = evaluated
    jm, tm = world[0], world[1]
    monkeypatch.setattr(jeval, "run_sequences", lambda *a, **k: list(
        zip(want["pose_p"], want["tran_p"])))
    for side in ("jax", "port"):
        path = str(tmp_path / side / "result.pt")
        if side == "jax":
            jeval.evaluate_sequences(js, params=world[2], model=jm,
                                     cache_path=path, cache_format=layout)
            out = teval.evaluate_sequences(ts, model=tm, cache_path=path,
                                           device="cpu")
            ref = want
        else:
            teval.evaluate_sequences(ts, params=world[3], model=tm,
                                     cache_path=path, cache_format=layout,
                                     pad_to_multiple=32, device="cpu")
            out = jeval.evaluate_sequences(js, model=jm, cache_path=path)
            ref = got
        loaded = torch.load(path, weights_only=False)
        assert len(loaded) == (2 if layout == "result2" else 4)
        assert all(isinstance(x, torch.Tensor) for x in loaded[0])
        for k in ("mpjpe", "pve", "pampjpe", "tran_error"):
            np.testing.assert_allclose(out[k], ref[k], atol=ATOL_M)


def test_entry_points(world, tmp_path, monkeypatch):
    r"""``evaluate_{aist,tc,pw3d}_ours`` on fixtures with a cache under a
    repointed data root: the second call reads the cache, without params;
    each entry also runs with its default, SMPLify refinement on, which
    moves the poses."""
    _, tm, _, tp, ds = world
    monkeypatch.setattr(teval, "paths", TC.Paths(data_root=str(tmp_path)))
    out = teval.evaluate_aist_ours(run_smplify=False, params=tp, model=tm,
                                   dataset=ds, device="cpu")
    assert os.path.exists(tmp_path / "dataset_work/AIST/result.pt")
    again = teval.evaluate_aist_ours(run_smplify=False, model=tm, dataset=ds,
                                     device="cpu")
    assert again["mpjpe"] == out["mpjpe"]
    tc = teval.evaluate_tc_ours(run_smplify=False, params=tp, model=tm,
                                dataset=ds, use_cache=False, device="cpu")
    pw = teval.evaluate_pw3d_ours(
        run_smplify=False, params=tp, model=tm,
        dataset=tfix.build_fixture_dataset_pw3d(tm, n_seq=1, T=16, seed=2),
        device="cpu")
    assert os.path.exists(tmp_path / "dataset_work/3DPW/result2.pt")
    for o in (out, tc, pw):
        assert np.isfinite([o["mpjpe"], o["pve"], o["pampjpe"]]).all()
    with one_torch_thread():
        refined = [
            teval.evaluate_aist_ours(params=tp, model=tm, dataset=ds,
                                     use_cache=False, device="cpu"),
            teval.evaluate_tc_ours(params=tp, model=tm, dataset=ds,
                                   use_cache=False, device="cpu"),
            teval.evaluate_pw3d_ours(
                params=tp, model=tm,
                dataset=tfix.build_fixture_dataset_pw3d(tm, n_seq=1, T=16,
                                                        seed=2),
                use_cache=False, device="cpu")]
    for plain, o in zip((out, tc, pw), refined):
        assert np.isfinite([o["mpjpe"], o["pve"], o["pampjpe"]]).all()
        assert any(np.abs(a - b).max() > 1e-4
                   for a, b in zip(o["pose_p"], plain["pose_p"]))


def test_cli_eval(world, tmp_path, capsys, monkeypatch):
    r"""``python -m robustcap_tpu_torch eval`` in-process on the CPU, over
    a fixture AIST++ corpus under a repointed data root: the metrics as
    JSON, ``--no-smplify`` gives the unrefined ones, and without
    ``--no-cache`` the result cache is written."""
    jp = world[2]
    monkeypatch.setattr(teval, "paths", TC.Paths(data_root=str(tmp_path)))
    # the CLI scores on the default body: the 6890-vertex procedural one
    os.makedirs(tmp_path / "dataset_work/AIST")
    torch.save(tfix.build_fixture_dataset(
        ParametricModel(data=synthetic_smpl_data(), device="cpu"), n_seq=1,
        T=16, n_cam=2, seed=3), tmp_path / "dataset_work/AIST/test.pt")
    pkl = str(tmp_path / "w.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(jax.tree.map(np.array, jp), f)
    lines = {}
    for flag in ("--no-smplify", None):
        argv = ["eval", "--weights", pkl, "--no-cache", "--device", "cpu"]
        with one_torch_thread():
            main(argv + ([flag] if flag else []))
        lines[flag] = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])
    for line in lines.values():
        assert set(line) == {"mpjpe", "pve", "pampjpe", "tran_error"}
        assert np.isfinite(list(line.values())).all()
    assert lines[None] != lines["--no-smplify"]
    main(["eval", "--weights", pkl, "--no-smplify", "--device", "cpu"])
    assert os.path.exists(tmp_path / "dataset_work/AIST/result.pt")


def test_evaluate_contacts_matches_jax(world):
    jm, tm, jp, tp, ds = world
    js = jdata.build_aist_sequences(ds, num_cameras=1)
    ts = tdata.build_aist_sequences(ds, num_cameras=1)
    gt = [jcontacts.contact_labels_from_joints(ds["joint3d"][0])]
    np.testing.assert_array_equal(
        tcontacts.contact_labels_from_joints(ds["joint3d"][0]), gt[0])
    want = jcontacts.evaluate_contacts(jp, jm, js, gt,
                                       probability_threshold=0.6)
    got = tcontacts.evaluate_contacts(tp, tm, ts, gt,
                                      probability_threshold=0.6,
                                      device="cpu")
    np.testing.assert_allclose(got["prf"], np.asarray(want["prf"]),
                               atol=1e-6)
    assert got["accuracy"] == want["accuracy"]


def test_serve_end_metric_deltas(world):
    r"""The serve path's bf16 and int8-gate modes against float32, through
    the real scoring: float32 metrics as the JAX package's (both rounded to
    1e-3 mm), the bf16 deltas within 0.01 mm of its (the same bf16
    arithmetic), the int8 deltas within 0.5 mm (the int8-gate arithmetic
    quantizes at other places in the two kernels), and every delta inside
    the 2 mm contract."""
    jm, tm, jp, tp, _ = world
    kw = dict(eval_frames=32, n_seq=1, n_cam=1, modes=("bf16", "int8"),
              seed=5)
    want = jquality(jp, jm, **kw)
    got = serve_end_metric_deltas(tp, tm, device="cpu", **kw)
    assert set(got) == set(want)
    for k, v in want["f32_mm"].items():
        assert abs(got["f32_mm"][k] - v) <= 2e-3, k
    for mode, tol in (("bf16", 0.01), ("int8", 0.5)):
        key = f"pallas_serve_{mode}_delta_mm"
        for k, v in want[key].items():
            assert abs(got[key][k] - v) <= tol, (mode, k)
            assert abs(got[key][k]) < END_METRIC_BOUND_MM, (mode, k)

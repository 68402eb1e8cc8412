r"""The port's display methods of ``ParametricModel`` and the evaluation
views (``eval/visualize.py``) against the JAX package, on the CPU.

Mirrors ``tests/test_smpl_model.py``'s ``TestExport`` and ``TestViewMotion``
and ``tests/test_evaluate_api.py``'s two view cases (the same 400-vertex
body, ``SMALL_SPECS`` weights from ``PRNGKey(1)`` and 32-frame fixture
corpus). Bounds against JAX: the network's pose and translation within
``chip_smoke.py`` phase 4's bounds (per-frame max-abs pose median 1e-4, p95
1e-3, translation 2e-2 m; float32 sums in another order, carried through
the recurrent state), and at most 0.1% of the overlay's pixels different
(an edge pixel flips where the vertices move by those roundings); the Unity
text files' parsed values within 1.5e-4 (their 4 and 5 decimals round
float32 values that differ in the last bits). With SMPLify (lr 0.001, the
default of ``run_single_view``) the refined result's MPJPE, PVE and
PA-MPJPE within 1 mm of JAX's, and the refinement moving one of them by
more than that gap, as ``tests/test_torch_smplify.py`` holds the
evaluation's refinement: at lr 0.001 float32 rounding picks among the line
search's steps (``test_lr_0001_is_set_by_rounding``), so the refined
rotations are not held to a tenth of JAX's move.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robustcap_tpu.math as JM
from robustcap_tpu.eval import visualize as jvis
from robustcap_tpu.models import sig_mp as jsig
from robustcap_tpu.preprocess import build_fixture_dataset
from robustcap_tpu.smpl import ParametricModel as JModel
from robustcap_tpu.smpl import synthetic_smpl_data
from robustcap_tpu_torch.convert import params_from_numpy
from robustcap_tpu_torch.eval import (build_aist_sequences, run_single_view,
                                      view_aist, view_aist_unity)
from robustcap_tpu_torch.eval.evaluate import _j_regressor, _mpjpe
from robustcap_tpu_torch.smpl import ParametricModel
from robustcap_tpu_torch.smplify import smplify_runner
from test_torch_tail import SMALL_SPECS

CPU = torch.device("cpu")
POSE_MEDIAN, POSE_P95, TRAN_MAX = 1e-4, 1e-3, 2e-2
PIXEL_SHARE = 1e-3
TEXT_ATOL = 1.5e-4
METRIC_GAP = 1e-3


@contextlib.contextmanager
def one_torch_thread():
    r"""Torch's CPU ops on one thread: these paths are many small ops, which
    stall in OpenMP regions when the test run oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def make_model(**kw):
    return ParametricModel(data=synthetic_smpl_data(num_verts=500),
                           device=CPU, **kw)


def random_pose(seed, b, j=24):
    rng = np.random.RandomState(seed)
    aa = rng.normal(0, 0.3, (b * j, 3)).astype(np.float32)
    return np.asarray(JM.axis_angle_to_rotation_matrix(jnp.asarray(aa))
                      ).reshape(b, j, 3, 3)


def _read(path):
    with open(path) as f:
        return np.array([[float(v) for v in line.split(",")]
                         for line in f.read().split("\n")])


class TestExport:
    def test_save_unity_motion(self, tmp_path):
        model = make_model()
        model.save_unity_motion(random_pose(6, 2), np.zeros((2, 3),
                                                            np.float32),
                                str(tmp_path))
        lines = open(tmp_path / "pose.txt").read().strip().split("\n")
        assert len(lines) == 2 and len(lines[0].split(",")) == 72
        lines = open(tmp_path / "tran.txt").read().strip().split("\n")
        assert len(lines) == 2 and len(lines[0].split(",")) == 3

    def test_save_obj(self, tmp_path):
        model = make_model()
        p = tmp_path / "m.obj"
        model.save_obj_mesh(model.get_zero_pose_joint_and_vertex()[1], str(p))
        assert p.read_text().startswith("v ")

    def test_files_match_jax(self, tmp_path):
        r"""Seeded poses and translations, as arrays and as tensors: the
        Unity files parse to JAX's within ``TEXT_ATOL``, the obj file is
        JAX's line for line."""
        jmodel = JModel(data=synthetic_smpl_data(num_verts=500))
        pose = random_pose(8, 5)
        tran = np.random.RandomState(8).randn(5, 3).astype(np.float32)
        jmodel.save_unity_motion(pose, tran, str(tmp_path / "jax"))
        ParametricModel.save_unity_motion(pose, tran, str(tmp_path / "np"))
        ParametricModel.save_unity_motion(torch.from_numpy(pose),
                                          torch.from_numpy(tran),
                                          str(tmp_path / "torch"))
        for name in ("pose.txt", "tran.txt"):
            want = _read(tmp_path / "jax" / name)
            for kind in ("np", "torch"):
                np.testing.assert_allclose(_read(tmp_path / kind / name),
                                           want, atol=TEXT_ATOL)
        model = make_model()
        verts = model.forward_kinematics(torch.from_numpy(pose[:1]),
                                         calc_mesh=True)[2][0]
        model.save_obj_mesh(verts, str(tmp_path / "port.obj"))
        jmodel.save_obj_mesh(verts.numpy(), str(tmp_path / "jax.obj"))
        assert (tmp_path / "port.obj").read_text() == \
            (tmp_path / "jax.obj").read_text()


class TestViewMotion:
    def test_view_motion_sequence(self, tmp_path):
        model = make_model()
        out = tmp_path / "motion.mp4"
        frames = model.view_motion([random_pose(1, 3)],
                                   [np.zeros((3, 3), np.float32)], fps=30,
                                   output_path=str(out), resolution=(96, 96))
        assert frames.shape == (3, 96, 96, 3) and frames.dtype == np.uint8
        assert frames.any(), "mesh must rasterize to non-black pixels"
        assert out.exists() or out.with_suffix(".mp4.npy").exists()

    def test_view_motion_two_subjects_offset(self):
        model = make_model()
        pose_a, pose_b = random_pose(2, 2), random_pose(5, 2)
        f1 = model.view_motion([pose_a, pose_b], resolution=(96, 96))
        f2 = model.view_motion([pose_a], resolution=(96, 96))
        assert f1.shape == f2.shape == (2, 96, 96, 3)
        assert (f1 != f2).any()

    def test_single_frame_turntable(self):
        model = make_model()
        frames = model.view_motion([random_pose(3, 1)], resolution=(64, 64))
        assert frames.shape == (60, 64, 64, 3)
        assert (frames[0] != frames[30]).any()

    def test_view_mesh_overlay(self):
        model = make_model()
        verts = model.forward_kinematics(torch.from_numpy(random_pose(4, 2)),
                                         calc_mesh=True)[2]
        verts[..., 2] += 3.0
        images = np.full((64, 64, 3), 17, np.uint8)
        K = np.array([[80.0, 0, 32], [0, 80.0, 32], [0, 0, 1]])
        frames = model.view_mesh_overlay(verts, images, K)
        assert frames.shape == (2, 64, 64, 3)
        assert (frames != 17).any()
        assert (frames == 17).any()

    def test_frames_match_jax(self):
        r"""Two subjects with translations through ``view_motion``, and one
        overlay with an extrinsic: the same images as JAX's up to
        ``PIXEL_SHARE`` of the pixels (the port's FK rounds otherwise)."""
        data = synthetic_smpl_data(num_verts=500)
        model = ParametricModel(data=data, device=CPU)
        jmodel = JModel(data=data)
        pose_a, pose_b = random_pose(11, 3), random_pose(12, 3)
        tran = np.random.RandomState(11).randn(3, 3).astype(np.float32) * 0.1
        got = model.view_motion([pose_a, pose_b], [tran, tran],
                                resolution=(80, 64))
        want = jmodel.view_motion([pose_a, pose_b], [tran, tran],
                                  resolution=(80, 64))
        Tcw = np.eye(4, dtype=np.float32)
        Tcw[:3, 3] = [0.05, -0.1, 3.0]
        verts = jmodel.forward_kinematics(jnp.asarray(pose_a),
                                          calc_mesh=True)[2]
        bg = np.full((64, 80, 3), 40, np.uint8)
        K = np.array([[70.0, 0, 40], [0, 70.0, 32], [0, 0, 1]])
        got = np.concatenate([got, model.view_mesh_overlay(
            torch.from_numpy(np.asarray(verts)), bg, K, Tcw)])
        want = np.concatenate([want, jmodel.view_mesh_overlay(
            np.asarray(verts), bg, K, Tcw)])
        assert got.shape == want.shape and want.any()
        assert (got != want).any(-1).mean() <= PIXEL_SHARE


@pytest.fixture(scope="module")
def world():
    r"""``tests/test_evaluate_api.py``'s world in both packages, and the
    JAX views run once: the network on camera 0 of sequence 0, without and
    with SMPLify, ``view_aist`` over two frames and ``view_aist_unity``."""
    import tempfile
    jmodel = JModel(data=synthetic_smpl_data(num_verts=400))
    jparams = jsig.init_params(jax.random.PRNGKey(1), SMALL_SPECS)
    ds = build_fixture_dataset(jmodel, n_seq=1, T=32, n_cam=2, seed=9)
    model = ParametricModel(data=jmodel.data, device=CPU)
    params = params_from_numpy(jax.tree.map(np.array, jparams), CPU)
    seq = build_aist_sequences(ds, num_cameras=2)[0]
    jseq = jvis.build_aist_sequences(ds, num_cameras=2)[0]
    jpose, jtran = jvis.run_single_view(jparams, jmodel, jseq,
                                        run_smplify=False)
    refined = jvis.run_single_view(jparams, jmodel, jseq)
    frames = jvis.view_aist(0, 0, run_smplify=False, params=jparams,
                            model=jmodel, dataset=ds, max_frames=2)
    out = tempfile.mkdtemp()
    jvis.view_aist_unity(0, 1, params=jparams, model=jmodel, dataset=ds,
                         out_dir=out)
    want = {"pose": np.asarray(jpose), "tran": np.asarray(jtran),
            "refined": tuple(np.asarray(a) for a in refined),
            "frames": frames, "unity": {n: _read(os.path.join(out, n))
                                        for n in ("pose.txt", "tran.txt")}}
    return model, params, ds, seq, want


def _hold(pose, tran, want):
    per_frame = np.abs(pose - want["pose"]).reshape(len(pose), -1).max(1)
    assert np.median(per_frame) <= POSE_MEDIAN
    assert np.percentile(per_frame, 95) <= POSE_P95
    assert np.abs(tran - want["tran"]).max() <= TRAN_MAX


class TestViews:
    def test_view_aist_software_render(self, world):
        model, params, ds, _, _ = world
        frames = view_aist(0, 0, run_smplify=False, params=params,
                           model=model, dataset=ds, max_frames=2)
        assert len(frames) == 2
        assert frames[0].shape == (1080, 1920, 3)
        assert frames[0].sum() > 0

    def test_view_aist_unity_export(self, world, tmp_path):
        model, params, ds, _, _ = world
        out_dir = view_aist_unity(0, 0, params=params, model=model,
                                  dataset=ds, out_dir=str(tmp_path / "u"))
        pose_lines = open(os.path.join(out_dir, "pose.txt")).read().split("\n")
        assert len(pose_lines) == 32
        assert len(pose_lines[0].split(",")) == 72
        tran0 = [float(v) for v in
                 open(os.path.join(out_dir, "tran.txt")).readline().split(",")]
        np.testing.assert_allclose(tran0, 0, atol=1e-4)

    def test_run_single_view_and_overlay_match_jax(self, world, tmp_path):
        model, params, ds, seq, want = world
        pose, tran = run_single_view(params, model, seq, run_smplify=False)
        assert pose.shape == (32, 24, 3, 3) and tran.shape == (32, 3)
        _hold(pose, tran, want)
        frames = view_aist(0, 0, run_smplify=False, params=params,
                           model=model, dataset=ds, max_frames=2,
                           save_dir=str(tmp_path))
        assert os.listdir(tmp_path)
        for got, ref in zip(frames, want["frames"]):
            assert got.shape == ref.shape and ref.any()
            assert (got != ref).any(-1).mean() <= PIXEL_SHARE

    def test_view_aist_unity_matches_jax(self, world, tmp_path):
        model, params, ds, _, want = world
        out = view_aist_unity(0, 1, params=params, model=model, dataset=ds,
                              out_dir=str(tmp_path))
        for name, ref in want["unity"].items():
            np.testing.assert_allclose(_read(os.path.join(out, name)), ref,
                                       atol=TEXT_ATOL)

    def test_run_single_view_refines_with_smplify(self, world):
        r"""With ``run_smplify`` the network's output goes through
        ``smplify_runner`` as JAX's does (lr 0.001, L-BFGS, one step, the
        head): the result is that call's on the same output, and its
        metrics against the ground truth are JAX's ``run_single_view``'s
        within ``METRIC_GAP``, which the refinement's own move exceeds."""
        model, params, _, seq, want = world
        pose, tran = run_single_view(params, model, seq, run_smplify=False)
        got = run_single_view(params, model, seq)
        ref = smplify_runner(pose, tran, seq.j2dc_px, seq.oric,
                             batch_size=len(pose), cam_k=seq.cam_K,
                             lr=0.001, use_lbfgs=True, opt_steps=1,
                             use_head=True, model=model, device=CPU)
        for a, b in zip(got, ref[:2]):
            assert np.isfinite(a).all()
            np.testing.assert_array_equal(a, b)
        jreg = _j_regressor(model)
        metrics = {name: _mpjpe(model, jreg, p, seq.pose_gt, True)
                   for name, p in (("port", got[0]),
                                   ("jax", want["refined"][0]),
                                   ("start", pose))}
        # the metres (MPJPE, PVE, PA-MPJPE), with ``pytest -s``
        print("refined (port, JAX) and unrefined:", metrics)
        gap = np.abs(metrics["port"] - metrics["jax"]).max()
        moved = np.abs(metrics["port"] - metrics["start"]).max()
        assert gap < METRIC_GAP and moved > gap, (gap, moved)

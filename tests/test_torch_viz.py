r"""The port's display modules (``viz/``) and the ``articulate``-shaped facade
(``compat``) against the JAX package, on the CPU.

Mirrors the renderer, keypoint and debug-parameter cases of
``tests/test_viz_sensors.py``, ``tests/test_render_pyrender.py`` and
``tests/test_bullet_viewer.py`` (with the same stub ``pyrender``, ``trimesh``
and ``pybullet`` modules in ``sys.modules``) and
``tests/test_filters_compat.py::TestCompatNamespace``. Parity: the software
renderer and the keypoint drawing are numpy copies, so their images equal
the JAX package's bit for bit on identical inputs; the bullet viewer's
primitives, placed from the port's FK, lie within 1e-5 m of the JAX
viewer's (float32 FK in another summation order).
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robustcap_tpu.math as JM
from robustcap_tpu import viz as jviz
from robustcap_tpu.smpl import ParametricModel as JModel
from robustcap_tpu.smpl import synthetic_smpl_data
from robustcap_tpu_torch import compat as art
from robustcap_tpu_torch import viz
from robustcap_tpu_torch.smpl import ParametricModel
from robustcap_tpu_torch.viz.viewers import BulletMotionViewer
from test_bullet_viewer import FakePyBullet
from test_render_pyrender import (_FakeDirectionalLight,  # noqa: F401
                                  _FakeIntrinsicsCamera, _FakeMesh,
                                  _FakeOffscreenRenderer, fake_pyrender)

CPU = torch.device("cpu")
VIEWER_ATOL = 1e-5


@pytest.fixture(scope="module")
def data():
    return synthetic_smpl_data(num_verts=200)


@pytest.fixture(scope="module")
def model(data):
    return ParametricModel(data=data, device=CPU)


def _K(f, c):
    return np.array([[f, 0, c], [0, f, c], [0, 0, 1]])


class TestSoftwareRenderer:
    def test_triangle_visible_and_depth(self):
        r = viz.SoftwareRenderer((64, 64))
        K = _K(60.0, 32)
        verts = np.array([[-0.2, -0.2, 2.0], [0.2, -0.2, 2.0],
                          [0.0, 0.3, 2.0],
                          [-0.2, -0.2, 1.0], [0.2, -0.2, 1.0],
                          [0.0, 0.3, 1.0]], np.float32)
        faces = np.array([[0, 1, 2], [3, 4, 5]])
        img = r.render(None, verts, faces, K, mesh_color=(1, 0, 0, 1.0))
        assert (img[:, :, 0] > 0).any()
        img2 = r.render(None, verts[3:], faces[:1], K,
                        mesh_color=(0, 1, 0, 1.0))
        center2 = img2[32, 32].astype(int)
        assert center2[1] > center2[0]

    def test_overlay_keeps_background(self):
        r = viz.SoftwareRenderer((32, 32))
        bg = np.full((32, 32, 3), 7, np.uint8)
        verts = np.array([[0, 0, 1.0], [0.1, 0, 1.0], [0, 0.1, 1.0]])
        out = r.render(bg, verts, np.array([[0, 1, 2]]), _K(30.0, 16))
        assert (out[0, 0] == 7).all()

    def test_renderer_wrapper(self, model):
        r = viz.Renderer(resolution=(64, 64), model=model)
        verts = model.get_zero_pose_joint_and_vertex()[1]
        verts = verts + torch.tensor([0, 0, 3.0])
        img = r.render(None, verts, _K(60.0, 32))
        assert img.shape == (64, 64, 3)
        assert img.sum() > 0

    def test_images_equal_jax_bit_for_bit(self, data, model):
        r"""The same vertices through both packages' ``Renderer`` (software
        backend): over black and over a seeded background, at two
        resolutions and with a translucent colour."""
        jr = jviz.Renderer(resolution=(96, 80), model=JModel(data=data))
        tr = viz.Renderer(resolution=(96, 80), model=model)
        assert jr._backend == tr._backend == "software"
        rng = np.random.RandomState(5)
        verts = (data.v_template - data.joints[:1]
                 + np.array([0.1, 0.2, 2.5], np.float32))
        bg = rng.randint(0, 256, (80, 96, 3)).astype(np.uint8)
        K = _K(70.0, 45)
        for image, color in ((None, (0.7, 0.7, 0.6, 1.0)),
                             (bg, (0.2, 0.5, 0.9, 0.6))):
            want = jr.render(image, verts, K, mesh_color=color)
            got = tr.render(image, torch.from_numpy(verts), K,
                            mesh_color=color)
            assert want.any()
            np.testing.assert_array_equal(got, want)
        faces = data.faces[:150]
        np.testing.assert_array_equal(
            viz.SoftwareRenderer((40, 30)).render(bg[:30, :40], verts, faces,
                                                  _K(40.0, 18)),
            jviz.SoftwareRenderer((40, 30)).render(bg[:30, :40], verts,
                                                   faces, _K(40.0, 18)))


class TestKeypointViz:
    def test_draw_confidence_alpha(self):
        img = np.zeros((50, 50, 3), np.uint8)
        kp = np.array([[25, 25, 1.0], [10, 10, 0.0]])
        out = viz.draw_keypoints(img, kp)
        assert out[25, 25, 2] > 200
        assert out[10, 10].sum() == 0

    def test_z1_plane_view(self):
        kp = np.zeros((2, 5, 3), np.float32)
        kp[..., 2] = 1.0
        frames = viz.view_2d_keypoint_on_z_1(kp)
        assert len(frames) == 2 and frames[0].shape == (480, 360, 3)

    def test_images_equal_jax_bit_for_bit(self):
        r"""Seeded keypoints with confidences and bones: drawn on a
        seeded image, on the z=1 canvas and on the default white ones."""
        rng = np.random.RandomState(7)
        kp = np.concatenate([rng.uniform(0, 60, (3, 6, 2)),
                             rng.uniform(0, 1, (3, 6, 1))], -1)
        parent = [None, 0, 1, 1, 3, 0]
        img = rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
        np.testing.assert_array_equal(
            viz.draw_keypoints(img, kp[0], parent, thickness=3),
            jviz.draw_keypoints(img, kp[0], parent, thickness=3))
        z1 = kp.copy()
        z1[..., :2] = z1[..., :2] / 200 - 0.15
        for got, want in zip(
                viz.view_2d_keypoint_on_z_1(z1, parent, scale=0.8)
                + viz.view_2d_keypoint(kp, parent),
                jviz.view_2d_keypoint_on_z_1(z1, parent, scale=0.8)
                + jviz.view_2d_keypoint(kp, parent)):
            np.testing.assert_array_equal(got, want)


class TestDebugParams:
    def test_button_click_semantics(self):
        b = viz.Button("start")
        assert not b.is_click()
        b.click()
        assert b.is_click()
        assert not b.is_click()
        b.click()
        b.click()
        assert b.num_clicks() == 3

    def test_slider_value(self):
        s = viz.Slider("gain", range=(0, 10), current=2.5)
        assert s.get_float() == 2.5
        s.set(7.6)
        assert s.get_int() == 8


def _verts_K():
    rng = np.random.RandomState(0)
    verts = rng.randn(200, 3).astype(np.float32)
    verts[:, 2] += 4.0
    return verts, np.array([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]],
                           np.float32)


class TestPyrenderBackend:
    r"""``tests/test_render_pyrender.py`` on the port's ``Renderer``."""

    def test_backend_selected(self, fake_pyrender, model):
        assert viz.Renderer(resolution=(64, 64), model=model)._backend == \
            "pyrender"

    def test_scene_assembly_and_cleanup(self, fake_pyrender, model):
        r = viz.Renderer(resolution=(64, 64), model=model)
        verts, K = _verts_K()
        out = r.render(None, torch.from_numpy(verts), K,
                       mesh_color=(0.2, 0.5, 0.9, 1.0))
        assert out.shape == (64, 64, 3)
        ren = _FakeOffscreenRenderer.deleted
        assert len(ren) == 1, "OffscreenRenderer.delete() must be called"
        scene = ren[0]._scene
        meshes = [o for o, _ in scene.nodes if isinstance(o, _FakeMesh)]
        cams = [(o, p) for o, p in scene.nodes
                if isinstance(o, _FakeIntrinsicsCamera)]
        lights = [o for o, _ in scene.nodes
                  if isinstance(o, _FakeDirectionalLight)]
        assert len(meshes) == 1 and len(cams) == 1 and len(lights) == 3
        cam, pose = cams[0]
        assert cam.fx == 100.0 and cam.cx == 32
        assert pose[1, 1] == -1 and pose[2, 2] == -1 and pose[0, 0] == 1
        tmobj = meshes[0].trimesh
        np.testing.assert_array_equal(tmobj.vertices, verts)
        assert tmobj.visual.vertex_colors.shape == (len(verts), 4)
        assert tuple(tmobj.visual.vertex_colors[0][:3]) == (51, 127, 229)

    def test_depth_mask_composite(self, fake_pyrender, model):
        r = viz.Renderer(resolution=(64, 64), model=model)
        verts, K = _verts_K()
        bg = np.full((64, 64, 3), 7, np.uint8)
        out = r.render(bg, verts, K)
        assert tuple(out[32, 32]) == (10, 200, 30)
        assert tuple(out[0, 0]) == (7, 7, 7)
        assert tuple(bg[32, 32]) == (7, 7, 7)

    def test_no_background_returns_color(self, fake_pyrender, model):
        r = viz.Renderer(resolution=(64, 64), model=model)
        verts, K = _verts_K()
        out = r.render(None, verts, K)
        assert out.shape == (64, 64, 3)
        assert tuple(out[32, 32]) == (10, 200, 30)
        assert tuple(out[0, 0]) == (0, 0, 0)

    def test_software_fallback_without_pyrender(self, model, monkeypatch):
        r"""A bare stub (no ``OffscreenRenderer``) or no module at all
        selects the software rasterizer."""
        import types
        monkeypatch.setitem(sys.modules, "pyrender",
                            types.ModuleType("pyrender"))
        assert viz.Renderer(resolution=(32, 32), model=model)._backend == \
            "software"
        monkeypatch.setitem(sys.modules, "pyrender", None)
        assert viz.Renderer(resolution=(32, 32), model=model)._backend == \
            "software"


@pytest.fixture()
def fake_bullet(monkeypatch):
    fake = FakePyBullet()
    monkeypatch.setitem(sys.modules, "pybullet", fake)
    return fake


@pytest.fixture(scope="module")
def body400():
    data = synthetic_smpl_data(num_verts=400)
    return ParametricModel(data=data, device=CPU), JModel(data=data)


def _pose_tran(seed=0):
    rng = np.random.RandomState(seed)
    aa = (rng.randn(24, 3) * 0.2).astype(np.float32)
    pose = np.asarray(JM.axis_angle_to_rotation_matrix(
        jnp.asarray(aa))).reshape(24, 3, 3)
    return pose, np.asarray([0.1, 0.9, 0.2], np.float32)


class TestBulletMotionViewer:
    r"""``tests/test_bullet_viewer.py`` on the port's viewer."""

    def test_connect_builds_skeleton_primitives(self, fake_bullet, body400):
        v = BulletMotionViewer(n=2, body_model=body400[0]).connect()
        assert len(fake_bullet.bodies) == 2 * (24 + 23)
        geoms = [g for g, _ in fake_bullet.shapes]
        assert geoms.count(FakePyBullet.GEOM_SPHERE) == 48
        assert geoms.count(FakePyBullet.GEOM_CAPSULE) == 46
        v.disconnect()
        assert not fake_bullet.connected

    def test_update_moves_every_primitive(self, fake_bullet, body400):
        model = body400[0]
        v = BulletMotionViewer(n=1, body_model=model).connect()
        pose, tran = _pose_tran()
        v.update_all([pose], [tran])
        assert len(fake_bullet.positions) == 24 + 23
        joints = model.forward_kinematics(torch.from_numpy(pose[None]))[1]
        expect = joints[0].numpy() + tran
        for j in range(24):
            np.testing.assert_allclose(fake_bullet.positions[j][0],
                                       expect[j], atol=1e-5)
        for bid in range(24, 47):
            _, quat = fake_bullet.positions[bid]
            np.testing.assert_allclose(np.linalg.norm(quat), 1.0, atol=1e-6)

    def test_capsule_orientation_aligns_with_bone(self, fake_bullet,
                                                  body400):
        model = body400[0]
        v = BulletMotionViewer(n=1, body_model=model).connect()
        pose, tran = _pose_tran(3)
        v.update_all([torch.from_numpy(pose)], [torch.from_numpy(tran)])
        jpos = model.forward_kinematics(
            torch.from_numpy(pose[None]))[1][0].numpy() + tran
        j = 4
        pos, q = fake_bullet.positions[24 + (j - 1)]
        x, y, z, w = q
        R = art.math.quaternion_to_rotation_matrix(
            torch.tensor([[w, x, y, z]], dtype=torch.float32)).reshape(3, 3)
        d = jpos[j] - jpos[model.parent[j]]
        np.testing.assert_allclose(R.numpy() @ [0, 0, 1],
                                   d / np.linalg.norm(d), atol=1e-5)
        np.testing.assert_allclose(pos, (jpos[j] + jpos[model.parent[j]]) / 2,
                                   atol=1e-5)

    def test_multi_subject_offsets(self, fake_bullet, body400):
        v = BulletMotionViewer(n=2, body_model=body400[0],
                               overlap=False).connect()
        pose, tran = _pose_tran()
        v.update_all([pose, pose], [tran, tran])
        np.testing.assert_allclose(fake_bullet.positions[0][0]
                                   - fake_bullet.positions[47][0],
                                   [1.2, 0, 0], atol=1e-5)

    def test_wrong_subject_count_raises(self, fake_bullet, body400):
        v = BulletMotionViewer(n=2, body_model=body400[0]).connect()
        pose, tran = _pose_tran()
        with pytest.raises(AssertionError, match="subject count"):
            v.update_all([pose], [tran])

    def test_headless_records_history(self, body400, monkeypatch):
        monkeypatch.setitem(sys.modules, "pybullet", None)
        v = BulletMotionViewer(n=1, body_model=body400[0]).connect()
        pose, tran = _pose_tran()
        v.update_all([pose], [tran])
        assert len(v.history) == 1

    def test_primitives_match_jax(self, monkeypatch, body400):
        r"""Both packages' viewers, two subjects apart, seeded poses: every
        primitive's position and orientation, and the capsules' shapes."""
        from robustcap_tpu.viz.viewers import \
            BulletMotionViewer as JBulletMotionViewer
        poses, trans = zip(_pose_tran(1), _pose_tran(2))
        got = []
        for cls, m in ((BulletMotionViewer, body400[0]),
                       (JBulletMotionViewer, body400[1])):
            fake = FakePyBullet()
            monkeypatch.setitem(sys.modules, "pybullet", fake)
            cls(n=2, body_model=m, overlap=False).connect().update_all(
                list(poses), list(trans))
            got.append(fake)
        port, jax_side = got
        assert port.shapes == jax_side.shapes
        assert port.positions.keys() == jax_side.positions.keys()
        for k, (pos, quat) in jax_side.positions.items():
            np.testing.assert_allclose(port.positions[k][0], pos,
                                       atol=VIEWER_ATOL)
            np.testing.assert_allclose(port.positions[k][1], quat,
                                       atol=VIEWER_ATOL)


def test_rotation_viewer_conversions_match_jax():
    r"""``RotationViewer``'s quaternion conversions run on the port's math."""
    rng = np.random.RandomState(4)
    q = rng.randn(4).astype(np.float32)
    q /= np.linalg.norm(q)
    R = np.asarray(JM.quaternion_to_rotation_matrix(jnp.asarray(q[None])))[0]
    port, ref = viz.RotationViewer(), jviz.RotationViewer()
    np.testing.assert_allclose(port._to_R(q), ref._to_R(q), atol=1e-6)
    np.testing.assert_allclose(port._to_xyzw(R), ref._to_xyzw(R), atol=1e-6)
    port.update_all([q, R])
    assert len(port.history) == 1


class TestCompatNamespace:
    def test_reference_style_usage(self):
        R = art.math.axis_angle_to_rotation_matrix(torch.tensor([[0.1, 0, 0]]))
        assert R.shape == (1, 3, 3)
        ev = art.PositionErrorEvaluator()
        assert float(ev(torch.zeros(2, 3), torch.zeros(2, 3))) == 0.0
        assert art.SMPLJoint.LELBOW.value == 18
        body = art.ParametricModel(data=synthetic_smpl_data(num_verts=100),
                                   device="cpu")
        assert body.num_joints == 24

    def test_names_and_values_match_jax(self):
        r"""The facade holds the JAX facade's names, and its math, filters
        and evaluators give the JAX values on seeded inputs."""
        from robustcap_tpu import compat as jart
        assert art.__all__ == jart.__all__
        rng = np.random.RandomState(2)
        aa = rng.randn(5, 3).astype(np.float32)
        np.testing.assert_allclose(
            art.math.axis_angle_to_rotation_matrix(torch.from_numpy(aa)),
            np.asarray(jart.math.axis_angle_to_rotation_matrix(aa)),
            atol=1e-6)
        a, b = rng.randn(2, 4, 24, 3).astype(np.float32)
        np.testing.assert_allclose(
            float(art.PositionErrorEvaluator()(torch.from_numpy(a),
                                               torch.from_numpy(b))),
            float(jart.PositionErrorEvaluator()(a, b)), rtol=1e-6)
        x = rng.randn(6, 3).astype(np.float32)
        lp, jlp = art.LowPassFilter(0.3), jart.LowPassFilter(0.3)
        for row in x:
            got, want = lp(row), jlp(row)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)

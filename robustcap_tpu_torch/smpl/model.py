r"""SMPL parametric body model on torch tensors (port of
``robustcap_tpu/smpl/model.py``: data loading, the procedural fallback body,
tree FK/IK, linear blend skinning, and the ``save_*``/``view_*`` export and
display helpers, which skin on the model's device and render on the
host)."""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import math as M
from ..config import SMPL_PARENT
from ..device import resolve_device
from ..math.spatial import KinematicTree, get_tree

__all__ = ["SmplData", "ParametricModel", "default_body_model",
           "load_smpl_data", "synthetic_smpl_data"]

SMPL_NUM_JOINTS = 24
SMPL_NUM_VERTS = 6890


@dataclass(frozen=True)
class SmplData:
    r"""Raw model arrays (numpy, host-side)."""
    j_regressor: np.ndarray      # [J, V]
    skinning_weights: np.ndarray  # [V, J]
    posedirs: np.ndarray         # [V, 3, 9*(J-1)]
    shapedirs: np.ndarray        # [V, 3, 10]
    v_template: np.ndarray       # [V, 3]
    joints: np.ndarray           # [J, 3] zero-pose joint positions
    faces: np.ndarray            # [F, 3]
    parent: tuple                # [J]


def load_smpl_data(path: str) -> SmplData:
    r"""Load the official SMPL/MANO/SMPLH pickle."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    jreg = data["J_regressor"]
    if hasattr(jreg, "toarray"):
        jreg = jreg.toarray()
    parent = list(data["kintree_table"][0])
    parent[0] = None
    return SmplData(
        j_regressor=np.asarray(jreg, np.float32),
        skinning_weights=np.asarray(data["weights"], np.float32),
        posedirs=np.asarray(data["posedirs"], np.float32),
        shapedirs=np.asarray(np.array(data["shapedirs"]), np.float32),
        v_template=np.asarray(data["v_template"], np.float32),
        joints=np.asarray(data["J"], np.float32),
        faces=np.asarray(data["f"], np.int32),
        parent=tuple(int(p) if p is not None else None for p in parent),
    )


# Approximate zero-pose SMPL joint positions (meters, y-up) of the procedural
# fallback body: a hand-authored plausible skeleton.
_SYNTH_JOINTS = np.array([
    [0.000, 0.000, 0.000], [0.070, -0.085, 0.010], [-0.070, -0.085, 0.010],
    [0.000, 0.110, -0.010], [0.105, -0.470, 0.005], [-0.105, -0.470, 0.005],
    [0.000, 0.250, 0.000], [0.090, -0.850, -0.030], [-0.090, -0.850, -0.030],
    [0.000, 0.310, 0.010], [0.110, -0.900, 0.095], [-0.110, -0.900, 0.095],
    [0.000, 0.470, -0.020], [0.080, 0.400, -0.010], [-0.080, 0.400, -0.010],
    [0.000, 0.560, 0.020], [0.180, 0.420, -0.015], [-0.180, 0.420, -0.015],
    [0.440, 0.400, -0.030], [-0.440, 0.400, -0.030], [0.690, 0.400, -0.030],
    [-0.690, 0.400, -0.030], [0.780, 0.395, -0.025], [-0.780, 0.395, -0.025],
], dtype=np.float32)


def synthetic_smpl_data(num_verts: int = SMPL_NUM_VERTS,
                        seed: int = 0) -> SmplData:
    r"""Deterministic procedural body with SMPL topology (numpy, seeded):
    vertices scattered along the bones, skinning weights blending the two
    nearest joints, a J-regressor averaging each joint's 8 nearest vertices,
    and small random blendshapes. Byte-identical to the JAX package's."""
    rng = np.random.RandomState(seed)
    joints = _SYNTH_JOINTS.copy()
    parent = tuple(SMPL_PARENT)

    bone_child = np.arange(1, SMPL_NUM_JOINTS)
    per_bone = num_verts // len(bone_child) + 1
    pts = []
    for c in bone_child:
        p = parent[c]
        t = rng.uniform(0, 1, (per_bone, 1)).astype(np.float32)
        seg = joints[p][None] * (1 - t) + joints[c][None] * t
        seg = seg + rng.normal(0, 0.05, seg.shape).astype(np.float32)
        pts.append(seg)
    v_template = np.concatenate(pts)[:num_verts].astype(np.float32)

    d = np.linalg.norm(v_template[:, None] - joints[None], axis=-1)  # [V, J]
    w = np.exp(-d / 0.03)
    order = np.argsort(-w, axis=1)
    mask = np.zeros_like(w)
    np.put_along_axis(mask, order[:, :2], 1.0, axis=1)
    w = w * mask
    skinning = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)

    jr = np.zeros((SMPL_NUM_JOINTS, num_verts), dtype=np.float32)
    near = np.argsort(d, axis=0)[:8]  # [8, J]
    for j in range(SMPL_NUM_JOINTS):
        jr[j, near[:, j]] = 1.0 / 8.0

    shapedirs = (rng.normal(0, 0.01, (num_verts, 3, 10))).astype(np.float32)
    posedirs = (rng.normal(0, 0.001,
                           (num_verts, 3, 9 * (SMPL_NUM_JOINTS - 1)))
                ).astype(np.float32)
    n_faces = 2 * num_verts
    faces = rng.randint(0, num_verts, (n_faces, 3)).astype(np.int32)

    return SmplData(j_regressor=jr, skinning_weights=skinning,
                    posedirs=posedirs, shapedirs=shapedirs,
                    v_template=v_template, joints=joints, faces=faces,
                    parent=parent)


class ParametricModel:
    r"""SMPL/MANO/SMPLH model with its constants as tensors on ``device``.

    ``device`` defaults to ``"cuda"`` and raises on a host without a card;
    tests pass ``device="cpu"``.
    """

    def __init__(self, official_model_file: Optional[str] = None,
                 use_pose_blendshape: bool = False,
                 data: Optional[SmplData] = None,
                 dtype=torch.float32, device="cuda"):
        if data is None:
            if official_model_file and os.path.exists(official_model_file):
                data = load_smpl_data(official_model_file)
            else:
                data = synthetic_smpl_data()
        self.device = resolve_device(device)
        self.data = data
        self.use_pose_blendshape = use_pose_blendshape
        self.parent = list(data.parent)
        self.tree: KinematicTree = get_tree(data.parent)
        self.face = np.asarray(data.faces)

        def t(x):
            return torch.tensor(np.asarray(x), dtype=dtype, device=self.device)

        self._J_regressor = t(data.j_regressor)
        self._skinning_weights = t(data.skinning_weights)
        self._posedirs = t(data.posedirs)
        self._shapedirs = t(data.shapedirs)
        self._v_template = t(data.v_template)
        self._J = t(data.joints)

        j0 = self._J - self._J[:1]
        self._zero_pose_joint = j0                      # [J, 3]
        self._zero_pose_vertex = self._v_template - self._J[:1]
        self._bone_vector = self.joint_position_to_bone_vector(j0[None])[0]

    @property
    def num_joints(self) -> int:
        return self.tree.num_joints

    @property
    def num_verts(self) -> int:
        return int(self._v_template.shape[0])

    def get_zero_pose_joint_and_vertex(self, shape=None):
        r"""Zero-pose joints/vertices, root at origin."""
        if shape is None:
            return self._zero_pose_joint, self._zero_pose_vertex
        shape = shape.reshape(-1, 10)
        v = torch.einsum("bs,vcs->bvc", shape, self._shapedirs) \
            + self._v_template
        j = torch.einsum("jv,bvc->bjc", self._J_regressor, v)
        return j - j[:, :1], v - j[:, :1]

    def bone_vector_to_joint_position(self, bone_vec):
        return M.bone_vector_to_joint_position(bone_vec, self.tree)

    def joint_position_to_bone_vector(self, joint_pos):
        return M.joint_position_to_bone_vector(joint_pos, self.tree)

    def forward_kinematics_R(self, R_local):
        return M.forward_kinematics_R(R_local, self.tree)

    def inverse_kinematics_R(self, R_global):
        return M.inverse_kinematics_R(R_global, self.tree)

    def forward_kinematics_T(self, T_local):
        return M.forward_kinematics_T(T_local, self.tree)

    def inverse_kinematics_T(self, T_global):
        return M.inverse_kinematics_T(T_global, self.tree)

    def vertex_index(self, vertex_ids) -> torch.Tensor:
        r"""``vertex_ids`` as an index tensor clipped to the model's vertex
        range, the way the JAX package's gathers clamp an out-of-range index
        (the procedural test bodies have fewer vertices than the SMPL ids in
        ``MP_VERTEX_MASK``)."""
        ids = np.clip(np.asarray(vertex_ids, np.int64), 0, self.num_verts - 1)
        return torch.as_tensor(ids, device=self.device)

    def forward_kinematics(self, pose, shape=None, tran=None,
                           calc_mesh: bool = False, vertex_ids=None):
        r"""Global joint rotations/positions (+ LBS mesh) from local pose.

        ``pose`` reshapes to [B, J, 3, 3]; returns (R_glb [B, J, 3, 3],
        joints [B, J, 3][, verts]). ``vertex_ids`` restricts skinning to a
        vertex subset (clipped like :meth:`vertex_index`)."""
        pose = pose.reshape(pose.shape[0], -1, 3, 3)
        B = pose.shape[0]
        if shape is None:
            j0 = self._zero_pose_joint.expand(B, -1, -1)
            v0 = self._zero_pose_vertex.expand(B, -1, -1) if calc_mesh \
                else None
            bone = self._bone_vector.expand(B, -1, -1)
        else:
            j0, v0 = self.get_zero_pose_joint_and_vertex(shape)
            j0 = j0.expand(B, -1, -1)
            bone = self.joint_position_to_bone_vector(j0)

        R_glb, p_glb = M.forward_kinematics(pose, bone, self.tree)

        def add_tran(x):
            return x if tran is None else x + tran.reshape(-1, 1, 3)

        if not calc_mesh:
            return R_glb, add_tran(p_glb)

        weights = self._skinning_weights
        posedirs = self._posedirs
        if vertex_ids is not None:
            ids = self.vertex_index(vertex_ids)
            v0 = v0[:, ids]
            weights = weights[ids]
            posedirs = posedirs[ids]
        if self.use_pose_blendshape:
            eye = torch.eye(3, dtype=pose.dtype, device=pose.device)
            r = (pose[:, 1:] - eye).reshape(B, -1)
            v0 = v0 + torch.einsum("bp,vcp->bvc", r, posedirs)

        # per-vertex transform = sum_j w[v,j] (R_j, t_j) with
        # t_j = p_glb[j] - R_j @ j0[j]
        t_j = p_glb - (R_glb @ j0[..., None])[..., 0]
        R_v = torch.einsum("vj,bjrc->bvrc", weights, R_glb)
        t_v = torch.einsum("vj,bjc->bvc", weights, t_j)
        verts = (R_v @ v0[..., None])[..., 0] + t_v
        return R_glb, add_tran(p_glb), add_tran(verts)

    # -- export / io ---------------------------------------------------------

    def _on_device(self, x):
        return torch.as_tensor(x).to(self.device, self._J.dtype)

    def save_obj_mesh(self, vertex_position, file_name="a.obj"):
        r"""Export an obj mesh (model.py:42)."""
        v = _host(vertex_position)
        with open(file_name, "w") as fp:
            for p in v:
                fp.write("v %f %f %f\n" % (p[0], p[1], p[2]))
            for f in self.face + 1:
                fp.write("f %d %d %d\n" % (f[0], f[1], f[2]))

    @staticmethod
    def save_unity_motion(pose=None, tran=None, output_dir="saved_motions/"):
        r"""Write pose.txt/tran.txt consumed by the Unity viewer (model.py:56).
        A tensor pose is converted on its own device, an array in float32 on
        the CPU; one host copy each."""
        os.makedirs(output_dir, exist_ok=True)
        if pose is not None:
            if not isinstance(pose, torch.Tensor):
                pose = torch.as_tensor(np.asarray(pose, np.float32))
            pose = _host(M.rotation_matrix_to_axis_angle(pose)
                         ).reshape(pose.shape[0], -1)
            with open(os.path.join(output_dir, "pose.txt"), "w") as f:
                f.write("\n".join(
                    ",".join("%.4f" % x for x in row) for row in pose))
        if tran is not None:
            tran = _host(tran).reshape(-1, 3)
            with open(os.path.join(output_dir, "tran.txt"), "w") as f:
                f.write("\n".join(
                    ",".join("%.5f" % x for x in row) for row in tran))

    # -- visualization hooks (host-side, optional deps) ----------------------

    def view_motion(self, pose_list, tran_list=None, fps=60,
                    distance_between_subjects=0.8, output_path=None,
                    resolution=(720, 720)):
        r"""Render model motion to frames/video (model.py:309-331).

        The reference opens an interactive open3d window; this rebuild is
        offscreen — posed meshes are rasterized with the dependency-free
        software renderer (viz/render.py) and optionally written to a video
        (``output_path``), so it works headless and in CI. Each subject is
        skinned in one FK call on the model's device and copied to the host
        once. Returns the rendered frames ``[T, H, W, 3] uint8``. A
        single-frame input produces a 60-frame turntable orbit instead of
        the reference's "show one picture".
        """
        verts = []
        for i, pose in enumerate(pose_list):
            pose = self._on_device(pose).reshape(-1, self.num_joints, 3, 3)
            tran = None
            if tran_list is not None:
                t = self._on_device(tran_list[i]).reshape(-1, 3)
                tran = t - t[:1]
            verts.append(self.forward_kinematics(pose, tran=tran,
                                                 calc_mesh=True)[2].cpu())
        return self.view_mesh(verts, fps, distance_between_subjects,
                              output_path=output_path, resolution=resolution)

    def view_mesh(self, vertex_list, fps=60, distance_between_subjects=0.8,
                  output_path=None, resolution=(720, 720),
                  turntable_frames=60):
        r"""Render meshes (one per subject, offset along x as the reference
        does — model.py:278-305) through an auto-framed virtual camera.

        vertex_list: length-num_subject list, each reshaping to
        [num_frame, num_vertex, 3]. Returns frames [T, H, W, 3] uint8 and
        writes ``output_path`` (mp4 via imageio when available) if given.
        """
        from ..viz.render import SoftwareRenderer

        V = self.num_verts
        v_list, f_list = [], []
        f = self.face.copy()
        for i, v in enumerate(vertex_list):
            v = np.array(_host(v, np.float32)).reshape(-1, V, 3)
            v[:, :, 0] += distance_between_subjects * i
            v_list.append(v)
            f_list.append(f.copy())
            f = f + V
        verts = np.concatenate(v_list, axis=1)          # [T, S*V, 3]
        faces = np.concatenate(f_list)

        W, H = resolution
        K = np.array([[1.2 * W, 0, W / 2], [0, 1.2 * W, H / 2], [0, 0, 1]],
                     np.float32)
        center = verts.reshape(-1, 3).mean(axis=0)
        radius = float(np.linalg.norm(
            verts.reshape(-1, 3) - center, axis=1).max())
        dist = max(3.0 * radius, 1e-3)

        single = len(verts) == 1
        n_frames = turntable_frames if single else len(verts)
        renderer = SoftwareRenderer((W, H))
        frames = []
        for t in range(n_frames):
            yaw = (2 * np.pi * t / n_frames) if single else 0.0
            frame_verts = verts[0] if single else verts[t]
            cam = self._look_at_transform(center, dist, yaw)
            vc = (frame_verts - cam["eye"]) @ cam["R"].T
            frames.append(renderer.render(None, vc, faces, K))
        frames = np.stack(frames)
        if output_path is not None:
            from ..eval.visualize import _write_video
            _write_video(list(frames), output_path, fps=fps)
        return frames

    @staticmethod
    def _look_at_transform(center, dist, yaw):
        r"""Camera on a horizontal orbit looking at ``center``: returns the
        world->camera rotation (rows = camera x/y/z axes, +z forward, y
        down — the pinhole convention of viz/render.py)."""
        eye = center + dist * np.array(
            [np.sin(yaw), 0.0, np.cos(yaw)], np.float32)
        fwd = center - eye
        fwd = fwd / max(np.linalg.norm(fwd), 1e-9)
        up = np.array([0.0, 1.0, 0.0], np.float32)       # SMPL y-up
        right = np.cross(fwd, up)
        right /= max(np.linalg.norm(right), 1e-9)
        down = np.cross(fwd, right)
        return {"eye": eye.astype(np.float32),
                "R": np.stack([right, down, fwd]).astype(np.float32)}

    def view_mesh_overlay(self, verts, images, K, Tcw=None, fps=60,
                          output_path=None):
        r"""Composite posed meshes over camera images (model.py:335-390).

        verts reshapes to [num_frame, num_vertex, 3] (world frame; a tensor
        is copied to the host once); images broadcast to [num_frame, H, W,
        3] uint8; K [3, 3]; Tcw [4, 4] world->camera extrinsic. Offscreen
        rebuild of the reference's open3d overlay window: each frame is
        rasterized with the software renderer and composited by depth mask.
        Returns frames; writes ``output_path`` if given.
        """
        from ..viz.render import SoftwareRenderer

        verts = _host(verts, np.float32).reshape(-1, self.num_verts, 3)
        images = np.asarray(images, np.uint8)
        if images.ndim == 3:
            images = np.broadcast_to(images, (len(verts),) + images.shape)
        H, W = images.shape[1:3]
        Tcw = np.eye(4, dtype=np.float32) if Tcw is None else \
            _host(Tcw, np.float32)
        renderer = SoftwareRenderer((W, H))
        frames = []
        for t in range(len(verts)):
            vc = verts[t] @ Tcw[:3, :3].T + Tcw[:3, 3]
            frames.append(renderer.render(images[t], vc, self.face,
                                          _host(K, np.float32)))
        frames = np.stack(frames)
        if output_path is not None:
            from ..eval.visualize import _write_video
            _write_video(list(frames), output_path, fps=fps)
        return frames


def _host(x, dtype=None):
    r"""``x`` (a tensor on any device, or array-like) as a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


# the process-wide body model, one per device
_DEFAULT_MODELS = {}


def default_body_model(device="cuda") -> ParametricModel:
    r"""The process-wide body model on ``device``: the official asset at
    ``config.paths.smpl_file`` if present, else the procedural fallback;
    built once per device."""
    from ..config import paths
    dev = resolve_device(device)
    if dev not in _DEFAULT_MODELS:
        _DEFAULT_MODELS[dev] = ParametricModel(paths.smpl_file, device=dev)
    return _DEFAULT_MODELS[dev]

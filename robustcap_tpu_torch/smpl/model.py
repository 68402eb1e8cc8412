r"""SMPL parametric body model on torch tensors (port of
``robustcap_tpu/smpl/model.py``: data loading, the procedural fallback body,
tree FK/IK and linear blend skinning; the ``view_*``/``save_*`` helpers are
not ported yet)."""

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

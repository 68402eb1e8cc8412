r"""Tree kinematics (port of ``robustcap_tpu/math/spatial.py``).

The tree is preprocessed once on the host into a level decomposition (FK is
a short chain of batched gather + 3x3 products) and an ancestor matrix
(``A[i, j] = 1`` iff j is i or an ancestor of i), so the bone-vector prefix
sum is one matrix product. IK needs no walk: ``R_local[i] =
R_glb[parent[i]]^T R_glb[i]``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "KinematicTree", "get_tree", "mat3_mul", "transformation_matrix",
    "decode_transformation_matrix", "inverse_transformation_matrix",
    "bone_vector_to_joint_position", "joint_position_to_bone_vector",
    "forward_kinematics_R", "inverse_kinematics_R", "forward_kinematics_T",
    "inverse_kinematics_T", "forward_kinematics",
]


def _canonical_parent(parent: Sequence) -> Tuple[int, ...]:
    r"""Parent list with root encoded as -1 (accepts None / -1 at index 0)."""
    return tuple(-1 if (p is None or i == 0) else int(p)
                 for i, p in enumerate(parent))


@dataclass(frozen=True)
class KinematicTree:
    r"""Preprocessed kinematic tree (host-side numpy constants).
    ``parent[i]`` must be < i for i > 0."""
    parent: Tuple[int, ...]
    levels: Tuple[Tuple[int, ...], ...] = field(init=False)
    ancestor_matrix: np.ndarray = field(init=False)  # [J, J] float32
    parent_clamped: np.ndarray = field(init=False)   # [J] int64, root -> 0

    def __post_init__(self):
        parent = _canonical_parent(self.parent)
        object.__setattr__(self, "parent", parent)
        n = len(parent)
        depth = [0] * n
        for i in range(1, n):
            if parent[i] >= i:
                raise ValueError("parent[i] must be smaller than i")
            depth[i] = depth[parent[i]] + 1
        levels = tuple(tuple(i for i in range(n) if depth[i] == d)
                       for d in range(1, max(depth) + 1))
        object.__setattr__(self, "levels", levels)
        anc = np.zeros((n, n), dtype=np.float32)
        for i in range(n):
            j = i
            while j >= 0:
                anc[i, j] = 1.0
                j = parent[j]
        object.__setattr__(self, "ancestor_matrix", anc)
        object.__setattr__(self, "parent_clamped",
                           np.array([max(p, 0) for p in parent], np.int64))

    @property
    def num_joints(self) -> int:
        return len(self.parent)


_TREE_CACHE: dict = {}


def get_tree(parent) -> KinematicTree:
    if isinstance(parent, KinematicTree):
        return parent
    key = _canonical_parent(parent)
    if key not in _TREE_CACHE:
        _TREE_CACHE[key] = KinematicTree(key)
    return _TREE_CACHE[key]


def mat3_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    r"""Batched 3x3 product as a broadcast multiply-sum."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def transformation_matrix(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    r"""Homogeneous transforms [*, 4, 4] from R [*, 3, 3] and p [*, 3]."""
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype,
                         device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat((torch.cat((R, p[..., None]), -1), bottom), -2)


def decode_transformation_matrix(T: torch.Tensor):
    r"""T [*, 4, 4] -> (R [*, 3, 3], p [*, 3])."""
    return T[..., :3, :3], T[..., :3, 3]


def inverse_transformation_matrix(T: torch.Tensor) -> torch.Tensor:
    r"""Closed-form inverse of rigid transforms [*, 4, 4]."""
    R, p = decode_transformation_matrix(T)
    invR = R.transpose(-1, -2)
    return transformation_matrix(invR, -(invR @ p[..., None])[..., 0])


def bone_vector_to_joint_position(bone_vec: torch.Tensor, parent):
    r"""Tree prefix sum as one product with the ancestor matrix."""
    tree = get_tree(parent)
    bone_vec = bone_vec.reshape(bone_vec.shape[0], -1, 3)
    anc = torch.as_tensor(tree.ancestor_matrix, dtype=bone_vec.dtype,
                          device=bone_vec.device)
    return torch.einsum("ij,bjk->bik", anc, bone_vec)


def joint_position_to_bone_vector(joint_pos: torch.Tensor, parent):
    r"""Inverse of the tree prefix sum: subtract the parent position."""
    tree = get_tree(parent)
    joint_pos = joint_pos.reshape(joint_pos.shape[0], -1, 3)
    parent_pos = joint_pos[:, torch.as_tensor(tree.parent_clamped)].clone()
    parent_pos[:, 0] = 0.0
    return joint_pos - parent_pos


def forward_kinematics_R(R_local: torch.Tensor, parent) -> torch.Tensor:
    r"""Global rotations from local rotations, level by level."""
    tree = get_tree(parent)
    R_local = R_local.reshape(R_local.shape[0], -1, 3, 3)
    R_glb = R_local.clone()
    for level in tree.levels:
        idx = torch.as_tensor(level)
        pidx = torch.as_tensor(tree.parent_clamped[list(level)])
        R_glb[:, idx] = mat3_mul(R_glb[:, pidx], R_local[:, idx])
    return R_glb


def inverse_kinematics_R(R_global: torch.Tensor, parent) -> torch.Tensor:
    r"""Local rotations from global rotations: one gather + batched product,
    root kept global."""
    tree = get_tree(parent)
    R_global = R_global.reshape(R_global.shape[0], -1, 3, 3)
    parent_R = R_global[:, torch.as_tensor(tree.parent_clamped)]
    local = mat3_mul(parent_R.transpose(-1, -2), R_global)
    return torch.cat([R_global[:, :1], local[:, 1:]], dim=1)


def forward_kinematics_T(T_local: torch.Tensor, parent) -> torch.Tensor:
    r"""Global transforms [B, J, 4, 4] from local ones, level by level."""
    tree = get_tree(parent)
    T_local = T_local.reshape(T_local.shape[0], -1, 4, 4)
    T_glb = T_local.clone()
    for level in tree.levels:
        idx = list(level)
        pidx = tree.parent_clamped[idx].tolist()
        T_glb[:, idx] = T_glb[:, pidx] @ T_local[:, idx]
    return T_glb


def inverse_kinematics_T(T_global: torch.Tensor, parent) -> torch.Tensor:
    r"""Local transforms from global ones, root kept global."""
    tree = get_tree(parent)
    T_global = T_global.reshape(T_global.shape[0], -1, 4, 4)
    parent_T = T_global[:, tree.parent_clamped.tolist()]
    local = inverse_transformation_matrix(parent_T) @ T_global
    return torch.cat([T_global[:, :1], local[:, 1:]], dim=1)


def forward_kinematics(R_local: torch.Tensor, p_local: torch.Tensor, parent):
    r"""(R_glb, p_glb) = FK(R_local, p_local), level by level on (R, p)."""
    tree = get_tree(parent)
    R_local = R_local.reshape(R_local.shape[0], -1, 3, 3)
    p_local = p_local.reshape(p_local.shape[0], -1, 3)
    R_glb = R_local.clone()
    p_glb = p_local.clone()
    for level in tree.levels:
        idx = torch.as_tensor(level)
        pidx = torch.as_tensor(tree.parent_clamped[list(level)])
        R_glb[:, idx] = mat3_mul(R_glb[:, pidx], R_local[:, idx])
        p_glb[:, idx] = (p_glb[:, pidx]
                         + (R_glb[:, pidx] * p_local[:, idx, None, :]).sum(-1))
    return R_glb, p_glb

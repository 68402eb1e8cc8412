r"""Rotation conversions (port of ``robustcap_tpu/math/angular.py``).
Quaternions are wxyz; euler angles take an uppercase sequence for intrinsic
and a lowercase one for extrinsic rotations; r6d is the first two columns
of the rotation matrix, column-major."""

from __future__ import annotations

import enum
import math

import torch

from .general import normalize_tensor, vector_cross_matrix

__all__ = [
    "RotationRepresentation", "to_rotation_matrix", "radian_to_degree",
    "degree_to_radian", "angle_between", "svd_rotate",
    "axis_angle_to_rotation_matrix", "rotation_matrix_to_axis_angle",
    "r6d_to_rotation_matrix", "rotation_matrix_to_r6d",
    "quaternion_to_axis_angle", "axis_angle_to_quaternion",
    "quaternion_to_rotation_matrix", "rotation_matrix_to_quaternion",
    "euler_angle_to_rotation_matrix",
]

_EPS = 1e-8


class RotationRepresentation(enum.Enum):
    AXIS_ANGLE = 0
    ROTATION_MATRIX = 1
    QUATERNION = 2
    R6D = 3
    EULER_ANGLE = 4


def to_rotation_matrix(r: torch.Tensor, rep: RotationRepresentation):
    r"""Any representation as rotation matrices [N, 3, 3]."""
    if rep == RotationRepresentation.AXIS_ANGLE:
        return axis_angle_to_rotation_matrix(r)
    if rep == RotationRepresentation.QUATERNION:
        return quaternion_to_rotation_matrix(r)
    if rep == RotationRepresentation.R6D:
        return r6d_to_rotation_matrix(r)
    if rep == RotationRepresentation.EULER_ANGLE:
        return euler_angle_to_rotation_matrix(r)
    if rep == RotationRepresentation.ROTATION_MATRIX:
        return r.reshape(-1, 3, 3)
    raise ValueError("unknown rotation representation")


def radian_to_degree(q):
    return q * (180.0 / math.pi)


def degree_to_radian(q):
    return q * (math.pi / 180.0)


def axis_angle_to_rotation_matrix(a: torch.Tensor) -> torch.Tensor:
    r"""Rodrigues formula, safe at zero angle -> [N, 3, 3]."""
    a = a.reshape(-1, 3)
    angle = torch.sqrt((a * a).sum(-1) + 1e-16)
    axis = a / angle.clamp_min(_EPS)[:, None]
    eye = torch.eye(3, dtype=a.dtype, device=a.device).expand(a.shape[0], 3, 3)
    c = torch.cos(angle)[:, None, None]
    s = torch.sin(angle)[:, None, None]
    outer = axis[:, :, None] * axis[:, None, :]
    return c * eye + (1 - c) * outer + s * vector_cross_matrix(axis)


def rotation_matrix_to_quaternion(r: torch.Tensor) -> torch.Tensor:
    r"""Rotation matrices -> wxyz quaternions with w >= 0 (Shepperd's
    method: the candidate with the largest pivot is taken)."""
    r = r.reshape(-1, 3, 3)
    m00, m01, m02 = r[:, 0, 0], r[:, 0, 1], r[:, 0, 2]
    m10, m11, m12 = r[:, 1, 0], r[:, 1, 1], r[:, 1, 2]
    m20, m21, m22 = r[:, 2, 0], r[:, 2, 1], r[:, 2, 2]
    tr = m00 + m11 + m22
    cands = torch.stack([
        torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20],
                    -1),
        torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21],
                    -1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22],
                    -1),
    ], 1)                                                    # [N, 4, 4]
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    best = pivots.argmax(-1)
    q = torch.take_along_dim(cands, best[:, None, None].expand(-1, 1, 4),
                             1)[:, 0]
    q = normalize_tensor(q, eps=_EPS)
    return q * torch.where(q[:, :1] < 0, -1.0, 1.0)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    r"""(Unnormalized) wxyz quaternions -> axis-angle, by atan2."""
    q = normalize_tensor(q.reshape(-1, 4), eps=_EPS)
    xyz_norm = torch.linalg.vector_norm(q[:, 1:], dim=-1)
    angle = 2.0 * torch.atan2(xyz_norm, q[:, 0])
    axis = q[:, 1:] / xyz_norm.clamp_min(_EPS)[:, None]
    return axis * angle[:, None]


def rotation_matrix_to_axis_angle(r: torch.Tensor) -> torch.Tensor:
    r"""Rotation matrices -> axis-angle with the angle in [0, pi]."""
    return quaternion_to_axis_angle(rotation_matrix_to_quaternion(r))


def axis_angle_to_quaternion(a: torch.Tensor) -> torch.Tensor:
    a = a.reshape(-1, 3)
    angle = torch.linalg.vector_norm(a, dim=-1)
    axis = a / angle.clamp_min(_EPS)[:, None]
    half = 0.5 * angle
    return torch.cat((torch.cos(half)[:, None],
                      torch.sin(half)[:, None] * axis), 1)


def quaternion_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    q = normalize_tensor(q.reshape(-1, 4), eps=_EPS)
    a, b, c, d = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r = torch.stack(
        (1 - 2 * c * c - 2 * d * d, 2 * b * c - 2 * a * d,
         2 * a * c + 2 * b * d,
         2 * b * c + 2 * a * d, 1 - 2 * b * b - 2 * d * d,
         2 * c * d - 2 * a * b,
         2 * b * d - 2 * a * c, 2 * a * b + 2 * c * d,
         1 - 2 * b * b - 2 * c * c), 1)
    return r.reshape(-1, 3, 3)


def r6d_to_rotation_matrix(r6d: torch.Tensor) -> torch.Tensor:
    r"""6D representation -> rotation matrix [N, 3, 3] by Gram-Schmidt with
    the guarded epsilon."""
    r6d = r6d.reshape(-1, 6)
    col0 = normalize_tensor(r6d[:, 0:3], eps=_EPS)
    proj = (col0 * r6d[:, 3:6]).sum(1, keepdim=True)
    col1 = normalize_tensor(r6d[:, 3:6] - proj * col0, eps=_EPS)
    col2 = torch.linalg.cross(col0, col1, dim=-1)
    return torch.stack((col0, col1, col2), dim=-1)


def rotation_matrix_to_r6d(r: torch.Tensor) -> torch.Tensor:
    r"""Rotation matrix -> 6D (first two columns, column-major)."""
    r = r.reshape(-1, 3, 3)
    return r[:, :, :2].transpose(1, 2).reshape(-1, 6)


def _single_axis_rotation(axis: int, angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == 0:
        rows = (one, zero, zero, zero, c, -s, zero, s, c)
    elif axis == 1:
        rows = (c, zero, s, zero, one, zero, -s, zero, c)
    else:
        rows = (c, -s, zero, s, c, zero, zero, zero, one)
    return torch.stack(rows, -1).reshape(angle.shape + (3, 3))


def euler_angle_to_rotation_matrix(q: torch.Tensor, seq: str = "XYZ"):
    r"""Euler angles -> rotation matrices (scipy's convention)."""
    q = q.reshape(-1, 3)
    mats = [_single_axis_rotation("xyz".index(s.lower()), q[:, i])
            for i, s in enumerate(seq)]
    if seq.isupper():
        return mats[0] @ mats[1] @ mats[2]
    if seq.islower():
        return mats[2] @ mats[1] @ mats[0]
    raise ValueError("seq must be all-intrinsic (upper) or all-extrinsic "
                     "(lower)")


def angle_between(rot1, rot2,
                  rep: RotationRepresentation =
                  RotationRepresentation.ROTATION_MATRIX):
    r"""Angle in radians between two batches of rotations."""
    r1 = to_rotation_matrix(rot1, rep)
    r2 = to_rotation_matrix(rot2, rep)
    offsets = r1.transpose(-1, -2) @ r2
    return torch.linalg.vector_norm(rotation_matrix_to_axis_angle(offsets),
                                    dim=-1)


def svd_rotate(source_points: torch.Tensor, target_points: torch.Tensor,
               calc_R: bool = True, calc_t: bool = False,
               calc_s: bool = False):
    r"""Batched Procrustes, min ||s R src + t - tgt||^2 over [B, m, n]
    point sets. Returns (R [B, n, n], t [B, n], s [B], transformed source
    points [B, m, n])."""
    if calc_t:
        src_mean = source_points.mean(1, keepdim=True)
        tgt_mean = target_points.mean(1, keepdim=True)
    else:
        src_mean = torch.zeros_like(source_points[:, :1])
        tgt_mean = torch.zeros_like(target_points[:, :1])
    if calc_s:
        src_rms = ((source_points - src_mean) ** 2).sum((1, 2))
        tgt_rms = ((target_points - tgt_mean) ** 2).sum((1, 2))
        scale = torch.sqrt(tgt_rms / src_rms)
    else:
        scale = torch.ones_like(source_points[:, 0, 0])
    n = source_points.shape[2]
    if calc_R:
        m = (source_points - src_mean).transpose(1, 2) \
            @ (target_points - tgt_mean)
        u, _, vt = torch.linalg.svd(m)
        v = vt.transpose(1, 2)
        det = torch.linalg.det(v @ u.transpose(1, 2))
        # the reference flips v's last column where det < -0.9
        flip = torch.where(det < -0.9, -1.0, 1.0)
        v = torch.cat([v[:, :, :-1], v[:, :, -1:] * flip[:, None, None]], 2)
        rotation = v @ u.transpose(1, 2)
    else:
        rotation = torch.eye(n, dtype=source_points.dtype,
                             device=source_points.device).expand(
            source_points.shape[0], n, n)
    translation = (-scale[:, None, None]
                   * (rotation @ src_mean.transpose(1, 2))
                   + tgt_mean.transpose(1, 2))
    transformed = (scale[:, None, None]
                   * (source_points @ rotation.transpose(1, 2))
                   + translation.transpose(1, 2))
    return rotation, translation[..., 0], scale, transformed

r"""Rotation conversions (port of what the SigMP path uses from
``robustcap_tpu/math/angular.py``). r6d is the first two columns of the
rotation matrix, column-major."""

from __future__ import annotations

import torch

from .general import normalize_tensor, vector_cross_matrix

__all__ = ["axis_angle_to_rotation_matrix", "r6d_to_rotation_matrix"]

_EPS = 1e-8


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


def r6d_to_rotation_matrix(r6d: torch.Tensor) -> torch.Tensor:
    r"""6D representation -> rotation matrix [N, 3, 3] by Gram-Schmidt with
    the guarded epsilon."""
    r6d = r6d.reshape(-1, 6)
    col0 = normalize_tensor(r6d[:, 0:3], eps=_EPS)
    proj = (col0 * r6d[:, 3:6]).sum(1, keepdim=True)
    col1 = normalize_tensor(r6d[:, 3:6] - proj * col0, eps=_EPS)
    col2 = torch.linalg.cross(col0, col1, dim=-1)
    return torch.stack((col0, col1, col2), dim=-1)


r"""Virtual-sensor synthesis on torch tensors (port of part of
``robustcap_tpu/preprocess/synthesis.py``): IMU acceleration from vertex
trajectories, IMU orientation from global joint rotations, the
pseudo-MediaPipe landmarks of a posed body, and pinhole projection."""

from __future__ import annotations

import torch

from ..config import IMU_JOINT_MASK, IMU_VERTEX_MASK
from ..ops.geometry_tail import sync_mp3d

__all__ = ["syn_acc", "synthesize_imu", "sync_3d_mp", "project_points",
           "normalize_keypoints"]


def syn_acc(v: torch.Tensor, smooth_n: int = 2,
            fps: float = 60.0) -> torch.Tensor:
    r"""Acceleration of positions ``[T, ..., 3]`` sampled at ``fps``: the
    central second difference times fps^2, and on frames ``[n, T - n)`` the
    wider stencil ``(v[i - n] + v[i + n] - 2 v[i]) fps^2 / n^2`` with
    ``n = smooth_n`` (when ``smooth_n // 2`` is not 0); the first and last
    frames are zero."""
    T = v.shape[0]
    scale = fps * fps
    acc = torch.zeros_like(v)
    acc[1:-1] = (v[:-2] + v[2:] - 2 * v[1:-1]) * scale
    if smooth_n // 2 != 0:
        n = smooth_n
        acc[n:-n] = (v[:T - 2 * n] + v[2 * n:] - 2 * v[n:T - n]) \
            * (scale / n ** 2)
    return acc


def synthesize_imu(glb_rot: torch.Tensor, verts: torch.Tensor,
                   smooth_n: int = 2, fps: float = 60.0):
    r"""Six virtual IMUs of a posed sequence: ``glb_rot [T, 24, 3, 3]``,
    ``verts [T, V, 3]`` -> (orientation ``[T, 6, 3, 3]`` at the IMU joints,
    acceleration ``[T, 6, 3]`` of the IMU vertices)."""
    ori = glb_rot[:, list(IMU_JOINT_MASK)]
    acc = syn_acc(verts[:, list(IMU_VERTEX_MASK)], smooth_n, fps)
    return ori, acc


def sync_3d_mp(verts_mp: torch.Tensor, joints: torch.Tensor) -> torch.Tensor:
    r"""Pseudo-MediaPipe 3-D landmarks ``[T, 33, 3]`` from the already
    gathered mask vertices ``[T, 33, 3]`` and the joints ``[T, 24, 3]``."""
    return sync_mp3d(verts_mp, joints)


def project_points(points_c: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    r"""Pinhole projection of camera-frame points ``[..., 3]`` to pixels
    ``[..., 2]``."""
    uvw = points_c @ K.T
    return uvw[..., :2] / uvw[..., 2:]


def normalize_keypoints(uv: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    r"""Pixel keypoints ``[..., 2]`` to z=1-plane coordinates by K^-1."""
    ones = torch.ones(uv.shape[:-1] + (1,), dtype=uv.dtype, device=uv.device)
    return (torch.cat([uv, ones], -1) @ torch.linalg.inv(K).T)[..., :2]

r"""Virtual-sensor synthesis on torch tensors (port of
``robustcap_tpu/preprocess/synthesis.py``): IMU acceleration from vertex
trajectories, IMU orientation from global joint rotations, the
pseudo-MediaPipe landmarks of a posed body, pinhole projection, and the
AMASS random camera and keypoint confidence. The random draws come from an
explicit ``torch.Generator`` on its device; JAX's keyed draws cannot be
matched, so they agree with the JAX package in law, not value."""

from __future__ import annotations

import torch

from ..config import IMU_JOINT_MASK, IMU_VERTEX_MASK
from ..math.angular import generate_random_rotation_matrix_constrained
from ..ops.geometry_tail import sync_mp3d

__all__ = ["syn_acc", "synthesize_imu", "sync_3d_mp", "project_points",
           "normalize_keypoints", "random_camera", "synthesize_confidence"]


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


def random_camera(generator: torch.Generator, yaw=(-180.0, 180.0),
                  pitch=(-30.0, 30.0), roll=(-5.0, 5.0)) -> torch.Tensor:
    r"""A random world-to-camera rotation ``Rcw [3, 3]`` on the
    generator's device for a synthetic view of an AMASS motion:
    ``(Rwc0 @ Rc0c)^T``, ``Rc0c`` with yaw, pitch and roll drawn uniformly
    from the ranges (degrees) and the canonical flip ``Rwc0 = diag(-1, -1,
    1)``."""
    Rwc0 = torch.tensor([[-1.0, 0, 0], [0, -1.0, 0], [0, 0, 1.0]],
                        device=generator.device)
    Rc0c = generate_random_rotation_matrix_constrained(
        generator, n=1, y=yaw, p=pitch, r=roll)[0]
    return (Rwc0 @ Rc0c).T


def synthesize_confidence(generator: torch.Generator, j2dc: torch.Tensor,
                          conf_pool: torch.Tensor,
                          noise_scale: float = 0.003) -> torch.Tensor:
    r"""Keypoint confidences drawn from an empirical pool and jitter that
    shrinks as they grow: ``j2dc [T, 33, C]`` (x, y first) ->
    ``[T, 33, 3]`` (x + e, y + e, p) with ``e ~ N(0, (noise_scale (1 -
    p))^2)``. ``conf_pool`` holds a confidence per frame ``[N]`` or per
    frame and landmark ``[N, 33(, 1)]``; T entries are drawn without
    replacement when N >= T, else with it."""
    T, dev = j2dc.shape[0], j2dc.device
    N = conf_pool.shape[0]
    idx = (torch.randperm(N, generator=generator, device=dev)[:T] if N >= T
           else torch.randint(N, (T,), generator=generator, device=dev))
    p = conf_pool[idx].reshape(T, -1)[..., None].expand(T, 33, 1)
    noise = torch.randn(j2dc[..., :2].shape, generator=generator,
                        device=dev) * (noise_scale * (1 - p))
    return torch.cat([j2dc[..., :2] + noise, p], -1)

r"""Smoothed bounding-box tracks from 2-D keypoints (reference-exact).

The port's own copy of ``robustcap_tpu/preprocess/smooth_bbox.py`` (numpy and
scipy only, so the port needs nothing of the JAX package).

Rebuild of ``scripts/smooth_bbox.py`` (the human_dynamics algorithm the
reference vendors): per-frame keypoint bboxes parameterised as
``[cx, cy, scale]`` with ``scale = 150 / person_height`` (diagonal of the
visible-keypoint box, smooth_bbox.py:33-54), middle gaps linearly
interpolated (get_all_bbox_params:57-95), then median + Gaussian filtering
(smooth_bbox_params:98-111). Returns ``(params, start, end)`` where frames
before ``start`` are zero rows and ``end`` is one past the last valid frame
— consumed by the detector crop math of ``run_3dpw_detector.py:33-53``
(see :func:`pw3d_crop_windows`).

Numerics match the reference operation-for-operation (zero-padded
``scipy.signal.medfilt``, reflect-mode ``gaussian_filter1d``) so bbox
tracks and detector crop caches are byte-comparable between the two
implementations (verified in ``tests/test_smooth_bbox.py`` against the
actual reference script).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy import signal
from scipy.ndimage import gaussian_filter1d

__all__ = ["kp_to_bbox_param", "get_all_bbox_params", "smooth_bbox_params",
           "get_smooth_bbox_params", "pw3d_crop_windows", "get_bbox"]


def kp_to_bbox_param(kp: Optional[np.ndarray], vis_thresh: float
                     ) -> Optional[np.ndarray]:
    r"""One frame's keypoints [K, 3] -> ``[cx, cy, scale]`` or None
    (smooth_bbox.py:33-54).

    ``scale = 150 / person_height`` where the height is the *diagonal* of
    the visible-keypoint box; frames with no keypoint above ``vis_thresh``
    or a degenerate (<0.5 px) box yield None.
    """
    if kp is None:
        return None
    kp = np.asarray(kp)
    vis = kp[:, 2] > vis_thresh
    if not np.any(vis):
        return None
    min_pt = np.min(kp[vis, :2], axis=0)
    max_pt = np.max(kp[vis, :2], axis=0)
    person_height = np.linalg.norm(max_pt - min_pt)
    if person_height < 0.5:
        return None
    center = (min_pt + max_pt) / 2.0
    scale = 150.0 / person_height
    return np.append(center, scale)


def get_all_bbox_params(kps: Sequence[Optional[np.ndarray]],
                        vis_thresh: float = 2
                        ) -> Tuple[np.ndarray, int, int]:
    r"""Per-frame params with middle gaps linearly interpolated
    (smooth_bbox.py:57-95) -> ``(params [N, 3], start incl, end excl)``.

    ``params`` covers frames ``start..end``; leading/trailing invalid frames
    are trimmed (the caller pads the head back with zeros). Interpolation
    endpoints are the surrounding valid frames, endpoints excluded from the
    inserted rows — matching the reference's ``np.linspace(...)[1:-1]``.
    """
    num_to_interpolate = 0
    start_index = -1
    bbox_params = np.empty(shape=(0, 3), dtype=np.float32)
    if len(kps) == 0:
        raise ValueError("empty keypoint sequence")

    for i, kp in enumerate(kps):
        bbox_param = kp_to_bbox_param(kp, vis_thresh=vis_thresh)
        if bbox_param is None:
            num_to_interpolate += 1
            continue

        if start_index == -1:
            start_index = i
            num_to_interpolate = 0

        if num_to_interpolate > 0:
            previous = bbox_params[-1]
            interpolated = np.array(
                [np.linspace(prev, curr, num_to_interpolate + 2)
                 for prev, curr in zip(previous, bbox_param)])
            bbox_params = np.vstack((bbox_params, interpolated.T[1:-1]))
            num_to_interpolate = 0
        bbox_params = np.vstack((bbox_params, bbox_param))

    return bbox_params, start_index, i - num_to_interpolate + 1


def smooth_bbox_params(bbox_params: np.ndarray, kernel_size: int = 11,
                       sigma: float = 8) -> np.ndarray:
    r"""Median then Gaussian filtering per parameter track
    (smooth_bbox.py:98-111). ``signal.medfilt`` zero-pads the borders and
    ``gaussian_filter1d`` reflects — kept exactly (the borders differ from
    the "obvious" nearest-padding rebuild)."""
    smoothed = np.array([signal.medfilt(param, kernel_size)
                         for param in bbox_params.T]).T
    return np.array([gaussian_filter1d(traj, sigma)
                     for traj in smoothed.T]).T


def get_smooth_bbox_params(kps: Sequence[Optional[np.ndarray]],
                           vis_thresh: float = 2, kernel_size: int = 11,
                           sigma: float = 3
                           ) -> Tuple[np.ndarray, int, int]:
    r"""Keypoint sequence -> smoothed ``[cx, cy, scale]`` track
    (smooth_bbox.py:9-30).

    Returns ``(params, start, end)``: rows before ``start`` are zeros (the
    reference vstacks a zero prefix); rows are only meaningful on
    ``start <= t < end``. Raises ValueError when no frame is valid (the
    reference crashes on that input).
    """
    bbox_params, start, end = get_all_bbox_params(kps, vis_thresh)
    if start < 0:
        raise ValueError("no frame passed the visibility threshold")
    smoothed = smooth_bbox_params(bbox_params, kernel_size, sigma)
    smoothed = np.vstack((np.zeros((start, 3)), smoothed))
    return smoothed, start, end


def pw3d_crop_windows(bbox_params: np.ndarray, img_h: int, img_w: int,
                      num_people: int = 1
                      ) -> List[Tuple[int, int, int, int]]:
    r"""Per-frame crop windows from a smoothed bbox track
    (run_3dpw_detector.py:33-53): ``(sx, sy, ex, ey)`` pixel bounds.

    Single-person landscape videos use a square ``1.1 * 150/scale`` window;
    multi-person or portrait videos use ``100/scale`` widened to ``1.8x``
    tall — both then clamped to the image. Int truncation order matches the
    reference (centers to int32 first, ``w // 2`` on int32 extents).
    """
    c_x = bbox_params[:, 0].astype(np.int32)
    c_y = bbox_params[:, 1].astype(np.int32)
    scale = bbox_params[:, 2]
    with np.errstate(divide="ignore"):
        if num_people != 1 or img_h > img_w:
            w = h = 100.0 / scale
            h = h * 1.8
        else:
            w = h = (150.0 / scale) * 1.1
    # zero rows before `start` divide to inf; the caller skips those frames
    # (the reference gates on mean keypoint confidence) — clamp so the
    # int cast below is defined
    w = np.where(np.isfinite(w), w, 0).astype(np.int32)
    h = np.where(np.isfinite(h), h, 0).astype(np.int32)
    out = []
    for i in range(len(bbox_params)):
        sx = int(max(0, c_x[i] - w[i] // 2))
        sy = int(max(0, c_y[i] - h[i] // 2))
        ex = int(min(c_x[i] + w[i] // 2, img_w))
        ey = int(min(c_y[i] + h[i] // 2, img_h))
        out.append((sx, sy, ex, ey))
    return out


def get_bbox(uv: np.ndarray, height: int, width: int, border: int = 130,
             w_h: float = 0.75):
    r"""4:3 crop window around keypoints, clamped to the image
    (utils.py:99-126): returns (u_start, v_start, u_end, v_end)."""
    u_max, v_max = int(uv[:, 0].max()), int(uv[:, 1].max())
    u_min, v_min = int(uv[:, 0].min()), int(uv[:, 1].min())
    u_c, v_c = (u_max + u_min) // 2, (v_max + v_min) // 2
    if (u_max - u_min) * w_h > (v_max - v_min):
        h_fix = min((u_max - u_min) + border, height)
        w_fix = int(h_fix * w_h)
    else:
        w_fix = min((v_max - v_min) + border, width)
        h_fix = int(w_fix / w_h)
    if v_c - w_fix // 2 < 0:
        v_s, v_e = 0, w_fix
    elif v_c + w_fix // 2 >= width:
        v_s, v_e = width - w_fix, width
    else:
        v_s, v_e = v_c - w_fix // 2, v_c + w_fix // 2
    if u_c - h_fix // 2 < 0:
        u_s, u_e = 0, h_fix
    elif u_c + h_fix // 2 >= height:
        u_s, u_e = height - h_fix, height
    else:
        u_s, u_e = u_c - h_fix // 2, u_c + h_fix // 2
    return int(u_s), int(v_s), int(u_e), int(v_e)

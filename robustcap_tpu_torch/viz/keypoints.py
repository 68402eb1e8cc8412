r"""2-D keypoint visualization (dependency-free numpy drawing; a copy of
``robustcap_tpu/viz/keypoints.py``).

Rebuild of the reference's keypoint renderers (utils.py:9-96,
articulate/utils/opencv/visualization.py:14): draws keypoints (alpha =
confidence) and bones onto images. Uses simple numpy disk/line rasterization
so it runs headless; cv2 is not required.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["draw_keypoints", "view_2d_keypoint", "view_2d_keypoint_on_z_1"]


def _disk(img, cx, cy, r, color, alpha):
    H, W = img.shape[:2]
    x0, x1 = max(int(cx - r), 0), min(int(cx + r) + 1, W)
    y0, y1 = max(int(cy - r), 0), min(int(cy + r) + 1, H)
    if x0 >= x1 or y0 >= y1:
        return
    xs, ys = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1))
    mask = (xs - cx) ** 2 + (ys - cy) ** 2 <= r * r
    region = img[y0:y1, x0:x1].astype(np.float32)
    region[mask] = (1 - alpha) * region[mask] + alpha * np.asarray(color)
    img[y0:y1, x0:x1] = region.astype(img.dtype)


def _line(img, p0, p1, color, alpha, thickness=2):
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1))
    for t in np.linspace(0, 1, n + 1):
        _disk(img, p0[0] + t * (p1[0] - p0[0]), p0[1] + t * (p1[1] - p0[1]),
              thickness / 2, color, alpha)


def draw_keypoints(image: np.ndarray, kp: np.ndarray,
                   parent: Optional[Sequence] = None,
                   thickness: Optional[int] = None) -> np.ndarray:
    r"""Draw one frame's keypoints [J, 2|3] (3rd column = confidence used as
    alpha, utils.py:49-59) onto a uint8 image."""
    out = image.copy()
    if thickness is None:
        thickness = max(round(image.shape[1] / 160), 1)
    has_conf = kp.shape[-1] == 3
    if parent is not None:
        for c, p in enumerate(parent):
            if p is None:
                continue
            conf = min(float(kp[c, 2]), float(kp[p, 2])) if has_conf else 1.0
            _line(out, kp[p, :2], kp[c, :2], (255, 0, 0), conf, thickness)
    for j in range(kp.shape[0]):
        conf = float(kp[j, 2]) if has_conf else 1.0
        _disk(out, kp[j, 0], kp[j, 1], thickness * 2, (0, 0, 255), conf)
    return out


def view_2d_keypoint(keypoints: np.ndarray, parent=None, images=None,
                     thickness=None) -> List[np.ndarray]:
    r"""Render a keypoint sequence [T, J, 2|3] over images (or white
    canvases, utils.py:9-70). Returns the frames; callers write videos or
    display (no GUI dependency here)."""
    keypoints = np.asarray(keypoints)
    T = keypoints.shape[0]
    if images is None:
        images = [np.full((480, 360, 3), 255, np.uint8) for _ in range(T)]
    return [draw_keypoints(images[t], keypoints[t], parent, thickness)
            for t in range(T)]


def view_2d_keypoint_on_z_1(keypoints, parent=None, thickness=None,
                            scale: float = 1.0) -> List[np.ndarray]:
    r"""Render z=1-plane keypoints by mapping them to a 360x480 canvas
    (utils.py:73-96)."""
    f = 500 * scale
    kp = np.asarray(keypoints).copy()
    kp[..., 0] = kp[..., 0] * f + 360 / 2
    kp[..., 1] = kp[..., 1] * f + 480 / 2
    return view_2d_keypoint(kp, parent=parent, thickness=thickness)

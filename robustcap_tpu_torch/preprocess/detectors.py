r"""Offline 2-D keypoint detector runners.

The port's own copy of ``robustcap_tpu/preprocess/detectors.py`` (numpy and
scipy only, so the port needs nothing of the JAX package).

Rebuild of the reference's ``scripts/run_{aist,tc,3dpw,3dpwocc}_detector.py``:
run MediaPipe Pose over dataset videos (optionally bbox-cropped with the
smoothed keypoint track, optionally with synthetic occluders pasted at fixed
per-video positions) and cache [T, 33, 3] (x_frac, y_frac, visibility)
arrays. MediaPipe/cv2 are external host dependencies — the framework
consumes the cached outputs (SURVEY.md §2); frame sources are injectable so
the cropping/occlusion logic is testable without them.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np

from .occlusion import occlude_with_objects
from .smooth_bbox import get_smooth_bbox_params, pw3d_crop_windows

__all__ = ["MediaPipeDetector", "detect_sequence", "detect_sequence_cropped",
           "detect_sequence_occluded"]


class MediaPipeDetector:
    r"""Thin MediaPipe Pose wrapper producing the 33-landmark array
    (run_aist_detector.py detection_mediapipe)."""

    def __init__(self, min_detection_confidence: float = 0.5,
                 model_complexity: int = 1, static_image_mode: bool = False):
        try:
            import mediapipe as mp
        except ImportError as e:
            raise ImportError(
                "MediaPipe is an external detector dependency; precomputed "
                "keypoint caches are consumed without it") from e
        self._pose = mp.solutions.pose.Pose(
            static_image_mode=static_image_mode,
            min_detection_confidence=min_detection_confidence,
            model_complexity=model_complexity)

    def __call__(self, frame_rgb: np.ndarray) -> Optional[np.ndarray]:
        res = self._pose.process(frame_rgb)
        if res.pose_landmarks is None:
            return None
        return np.asarray([[p.x, p.y, p.visibility]
                           for p in res.pose_landmarks.landmark], np.float32)


def _placeholder() -> np.ndarray:
    r"""Detector-failure placeholder: zeros with confidence 0
    (preprocess.py:89-91)."""
    return np.zeros((33, 3), np.float32)


def detect_sequence(frames: Iterable[np.ndarray],
                    detector: Callable) -> np.ndarray:
    r"""Run the detector over frames -> [T, 33, 3] with placeholders on
    failures."""
    out = []
    for frame in frames:
        kp = detector(frame)
        out.append(kp if kp is not None else _placeholder())
    return np.stack(out) if out else np.zeros((0, 33, 3), np.float32)


def detect_sequence_cropped(frames: List[np.ndarray], gt_kp: np.ndarray,
                            detector: Callable, num_people: int = 1,
                            vis_thresh: float = 0.3, sigma: float = 8.0,
                            conf_gate: float = 0.3) -> np.ndarray:
    r"""Detect on smoothed-bbox crops and map landmarks back to full-frame
    fractions (run_3dpw_detector.py:33-53).

    The crop pipeline is reference-exact: ``get_smooth_bbox_params`` with
    the 3DPW settings (vis_thresh=0.3, sigma=8), the single-vs-multi-person
    window sizing, int-truncated clamped windows, and the
    mean-confidence<0.3 frame gate that emits a placeholder without running
    the detector. Output stays in this framework's fraction convention
    (the reference stores absolute pixels; the affine map is the same).
    """
    H, W = frames[0].shape[:2]
    track, start, end = get_smooth_bbox_params(gt_kp, vis_thresh=vis_thresh,
                                               sigma=sigma)
    windows = pw3d_crop_windows(track, H, W, num_people=num_people)
    out = []
    for t, frame in enumerate(frames):
        kp_t = np.asarray(gt_kp[t])
        if kp_t[:, 2].mean() < conf_gate or t >= len(windows):
            out.append(_placeholder())
            continue
        sx, sy, ex, ey = windows[t]
        crop = frame[sy:ey, sx:ex]
        if crop.size == 0:
            out.append(_placeholder())
            continue
        kp = detector(crop)
        if kp is None:
            out.append(_placeholder())
            continue
        kp = kp.copy()
        kp[:, 0] = (kp[:, 0] * (ex - sx) + sx) / W
        kp[:, 1] = (kp[:, 1] * (ey - sy) + sy) / H
        out.append(kp)
    return np.stack(out)


def detect_sequence_occluded(frames: Iterable[np.ndarray], occluders,
                             detector: Callable, seed: int = 0,
                             n_range: Tuple[int, int] = (1, 8),
                             frame_size: Tuple[int, int] = (1920, 1080)
                             ) -> np.ndarray:
    r"""Paste occluders at *fixed random centers per video* then detect
    (run_aist_detector.py:81-141) — temporally coherent synthetic occlusion
    for training the confidence gate."""
    rng = np.random.RandomState(seed)
    w, h = frame_size
    n = rng.randint(n_range[0], n_range[1] + 1)
    centers = [(rng.uniform(0, w), rng.uniform(0, h)) for _ in range(n)]
    out = []
    for frame in frames:
        occluded = occlude_with_objects(frame, occluders, rng,
                                        centers=centers)
        kp = detector(occluded)
        out.append(kp if kp is not None else _placeholder())
    return np.stack(out)

r"""AIST++ raw-corpus conversion (port of ``robustcap_tpu/preprocess/aist.py``;
the motion's FK runs on the body model's device).

Rebuild of the reference's ``preprocess_aist`` / ``preprocess_aist_pre``
(preprocess.py:36-249, 500-561). Raw AIST++ ships per-sequence SMPL motions
(pickles with ``smpl_poses/smpl_scaling/smpl_trans``), 9-camera parameter
JSONs, and per-camera cached detector keypoints; this module converts parsed
raw records into the unified work schema:

* ``aist_camera_params``  — camera JSON -> (K, Tcw) pairs,
* ``repair_frame_count``  — detector caches can be 1-2 frames short/long;
                            pad by repeating the last frame / trim
                            (preprocess.py:66-130),
* ``aist_sequence_to_work`` — scale/normalize the motion, FK, synthesize
                            virtual IMUs, attach per-camera keypoints,
* ``compute_not_aligned`` — flag camera-sequences whose GT reprojection
                            disagrees with the detector by > 25 px
                            (preprocess.py:546-560), producing
                            ``not_aligned.txt`` entries.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..math.angular import axis_angle_to_rotation_matrix
from .datasets import amass_sequence_to_work

__all__ = ["aist_camera_params", "repair_frame_count",
           "aist_sequence_to_work", "compute_not_aligned"]


def aist_camera_params(cam_json: Sequence[Dict]) -> List[Tuple[np.ndarray,
                                                               np.ndarray]]:
    r"""AIST camera-setting JSON records -> [(K [3,3], Tcw [4,4])].

    Each record holds ``matrix`` (intrinsics), axis-angle ``rotation`` and
    ``translation`` (in centimeters, converted to meters)."""
    out = []
    for cam in cam_json:
        K = np.asarray(cam["matrix"], np.float32).reshape(3, 3)
        rvec = np.asarray(cam["rotation"], np.float32).reshape(3)
        R = axis_angle_to_rotation_matrix(torch.from_numpy(rvec[None]))[0] \
            .numpy()
        t = np.asarray(cam["translation"], np.float32).reshape(3) / 100.0
        Tcw = np.eye(4, dtype=np.float32)
        Tcw[:3, :3] = R
        Tcw[:3, 3] = t
        out.append((K, Tcw))
    return out


def repair_frame_count(kp: Optional[np.ndarray], target_len: int,
                       max_gap: int = 3) -> Optional[np.ndarray]:
    r"""Align a cached detector track's length to the motion's frame count
    (preprocess.py:66-130): pad short tracks by repeating the final frame,
    trim long ones; give up (None) beyond ``max_gap`` frames."""
    if kp is None:
        return None
    kp = np.asarray(kp, np.float32)
    gap = target_len - len(kp)
    if gap == 0:
        return kp
    if abs(gap) > max_gap:
        return None
    if gap > 0:
        return np.concatenate([kp, np.repeat(kp[-1:], gap, axis=0)])
    return kp[:target_len]


def aist_sequence_to_work(model, motion: Dict, cameras: Sequence[Dict],
                          detector_kp: Sequence[Optional[np.ndarray]],
                          name: str = "seq", src_fps: float = 60.0,
                          device="cuda") -> Dict:
    r"""One raw AIST motion + cameras + cached detector outputs -> work entry
    (preprocess.py:52-248).

    ``motion``: {'smpl_poses' [T, 72], 'smpl_trans' [T, 3],
    'smpl_scaling' scalar} — translations are divided by the scaling like
    the reference. ``detector_kp[j]``: per-camera [T', 33, 3] fraction-of-
    frame keypoints or None. ``model`` lies on ``device``.
    """
    pose = np.asarray(motion["smpl_poses"], np.float32).reshape(-1, 72)
    scaling = float(np.asarray(motion.get("smpl_scaling", 1.0)).reshape(-1)[0])
    tran = np.asarray(motion["smpl_trans"],
                      np.float32).reshape(-1, 3) / scaling
    entry = amass_sequence_to_work(model, pose, tran, src_fps=src_fps,
                                   device=device)
    T = len(entry["pose"])

    cam_Ks, cam_Ts = [], []
    for K, Tcw in aist_camera_params(cameras):
        cam_Ks.append(K)
        cam_Ts.append(Tcw)
    kps = [repair_frame_count(kp, T) for kp in detector_kp]
    entry.update({"name": name, "cam_K": cam_Ks, "cam_T": cam_Ts,
                  "joint2d_mp": kps})
    return entry


def compute_not_aligned(entry: Dict, img_w: int = 1920, img_h: int = 1080,
                        threshold_px: float = 25.0) -> List[str]:
    r"""Names of camera views whose detector keypoints disagree with the GT
    reprojection by more than ``threshold_px`` on average
    (preprocess.py:546-560). Compares the pelvis-adjacent landmarks (hips,
    row 23/24) which are stable across detectors."""
    names = []
    joints = np.asarray(entry["joint3d"])       # [T, 24, 3] world
    for j, (K, Tcw) in enumerate(zip(entry["cam_K"], entry["cam_T"])):
        kp = entry["joint2d_mp"][j]
        if kp is None:
            names.append(_cam_name(entry["name"], j))
            continue
        hips_w = joints[:, 1:3]                 # [T, 2, 3]
        hips_c = hips_w @ Tcw[:3, :3].T + Tcw[:3, 3]
        uv = (hips_c @ K.T)
        uv = uv[..., :2] / uv[..., 2:]
        det = np.stack([kp[:, 23:25, 0] * img_w, kp[:, 23:25, 1] * img_h], -1)
        conf = kp[:, 23:25, 2]
        err = np.linalg.norm(uv - det, axis=-1)
        valid = conf > 0.5
        if valid.sum() == 0 or err[valid].mean() > threshold_px:
            names.append(_cam_name(entry["name"], j))
    return names


def _cam_name(name: str, j: int) -> str:
    return str(name).replace("cAll", "c0%d" % (j + 1))

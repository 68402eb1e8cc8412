r"""Raw-corpus preprocessing: AMASS, TotalCapture and 3DPW motions into the
work-dict entries that training and evaluation read (port of
``robustcap_tpu/preprocess/datasets.py``).

The parsing is host-side numpy; the body math (axis-angle to rotation
matrices, FK, skinning of the needed vertices, the IMU accelerations) runs
in torch on the body model's device, which must be ``device``:

* ``resample_sequence``       frame-rate conversion by nearest index,
* ``interpolate_keypoints``   linear upsampling of detector keypoints,
* ``amass_sequence_to_work``  FK, six virtual IMUs and 33 pseudo-landmarks,
* ``totalcapture_align_imus`` the sensor reorder and global-frame flip of
                              real TotalCapture IMUs,
* ``check_real_vs_synthetic_imu`` real IMU orientations against FK.

Entries are numpy arrays, the JAX package's layout, so a corpus written by
either package loads in both.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import IMU_JOINT_MASK, IMU_VERTEX_MASK, MP_VERTEX_MASK
from ..device import resolve_device
from ..math.angular import (angle_between, axis_angle_to_rotation_matrix,
                            radian_to_degree)
from . import synthesis

__all__ = ["resample_sequence", "interpolate_keypoints",
           "amass_sequence_to_work", "totalcapture_align_imus",
           "check_real_vs_synthetic_imu", "preprocess_amass",
           "preprocess_3dpw_sequence"]

TC_SENSOR_ORDER = [2, 3, 0, 1, 4, 5]
_TC_FLIP = np.diag([-1.0, 1.0, -1.0]).astype(np.float32)
# the vertices a preprocessing FK skins: the landmarks' and the IMUs'
NEED_VERTS = np.union1d(np.asarray(MP_VERTEX_MASK),
                        np.asarray(IMU_VERTEX_MASK))
_VI = np.searchsorted(NEED_VERTS, np.asarray(IMU_VERTEX_MASK))
_MP = np.searchsorted(NEED_VERTS, np.asarray(MP_VERTEX_MASK))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def rotations(aa: np.ndarray, dev) -> torch.Tensor:
    r"""Axis-angle ``[..., 3]`` (host) as rotation matrices ``[N, 3, 3]``
    on ``dev``."""
    return axis_angle_to_rotation_matrix(torch.as_tensor(
        np.asarray(aa, np.float32).reshape(-1, 3), device=dev))


def posed_body(model, pose_R: torch.Tensor, tran: np.ndarray,
               shape: Optional[np.ndarray] = None) -> Dict[str, torch.Tensor]:
    r"""FK and skinning of :data:`NEED_VERTS` of a posed sequence on the
    model's device: ``glb [T, 24, 3, 3]``, ``joints [T, 24, 3]``, the IMU
    orientations ``ori [T, 6, 3, 3]`` and accelerations ``acc [T, 6, 3]``
    (60 fps) and the pseudo-MediaPipe landmarks ``mp3d [T, 33, 3]``."""
    dev = model.device
    glb, joints, verts = model.forward_kinematics(
        pose_R, tran=torch.as_tensor(np.asarray(tran, np.float32),
                                     device=dev),
        shape=None if shape is None else torch.as_tensor(
            np.asarray(shape, np.float32), device=dev),
        calc_mesh=True, vertex_ids=NEED_VERTS)
    return {"glb": glb, "joints": joints,
            "ori": glb[:, list(IMU_JOINT_MASK)],
            "acc": synthesis.syn_acc(verts[:, list(_VI)]),
            "mp3d": synthesis.sync_3d_mp(verts[:, list(_MP)], joints)}


def resample_sequence(x: np.ndarray, src_fps: float, dst_fps: float = 60.0
                      ) -> np.ndarray:
    r"""Nearest-index frame-rate conversion along axis 0."""
    T = len(x)
    n_out = int(round(T * dst_fps / src_fps))
    idx = np.clip(np.round(np.arange(n_out) * src_fps / dst_fps), 0,
                  T - 1).astype(int)
    return x[idx]


def interpolate_keypoints(kp: np.ndarray, factor: int = 2) -> np.ndarray:
    r"""Linear temporal upsampling of detector keypoints ``[T, J, C]`` to
    ``[factor (T - 1) + 1, J, C]`` (30 to 60 Hz for 3DPW)."""
    T = len(kp)
    out_len = factor * (T - 1) + 1
    t_src = np.arange(T, dtype=np.float64)
    t_dst = np.arange(out_len, dtype=np.float64) / factor
    flat = kp.reshape(T, -1)
    cols = [np.interp(t_dst, t_src, flat[:, c]) for c in range(flat.shape[1])]
    return np.stack(cols, 1).reshape(out_len, *kp.shape[1:]).astype(np.float32)


def amass_sequence_to_work(model, pose_aa: np.ndarray, tran: np.ndarray,
                           src_fps: float = 60.0,
                           align_length_multiple: Optional[int] = None,
                           device="cuda") -> Dict[str, np.ndarray]:
    r"""One AMASS motion as a work entry: resampled to 60 fps, posed with
    ``model`` (on ``device``), with its six virtual IMUs and 33
    pseudo-landmarks. Returns numpy arrays ``pose [T, 72]``, ``tran``,
    ``joint3d``, ``imu_ori``, ``imu_acc`` and ``sync_3d_mp``; raises
    ``ValueError`` below 10 frames."""
    dev = resolve_device(device)
    pose_aa = np.asarray(pose_aa, np.float32).reshape(len(pose_aa), -1)[:, :72]
    tran = np.asarray(tran, np.float32)
    if src_fps != 60.0:
        pose_aa = resample_sequence(pose_aa, src_fps)
        tran = resample_sequence(tran, src_fps)
    if align_length_multiple:
        T = (len(pose_aa) // align_length_multiple) * align_length_multiple
        pose_aa, tran = pose_aa[:T], tran[:T]
    T = len(pose_aa)
    if T < 10:
        raise ValueError("sequence too short after resampling")
    body = posed_body(model, rotations(pose_aa, dev).reshape(T, 24, 3, 3),
                      tran)
    ori, acc = _np(body["ori"]), _np(body["acc"])
    assert not np.isnan(ori).any() and not np.isnan(acc).any()
    assert ori.shape == (T, 6, 3, 3) and acc.shape == (T, 6, 3)
    return {"pose": pose_aa, "tran": tran, "joint3d": _np(body["joints"]),
            "imu_ori": ori, "imu_acc": acc,
            "sync_3d_mp": _np(body["mp3d"])}


def preprocess_amass(model, raw_dir: str, out_dir: str,
                     splits: Dict[str, Sequence[str]], kinds=("train", "val"),
                     save=True, device="cuda") -> Dict[str, Dict[str, List]]:
    r"""Every ``<raw_dir>/<corpus>/<subject>/*_poses.npz`` of each split's
    corpora (``splits[kind]``, e.g. ``config.AmassSplits``) as work
    entries, written to ``<out_dir>/<kind>.pt``. Sequences too short or
    without poses are skipped."""
    device = resolve_device(device)
    out = {}
    for kind in kinds:
        agg = {k: [] for k in ["pose", "tran", "joint3d", "imu_ori",
                               "imu_acc", "sync_3d_mp"]}
        for corpus in splits[kind]:
            for npz in sorted(glob.glob(
                    os.path.join(raw_dir, corpus, "*/*_poses.npz"))):
                data = np.load(npz)
                try:
                    entry = amass_sequence_to_work(
                        model, data["poses"][:, :72], data["trans"],
                        float(data.get("mocap_framerate", 60.0)),
                        device=device)
                except (ValueError, KeyError):
                    continue
                for k in agg:
                    agg[k].append(entry[k])
        out[kind] = agg
        if save:
            os.makedirs(out_dir, exist_ok=True)
            torch.save(agg, os.path.join(out_dir, f"{kind}.pt"))
    return out


def totalcapture_align_imus(raw_ori: np.ndarray, raw_acc: np.ndarray
                            ) -> tuple:
    r"""Real TotalCapture IMUs in the model's order (left/right forearm,
    left/right lower leg, head, pelvis) and frame (the corpus' inertial
    frame turned 180 degrees about the vertical)."""
    ori = np.asarray(raw_ori, np.float32)[:, TC_SENSOR_ORDER]
    acc = np.asarray(raw_acc, np.float32)[:, TC_SENSOR_ORDER]
    ori = np.einsum("ij,tnjk->tnik", _TC_FLIP, ori)
    acc = np.einsum("ij,tnj->tni", _TC_FLIP, acc)
    return ori, acc


def check_real_vs_synthetic_imu(model, pose_aa, tran, real_ori, real_acc,
                                max_angle_deg: float = 17.0,
                                device="cuda") -> Dict:
    r"""Real sensor orientations against FK-synthesized ones: the mean
    angle in degrees, whether it is under ``max_angle_deg``, and the
    synthetic entry (the caller decides what to do)."""
    work = amass_sequence_to_work(model, pose_aa, tran, device=device)
    dev = resolve_device(device)
    ang = _np(radian_to_degree(angle_between(
        torch.as_tensor(np.asarray(real_ori, np.float32), device=dev),
        torch.as_tensor(work["imu_ori"], device=dev))))
    return {"mean_angle_deg": float(ang.mean()),
            "ok": bool(ang.mean() < max_angle_deg),
            "synthetic": work}


def preprocess_3dpw_sequence(model, pose_cam_aa: np.ndarray,
                             tran_cam: np.ndarray, kp2d_30hz: np.ndarray,
                             cam_K: np.ndarray, cam_T_30hz: np.ndarray,
                             device="cuda") -> Dict[str, np.ndarray]:
    r"""One 3DPW sequence as a camera-frame work entry: 30 to 60 Hz
    (keypoints interpolated; pose, translation and camera poses nearest),
    with camera-frame IMUs synthesized from the posed body."""
    pose60 = resample_sequence(np.asarray(pose_cam_aa, np.float32), 30.0)
    tran60 = resample_sequence(np.asarray(tran_cam, np.float32), 30.0)
    kp60 = interpolate_keypoints(np.asarray(kp2d_30hz, np.float32))
    L = min(len(pose60), len(kp60))
    pose60, tran60, kp60 = pose60[:L], tran60[:L], kp60[:L]
    camT60 = resample_sequence(np.asarray(cam_T_30hz, np.float32), 30.0)[:L]
    work = amass_sequence_to_work(model, pose60, tran60, device=device)
    return {"posec": _np(rotations(pose60, resolve_device(device)))
            .reshape(L, 24, 3, 3),
            "tranc": tran60, "joint2d_mp": kp60, "cam_K": np.asarray(cam_K),
            "cam_T": camT60, "imu_oric": work["imu_ori"],
            "imu_accc": work["imu_acc"]}

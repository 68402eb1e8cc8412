r"""Per-RNN feature/label engineering from preprocessed dataset dicts (port
of ``robustcap_tpu/train/features.py``).

Each ``rnn*_features`` function maps a corpus dict to ``(data_list,
label_list)`` of [T, D] float32 sequences, trimmed by one frame at both
ends, on the host, once per dataset. Conventions:

* root frame = pelvis orientation transposed (Rrw = R_root^T),
* rnn7 rotates only the first five IMUs into the root frame; the pelvis IMU
  stays in the world frame, as in the reference,
* AMASS rnn4/rnn6 data stays in the world frame (``amass_mp_base``); the
  random camera, translation and keypoint confidence are drawn per chunk on
  the device by ``amass_camera_augment``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import VEL_SCALE
from ..eval.datasets import _aa_to_R, _to_np
from ..math.angular import rotation_matrix_to_r6d
from ..math.general import lerp
from ..models.sig_mp import get_bbox_scale
from ..preprocess.synthesis import random_camera, synthesize_confidence

__all__ = [
    "aist_root_frame", "amass_root_frame", "rnn2_features", "rnn3_features",
    "rnn4_features_aist", "rnn6_features_aist", "rnn7_features",
    "rnn8_features", "amass_mp_base", "amass_camera_augment",
    "cliff_normalize_seq",
]


def aist_root_frame(seq_pose, seq_ori, seq_acc, seq_joint3d,
                    rotate_all_imus: bool = True):
    r"""World -> root-frame inputs of one sequence: ``(Rrw, orir, accr,
    j3dr, pose_R)``, joints root-relative without the root row."""
    pose_R = _aa_to_R(_to_np(seq_pose).reshape(len(seq_pose), -1))
    Rrw = np.swapaxes(pose_R[:, 0], 1, 2)
    ori = _to_np(seq_ori)
    if rotate_all_imus:
        orir = np.einsum("tij,tnjk->tnik", Rrw, ori)
    else:
        orir = ori.copy()
        orir[:, :5] = np.einsum("tij,tnjk->tnik", Rrw, ori[:, :5])
    accr = np.einsum("tij,tnj->tni", Rrw, _to_np(seq_acc))
    j3dr = np.einsum("tij,tnj->tni", Rrw, _to_np(seq_joint3d))
    j3dr = j3dr[:, 1:] - j3dr[:, :1]
    return Rrw, orir, accr, j3dr, pose_R


def amass_root_frame(seq_pose, seq_ori, seq_acc, seq_joint3d,
                     rotate_all_imus: bool = True):
    r"""The same transform for the AMASS schema; the root rotation comes
    from the pose itself."""
    return aist_root_frame(seq_pose, seq_ori, seq_acc, seq_joint3d,
                           rotate_all_imus)


def _root_velocity(joint3d: np.ndarray) -> np.ndarray:
    r"""Scaled central-difference root velocity, zero at both ends."""
    v = (joint3d[2:] - joint3d[:-2]) * 30.0
    return np.concatenate([np.zeros((1, 3), np.float32), v[:, 0],
                           np.zeros((1, 3), np.float32)]) / VEL_SCALE


def _flat(*xs):
    return np.concatenate([x.reshape(len(x), -1) for x in xs], 1)


def rnn2_features(dataset: Dict) -> Tuple[List, List]:
    r"""IMU -> root-relative joints."""
    data, label = [], []
    for i in range(len(dataset["pose"])):
        _, orir, accr, j3dr, _ = aist_root_frame(
            dataset["pose"][i], dataset["imu_ori"][i], dataset["imu_acc"][i],
            dataset["joint3d"][i])
        data.append(_flat(accr, orir)[1:-1])
        label.append(j3dr.reshape(len(j3dr), -1)[1:-1])
    return data, label


def rnn3_features(dataset: Dict) -> Tuple[List, List]:
    r"""IMU + joints -> root velocity in the root frame."""
    data, label = [], []
    for i in range(len(dataset["pose"])):
        Rrw, orir, accr, j3dr, _ = aist_root_frame(
            dataset["pose"][i], dataset["imu_ori"][i], dataset["imu_acc"][i],
            dataset["joint3d"][i])
        v3dw = _root_velocity(_to_np(dataset["joint3d"][i]))
        v3dr = np.einsum("tij,tj->ti", Rrw, v3dw)
        data.append(_flat(accr, orir, j3dr)[1:-1])
        label.append(v3dr[1:-1])
    return data, label


def cliff_normalize_seq(j2dc: np.ndarray, bbox_scale: bool = True
                        ) -> np.ndarray:
    r"""Whole-sequence bbox and root-centering normalization: x/y divided by
    the per-frame bbox scale, then every row except row 23 centered on the
    (pre-centering) row 23.

    ``bbox_scale=False`` is the reference's occluded-sample path, where the
    bbox division lands on the clean keypoints instead, so the occluded
    keypoints that enter training are only K^-1-normalized and
    root-centered."""
    out = j2dc.copy()
    if bbox_scale:
        scale = get_bbox_scale(torch.from_numpy(out)).numpy().reshape(-1, 1, 1)
        out[..., :2] = out[..., :2] / scale
    center = out[:, 23:24, :2].copy()
    out[:, 24:, :2] -= center
    out[:, :23, :2] -= center
    return out


def _camera_frame_seq(dataset, i, j):
    Tcw = _to_np(dataset["cam_T"][i][j])
    Kinv = np.linalg.inv(_to_np(dataset["cam_K"][i][j]))
    oric = np.einsum("ij,tnjk->tnik", Tcw[:3, :3],
                     _to_np(dataset["imu_ori"][i]))
    accc = np.einsum("ij,tnj->tni", Tcw[:3, :3], _to_np(dataset["imu_acc"][i]))
    j3dc = np.einsum("ij,tnj->tni", Tcw[:3, :3],
                     _to_np(dataset["joint3d"][i])) + Tcw[:3, 3]
    j3dc = j3dc[:, 1:] - j3dc[:, :1]
    tranc = _to_np(dataset["tran"][i]) @ Tcw[:3, :3].T + Tcw[:3, 3]
    return Kinv, oric, accc, j3dc, tranc


def _detector_kp(dataset, key, i, j, Kinv):
    r"""Keypoints [T, 33, 3] of camera j: x, y on the K^-1 plane, and the
    confidence from the last column (raw MediaPipe caches carry four:
    x, y, z, visibility)."""
    kp = dataset.get(key, None)
    if kp is None or kp[i][j] is None:
        return None
    kp = _to_np(kp[i][j])
    uv = kp[..., :2] * np.array([1920.0, 1080.0], np.float32)
    xy = np.concatenate([uv, np.ones_like(uv[..., :1])], -1) @ Kinv.T
    out = xy.astype(np.float32)
    out[..., 2] = kp[..., -1]
    return out


def rnn4_features_aist(dataset: Dict, num_cameras=None,
                       include_occ: bool = True) -> Tuple[List, List]:
    r"""Camera-frame IMU + normalized keypoints -> camera-frame joints, plus
    the occluded-detection variants (``joint2d_occ``)."""
    data, label = [], []
    for i in range(len(dataset["pose"])):
        n_cam = (num_cameras if num_cameras is not None
                 else len(dataset["cam_T"][i]))
        for j in range(n_cam):
            if dataset["joint2d_mp"][i][j] is None:
                continue
            Kinv, oric, accc, j3dc, _ = _camera_frame_seq(dataset, i, j)
            y = j3dc.reshape(len(j3dc), -1)
            kpn = cliff_normalize_seq(
                _detector_kp(dataset, "joint2d_mp", i, j, Kinv))
            data.append(_flat(accc, oric, kpn)[1:-1])
            label.append(y[1:-1])
            if include_occ and "joint2d_occ" in dataset:
                kpo = _detector_kp(dataset, "joint2d_occ", i, j, Kinv)
                if kpo is None or len(kpo) != len(oric):
                    continue
                kpo = cliff_normalize_seq(kpo, bbox_scale=False)
                data.append(_flat(accc, oric, kpo)[1:-1])
                label.append(y[1:-1])
    return data, label


def rnn6_features_aist(dataset: Dict, num_cameras=None) -> Tuple[List, List]:
    r"""Camera-frame IMU + keypoints (K^-1-normalized, not bbox-normalized)
    + joints -> camera-frame root translation."""
    data, label = [], []
    for i in range(len(dataset["pose"])):
        n_cam = (num_cameras if num_cameras is not None
                 else len(dataset["cam_T"][i]))
        for j in range(n_cam):
            if dataset["joint2d_mp"][i][j] is None:
                continue
            Kinv, oric, accc, j3dc, tranc = _camera_frame_seq(dataset, i, j)
            kp = _detector_kp(dataset, "joint2d_mp", i, j, Kinv)
            data.append(_flat(accc, oric, kp, j3dc)[1:-1])
            label.append(tranc[1:-1])
    return data, label


def rnn7_features(dataset: Dict, body_model) -> Tuple[List, List]:
    r"""IMU (pelvis unrotated) + joints -> global 6-D pose with an identity
    root, through ``body_model``'s ``forward_kinematics_R`` on its
    device."""
    data, label = [], []
    for i in range(len(dataset["pose"])):
        _, orir, accr, j3dr, pose_R = aist_root_frame(
            dataset["pose"][i], dataset["imu_ori"][i], dataset["imu_acc"][i],
            dataset["joint3d"][i], rotate_all_imus=False)
        p = pose_R.copy()
        p[:, 0] = np.eye(3, dtype=np.float32)
        glb = body_model.forward_kinematics_R(
            torch.from_numpy(p).to(body_model.device))
        r6d = rotation_matrix_to_r6d(glb).cpu().numpy().reshape(len(p), -1)
        data.append(_flat(accr, orir, j3dr)[1:-1])
        label.append(r6d[1:-1])
    return data, label


def rnn8_features(dataset: Dict, contact_vel_threshold: float = 0.25
                  ) -> Tuple[List, List]:
    r"""IMU + joints -> foot-contact labels (both feet's speed under the
    threshold)."""
    data, label = [], []
    for i in range(len(dataset["pose"])):
        _, orir, accr, j3dr, _ = aist_root_frame(
            dataset["pose"][i], dataset["imu_ori"][i], dataset["imu_acc"][i],
            dataset["joint3d"][i])
        j3d = _to_np(dataset["joint3d"][i])
        v3dw = (j3d[2:] - j3d[:-2]) * 30.0
        contacts = (np.linalg.norm(v3dw[:, 10:12], axis=2)
                    < contact_vel_threshold).astype(np.float32)
        contacts = np.concatenate([contacts[:1], contacts, contacts[-1:]])
        data.append(_flat(accr, orir, j3dr)[1:-1])
        label.append(contacts[1:-1])
    return data, label


# ---------------------------------------------------------------------------
# AMASS random-camera synthesis for rnn4/rnn6 (per-draw augmentation)
# ---------------------------------------------------------------------------


def amass_mp_base(dataset: Dict) -> Tuple[List, List]:
    r"""World-frame base sequences of the AMASS rnn4/rnn6 path: data =
    [accw | oriw | j3dw_mp (33x3)], label = j3dw (24x3), both less the first
    frame's root, with the MediaPipe limb rows replaced by true joints."""
    data, label = [], []
    for i in range(len(dataset["imu_acc"])):
        j3d = _to_np(dataset["joint3d"][i])
        root = j3d[0, 0].copy()
        j3dw = j3d - root
        mp = _to_np(dataset["sync_3d_mp"][i]) - root
        mp[:, 11:17] = j3dw[:, 16:22]
        mp[:, 23:25] = j3dw[:, 1:3]
        mp[:, 25:27] = j3dw[:, 4:6]
        mp[:, 27:29] = j3dw[:, 7:9]
        data.append(_flat(_to_np(dataset["imu_acc"][i]),
                          _to_np(dataset["imu_ori"][i]), mp)[1:-1])
        label.append(j3dw.reshape(len(j3dw), -1)[1:-1])
    return data, label


def amass_camera_augment(generator: torch.Generator, data: torch.Tensor,
                         label: torch.Tensor, conf_pool: torch.Tensor,
                         target: str = "rnn4", yaw=(-180.0, 180.0),
                         draws: dict = None):
    r"""One random camera, translation and keypoint confidence for one
    world-frame chunk, drawn from ``generator`` on the chunk's device.

    ``data [T, 18+54+99]`` (``amass_mp_base``), ``label [T, 72]``. Returns
    ``(data', label')`` in the camera frame: for rnn4 the bbox-normalized
    keypoints and root-relative joints [T, 69]; for rnn6 the raw keypoints
    followed by the relative joints, and the absolute root [T, 3].
    ``conf_pool`` holds confidences per frame and landmark [N, 33, 1] or
    per frame [N]; T of them are drawn without replacement when N >= T.

    ``draws`` pins the draws for parity tests: ``{"Rc0c": [3, 3],
    "uniform3": [3]}`` replace the camera rotation and the translation
    lerp's uniforms."""
    draws = draws or {}
    dev, T = data.device, data.shape[0]
    accw = data[:, :18].reshape(T, 6, 3)
    oriw = data[:, 18:72].reshape(T, 6, 3, 3)
    mpw = data[:, 72:].reshape(T, 33, 3)
    j3dw = label.reshape(T, 24, 3)

    if "Rc0c" in draws:
        Rwc0 = torch.tensor([[-1.0, 0, 0], [0, -1.0, 0], [0, 0, 1.0]],
                            device=dev)
        Rcw = (Rwc0 @ torch.tensor(np.array(draws["Rc0c"]),
                                   dtype=torch.float32, device=dev)).T
    else:
        Rcw = random_camera(generator, yaw=yaw)

    accc = torch.einsum("ij,tnj->tni", Rcw, accw)
    oric = torch.einsum("ij,tnjk->tnik", Rcw, oriw)
    j3dc = torch.einsum("ij,tnj->tni", Rcw, j3dw)
    mpc = torch.einsum("ij,tnj->tni", Rcw, mpw)

    u3 = (torch.as_tensor(draws["uniform3"], dtype=torch.float32, device=dev)
          if "uniform3" in draws
          else torch.rand(3, generator=generator, device=dev))
    tr = lerp(torch.tensor([-1.0, -1.0, 3.0], device=dev),
              torch.tensor([1.0, 1.0, 8.0], device=dev), u3)
    tr = torch.cat([tr[:2], tr[2:] - j3dc[..., 2].min()])
    j3dc = j3dc + tr
    mpc = mpc + tr

    j2dc = synthesize_confidence(generator, mpc / mpc[..., 2:], conf_pool)

    j3dc_rel = (j3dc[:, 1:] - j3dc[:, :1]).reshape(T, -1)
    if target == "rnn4":
        xy = j2dc[..., :2] / get_bbox_scale(j2dc).reshape(T, 1, 1)
        xy_c = xy - xy[:, 23:24]
        xy_c[:, 23] = xy[:, 23]
        kp = torch.cat([xy_c, j2dc[..., 2:]], -1)
        return (torch.cat([accc.reshape(T, -1), oric.reshape(T, -1),
                           kp.reshape(T, -1)], 1), j3dc_rel)
    out = torch.cat([accc.reshape(T, -1), oric.reshape(T, -1),
                     j2dc.reshape(T, -1), j3dc_rel], 1)
    return out, j3dc[:, 0]

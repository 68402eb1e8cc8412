r"""Synthetic corpora in the schema of the reference's preprocessed
``test.pt`` files (port of ``robustcap_tpu/preprocess/fixtures.py``).

Real corpora (AIST++, TotalCapture, 3DPW) are licensed and absent, so the
evaluation runs on smooth random motions pushed through the synthesis the
reference uses for virtual sensors: FK and skinning, IMU orientations at
the IMU joints and accelerations at the IMU vertices, and pinhole-projected
pseudo-MediaPipe landmarks with a confidence. The random draws come from a
``np.random.RandomState`` in the JAX package's order, so one seed gives the
same motions, cameras and confidences in both packages; the body math runs
in torch on the body model's device.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..config import IMU_JOINT_MASK, IMU_VERTEX_MASK, MP_VERTEX_MASK
from ..math.angular import axis_angle_to_rotation_matrix
from . import synthesis

__all__ = ["smooth_random_motion", "build_fixture_dataset",
           "build_fixture_dataset_pw3d"]

IMG_W, IMG_H = 1920, 1080


def smooth_random_motion(rng: np.random.RandomState, T: int,
                         amp: float = 0.18, walk: float = 0.4):
    r"""A smooth random motion: low-pass-filtered noise on the axis-angle
    joints ``[T, 24, 3]`` and a slow root walk ``[T, 3]`` (world frame,
    y up)."""
    def smooth(x, k=15):
        # the kernel is clamped to the sequence: a 'same' convolution
        # returns max(len, kernel) samples
        k = min(k, x.shape[0])
        if k < 3:  # hanning(<3) sums to 0
            return x
        kernel = np.hanning(k)
        kernel /= kernel.sum()
        return np.apply_along_axis(
            lambda a: np.convolve(a, kernel, mode="same"), 0, x)

    aa = smooth(rng.normal(0, amp * 4, (T, 24, 3))).astype(np.float32)
    aa[:, 0] = smooth(rng.normal(0, 0.3, (T, 3))).astype(np.float32)
    tran = np.cumsum(
        smooth(rng.normal(0, walk / 60, (T, 3))), axis=0).astype(np.float32)
    tran[:, 1] *= 0.1  # keep the body near a constant height
    return aa, tran


def _look_at_camera(subject_center: np.ndarray, distance: float,
                    azimuth: float, height: float) -> np.ndarray:
    r"""World-to-camera SE(3) (Tcw) of a camera orbiting the subject."""
    cam_pos = subject_center + np.array(
        [distance * np.sin(azimuth), height, distance * np.cos(azimuth)],
        np.float32)
    fwd = subject_center - cam_pos
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0, 1.0, 0], np.float32)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    Rcw = np.stack([right, down, fwd])          # rows: camera axes in world
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rcw
    T[:3, 3] = -Rcw @ cam_pos
    return T


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _rotations(aa: np.ndarray, dev) -> np.ndarray:
    r"""Axis-angle ``[..., 3]`` as rotation matrices ``[N, 3, 3]``."""
    return _np(axis_angle_to_rotation_matrix(
        torch.as_tensor(np.asarray(aa, np.float32).reshape(-1, 3),
                        device=dev)))


def build_fixture_dataset(model, n_seq: int = 2, T: int = 96, n_cam: int = 2,
                          seed: int = 0, conf_fn=None) -> Dict[str, List]:
    r"""A dataset dict in the AIST schema (name, pose, tran, joint3d,
    joint2d_mp, cam_K, cam_T, imu_ori, imu_acc, sync_3d_mp) of ``n_seq``
    motions of ``T`` frames seen by ``n_cam`` cameras, posed with ``model``
    (the port's ``ParametricModel``). ``conf_fn(rng, T) -> [T]`` sets the
    per-frame keypoint confidence; the default is high with occasional
    dips."""
    rng = np.random.RandomState(seed)
    dev = model.device
    need_verts = np.union1d(np.asarray(MP_VERTEX_MASK),
                            np.asarray(IMU_VERTEX_MASK))
    vi_in_need = np.searchsorted(need_verts, np.asarray(IMU_VERTEX_MASK))
    mp_in_need = np.searchsorted(need_verts, np.asarray(MP_VERTEX_MASK))
    K = np.array([[1200.0, 0, IMG_W / 2], [0, 1200.0, IMG_H / 2], [0, 0, 1]],
                 np.float32)

    data = {k: [] for k in ["name", "pose", "tran", "joint3d", "joint2d_mp",
                            "cam_K", "cam_T", "imu_ori", "imu_acc",
                            "sync_3d_mp"]}
    for s in range(n_seq):
        aa, tran = smooth_random_motion(rng, T)
        pose = _rotations(aa, dev).reshape(T, 24, 3, 3)
        glb, joints, verts = model.forward_kinematics(
            torch.as_tensor(pose, device=dev),
            tran=torch.as_tensor(tran, device=dev), calc_mesh=True,
            vertex_ids=need_verts)
        ori = _np(glb[:, list(IMU_JOINT_MASK)])
        acc = _np(synthesis.syn_acc(verts[:, vi_in_need]))
        mp3d_w = _np(synthesis.sync_3d_mp(verts[:, mp_in_need], joints))
        joints = _np(joints)

        cam_Ks, cam_Ts, kp2d = [], [], []
        center = joints.mean(axis=(0, 1))
        for cidx in range(n_cam):
            Tcw = _look_at_camera(center, distance=4.0 + 0.5 * cidx,
                                  azimuth=2 * np.pi * cidx / max(n_cam, 1),
                                  height=0.4)
            mp_c = mp3d_w @ Tcw[:3, :3].T + Tcw[:3, 3]
            uv = _np(synthesis.project_points(torch.as_tensor(mp_c),
                                              torch.as_tensor(K)))
            if conf_fn is None:
                conf = np.clip(
                    0.95 - 0.5 * (rng.uniform(0, 1, T) < 0.15), 0, 1)
            else:
                conf = conf_fn(rng, T)
            kp = np.zeros((T, 33, 3), np.float32)
            kp[..., 0] = uv[..., 0] / IMG_W
            kp[..., 1] = uv[..., 1] / IMG_H
            kp[..., 2] = conf[:, None]
            cam_Ks.append(K.copy())
            cam_Ts.append(Tcw)
            kp2d.append(kp)

        data["name"].append(f"synth_seq_{s}_cAll")
        data["pose"].append(aa.reshape(T, 72))
        data["tran"].append(tran)
        data["joint3d"].append(joints)
        data["joint2d_mp"].append(kp2d)
        data["cam_K"].append(cam_Ks)
        data["cam_T"].append(cam_Ts)
        data["imu_ori"].append(ori)
        data["imu_acc"].append(acc)
        data["sync_3d_mp"].append(mp3d_w)
    return data


def build_fixture_dataset_pw3d(model, n_seq: int = 1, T: int = 64,
                               seed: int = 0,
                               conf_fn=None) -> Dict[str, List]:
    r"""A dataset dict in the 3DPW schema (posec, tranc, imu_oric,
    imu_accc, joint2d_mp, cam_K, cam_T): camera-frame pose, translation and
    IMUs, per-frame extrinsics of a slowly turning hand-held camera, and
    keypoints in pixels."""
    base = build_fixture_dataset(model, n_seq=n_seq, T=T, n_cam=1,
                                 seed=seed, conf_fn=conf_fn)
    out = {k: [] for k in ["posec", "tranc", "imu_oric", "imu_accc",
                           "joint2d_mp", "cam_K", "cam_T"]}
    rng = np.random.RandomState(seed + 1)
    for i in range(n_seq):
        K = base["cam_K"][i][0]
        Tcw0 = base["cam_T"][i][0]
        # slow per-frame camera jitter around the static extrinsics
        yaw = np.cumsum(rng.normal(0, 0.001, T)).astype(np.float32)
        cam_T = []
        for t in range(T):
            Tt = Tcw0.copy()
            Tt[:3, :3] = _rotations([0.0, yaw[t], 0.0], model.device)[0] \
                @ Tcw0[:3, :3]
            cam_T.append(Tt)
        cam_T = np.stack(cam_T)

        pose = _rotations(base["pose"][i], model.device).reshape(T, 24, 3, 3)
        R0 = Tcw0[:3, :3]
        pose[:, 0] = np.einsum("ij,tjk->tik", R0, pose[:, 0])
        tranc = base["tran"][i] @ R0.T + Tcw0[:3, 3]
        oric = np.einsum("ij,tnjk->tnik", R0, base["imu_ori"][i])
        accc = np.einsum("ij,tnj->tni", R0, base["imu_acc"][i])
        kp = base["joint2d_mp"][i][0].copy()
        kp[..., 0] *= IMG_W
        kp[..., 1] *= IMG_H
        out["posec"].append(pose)
        out["tranc"].append(tranc.astype(np.float32))
        out["imu_oric"].append(oric.astype(np.float32))
        out["imu_accc"].append(accc.astype(np.float32))
        out["joint2d_mp"].append(kp)
        out["cam_K"].append(K)
        out["cam_T"].append(cam_T)
    return out

r"""Evaluation sequences from preprocessed dataset dicts (port of
``robustcap_tpu/eval/datasets.py``): every camera view of a motion as an
``EvalSequence`` in that camera's frame, on the host in numpy, ready for
the batched runner. AIST++ (9 cameras, ground-truth first translation),
TotalCapture (8 cameras, first-frame seeding) and 3DPW (one moving camera,
data already in the camera frame)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..math.angular import axis_angle_to_rotation_matrix

__all__ = ["EvalSequence", "load_torch_file", "build_aist_sequences",
           "build_tc_sequences", "build_pw3d_sequences", "bucket_sequences"]

IMG_W, IMG_H = 1920, 1080
_DOWN = np.array([0.0, -1.0, 0.0], np.float32)


@dataclass
class EvalSequence:
    r"""One camera view of one motion, in that camera's frame."""
    name: str
    j2dc: np.ndarray          # [T, 33, 3] K^-1-normalized x, y + confidence
    j2dc_px: np.ndarray       # [T, 33, 3] pixel x, y + confidence
    accc: np.ndarray          # [T, 6, 3]
    oric: np.ndarray          # [T, 6, 3, 3]
    pose_gt: np.ndarray       # [T, 24, 3, 3] camera frame (root rotated)
    tran_gt: np.ndarray       # [T, 3] camera frame
    gravityc: np.ndarray      # [T, 3] gravity direction in the camera frame
    cam_K: np.ndarray         # [3, 3]
    first_tran: Optional[np.ndarray]  # ground-truth seed translation
    first_frame: bool         # TotalCapture-style seeding
    valid: bool = True        # not filtered out (AIST's not_aligned list)

    @property
    def length(self) -> int:
        return int(self.j2dc.shape[0])


def load_torch_file(path: str):
    r"""A preprocessed ``.pt`` artifact, loaded on the CPU. It holds numpy
    and Python objects besides tensors, so it is unpickled in full: load
    only files this pipeline or the reference wrote."""
    return torch.load(path, map_location="cpu", weights_only=False)


def _to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _aa_to_R(aa: np.ndarray) -> np.ndarray:
    return axis_angle_to_rotation_matrix(
        torch.from_numpy(np.ascontiguousarray(aa.reshape(-1, 3)))
    ).numpy().reshape(-1, 24, 3, 3)


def _normalize_kp(kp_px: np.ndarray, K: np.ndarray) -> np.ndarray:
    r"""Pixel keypoints with confidence -> K^-1 plane coordinates with
    confidence."""
    Kinv = np.linalg.inv(K)
    ones = np.ones_like(kp_px[..., :1])
    uv1 = np.concatenate([kp_px[..., :2], ones], -1) @ Kinv.T
    return np.concatenate([uv1[..., :2], kp_px[..., 2:]],
                          -1).astype(np.float32)


def _camera_frame_inputs(Tcw: np.ndarray, imu_ori: np.ndarray,
                         imu_acc: np.ndarray, pose_aa: np.ndarray,
                         tran: np.ndarray):
    r"""World -> camera transforms shared by AIST and TotalCapture."""
    R = Tcw[:3, :3]
    oric = np.einsum("ij,tnjk->tnik", R, imu_ori)
    accc = np.einsum("ij,tnj->tni", R, imu_acc)        # a free vector
    pose = _aa_to_R(pose_aa)
    pose[:, 0] = np.einsum("ij,tjk->tik", R, pose[:, 0])
    tranc = tran @ R.T + Tcw[:3, 3]
    gravityc = (R @ _DOWN).astype(np.float32)
    return oric.astype(np.float32), accc.astype(np.float32), pose, \
        tranc.astype(np.float32), gravityc


def _scaled_px(kp: np.ndarray) -> np.ndarray:
    r"""Stored fraction-of-frame keypoints -> pixels; x, y and the last
    column as the confidence (raw MediaPipe caches have 4 columns)."""
    kp = np.asarray(kp, np.float32)
    return np.stack([kp[..., 0] * IMG_W, kp[..., 1] * IMG_H, kp[..., -1]],
                    axis=-1)


def _camera_sequences(dataset: Dict, num_cameras: Optional[int], name_fn,
                      gt_seed: bool, valid_fn=lambda name: True):
    seqs = []
    for i in range(len(dataset["pose"])):
        n_cam = (num_cameras if num_cameras is not None
                 else len(dataset["cam_T"][i]))
        for j in range(n_cam):
            name = name_fn(i, j)
            Tcw = _to_np(dataset["cam_T"][i][j])
            K = _to_np(dataset["cam_K"][i][j])
            oric, accc, pose, tranc, grav = _camera_frame_inputs(
                Tcw, _to_np(dataset["imu_ori"][i]),
                _to_np(dataset["imu_acc"][i]),
                _to_np(dataset["pose"][i]), _to_np(dataset["tran"][i]))
            kp_px = _scaled_px(_to_np(dataset["joint2d_mp"][i][j]))
            T = len(oric)
            seqs.append(EvalSequence(
                name=name, j2dc=_normalize_kp(kp_px, K), j2dc_px=kp_px,
                accc=accc, oric=oric, pose_gt=pose, tran_gt=tranc,
                gravityc=np.broadcast_to(grav, (T, 3)).copy(), cam_K=K,
                first_tran=tranc[0] if gt_seed else None,
                first_frame=not gt_seed, valid=valid_fn(name)))
    return seqs


def build_aist_sequences(dataset: Dict, not_aligned: Sequence[str] = (),
                         num_cameras: Optional[int] = None
                         ) -> List[EvalSequence]:
    r"""AIST++: every camera view (9, or what the data holds), seeded with
    the ground-truth first translation; views named in ``not_aligned`` are
    marked invalid, and the metrics skip them."""
    not_aligned = set(not_aligned)
    return _camera_sequences(
        dataset, num_cameras,
        lambda i, j: str(dataset["name"][i]).replace("cAll", f"c0{j + 1}"),
        gt_seed=True, valid_fn=lambda name: name not in not_aligned)


def build_tc_sequences(dataset: Dict, num_cameras: Optional[int] = None
                       ) -> List[EvalSequence]:
    r"""TotalCapture: real IMU recordings, every camera view (8, or what the
    data holds), seeded by ``first_frame`` instead of a ground-truth
    translation."""
    return _camera_sequences(dataset, num_cameras,
                             lambda i, j: f"tc_{i}_c{j}", gt_seed=False)


def build_pw3d_sequences(dataset: Dict) -> List[EvalSequence]:
    r"""3DPW(-OCC): one moving camera, data already in the camera frame,
    per-frame gravity from the extrinsics, keypoints in pixels; sequences
    without keypoints are skipped."""
    seqs = []
    for i in range(len(dataset["posec"])):
        if dataset["joint2d_mp"][i] is None:
            continue
        K = _to_np(dataset["cam_K"][i])
        kp_px = _to_np(dataset["joint2d_mp"][i]).copy()
        oric = _to_np(dataset["imu_oric"][i])
        pose = _to_np(dataset["posec"][i]).reshape(-1, 24, 3, 3)
        tranc = _to_np(dataset["tranc"][i]).reshape(-1, 3)
        T = len(oric)
        cam_T = np.stack([_to_np(dataset["cam_T"][i][t]) for t in range(T)])
        grav = np.einsum("tij,j->ti", cam_T[:, :3, :3], _DOWN)
        seqs.append(EvalSequence(
            name=f"pw3d_{i}", j2dc=_normalize_kp(kp_px, K), j2dc_px=kp_px,
            accc=_to_np(dataset["imu_accc"][i]), oric=oric, pose_gt=pose,
            tran_gt=tranc, gravityc=grav.astype(np.float32), cam_K=K,
            first_tran=tranc[0], first_frame=False))
    return seqs


def bucket_sequences(seqs: List[EvalSequence], max_bucket: int = 32,
                     pad_to_multiple: int = 128
                     ) -> List[Tuple[List[int], int]]:
    r"""Sequences grouped into batches of one padded length (each length
    rounded up to ``pad_to_multiple``, at most ``max_bucket`` a batch, in
    order of length): ``[(indices, padded_length)]``."""
    order = sorted(range(len(seqs)), key=lambda i: seqs[i].length)
    buckets = []
    cur: List[int] = []
    cur_len = 0
    for idx in order:
        L = -(-seqs[idx].length // pad_to_multiple) * pad_to_multiple
        if cur and (L != cur_len or len(cur) >= max_bucket):
            buckets.append((cur, cur_len))
            cur = []
        cur.append(idx)
        cur_len = L
    if cur:
        buckets.append((cur, cur_len))
    return buckets

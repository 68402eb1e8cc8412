r"""Corpus drivers: raw dataset trees into the work ``.pt`` dicts that
training and evaluation read (port of ``robustcap_tpu/preprocess/corpus.py``).

* ``preprocess_aist`` — split lists, the official and the minimalbody
  ignore lists, the ``smpl_loss > 4`` and NaN-keypoint filters, the
  per-camera MediaPipe, minimalbody and occluded keypoint caches with the
  frame-count splice repair, the ROMP and PARE baselines of the test split,
  FK and virtual IMUs;
* ``write_not_aligned`` — the camera views whose cached detections sit
  more than 25 px (mean) from the ground truth's reprojection, written to
  ``not_aligned.txt``;
* ``preprocess_totalcapture_pre`` — the raw sensor pickles with the
  ``[2, 3, 0, 1, 4, 5]`` sensor reorder and the diag(-1, 1, -1) frame
  flip, the Vicon positions (inches to metres) with the translation fixups,
  ``calibration.cal``;
* ``preprocess_totalcapture`` — the evaluation dict, skipping the motions
  whose video is not aligned, with the real IMUs held within 17 degrees of
  the synthetic ones and the joints against the Vicon-derived ones;
* ``preprocess_3dpw`` — each person's camera-frame pose and translation,
  30 to 60 Hz midpoint keypoints, FK with the person's shape, and the
  occluded variant.

The artifacts keep the reference's formats (pickle, JSON, ``torch.save``
of numpy arrays), the JAX package's, so a work dict written by either
package loads in both packages' ``eval/datasets.py``. The body math runs in
torch on the body model's device (``device``, the card by default).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import IMU_JOINT_MASK
from ..device import resolve_device
from ..math.angular import (angle_between, radian_to_degree,
                            rotation_matrix_to_axis_angle)
from ..smpl.model import ParametricModel, default_body_model
from .datasets import _TC_FLIP, TC_SENSOR_ORDER, _np, posed_body, rotations

__all__ = [
    "splice_repair", "fill_missing_frames", "preprocess_aist",
    "write_not_aligned", "parse_vicon_positions", "parse_calibration",
    "preprocess_totalcapture_pre", "preprocess_totalcapture",
    "preprocess_3dpw",
]

INCHES_TO_METERS = 0.0254
# SMPL root offset of the mean shape in the AIST++ motions (differs from
# the live demo's config.TRAN_OFFSET)
TRAN_OFFSET_AIST = (-0.00217368, -0.240789175, 0.028583793)
AIST_KEYS = ["name", "pose", "tran", "joint2d", "joint2d_minimalbody",
             "joint2d_mp", "joint2d_occ", "joint3d", "cam_K", "cam_T",
             "imu_ori", "imu_acc", "romp_pose", "romp_tran", "pare_pose",
             "pare_tran"]


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=False)


def _load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def _as_np(x) -> np.ndarray:
    return _np(x) if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# Frame-count repair and missing-frame placeholders
# ---------------------------------------------------------------------------


def splice_repair(track: Optional[np.ndarray], target_len: int
                  ) -> Optional[np.ndarray]:
    r"""The reference's frame-count repair: a track 1-3 frames short gets
    frames repeated (n=1 the last; n=2 the middle and the last; n=3 at the
    thirds and the last), a longer one is cut, and a gap of 4 or more gives
    None."""
    if track is None:
        return None
    track = np.asarray(track)
    n = target_len - len(track)
    if n < 0:
        return track[:target_len]
    if n == 0:
        return track
    if n == 1:
        return np.concatenate([track, track[-1:]])
    if n == 2:
        mid = target_len // 2
        return np.concatenate([track[:mid], track[mid - 1:], track[-1:]])
    if n == 3:
        mid1 = target_len // 3
        mid2 = mid1 * 2
        return np.concatenate([track[:mid1], track[mid1 - 1:mid2],
                               track[mid2 - 1:], track[-1:]])
    return None


def fill_missing_frames(frames: Sequence, n_cols: int = 4,
                        rng: Optional[np.random.RandomState] = None
                        ) -> Optional[np.ndarray]:
    r"""A detector cache's frames stacked, each failed frame (None or empty)
    replaced by random positions with confidence 0 (drawn from ``rng``)."""
    if frames is None or len(frames) == 0:
        return None
    rng = rng or np.random.RandomState(0)
    out = []
    for f in frames:
        if f is None or (hasattr(f, "__len__") and len(f) == 0):
            ph = rng.rand(33, n_cols).astype(np.float32)
            ph[:, -1] = 0.0
            out.append(ph)
        else:
            out.append(np.asarray(_as_np(f), np.float32))
    return np.stack(out)


def _load_kp_cache(path: str, n_cols: int, target_len: int,
                   rng: np.random.RandomState) -> Optional[np.ndarray]:
    if not os.path.exists(path):
        return None
    stacked = fill_missing_frames(_load(path), n_cols=n_cols, rng=rng)
    if stacked is None:
        return None
    repaired = splice_repair(stacked, target_len)
    if repaired is not None:
        assert not np.isnan(repaired).any()
    return repaired


# ---------------------------------------------------------------------------
# AIST++
# ---------------------------------------------------------------------------


def _read_lines(path: str) -> List[str]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [line.strip("\n") for line in f if line.strip("\n")]


def _aist_cameras(cam_data: Sequence[Dict], scale: float):
    r"""Camera JSONs as ``(K [C, 3, 3], Tcw [C, 4, 4])``; the translations
    share the motion's SMPL scaling."""
    Ks, Ts = [], []
    for d in cam_data:
        K = np.asarray(d["matrix"], np.float32).reshape(3, 3)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = _np(rotations(d["rotation"], "cpu"))[0]
        T[:3, 3] = np.asarray(d["translation"], np.float32).reshape(3) / scale
        Ks.append(K)
        Ts.append(T)
    return np.stack(Ks), np.stack(Ts)


def _fk_virtual_imus(model: ParametricModel, pose_aa: np.ndarray,
                     tran: np.ndarray, shape: Optional[np.ndarray] = None
                     ) -> Dict[str, np.ndarray]:
    r"""FK and the virtual IMUs of a motion on the model's device, as
    numpy: ``posed_body``'s outputs."""
    pose_R = rotations(pose_aa, model.device).reshape(len(pose_aa), 24, 3, 3)
    return {k: _np(v) for k, v in posed_body(model, pose_R, tran,
                                             shape).items()}


def _fit_length(pose, tran, target_len):
    n = target_len - len(pose)
    if n < 0:
        return pose[:target_len], tran[:target_len]
    if n >= 4:
        return None, None
    if n >= 1:
        pose = splice_repair(pose, target_len)
        tran = splice_repair(tran, target_len)
    return pose, tran


def _load_romp(path: str, target_len: int):
    r"""A ROMP baseline: per-frame dicts of ``global_orient``, ``body_pose``
    (axis-angle) and ``cam_trans``."""
    if not os.path.exists(path):
        return None, None
    data = _load(path)
    aa = np.stack([np.concatenate([
        _as_np(d["global_orient"]).reshape(3),
        _as_np(d["body_pose"]).reshape(-1)[:69]]) for d in data])
    tran = np.stack([_as_np(d["cam_trans"]).reshape(3) for d in data])
    pose = _np(rotations(aa, "cpu")).reshape(-1, 24, 3, 3)
    return _fit_length(pose, tran, target_len)


def _load_pare(path: str, target_len: int):
    r"""A PARE baseline: a tracklet of ``frame_ids``, ``pose`` and
    ``pred_cam``; a missing frame gets the identity pose with the
    image-flip root and the last translation, and ``pred_cam (s, tx, ty)``
    becomes ``(tx, ty, 2 * 5000 / (224 s))``."""
    if not os.path.exists(path):
        return None, None
    trk = _load(path)[1]
    frame_ids = list(_as_np(trk["frame_ids"]).astype(int))
    poses, trans = [], []
    tran_temp = np.zeros(3, np.float32)
    flip = np.diag([-1.0, -1.0, 1.0]).astype(np.float32)
    j = 0
    for t in range(frame_ids[-1] + 1):
        while frame_ids[j] < t:
            j += 1
        if frame_ids[j] != t:
            p = np.broadcast_to(np.eye(3, dtype=np.float32),
                                (24, 3, 3)).copy()
            p[0] = flip @ p[0]
            poses.append(p)
            trans.append(tran_temp)
        else:
            poses.append(_as_np(trk["pose"][j]).reshape(24, 3, 3))
            cam = _as_np(trk["pred_cam"][j]).reshape(3)
            tran_temp = np.asarray(
                [cam[1], cam[2], 2 * 5000.0 / (224 * cam[0] + 1e-9)],
                np.float32)
            trans.append(tran_temp)
            j += 1
    return _fit_length(np.stack(poses), np.stack(trans), target_len)


def _aist_motion(raw_dir, name, mapping):
    smpl = _load_pickle(os.path.join(raw_dir, "motions", name + ".pkl"))
    kp = _load_pickle(os.path.join(raw_dir, "keypoints2d", name + ".pkl"))
    with open(os.path.join(raw_dir, "cameras",
                           mapping[name] + ".json")) as f:
        cams = json.load(f)
    scale = float(np.asarray(smpl["smpl_scaling"]).reshape(-1)[0])
    pose = np.asarray(smpl["smpl_poses"], np.float32).reshape(-1, 72)
    tran = (np.asarray(smpl["smpl_trans"], np.float32).reshape(-1, 3) / scale
            + np.asarray(TRAN_OFFSET_AIST, np.float32))
    return smpl, kp, cams, scale, pose, tran


def _aist_lists(raw_dir, kind):
    names = _read_lines(os.path.join(raw_dir, "splits", f"pose_{kind}.txt"))
    ignore = set(_read_lines(os.path.join(raw_dir, "ignore_list.txt")))
    mapping = {line.split(" ")[0]: line.split(" ")[1] for line in _read_lines(
        os.path.join(raw_dir, "cameras", "mapping.txt"))}
    return names, ignore, mapping


def preprocess_aist(raw_dir: str, out_dir: str,
                    kinds: Sequence[str] = ("test",),
                    model: Optional[ParametricModel] = None,
                    n_cameras: int = 9, device="cuda") -> Dict[str, int]:
    r"""A raw AIST++ tree as ``{kind}.pt`` work dicts; returns ``{kind:
    sequences}``. The layout is the reference's:

    - ``splits/pose_{kind}.txt``, ``ignore_list.txt``,
      ``ignore_minimalbody.txt``, ``cameras/mapping.txt``,
      ``cameras/{setting}.json``
    - ``motions/{name}.pkl`` (smpl_poses, smpl_trans, smpl_scaling,
      smpl_loss)
    - ``keypoints2d/{name}.pkl`` (``{'keypoints2d': [C, T, 17, 3]}``)
    - per camera, ``keypoints2d_mp|keypoints2d_minimalbody|
      keypoints2d_mp_occ/{name with cAll -> c0X}.pt``
    - optional baselines ``romp_pts|pare_pts/{name with cAll -> c0X}.pt``

    ``model`` (default: ``default_body_model`` on ``device``) lies on
    ``device``.
    """
    dev = resolve_device(device)
    model = model or default_body_model(dev)
    counts = {}
    for kind in kinds:
        split_file = os.path.join(raw_dir, "splits", f"pose_{kind}.txt")
        if not os.path.exists(split_file):
            raise FileNotFoundError(
                f"AIST split list not found: {split_file} — is --raw "
                f"pointing at the corpus root?")
        names, ignore, mapping = _aist_lists(raw_dir, kind)
        ignore_mb = set(_read_lines(
            os.path.join(raw_dir, "ignore_minimalbody.txt")))
        out = {k: [] for k in AIST_KEYS}
        n_succeed = 0
        rng = np.random.RandomState(0)
        for name in names:
            if name in ignore:
                continue
            smpl, kp_data, cam_data, scale, pose, tran = _aist_motion(
                raw_dir, name, mapping)
            if float(np.asarray(smpl.get("smpl_loss", 0.0)).reshape(-1)[0]
                     ) > 4 and kind != "test":
                continue
            joint2d = np.asarray(kp_data["keypoints2d"], np.float32)
            if np.isnan(joint2d).any() and kind != "test":
                continue
            T = joint2d.shape[1]

            kp_mp, kp_mb, kp_occ = [], [], []
            romp_p, romp_t, pare_p, pare_t = [], [], [], []
            for cid in range(n_cameras):
                cname = name.replace("cAll", "c0%d" % (cid + 1))

                def cache(folder):
                    return os.path.join(raw_dir, folder, cname + ".pt")

                if kind == "test":
                    assert os.path.exists(cache("keypoints2d_mp")), \
                        f"Missing {cache('keypoints2d_mp')}"
                use_mb = cname not in ignore_mb or kind == "test"
                mb = (_load_kp_cache(cache("keypoints2d_minimalbody"), 3, T,
                                     rng) if use_mb else None)
                if mb is not None:
                    mb = mb[:, :, [1, 0, 2]]   # row/col swap
                kp_mb.append(mb)
                # the reference gates the MediaPipe cache on the
                # minimalbody ignore list too, dropping a view's valid
                # keypoints when only its minimalbody detector failed
                kp_mp.append(_load_kp_cache(cache("keypoints2d_mp"), 4, T,
                                            rng) if use_mb else None)
                kp_occ.append(_load_kp_cache(cache("keypoints2d_mp_occ"), 4,
                                             T, rng)
                              if (cname not in ignore_mb and kind != "test")
                              else None)
                rp, rt = ((None, None) if kind != "test"
                          else _load_romp(cache("romp_pts"), T))
                pp, pt = ((None, None) if kind != "test"
                          else _load_pare(cache("pare_pts"), T))
                romp_p.append(rp)
                romp_t.append(rt)
                pare_p.append(pp)
                pare_t.append(pt)

            cam_K, cam_T = _aist_cameras(cam_data, scale)
            body = _fk_virtual_imus(model, pose, tran)

            assert joint2d.shape[1] == pose.shape[0] == tran.shape[0]
            assert joint2d.shape[0] == n_cameras and joint2d.shape[2] == 17
            assert not np.isnan(pose).any() and not np.isnan(tran).any()
            for i, d in enumerate(cam_data):
                assert d.get("name", "c0%d" % (i + 1)) == "c0%d" % (i + 1)

            for key, value in (
                    ("name", name), ("pose", pose), ("tran", tran),
                    ("joint2d", joint2d), ("joint3d", body["joints"]),
                    ("cam_K", cam_K), ("cam_T", cam_T),
                    ("imu_ori", body["ori"]), ("imu_acc", body["acc"]),
                    ("joint2d_mp", kp_mp), ("joint2d_minimalbody", kp_mb),
                    ("joint2d_occ", kp_occ), ("romp_pose", romp_p),
                    ("romp_tran", romp_t), ("pare_pose", pare_p),
                    ("pare_tran", pare_t)):
                out[key].append(value)
            n_succeed += 1

        os.makedirs(out_dir, exist_ok=True)
        torch.save(out, os.path.join(out_dir, kind + ".pt"))
        counts[kind] = n_succeed
    return counts


def write_not_aligned(raw_dir: str, out_path: Optional[str] = None,
                      model: Optional[ParametricModel] = None,
                      kind: str = "test", n_cameras: int = 9,
                      threshold_px: float = 25.0,
                      img_wh=(1920, 1080), device="cuda") -> List[str]:
    r"""The camera views of a raw AIST++ tree whose cached MediaPipe
    keypoints sit more than ``threshold_px`` (mean over frames) from the
    reprojection of the ground truth's 33 pseudo-landmarks; written to
    ``out_path`` (default ``<raw_dir>/not_aligned.txt``) and returned."""
    dev = resolve_device(device)
    model = model or default_body_model(dev)
    names, ignore, mapping = _aist_lists(raw_dir, kind)
    flagged = []
    rng = np.random.RandomState(0)
    for name in names:
        if name in ignore:
            continue
        _, kp_data, cam_data, scale, pose, tran = _aist_motion(
            raw_dir, name, mapping)
        T = np.asarray(kp_data["keypoints2d"]).shape[1]
        cam_K, cam_T = _aist_cameras(cam_data, scale)
        syn3d_w = _fk_virtual_imus(model, pose, tran)["mp3d"]
        for cid in range(n_cameras):
            cname = name.replace("cAll", "c0%d" % (cid + 1))
            kp = _load_kp_cache(os.path.join(
                raw_dir, "keypoints2d_mp", cname + ".pt"), 4, T, rng)
            if kp is None:
                continue
            # as the reference: the mean runs over every frame, the
            # confidence-0 placeholders of failed detections included
            det = kp[..., :2] * np.asarray(img_wh, np.float32)
            R, t = cam_T[cid][:3, :3], cam_T[cid][:3, 3]
            uvw = (syn3d_w @ R.T + t) @ cam_K[cid].T
            syn2d = uvw[..., :2] / uvw[..., 2:]
            if float(np.linalg.norm(det - syn2d, axis=-1).mean()) \
                    > threshold_px:
                flagged.append(cname)
    if out_path is None:
        out_path = os.path.join(raw_dir, "not_aligned.txt")
    with open(out_path, "w") as f:
        f.write("".join(n + "\n" for n in flagged))
    return flagged


# ---------------------------------------------------------------------------
# TotalCapture
# ---------------------------------------------------------------------------


def parse_vicon_positions(path: str,
                          joints=("LeftFoot", "RightFoot", "Spine", "Hips")):
    r"""``gt_skel_gbl_pos.txt`` (a tab-separated header of joint names,
    then per frame each joint's space-separated xyz in inches) as the
    selected joints' positions in metres ``[T, len(joints), 3]``."""
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        index = [header.index(j) for j in joints]
        pos = []
        for line in f:
            cols = line.rstrip("\n").split("\t")
            if len(cols) <= max(index):
                break
            pos.append([[float(v) for v in cols[i].split(" ")]
                        for i in index])
    return np.asarray(pos, np.float32) * INCHES_TO_METERS


def parse_calibration(path: str):
    r"""TotalCapture's ``calibration.cal``: per camera a header line, ``fx
    fy cx cy``, a distortion line (skipped), three rotation rows and a
    translation row. Returns ``[(R [3, 3], t [3], K [3, 3])]``."""
    cams = []
    with open(path) as f:
        f.readline()
        while True:
            header = f.readline()
            if not header or not header.strip():
                break
            fx, fy, cx, cy = [float(v) for v in
                              f.readline().split("\t")[0].split()[:4]]
            K = np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
            f.readline()
            R = np.asarray([[float(v) for v in
                             f.readline().split("\t")[0].split()[:3]]
                            for _ in range(3)], np.float32)
            t = np.asarray([float(v) for v in
                            f.readline().split("\t")[0].split()[:3]],
                           np.float32)
            cams.append((R, t, K))
    return cams


def _joints(model, pose, tran):
    r"""The global rotations and joints of a posed motion (host arrays in,
    tensors on the model's device out)."""
    dev = model.device
    glb, joints, _ = model.forward_kinematics(
        torch.as_tensor(pose, device=dev), tran=torch.as_tensor(tran,
                                                                device=dev),
        calc_mesh=True, vertex_ids=np.asarray([0]))
    return glb, joints


def preprocess_totalcapture_pre(raw_dir: str,
                                model: Optional[ParametricModel] = None,
                                n_cameras: int = 8, device="cuda") -> str:
    r"""Stage 1: the raw sensor pickles
    (``TotalCapture_60FPS_Original/*.pkl``: ori, acc, gt) reordered and
    flipped into the model's frame, the Vicon hip positions with the
    reference's fixups (x -= 0.03, y += 1 / (10 + z)), the per-camera
    keypoint caches, and the FK joints, saved as
    ``<raw_dir>/total_capture_data.pt``. Returns that path."""
    dev = resolve_device(device)
    model = model or default_body_model(dev)
    poses, trans, oris, accs, kp_2ds, kp_mps, kp_3ds = ([] for _ in range(7))
    cams = parse_calibration(os.path.join(raw_dir, "calibration.cal"))
    files = sorted(os.listdir(os.path.join(raw_dir,
                                           "TotalCapture_60FPS_Original")))
    rng = np.random.RandomState(0)
    for file in files:
        data = _load_pickle(os.path.join(
            raw_dir, "TotalCapture_60FPS_Original", file))
        ori = np.asarray(data["ori"], np.float32)[:, TC_SENSOR_ORDER]
        acc = np.asarray(data["acc"], np.float32)[:, TC_SENSOR_ORDER]
        gt = np.asarray(data["gt"], np.float32)
        pose = _np(rotations(gt, dev)).reshape(-1, 24, 3, 3)
        Tn = min(len(acc), len(pose))
        pose, ori, acc = pose[:Tn], ori[:Tn], acc[:Tn]
        pose[:, 0] = np.einsum("ij,tjk->tik", _TC_FLIP, pose[:, 0])
        ori = np.einsum("ij,tnjk->tnik", _TC_FLIP, ori)
        acc = np.einsum("ij,tnj->tni", _TC_FLIP, acc)

        subject = file.split("_")[0].upper()
        motion = file.split(".")[0].split("_")[1]
        kp_2d, kp_mp = [], []
        for i in range(n_cameras):
            stem = subject.lower() + "_" + motion + "_cam" + str(i + 1) + ".pt"
            kp_2d.append(np.asarray(_as_np(_load(os.path.join(
                raw_dir, "kp2d", stem))), np.float32))
            kp_mp.append(fill_missing_frames(
                _load(os.path.join(raw_dir, "kp2d_mp", stem)), 4, rng))

        tran = parse_vicon_positions(os.path.join(
            raw_dir, "Vicon_GroundTruth", subject, motion,
            "gt_skel_gbl_pos.txt"))[:, 3]
        tran = tran[:Tn]
        assert len(tran) == len(acc) == len(ori) == len(pose)
        tran[:, 0] -= 0.03
        tran[:, 1] += 1.0 / (10.0 + tran[:, 2])

        _, kp3d = _joints(model, pose, tran)
        poses.append(pose)
        trans.append(tran)
        oris.append(ori)
        accs.append(acc)
        kp_2ds.append(kp_2d)
        kp_mps.append(kp_mp)
        kp_3ds.append(_np(kp3d))
    out_path = os.path.join(raw_dir, "total_capture_data.pt")
    torch.save({"pose": poses, "tran": trans, "ori": oris, "acc": accs,
                "cam": cams, "kp_2d": kp_2ds, "kp_3d": kp_3ds,
                "kp_mp": kp_mps, "files": files}, out_path)
    return out_path


def preprocess_totalcapture(raw_dir: str, out_dir: str,
                            model: Optional[ParametricModel] = None,
                            skip: Sequence[int] = (2, 12, 42),
                            max_imu_angle_deg: float = 17.0,
                            device="cuda") -> int:
    r"""Stage 2: ``<out_dir>/test.pt`` from ``total_capture_data.pt``,
    without the motions at ``skip`` (their video is not aligned), poses
    back to axis-angle, the minimalbody keypoints' row/col order swapped;
    asserts the real IMU orientations within ``max_imu_angle_deg`` (mean)
    of the synthetic ones and the joints against stage 1's. Returns the
    number of sequences."""
    dev = resolve_device(device)
    model = model or default_body_model(dev)
    data = _load(os.path.join(raw_dir, "total_capture_data.pt"))
    cams = data["cam"]
    cam_K = np.stack([K for _, _, K in cams])
    cam_T = np.tile(np.eye(4, dtype=np.float32), (len(cams), 1, 1))
    cam_T[:, :3, :3] = np.stack([R for R, _, _ in cams])
    cam_T[:, :3, 3] = np.stack([t for _, t, _ in cams])

    # names from the per-motion video listings without "_cam#.mp4", else
    # the pickles' stems
    names = []
    for f in data.get("files", []):
        subject = f.split("_")[0].upper()
        motion = f.split(".")[0].split("_")[1]
        vdir = os.path.join(raw_dir, "video", subject, motion)
        if os.path.isdir(vdir):
            vids = sorted(set(v[:-9] for v in os.listdir(vdir)))
            names.append(vids[0] if vids else f.split(".")[0])
        else:
            names.append(f.split(".")[0])
    if not names:
        names = [f"tc_{i}" for i in range(len(data["pose"]))]
    new = {k: [] for k in ["name", "pose", "tran", "joint2d_minimalbody",
                           "joint2d_mp", "joint3d", "cam_K", "cam_T",
                           "imu_ori", "imu_acc"]}
    n = 0
    for i in range(len(data["pose"])):
        if i in set(skip):
            continue
        pose = np.asarray(data["pose"][i], np.float32)
        tran = np.asarray(data["tran"][i], np.float32)
        T = len(pose)
        real_ori = np.asarray(data["ori"][i], np.float32)
        real_kp2d = np.stack([np.asarray(k, np.float32)[:T]
                              for k in data["kp_2d"][i]])
        real_kpmp = np.stack([np.asarray(k, np.float32)[:T]
                              for k in data["kp_mp"][i]])

        glb, joint = _joints(model, pose, tran)
        syn_ori = glb[:, list(IMU_JOINT_MASK)]
        ang = float(radian_to_degree(angle_between(
            torch.as_tensor(real_ori, device=dev), syn_ori).mean()))
        assert ang < max_imu_angle_deg, (
            f"real-vs-synthetic IMU disagreement {ang:.1f} deg on seq {i}")
        kp3d = np.asarray(data["kp_3d"][i], np.float32)
        assert float(np.abs(kp3d[:, :22] - _np(joint)[:, :22]).sum()) < 0.01

        pose_aa = _np(rotation_matrix_to_axis_angle(torch.as_tensor(
            pose.reshape(-1, 3, 3), device=dev))).reshape(-1, 24, 3)
        for key, value in (
                ("name", names[i]), ("pose", pose_aa), ("tran", tran),
                ("joint2d_minimalbody", real_kp2d[..., [1, 0, 2]]),
                ("joint2d_mp", real_kpmp), ("cam_K", cam_K),
                ("cam_T", cam_T), ("imu_ori", real_ori),
                ("imu_acc", np.asarray(data["acc"][i], np.float32)),
                ("joint3d", kp3d)):
            new[key].append(value)
        n += 1
    os.makedirs(out_dir, exist_ok=True)
    torch.save(new, os.path.join(out_dir, "test.pt"))
    return n


# ---------------------------------------------------------------------------
# 3DPW and 3DPW-OCC
# ---------------------------------------------------------------------------


def _interp_30_to_60(frames: Sequence, n_cols: int,
                     rng: np.random.RandomState) -> np.ndarray:
    r"""30 to 60 Hz keypoints by midpoints; the last frame is doubled."""
    filled = fill_missing_frames(frames, n_cols=n_cols, rng=rng)
    out = []
    for i in range(len(filled)):
        out.append(filled[i])
        if i == len(filled) - 1:
            out.append(filled[i])
        else:
            out.append((filled[i] + filled[i + 1]) / 2.0)
    return np.stack(out)


def preprocess_3dpw(raw_dir: str, out_dir: str, occ: bool = False,
                    model: Optional[ParametricModel] = None,
                    split: str = "test", device="cuda") -> int:
    r"""A raw 3DPW tree as ``<out_dir>/test.pt`` (``test_occ.pt`` with
    ``occ``): each person's camera-frame pose and translation, FK with the
    person's shape, virtual IMUs, 30 to 60 Hz keypoints. Returns the number
    of person-sequences."""
    dev = resolve_device(device)
    model = model or default_body_model(dev)
    kp_dir = "kp2d_occ_mp" if occ else "kp2d_mp"
    seq_dir = os.path.join(raw_dir, "sequenceFiles", "all" if occ else split)
    if occ:
        sequences = sorted(set(
            "_".join(x.split("_")[:3])
            for x in os.listdir(os.path.join(raw_dir, kp_dir))))
    else:
        sequences = sorted(x.split(".")[0] for x in os.listdir(seq_dir))
    new = {k: [] for k in ["name", "posec", "tranc", "joint2d_mp", "joint3d",
                           "cam_K", "cam_T", "imu_oric", "imu_accc", "shape"]}
    rng = np.random.RandomState(0)
    n = 0
    for name in sequences:
        data = _load_pickle(os.path.join(seq_dir, name + ".pkl"))
        for p_id in range(len(data["poses"])):
            pose = np.asarray(data["poses_60Hz"][p_id], np.float32)
            shape = np.asarray(data["betas"][p_id][:10], np.float32)
            cam_pose = np.repeat(np.asarray(data["cam_poses"], np.float32),
                                 2, axis=0)
            trans = np.asarray(data["trans_60Hz"][p_id],
                               np.float32)[:len(cam_pose)]
            K = np.asarray(data["cam_intrinsics"], np.float32)
            posec = _np(rotations(pose, dev)).reshape(-1, 24, 3, 3)
            posec = posec[:len(cam_pose)]
            cam_pose = cam_pose[:len(posec)]
            posec[:, 0] = np.einsum("tij,tjk->tik", cam_pose[:, :3, :3],
                                    posec[:, 0])
            tranc = (np.einsum("tij,tj->ti", cam_pose[:, :3, :3], trans)
                     + cam_pose[:, :3, 3])
            body = {k: _np(v) for k, v in posed_body(
                model, torch.as_tensor(posec, device=dev), tranc,
                shape).items()}
            joint_2d = _interp_30_to_60(
                _load(os.path.join(raw_dir, kp_dir, f"{name}_{p_id}.pt")),
                3, rng)[:len(posec)]
            assert (posec.shape[0] == tranc.shape[0] == body["ori"].shape[0]
                    == body["acc"].shape[0] == len(joint_2d))
            for key, value in (
                    ("name", name), ("posec", posec),
                    ("tranc", tranc.astype(np.float32)),
                    ("joint2d_mp", joint_2d.astype(np.float32)),
                    ("joint3d", body["joints"]), ("cam_K", K),
                    ("cam_T", cam_pose), ("imu_oric", body["ori"]),
                    ("imu_accc", body["acc"]), ("shape", shape)):
                new[key].append(value)
            n += 1
    os.makedirs(out_dir, exist_ok=True)
    torch.save(new, os.path.join(out_dir,
                                 "test_occ.pt" if occ else "test.pt"))
    return n

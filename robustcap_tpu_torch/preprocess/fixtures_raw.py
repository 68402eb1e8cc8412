r"""Raw-corpus fixtures: synthetic dataset trees in the reference's raw
on-disk layouts, to drive the corpus drivers (``corpus.py``) end to end
(port of ``robustcap_tpu/preprocess/fixtures_raw.py``).

Each writer makes a small corpus with the directory structure, file formats
and quirks of the real one (ignore lists, short detector tracks that need
the splice repair, failed detector frames, 30 Hz keypoint caches, Vicon
text files, ``calibration.cal``) from the procedural motions of
``fixtures.py``, so the ground truth round-trips through preprocessing into
evaluable sequences. The random draws come from a ``np.random.RandomState``
in the JAX package's order, so one seed writes the same numpy-drawn parts as
the JAX package; the posed bodies come from the port's FK on the body
model's device.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Optional

import numpy as np
import torch

from ..math.angular import rotation_matrix_to_axis_angle
from .corpus import TRAN_OFFSET_AIST, parse_calibration
from .datasets import _TC_FLIP, TC_SENSOR_ORDER, _np, posed_body, rotations
from .fixtures import _look_at_camera, smooth_random_motion

__all__ = ["build_raw_aist", "build_raw_totalcapture", "build_raw_pw3d"]

IMG_W, IMG_H = 1920, 1080


def _fk_world(model, aa, tran, shape=None):
    r"""``(pose_R, body)`` of a world-frame motion: the local rotations
    ``[T, 24, 3, 3]`` and ``posed_body``'s outputs, as numpy."""
    pose_R = rotations(aa, model.device).reshape(len(aa), 24, 3, 3)
    body = posed_body(model, pose_R, tran, shape)
    return _np(pose_R), {k: _np(v) for k, v in body.items()}


def _to_axis_angle(R: np.ndarray) -> np.ndarray:
    return _np(rotation_matrix_to_axis_angle(torch.from_numpy(
        np.ascontiguousarray(R, np.float32))))


def _project_mp(mp3d_w, Tcw, K, conf=0.95, n_cols=4):
    pc = mp3d_w @ Tcw[:3, :3].T + Tcw[:3, 3]
    uvw = pc @ K.T
    uv = uvw[..., :2] / uvw[..., 2:]
    kp = np.zeros((len(mp3d_w), 33, n_cols), np.float32)
    kp[..., 0] = uv[..., 0] / IMG_W
    kp[..., 1] = uv[..., 1] / IMG_H
    kp[..., -1] = conf
    return kp


def _write_pickle(obj, path):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _write_text(text, path):
    with open(path, "w") as f:
        f.write(text)


def build_raw_aist(root: str, model, n_seq: int = 2, T: int = 24,
                   n_cam: int = 9, seed: int = 0, short_track: bool = True,
                   none_frame: bool = True,
                   misaligned_cam: Optional[int] = None,
                   kind: str = "test") -> Dict:
    r"""Write a raw AIST++-layout corpus. Quirks: the first sequence's
    camera-0 MediaPipe cache is 2 frames short (splice repair) and has a
    failed (None) frame, one more name stands on the official ignore list,
    and ``misaligned_cam`` (if set) gets keypoints shifted 80 px, which
    ``write_not_aligned`` flags."""
    rng = np.random.RandomState(seed)
    scale = 90.0 + 10.0 * rng.rand()
    names = [f"gBR_sFM_cAll_d0{i}_mBR0_ch0{i}" for i in range(n_seq + 1)]
    ignored = names[-1]
    for d in ["splits", "motions", "keypoints2d", "cameras", "keypoints2d_mp",
              "keypoints2d_minimalbody", "keypoints2d_mp_occ"]:
        os.makedirs(os.path.join(root, d), exist_ok=True)
    _write_text("".join(n + "\n" for n in names),
                os.path.join(root, "splits", f"pose_{kind}.txt"))
    _write_text(ignored + "\n", os.path.join(root, "ignore_list.txt"))
    _write_text("", os.path.join(root, "ignore_minimalbody.txt"))
    _write_text("".join(f"{n} setting1\n" for n in names),
                os.path.join(root, "cameras", "mapping.txt"))

    # one ring of cameras for every sequence
    cams = []
    for c in range(n_cam):
        Tcw = _look_at_camera(np.array([0, 0.2, 0], np.float32),
                              distance=4.0 + 0.2 * c,
                              azimuth=2 * np.pi * c / n_cam, height=0.4)
        K = np.array([[1200.0, 0, IMG_W / 2], [0, 1200.0, IMG_H / 2],
                      [0, 0, 1]], np.float32)
        cams.append({"name": "c0%d" % (c + 1), "size": [IMG_W, IMG_H],
                     "matrix": K.tolist(),
                     "rotation": _to_axis_angle(Tcw[:3, :3][None])
                     .reshape(3).tolist(),
                     "translation": (Tcw[:3, 3] * scale).tolist()})
    with open(os.path.join(root, "cameras", "setting1.json"), "w") as f:
        json.dump(cams, f)

    entries = {}
    for si, name in enumerate(names):
        aa, tran_w = smooth_random_motion(rng, T)
        aa = aa.reshape(T, 72)
        tran_off = tran_w - np.asarray(TRAN_OFFSET_AIST, np.float32)
        _write_pickle(
            {"smpl_poses": aa, "smpl_trans": tran_off * scale,
             "smpl_scaling": np.asarray([scale]), "smpl_loss": 1.0},
            os.path.join(root, "motions", name + ".pkl"))
        _write_pickle({"keypoints2d": rng.rand(n_cam, T, 17, 3)
                       .astype(np.float32)},
                      os.path.join(root, "keypoints2d", name + ".pkl"))
        _, body = _fk_world(model, aa, tran_w)
        entries[name] = (aa, tran_w, body["joints"])
        for c, cam in enumerate(cams):
            cname = name.replace("cAll", "c0%d" % (c + 1))
            Tcw = np.eye(4, dtype=np.float32)
            Tcw[:3, :3] = _np(rotations(cam["rotation"], "cpu"))[0]
            Tcw[:3, 3] = np.asarray(cam["translation"], np.float32) / scale
            kp = _project_mp(body["mp3d"], Tcw,
                             np.asarray(cam["matrix"], np.float32))
            if misaligned_cam is not None and c == misaligned_cam:
                kp[..., 0] += 80.0 / IMG_W
            frames = [torch.from_numpy(kp[t]) for t in range(T)]
            if none_frame and si == 0 and c == 0:
                frames[T // 2] = None
            if short_track and si == 0 and c == 0:
                frames = frames[:-2]
            torch.save(frames, os.path.join(root, "keypoints2d_mp",
                                            cname + ".pt"))
            mb = [torch.from_numpy(kp[t, :, [1, 0, 3]].T.copy())
                  for t in range(T)]
            torch.save(mb, os.path.join(root, "keypoints2d_minimalbody",
                                        cname + ".pt"))
    return {"names": names, "ignored": ignored, "entries": entries,
            "scale": scale}


def build_raw_totalcapture(root: str, model, n_seq: int = 2, T: int = 24,
                           n_cam: int = 8, seed: int = 0) -> Dict:
    r"""Write a raw TotalCapture-layout corpus: sensor pickles in the raw
    sensor order and frame (the driver applies the reorder and the flip),
    Vicon text files in inches with the translation fixups inverted,
    ``calibration.cal``, per-camera keypoint caches, and the ``video/``
    listing the names come from."""
    rng = np.random.RandomState(seed)
    for d in ["TotalCapture_60FPS_Original", "kp2d", "kp2d_mp"]:
        os.makedirs(os.path.join(root, d), exist_ok=True)

    with open(os.path.join(root, "calibration.cal"), "w") as f:
        f.write("8\t cameras\n")
        for c in range(n_cam):
            Tcw = _look_at_camera(np.array([0, 0.2, 0], np.float32),
                                  distance=4.0 + 0.2 * c,
                                  azimuth=2 * np.pi * c / n_cam, height=0.3)
            f.write(f"{c + 1}\n")
            f.write("1200.0 1200.0 960.0 540.0\n")
            f.write("0 0 0 0\n")
            for r in range(3):
                f.write(" ".join("%.8f" % v for v in Tcw[r, :3]) + "\n")
            f.write(" ".join("%.8f" % v for v in Tcw[:3, 3]) + "\n")

    inv_reorder = np.argsort(TC_SENSOR_ORDER)
    names = []
    entries = {}
    for s in range(n_seq):
        subject, motion = f"S{s + 1}", "acting1"
        file = f"{subject.lower()}_{motion}.pkl"
        names.append(f"TC_{subject}_{motion}")
        aa, tran_w = smooth_random_motion(rng, T)
        aa = aa.reshape(T, 72)
        tran_w = tran_w + np.asarray([0, 1.0, 0], np.float32)
        pose_R, body = _fk_world(model, aa, tran_w)
        ori_world, acc_world = body["ori"], body["acc"]

        # the inverse of the driver's flip and reorder, so the round trip
        # gives back the world-frame signals
        raw_gt = aa.copy().reshape(T, 24, 3)
        raw_gt[:, 0] = _to_axis_angle(
            np.einsum("ij,tjk->tik", _TC_FLIP, pose_R[:, 0])).reshape(T, 3)
        raw_ori = np.einsum("ij,tnjk->tnik", _TC_FLIP,
                            ori_world)[:, inv_reorder]
        raw_acc = np.einsum("ij,tnj->tni", _TC_FLIP, acc_world)[:, inv_reorder]
        _write_pickle({"ori": raw_ori, "acc": raw_acc, "gt": raw_gt},
                      os.path.join(root, "TotalCapture_60FPS_Original", file))

        tran_raw = tran_w.copy()
        tran_raw[:, 1] -= 1.0 / (10.0 + tran_raw[:, 2])
        tran_raw[:, 0] += 0.03
        vdir = os.path.join(root, "Vicon_GroundTruth", subject, motion)
        os.makedirs(vdir, exist_ok=True)
        joints = body["joints"]
        with open(os.path.join(vdir, "gt_skel_gbl_pos.txt"), "w") as f:
            f.write("LeftFoot\tRightFoot\tSpine\tHips\t\n")
            for t in range(T):
                row = [joints[t, 10], joints[t, 11], joints[t, 6],
                       tran_raw[t]]
                f.write("\t".join(
                    " ".join("%.6f" % (v / 0.0254) for v in p)
                    for p in row) + "\t\n")

        cams = parse_calibration(os.path.join(root, "calibration.cal"))
        for c, (R, t, K) in enumerate(cams):
            Tcw = np.eye(4, dtype=np.float32)
            Tcw[:3, :3] = R
            Tcw[:3, 3] = t
            kp = _project_mp(body["mp3d"], Tcw, K, n_cols=4)
            stem = f"{subject.lower()}_{motion}_cam{c + 1}.pt"
            torch.save([torch.from_numpy(kp[t]) for t in range(T)],
                       os.path.join(root, "kp2d_mp", stem))
            torch.save(np.ascontiguousarray(kp[:, :, [1, 0, 3]]),
                       os.path.join(root, "kp2d", stem))

        vdir = os.path.join(root, "video", subject, motion)
        os.makedirs(vdir, exist_ok=True)
        for c in range(n_cam):
            _write_text("", os.path.join(
                vdir, f"TC_{subject}_{motion}_cam{c + 1}.mp4"))
        entries[names[-1]] = (aa, tran_w, ori_world, acc_world)
    return {"names": names, "entries": entries}


def build_raw_pw3d(root: str, model, n_seq: int = 1, T60: int = 24,
                   seed: int = 0, occ: bool = False) -> Dict:
    r"""Write a raw 3DPW-layout corpus: sequence pickles with 60 Hz poses
    and translations and 30 Hz camera extrinsics, and 30 Hz per-person
    detector caches (the driver interpolates them to 60 Hz)."""
    rng = np.random.RandomState(seed)
    seq_dir = os.path.join(root, "sequenceFiles", "all" if occ else "test")
    kp_dir = os.path.join(root, "kp2d_occ_mp" if occ else "kp2d_mp")
    os.makedirs(seq_dir, exist_ok=True)
    os.makedirs(kp_dir, exist_ok=True)
    entries = {}
    for s in range(n_seq):
        name = f"downtown_walk_{s:02d}"
        aa, tran_w = smooth_random_motion(rng, T60)
        aa = aa.reshape(T60, 72)
        shape = (rng.normal(0, 0.3, 10)).astype(np.float32)
        Tcw = _look_at_camera(np.array([0, 0.2, 0], np.float32),
                              distance=4.0, azimuth=0.3, height=0.4)
        cam_poses = np.tile(Tcw, (T60 // 2, 1, 1)).astype(np.float32)
        K = np.array([[1200.0, 0, IMG_W / 2], [0, 1200.0, IMG_H / 2],
                      [0, 0, 1]], np.float32)
        _write_pickle(
            {"poses": [aa], "poses_60Hz": [aa], "betas": [shape],
             "trans_60Hz": [tran_w], "cam_poses": cam_poses,
             "cam_intrinsics": K},
            os.path.join(seq_dir, name + ".pkl"))

        # 30 Hz detector cache in pixels
        _, body = _fk_world(model, aa, tran_w, shape)
        uvw = (body["mp3d"] @ Tcw[:3, :3].T + Tcw[:3, 3]) @ K.T
        uv = uvw[..., :2] / uvw[..., 2:]
        kp = np.concatenate(
            [uv, np.full((T60, 33, 1), 0.95, np.float32)],
            axis=-1).astype(np.float32)[::2]
        frames = [torch.from_numpy(kp[t]) for t in range(len(kp))]
        frames[1] = None   # a failed detection, filled by the driver
        torch.save(frames, os.path.join(kp_dir, f"{name}_0.pt"))
        entries[name] = (aa, tran_w, shape, Tcw)
    return {"entries": entries}

r"""Evaluation visualization entry points (port of
``robustcap_tpu/eval/visualize.py``).

Rebuild of the reference's ``view_aist`` / ``view_aist_unity``
(evaluate.py:316-415): run the network (+ optional SMPLify) on one
sequence/camera and either render mesh-overlay frames or export
Unity-format motion text files. The network and the skinning run on the
body model's device; rendering uses the software rasterizer on the host
when pyrender is unavailable; video writing uses imageio/cv2 when present
and otherwise saves PNG-free raw frames via numpy.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..config import SigMPConfig, paths
from ..models import sig_mp
from ..smpl.model import default_body_model
from .datasets import _to_np, build_aist_sequences, load_torch_file

__all__ = ["run_single_view", "view_aist", "view_aist_unity"]


def run_single_view(params, model, seq, cfg: Optional[SigMPConfig] = None,
                    run_smplify: bool = True):
    r"""Network (+ SMPLify) on one EvalSequence -> (pose [T,24,3,3],
    tran [T,3]) as numpy arrays (evaluate.py:341-352). Runs on the body
    model's device; ``params`` must be there too."""
    cfg = cfg or SigMPConfig()
    pose, tran = sig_mp.forward_offline(
        params, model, cfg, seq.j2dc, seq.accc, seq.oric,
        first_tran=seq.first_tran, first_frame=seq.first_frame,
        gravityc=seq.gravityc, device=model.device)
    pose, tran = pose.cpu().numpy(), tran.cpu().numpy()
    if run_smplify:
        from ..smplify.runner import smplify_runner
        pose, tran, _ = smplify_runner(
            pose, tran, seq.j2dc_px, seq.oric, batch_size=len(pose),
            cam_k=seq.cam_K, lr=0.001, use_lbfgs=True, opt_steps=1,
            use_head=True, model=model, device=model.device)
    return pose, tran


def _camera_sequence(dataset, seq_idx, cam_idx):
    if dataset is None:
        dataset = load_torch_file(os.path.join(paths.aist_dir, "test.pt"))
    n_cam = len(dataset["cam_K"][0])
    seqs = build_aist_sequences(dataset, num_cameras=n_cam)
    return dataset, seqs[seq_idx * n_cam + cam_idx]


def view_aist(seq_idx: int = 0, cam_idx: int = 0, run_smplify: bool = True,
              params=None, model=None, dataset=None, save_dir=None,
              max_frames: Optional[int] = None, device="cuda"):
    r"""Overlay the predicted mesh on the camera view (evaluate.py:316-370).

    Skins every frame in one FK call on the body model's device (without
    ``model``: ``default_body_model(device)``), copies the vertices to the
    host once, and renders frame by frame. Returns the rendered frames;
    writes ``result.mp4`` when imageio/cv2 is available and ``save_dir``
    given.
    """
    model = model or default_body_model(device)
    _, seq = _camera_sequence(dataset, seq_idx, cam_idx)
    pose, tran = run_single_view(params, model, seq, run_smplify=run_smplify)
    if max_frames:
        pose, tran = pose[:max_frames], tran[:max_frames]

    from ..viz.render import Renderer
    render = Renderer(resolution=(1920, 1080), model=model)
    verts = model.forward_kinematics(
        model._on_device(pose), tran=model._on_device(tran),
        calc_mesh=True)[2].cpu().numpy()
    frames = [render.render(None, v, seq.cam_K) for v in verts]
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        _write_video(frames, os.path.join(save_dir, "result.mp4"))
    return frames


def _write_video(frames, path, fps=30):
    r"""Write frames as a video: imageio (ffmpeg) -> cv2 -> raw .npy."""
    try:
        import imageio.v2 as imageio
        imageio.mimwrite(path, frames, fps=fps)
        return path
    except Exception:
        pass
    try:
        import cv2
        h, w = frames[0].shape[:2]
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 fps, (w, h))
        if not writer.isOpened():
            raise RuntimeError("cv2.VideoWriter failed to open")
        for f in frames:
            writer.write(np.asarray(f)[..., ::-1])  # RGB -> BGR
        writer.release()
        return path
    except Exception:
        np.save(path + ".npy", np.stack(frames[:32]))
        return path + ".npy"


def view_aist_unity(seq_idx: int = 0, cam_idx: int = 0, params=None,
                    model=None, dataset=None, out_dir=None, device="cuda"):
    r"""Export the prediction as Unity LoadMotion() text files
    (evaluate.py:373-415): live-mode flags, pose/translation de-rotated to
    world by Tcw^T and zeroed at the first frame. Runs on the body model's
    device (without ``model``: ``default_body_model(device)``)."""
    model = model or default_body_model(device)
    dataset, seq = _camera_sequence(dataset, seq_idx, cam_idx)
    pose, tran = run_single_view(params, model, seq,
                                 cfg=SigMPConfig.live_mode(),
                                 run_smplify=False)
    Tcw = _to_np(dataset["cam_T"][seq_idx][cam_idx])
    R = Tcw[:3, :3]
    pose[:, 0] = np.einsum("ji,tjk->tik", R, pose[:, 0])
    tran = tran @ R + Tcw[:3, 3]
    tran = tran - tran[:1]
    out_dir = out_dir or os.path.join(
        paths.temp_dir, f"aist_{seq_idx}_{cam_idx}_unity", "0")
    model.save_unity_motion(pose, tran, out_dir)
    return out_dir

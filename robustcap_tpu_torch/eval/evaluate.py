r"""Offline dataset evaluation with the reference's ``evaluate.py`` API
(port of ``robustcap_tpu/eval/evaluate.py``).

``evaluate_{aist,tc,pw3d}_ours`` and ``cal_mpjpe`` keep the reference's
names and results. Inference runs bucketed and batched (``runner.py``);
MPJPE and PVE come from the H36M-regressed 14 joints and the mesh of one
whole sequence at once on the body model's device, PA-MPJPE from a float64
Procrustes on the host. Results are cached to ``result.pt`` (AIST,
TotalCapture: ``[pose_p, pose_t, tran_p, tran_t]``) or ``result2.pt``
(3DPW: ``[pose_p, tran_p]``) as lists of float32 tensors, the layouts the
reference and the JAX package write, so each reads the others' caches.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from ..config import SigMPConfig, paths
from ..device import resolve_device
from ..ops.procrustes import reconstruction_error_np
from ..smpl.model import ParametricModel
from .datasets import (build_aist_sequences, build_pw3d_sequences,
                       build_tc_sequences, load_torch_file)
from .evaluator import PositionErrorEvaluator
from .runner import run_sequences

__all__ = ["cal_mpjpe", "evaluate_aist_ours", "evaluate_tc_ours",
           "evaluate_pw3d_ours", "evaluate_sequences"]


def _default_model(device):
    return ParametricModel(paths.smpl_file, device=device)


def _j_regressor(model: ParametricModel) -> torch.Tensor:
    r"""The H36M 14-joint regressor, on the model's device. Without the
    asset the body model's own first 14 regressor rows stand in, with a
    warning: MPJPE over those joints is not comparable to published
    H36M-regressed numbers."""
    path = paths.j_regressor_file
    if os.path.exists(path):
        return torch.as_tensor(np.load(path).astype(np.float32)[:14],
                               device=model.device)
    warnings.warn(
        f"H36M joint regressor not found at {path}; falling back to the "
        "body model's own first 14 regressor rows. MPJPE/PA-MPJPE computed "
        "this way are NOT comparable to published H36M-regressed numbers — "
        "install J_regressor_h36m.npy for metric parity.", stacklevel=3)
    return model._J_regressor[:14]


def cal_mpjpe(pose, gt_pose, cal_pampjpe: bool = False,
              model: ParametricModel = None, device="cuda"):
    r"""``[mpjpe, pve]`` (and ``pa-mpjpe`` with ``cal_pampjpe``) of one
    sequence in metres, as a float32 numpy array. ``model`` defaults to the
    SMPL asset (the procedural body without it) on ``device``."""
    model = model or _default_model(resolve_device(device))
    return _mpjpe(model, _j_regressor(model), pose, gt_pose, cal_pampjpe)


def _mpjpe(model, jreg, pose, gt_pose, cal_pampjpe):
    def as_pose(x):
        return torch.as_tensor(np.asarray(x, np.float32),
                               device=model.device).reshape(-1, 24, 3, 3)

    _, _, vert_p = model.forward_kinematics(as_pose(pose), calc_mesh=True)
    _, _, vert_t = model.forward_kinematics(as_pose(gt_pose), calc_mesh=True)
    kp_p = torch.einsum("jv,tvc->tjc", jreg, vert_p)
    kp_t = torch.einsum("jv,tvc->tjc", jreg, vert_t)
    kp_p = kp_p - kp_p[:, :1]
    kp_t = kp_t - kp_t[:, :1]
    mpjpe = torch.linalg.vector_norm(kp_p - kp_t, dim=2).mean()
    pve = torch.linalg.vector_norm(vert_p - vert_t, dim=2).mean()
    out = [float(mpjpe), float(pve)]
    if cal_pampjpe:
        # float64 on the host: a float32 SVD carries ~1 mm of noise
        out.append(float(reconstruction_error_np(kp_p.cpu().numpy(),
                                                 kp_t.cpu().numpy())))
    return np.asarray(out, np.float32)


def _load_cache(path):
    loaded = torch.load(path, map_location="cpu", weights_only=False)
    if len(loaded) == 2:
        pose_p, tran_p = loaded
    else:
        pose_p, _, tran_p, _ = loaded
    return ([np.asarray(p, np.float32) for p in pose_p],
            [np.asarray(t, np.float32) for t in tran_p])


def _save_cache(path, cache_format, seqs, pose_p, tran_p):
    def tensors(arrs):
        # tensors, not numpy: the reference applies tensor methods to the
        # loaded entries
        return [torch.from_numpy(np.ascontiguousarray(a, np.float32))
                for a in arrs]

    os.makedirs(os.path.dirname(path), exist_ok=True)
    if cache_format == "result2":
        torch.save([tensors(pose_p), tensors(tran_p)], path)
    else:
        torch.save([tensors(pose_p), tensors([s.pose_gt for s in seqs]),
                    tensors(tran_p), tensors([s.tran_gt for s in seqs])],
                   path)


def evaluate_sequences(seqs, params=None, model=None, cfg=SigMPConfig(),
                       first_tran_mode="gt", run_smplify=False,
                       cache_path=None, pad_to_multiple=128, max_bucket=32,
                       extended_metrics=False, cache_format="result4",
                       device="cuda"):
    r"""The shared pipeline: run the net (or load ``cache_path``), score.

    Returns the per-sequence arrays (``pose_p``, ``tran_p``, ``pose_t``,
    ``tran_t``, ``errors [n, 3]``, ``tran_errors``, ``valid``) and the
    means over valid sequences (``mpjpe``, ``pve``, ``pampjpe``,
    ``tran_error``, in metres); ``extended_metrics`` adds the
    :class:`~.evaluator.FullMotionEvaluator` battery as ``full_motion``
    ``[11, 2]``. A cache in either layout is read; a new one is written
    in ``cache_format`` (``"result4"`` or ``"result2"``). Params and model
    must already be on ``device``. SMPLify refinement is not ported yet:
    ``run_smplify=True`` raises."""
    if run_smplify:
        raise NotImplementedError(
            "run_smplify: the SMPLify refinement is not ported yet "
            "(ROADMAP A10); pass run_smplify=False")
    dev = resolve_device(device)
    model = model or _default_model(dev)
    if cache_path is not None and os.path.exists(cache_path):
        pose_p, tran_p = _load_cache(cache_path)
    else:
        if params is None:
            raise ValueError("params are required when there is no cached "
                             "result")
        results = run_sequences(params, model, cfg, seqs, first_tran_mode,
                                max_bucket=max_bucket,
                                pad_to_multiple=pad_to_multiple, device=dev)
        pose_p = [r[0] for r in results]
        tran_p = [r[1] for r in results]
        if cache_path is not None:
            _save_cache(cache_path, cache_format, seqs, pose_p, tran_p)
    pose_t = [s.pose_gt for s in seqs]
    tran_t = [s.tran_gt for s in seqs]
    jreg = _j_regressor(model)
    errors = np.stack([_mpjpe(model, jreg, p, t, True)
                       for p, t in zip(pose_p, pose_t)])
    valid = np.asarray([s.valid for s in seqs])
    tran_eval = PositionErrorEvaluator()
    tran_err = np.asarray([float(tran_eval(p, t))
                           for p, t in zip(tran_p, tran_t)])
    out = {
        "pose_p": pose_p, "tran_p": tran_p,
        "pose_t": pose_t, "tran_t": tran_t,
        "errors": errors, "tran_errors": tran_err, "valid": valid,
        "mpjpe": float(errors[valid, 0].mean()),
        "pve": float(errors[valid, 1].mean()),
        "pampjpe": float(errors[valid, 2].mean()),
        "tran_error": float(tran_err[valid].mean()),
    }
    if extended_metrics:
        from .evaluator import FullMotionEvaluator
        fme = FullMotionEvaluator(model=model)
        out["full_motion"] = np.stack([
            fme(pose_p[i], pose_t[i], tran_p=tran_p[i],
                tran_t=tran_t[i]).cpu().numpy()
            for i in range(len(seqs)) if valid[i]]).mean(axis=0)
    return out


def _report(out, tran=True):
    print("mpjpe, pve, pampjpe:", out["mpjpe"], out["pve"], out["pampjpe"])
    if tran:
        print("absolute root position error:", out["tran_error"])


def evaluate_aist_ours(run_smplify: bool = True, params=None, model=None,
                       dataset=None, use_cache: bool = True, device="cuda"):
    r"""AIST++: 9 cameras, ground-truth first translation, the
    ``not_aligned.txt`` views skipped; MPJPE/PVE/PA-MPJPE and the absolute
    root position error."""
    if dataset is None:
        dataset = load_torch_file(os.path.join(paths.aist_dir, "test.pt"))
    na_file = os.path.join(paths.aist_dir, "not_aligned.txt")
    not_aligned = []
    if os.path.exists(na_file):
        with open(na_file) as f:
            not_aligned = [line.strip() for line in f]
    seqs = build_aist_sequences(dataset, not_aligned)
    cache = (os.path.join(paths.aist_dir, "result.pt") if use_cache
             else None)
    out = evaluate_sequences(seqs, params, model, SigMPConfig(),
                             first_tran_mode="gt", run_smplify=run_smplify,
                             cache_path=cache, device=device)
    _report(out)
    return out


def evaluate_tc_ours(run_smplify: bool = True, params=None, model=None,
                     dataset=None, use_cache: bool = True, device="cuda"):
    r"""TotalCapture: real IMUs, 8 cameras, first-frame seeding; the root
    position error after aligning the last frames."""
    if dataset is None:
        dataset = load_torch_file(
            os.path.join(paths.totalcapture_dir, "test.pt"))
    seqs = build_tc_sequences(dataset)
    cache = (os.path.join(paths.totalcapture_dir, "result.pt")
             if use_cache else None)
    out = evaluate_sequences(seqs, params, model, SigMPConfig(),
                             first_tran_mode="first_frame",
                             run_smplify=run_smplify, cache_path=cache,
                             device=device)
    tran_eval = PositionErrorEvaluator()
    errs = []
    for p, t in zip(out["tran_p"], out["tran_t"]):
        errs.append(float(tran_eval(p + (t[-1] - p[-1]), t)))
    out["tran_error"] = float(np.mean(errs))
    _report(out)
    return out


def evaluate_pw3d_ours(run_smplify: bool = True, occ: bool = False,
                       params=None, model=None, dataset=None,
                       use_cache: bool = True, device="cuda"):
    r"""3DPW / 3DPW-OCC: camera-frame data, the flat floor off, per-frame
    gravity."""
    if dataset is None:
        name = "test_occ.pt" if occ else "test.pt"
        dataset = load_torch_file(os.path.join(paths.pw3d_dir, name))
    seqs = build_pw3d_sequences(dataset)
    cache_name = "result_occ2.pt" if occ else "result2.pt"
    cache = (os.path.join(paths.pw3d_dir, cache_name) if use_cache
             else None)
    out = evaluate_sequences(seqs, params, model,
                             SigMPConfig(use_flat_floor=False),
                             first_tran_mode="gt", run_smplify=run_smplify,
                             cache_path=cache, cache_format="result2",
                             device=device)
    _report(out, tran=False)
    return out

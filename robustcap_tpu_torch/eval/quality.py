r"""The quality contract of the serve kernel's reduced-precision modes
(port of ``robustcap_tpu/eval/quality.py``).

The bf16 and int8-gate modes are approximate, so their contract is a
bounded change of the end metrics (MPJPE, PVE, PA-MPJPE) through the real
evaluation, not agreement bit for bit: each must stay within
``END_METRIC_BOUND_MM`` of float32 on the fixture corpus.
"""

from __future__ import annotations

import os
import tempfile

import torch

from ..config import SigMPConfig
from ..models import sig_mp
from ..nn.rnn import cast_params, quantize_params
from ..preprocess import build_fixture_dataset
from .datasets import build_aist_sequences
from .evaluate import evaluate_sequences

__all__ = ["END_METRIC_BOUND_MM", "serve_end_metric_deltas"]

# the largest change of MPJPE, PVE or PA-MPJPE a serving mode may cause
END_METRIC_BOUND_MM = 2.0


def serve_end_metric_deltas(params, model, eval_frames: int = 64,
                            n_seq: int = 1, n_cam: int = 2,
                            modes=("int8",), seed: int = 5, device="cuda"):
    r"""MPJPE/PVE/PA-MPJPE changes (mm) of the serve kernel's modes from the
    float32 plain step, on a fixture corpus of ``n_seq`` motions seen by
    ``n_cam`` cameras, ``eval_frames`` frames each.

    Both sides run the single-stream ``forward_offline`` (the batched path
    runs no kernel): float32 with ``SigMPConfig()``, each mode with
    ``SigMPConfig(pallas_serve=True)``, one serve launch per sequence on the
    card. The trajectories are scored by ``evaluate_sequences`` through its
    ``result2`` cache branch, so the metric code and the corpus are the
    same and only the forward program differs.

    ``modes``: any of ``"bf16"`` (``cast_params`` to bf16) and ``"int8"``
    (``quantize_params`` with ``int8_compute``). Returns ``{"f32_mm":
    {...}, "pallas_serve_<mode>_delta_mm": {...}}`` in millimetres. Params
    and model must already be on ``device``."""
    ds = build_fixture_dataset(model, n_seq=n_seq, T=eval_frames,
                               n_cam=n_cam, seed=seed)
    seqs = build_aist_sequences(ds, num_cameras=n_cam)

    def run_and_score(p, cfg):
        pose_p, tran_p = [], []
        for s in seqs:
            pose, tran = sig_mp.forward_offline(
                p, model, cfg, s.j2dc, s.accc, s.oric,
                first_tran=s.first_tran, first_frame=s.first_frame,
                gravityc=s.gravityc, device=device)
            pose_p.append(pose.float().cpu())
            tran_p.append(tran.float().cpu())
        with tempfile.TemporaryDirectory() as td:
            cache = os.path.join(td, "result2.pt")
            torch.save([pose_p, tran_p], cache)
            out = evaluate_sequences(seqs, model=model, cache_path=cache,
                                     pad_to_multiple=eval_frames,
                                     device=device)
        return {k: float(out[k]) for k in ("mpjpe", "pve", "pampjpe")}

    m_f = run_and_score(params, SigMPConfig())
    res = {"f32_mm": {k: round(v * 1e3, 3) for k, v in m_f.items()}}
    for mode in modes:
        if mode == "bf16":
            m = run_and_score(cast_params(params, torch.bfloat16),
                              SigMPConfig(pallas_serve=True))
        elif mode == "int8":
            m = run_and_score(quantize_params(params),
                              SigMPConfig(pallas_serve=True,
                                          int8_compute=True))
        else:
            raise ValueError(f"unknown serve mode {mode!r}")
        res[f"pallas_serve_{mode}_delta_mm"] = {
            k: round((m[k] - m_f[k]) * 1e3, 4) for k in m_f}
    return res

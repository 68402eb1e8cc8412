r"""The batched offline runner (port of ``robustcap_tpu/eval/runner.py``):
sequences grouped into buckets of one padded length, each bucket one
``forward_offline_batched`` run of B rows, outputs cut back to each
sequence's length."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import SigMPConfig
from ..device import resolve_device
from ..models import sig_mp
from ..nn.rnn import prepare_scan_params
from .datasets import EvalSequence, bucket_sequences

__all__ = ["run_sequences", "stack_frames"]


def stack_frames(seqs: List[EvalSequence], pad_len: int,
                 first_tran_mode: str = "gt") -> Dict[str, torch.Tensor]:
    r"""EvalSequences as one padded ``[B, pad_len, ...]`` frame dict (CPU
    tensors). A sequence's padding repeats its last frame, so the padded
    steps see sane keypoints and orientations; their outputs are
    discarded. ``first_tran_mode="gt"`` seeds frame 0 with the sequence's
    ground-truth first translation where it has one, ``"first_frame"``
    (or a sequence's own ``first_frame``) marks frame 0 a first frame."""
    B = len(seqs)
    out = {
        "j2dc": np.zeros((B, pad_len, 33, 3), np.float32),
        "accc": np.zeros((B, pad_len, 6, 3), np.float32),
        "oric": np.tile(np.eye(3, dtype=np.float32), (B, pad_len, 6, 1, 1)),
        "first_tran": np.zeros((B, pad_len, 3), np.float32),
        "first_tran_valid": np.zeros((B, pad_len), bool),
        "first_frame": np.zeros((B, pad_len), bool),
        "gravityc": np.zeros((B, pad_len, 3), np.float32),
    }
    for b, s in enumerate(seqs):
        T = s.length
        for k, v in (("j2dc", s.j2dc), ("accc", s.accc), ("oric", s.oric),
                     ("gravityc", s.gravityc)):
            out[k][b, :T] = v
            out[k][b, T:] = v[-1]
        if first_tran_mode == "gt" and s.first_tran is not None:
            out["first_tran"][b, 0] = s.first_tran
            out["first_tran_valid"][b, 0] = True
        elif first_tran_mode == "first_frame" or s.first_frame:
            out["first_frame"][b, 0] = True
    return {k: torch.from_numpy(v) for k, v in out.items()}


def run_sequences(params, body_model, cfg: SigMPConfig,
                  seqs: List[EvalSequence], first_tran_mode: str = "gt",
                  max_bucket: int = 32, pad_to_multiple: int = 128,
                  device="cuda") -> List[Tuple[np.ndarray, np.ndarray]]:
    r"""The fusion net over every sequence, bucket by bucket; returns each
    sequence's ``(pose [T, 24, 3, 3], tran [T, 3])`` as numpy arrays, cut
    to its length, in input order. Params and body model must already be
    on ``device``. A bucket runs up to its longest sequence, and every
    bucket is queued on the device before the first result is read
    back."""
    dev = resolve_device(device)
    params = prepare_scan_params(params, cfg.int8_compute)
    pending = []
    for indices, pad_len in bucket_sequences(seqs, max_bucket,
                                             pad_to_multiple):
        batch = [seqs[i] for i in indices]
        frames = stack_frames(batch, pad_len, first_tran_mode)
        pending.append((indices, sig_mp.forward_offline_batched(
            params, body_model, cfg, frames,
            lengths=[s.length for s in batch], device=dev)))
    results: List = [None] * len(seqs)
    for indices, (pose, tran) in pending:
        pose, tran = pose.cpu().numpy(), tran.cpu().numpy()
        for k, i in enumerate(indices):
            T = seqs[i].length
            results[i] = (pose[k, :T], tran[k, :T])
    return results

r"""The batched offline runner (port of ``robustcap_tpu/eval/runner.py``):
sequences grouped into buckets of one padded length, each bucket one run of
the batched step (``sig_mp.make_batched_step``, built from the caller's
``cfg`` as the JAX runner builds its vmapped step) over B rows, outputs cut
back to each sequence's length; with a data mesh each rank runs its rows of
every bucket."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import trace
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
                  device="cuda", mesh=None
                  ) -> List[Tuple[np.ndarray, np.ndarray]]:
    r"""The fusion net over every sequence, bucket by bucket; returns each
    sequence's ``(pose [T, 24, 3, 3], tran [T, 3])`` as numpy arrays, cut
    to its length, in input order. Params and body model must already be
    on ``device``. A bucket runs up to its longest sequence, and every
    bucket is queued on the device before the first result is read
    back. With ``cfg.pallas_tail`` each tail of each frame-step is one call
    of the operator ``robustcap::geometry_tail`` over the bucket's rows (one
    kernel launch on the card, two a frame-step with the vision updater);
    the other ``pallas_*`` flags are not read.

    With ``mesh`` (``parallel.make_mesh``; ``device`` is then the mesh's)
    a bucket is padded by repeating its last sequence until the ranks
    divide it, each rank runs its rows, and every rank gathers and returns
    the whole list."""
    with trace.span("runner"):
        dev = mesh.device if mesh is not None else resolve_device(device)
        params = prepare_scan_params(params, cfg.int8_compute)
        step = sig_mp.make_batched_step(body_model, cfg)
        pending = []
        for indices, pad_len in bucket_sequences(seqs, max_bucket,
                                                 pad_to_multiple):
            batch = [seqs[i] for i in indices]
            if mesh is not None:
                batch += [batch[-1]] * (-len(batch) % mesh.size)
                batch = batch[mesh.rows(len(batch))]
            with trace.span("runner.stack"):
                frames = stack_frames(batch, pad_len, first_tran_mode)
            pending.append((indices, sig_mp._offline_batched(
                step, params, body_model, cfg.int8_compute, frames,
                [s.length for s in batch], dev)))
        results: List = [None] * len(seqs)
        for indices, (pose, tran) in pending:
            if mesh is not None:
                pose, tran = mesh.gather(pose), mesh.gather(tran)
            with trace.span("runner.readback"):
                pose, tran = pose.cpu().numpy(), tran.cpu().numpy()
            for k, i in enumerate(indices):
                T = seqs[i].length
                results[i] = (pose[k, :T], tran[k, :T])
        return results

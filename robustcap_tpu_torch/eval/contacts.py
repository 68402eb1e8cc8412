r"""Foot-contact classification (port of ``robustcap_tpu/eval/contacts.py``):
ground-truth contacts from the feet's speed, the net's contact head through
``forward_offline``, and their precision, recall and F1."""

from __future__ import annotations

from typing import List

import numpy as np

from ..config import SigMPConfig
from ..models import sig_mp
from .datasets import EvalSequence
from .evaluator import BinaryClassificationErrorEvaluator

__all__ = ["contact_labels_from_joints", "evaluate_contacts"]


def contact_labels_from_joints(joint3d: np.ndarray,
                               threshold: float = 0.25) -> np.ndarray:
    r"""Feet (joints 10 and 11) slower than ``threshold`` m/s are in
    contact: ``[T, 24, 3]`` -> ``[T, 2]`` in {0, 1}."""
    j = np.asarray(joint3d)
    v = (j[2:] - j[:-2]) * 30.0
    c = (np.linalg.norm(v[:, 10:12], axis=2) < threshold).astype(np.float32)
    return np.concatenate([c[:1], c, c[-1:]])


def evaluate_contacts(params, model, seqs: List[EvalSequence],
                      gt_contacts: List[np.ndarray],
                      cfg: SigMPConfig = SigMPConfig(),
                      probability_threshold: float = 0.5, device="cuda"):
    r"""The contact head over every sequence, scored against
    ``gt_contacts``: ``{"prf": [3, 2] precision/recall/F1 of the positive
    and negative samples, "accuracy": float}``."""
    preds, gts = [], []
    for s, gt in zip(seqs, gt_contacts):
        _, _, contact = sig_mp.forward_offline(
            params, model, cfg, s.j2dc, s.accc, s.oric,
            first_tran=s.first_tran, first_frame=s.first_frame,
            gravityc=s.gravityc, return_contacts=True, device=device)
        contact = contact.cpu().numpy()
        preds.append(contact)
        gts.append(np.asarray(gt, np.float32)[:len(contact)])
    p = np.concatenate(preds).reshape(-1)
    t = np.concatenate(gts).reshape(-1)
    ev = BinaryClassificationErrorEvaluator(is_after_sigmoid=True)
    prf = ev(p, t).cpu().numpy()
    acc = float(((p > probability_threshold) == (t > 0.5)).mean())
    return {"prf": prf, "accuracy": acc}

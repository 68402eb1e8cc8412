r"""The one traffic generator: seeded synthetic capture sequences from a
traffic file's parameters.

A sequence is what one camera and six body-worn IMUs record of one subject:
per frame 33 keypoints (x, y in the unit square, and the frame's detection
confidence), six accelerations and six orientations. Its confidence follows
the parameters' ``confidence``: the listed values in equal shares, in an
order drawn from the seed, with an occluded run at a third of the sequence
(``occluded_frames`` frames at ``occluded_value``), so that every band of
the confidence gate and the occluded-frame refeed are taken. Each
sequence's start follows ``seeding`` in turn: ``tran`` (a known first
translation, as AIST++ and 3DPW are evaluated), ``first_frame`` (the first
frame seeds the translation, as TotalCapture is) or ``none`` (the
translation starts at the camera's centre).

The lengths are a fixed set, evenly spaced over ``lengths`` (both ends
included), in an order drawn from the seed: every seed gives the same work
in another order. Everything is drawn on the device and handed over as
numpy arrays, as a user's recorded data would be.
"""

from __future__ import annotations

import numpy as np
import torch

from .inputs import generator
from .reference.sigmp import r6d_to_rotation

__all__ = ["Pool", "lengths", "make_pool"]


def lengths(lo: int, hi: int, n: int, perm: torch.Generator) -> np.ndarray:
    r"""``n`` lengths evenly spaced over ``[lo, hi]``, in a seeded order."""
    base = np.rint(np.linspace(lo, hi, n)).astype(np.int64)
    order = torch.randperm(n, generator=perm, device=perm.device).cpu()
    return base[order.numpy()]


class Pool:
    r"""``n`` sequences end to end: ``j2dc [F, 33, 3]``, ``accc [F, 6, 3]``,
    ``oric [F, 6, 3, 3]`` float32 numpy arrays over all ``F`` frames, each
    frame's confidence ``conf [F]`` (the mean over its keypoints, as the
    step reads it), ``offsets [n + 1]``, ``lengths [n]``, and each
    sequence's seeding (``first_tran [n, 3]``, ``tran_valid [n]``,
    ``first_frame [n]``)."""

    def __init__(self, j2dc, accc, oric, lens, first_tran, tran_valid,
                 first_frame):
        self.j2dc, self.accc, self.oric = j2dc, accc, oric
        self.conf = j2dc[:, :, 2].mean(1)
        self.lengths = lens
        self.offsets = np.concatenate([[0], np.cumsum(lens)])
        self.first_tran = first_tran
        self.tran_valid = tran_valid
        self.first_frame = first_frame

    def __len__(self):
        return len(self.lengths)

    def frames(self, i):
        r"""Sequence ``i``'s ``(j2dc, accc, oric)`` (views)."""
        a, b = self.offsets[i], self.offsets[i + 1]
        return self.j2dc[a:b], self.accc[a:b], self.oric[a:b]

    def seeding(self, i):
        r"""``(first_tran or None, first_frame)`` of sequence ``i``."""
        return (self.first_tran[i] if self.tran_valid[i] else None,
                bool(self.first_frame[i]))

    def padded(self, ids):
        r"""Sequences ``ids`` as ``[B, T, ...]`` arrays padded to the
        longest (a row's padding repeats its last frame) with their seeding
        on frame 0, the frame dict the reference runs."""
        T = int(max(self.lengths[i] for i in ids))
        B = len(ids)
        out = {"j2dc": np.empty((B, T, 33, 3), np.float32),
               "accc": np.empty((B, T, 6, 3), np.float32),
               "oric": np.empty((B, T, 6, 3, 3), np.float32)}
        for b, i in enumerate(ids):
            for k, v in zip(("j2dc", "accc", "oric"), self.frames(i)):
                out[k][b, :len(v)] = v
                out[k][b, len(v):] = v[-1]
        out["first_tran"] = np.zeros((B, T, 3), np.float32)
        out["first_tran_valid"] = np.zeros((B, T), bool)
        out["first_frame"] = np.zeros((B, T), bool)
        for b, i in enumerate(ids):
            out["first_tran"][b] = self.first_tran[i]
            out["first_tran_valid"][b, 0] = self.tran_valid[i]
            out["first_frame"][b, 0] = self.first_frame[i]
        return out


def _confidence(lens, conf, g, dev):
    r"""Each frame's confidence: the values in equal shares, shuffled within
    each sequence, and the occluded run."""
    values = torch.tensor(conf["values"], dtype=torch.float32, device=dev)
    F = int(sum(lens))
    keys = torch.rand(F, generator=g, device=dev)
    out = torch.empty(F, device=dev)
    off = 0
    for n in lens:
        n = int(n)
        order = keys[off:off + n].argsort()
        out[off + order] = values[torch.arange(n, device=dev) % len(values)]
        a = off + n // 3
        out[a:min(a + conf["occluded_frames"], off + n)] = \
            conf["occluded_value"]
        off += n
    return out


def make_pool(traffic, n: int, seed: int, device) -> Pool:
    r"""``n`` sequences of the traffic file ``traffic`` for ``seed``: the
    lengths from ``traffic["lengths"]``, the confidence from
    ``traffic["confidence"]``, the seeding from ``traffic["seeding"]`` and
    ``traffic["first_tran"]``."""
    g = generator(seed, "traffic", device)
    lens = lengths(*traffic["lengths"], n, g)
    F = int(lens.sum())
    c = _confidence(lens, traffic["confidence"], g, device)
    j2dc = 0.2 + 0.7 * torch.rand((F, 33, 3), generator=g, device=device)
    j2dc[:, :, 2] = c[:, None]
    accc = torch.randn((F, 6, 3), generator=g, device=device)
    oric = r6d_to_rotation(torch.randn((F, 6, 6), generator=g,
                                       device=device))
    kinds = [traffic["seeding"][i % len(traffic["seeding"])]
             for i in range(len(lens))]
    tran = np.tile(np.asarray(traffic["first_tran"], np.float32),
                   (len(lens), 1))
    return Pool(j2dc.cpu().numpy(), accc.cpu().numpy(), oric.cpu().numpy(),
                lens, tran, np.array([k == "tran" for k in kinds]),
                np.array([k == "first_frame" for k in kinds]))

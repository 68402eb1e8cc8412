r"""The comparison that decides ``correct``: the program's outputs against
the reference's, frame by frame, over every valid frame of the sampled
sequences.

Five numbers; a cell holds those that separate its program's readings from
its control's, each to its own limit (``portbench/limits/<cell>.json``):

* ``pose_median``: the median over frames of a frame's largest gap between
  rotation-matrix entries. Every frame's pose comes out of a Gram-Schmidt
  of the rnn7 head and a product with the parent's rotation, so a precision
  lost anywhere in the six stacks shows in most frames, and this median
  moves with it while single chaotic frames do not.
* ``pose_max``: the largest such gap over all frames: one frame's answer
  altered shows here. A frame whose rnn7 head is near the Gram-Schmidt's
  degenerate case (its two 6D columns within a degree) turns rounding into
  a gap of 1e-2 or more, ever rarer as the gap grows, so in a cell that
  compares many frames this number has a long tail of sound readings.
* ``pose_p999``: the 99.9th percentile of the frames' gaps: an answer
  altered on a tenth of a percent of the frames compared (one frame-step
  of a batch, a few rows) shows here, and a few chaotic frames do not.
* ``tran_max``: the largest gap of the root translation (metres) over all
  frames. Translation integrates every frame's velocity and contact
  decisions, so a lasting change of meaning shows here; so does, in a
  float32 cell, a contact decision that rounding flipped, which is why not
  every cell holds it.
* ``tran_step_median``: the median over frames of the largest gap between
  the two sides' frame-to-frame translation steps (metres): whether each
  frame's velocity and contact step agree, untouched by an offset that an
  earlier flipped decision left.

A frame whose output is not finite, or a sequence that came back with the
wrong number of frames, reads infinity.
"""

from __future__ import annotations

import json
import os

import numpy as np

__all__ = ["NUMBERS", "pick", "reference_outputs", "gaps", "failed_part",
           "merge", "load_limits", "judge"]

NUMBERS = ("pose_median", "pose_p999", "pose_max", "tran_max",
           "tran_step_median")


def pick(ctx, ids, lengths):
    r"""The sample: the longest of ``ids`` (whose lengths ``lengths[i]``
    gives), then ``check_sequences - 1`` more drawn from the seed."""
    import torch
    from .inputs import generator
    ids = list(ids)
    longest = max(ids, key=lambda i: lengths[i])
    rest = [i for i in ids if i != longest]
    order = torch.randperm(len(rest), generator=generator(
        ctx.seed, "sample", "cpu")).tolist()
    return [longest] + [rest[j] for j in
                        order[:ctx.traffic["check_sequences"] - 1]]


def reference_outputs(ctx, inputs, seqs, dev, **kw):
    r"""The reference's ``(pose [B, T, 24, 3, 3], tran [B, T, 3])`` numpy
    arrays over pool sequences ``seqs`` (padded to the longest), with the
    weights and body of ``inputs``; a live session starts with a first
    frame and no known translation. ``kw`` goes to the reference's run."""
    import torch
    from . import program
    from .reference import sigmp
    t = ctx.traffic
    padded = inputs["pool"].padded(seqs)
    if t["mode"] == "live":
        padded["first_frame"][:, 0] = True
        padded["first_tran_valid"][:] = False
    frames = {k: torch.as_tensor(v, device=dev) for k, v in padded.items()}
    frames["gravityc"] = torch.as_tensor(t["gravity"], device=dev).expand(
        frames["j2dc"].shape[0], frames["j2dc"].shape[1], 3)
    cfg, consts = program.reference(ctx, inputs["body"])
    pose, tran = sigmp.run(inputs["bank"], consts, cfg, frames, **kw)
    return pose.cpu().numpy(), tran.cpu().numpy()


def gaps(pose, tran, pose_ref, tran_ref):
    r"""One sequence's gaps, ``pose [T, 24, 3, 3]`` and ``tran [T, 3]``
    against the reference's, frame by frame, for :func:`merge` to pool."""
    pose, tran = np.asarray(pose, np.float64), np.asarray(tran, np.float64)
    pose_ref = np.asarray(pose_ref, np.float64)
    tran_ref = np.asarray(tran_ref, np.float64)
    if pose.shape != pose_ref.shape or tran.shape != tran_ref.shape:
        inf = np.full(max(len(pose_ref), 1), np.inf)
        return {"frames": inf, "tran": inf, "step": inf}
    per_frame = np.abs(pose - pose_ref).reshape(len(pose), -1).max(1)
    per_tran = np.abs(tran - tran_ref).max(1)
    bad = ~(np.isfinite(pose).reshape(len(pose), -1).all(1)
            & np.isfinite(tran).all(1))
    per_frame[bad] = np.inf
    per_tran[bad] = np.inf
    d = tran - tran_ref
    step = np.abs(np.diff(d, axis=0)).max(1) if len(d) > 1 else np.zeros(1)
    step[~np.isfinite(step)] = np.inf
    return {"frames": per_frame, "tran": per_tran, "step": step}


def failed_part():
    r"""What a call that failed adds: infinity everywhere."""
    inf = np.array([np.inf])
    return {"frames": inf, "tran": inf, "step": inf}


def merge(parts):
    r"""The numbers over the frames of every sequence compared."""
    if not parts:
        return {k: float("inf") for k in NUMBERS}
    frames = np.concatenate([p["frames"] for p in parts])
    tran = np.concatenate([p["tran"] for p in parts])
    step = np.concatenate([p["step"] for p in parts])
    return {"pose_median": float(np.median(frames)),
            "pose_p999": float(np.quantile(frames, 0.999)),
            "pose_max": float(frames.max()),
            "tran_max": float(tran.max()),
            "tran_step_median": float(np.median(step))}


def load_limits(root, cell):
    with open(os.path.join(root, "portbench", "limits", f"{cell}.json")) as f:
        return json.load(f)


def judge(numbers, limits):
    r"""``(correct, {name: {"value", "limit"}})`` over the numbers the
    cell holds: correct where each is at most its limit (a NaN is not)."""
    out = {k: {"value": numbers[k], "limit": limits["limits"][k]}
           for k in NUMBERS if k in limits["limits"]}
    ok = all(bool(v["value"] <= v["limit"]) for v in out.values())
    return ok, out

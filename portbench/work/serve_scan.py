r"""The serve kernel's work for one sequence of ``frames`` frames, the same
whatever implements it: what the plain step needs on the sequence's
inputs. Every frame through the six stacks once, the heads once more on
each of its ``refeeds`` refeed frames (:mod:`portbench.work.sigmp`), at
the served type's rate; the IMU re-init ``inits`` times, and the geometry
tail once a frame and once more a refeed frame, at the float32 rate; the
bank read once, each frame's inputs (33 keypoints, 6 accelerations and 6
orientations) read once, each frame's pose and translation written once,
and the tail's body constants read once.
"""

from __future__ import annotations

from . import geometry_tail, sigmp

__all__ = ["work", "bound_s"]

_PEAK = {"float32": "f32_flops", "bfloat16": "bf16_flops"}


def work(config, frames: int, refeeds: int = 0, inits: int = 1):
    r"""``(bytes, {peak key: operations})`` of one sequence."""
    stacks, dtype = config["stacks"], config["dtype"]
    blend = config["body"]["pose_blendshape"]
    ops = {_PEAK[dtype]: frames * sigmp.frame_flops(stacks)
           + refeeds * sigmp.refeed_flops(stacks)}
    ops["f32_flops"] = ops.get("f32_flops", 0) \
        + inits * sigmp.init_flops(stacks) \
        + (frames + refeeds) * geometry_tail.row_flops(blend)
    n_bytes = sigmp.weight_bytes(stacks, dtype) \
        + frames * 4 * (99 + 18 + 54) + frames * 4 * (216 + 3) \
        + geometry_tail.shared_bytes(blend)
    return n_bytes, ops


def bound_s(config, frames: int, peaks, refeeds: int = 0, inits: int = 1):
    r"""``(seconds, "bytes" or "operations")``: the least time the card
    could take for one sequence."""
    n_bytes, ops = work(config, frames, refeeds, inits)
    t_bytes = n_bytes / peaks["hbm_bytes_per_s"]
    t_ops = sum(n / peaks[k] for k, n in ops.items())
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

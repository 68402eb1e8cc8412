r"""The geometry tail's work for a launch over ``rows`` rows, the same
whatever implements it: each row's inputs read once (the rnn7/rnn8 heads,
the root rotation, velocity and visual position, the confidence and its
lerp weight, the first translation, gravity and the two first-frame
flags, and the carry it reads), each row's outputs written once (pose,
translation, contacts, feet, the floor ring, the landmarks, joints and the
two counters), and the body's constants read once (parent index, bones,
zero-pose joints, the 33 landmarks' skinning weights and rest positions
and, with pose blendshapes, their 3 x 207 blendshapes); about 8,000
operations a row for rotations, IK, FK and translation, and per landmark
a 24-joint blend and the 3 x 207 blendshape sums.
"""

from __future__ import annotations

__all__ = ["row_bytes", "shared_bytes", "row_flops", "bound_s", "needed_s"]

_F, _I, _B = 4, 4, 1


def row_bytes() -> int:
    frame = _F * (144 + 2 + 9 + 3 + 3 + 1 + 1 + 3 + 3) + 2 * _B
    carry = _F * (6 + 3 + 33 + 99) + 2 * _B + 2 * _I
    out = _F * (216 + 3 + 2 + 6 + 33 + 99 + 72 + 99) + 2 * _I
    return frame + carry + out


def shared_bytes(blendshape: bool) -> int:
    body = _I * 24 + _F * (72 + 72 + 33 * 24 + 33 * 3)
    return body + (_F * 3 * 207 * 33 if blendshape else 0)


def row_flops(blendshape: bool) -> int:
    return 8000 + 33 * (24 * 24 + (3 * 207 * 2 if blendshape else 0))


def bound_s(rows: int, blendshape: bool, peaks):
    r"""``(seconds, "bytes" or "operations")``: the least time a launch
    over ``rows`` rows could take on the card."""
    t_bytes = (rows * row_bytes() + shared_bytes(blendshape)) \
        / peaks["hbm_bytes_per_s"]
    t_ops = rows * row_flops(blendshape) / peaks["f32_flops"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def needed_s(launches, blendshape: bool, peaks) -> float:
    r"""The least time of the tail evaluations a step needs, ``launches``
    the rows of each (a launch of no rows is none)."""
    return sum(bound_s(n, blendshape, peaks)[0] for n in launches if n > 0)

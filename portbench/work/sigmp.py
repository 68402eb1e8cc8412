r"""The network's work, counted from the configuration's published widths:
the operations of the products of each stack (linear1, the two gate
products of each LSTM layer, linear2) and of the IMU re-init MLP, and the
bytes of the weights; and which frames of the traffic take the plain
step's extra work (the heads' re-run on a refeed frame, the re-init).
Nothing here reads the program.
"""

from __future__ import annotations

import numpy as np

__all__ = ["stack_flops", "frame_flops", "refeed_flops", "init_flops",
           "weight_bytes", "refeed_frames", "init_frame", "TYPE_BYTES",
           "REFEED_STACKS"]

TYPE_BYTES = {"float32": 4, "bfloat16": 2}

# the heads the plain step runs once more on a refeed frame: first on the
# inertial joints, for the landmarks that stand in for the occluded
# keypoints, then on the fused joints
REFEED_STACKS = ("rnn7", "rnn8")


def stack_flops(spec) -> int:
    r"""Multiply-adds times two of one frame through one stack: linear1
    ``in x H``, each layer's ``4H x H`` input and recurrent products, and
    linear2 ``H x out``."""
    i, o, h, L = spec["input"], spec["output"], spec["hidden"], spec["layers"]
    return 2 * (i * h + L * 2 * 4 * h * h + h * o)


def frame_flops(stacks) -> int:
    r"""One frame of the step: each of the six stacks once."""
    return sum(stack_flops(s) for s in stacks.values())


def refeed_flops(stacks) -> int:
    r"""What a refeed frame adds: the heads of :data:`REFEED_STACKS` once
    more."""
    return sum(stack_flops(stacks[n]) for n in REFEED_STACKS)


def init_flops(stacks) -> int:
    r"""One firing of the IMU re-init MLP (``out -> H -> L H -> 2 L H``)
    of every stack that has one."""
    total = 0
    for s in stacks.values():
        if s.get("init_net"):
            o, h, L = s["output"], s["hidden"], s["layers"]
            total += 2 * (o * h + h * L * h + L * h * 2 * L * h)
    return total


def refeed_frames(conf, flags, age=None) -> np.ndarray:
    r"""Which frames the plain step refeeds: a confidence at or below the
    gate's low end and, in live mode, only the frames that refresh the
    landmarks (``age``, the frames since the state was fresh, a multiple
    of ``update_vision_freq + 1``). ``flags``: the reference's mode
    flags."""
    out = np.asarray(conf) <= flags["conf_range"][0]
    if flags["live"]:
        out &= np.asarray(age) % (flags["update_vision_freq"] + 1) == 0
    return out


def init_frame(conf, flags) -> bool:
    r"""Whether a sequence's frames ``conf`` fire the IMU re-init: it
    fires on the first frame whose confidence reaches the gate's high
    end."""
    return bool((np.asarray(conf) >= flags["conf_range"][1]).any())


def _stack_params(spec) -> int:
    i, o, h, L = spec["input"], spec["output"], spec["hidden"], spec["layers"]
    n = i * h + h + L * (2 * 4 * h * h + 2 * 4 * h) + h * o + o
    if spec.get("init_net"):
        n += o * h + h + h * L * h + L * h + L * h * 2 * L * h + 2 * L * h
    return n


def weight_bytes(stacks, dtype) -> int:
    r"""Every weight and bias of the bank once, in the served type."""
    return TYPE_BYTES[dtype] * sum(_stack_params(s) for s in stacks.values())

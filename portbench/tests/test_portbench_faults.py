r"""A run of each cell on the CPU at small widths, past the harness's look
for a card, with the timed path broken underneath: ``correct`` has to come
out false for each fault the cell can have (a step that returns its state
unchanged; half of the batch left out, in the batched cells; an answer
altered where it is produced: every answer's root rotation, and one
frame in the cells that hold a largest gap), and true when nothing is
broken. The
cells run on one card, so no exchange between cards can be left out."""

import json
import os
import time

import pytest

from portbench import run
from portbench.harness import ROOT
from small import small_context

from robustcap_tpu_torch.models import sig_mp

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in SPEC["workloads"]]


def _traffic(cell):
    w = {x["name"]: x for x in SPEC["workloads"]}[cell]
    with open(os.path.join(ROOT, "portbench", "traffic",
                           w["traffic"] + ".json")) as f:
        return json.load(f)


def _holds(cell, number):
    with open(os.path.join(ROOT, "portbench", "limits",
                           cell + ".json")) as f:
        return number in json.load(f)["limits"]


# the cells whose step runs many rows at once, and those that hold a
# largest gap, where a single altered frame has to show
BATCHED = [c for c in CELLS if _traffic(c)["entry"] != "sequences"]
FRAME = [c for c in CELLS if _holds(c, "pose_max") or _holds(c, "tran_max")]


def _run(cell, seconds=0.3):
    res, forbidden, _, _ = run.run(small_context(cell, seconds=seconds),
                                time.perf_counter(), device="cpu")
    assert forbidden == []
    return res


def _state_unchanged(monkeypatch):
    def wrap(make):
        def made(*a, **k):
            step = make(*a, **k)
            return lambda params, carry, frame: (
                carry, step(params, carry, frame)[1])
        return made
    monkeypatch.setattr(sig_mp, "step_from_constants",
                        wrap(sig_mp.step_from_constants))
    monkeypatch.setattr(sig_mp, "make_batched_step",
                        wrap(sig_mp.make_batched_step))


def _half_batch(monkeypatch):
    make = sig_mp.make_batched_step

    def made(*a, **k):
        step = make(*a, **k)

        def half(params, carry, frame):
            carry, (pose, tran) = step(params, carry, frame)
            h = pose.shape[0] // 2
            pose, tran = pose.clone(), tran.clone()
            pose[h:2 * h], tran[h:2 * h] = pose[:h], tran[:h]
            return carry, (pose, tran)
        return half
    monkeypatch.setattr(sig_mp, "make_batched_step", made)


def _alter(monkeypatch, change):
    r"""``change(pose, tran, rows)`` applied to every answer where the
    program produces it: the offline entry's outputs (``rows`` False: a
    sequence's frames), the batched step's (``rows`` True: a step's
    rows)."""
    forward, make = sig_mp.forward_offline, sig_mp.make_batched_step

    def fwd(*a, **k):
        return change(*forward(*a, **k), False)

    def made(*a, **k):
        step = make(*a, **k)

        def altered(params, carry, frame):
            carry, out = step(params, carry, frame)
            return carry, change(*out, True)
        return altered
    monkeypatch.setattr(sig_mp, "forward_offline", fwd)
    monkeypatch.setattr(sig_mp, "make_batched_step", made)


def _altered_answer(monkeypatch):
    # every frame's root rotation off by 0.05 in one entry
    def change(pose, tran, rows):
        pose = pose.clone()
        pose[..., 0, 0, 0] += 0.05
        return pose, tran
    _alter(monkeypatch, change)


def _altered_frame(monkeypatch):
    # one frame's answer off, a joint rotation entry by 0.5 and the
    # translation by 5 cm: the first frame of the fifth sequence answered
    # (the second of the window), or one frame-step of every row in the
    # twelfth step answered (so that some row's frame lies in a session
    # the window completes)
    calls = {"n": 0}

    def change(pose, tran, rows):
        calls["n"] += 1
        if calls["n"] == (12 if rows else 5):
            pose, tran = pose.clone(), tran.clone()
            at = slice(None) if rows else slice(0, 1)
            pose.reshape(-1, 24, 3, 3)[at, 5, 1, 1] += 0.5
            tran.reshape(-1, 3)[at, 0] += 0.05
        return pose, tran
    _alter(monkeypatch, change)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"] and res["failed"] == 0, res["checks"]


FAULTS = [(c, f) for c in CELLS for f in ("state", "answer")] + \
    [(c, "half") for c in BATCHED] + [(c, "frame") for c in FRAME]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_caught(cell, fault, monkeypatch):
    {"state": _state_unchanged, "half": _half_batch,
     "answer": _altered_answer, "frame": _altered_frame}[fault](monkeypatch)
    res = _run(cell, seconds=1.0 if fault == "frame" else 0.3)
    assert not res["correct"], res["checks"]

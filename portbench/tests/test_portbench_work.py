r"""The work counts against hand counts at small widths, and the tail's
bytes against the counts its kernel was held to on the card."""

import json
import os

import pytest
import torch

from conftest import ROOT
from portbench import inputs
from portbench.work import geometry_tail, serve_scan, sigmp

PEAKS = json.load(open(os.path.join(ROOT, "portbench", "work",
                                    "peaks.json")))
TINY = {"a": {"input": 3, "output": 1, "hidden": 2, "layers": 2,
              "init_net": True},
        "b": {"input": 5, "output": 4, "hidden": 3, "layers": 1,
              "init_net": False}}


def test_stack_flops_by_hand():
    # linear1 3x2, two layers of (4*2 x 2) twice, linear2 2x1
    assert sigmp.stack_flops(TINY["a"]) == 2 * (6 + 2 * 2 * 8 * 2 + 2)
    assert sigmp.stack_flops(TINY["b"]) == 2 * (15 + 1 * 2 * 12 * 3 + 12)
    assert sigmp.frame_flops(TINY) == 2 * (6 + 64 + 2) + 2 * (15 + 72 + 12)
    # init net 1 -> 2 -> 4 -> 8
    assert sigmp.init_flops(TINY) == 2 * (2 + 8 + 32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_bytes_count_every_leaf_made(dtype):
    bank = inputs.make_weights(TINY, 1, "cpu",
                               {"float32": torch.float32,
                                "bfloat16": torch.bfloat16}[dtype])

    def leaves(t):
        if isinstance(t, dict):
            return [x for v in t.values() for x in leaves(v)]
        if isinstance(t, list):
            return [x for v in t for x in leaves(v)]
        return [t]
    total = sum(x.numel() * x.element_size() for x in leaves(bank))
    assert sigmp.weight_bytes(TINY, dtype) == total


@pytest.mark.parametrize("rows,expected", [(1, 89588), (512, 1816768)])
def test_tail_bytes_match_the_kernels_count(rows, expected):
    # each row's operands and outputs once, the shared constants once
    assert rows * geometry_tail.row_bytes() \
        + geometry_tail.shared_bytes(True) == expected


def test_tail_bound_is_bytes():
    t, by = geometry_tail.bound_s(2048, True, PEAKS)
    assert by == "bytes"
    assert t == pytest.approx((2048 * 3380 + 86208) / 3.35e12)


@pytest.mark.parametrize("dtype,by", [("float32", "operations"),
                                      ("bfloat16", "operations")])
def test_serve_bound_full_width(dtype, by):
    cfg = json.load(open(os.path.join(
        ROOT, "portbench", "configs",
        {"float32": "robustcap_f32", "bfloat16": "robustcap_bf16"}[dtype]
        + ".json")))
    t, got = serve_scan.bound_s(cfg, 1280, PEAKS)
    assert got == by
    n_bytes, ops = serve_scan.work(cfg, 1280)
    flops = sigmp.frame_flops(cfg["stacks"])
    assert 121e6 < flops < 122e6          # the six stacks: ~60.7M MACs
    key = "f32_flops" if dtype == "float32" else "bf16_flops"
    assert ops[key] >= 1280 * flops


def test_refeed_and_init_frames_by_hand():
    from portbench.reference.sigmp import LIVE, OFFLINE
    conf = [0.2, 0.75, 0.95, 0.1, 0.95, 0.2]
    # offline: at or below 0.7
    assert sigmp.refeed_frames(conf, OFFLINE).tolist() == \
        [True, False, False, True, False, True]
    # live: at or below 0.85, and only every 31st frame from a fresh state
    age = [0, 31, 62, 5, 93, 124]
    assert sigmp.refeed_frames(conf, LIVE, age).tolist() == \
        [True, True, False, False, False, True]
    assert sigmp.init_frame(conf, OFFLINE)
    assert not sigmp.init_frame([0.2, 0.75], OFFLINE)
    assert sigmp.refeed_flops(TINY | {"rnn7": TINY["a"], "rnn8": TINY["b"]}) \
        == sigmp.stack_flops(TINY["a"]) + sigmp.stack_flops(TINY["b"])


def test_serve_work_counts_the_refeeds_and_inits():
    cfg = json.load(open(os.path.join(ROOT, "portbench", "configs",
                                      "robustcap_f32.json")))
    st = cfg["stacks"]
    _, base = serve_scan.work(cfg, 100, 0, 0)
    _, more = serve_scan.work(cfg, 100, 7, 1)
    assert more["f32_flops"] - base["f32_flops"] == \
        7 * (sigmp.refeed_flops(st) + geometry_tail.row_flops(True)) \
        + sigmp.init_flops(st)


def test_tail_needs_a_launch_per_nonempty_group():
    one = geometry_tail.bound_s(5, True, PEAKS)[0]
    assert geometry_tail.needed_s([5, 0, 5], True, PEAKS) == \
        pytest.approx(2 * one)


def test_evaluation_counts_valid_rows_only():
    from portbench.entries import evaluate
    from portbench.generate import Pool
    import numpy as np
    lens = np.array([3, 5])
    F = int(lens.sum())
    j2dc = np.zeros((F, 33, 3), np.float32)
    j2dc[:, :, 2] = np.array([0.2, 0.95, 0.95, 0.95, 0.2, 0.2, 0.75, 0.95],
                             np.float32)[:, None]
    pool = Pool(j2dc, None, None, lens, np.zeros((2, 3)),
                np.zeros(2, bool), np.zeros(2, bool))

    class Ctx:
        traffic = {"mode": "offline"}
    w = evaluate._work(Ctx, pool)
    assert w["frames"] == 8 and w["steps"] == 5 and w["inits"] == 2
    # refeeds: frame 0 of view 0; frames 1, 2 of view 1
    assert w["refeeds"] == 3
    # (valid rows, refeed rows) at each of the 5 frame-steps
    assert w["tail_rows"] == [2, 1, 2, 1, 2, 1, 1, 0, 1, 0]


def test_sessions_join_part_way_through():
    from portbench.entries.multiplex import _Schedule
    from portbench.generate import Pool
    from portbench.reference.sigmp import LIVE
    import numpy as np
    lens = np.array([600, 3600, 1000, 2000])
    F = int(lens.sum())
    j2dc = np.full((F, 33, 3), 0.95, np.float32)
    pool = Pool(j2dc, None, None, lens, np.zeros((4, 3)),
                np.zeros(4, bool), np.zeros(4, bool))
    a = _Schedule(pool, 4, 2 ** 31 + 5, LIVE)
    b = _Schedule(pool, 4, 2 ** 31 + 5, LIVE)
    assert (a.frame == b.frame).all()
    assert ((a.frame > 0) & (a.frame < lens)).all()
    shares = np.sort(a.frame / lens)
    assert np.allclose(shares, (np.arange(4) + 0.5) / 4, atol=1e-3)
    # every slot fires the re-init on its first full frame, once
    rows, _ = a.rows()
    assert a.work(rows) == (0, 4)
    assert a.work(rows) == (0, 0)

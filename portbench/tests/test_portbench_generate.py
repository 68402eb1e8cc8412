r"""The seeded generators: the same seed gives the same values, another
seed the same work in another order."""

import numpy as np
import pytest
import torch

from portbench import generate, inputs

TRAFFIC = {"lengths": [20, 50], "seeding": ["tran", "first_frame", "none"],
           "first_tran": [0.1, -0.2, 3.0],
           "confidence": {"values": [0.2, 0.75, 0.95, 0.95],
                          "occluded_value": 0.1, "occluded_frames": 5}}


def _pool(seed):
    return generate.make_pool(TRAFFIC, 7, seed, "cpu")


def test_same_seed_same_pool():
    a, b = _pool(2 ** 31 + 99), _pool(2 ** 31 + 99)
    for k in ("j2dc", "accc", "oric", "lengths", "tran_valid",
              "first_frame"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_other_seed_same_lengths_other_order():
    a, b = _pool(5), _pool(6)
    assert sorted(a.lengths) == sorted(b.lengths)
    assert not np.array_equal(a.j2dc, b.j2dc)
    assert sorted(a.lengths) == list(np.rint(np.linspace(20, 50, 7)))


def test_confidence_shares_and_occluded_run():
    p = _pool(3)
    for i in range(len(p)):
        c = p.frames(i)[0][:, 0, 2]
        n = len(c)
        occ = slice(n // 3, n // 3 + 5)
        assert np.all(c[occ] == np.float32(0.1))
        rest = np.delete(c, np.arange(n)[occ])
        vals, counts = np.unique(rest, return_counts=True)
        assert set(vals) <= {np.float32(v) for v in (0.2, 0.75, 0.95)}
        # 0.95 is listed twice, so it takes about half the frames
        assert counts[vals == np.float32(0.95)][0] >= 0.4 * len(rest)


def test_seeding_pattern_and_rotations():
    p = _pool(4)
    assert list(p.tran_valid) == [True, False, False] * 2 + [True]
    assert list(p.first_frame) == [False, True, False] * 2 + [False]
    R = torch.from_numpy(p.oric)
    eye = torch.eye(3).expand_as(R)
    assert torch.allclose(R @ R.transpose(-1, -2), eye, atol=1e-5)


@pytest.mark.parametrize("what", ["weights", "body"])
def test_weights_and_body_repeat_from_the_seed(what):
    stacks = {"rnn2": {"input": 4, "output": 3, "hidden": 2, "layers": 2,
                       "init_net": True}}
    make = (lambda s: inputs.make_weights(stacks, s, "cpu")["rnn2"]
            ["layers"][1]["w_hh"]) if what == "weights" else \
        (lambda s: inputs.make_body(s, "cpu", 100)["v_template"])
    assert torch.equal(make(2 ** 32 + 1), make(2 ** 32 + 1))
    assert not torch.equal(make(2 ** 32 + 1), make(2 ** 32 + 2))


def test_weight_bounds_follow_fan_in():
    stacks = {"s": {"input": 400, "output": 3, "hidden": 100, "layers": 1,
                    "init_net": False}}
    bank = inputs.make_weights(stacks, 1, "cpu")["s"]
    assert bank["linear1"]["w"].abs().max() <= 1 / 20
    assert bank["linear1"]["w"].abs().max() > 0.9 / 20
    assert bank["layers"][0]["w_ih"].abs().max() <= 1 / 10


def test_output_offset_lands_on_the_output_bias():
    from portbench import inputs
    stacks = {"s": {"input": 3, "output": 3, "hidden": 2, "layers": 1,
                    "init_net": False}}
    plain = inputs.make_weights(stacks, 7, "cpu")["s"]["linear2"]["b"]
    stacks["s"]["output_offset"] = [0.0, 0.0, 3.0]
    moved = inputs.make_weights(stacks, 7, "cpu")["s"]["linear2"]["b"]
    assert torch.allclose(moved - plain, torch.tensor([0.0, 0.0, 3.0]),
                          atol=1e-6)

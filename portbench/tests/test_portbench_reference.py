r"""The reference against the program's plain float32 paths at small
widths on the CPU: the offline step of ``forward_offline`` and the live
batched step of the multiplexer. The two are written apart (the reference
imports nothing of the program), so this is where a slip in either shows.
"""

import dataclasses

import numpy as np
import pytest
import torch

from portbench import generate, inputs
from portbench.reference import body as ref_body
from portbench.reference import sigmp
from small import SMALL_STACKS

from robustcap_tpu_torch.config import SigMPConfig
from robustcap_tpu_torch.models import sig_mp
from robustcap_tpu_torch.smpl.model import ParametricModel, SmplData

STACKS = {k: {"input": i, "output": o, "hidden": h, "layers": 2,
              "init_net": w} for k, (i, o, h, w) in SMALL_STACKS.items()}
TRAFFIC = {"lengths": [30, 45], "seeding": ["tran", "first_frame", "none"],
           "first_tran": [0.1, -0.2, 3.0],
           "confidence": {"values": [0.2, 0.75, 0.95, 0.95],
                          "occluded_value": 0.1, "occluded_frames": 8}}
GRAVITY = np.asarray([-0.0029, 0.9980, -0.0273], np.float32)
# float32 sums in another order, through the recurrence and Gram-Schmidt
TOL = 1e-4


def _setup(seed, blendshape=True, dtype=torch.float32):
    bank = inputs.make_weights(STACKS, seed, "cpu", dtype)
    body = inputs.make_body(seed, "cpu", 100)
    h = inputs.host(body)
    model = ParametricModel(data=SmplData(
        j_regressor=h["j_regressor"], skinning_weights=h["skinning"],
        posedirs=h["posedirs"], shapedirs=h["shapedirs"],
        v_template=h["v_template"], joints=h["joints"], faces=h["faces"],
        parent=ref_body.SMPL_PARENT), use_pose_blendshape=blendshape,
        device="cpu")
    pool = generate.make_pool(TRAFFIC, 3, seed, "cpu")
    return bank, body, model, pool


def _frames(pool, ids):
    f = {k: torch.from_numpy(v) for k, v in pool.padded(ids).items()}
    f["gravityc"] = torch.from_numpy(GRAVITY).expand(
        len(ids), f["j2dc"].shape[1], 3)
    return f


@pytest.mark.parametrize("blendshape", [True, False])
def test_offline_against_forward_offline(blendshape):
    bank, body, model, pool = _setup(11, blendshape)
    ref = sigmp.run(bank, ref_body.constants(body, blendshape),
                    sigmp.OFFLINE, _frames(pool, [0, 1, 2]))
    for i in range(3):
        ft, ff = pool.seeding(i)
        pose, tran = sig_mp.forward_offline(
            bank, model, SigMPConfig.offline(), *pool.frames(i),
            first_tran=ft, first_frame=ff, gravityc=GRAVITY, device="cpu")
        n = pool.lengths[i]
        assert (pose - ref[0][i, :n]).abs().max() < TOL
        assert (tran - ref[1][i, :n]).abs().max() < TOL


def test_live_against_the_batched_step():
    bank, body, model, pool = _setup(12)
    f = _frames(pool, [0, 1, 2])
    f["first_frame"][:, 0] = True
    f["first_tran_valid"][:] = False
    ref = sigmp.run(bank, ref_body.constants(body, True), sigmp.LIVE, f)
    cfg = SigMPConfig.live_mode()
    step = sig_mp.make_batched_step(model, cfg)
    pose, tran = sig_mp._offline_batched(step, bank, model, False, f, None,
                                         torch.device("cpu"))
    assert (pose - ref[0]).abs().max() < TOL
    assert (tran - ref[1]).abs().max() < TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_against_the_serve_path(dtype):
    # forward_offline under pallas_serve runs the serve kernel's plain
    # version on the CPU, in the mode of the weights' type: the bf16 mode
    # rounds each product's activation side to bf16, as the reference's
    # bf16 arithmetic does, and the prescan runs in bf16 on both sides
    bank, body, model, pool = _setup(13, dtype=dtype)
    ref = sigmp.run(bank, ref_body.constants(body, True), sigmp.OFFLINE,
                    _frames(pool, [0, 1, 2]))
    cfg = SigMPConfig(pallas_serve=True)
    for i in range(3):
        ft, ff = pool.seeding(i)
        pose, tran = sig_mp.forward_offline(
            bank, model, cfg, *pool.frames(i), first_tran=ft,
            first_frame=ff, gravityc=GRAVITY, device="cpu")
        n = pool.lengths[i]
        assert (pose - ref[0][i, :n]).abs().max() < TOL
        assert (tran - ref[1][i, :n]).abs().max() < TOL


def test_offline_flags_are_the_programs():
    for mode, cfg in ((sigmp.OFFLINE, SigMPConfig.offline()),
                      (sigmp.LIVE, SigMPConfig.live_mode())):
        d = dataclasses.asdict(cfg)
        for k, v in mode.items():
            assert d[k] == v, k

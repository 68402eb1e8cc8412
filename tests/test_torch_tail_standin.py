r"""The geometry-tail kernel's own source, ``csrc/geometry_tail.cu`` with the
body ``csrc/tail_block.cuh``, run on the host.

g++ builds it against the stand-in headers of ``tests/cuda_standin/``: the
launch runs the kernel's 512 threads as fibers, and the stand-in
``serve_async.cuh`` turns the bulk copies of the body-model constants and
the posedirs rows into ``memcpy`` calls that complete their mbarriers. ``geometry_tail._launch`` drives
that build on CPU tensors as it drives the kernel on the card, frame after
frame from random inputs and carries, and every output field is held
against the plain version (``tail_plain``) in each regime of
``tests/test_torch_tail.py``: the confidence bands, the first frame and a
valid first translation, the floor ring's appends and snap, the live
throttle's recompute and reuse, no landmarks, the snap of a far visual
position, each with pose blendshapes off and on.

Tolerance: 1e-4 absolute, as ``chip_smoke.py`` holds the kernel on the card:
one frame of float32 math summed in another order. Counters equal.
"""

import numpy as np
import pytest
import torch

from robustcap_tpu_torch.config import SigMPConfig
from robustcap_tpu_torch.math.angular import r6d_to_rotation_matrix
from robustcap_tpu_torch.models.sig_mp import DEFAULT_GRAVITY
from robustcap_tpu_torch.ops import geometry_tail as G
from robustcap_tpu_torch.smpl import ParametricModel, synthetic_smpl_data
from cuda_standin import standin

ATOL = 1e-4
FRAMES = 12
CPU = torch.device("cpu")

# regime -> (config, confidence per frame, carry overrides per frame)
REGIMES = {
    "confidence": (SigMPConfig(), (0.2, 0.75, 0.95, 0.95), {}),
    "first_frame": (SigMPConfig(), (0.75, 0.95), {"first": True}),
    "floor_append_snap": (SigMPConfig(contact_threshold=0.2,
                                      height_threshold=5.0), (0.95,),
                          {"floor_cnt": (5, 9, 10, 11)}),
    "live_throttle": (SigMPConfig(live=True, update_vision_freq=3,
                                  conf_range=(0.5, 0.6)), (0.3, 0.9, 0.2),
                      {"vision_count": (0, 1, 2)}),
    "no_landmarks": (SigMPConfig(use_vision_updater=False,
                                 use_flat_floor=False), (0.2, 0.95), {}),
    "far_snap": (SigMPConfig(tran_filter_num=2.0, distance_threshold=0.5),
                 (0.95, 0.75), {}),
}


@pytest.fixture(scope="module")
def standin_lib(tmp_path_factory):
    return standin.build("geometry_tail",
                         tmp_path_factory.mktemp("tail_standin"))


@pytest.fixture(scope="module")
def consts():
    data = synthetic_smpl_data()
    return {bs: G.tail_constants(ParametricModel(
        data=data, use_pose_blendshape=bs, device=CPU)) for bs in (False, True)}


def frame_case(rng, i, conf, over):
    r"""Random inputs of frame ``i`` (numpy, seeded)."""
    def rn(*shape, s=1.0):
        return torch.tensor(s * rng.randn(*shape), dtype=torch.float32)

    c = torch.tensor(conf[i % len(conf)], dtype=torch.float32)
    pick = {k: v[i % len(v)] for k, v in over.items() if k != "first"}
    carry = {
        "last_pfoot": rn(2, 3, s=0.5),
        "has_pfoot": torch.tensor(i % 5 != 0),
        "last_tran": rn(3),
        "has_tran": torch.tensor(i % 7 != 0),
        "floor_buf": rn(11, 3, s=0.05),
        "floor_cnt": torch.tensor(pick.get("floor_cnt", (i * 5) % 12),
                                  dtype=torch.int32),
        "vision_count": torch.tensor(
            pick.get("vision_count", (0, 1, 30)[i % 3]), dtype=torch.int32),
        "j_temp": rn(33, 3),
    }
    first = over.get("first", False)
    frame = {"first_tran": rn(3),
             "gravityc": torch.as_tensor(DEFAULT_GRAVITY, dtype=torch.float32),
             "first_frame": first and i % 2 == 0,
             "first_tran_valid": first and i % 4 == 1}
    Rcr = r6d_to_rotation_matrix(rn(1, 6)).reshape(3, 3).contiguous()
    return dict(out7=rn(144), out8=rn(2, s=2.0), carry=carry, frame=frame,
                c=c, Rcr=Rcr, vr=rn(3), pc=rn(3, s=0.3),
                k_lerp=torch.clamp((c - 0.7) * 10.0, 0.0, 1.0))


@pytest.mark.parametrize("blendshape", [False, True], ids=["no_bs", "bs"])
@pytest.mark.parametrize("regime", list(REGIMES))
def test_standin_tail_matches_plain(monkeypatch, standin_lib, consts, regime,
                                    blendshape):
    standin.use(monkeypatch, "geometry_tail", standin_lib)
    cfg, conf, over = REGIMES[regime]
    k = consts[blendshape]
    rng = np.random.RandomState(len(regime) + 100 * blendshape)
    reached = {"append": 0, "snap": 0, "recompute": 0, "reuse": 0,
               "first": 0}
    for i in range(FRAMES):
        a = frame_case(rng, i, conf, over)
        got = G._launch(k, cfg, **a)
        want = G.tail_plain(k, cfg, **a)
        assert set(got) == set(want)
        for field, w in want.items():
            g = got[field]
            assert g.shape == w.shape, field
            if w.dtype in (torch.int32, torch.int64):
                assert torch.equal(g, w), (i, field)
            else:
                err = float((g.double() - w.double()).abs().max())
                assert err <= ATOL, (i, field, err)
        before = int(a["carry"]["floor_cnt"])
        reached["append"] += int(got["floor_cnt"]) > before
        reached["snap"] += int(got["floor_cnt"]) == 11 and float(
            torch.sigmoid(a["out8"]).max()) > cfg.contact_threshold
        vc = int(a["carry"]["vision_count"])
        reached["recompute"] += cfg.live and vc == 0
        reached["reuse"] += cfg.live and vc > 0
        reached["first"] += a["frame"]["first_frame"] or \
            a["frame"]["first_tran_valid"]
    if regime == "floor_append_snap":
        assert reached["append"] > 0 and reached["snap"] > 0
    if regime == "live_throttle":
        assert reached["recompute"] > 0 and reached["reuse"] > 0
    if regime == "first_frame":
        assert reached["first"] > 0


def test_kernel_constant_layouts(consts):
    r"""What the kernels read of the constants: ``body`` holds the parent
    index (int32 bits), bones, joints, skinning weights and rest positions
    end to end, zero-padded to ``BODY_WORDS``; the posedirs rows hold the
    plain version's ``pd``, row ``c * 33 + v`` landmark v's channel c,
    zero-padded to ``PD_ROW``."""
    k = consts[True]
    body = k["body"]
    assert body.shape == (G.BODY_WORDS,) and body.dtype == torch.float32
    assert torch.equal(body[:24].view(torch.int32), k["parent"])
    want = torch.cat([k[n].reshape(-1) for n in ("bone", "j0", "wsub",
                                                  "v0sub")])
    assert torch.equal(body[24:24 + want.numel()], want)
    assert not body[24 + want.numel():].any()
    pd, rows = k["pd"], k["pd_rows"]
    assert rows.shape == (99, G.PD_ROW) and rows.is_contiguous()
    assert torch.equal(rows[:, :207].reshape(3, 33, 207),
                       pd.permute(0, 2, 1))
    assert not rows[:, 207:].any()
    assert consts[False]["pd_rows"] is None

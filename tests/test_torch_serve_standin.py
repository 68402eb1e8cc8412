r"""The serve kernel's own source, ``csrc/serve_scan.cu``, run on the host.

g++ builds it against the stand-in headers of ``tests/cuda_standin/``: a
cooperative launch runs every CUDA thread of the grid (3 blocks of 512) as a
fiber, and the stand-in ``serve_async.cuh`` turns a bulk copy into a
``memcpy`` that completes its mbarrier. ``serve_scan._launch`` drives that
build on CPU tensors as it drives the kernel on the card, and the result is
held against ``serve_scan_plain`` in each weight mode: on a mixed chunk
with the whole shared memory of an H100 block (bf16 and int8 keep runs
resident), and on a live chunk with a 28,000-byte budget, where the ring
wraps and runs stream in several pieces. 3 + 5 chained frames must give the
bits of 8.

This checks the kernel's logic: the plan, the ring's walk, the skipped
speculative heads, live mode's rnn4/rnn6 decision, the carry, and block
0's timestamp buffer (its stamps in order, its byte counts exact). Its PTX,
its speed and the card's memory ordering are checked only on the card
(``chip_smoke.py``).

Tolerance: 1e-4 absolute on pose, translation, contacts and the carried
(h, c) of every stack; the kernel and the plain version sum in other orders,
which at these widths and 8 frames moves values by about 1e-6. The carry's
counters equal; chained equal to unchained bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from robustcap_tpu_torch.config import SigMPConfig
from robustcap_tpu_torch.math.angular import r6d_to_rotation_matrix
from robustcap_tpu_torch.models import sig_mp
from robustcap_tpu_torch.nn.rnn import cast_params, quantize_params
from robustcap_tpu_torch.ops import serve_scan as S
from robustcap_tpu_torch.ops.geometry_tail import tail_constants
from robustcap_tpu_torch.smpl import ParametricModel, synthetic_smpl_data
from cuda_standin import standin
from test_torch_tail import CPU, SMALL_SPECS

ATOL = 1e-4
# a visible first frame (rnn4 keeps its state on it), occluded frames (the
# refeed fires), mid-confidence and confident frames (the IMU updater fires
# on the first)
CONF = [0.75, 0.2, 0.95, 0.1, 0.95, 0.2, 0.75, 0.95]
SMEM_SMALL = 28000


@pytest.fixture(scope="module")
def standin_lib(tmp_path_factory):
    return standin.build("serve_scan",
                         tmp_path_factory.mktemp("serve_standin"))


@pytest.fixture(scope="module")
def world():
    params = sig_mp.init_params(torch.Generator().manual_seed(0), SMALL_SPECS,
                                device=CPU)
    model = ParametricModel(data=synthetic_smpl_data(), device=CPU)
    return params, model, tail_constants(model)


@pytest.fixture
def on_standin(monkeypatch, standin_lib):
    r"""``serve_scan._launch`` goes to the host build, with no plan kept
    from another test (a test may plan for a smaller budget)."""
    standin.use(monkeypatch, "serve_scan", standin_lib)
    monkeypatch.setattr(S, "_PLANS", {})


def stream(seed, conf):
    rng = np.random.RandomState(seed)
    T = len(conf)
    j2dc = rng.uniform(0.2, 0.9, (T, 33, 3)).astype(np.float32)
    j2dc[:, :, 2] = np.asarray(conf, np.float32)[:, None]
    accc = rng.randn(T, 6, 3).astype(np.float32)
    oric = r6d_to_rotation_matrix(torch.from_numpy(
        rng.randn(T * 6, 6).astype(np.float32))).reshape(T, 6, 3, 3).numpy()
    return j2dc, accc, oric


def mode_params(params, mode):
    if mode == "bf16":
        return cast_params(params, torch.bfloat16)
    return quantize_params(params) if mode == "int8" else params


def max_gap(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def state_gap(a, b):
    return max(float((a["states"][n][i] - b["states"][n][i]).abs().max())
               for n in a["states"] for i in (0, 1))


def chunk_of(world, monkeypatch, mode, live, small_ring):
    r"""(prepped, config, frames, carry) of the test chunk in ``mode``: the
    default or the live config, and with ``small_ring`` a plan made for a
    28,000-byte budget."""
    params, model, _ = world
    int8 = mode == "int8"
    cfg = dataclasses.replace(SigMPConfig.live_mode() if live
                              else SigMPConfig(), int8_compute=int8)
    if small_ring:
        plan = S.serve_plan
        monkeypatch.setattr(S, "serve_plan",
                            lambda p, n, smem: plan(p, n, SMEM_SMALL))
    p = mode_params(params, mode)
    prepped = S.prepare_serve_params(p, int8_gates=int8)
    scan_p = sig_mp.prepare_scan_params(p, int8)
    frames = sig_mp._sequence_frames(*stream(6, CONF), np.zeros(3, np.float32),
                                     True, None, CPU)
    carry = sig_mp.prescan_first_frame(scan_p, model, sig_mp.init_carry(scan_p),
                                       sig_mp._frame_at(frames, 0), int8)
    return prepped, cfg, frames, carry


@pytest.mark.parametrize("chunk", ["mixed", "live_small_ring"])
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_standin_kernel_matches_plain(world, on_standin, monkeypatch, mode,
                                      chunk):
    consts = world[2]
    prepped, cfg, frames, carry = chunk_of(world, monkeypatch, mode,
                                           chunk != "mixed", chunk != "mixed")

    got = S._launch(prepped, consts, cfg, frames, carry)
    want = S.serve_scan_plain(prepped, consts, cfg, frames, carry)
    assert max_gap(got[:3], want[:3]) < ATOL
    assert state_gap(got[3], want[3]) < ATOL
    for key in ("floor_cnt", "vision_count", "first_reach"):
        assert int(got[3][key]) == int(want[3][key])

    first = S._launch(prepped, consts, cfg,
                      {k: v[:3] for k, v in frames.items()}, carry)
    rest = S._launch(prepped, consts, cfg,
                     {k: v[3:] for k, v in frames.items()}, first[3])
    for a, b, whole in zip(first[:3], rest[:3], got[:3]):
        assert torch.equal(torch.cat([a, b]), whole)
    assert state_gap(rest[3], got[3]) == 0

    plan = S._device_plan(prepped, CPU)[0]
    lay = plan["layout"]
    if chunk == "mixed":
        assert lay["total"] == 232448
    else:
        # block 0 streams more in a frame than its ring holds: it wraps
        assert lay["total"] <= SMEM_SMALL
        streamed = sum(
            int(np.diff(plan["starts"][si, k, :2])[0]) * plan["rec"][si][k]
            for si in range(6) for k in range(4)
            if not plan["resident"][si][k])
        assert streamed > lay["ring_bytes"]


@pytest.mark.parametrize("live", [False, True], ids=["mixed", "live"])
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_standin_timestamps(world, on_standin, monkeypatch, mode, live):
    r"""Block 0's timestamp buffer (``serve_scan(..., timestamps=)``): each
    frame's stamps lie between its start (slot 0) and its last barrier
    (slot 40), one frame after the other, and the byte slots of phase 1
    (45-47) count block 0's records of that phase: rnn2's layer 0, and
    rnn4's where the refeed cannot fire. Under a 28,000-byte budget nothing
    stays resident, so all of them stream."""
    consts = world[2]
    prepped, cfg, frames, carry = chunk_of(world, monkeypatch, mode, live,
                                           True)
    ts = torch.zeros((len(CONF), S.TS_SLOTS), dtype=torch.int64)
    S._launch(prepped, consts, cfg, frames, carry, ts)
    plan = S._device_plan(prepped, CPU)[0]
    assert not any(any(r) for r in plan["resident"])

    def layer0_bytes(name):
        si = S._STACKS.index(name)
        return int(np.diff(plan["starts"][si, 1, :2])[0]) * plan["rec"][si][1]

    rows = ts.numpy()
    lo = np.float32(cfg.conf_range[0])
    for t, row in enumerate(rows):
        times = [v for k, v in enumerate(row) if v and k not in (45, 46, 47)]
        assert row[0] == min(times) and row[40] == max(times)
        assert t == 0 or rows[t - 1][40] <= row[0]
        assert row[46] > 0
        assert row[47] - row[45] == layer0_bytes("rnn2") + (
            layer0_bytes("rnn4") if np.float32(CONF[t]) > lo else 0)

r"""The port's serve path (``ops/serve_scan.py``) against the JAX package's
``ops/pallas_serve.py``, in every regime of ``tests/test_pallas_serve.py``,
and end to end through ``forward_offline`` and
``StreamingNet.forward_chunk`` with ``pallas_serve``.

On the CPU the port's ``serve_scan`` runs its plain version (a frame loop of
the branchless steady step); the JAX serve kernel runs in Pallas interpret
mode with dense float32 operands and nothing streamed, as its own tests run
it. Both sides get the same numpy inputs and the same weights. Per-frame
pose, translation and contacts and the whole final carry are compared.

Tolerance: 3e-4 absolute, the JAX serve test's own: the kernel's fused and
split products sum in other orders than XLA and PyTorch, and the
differences compound through the carried LSTM states over a chunk.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustcap_tpu.config import SigMPConfig as JaxConfig
from robustcap_tpu.models import sig_mp as jsig
from robustcap_tpu.ops import pallas_serve
from robustcap_tpu_torch.config import SigMPConfig
from robustcap_tpu_torch.models import sig_mp as tsig
from robustcap_tpu_torch.ops import serve_scan
from robustcap_tpu_torch.ops.geometry_tail import tail_constants
from test_torch_tail import (CPU, MIXED, SMALL_SPECS, assert_tree_close,
                             make_inputs, make_models, make_params, port_cfg)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 3e-4


@pytest.fixture(scope="module")
def world():
    jm, tm = make_models(num_verts=500)   # MP landmark ids get clipped
    jp, tp = make_params(0)
    return jm, tm, jp, tp


def run_jax(params, model, cfg, inputs, first_tran, first_frame):
    frames = jsig._sequence_frames(*inputs, first_tran, first_frame, None)
    carry = jsig.prescan_first_frame(params, model, jsig.init_carry(params),
                                     jax.tree.map(lambda x: x[0], frames))
    prepped = pallas_serve.prepare_serve_params(params, dtype=jnp.float32,
                                                stream=())
    return pallas_serve.serve_scan(prepped, model, cfg, frames, carry)


def port_chunk(params, model, inputs, first_tran, first_frame):
    frames = tsig._sequence_frames(*inputs, first_tran, first_frame, None,
                                   CPU)
    carry = tsig.prescan_first_frame(params, model, tsig.init_carry(params),
                                     tsig._frame_at(frames, 0))
    return frames, carry


def run_port(params, model, cfg, inputs, first_tran, first_frame):
    frames, carry = port_chunk(params, model, inputs, first_tran,
                               first_frame)
    return serve_scan.serve_scan(serve_scan.prepare_serve_params(params),
                                 tail_constants(model), cfg, frames, carry)


REGIMES = {
    "mixed_confidence": (JaxConfig(), MIXED, [0.1, 0.2, 1.5], True, False),
    "imu_updater_midchunk": (JaxConfig(),
                             [0.1, 0.2, 0.1, 0.95, 0.9, 0.3, 0.95, 0.1],
                             None, False, False),
    "floor_fill_and_snap": (JaxConfig(contact_threshold=0.2,
                                      height_threshold=5.0),
                            [0.95] * 20, None, True, False),
    "live_throttle": (JaxConfig(live=True, update_vision_freq=3,
                                conf_range=(0.5, 0.6)),
                      [0.3, 0.2, 0.9, 0.1, 0.2, 0.3, 0.1, 0.9, 0.2, 0.1],
                      [0.0, 0.0, 2.0], True, False),
    "no_flat_floor": (JaxConfig(use_flat_floor=False), MIXED, None, True,
                      False),
    "pose_blendshape": (JaxConfig(), MIXED, [0.1, 0.0, 1.2], True, True),
}


@pytest.mark.parametrize("regime", list(REGIMES))
def test_serve_agreement(world, regime):
    jm, tm, jp, tp = world
    cfg, conf, first_tran, first_frame, blendshape = REGIMES[regime]
    if blendshape:
        jm, tm = make_models(num_verts=500, blendshape=True)
    if first_tran is not None:
        first_tran = np.asarray(first_tran, np.float32)
    seed = list(REGIMES).index(regime) + 1
    inputs = make_inputs(seed, conf)
    want = run_jax(jp, jm, cfg, inputs, first_tran, first_frame)
    got = run_port(tp, tm, port_cfg(cfg), inputs, first_tran, first_frame)
    assert_tree_close(want[:3], got[:3], ATOL)
    assert_tree_close(want[3], got[3], ATOL)
    carry = got[3]
    if regime == "imu_updater_midchunk":
        assert not bool(carry["first_reach"])
    if regime == "floor_fill_and_snap":
        assert int(carry["floor_cnt"]) == 11


def test_chunk_chaining(world):
    r"""Carry handoff: two chunks give what one chunk of both gives."""
    _, tm, _, tp = world
    frames, carry = port_chunk(tp, tm, make_inputs(8, MIXED), None, True)
    prepped = serve_scan.prepare_serve_params(tp)
    consts = tail_constants(tm)
    whole = serve_scan.serve_scan(prepped, consts, SigMPConfig(), frames,
                                  carry)
    half = len(MIXED) // 2
    a = serve_scan.serve_scan(prepped, consts, SigMPConfig(),
                              {k: v[:half] for k, v in frames.items()}, carry)
    b = serve_scan.serve_scan(prepped, consts, SigMPConfig(),
                              {k: v[half:] for k, v in frames.items()}, a[3])
    for x, y, z in zip(a[:3], b[:3], whole[:3]):
        np.testing.assert_allclose(torch.cat([x, y]).numpy(), z.numpy(),
                                   atol=1e-5, rtol=0)
    assert_tree_close(whole[3], b[3], 1e-5)


def test_forward_offline(world):
    jm, tm, jp, tp = world
    cfg = JaxConfig(pallas_serve=True)
    j2dc, accc, oric = make_inputs(9, np.resize(MIXED, 24))
    want = jsig.forward_offline(jp, jm, cfg, j2dc, accc, oric,
                                first_frame=True, return_contacts=True)
    got = tsig.forward_offline(tp, tm, port_cfg(cfg), j2dc, accc, oric,
                               first_frame=True, return_contacts=True,
                               device="cpu")
    assert_tree_close(want, got, ATOL)


def test_streaming_net_chunk(world):
    r"""``StreamingNet.forward_chunk`` with ``pallas_serve``: a first frame
    through ``forward_online``, then two chunks, carry included."""
    jm, tm, jp, tp = world
    cfg = JaxConfig(pallas_serve=True)
    j2dc, accc, oric = make_inputs(10, MIXED[:10])
    jnet = jsig.StreamingNet(jp, jm, cfg)
    tnet = tsig.StreamingNet(tp, tm, port_cfg(cfg), device="cpu")
    want = [jnet.forward_online(j2dc[0], accc[0], oric[0], first_frame=True)]
    got = [tnet.forward_online(j2dc[0], accc[0], oric[0], first_frame=True)]
    want = [tuple(np.asarray(x)[None] for x in want[0])]
    got = [tuple(x.numpy()[None] for x in got[0])]
    for sl in (slice(1, 6), slice(6, 10)):
        want.append(tuple(np.asarray(x) for x in jnet.forward_chunk(
            j2dc[sl], accc[sl], oric[sl])))
        got.append(tuple(x.numpy() for x in tnet.forward_chunk(
            j2dc[sl], accc[sl], oric[sl])))
    assert_tree_close(tuple(np.concatenate(x) for x in zip(*want)),
                      tuple(np.concatenate(x) for x in zip(*got)), ATOL)
    assert_tree_close(jnet.carry, tnet.carry, ATOL)


def test_serve_counts_no_launch_on_cpu(world, monkeypatch):
    r"""On CPU tensors the serve wrapper runs its plain version and counts
    no launch; the entry points still go through it."""
    _, tm, _, tp = world
    before = serve_scan.LAUNCHES
    calls = []
    real = serve_scan.serve_scan_plain

    def spy(*args):
        calls.append(len(args[3]["conf"]))
        return real(*args)

    monkeypatch.setattr(serve_scan, "serve_scan_plain", spy)
    net = tsig.StreamingNet(tp, tm, SigMPConfig(pallas_serve=True),
                            device="cpu")
    net.forward_chunk(*make_inputs(11, [0.95, 0.3, 0.95]))
    tsig.forward_offline(tp, tm, SigMPConfig(pallas_serve=True),
                         *make_inputs(12, [0.2, 0.95]), device="cpu")
    assert calls == [3, 2]
    assert serve_scan.LAUNCHES == before


def test_prepare_refuses_other_weight_types(world):
    _, _, _, tp = world
    half = dict(tp, rnn4=dict(tp["rnn4"],
                              linear1={"w": tp["rnn4"]["linear1"]["w"].half(),
                                       "b": tp["rnn4"]["linear1"]["b"]}))
    with pytest.raises(NotImplementedError, match="later slice"):
        serve_scan.prepare_serve_params(half)
    specs = dict(SMALL_SPECS, rnn7=(141, 144, 32, 0.1, False))
    wide = tsig.init_params(torch.Generator().manual_seed(1), specs,
                            device="cpu")
    with pytest.raises(ValueError, match="hidden sizes must match"):
        serve_scan.prepare_serve_params(wide)

r"""The port's SigMP slice against the JAX package: ``forward_offline``,
the streaming variant of the step, ``StreamingNet`` (per-frame, chunked,
with ``pallas_inertial`` and ``pallas_tail``, live mode), and the golden
fixture.

On the CPU the port's kernel wrappers run their plain versions; the JAX
package runs its Pallas kernels in interpret mode, as its own tests do.
Tolerances: 2e-4 absolute against JAX (summation order differs between XLA
and PyTorch and compounds through the carried LSTM states; the JAX package's
tail test uses the same bound), and 5e-4 against the golden fixture, as
``tests/test_golden.py`` uses.
"""

import os

import jax
import numpy as np
import pytest
import torch

from robustcap_tpu.config import SigMPConfig as JaxConfig
from robustcap_tpu.models import sig_mp as jsig
from robustcap_tpu_torch.config import SigMPConfig
from robustcap_tpu_torch.convert import params_from_numpy
from robustcap_tpu_torch.models import sig_mp as tsig
from robustcap_tpu_torch.ops import geometry_tail, lstm_scan
from test_torch_tail import (CPU, MIXED, SMALL_SPECS, assert_tree_close,
                             make_inputs, make_models, make_params, port_cfg)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_trajectory.npz")


@pytest.fixture(scope="module")
def world():
    jm, tm = make_models(num_verts=500)   # MP landmark ids get clipped
    jp, tp = make_params(0)
    return jm, tm, jp, tp


def test_golden_fixture():
    r"""Inputs and weights as ``tests/make_golden.py::build`` makes them;
    the port's ``forward_offline`` against the stored trajectory."""
    from robustcap_tpu.eval import build_aist_sequences
    from robustcap_tpu.preprocess import build_fixture_dataset
    jm, tm = make_models()
    _, tp = make_params(42)

    def conf_fn(rng, T):
        conf = np.full(T, 0.95, np.float32)
        conf[8:16] = 0.2
        conf[20:24] = 0.75
        return conf

    ds = build_fixture_dataset(jm, n_seq=1, T=32, n_cam=1, seed=1234,
                               conf_fn=conf_fn)
    s = build_aist_sequences(ds, num_cameras=1)[0]
    pose, tran = tsig.forward_offline(
        tp, tm, SigMPConfig(), np.array(s.j2dc), np.array(s.accc),
        np.array(s.oric), first_tran=np.array(s.first_tran),
        gravityc=np.array(s.gravityc), device="cpu")
    ref = np.load(GOLDEN)
    np.testing.assert_allclose(pose.numpy(), ref["pose"], atol=5e-4)
    np.testing.assert_allclose(tran.numpy(), ref["tran"], atol=5e-4)


@pytest.mark.parametrize("pallas_tail", [False, True])
def test_forward_offline(world, pallas_tail):
    jm, tm, jp, tp = world
    cfg = JaxConfig(pallas_tail=pallas_tail)
    j2dc, accc, oric = make_inputs(7, np.resize(MIXED, 24))
    want = jsig.forward_offline(jp, jm, cfg, j2dc, accc, oric,
                                first_frame=True, return_contacts=True)
    got = tsig.forward_offline(tp, tm, port_cfg(cfg), j2dc, accc, oric,
                               first_frame=True, return_contacts=True,
                               device="cpu")
    assert_tree_close(want, got)


@pytest.mark.parametrize("live", [False, True])
def test_streaming_variant_step(world, live):
    r"""``include_first_frame_step=True``: the reference's literal
    structure, with the first-frame double rnn6 advance inside the step."""
    jm, tm, jp, tp = world
    cfg = JaxConfig(live=live, update_vision_freq=3)
    inputs = make_inputs(8, MIXED)
    frames = jsig._sequence_frames(*inputs, None, True, None)
    jstep = jsig.make_step(jm, cfg, output_contacts=True)
    jc, jo = jax.lax.scan(lambda c, f: jstep(jp, c, f),
                          jsig.init_carry(jp), frames)
    tframes = tsig._sequence_frames(*inputs, None, True, None, CPU)
    tstep = tsig.make_step(tm, port_cfg(cfg), output_contacts=True)
    carry, outs = tsig.init_carry(tp), []
    for t in range(len(MIXED)):
        carry, out = tstep(tp, carry, tsig._frame_at(tframes, t))
        outs.append(out)
    assert_tree_close(jo, tuple(torch.stack(x) for x in zip(*outs)))
    assert_tree_close(jc, carry)


def _stream(net, first, chunks, to_np):
    r"""First frame through ``forward_online``, then each chunk through
    ``forward_chunk``; returns the concatenated (pose, tran)."""
    j2dc, accc, oric = first
    outs = [tuple(to_np(x)[None] for x in net.forward_online(
        j2dc[0], accc[0], oric[0], first_tran=np.zeros(3, np.float32),
        first_frame=True))]
    for j2dc, accc, oric in chunks:
        outs.append(tuple(to_np(x) for x in net.forward_chunk(j2dc, accc,
                                                              oric)))
    return tuple(np.concatenate(x) for x in zip(*outs))


def test_streaming_net_inertial_and_tail_kernels(world):
    r"""``SigMPConfig(pallas_inertial=True, pallas_tail=True)``: a chunk
    while ``first_reach`` is pending takes the per-frame path, a confident
    chunk clears it, and the next chunk (with occluded frames) takes the
    LSTM-scan path."""
    jm, tm, jp, tp = world
    cfg = JaxConfig(pallas_inertial=True, pallas_tail=True)
    first = make_inputs(9, [0.2])
    pending = make_inputs(10, [0.2, 0.5, 0.3, 0.1])
    confident = make_inputs(11, [0.95, 0.9, 0.95, 0.85])
    occluded = make_inputs(12, [0.95, 0.2, 0.1, 0.75])

    jnet = jsig.StreamingNet(jp, jm, cfg)
    want = _stream(jnet, first, [pending, confident, occluded], np.asarray)
    tnet = tsig.StreamingNet(tp, tm, port_cfg(cfg), device="cpu")
    got = _stream(tnet, first, [pending, confident], lambda x: x.numpy())
    assert list(tnet._chunk_steps) == [False]
    assert bool(tnet.carry["first_reach"]) is False
    more = tuple(x.numpy() for x in tnet.forward_chunk(*occluded))
    assert list(tnet._chunk_steps) == [False, True]
    got = tuple(np.concatenate([a, b]) for a, b in zip(got, more))
    assert_tree_close(want, got)
    assert_tree_close(jnet.carry, tnet.carry)


def test_streaming_net_live_mode(world):
    jm, tm, jp, tp = world
    cfg = JaxConfig.live_mode()
    first = make_inputs(13, [0.95])
    chunk = make_inputs(14, [0.95, 0.5, 0.3, 0.92, 0.1, 0.88])
    jnet = jsig.StreamingNet(jp, jm, cfg)
    tnet = tsig.StreamingNet(tp, tm, port_cfg(cfg), device="cpu")
    want = _stream(jnet, first, [], np.asarray)
    got = _stream(tnet, first, [], lambda x: x.numpy())
    for t in range(len(chunk[0])):
        frame = [x[t] for x in chunk]
        want = tuple(np.concatenate([a, np.asarray(b)[None]])
                     for a, b in zip(want, jnet.forward_online(*frame)))
        got = tuple(np.concatenate([a, b.numpy()[None]])
                    for a, b in zip(got, tnet.forward_online(*frame)))
    assert_tree_close(want, got)
    assert_tree_close(jnet.carry, tnet.carry)


def test_reset_states_reenables_imu_updater(world):
    r"""After ``reset_states`` the one-shot IMU-updater rewrite is pending
    again, so the next chunk must take the per-frame path."""
    _, tm, _, tp = world
    net = tsig.StreamingNet(tp, tm, SigMPConfig(pallas_inertial=True),
                            device="cpu")
    net.forward_chunk(*make_inputs(15, [0.95, 0.95]))
    net.forward_chunk(*make_inputs(16, [0.95, 0.95]))
    assert list(net._chunk_steps) == [False, True]
    net.reset_states()
    assert bool(net.carry["first_reach"]) is True
    net.forward_chunk(*make_inputs(17, [0.3, 0.95]))
    # the chunk ran per frame (the rewrite fired there), and only now is
    # first_reach seen cleared
    assert net._first_reach_cleared is False
    assert bool(net.carry["first_reach"]) is False


@pytest.mark.parametrize("cond_updater", [False, True])
def test_fuse_spec_heads_changes_no_value(world, cond_updater):
    r"""``fuse_spec_heads`` only decides where the speculative heads are
    evaluated: the values are the same either way."""
    _, tm, _, tp = world
    frames = tsig._sequence_frames(*make_inputs(19, MIXED), None, True, None,
                                   CPU)
    runs = []
    for fuse in (True, False):
        step = tsig.make_step(tm, SigMPConfig(),
                              include_first_frame_step=False,
                              cond_updater=cond_updater,
                              fuse_spec_heads=fuse)
        carry = tsig.prescan_first_frame(tp, tm, tsig.init_carry(tp),
                                         tsig._frame_at(frames, 0))
        outs = []
        for t in range(len(MIXED)):
            carry, out = step(tp, carry, tsig._frame_at(frames, t))
            outs.append(out)
        runs.append((outs, carry))
    assert_tree_close(runs[0], runs[1], atol=0)


def test_wrappers_count_no_launch_on_cpu(world):
    r"""On CPU tensors the kernel wrappers run their plain versions and
    count no launch."""
    _, tm, _, tp = world
    before = (lstm_scan.LAUNCHES, geometry_tail.LAUNCHES)
    net = tsig.StreamingNet(tp, tm, SigMPConfig(pallas_inertial=True,
                                                pallas_tail=True),
                            device="cpu")
    net.forward_chunk(*make_inputs(17, [0.95, 0.3, 0.95]))
    net.forward_chunk(*make_inputs(18, [0.95, 0.3, 0.95]))
    assert (lstm_scan.LAUNCHES, geometry_tail.LAUNCHES) == before


def test_params_from_numpy_layout():
    jp = jsig.init_params(jax.random.PRNGKey(3), SMALL_SPECS)
    tp = params_from_numpy(jax.tree.map(np.array, jp), "cpu")
    assert_tree_close(jp, tp, atol=0)
    assert tp["rnn2"]["layers"][0]["w_ih"].shape == (64, 16)
    assert len(tp["rnn2"]["init_net"]) == 3

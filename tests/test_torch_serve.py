r"""The port's serve path (``ops/serve_scan.py``) against the JAX package's
``ops/pallas_serve.py``, in every regime of ``tests/test_pallas_serve.py``,
and end to end through ``forward_offline`` and
``StreamingNet.forward_chunk`` with ``pallas_serve``; then the kernel's
bf16-weight and int8-gate modes.

On the CPU the port's ``serve_scan`` runs its plain version (a frame loop of
the branchless steady step); the JAX serve kernel runs in Pallas interpret
mode with dense float32 operands and nothing streamed, as its own tests run
it. Both sides get the same numpy inputs and the same weights. Per-frame
pose, translation and contacts and the whole final carry are compared.

Tolerance: 3e-4 absolute, the JAX serve test's own: the kernel's fused and
split products sum in other orders than XLA and PyTorch, and the
differences compound through the carried LSTM states over a chunk. The bf16
mode is held within 2e-3, a tenth of the JAX bf16 kernel's own distance
from float32 on the mixed stream (0.019 in pose); the int8 mode within
6e-2, the bound of the JAX package's own int8 serve test: a sum in another
order can move a value across a bf16 rounding boundary and so change a
quantized activation by one step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robustcap_tpu.math as M
from robustcap_tpu.config import SigMPConfig as JaxConfig
from robustcap_tpu.models import sig_mp as jsig
from robustcap_tpu.nn import rnn as jrnn
from robustcap_tpu.ops import pallas_serve
from robustcap_tpu_torch.config import SigMPConfig
from robustcap_tpu_torch.models import sig_mp as tsig
from robustcap_tpu_torch.nn import rnn as trnn
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
    _chaining(tp, tm, SigMPConfig(), serve_scan.prepare_serve_params(tp))


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
    with pytest.raises(ValueError, match="no mode for torch.float16"):
        serve_scan.prepare_serve_params(trnn.cast_params(tp, torch.float16))
    with pytest.raises(ValueError, match="no mode for torch.float16"):
        serve_scan.prepare_serve_params(tp, torch.float16)
    specs = dict(SMALL_SPECS, rnn7=(141, 144, 32, 0.1, False))
    wide = tsig.init_params(torch.Generator().manual_seed(1), specs,
                            device="cpu")
    with pytest.raises(ValueError, match="hidden sizes must match"):
        serve_scan.prepare_serve_params(wide)


# ---------------------------------------------------------------------------
# The bf16-weight and int8-gate modes
# ---------------------------------------------------------------------------

BF16_ATOL = 2e-3
INT8_ATOL = 6e-2


def jax_prescan(params, model, cfg, frames):
    r"""The JAX first-frame prescan on the scan-ready weights, as
    ``forward_offline`` runs it."""
    sp = jsig.prepare_scan_params(params, cfg.int8_compute)
    return jsig.prescan_first_frame(sp, model, jsig.init_carry(sp),
                                    jax.tree.map(lambda x: x[0], frames),
                                    int8_compute=cfg.int8_compute)


def carry_from_jax(carry):
    r"""A JAX carry as the port's, leaf for leaf."""
    if isinstance(carry, dict):
        return {k: carry_from_jax(v) for k, v in carry.items()}
    if isinstance(carry, (list, tuple)):
        return type(carry)(carry_from_jax(v) for v in carry)
    return torch.as_tensor(np.array(carry))


def run_jax_mode(params, model, cfg, frames, carry, **prep):
    r"""The JAX serve kernel in interpret mode, nothing streamed."""
    prepped = pallas_serve.prepare_serve_params(params, stream=(), **prep)
    return pallas_serve.serve_scan(prepped, model, cfg, frames, carry)


def run_port_mode(params, model, cfg, inputs, first_tran, first_frame,
                  carry=None, **prep):
    r"""The port's serve path after its own prescan, or from ``carry``."""
    frames = tsig._sequence_frames(*inputs, first_tran, first_frame, None,
                                   CPU)
    if carry is None:
        sp = tsig.prepare_scan_params(params, cfg.int8_compute)
        carry = tsig.prescan_first_frame(sp, model, tsig.init_carry(sp),
                                         tsig._frame_at(frames, 0),
                                         cfg.int8_compute)
    prepped = serve_scan.prepare_serve_params(params, **prep)
    return serve_scan.serve_scan(prepped, tail_constants(model), cfg,
                                 frames, carry)


def _chaining(params, model, cfg, prep):
    r"""Two chunks give what one chunk of both gives, bit for bit: the
    plain version does the same operations either way."""
    frames, carry = port_chunk(params, model, make_inputs(8, MIXED), None,
                               True)
    consts = tail_constants(model)
    whole = serve_scan.serve_scan(prep, consts, cfg, frames, carry)
    half = len(MIXED) // 2
    a = serve_scan.serve_scan(prep, consts, cfg,
                              {k: v[:half] for k, v in frames.items()}, carry)
    b = serve_scan.serve_scan(prep, consts, cfg,
                              {k: v[half:] for k, v in frames.items()}, a[3])
    for x, y, z in zip(a[:3], b[:3], whole[:3]):
        np.testing.assert_array_equal(torch.cat([x, y]).numpy(), z.numpy())
    assert_tree_close(whole[3], b[3], 0.0)


@pytest.fixture(scope="module")
def bf16_world(world):
    jm, tm, jp, tp = world
    return (jm, tm, jrnn.cast_params(jp, jnp.bfloat16),
            trnn.cast_params(tp, torch.bfloat16))


class TestServeBf16:
    r"""bf16 weights: the port's serve path against the JAX serve kernel
    with ``dtype=jnp.bfloat16`` (interpret mode). The regimes start both
    from the JAX prescan's carry: the prescan is the XLA-form step, which on
    a bf16 tree computes its cells in bf16, where XLA and PyTorch round at
    other places (``test_torch_quant.py`` holds that step); in live mode
    rnn4/rnn6 keep the prescan's state until the throttle fires.
    ``test_forward_offline`` runs each side's own prescan."""

    @pytest.mark.parametrize("regime", ["mixed_confidence",
                                        "imu_updater_midchunk",
                                        "live_throttle",
                                        "f32_weights_cast_in_prepare"])
    def test_serve_agreement(self, world, bf16_world, regime):
        jm, tm, jp, tp = bf16_world
        prep_j, prep_t = {"dtype": jnp.bfloat16}, {}
        if regime == "f32_weights_cast_in_prepare":
            # the JAX kernel's default: a float32 tree cast as it is packed
            _, _, jp, tp = world
            prep_t = {"dtype": torch.bfloat16}
            regime = "mixed_confidence"
        cfg, conf, first_tran, first_frame, _ = REGIMES[regime]
        if first_tran is not None:
            first_tran = np.asarray(first_tran, np.float32)
        inputs = make_inputs(list(REGIMES).index(regime) + 1, conf)
        frames = jsig._sequence_frames(*inputs, first_tran, first_frame,
                                       None)
        carry = jax_prescan(jp, jm, cfg, frames)
        want = run_jax_mode(jp, jm, cfg, frames, carry, **prep_j)
        got = run_port_mode(tp, tm, port_cfg(cfg), inputs, first_tran,
                            first_frame, carry_from_jax(carry), **prep_t)
        assert_tree_close(want[:3], got[:3], BF16_ATOL)
        assert_tree_close(want[3], got[3], BF16_ATOL)
        if regime == "imu_updater_midchunk":
            assert not bool(got[3]["first_reach"])

    def test_chunk_chaining(self, bf16_world):
        _, tm, _, tp = bf16_world
        prep = serve_scan.prepare_serve_params(tp)
        assert prep["mode"] == "bf16"
        assert prep["stacks"]["rnn4"]["w_ih"][0].dtype == torch.bfloat16
        _chaining(tp, tm, SigMPConfig(), prep)

    def test_forward_offline(self, bf16_world):
        jm, tm, jp, tp = bf16_world
        cfg = JaxConfig(pallas_serve=True)
        j2dc, accc, oric = make_inputs(9, np.resize(MIXED, 24))
        want = jsig.forward_offline(jp, jm, cfg, j2dc, accc, oric,
                                    first_frame=True, return_contacts=True)
        got = tsig.forward_offline(tp, tm, port_cfg(cfg), j2dc, accc, oric,
                                   first_frame=True, return_contacts=True,
                                   device="cpu")
        assert_tree_close(want, got, BF16_ATOL)


def _jax_int8_frames():
    r"""``tests/test_pallas_serve.py::TestInt8Gates``'s frames."""
    key = jax.random.PRNGKey(11)
    ks = jax.random.split(key, 3)
    T = len(MIXED)
    j2dc = jax.random.uniform(ks[0], (T, 33, 3), minval=0.2, maxval=0.9)
    j2dc = j2dc.at[:, :, 2].set(jnp.asarray(MIXED, jnp.float32)[:, None])
    accc = jax.random.normal(ks[1], (T, 6, 3))
    oric = M.r6d_to_rotation_matrix(
        jax.random.normal(ks[2], (T * 6, 6))).reshape(T, 6, 3, 3)
    return tuple(np.array(x) for x in (j2dc, accc, oric))


class TestServeInt8:
    r"""int8 gates (``cfg.int8_compute``): the port's serve path against the
    JAX int8 serve kernel and the JAX ``int8_compute`` XLA scan."""

    def test_int8_agreement(self):
        from functools import partial
        jm, tm = make_models()
        jp, tp = make_params(0)
        jq, tq = jrnn.quantize_params(jp), trnn.quantize_params(tp)
        cfg8 = JaxConfig(int8_compute=True)
        inputs = _jax_int8_frames()
        first_tran = np.asarray([0.1, 0.2, 1.5], np.float32)
        frames = jsig._sequence_frames(*inputs, first_tran, True, None)
        carry0 = jax_prescan(jq, jm, cfg8, frames)
        kernel = run_jax_mode(jq, jm, cfg8, frames, carry0, int8_gates=True)
        step = jsig.make_step(jm, cfg8, include_first_frame_step=False,
                              output_contacts=True, cond_updater=False,
                              fuse_spec_heads=False)
        _, xla = jax.lax.scan(partial(step, jsig.prepare_scan_params(jq, True)),
                              carry0, frames)
        got = run_port_mode(tq, tm, port_cfg(cfg8), inputs, first_tran,
                            True, carry_from_jax(carry0), int8_gates=True)
        assert_tree_close(kernel[:2], got[:2], INT8_ATOL)
        assert_tree_close(xla[:2], got[:2], INT8_ATOL)
        # the int8 mode's quality bound against the float32 trajectory
        step_f = jsig.make_step(jm, JaxConfig(),
                                include_first_frame_step=False,
                                output_contacts=True, cond_updater=False,
                                fuse_spec_heads=False)
        carry_f = jsig.prescan_first_frame(
            jp, jm, jsig.init_carry(jp), jax.tree.map(lambda x: x[0], frames))
        _, (pose_f, _, _) = jax.lax.scan(partial(step_f, jp), carry_f, frames)
        assert float(np.abs(got[0].numpy() - np.asarray(pose_f)).max()) < 0.2

    def test_chunk_chaining(self, world):
        _, tm, _, tp = world
        prep = serve_scan.prepare_serve_params(trnn.quantize_params(tp),
                                               int8_gates=True)
        assert prep["mode"] == "int8"
        assert prep["stacks"]["rnn6"]["w_hh"][1].dtype == torch.int8
        _chaining(tp, tm, SigMPConfig(int8_compute=True), prep)

    def test_streaming_net_chunk(self, world):
        r"""``StreamingNet.forward_chunk`` on an int8 tree with
        ``int8_compute`` and ``pallas_serve``: a first frame through
        ``forward_online`` (the XLA-form int8 step), then two chunks, each
        side after its own prescan. The oracle is the JAX ``StreamingNet``
        with ``int8_compute`` and its XLA chunk scan: the JAX serve path of
        ``forward_chunk`` does not pass the int8 flag on to its kernel, which
        then refuses the int8 operands."""
        jm, tm, jp, tp = world
        cfg = JaxConfig(pallas_serve=True, int8_compute=True)
        j2dc, accc, oric = make_inputs(10, MIXED[:10])
        jnet = jsig.StreamingNet(jrnn.quantize_params(jp), jm,
                                 JaxConfig(int8_compute=True))
        tnet = tsig.StreamingNet(trnn.quantize_params(tp), tm, port_cfg(cfg),
                                 device="cpu")
        want = [tuple(np.asarray(x)[None] for x in jnet.forward_online(
            j2dc[0], accc[0], oric[0], first_frame=True))]
        got = [tuple(x.numpy()[None] for x in tnet.forward_online(
            j2dc[0], accc[0], oric[0], first_frame=True))]
        for sl in (slice(1, 6), slice(6, 10)):
            want.append(tuple(np.asarray(x) for x in jnet.forward_chunk(
                j2dc[sl], accc[sl], oric[sl])))
            got.append(tuple(x.numpy() for x in tnet.forward_chunk(
                j2dc[sl], accc[sl], oric[sl])))
        assert_tree_close(tuple(np.concatenate(x) for x in zip(*want)),
                          tuple(np.concatenate(x) for x in zip(*got)),
                          INT8_ATOL)
        assert_tree_close(jnet.carry, tnet.carry, INT8_ATOL)

    def test_mode_must_match_cfg(self, world):
        r"""``cfg.int8_compute`` runs only int8-gate operands, and int8-gate
        operands only under it, as in the JAX kernel."""
        _, tm, _, tp = world
        frames, carry = port_chunk(tp, tm, make_inputs(12, [0.9, 0.2]), None,
                                   True)
        consts = tail_constants(tm)
        f32 = serve_scan.prepare_serve_params(tp)
        int8 = serve_scan.prepare_serve_params(tp, int8_gates=True)
        for prep, cfg in ((f32, SigMPConfig(int8_compute=True)),
                          (int8, SigMPConfig())):
            with pytest.raises(ValueError, match="int8_gates"):
                serve_scan.serve_scan(prep, consts, cfg, frames, carry)

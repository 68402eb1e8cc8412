r"""The port's per-frame step with ``pallas_tail`` on against the JAX step
with ``pallas_tail`` on, in every regime of ``tests/test_pallas_tail.py``.

On the CPU the port's tail wrapper runs its plain PyTorch version
(``ops/geometry_tail.py::tail_plain``) and the JAX tail kernel runs in
Pallas interpret mode. Both sides get the same numpy inputs and the same
weights (JAX ``init_params``, carried across with ``params_from_numpy``);
the outputs and the whole final carry are compared.

Tolerance: 2e-4 absolute, as the JAX package's own tail-kernel test uses.
XLA and PyTorch sum the small matrix products in different orders, and the
differences compound through the six carried LSTM states over the run. The
reprojection regime divides by z^4 and gets 5e-4, as in the JAX test.

The helpers here are shared with ``test_torch_sig_mp.py``.
"""

import dataclasses
from functools import partial

import jax
import numpy as np
import pytest
import torch

import robustcap_tpu.math as M
from robustcap_tpu.config import SigMPConfig as JaxConfig
from robustcap_tpu.models import sig_mp as jsig
from robustcap_tpu.smpl import ParametricModel as JaxModel
from robustcap_tpu.smpl import synthetic_smpl_data as jax_synthetic
from robustcap_tpu_torch.config import SigMPConfig
from robustcap_tpu_torch.convert import params_from_numpy
from robustcap_tpu_torch.models import sig_mp as tsig
from robustcap_tpu_torch.smpl import ParametricModel, synthetic_smpl_data

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SMALL_SPECS = {
    "rnn2": (72, 69, 16, 0.4, True),
    "rnn3": (141, 3, 16, 0.4, False),
    "rnn4": (171, 69, 24, 0.4, False),
    "rnn6": (240, 3, 20, 0.4, False),
    "rnn7": (141, 144, 16, 0.1, False),
    "rnn8": (141, 2, 16, 0.4, False),
}

ATOL = 2e-4
CPU = torch.device("cpu")

# mixed regime: occluded, mid-confidence, and fully-confident frames
MIXED = [0.2, 0.75, 0.95, 0.1, 0.9, 0.72, 0.95, 0.3, 0.95, 0.95,
         0.05, 0.78, 0.95, 0.95, 0.2, 0.95]


def port_cfg(cfg: JaxConfig) -> SigMPConfig:
    r"""The port's config with the same field values."""
    return SigMPConfig(**dataclasses.asdict(cfg))


def make_models(num_verts=6890, blendshape=False):
    jm = JaxModel(data=jax_synthetic(num_verts=num_verts),
                  use_pose_blendshape=blendshape)
    tm = ParametricModel(data=synthetic_smpl_data(num_verts=num_verts),
                         use_pose_blendshape=blendshape, device="cpu")
    return jm, tm


def make_params(seed, specs=SMALL_SPECS):
    jp = jsig.init_params(jax.random.PRNGKey(seed), specs)
    return jp, params_from_numpy(jax.tree.map(np.array, jp), "cpu")


def make_inputs(seed, conf_pattern):
    r"""numpy frame stream whose per-frame confidence follows
    ``conf_pattern``: (j2dc [T,33,3], accc [T,6,3], oric [T,6,3,3])."""
    rng = np.random.RandomState(seed)
    T = len(conf_pattern)
    j2dc = rng.uniform(0.2, 0.9, (T, 33, 3)).astype(np.float32)
    j2dc[:, :, 2] = np.asarray(conf_pattern, np.float32)[:, None]
    accc = rng.randn(T, 6, 3).astype(np.float32)
    oric = np.array(M.r6d_to_rotation_matrix(
        rng.randn(T * 6, 6).astype(np.float32))).reshape(T, 6, 3, 3)
    return j2dc, accc, oric


def run_jax(params, model, cfg, inputs, cond_updater, first_tran=None,
            first_frame=False):
    frames = jsig._sequence_frames(*inputs, first_tran, first_frame, None)
    step = jsig.make_step(model, cfg, include_first_frame_step=False,
                          output_contacts=True, cond_updater=cond_updater)
    frame0 = jax.tree.map(lambda x: x[0], frames)
    carry = jsig.prescan_first_frame(params, model, jsig.init_carry(params),
                                     frame0)
    return jax.lax.scan(partial(step, params), carry, frames)


def run_port(params, model, cfg, inputs, cond_updater, first_tran=None,
             first_frame=False):
    frames = tsig._sequence_frames(*inputs, first_tran, first_frame, None,
                                   CPU)
    step = tsig.make_step(model, cfg, include_first_frame_step=False,
                          output_contacts=True, cond_updater=cond_updater)
    carry = tsig.prescan_first_frame(params, model, tsig.init_carry(params),
                                     tsig._frame_at(frames, 0))
    outs = []
    for t in range(len(frames["conf"])):
        carry, out = step(params, carry, tsig._frame_at(frames, t))
        outs.append(out)
    return carry, tuple(torch.stack(x) for x in zip(*outs))


def assert_tree_close(jax_tree, port_tree, atol=ATOL):
    r"""Same structure and keys; every leaf within ``atol``."""
    if isinstance(jax_tree, dict):
        assert set(jax_tree) == set(port_tree)
        for k in jax_tree:
            assert_tree_close(jax_tree[k], port_tree[k], atol)
    elif isinstance(jax_tree, (list, tuple)):
        assert len(jax_tree) == len(port_tree)
        for a, b in zip(jax_tree, port_tree):
            assert_tree_close(a, b, atol)
    else:
        want = np.asarray(jax_tree, np.float64)
        got = torch.as_tensor(port_tree).double().numpy()
        assert want.shape == got.shape
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.fixture(scope="module")
def world():
    jm, tm = make_models()
    jp, tp = make_params(0)
    return jm, tm, jp, tp


def _agree(world, cfg, inputs, cond_updater, atol=ATOL, model=None,
           **kw):
    jm, tm, jp, tp = world
    if model is not None:
        jm, tm = model
    jcfg = dataclasses.replace(cfg, pallas_tail=True)
    jc, jo = run_jax(jp, jm, jcfg, inputs, cond_updater, **kw)
    tc, to = run_port(tp, tm, port_cfg(jcfg), inputs, cond_updater, **kw)
    assert_tree_close(jo, to, atol)
    assert_tree_close(jc, tc, atol)
    return jc, tc


@pytest.mark.parametrize("cond_updater", [False, True])
def test_mixed_confidence(world, cond_updater):
    _agree(world, JaxConfig(), make_inputs(1, MIXED), cond_updater,
           first_tran=np.array([0.1, 0.2, 1.5], np.float32))


def test_floor_append_and_snap(world):
    # low contact threshold so cmax > threshold fires, all-confident stream
    # so the ring fills past 11 and the snap branch runs
    cfg = JaxConfig(contact_threshold=0.2, height_threshold=5.0)
    jc, tc = _agree(world, cfg, make_inputs(2, [0.95] * 20), True,
                    first_frame=True)
    assert int(jc["floor_cnt"]) == 11 and int(tc["floor_cnt"]) == 11


@pytest.mark.parametrize("cond_updater", [False, True])
def test_live_throttle(world, cond_updater):
    cfg = JaxConfig(live=True, update_vision_freq=3, conf_range=(0.5, 0.6))
    pattern = [0.3, 0.2, 0.9, 0.1, 0.2, 0.3, 0.1, 0.9, 0.2, 0.1]
    _agree(world, cfg, make_inputs(3, pattern), cond_updater,
           first_tran=np.array([0.0, 0.0, 2.0], np.float32))


def test_no_vision_updater(world):
    cfg = JaxConfig(use_vision_updater=False, use_flat_floor=False)
    _agree(world, cfg, make_inputs(4, MIXED), False,
           first_tran=np.array([0.0, 0.1, 1.0], np.float32))


def test_reproj_opt(world):
    # the refinement divides by z^4
    _agree(world, JaxConfig(use_reproj_opt=True), make_inputs(5, MIXED),
           True, atol=5e-4, first_tran=np.array([0.0, 0.1, 1.5], np.float32))


def test_pose_blendshape(world):
    _agree(world, JaxConfig(), make_inputs(6, MIXED), True,
           model=make_models(blendshape=True),
           first_tran=np.array([0.1, 0.0, 1.2], np.float32))


def test_tail_constants_clip_landmark_ids():
    r"""A 500-vertex body has fewer vertices than the SMPL ids of the
    landmarks: the gather clips them, as the JAX package's clamps them."""
    from robustcap_tpu.ops.pallas_tail import tail_constants as jax_consts
    from robustcap_tpu_torch.ops.geometry_tail import tail_constants
    jm, tm = make_models(num_verts=500, blendshape=True)
    want = jax_consts(jm)
    got = tail_constants(tm)
    np.testing.assert_array_equal(got["wsub"].numpy(), want["wsub"])
    np.testing.assert_array_equal(got["v0sub"].numpy(), want["v0sub"])
    np.testing.assert_array_equal(got["bone"].numpy(), want["bone"])
    np.testing.assert_array_equal(got["anc"].numpy(), want["anc"])
    # JAX re-lays posedirs as [27, 33, 24] (c*9+k, v, j) with j >= 1
    pd = got["pd"].numpy()                           # [3, 207, 33]
    for c in range(3):
        for k in range(9):
            for j in range(1, 24):
                np.testing.assert_array_equal(pd[c, (j - 1) * 9 + k],
                                              want["pd"][c * 9 + k, :, j])

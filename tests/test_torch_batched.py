r"""The port's batched step (``forward_offline_batched``) against the JAX
package's, against the port's own single-stream ``forward_offline`` row by
row, and the r6d diagnostic tap of the single-stream path.

Both packages get the same numpy frames and the same weights (JAX
``init_params``, carried across with ``params_from_numpy``). Tolerances:
float32 against JAX 5e-4 absolute, as ``tests/test_torch_sig_mp.py`` holds
``forward_offline`` against the golden trajectory (XLA and PyTorch sum in
other orders, compounded through the carried states); bf16 and int8 against
JAX with the bounds ``tests/test_torch_quant.py`` uses for those modes (the
two packages round at other places); each row against the port's
single-stream run 1e-5, as ``tests/test_sig_mp_step.py::TestBatched`` holds
the JAX package's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustcap_tpu.config import SigMPConfig as JaxConfig
from robustcap_tpu.models import sig_mp as jsig
from robustcap_tpu.nn import rnn as jrnn
from robustcap_tpu_torch.config import SigMPConfig
from robustcap_tpu_torch.models import sig_mp as tsig
from robustcap_tpu_torch.nn import rnn as trnn
from test_torch_tail import (make_inputs, make_models, make_params,
                             port_cfg)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL_JAX = 5e-4
ATOL_ROW = 1e-5
T = 24
LENGTHS = (24, 17, 11)
# per row: (ground-truth first translation, first_frame)
SEEDS = ((np.array([0.1, -0.2, 3.0], np.float32), False), (None, True),
         (None, False))


def _conf(seed, n):
    r"""Mixed confidence with an occluded run, so that the refeed fires."""
    rng = np.random.RandomState(seed)
    conf = rng.choice([0.2, 0.72, 0.75, 0.95, 0.95], n).astype(np.float32)
    conf[n // 3:n // 3 + 4] = 0.1
    return conf


def _rows():
    return [make_inputs(30 + b, _conf(b, n)) for b, n in enumerate(LENGTHS)]


def _stack(rows):
    r"""numpy frames ``[B, T, ...]``; a row's padding repeats its last
    frame, as ``eval.runner.stack_frames`` pads."""
    out = {k: [] for k in ("j2dc", "accc", "oric", "first_tran",
                           "first_tran_valid", "first_frame", "gravityc")}
    for (j2dc, accc, oric), (ft, ff) in zip(rows, SEEDS):
        n = len(j2dc)

        def pad(x):
            return np.concatenate([x, np.repeat(x[-1:], T - n, 0)])

        out["j2dc"].append(pad(j2dc))
        out["accc"].append(pad(accc))
        out["oric"].append(pad(oric))
        out["first_tran"].append(np.zeros((T, 3), np.float32)
                                 if ft is None else np.tile(ft, (T, 1)))
        out["first_tran_valid"].append((np.arange(T) == 0) & (ft is not None))
        out["first_frame"].append((np.arange(T) == 0) & ff)
        out["gravityc"].append(np.tile(jsig.DEFAULT_GRAVITY, (T, 1)))
    return {k: np.stack(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def world():
    jm, tm = make_models(num_verts=500)   # MP landmark ids get clipped
    jp, tp = make_params(0)
    rows = _rows()
    return jm, tm, jp, tp, rows, _stack(rows)


def _kind(jp, tp, kind):
    if kind == "int8":
        return jrnn.quantize_params(jp), trnn.quantize_params(tp)
    if kind == "bf16":
        return (jrnn.cast_params(jp, jnp.bfloat16),
                trnn.cast_params(tp, torch.bfloat16))
    return jp, tp


def _run(world, cfg, kind="f32"):
    jm, tm, jp, tp, _, frames = world
    jp, tp = _kind(jp, tp, kind)
    want = jsig.forward_offline_batched(
        jp, jm, cfg, {k: jnp.asarray(v) for k, v in frames.items()})
    got = tsig.forward_offline_batched(tp, tm, port_cfg(cfg), frames,
                                       lengths=LENGTHS, device="cpu")
    return (tuple(np.asarray(x, np.float32) for x in want),
            tuple(x.float().numpy() for x in got))


def _valid(x):
    r"""Every row's frames up to its length, end to end."""
    return np.concatenate([x[b, :n] for b, n in enumerate(LENGTHS)])


@pytest.fixture(scope="module")
def f32_runs(world):
    return _run(world, JaxConfig())


def test_shapes_and_lengths(world, f32_runs):
    _, (pose, tran) = f32_runs
    assert pose.shape == (3, max(LENGTHS), 24, 3, 3)
    assert tran.shape == (3, max(LENGTHS), 3)
    full = tsig.forward_offline_batched(world[3], world[1], SigMPConfig(),
                                        world[5], device="cpu")
    assert tuple(full[0].shape) == (3, T, 24, 3, 3)
    np.testing.assert_array_equal(full[0][:, :max(LENGTHS)].numpy(), pose)


def test_batched_matches_jax(f32_runs):
    (pose_j, tran_j), (pose_t, tran_t) = f32_runs
    for want, got in ((pose_j, pose_t), (tran_j, tran_t)):
        np.testing.assert_allclose(_valid(got), _valid(want), atol=ATOL_JAX)


def test_live_mode_matches_jax(world):
    r"""Live mode: the throttled landmark recompute and refeed, per row."""
    cfg = dataclasses.replace(JaxConfig.live_mode(), update_vision_freq=3)
    (pose_j, tran_j), (pose_t, tran_t) = _run(world, cfg)
    for want, got in ((pose_j, pose_t), (tran_j, tran_t)):
        np.testing.assert_allclose(_valid(got), _valid(want), atol=ATOL_JAX)


@pytest.mark.parametrize("kind,int8_compute", [("int8", True),
                                               ("bf16", False)])
def test_quantized_batched_matches_jax(world, f32_runs, kind, int8_compute):
    r"""bf16 and ``int8_compute`` banks: within the bounds
    ``tests/test_torch_quant.py`` holds the single-stream path to, of the
    JAX package's run of the same mode and of float32. (int8 weight-only:
    ``test_batched_int8_close_to_f32``.)"""
    (pose_j, tran_j), (pose_q, tran_q) = _run(
        world, JaxConfig(int8_compute=int8_compute), kind)
    _, (pose_f, tran_f) = f32_runs
    for b, n in enumerate(LENGTHS):
        for pose, tran in ((pose_j, tran_j), (pose_f, tran_f)):
            d = np.abs(pose_q[b, :n] - pose[b, :n])
            assert d.max() < 0.3 and d.mean() < 0.02
            assert np.abs(tran_q[b, :n] - tran[b, :n]).max() < 0.05
    rtr = np.einsum("ntjab,ntjac->ntjbc", pose_q, pose_q)
    assert np.abs(rtr - np.eye(3)).max() < 0.02


ROW_CONFIGS = {
    "f32": SigMPConfig(),
    "int8c": SigMPConfig(int8_compute=True),
    "reproj": SigMPConfig(use_reproj_opt=True),
    "no_updaters": SigMPConfig(use_vision_updater=False,
                               use_imu_updater=False, use_flat_floor=False),
}


@pytest.mark.parametrize("kind", list(ROW_CONFIGS))
def test_rows_match_single_stream(world, f32_runs, kind):
    r"""Each row of the batch against the port's own ``forward_offline`` on
    that row's frames and seeds: the batched prescan keeps the carry of a
    row whose frame 0 is not a first frame, and each option of the step
    (the reprojection refinement, the updaters off) batches."""
    _, tm, _, tp, rows, frames = world
    cfg = ROW_CONFIGS[kind]
    if kind == "int8c":
        tp = trnn.quantize_params(tp)
    if kind == "f32":
        _, (pose_b, tran_b) = f32_runs
    else:
        pose_b, tran_b = (x.numpy() for x in tsig.forward_offline_batched(
            tp, tm, cfg, frames, lengths=LENGTHS, device="cpu"))
    for b, ((j2dc, accc, oric), (ft, ff)) in enumerate(zip(rows, SEEDS)):
        pose, tran = tsig.forward_offline(tp, tm, cfg, j2dc, accc, oric,
                                          first_tran=ft, first_frame=ff,
                                          device="cpu")
        n = LENGTHS[b]
        np.testing.assert_allclose(pose_b[b, :n], pose.numpy(),
                                   atol=ATOL_ROW)
        np.testing.assert_allclose(tran_b[b, :n], tran.numpy(),
                                   atol=ATOL_ROW)


def test_batched_int8_close_to_f32():
    r"""``tests/test_quantization.py``'s batched case: a quantized bank's
    trajectory within a few degrees and centimetres of float32 over 40
    frames."""
    from robustcap_tpu_torch.math.angular import (
        axis_angle_to_rotation_matrix)
    from robustcap_tpu_torch.smpl import (ParametricModel,
                                          synthetic_smpl_data)
    model = ParametricModel(data=synthetic_smpl_data(), device="cpu")
    specs = {k: (i, o, 48, d, w)
             for k, (i, o, _, d, w) in tsig.RNN_SPECS.items()}
    params = tsig.init_params(torch.Generator().manual_seed(0), specs,
                              device="cpu")
    n = 40
    rng = np.random.RandomState(0)
    j2dc = (rng.randn(n, 33, 3) * 0.1).astype(np.float32)
    j2dc[..., 2] = np.clip(rng.uniform(0.3, 1.0, (n, 1)), 0, 1)
    accc = rng.randn(n, 6, 3).astype(np.float32)
    aa = (rng.randn(n * 6, 3) * 0.2).astype(np.float32)
    oric = axis_angle_to_rotation_matrix(torch.from_numpy(aa)).reshape(
        n, 6, 3, 3).numpy()
    frames = {
        "j2dc": j2dc[None], "accc": accc[None], "oric": oric[None],
        "first_tran": np.zeros((1, n, 3), np.float32),
        "first_tran_valid": (np.arange(n) == 0)[None],
        "first_frame": np.zeros((1, n), bool),
        "gravityc": np.broadcast_to(np.asarray([0, -1.0, 0], np.float32),
                                    (1, n, 3)).copy(),
    }

    def run(p):
        pose, tran = tsig.forward_offline_batched(p, model, SigMPConfig(),
                                                  frames, device="cpu")
        return pose[0].float().numpy(), tran[0].float().numpy()

    pose_f, tran_f = run(params)
    pose_q, tran_q = run(trnn.quantize_params(params))
    assert np.abs(pose_q - pose_f).max() < 0.3
    assert np.abs(pose_q - pose_f).mean() < 0.02
    assert np.abs(tran_q - tran_f).max() < 0.05


def test_r6d_tap_matches_jax(world):
    r"""``forward_offline(return_r6d=True)`` (``make_step(output_r6d=True)``)
    appends the raw rnn7 head after the contacts, as the JAX package
    does."""
    jm, tm, jp, tp, rows, _ = world
    j2dc, accc, oric = rows[0]
    want = jsig.forward_offline(jp, jm, JaxConfig(), j2dc, accc, oric,
                                first_frame=True, return_contacts=True,
                                return_r6d=True)
    got = tsig.forward_offline(tp, tm, SigMPConfig(), j2dc, accc, oric,
                               first_frame=True, return_contacts=True,
                               return_r6d=True, device="cpu")
    assert len(got) == 4 and tuple(got[3].shape) == (len(j2dc), 144)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL_JAX)


def test_r6d_tap_is_pure_diagnostic(world):
    r"""The tap changes no other output, and the serve path, which does not
    keep the head, refuses it."""
    _, tm, _, tp, rows, _ = world
    j2dc, accc, oric = rows[1]
    cfg = SigMPConfig()
    pose, tran = tsig.forward_offline(tp, tm, cfg, j2dc, accc, oric,
                                      first_tran=SEEDS[0][0], device="cpu")
    pose2, tran2, r6d = tsig.forward_offline(
        tp, tm, cfg, j2dc, accc, oric, first_tran=SEEDS[0][0],
        return_r6d=True, device="cpu")
    assert torch.equal(pose, pose2) and torch.equal(tran, tran2)
    assert tuple(r6d.shape) == (len(j2dc), 144)
    with pytest.raises(ValueError, match="return_r6d"):
        tsig.forward_offline(tp, tm, dataclasses.replace(
            cfg, pallas_serve=True), j2dc, accc, oric, return_r6d=True,
            device="cpu")


def test_batched_prescan_keeps_other_rows(world):
    r"""The batched prescan advances rnn4/rnn6 only in the rows whose
    frame 0 is a first frame."""
    _, tm, _, tp, _, frames = world
    carry = tsig.init_carry(tp, batch_shape=(3,))
    frame0 = {k: torch.as_tensor(v[:, 0]) for k, v in frames.items()}
    out = tsig.prescan_first_frame(tp, tm, carry, frame0)
    first = frames["first_frame"][:, 0]
    assert first.tolist() == [False, True, False]
    for name in ("rnn4", "rnn6"):
        for new, old in zip(out["states"][name], carry["states"][name]):
            changed = (new != old).flatten(2).any(-1).any(0).numpy()
            assert changed.tolist() == first.tolist()
    assert (out["pc_first"][~torch.from_numpy(first)] == 0).all()
    assert (out["pc_first"][1] != 0).any()

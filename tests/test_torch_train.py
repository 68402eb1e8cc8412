r"""The port's training pieces (``robustcap_tpu_torch/train``, the padded
forwards of ``nn/rnn.py`` and the math they use) against the JAX package.

Both packages get the same numpy inputs; parameters go JAX -> numpy ->
``params_from_numpy``. Tolerances, stated where used: what numpy computes
on the host is held equal (batches); float32 body and rotation math
summed in another order within 1e-5 (features, losses); the padded LSTM
forwards within 2e-5 (as ``tests/test_torch_rnn.py``) and their gradients
within 1e-4 relative to the largest entry of each gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustcap_tpu import math as JM
from robustcap_tpu.nn import rnn as jrnn
from robustcap_tpu.preprocess import build_fixture_dataset
from robustcap_tpu.smpl import ParametricModel as JModel
from robustcap_tpu.smpl import synthetic_smpl_data as j_smpl_data
from robustcap_tpu.train import data as jdata
from robustcap_tpu.train import features as JF
from robustcap_tpu.train import losses as jloss
from robustcap_tpu_torch import math as TM
from robustcap_tpu_torch.convert import params_from_numpy
from robustcap_tpu_torch.device import tree_map
from robustcap_tpu_torch.nn import rnn as trnn
from robustcap_tpu_torch.smpl import ParametricModel as TModel
from robustcap_tpu_torch.smpl import synthetic_smpl_data as t_smpl_data
from robustcap_tpu_torch.train import data as tdata
from robustcap_tpu_torch.train import features as TF
from robustcap_tpu_torch.train import losses as tloss
from robustcap_tpu_torch.train.loop import _tensor_leaves

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FEATURE_ATOL = 1e-5
FORWARD_ATOL = 2e-5
GRAD_RTOL = 1e-4


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.fixture(scope="module")
def world():
    r"""One fixture corpus (numpy, from the JAX package) and both packages'
    body models over the same procedural SMPL data. A ``joint2d_occ`` key
    (the clean keypoints, jittered) drives rnn4's occluded variant."""
    jmodel = JModel(data=j_smpl_data())
    tmodel = TModel(data=t_smpl_data(), device="cpu")
    ds = build_fixture_dataset(jmodel, n_seq=2, T=36, n_cam=2, seed=1)
    rng = np.random.RandomState(2)
    ds["joint2d_occ"] = [[np.asarray(kp) + rng.randn(*np.shape(kp)).astype(
        np.float32) * 0.01 for kp in cams] for cams in ds["joint2d_mp"]]
    return jmodel, tmodel, ds


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------


def _toy(seed, n, D, L, with_init=False, split=-1, augment=False):
    rng = np.random.RandomState(seed)
    data = [rng.randn(rng.randint(3, 15), D).astype(np.float32)
            for _ in range(n)]
    label = [rng.randn(len(d), L).astype(np.float32) for d in data]

    def aug(r, x):
        return (x + r.normal(0, 0.1, x.shape)).astype(np.float32)

    kw = dict(split_size=split, with_init=with_init,
              augment_fn=aug if augment else None)
    return (jdata.SeqDataset(data, label, **kw),
            tdata.SeqDataset(data, label, **kw))


@pytest.mark.parametrize("case", [
    dict(with_init=True), dict(split=5, pad_to=16),
    dict(split=4, drop_last=True), dict(augment=True, split=6)])
def test_padded_batches_match_jax(case):
    r"""The same ``RandomState`` gives the same batches, in the same order,
    equal to the bit."""
    pad_to = case.pop("pad_to", 0)
    drop_last = case.pop("drop_last", False)
    jds, tds = _toy(0, 11, 4, 3, **case)
    jb = list(jdata.padded_batches(jds, 3, np.random.RandomState(7),
                                   drop_last=drop_last, pad_to=pad_to))
    tb = list(tdata.padded_batches(tds, 3, np.random.RandomState(7),
                                   drop_last=drop_last, pad_to=pad_to))
    assert len(jb) == len(tb) > 0
    for a, b in zip(jb, tb):
        for x, y in zip(a, b):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# Features
# ---------------------------------------------------------------------------

FEATURES = {
    "rnn2": lambda F, ds, m: F.rnn2_features(ds),
    "rnn3": lambda F, ds, m: F.rnn3_features(ds),
    "rnn4": lambda F, ds, m: F.rnn4_features_aist(ds, num_cameras=2),
    "rnn4_no_occ": lambda F, ds, m: F.rnn4_features_aist(ds,
                                                          include_occ=False),
    "rnn6": lambda F, ds, m: F.rnn6_features_aist(ds, num_cameras=2),
    "rnn7": lambda F, ds, m: F.rnn7_features(ds, m),
    "rnn8": lambda F, ds, m: F.rnn8_features(ds),
    "amass_mp_base": lambda F, ds, m: F.amass_mp_base(ds),
}


@pytest.mark.parametrize("name", sorted(FEATURES))
def test_features_match_jax(world, name):
    jmodel, tmodel, ds = world
    jd, jl = FEATURES[name](JF, ds, jmodel)
    td, tl = FEATURES[name](TF, ds, tmodel)
    assert len(jd) == len(td) > 0 and len(jl) == len(tl)
    for a, b in zip(jd + jl, td + tl):
        assert b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(b, np.asarray(a), atol=FEATURE_ATOL,
                                   rtol=0)
    if name == "rnn4":
        assert len(td) == 8          # 2 motions x 2 cameras x clean/occluded


def test_rnn7_pelvis_column_not_rotated(world):
    r"""The pelvis IMU's orientation stays in the world frame."""
    _, tmodel, ds = world
    d, l = TF.rnn7_features(ds, tmodel)
    assert d[0].shape == (34, 141) and l[0].shape == (34, 144)
    raw = np.asarray(ds["imu_ori"][0])[1:-1, 5]
    np.testing.assert_allclose(d[0][:, 18 + 5 * 9:18 + 6 * 9],
                               raw.reshape(-1, 9), atol=1e-5)


@pytest.mark.parametrize("target,yaw", [("rnn4", (-180.0, 180.0)),
                                        ("rnn6", (-90.0, 90.0))])
def test_amass_camera_augment_matches_jax(world, target, yaw):
    r"""With the camera rotation and translation uniforms pinned and a
    confidence pool of 1.0 (the keypoint noise is then 0 and the pool draw
    moot), both packages synthesize the same camera view."""
    _, _, ds = world
    d, l = JF.amass_mp_base(ds)
    R = np.asarray(JM.euler_angle_to_rotation_matrix(
        jnp.asarray([[0.4, -0.2, 0.05]]), seq="YXZ"))[0]
    draws = {"Rc0c": R, "uniform3": np.array([0.3, 0.6, 0.2], np.float32)}
    pool = np.ones(64, np.float32)
    jd, jl = JF.amass_camera_augment(jax.random.PRNGKey(0), jnp.asarray(d[0]),
                                     jnp.asarray(l[0]), jnp.asarray(pool),
                                     target=target, yaw=yaw, draws=draws)
    td, tl = TF.amass_camera_augment(torch.Generator().manual_seed(0),
                                     torch.from_numpy(d[0]),
                                     torch.from_numpy(l[0]),
                                     torch.from_numpy(pool), target=target,
                                     yaw=yaw, draws=draws)
    np.testing.assert_allclose(_np(td), np.asarray(jd), atol=FEATURE_ATOL)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=FEATURE_ATOL)
    # drawn (not pinned): subjects in front of the camera, confidences
    # taken from the pool
    td, tl = TF.amass_camera_augment(torch.Generator().manual_seed(1),
                                     torch.from_numpy(d[0]),
                                     torch.from_numpy(l[0]),
                                     torch.from_numpy(pool * 0.5),
                                     target=target, yaw=yaw)
    assert td.shape == jd.shape and tl.shape == jl.shape
    assert torch.isfinite(td).all()
    assert torch.all(td[:, 72:171].reshape(-1, 33, 3)[..., 2] == 0.5)
    if target == "rnn6":
        assert float(tl[:, 2].min()) > 0


def test_rotation_helpers():
    r"""``r6d_to_rotation_matrix_nd`` equals JAX's; the random rotations are
    rotations, reproducible from their generator, and the constrained ones
    stay within their ranges."""
    x = np.random.RandomState(0).randn(3, 4, 6).astype(np.float32)
    np.testing.assert_allclose(
        _np(TM.r6d_to_rotation_matrix_nd(torch.from_numpy(x))),
        np.asarray(JM.r6d_to_rotation_matrix_nd(jnp.asarray(x))), atol=1e-6)
    for fn, kw in ((TM.generate_random_rotation_matrix, {}),
                   (TM.generate_random_rotation_matrix_constrained,
                    dict(y=(-90, 90), p=(-30, 30), r=(-5, 5)))):
        R = fn(torch.Generator().manual_seed(3), n=50, **kw)
        assert R.shape == (50, 3, 3)
        eye = torch.eye(3).expand(50, 3, 3)
        assert torch.allclose(R @ R.transpose(1, 2), eye, atol=1e-5)
        assert torch.allclose(torch.linalg.det(R), torch.ones(50), atol=1e-5)
        assert torch.equal(R, fn(torch.Generator().manual_seed(3), n=50, **kw))
    R = TM.generate_random_rotation_matrix_constrained(
        torch.Generator().manual_seed(4), n=200, y=(-90, 90), p=(-30, 30),
        r=(-5, 5))
    # YXZ: R = Ry Rx Rz, so R[1, 2] = -sin(pitch) and the yaw sits in row 0/2
    pitch = torch.rad2deg(torch.asin(-R[:, 1, 2]))
    yaw = torch.rad2deg(torch.atan2(R[:, 0, 2], R[:, 2, 2]))
    assert pitch.abs().max() <= 30 + 1e-3 and yaw.abs().max() <= 90 + 1e-3
    assert pitch.abs().max() > 20 and yaw.abs().max() > 60


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _loss_pairs(world):
    jmodel, tmodel, _ = world
    pw = np.array([2.0, 0.5], np.float32)
    return {
        "masked_mse": (jloss.masked_mse, tloss.masked_mse, 6),
        "masked_distance": (jloss.masked_distance, tloss.masked_distance, 9),
        "velocity_horizon": (jloss.velocity_horizon_loss,
                             tloss.velocity_horizon_loss, 3),
        "fk_pose": (jloss.make_fk_pose_loss(jmodel),
                    tloss.make_fk_pose_loss(tmodel), 144),
        "bce_pos_weight": (jloss.masked_bce_pos_weight(pw),
                           tloss.masked_bce_pos_weight(pw), 2),
    }


@pytest.mark.parametrize("name", ["masked_mse", "masked_distance",
                                  "velocity_horizon", "fk_pose",
                                  "bce_pos_weight"])
def test_losses_and_gradients_match_jax(world, name):
    r"""Value and gradient (``jax.grad``) with varied lengths; T=65 puts
    every horizon window of the velocity loss on some row."""
    jfn, tfn, D = _loss_pairs(world)[name]
    rng = np.random.RandomState(5)
    T, B = 65, 4
    ys = rng.randn(T, B, D).astype(np.float32)
    labels = rng.randn(T, B, D).astype(np.float32)
    if name == "bce_pos_weight":
        labels = (labels > 0).astype(np.float32)
    lengths = np.array([65, 61, 20, 7], np.int32)
    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(ys), jnp.asarray(labels),
                                     jnp.asarray(lengths))
    t_ys = torch.from_numpy(ys).requires_grad_()
    tv = tfn(t_ys, torch.from_numpy(labels), torch.from_numpy(lengths))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    g = np.asarray(jg)
    np.testing.assert_allclose(_np(t_ys.grad), g,
                               atol=GRAD_RTOL * np.abs(g).max())
    assert np.all(_np(t_ys.grad)[20:, 2] == 0)   # past a length: no gradient


# ---------------------------------------------------------------------------
# Padded forwards
# ---------------------------------------------------------------------------


def _pair(key, n_in, n_out, hidden, with_init):
    jp = jrnn.init_rnn_params(jax.random.PRNGKey(key), n_in, n_out, hidden,
                              2, with_init)
    return jp, params_from_numpy(jax.tree.map(np.array, jp), "cpu")


def _grad_close(want, got):
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want,
                               atol=GRAD_RTOL * max(np.abs(want).max(), 1e-6))


PADDED = {"cudnn_path": trnn.rnn_forward_padded,
          "plain_loop": trnn.rnn_forward_padded_plain}


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("path", sorted(PADDED))
def test_rnn_forward_padded_matches_jax(path, with_init):
    r"""Outputs, final (h, c) and the gradients of every parameter and of
    the input, rows of several lengths, padded past the longest. The
    ``nn.LSTM`` path runs the CPU kernel here and cuDNN on the card."""
    jp, tp = _pair(1, 10, 5, 12, with_init)
    rng = np.random.RandomState(0)
    T, B = 11, 5
    xs = rng.randn(T, B, 10).astype(np.float32)
    lengths = np.array([9, 3, 6, 1, 9], np.int32)
    init = rng.randn(B, 5).astype(np.float32)
    w = rng.randn(T, B, 5).astype(np.float32)

    def j_loss(p, x):
        s0 = jrnn.init_net_apply(p, jnp.asarray(init)) if with_init else None
        ys, (h, c) = jrnn.rnn_forward_padded(p, x, jnp.asarray(lengths), s0)
        return (ys * w).sum() + (h ** 2).sum() + (c * 0.5).sum(), (ys, h, c)

    (_, (jy, jh, jc)), (jgp, jgx) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(xs))

    tp = tree_map(lambda t: t.clone().requires_grad_(), tp)
    tx = torch.from_numpy(xs).requires_grad_()
    s0 = trnn.init_net_apply(tp, torch.from_numpy(init)) if with_init \
        else None
    ys, (h, c) = PADDED[path](tp, tx, lengths, s0)
    ((ys * torch.from_numpy(w)).sum() + (h ** 2).sum()
     + (c * 0.5).sum()).backward()
    for a, b in ((jy, ys), (jh, h), (jc, c)):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=FORWARD_ATOL)
    assert np.all(_np(ys)[3:, 1] == 0) and np.all(_np(ys)[9:] == 0)
    _grad_close(jgx, tx.grad)
    for a, b in zip(jax.tree.leaves(jgp), _tensor_leaves(tp)):
        _grad_close(a, b.grad)


@pytest.mark.parametrize("path", sorted(PADDED))
def test_rnn_forward_padded_dropout(path):
    r"""With dropout: outputs past a length stay zero, the final carry is
    the state at the length (linear2 of its top h is the last valid
    output), and without a generator (eval) it equals dropout 0."""
    _, tp = _pair(2, 10, 5, 12, False)
    xs = torch.from_numpy(np.random.RandomState(1).randn(8, 4, 10)
                          .astype(np.float32))
    lengths = np.array([8, 2, 5, 8])
    fn = PADDED[path]
    with torch.random.fork_rng():
        torch.manual_seed(0)
        ys, (h, c) = fn(tp, xs, lengths, dropout=0.5,
                        generator=torch.Generator().manual_seed(3))
    ref, _ = fn(tp, xs, lengths)
    assert not torch.allclose(ys, ref)
    for b, L in enumerate(lengths):
        assert torch.all(ys[L:, b] == 0)
        last = h[-1, b] @ tp["linear2"]["w"].T + tp["linear2"]["b"]
        torch.testing.assert_close(last, ys[L - 1, b], atol=1e-6, rtol=0)
    no_gen, state = fn(tp, xs, lengths, dropout=0.5)
    assert torch.equal(no_gen, ref)
    assert torch.allclose(ref, fn(tp, xs, lengths)[0])
    with pytest.raises(ValueError, match="host"):
        fn(tp, xs, torch.as_tensor(lengths, device="meta"))


def test_pure_and_cycle_match_jax():
    r"""PureRNN (``nn.LSTM`` with ``proj_size``) and CycleRNN from one torch
    state dict, converted by each package."""
    torch.manual_seed(0)
    pure = torch.nn.LSTM(7, 10, 2, proj_size=4)
    sd = {f"rnn.{k}": v.detach().numpy() for k, v in
          pure.state_dict().items()}
    rng = np.random.RandomState(3)
    xs = rng.randn(9, 3, 7).astype(np.float32)
    lengths = np.array([9, 4, 1])
    want = jrnn.pure_rnn_forward_padded(jrnn.pure_rnn_params_from_torch(sd),
                                        jnp.asarray(xs), jnp.asarray(lengths))
    got = trnn.pure_rnn_forward_padded(
        trnn.pure_rnn_params_from_torch(sd, device="cpu"),
        torch.from_numpy(xs), lengths)
    assert got.shape == (9, 3, 4)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=FORWARD_ATOL)

    cycle = torch.nn.ModuleDict({"linear1": torch.nn.Linear(7, 12),
                                 "rnn": torch.nn.LSTM(12, 12, 2),
                                 "linear2": torch.nn.Linear(12, 3)})
    sd = {k: v.detach().numpy() for k, v in cycle.state_dict().items()}
    for pred_weight in (1.0, 0.7):
        want = jrnn.cycle_rnn_forward_padded(
            jrnn.cycle_rnn_params_from_torch(sd), jnp.asarray(xs),
            jnp.asarray(lengths), pred_weight)
        got = trnn.cycle_rnn_forward_padded(
            trnn.cycle_rnn_params_from_torch(sd, device="cpu"),
            torch.from_numpy(xs), lengths, pred_weight)
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   atol=FORWARD_ATOL)

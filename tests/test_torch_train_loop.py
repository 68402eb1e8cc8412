r"""The port's training loop, checkpoints, trainers and ``train``/``quantize``
commands against the JAX package.

The loop runs on ``TestLoop``'s toy data (``tests/test_train.py``) from one
init in both packages. Bounds: per-step losses within 2e-5 relative
(float32 forward and gradient rounding, about 1e-5, carried through up to
12 Adam steps); the best parameters within 1e-3 of their
motion from the init (Adam divides by the root of the second moment, so a
gradient near 0 turns a rounding into a step: the whole loop is held by
the motion, the first step's gradients by ``tests/test_torch_train.py``).
"""

import functools
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from robustcap_tpu.nn.rnn import init_rnn_params as j_init_rnn_params
from robustcap_tpu.nn.rnn import quantize_params as j_quantize_params
from robustcap_tpu.preprocess import build_fixture_dataset
from robustcap_tpu.smpl import ParametricModel as JModel
from robustcap_tpu.smpl import synthetic_smpl_data as j_smpl_data
from robustcap_tpu.train import loop as jloop
from robustcap_tpu.train import trainers as jtrainers
from robustcap_tpu_torch import config as TC
from robustcap_tpu_torch.__main__ import main
from robustcap_tpu_torch.convert import params_from_numpy
from robustcap_tpu_torch.nn.rnn import quantize_params
from robustcap_tpu_torch.smpl import ParametricModel as TModel
from robustcap_tpu_torch.smpl import synthetic_smpl_data as t_smpl_data
from robustcap_tpu_torch.train import loop as tloop
from robustcap_tpu_torch.train import trainers as ttrainers
from robustcap_tpu_torch.train.data import SeqDataset
from robustcap_tpu_torch.train.loop import _tensor_leaves
from robustcap_tpu_torch.train.losses import masked_mse

LOSS_RTOL = 2e-5
MOTION_SHARE = 1e-3


def _toy_data():
    r"""``TestLoop``'s learnable toy: label = running mean of the input."""
    rng = np.random.RandomState(0)
    data = [rng.randn(20, 8).astype(np.float32) for _ in range(8)]
    label = [np.cumsum(d, 0).astype(np.float32)[:, :2] / 20 for d in data]
    return data, label


def _toy_params(hidden=16):
    jp = j_init_rnn_params(jax.random.PRNGKey(0), 8, 2, hidden, 2)
    return jax.tree.map(np.array, jp)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f.read().splitlines()]


def _port_train(tmp_path, num_epoch, **kw):
    data, label = _toy_data()
    ds = SeqDataset(data, label, split_size=10)
    kw = dict(dict(batch_size=4, learning_rate=1e-2, clip_grad_norm=1.0),
              **kw)
    return tloop.train(params_from_numpy(_toy_params(), "cpu"),
                       ttrainers.make_forward_fn(0.0), masked_mse, ds, ds,
                       str(tmp_path), num_epoch=num_epoch, device="cpu", **kw)


def test_loop_matches_jax(tmp_path):
    r"""Same init, dropout 0, clip 1.0, lr 1e-2, 3 epochs, a validation
    after every step: each step's loss and validation loss, and the best
    parameters."""
    from robustcap_tpu.train import data as jdata
    from robustcap_tpu.train import losses as jlosses
    data, label = _toy_data()
    p0 = _toy_params()
    jds = jdata.SeqDataset(data, label, split_size=10)
    kw = dict(num_epoch=3, batch_size=4, learning_rate=1e-2,
              clip_grad_norm=1.0, num_iter_between_vald=1)
    jbest = jloop.train(jax.tree.map(jax.numpy.asarray, p0),
                        jtrainers.make_forward_fn(0.0), jlosses.masked_mse,
                        jds, jds, str(tmp_path / "jax"), **kw)
    tbest = _port_train(tmp_path / "port", **kw)
    jrec = _records(tmp_path / "jax" / "metrics.jsonl")
    trec = _records(tmp_path / "port" / "metrics.jsonl")
    assert len(jrec) == len(trec) == 12
    for a, b in zip(jrec, trec):
        assert (a["epoch"], a["it"], a["total_it"]) == \
            (b["epoch"], b["it"], b["total_it"])
        for key in ("train_loss", "vald_loss"):
            np.testing.assert_allclose(b[key], a[key], rtol=LOSS_RTOL)
    assert trec[-1]["vald_loss"] < trec[0]["vald_loss"]
    for want, got, start in zip(jax.tree.leaves(jbest), _tensor_leaves(tbest),
                                jax.tree.leaves(p0)):
        motion = np.abs(np.asarray(want) - start).max()
        assert motion > 1e-2
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=MOTION_SHARE * motion)


def test_train_reduces_loss_and_resumes(tmp_path, capsys):
    r"""``TestLoop.test_train_reduces_loss_and_resumes``, plus: the resumed
    run picks up the epoch, the iteration count and the optimizer state."""
    _port_train(tmp_path, 8)
    recs = _records(tmp_path / "metrics.jsonl")
    assert min(r["vald_loss"] for r in recs[1:]) < recs[0]["vald_loss"]
    assert os.path.exists(tmp_path / "best_weights.pkl")
    capsys.readouterr()
    assert _port_train(tmp_path, 9) is not None
    out = capsys.readouterr().out
    assert "resumed: epoch 7 it 4 total_it 32" in out
    assert "reinitializing" not in out
    assert _records(tmp_path / "metrics.jsonl")[-1]["total_it"] == 36


def test_resume_skips_the_iterations_done(tmp_path, capsys):
    r"""A run stopped after two of an epoch's four iterations resumes at the
    third; a saved optimizer state that does not fit, or the JAX package's
    optax pickle, is reported and replaced by a fresh one."""
    _port_train(tmp_path, 1, num_iter_between_vald=1)
    info = json.load(open(tmp_path / "train_info.json"))
    info.update(it=2, total_it=2)
    json.dump(info, open(tmp_path / "train_info.json", "w"))
    os.remove(tmp_path / "metrics.jsonl")
    capsys.readouterr()
    _port_train(tmp_path, 1, num_iter_between_vald=1)
    assert [r["it"] for r in _records(tmp_path / "metrics.jsonl")] == [3, 4]
    assert "reinitializing" not in capsys.readouterr().out

    small = _tensor_leaves(params_from_numpy(_toy_params(hidden=4), "cpu"))
    opt = torch.optim.Adam(small)
    for p in small:
        p.grad = torch.ones_like(p)
    opt.step()
    torch.save(opt.state_dict(), tmp_path / "optimizer_states.pt")
    _port_train(tmp_path, 2)
    assert "optimizer config changed; reinitializing opt state" in \
        capsys.readouterr().out
    os.remove(tmp_path / "optimizer_states.pt")
    with open(tmp_path / "optimizer_states.pkl", "wb") as f:
        pickle.dump({"count": np.zeros(())}, f)
    _port_train(tmp_path, 3)
    assert "JAX package's optimizer state; reinitializing" in \
        capsys.readouterr().out
    assert os.path.exists(tmp_path / "optimizer_states.pt")


def test_optimizer_factory_matches_jax(tmp_path, capsys):
    r"""``train(optimizer=)``: SGD from a factory against JAX's loop with
    ``optax.sgd`` (same init, clip 1.0, lr 1e-1, one epoch, a validation
    after every step), each loss within ``LOSS_RTOL``; then a resume with
    SGD adopts the saved state, and one with the default Adam does not."""
    import optax
    from robustcap_tpu.train import data as jdata
    from robustcap_tpu.train import losses as jlosses
    data, label = _toy_data()
    kw = dict(num_epoch=1, batch_size=4, learning_rate=1e-1,
              clip_grad_norm=1.0, num_iter_between_vald=1)
    jloop.train(jax.tree.map(jax.numpy.asarray, _toy_params()),
                jtrainers.make_forward_fn(0.0), jlosses.masked_mse,
                jdata.SeqDataset(data, label, split_size=10),
                jdata.SeqDataset(data, label, split_size=10),
                str(tmp_path / "jax"), optimizer=optax.sgd, **kw)
    made = []

    def sgd(params, lr):
        made.append(torch.optim.SGD(params, lr))
        return made[-1]

    _port_train(tmp_path / "port", optimizer=sgd, **kw)
    assert len(made) == 1 and made[0].param_groups[0]["lr"] == 1e-1
    jrec = _records(tmp_path / "jax" / "metrics.jsonl")
    trec = _records(tmp_path / "port" / "metrics.jsonl")
    assert len(jrec) == len(trec) == 4
    for a, b in zip(jrec, trec):
        for key in ("train_loss", "vald_loss"):
            np.testing.assert_allclose(b[key], a[key], rtol=LOSS_RTOL)
    capsys.readouterr()
    _port_train(tmp_path / "port", 2, optimizer=sgd)
    assert "reinitializing" not in capsys.readouterr().out
    _port_train(tmp_path / "port", 3)
    assert "optimizer config changed; reinitializing opt state" in \
        capsys.readouterr().out


def test_plateau_not_triggered_while_improving(tmp_path):
    r"""``TestLoopFixes.test_plateau_not_triggered_while_improving``: the
    plateau scale steps per validation."""
    _port_train(tmp_path, 6, lr_scheduler_patience=1,
                num_iter_between_vald=2)
    info = json.load(open(tmp_path / "train_info.json"))
    assert info["lr_scale"] > 1e-2


def test_plateau_decays_the_learning_rate(tmp_path, monkeypatch):
    r"""A validation loss that stops improving for more than ``patience``
    validations scales Adam's learning rate by the factor."""
    lrs = []
    real_step = torch.optim.Adam.step

    def step(self, *a, **k):
        lrs.append(self.param_groups[0]["lr"])
        return real_step(self, *a, **k)

    monkeypatch.setattr(torch.optim.Adam, "step", step)
    data, label = _toy_data()
    ds = SeqDataset(data, label, split_size=10)
    tloop.train(params_from_numpy(_toy_params(), "cpu"),
                ttrainers.make_forward_fn(0.0), masked_mse, ds, ds,
                str(tmp_path), num_epoch=3, batch_size=4, learning_rate=1e-2,
                eval_fn=lambda ys, labels, lengths: ys.sum() * 0 + 1.0,
                lr_scheduler_patience=1, num_iter_between_vald=1,
                device="cpu")
    info = json.load(open(tmp_path / "train_info.json"))
    assert info["lr_scale"] < 1e-2
    assert lrs[0] == 1e-2 and min(lrs) == pytest.approx(1e-2 *
                                                        info["lr_scale"])


def test_epoch_hook_called_and_data_refresh_applies(tmp_path):
    r"""``TestLoopFixes.test_epoch_hook_called_and_data_refresh_applies``:
    the hook runs before each epoch's batches, and its edits reach them."""
    rng = np.random.RandomState(0)
    data = [rng.randn(10, 8).astype(np.float32) for _ in range(4)]
    ds = SeqDataset(data, [d[:, :2].copy() for d in data])
    seen, calls = [], []
    real = tloop.padded_batches

    def spy(dataset, *a, **k):
        if dataset is ds and k.get("shuffle", True):
            seen.append(float(dataset.data[0][0, 0]))
        return real(dataset, *a, **k)

    def hook(epoch):
        calls.append(epoch)
        ds.data[0] = ds.data[0] + 1.0

    tloop.padded_batches, saved = spy, tloop.padded_batches
    try:
        tloop.train(params_from_numpy(jax.tree.map(np.array, j_init_rnn_params(
            jax.random.PRNGKey(0), 8, 2, 8, 2)), "cpu"),
            ttrainers.make_forward_fn(0.0), masked_mse, ds, ds,
            str(tmp_path), num_epoch=3, batch_size=2, learning_rate=1e-2,
            epoch_hook=hook, device="cpu")
    finally:
        tloop.padded_batches = saved
    assert calls == [0, 1, 2]
    assert np.allclose(np.diff(seen), 1.0) and len(seen) == 3


def test_weights_cross_load(tmp_path):
    r"""``weights.pkl`` written by either package loads in the other, f32 and
    int8 trees, and the port's ``torch.save`` checkpoint round-trips."""
    p0 = _toy_params()
    jq = jax.tree.map(np.array, j_quantize_params(jax.tree.map(
        jax.numpy.asarray, p0)))
    for tree in (p0, jq):
        path = str(tmp_path / "j.pkl")
        jloop.save_pytree(tree, path)
        got = tloop.load_pytree(path, "cpu")
        for a, b in zip(jax.tree.leaves(tree), _tensor_leaves(got)):
            assert b.dtype == (torch.int8 if a.dtype == np.int8
                               else torch.float32)
            np.testing.assert_array_equal(b.numpy(), a)
    tp = params_from_numpy(p0, "cpu")
    for tree in (tp, quantize_params(tp)):
        path = str(tmp_path / "t.pkl")
        tloop.save_pytree(tree, path)
        got = jloop.load_pytree(path)
        for a, b in zip(_tensor_leaves(tree), jax.tree.leaves(got)):
            np.testing.assert_array_equal(np.asarray(b), a.numpy())
        tloop.save_checkpoint(tree, str(tmp_path / "t.pt"))
        back = tloop.load_checkpoint(str(tmp_path / "t.pt"), "cpu")
        for a, b in zip(_tensor_leaves(tree), _tensor_leaves(back)):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="bfloat16"):
        tloop.save_pytree({"w": torch.zeros(2, dtype=torch.bfloat16)},
                          str(tmp_path / "bf.pkl"))


def test_batch_inference_matches_jax():
    data, label = _toy_data()
    p0 = _toy_params()
    from robustcap_tpu.train import data as jdata
    want = jloop.batch_inference(jax.tree.map(jax.numpy.asarray, p0),
                                 jtrainers.make_forward_fn(0.4),
                                 jdata.SeqDataset(data, label, split_size=7),
                                 batch_size=3)
    got = tloop.batch_inference(params_from_numpy(p0, "cpu"),
                                ttrainers.make_forward_fn(0.4),
                                SeqDataset(data, label, split_size=7),
                                batch_size=3, device="cpu")
    assert len(want) == len(got) == 24
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, atol=2e-5)


# ---------------------------------------------------------------------------
# Trainers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus():
    jmodel = JModel(data=j_smpl_data())
    tmodel = TModel(data=t_smpl_data(), device="cpu")
    ds = build_fixture_dataset(jmodel, n_seq=2, T=36, n_cam=2, seed=1)
    return jmodel, tmodel, ds


def _capture(monkeypatch, module):
    calls = []

    def fake(params, forward_fn, loss_fn, train_ds, valid_ds, save_dir,
             **kw):
        calls.append(dict(params=params, forward=forward_fn, loss=loss_fn,
                          train=train_ds, valid=valid_ds, kw=kw))
        return params

    monkeypatch.setattr(module, "train", fake)
    return calls


def _closure(fn):
    return {name: cell.cell_contents for name, cell in
            zip(fn.__code__.co_freevars, fn.__closure__ or ())
            if isinstance(cell.cell_contents, (int, float, bool))}


def _same_arrays(a, b):
    r"""Feature arrays: the float32 rotation math of each package within
    1e-5, as ``tests/test_torch_train.py`` holds them."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["rnn2", "rnn3", "rnn4", "rnn6", "rnn7",
                                  "rnn8"])
def test_trainers_pass_train_what_jax_does(corpus, monkeypatch, name):
    r"""Each ``train_rnnK`` hands ``train`` the same datasets (within the
    features' 1e-5), dropout, loss and keywords as the JAX trainer (``train`` captured in both, nothing
    trained). The AMASS camera chunks of rnn4/rnn6 are random draws: there
    the AIST chunks are held equal, the AMASS ones by shape, and the epoch
    hook must redraw them."""
    jmodel, tmodel, ds = corpus
    jcalls = _capture(monkeypatch, jtrainers)
    tcalls = _capture(monkeypatch, ttrainers)
    fn_j = getattr(jtrainers, f"train_{name}")
    fn_t = getattr(ttrainers, f"train_{name}")
    extra_j, extra_t = {}, {}
    if name == "rnn7":
        extra_j, extra_t = dict(body_model=jmodel), dict(body_model=tmodel)
    args = (ds, ds) if name == "rnn8" else (ds, ds, ds, ds)
    fn_j(*args, save_dir="unused", **extra_j)
    fn_t(*args, save_dir="unused", device="cpu", **extra_t)
    (j,), (t,) = jcalls, tcalls

    assert t["kw"].pop("device") == "cpu"
    assert set(j["kw"]) == set(t["kw"])
    for key, want in j["kw"].items():
        got = t["kw"][key]
        if callable(want):
            assert callable(got) and (getattr(want, "__name__", "")
                                      == getattr(got, "__name__", ""))
        else:
            assert got == want, key
    assert _closure(j["forward"]) == _closure(t["forward"])
    assert j["loss"].__qualname__ == t["loss"].__qualname__
    assert [a.shape for a in jax.tree.leaves(j["params"])] == \
        [tuple(a.shape) for a in jax.tree.leaves(t["params"])]

    _same_arrays(j["valid"].data, t["valid"].data)
    _same_arrays(j["valid"].label, t["valid"].label)
    assert j["train"].with_init == t["train"].with_init
    n = len(j["train"].data)
    assert n == len(t["train"].data)
    if name in ("rnn4", "rnn6"):
        from robustcap_tpu.train import features as JF
        n_aist = n - len(JF.amass_mp_base(ds)[0])
        assert [x.shape for x in j["train"].data[n_aist:]] == \
            [x.shape for x in t["train"].data[n_aist:]]
        before = [x.copy() for x in t["train"].data[n_aist:]]
        t["kw"]["epoch_hook"](1)
        assert all(not np.allclose(a, b) for a, b in
                   zip(before, t["train"].data[n_aist:]))
        _same_arrays(j["train"].data[:n_aist], t["train"].data[:n_aist])
    else:
        _same_arrays(j["train"].data, t["train"].data)
        _same_arrays(j["train"].label, t["train"].label)
    # the augmentation draws from the loop's RandomState: the same noise
    assert (j["train"].augment_fn is None) == (t["train"].augment_fn is None)
    if j["train"].augment_fn is not None:
        x = j["train"].data[0]
        np.testing.assert_array_equal(
            t["train"].augment_fn(np.random.RandomState(3), x),
            j["train"].augment_fn(np.random.RandomState(3), x))
    rng = np.random.RandomState(0)
    ys = rng.randn(30, 3, j["valid"].label[0].shape[-1]).astype(np.float32)
    labels = rng.rand(*ys.shape).astype(np.float32)
    lengths = np.array([30, 12, 5], np.int32)
    want = float(j["loss"](ys, labels, lengths))
    got = float(t["loss"](torch.from_numpy(ys), torch.from_numpy(labels),
                          torch.from_numpy(lengths)))
    np.testing.assert_allclose(got, want, rtol=1e-5)

def test_merge_weights(tmp_path):
    r"""The six best checkpoints merge into the tree ``forward_offline``
    loads, saved where JAX's ``load_pytree`` reads it."""
    from test_torch_tail import SMALL_SPECS
    from robustcap_tpu.models import sig_mp as jsig
    jp = jax.tree.map(np.array, jsig.init_params(jax.random.PRNGKey(0),
                                                 SMALL_SPECS))
    for name, tree in jp.items():
        os.makedirs(tmp_path / name)
        tloop.save_pytree(params_from_numpy(tree, "cpu"),
                          str(tmp_path / name / "best_weights.pkl"))
    merged = ttrainers.merge_weights(str(tmp_path), device="cpu")
    assert set(merged) == set(SMALL_SPECS)
    back = jloop.load_pytree(str(tmp_path / "best_weights.pkl"))
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), a)


# ---------------------------------------------------------------------------
# Commands
# ---------------------------------------------------------------------------


def test_cli_train_and_quantize(corpus, tmp_path, monkeypatch, capsys):
    r"""``train --rnn 3`` over ``train.pt``/``val.pt`` written from the
    fixture corpus, on the CPU, with the trainer cut to one epoch; then ``quantize`` of the weights
    it wrote, as a pickle and as a ``torch.save`` checkpoint."""
    _, _, ds = corpus
    monkeypatch.setattr(ttrainers, "paths",
                        TC.Paths(data_root=str(tmp_path)))
    monkeypatch.setattr(ttrainers, "train_rnn3",
                        functools.partial(ttrainers.train_rnn3, num_epoch=1))
    aist = tmp_path / "aist"
    os.makedirs(aist)
    for kind in ("train", "val"):
        torch.save(ds, aist / f"{kind}.pt")
    main(["train", "--rnn", "3", "--aist", str(aist), "--device", "cpu"])
    out_dir = tmp_path / "weights" / "sig_mp" / "rnn3"
    for f in ("weights.pkl", "best_weights.pkl", "optimizer_states.pt",
              "train_info.json", "metrics.jsonl"):
        assert os.path.exists(out_dir / f), f
    best = tloop.load_pytree(str(out_dir / "best_weights.pkl"), "cpu")
    assert best["layers"][0]["w_hh"].shape == (2048, 512)
    capsys.readouterr()

    weights = str(out_dir / "best_weights.pkl")
    for flag in ((), ("--torch-save",)):
        out = str(tmp_path / ("q.pt" if flag else "q.pkl"))
        main(["quantize", "--weights", weights, "--out", out,
              "--device", "cpu", *flag])
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["out"] == out and line["bytes"] > 0
        q = (tloop.load_checkpoint(out, "cpu") if flag
             else tloop.load_pytree(out, "cpu"))
        assert q["layers"][0]["w_hh"]["q"].dtype == torch.int8
        assert line["bytes"] == sum(t.numel() * t.element_size()
                                    for t in _tensor_leaves(q))

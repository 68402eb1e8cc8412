r"""The port's data parallelism (``robustcap_tpu_torch/parallel``) on the CPU
over gloo: the flag gating, the dataset partition and process slices
against the JAX package's numbers, the global batch, ``train(mesh=)``, the
one-rank DP step against the plain step and against JAX's
``make_dp_train_step``, and two processes (this file run with ``--child``)
whose DP step with unequal lengths, sharded evaluation and sharded
refinement are held against one process on the whole batch, whose barrier
waits for rank 0's file, and whose ``train(mesh=)`` (validation decided by
rank 0, early stop, the plateau, rank 0's checkpoints, resume) leaves both
ranks with the same parameters.

Bounds: the DP step against the whole batch within 1e-5 (the loss
relative to itself, gradients against their largest entry, parameters
after an SGD step against the step's move: Adam's first step divides each
gradient by its own size, so near-zero entries turn rounding into moves of
the whole step, and Adam's parameters are held equal across ranks
instead); a mean of the ranks' means, the control, must fall outside it.
The one-rank DP step against JAX's: parameters after Adam within 1e-5.
Sharded ``run_sequences`` within 1e-5 of unsharded;
sharded ``refine_sequences_batched`` in float64 within 1e-9 of unsharded
and within a tenth of the refinement's move.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from robustcap_tpu_torch.device import tree_map
from robustcap_tpu_torch.nn.rnn import init_rnn_params
from robustcap_tpu_torch.parallel import (dataset_shard_indices,
                                          global_batch_from_local,
                                          initialize_distributed,
                                          make_dp_train_step, make_mesh,
                                          process_local_batch, replicate,
                                          shard_batch)
from robustcap_tpu_torch.train import (SeqDataset, make_forward_fn,
                                       masked_mse, train,
                                       velocity_horizon_loss)
from robustcap_tpu_torch.train.loop import (_clip_by_global_norm,
                                            _tensor_leaves)

BOUND = 1e-5
CHILD_TIMEOUT_S = 120
SPECS = {"rnn2": (72, 69, 12, 0.4, True), "rnn3": (141, 3, 12, 0.4, False),
         "rnn4": (171, 69, 16, 0.4, False), "rnn6": (240, 3, 12, 0.4, False),
         "rnn7": (141, 144, 12, 0.1, False), "rnn8": (141, 2, 12, 0.4, False)}
# the global batch of the DP step: 8 rows, the two ranks' valid frames
# 168 and 120 of 288
DP_T, DP_B, DP_IN, DP_OUT, DP_H = 64, 8, 8, 3, 16
DP_LENGTHS = np.array([64, 10, 30, 64, 7, 50, 22, 41], np.int32)
DP_LR = 1e-2
SGD_LR = 0.1
DP_LOSSES = {"masked_mse": masked_mse,
             "velocity_horizon_loss": velocity_horizon_loss}


def _dp_batch():
    rng = np.random.RandomState(0)
    valid = (np.arange(DP_T)[:, None] < DP_LENGTHS)[..., None]
    xs = (rng.randn(DP_T, DP_B, DP_IN) * valid).astype(np.float32)
    ys = (rng.randn(DP_T, DP_B, DP_OUT) * valid).astype(np.float32)
    return xs, ys, DP_LENGTHS


def _dp_params():
    return tree_map(lambda t: t.clone().requires_grad_(),
                    init_rnn_params(torch.Generator().manual_seed(0), DP_IN,
                                    DP_OUT, DP_H, 2))


def _sgd(leaves):
    return torch.optim.SGD(leaves, lr=SGD_LR)


def _adam(leaves):
    return torch.optim.Adam(leaves, lr=DP_LR)


def _plain_step(loss_fn, xs, ys, lengths, clip=0.0, optimizer=_sgd):
    r"""One process on the whole batch: (loss, gradients, parameters after
    the step, parameters before)."""
    p = _dp_params()
    leaves = _tensor_leaves(p)
    before = [t.detach().clone() for t in leaves]
    opt = optimizer(leaves)
    lengths = torch.from_numpy(lengths)
    loss = loss_fn(make_forward_fn(0.0)(p, torch.from_numpy(xs), lengths,
                                        None, None),
                   torch.from_numpy(ys), lengths)
    loss.backward()
    if clip:
        _clip_by_global_norm(leaves, clip)
    grads = [t.grad.clone() for t in leaves]
    opt.step()
    return (float(loss.detach()), grads, [t.detach().clone() for t in leaves],
            before)


def _gaps(loss, grads, params, ref):
    r"""(loss gap relative to the loss, gradient gap relative to the
    largest gradient entry, parameter gap relative to the step's move)."""
    r_loss, r_grads, r_params, before = ref
    g = max(float((a - b).abs().max()) for a, b in zip(grads, r_grads)) \
        / max(float(b.abs().max()) for b in r_grads)
    move = max(float((a - b).abs().max()) for a, b in zip(r_params, before))
    p = max(float((a - b).abs().max()) for a, b in zip(params, r_params))
    return abs(loss - r_loss) / abs(r_loss), g, p / move


# ---------------------------------------------------------------------------
# The two-process world (this file run as a child)
# ---------------------------------------------------------------------------


def _eval_world():
    r"""Small-width params, a 400-vertex body and three one-camera fixture
    sequences (a bucket of 3: padded to 4 over two ranks), with the
    network's outputs perturbed as the refinement's start."""
    from robustcap_tpu_torch.eval import build_aist_sequences
    from robustcap_tpu_torch.models import sig_mp
    from robustcap_tpu_torch.preprocess import build_fixture_dataset
    from robustcap_tpu_torch.smpl import ParametricModel, synthetic_smpl_data
    from robustcap_tpu_torch.smplify.prior import MaxMixturePrior
    data = synthetic_smpl_data(num_verts=400)
    model = ParametricModel(data=data, device="cpu")
    params = sig_mp.init_params(torch.Generator().manual_seed(1), SPECS,
                                device="cpu")
    seqs = build_aist_sequences(build_fixture_dataset(
        model, n_seq=3, T=20, n_cam=1, seed=4))
    rng = np.random.RandomState(3)
    start = [(s.pose_gt, s.tran_gt + rng.normal(0, 0.02, (s.length, 3)))
             for s in seqs]
    model64 = ParametricModel(data=data, dtype=torch.float64, device="cpu")
    prior64 = MaxMixturePrior("/nonexistent", device="cpu",
                              dtype=torch.float64)
    return params, model, seqs, start, model64, prior64


def _refine(start, seqs, model64, prior64, mesh=None):
    from robustcap_tpu_torch.smplify import refine_sequences_batched
    return refine_sequences_batched(start, seqs, lr=1.0, model=model64,
                                    prior=prior64, pad_to_multiple=20,
                                    group_size=4, device="cpu", mesh=mesh)


# train(mesh=) in the two-process run: rank 0's validation values improve
# twice, then rise, so early stop (threshold 2) ends the first run at its
# fourth validation with the second's weights as the best, and the plateau
# (patience 0) scales the lr at the third; rank 1's own values keep falling,
# so it would neither stop nor scale if it decided on them
TRAIN_VALD_RANK0 = [3.0, 2.0, 2.5, 2.6, 2.7, 2.8]
TRAIN_WRITTEN = {"weights.pkl", "best_weights.pkl", "optimizer_states.pt",
                 "train_info.json", "metrics.jsonl"}


def _train_data():
    rng = np.random.RandomState(5)
    data = [rng.randn(int(n), DP_IN).astype(np.float32)
            for n in rng.randint(5, 13, 13)]
    return SeqDataset(data, [d[:, :DP_OUT] * 0.5 for d in data])


def _train_two_ranks(mesh, save_dir):
    r"""Two ``train(mesh=)`` runs into one ``save_dir``: one ended by early
    stop, then its resume. Returns each run's parameters, ``train_info``
    as every rank reads it after the run, and the files this rank
    wrote."""
    from robustcap_tpu_torch.train import loop
    written = []
    real_open, real_save = open, torch.save

    def recording_open(path, mode="r", *args, **kw):
        if "w" in mode or "a" in mode:
            written.append(os.path.basename(path))
        return real_open(path, mode, *args, **kw)

    def recording_save(obj, path, *args, **kw):
        written.append(os.path.basename(path))
        return real_save(obj, path, *args, **kw)

    calls = []

    def vald(ys, labels, lengths):
        calls.append(None)
        k = len(calls) - 1
        value = TRAIN_VALD_RANK0[k] if mesh.rank == 0 else -float(k)
        return torch.tensor(value)

    ds = _train_data()
    init = init_rnn_params(torch.Generator().manual_seed(2), DP_IN, DP_OUT,
                           DP_H, 2)
    got = {}
    loop.open, loop.torch.save = recording_open, recording_save
    try:
        for run, kw in (("first", dict(num_epoch=5, eval_fn=vald,
                                       early_stop_threshold=2,
                                       lr_scheduler_patience=0)),
                        ("resumed", dict(num_epoch=3))):
            out = train(init, make_forward_fn(0.1), masked_mse, ds, ds,
                        save_dir, batch_size=4, valid_batch_size=64,
                        learning_rate=1e-2, num_iter_between_vald=1,
                        device="cpu", mesh=mesh, **kw)
            got[f"train_{run}"] = [t.tolist() for t in _tensor_leaves(out)]
            with real_open(os.path.join(save_dir, "train_info.json")) as f:
                got[f"train_info_{run}"] = json.load(f)
            if run == "first":
                got["train_best_file"] = [
                    t.tolist() for t in _tensor_leaves(loop.load_pytree(
                        os.path.join(save_dir, "best_weights.pkl"), "cpu"))]
            mesh.barrier()      # both ranks have read before the resume
    finally:
        del loop.open
        loop.torch.save = real_save
    got["train_written"] = sorted(set(written))
    return got


def _child(port, rank, out):
    r"""One rank of the two-process run: the DP step and its control for
    each loss, sharded ``run_sequences`` and sharded refinement; saves
    what it got to ``out``."""
    from robustcap_tpu_torch.config import SigMPConfig
    from robustcap_tpu_torch.eval import run_sequences
    from robustcap_tpu_torch.parallel.mesh import all_reduce_grads
    torch.set_num_threads(1)
    ctx = initialize_distributed(f"127.0.0.1:{port}", 2, rank, device="cpu")
    mesh = make_mesh("cpu")
    got = {"rank": ctx.process_index, "size": ctx.process_count}
    xs, ys, lengths = _dp_batch()
    for name, loss_fn in DP_LOSSES.items():
        for label, optimizer in (("", _sgd), ("adam_", _adam)):
            p = _dp_params()
            leaves = _tensor_leaves(p)
            step = make_dp_train_step(make_forward_fn(0.0), loss_fn,
                                      optimizer(leaves), mesh)
            got[f"{name}/{label}loss"] = float(step(p, xs, ys, lengths,
                                                    None))
            got[f"{name}/{label}grads"] = [t.grad.numpy().tolist()
                                           for t in leaves]
            got[f"{name}/{label}params"] = [t.detach().numpy().tolist()
                                            for t in leaves]
        # the control: each rank's mean over its own rows, averaged
        q = _dp_params()
        local = shard_batch({"xs": xs, "ys": ys}, mesh, axis=1)
        rows = torch.from_numpy(lengths[mesh.rows(DP_B)])
        loss = loss_fn(make_forward_fn(0.0)(q, local["xs"], rows, None,
                                            None), local["ys"], rows)
        loss.backward()
        all_reduce_grads(_tensor_leaves(q), mesh)
        got[f"{name}/control_loss"] = float(
            mesh.all_reduce_(loss.detach().clone())) / mesh.size
        got[f"{name}/control_grads"] = [
            (t.grad / mesh.size).numpy().tolist() for t in _tensor_leaves(q)]
    local = {"x": torch.arange(6.0).reshape(3, 2) + 10 * rank,
             "b": torch.tensor([True, False, rank == 1])}
    glob = global_batch_from_local(local, mesh)
    got["global_x"] = glob["x"].tolist()
    got["global_b"] = glob["b"].tolist()
    got["replicated"] = replicate(torch.full((2,), float(rank)),
                                  mesh).tolist()
    # the barrier waits for rank 0, which writes a file a second late
    flag = os.path.join(os.path.dirname(out), "barrier_flag")
    if rank == 0:
        time.sleep(1.0)
        open(flag, "w").close()
    mesh.barrier()
    got["flag_after_barrier"] = os.path.exists(flag)
    got.update(_train_two_ranks(mesh, os.path.join(os.path.dirname(out),
                                                   "train")))

    params, model, seqs, start, model64, prior64 = _eval_world()
    res = run_sequences(params, model, SigMPConfig(), seqs,
                        pad_to_multiple=8, device="cpu", mesh=mesh)
    got["pose"] = [r[0].tolist() for r in res]
    got["tran"] = [r[1].tolist() for r in res]
    refined = _refine(start, seqs, model64, prior64, mesh)
    got["refined_pose"] = [r[0].tolist() for r in refined]
    got["refined_tran"] = [r[1].tolist() for r in refined]
    with open(out, "w") as f:
        json.dump(got, f)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    r"""Runs the two children once (each within ``CHILD_TIMEOUT_S``; on a
    timeout both are killed and the tests fail); returns their results."""
    root = tmp_path_factory.mktemp("two_ranks")
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    for k in ("MASTER_ADDR", "MASTER_PORT", "ROBUSTCAP_COORDINATOR"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", str(port),
         str(rank), str(root / f"rank{rank}.json")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in range(2)]
    try:
        errs = [p.communicate(timeout=CHILD_TIMEOUT_S)[1] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"two-rank run passed {CHILD_TIMEOUT_S} s")
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    out = []
    for rank in range(2):
        with open(root / f"rank{rank}.json") as f:
            out.append(json.load(f))
    return out


def _as_tensors(lists):
    return [torch.tensor(x) for x in lists]


@pytest.mark.parametrize("name", sorted(DP_LOSSES))
def test_two_process_dp_step_unequal_lengths(two_ranks, name):
    r"""Two ranks (168 and 120 valid frames) equal one process on the whole
    batch within 1e-5; the mean of the ranks' means falls outside."""
    ref = _plain_step(DP_LOSSES[name], *_dp_batch())
    for got in two_ranks:
        assert (got["rank"], got["size"]) in ((0, 2), (1, 2))
        gaps = _gaps(got[f"{name}/loss"], _as_tensors(got[f"{name}/grads"]),
                     _as_tensors(got[f"{name}/params"]), ref)
        assert max(gaps) < BOUND, gaps
        control = _gaps(got[f"{name}/control_loss"],
                        _as_tensors(got[f"{name}/control_grads"]), ref[2],
                        ref)
        assert control[0] > BOUND and control[1] > BOUND, control
        assert got[f"{name}/adam_loss"] == got[f"{name}/loss"]
    # the ranks hold the same parameters after the step
    for key in ("params", "adam_params"):
        assert two_ranks[0][f"{name}/{key}"] == two_ranks[1][f"{name}/{key}"]


def test_two_process_global_batch(two_ranks):
    for got in two_ranks:
        want = np.concatenate([np.arange(6.0).reshape(3, 2),
                               np.arange(6.0).reshape(3, 2) + 10])
        np.testing.assert_array_equal(got["global_x"], want)
        assert got["global_b"] == [True, False, False, True, False, True]
        assert got["replicated"] == [0.0, 0.0]


def test_two_process_barrier_waits(two_ranks):
    r"""Rank 1 leaves the barrier only after rank 0, a second later, has
    written its file."""
    assert [got["flag_after_barrier"] for got in two_ranks] == [True, True]


def test_two_process_train(two_ranks):
    r"""``train(mesh=)`` over two ranks: both return the same parameters
    (the best, rank 0's file, after early stop; then the resumed run's),
    only rank 0 writes, early stop and the plateau follow rank 0's
    validation, and the resume carries on from rank 0's ``train_info``."""
    r0, r1 = two_ranks
    for run in ("first", "resumed"):
        assert r0[f"train_{run}"] == r1[f"train_{run}"]
        assert r0[f"train_info_{run}"] == r1[f"train_info_{run}"]
    assert r0["train_first"] == r0["train_best_file"]
    assert r0["train_first"] != r0["train_resumed"]
    assert set(r0["train_written"]) == TRAIN_WRITTEN
    assert r1["train_written"] == []
    # 13 sequences at batch 4: 3 steps an epoch; early stop at the fourth
    # validation (epoch 1, step 1), the plateau's scale from the third
    first, resumed = r0["train_info_first"], r0["train_info_resumed"]
    assert (first["epoch"], first["it"], first["total_it"]) == (1, 1, 4)
    assert first["min_vald_loss"] == 2.0 and first["lr_scale"] == 0.1
    assert (resumed["epoch"], resumed["total_it"]) == (2, 9)
    assert resumed["lr_scale"] == 0.1


def test_two_process_run_sequences(two_ranks):
    r"""``run_sequences(mesh=)`` over a bucket of three (padded to four)
    against one process: pose and translation within 1e-5."""
    from robustcap_tpu_torch.config import SigMPConfig
    from robustcap_tpu_torch.eval import run_sequences
    params, model, seqs, *_ = _eval_world()
    want = run_sequences(params, model, SigMPConfig(), seqs,
                         pad_to_multiple=8, device="cpu")
    for got in two_ranks:
        assert len(got["pose"]) == len(want) == 3
        for (p, t), gp, gt in zip(want, got["pose"], got["tran"]):
            np.testing.assert_allclose(gp, p, atol=BOUND)
            np.testing.assert_allclose(gt, t, atol=BOUND)


def test_two_process_refine(two_ranks):
    r"""``refine_sequences_batched(mesh=)`` in float64 (one group of four
    lanes, two a rank) against one process: within 1e-9 and within a
    tenth of the refinement's move."""
    _, _, seqs, start, model64, prior64 = _eval_world()
    want = _refine(start, seqs, model64, prior64)
    for got in two_ranks:
        for (p, t), (p0, t0), gp, gt in zip(want, start, got["refined_pose"],
                                           got["refined_tran"]):
            move = max(np.abs(p - p0).max(), np.abs(t - t0).max())
            assert move > 1e-4
            gap = max(np.abs(np.asarray(gp) - p).max(),
                      np.abs(np.asarray(gt) - t).max())
            assert gap < min(1e-9, move / 10), (gap, move)


# ---------------------------------------------------------------------------
# One process
# ---------------------------------------------------------------------------


def test_noop_without_coordinator(monkeypatch):
    r"""No coordinator configured: one process, the runtime untouched, a
    mesh of one rank whose collectives are identities."""
    for k in ("ROBUSTCAP_COORDINATOR", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    ctx = initialize_distributed(device="cpu")
    assert not ctx.enabled
    assert (ctx.process_index, ctx.process_count) == (0, 1)
    assert (ctx.local_device_count, ctx.global_device_count) == (1, 1)
    assert not torch.distributed.is_initialized()
    mesh = make_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.group, mesh.axis_name) == \
        (0, 1, None, "data")
    x = torch.arange(4.0)
    assert mesh.all_reduce_(x) is x and mesh.broadcast_(x) is x
    mesh.barrier()


def test_coordinator_without_world_size_raises(monkeypatch):
    for k in ("ROBUSTCAP_NUM_PROCESSES", "WORLD_SIZE",
              "ROBUSTCAP_PROCESS_ID", "RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("ROBUSTCAP_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(ValueError, match="world size"):
        initialize_distributed(device="cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("n,p,P", [(23, 0, 4), (23, 1, 4), (23, 3, 4),
                                   (8, 0, 1), (5, 2, 3), (0, 0, 2)])
def test_dataset_shard_indices_match_jax(n, p, P):
    from robustcap_tpu.parallel import dataset_shard_indices as jax_fn
    np.testing.assert_array_equal(dataset_shard_indices(n, p, P),
                                  jax_fn(n, p, P))
    parts = [dataset_shard_indices(n, q, P) for q in range(P)]
    np.testing.assert_array_equal(np.sort(np.concatenate(parts)),
                                  np.arange(n))


@pytest.mark.parametrize("n,P", [(16, 4), (8, 1), (6, 3), (10, 4)])
def test_process_local_batch_matches_jax(n, P):
    from robustcap_tpu.parallel import process_local_batch as jax_fn
    if n % P:
        for fn in (process_local_batch, jax_fn):
            with pytest.raises(AssertionError, match="must divide"):
                fn(n, 0, P)
        return
    slices = [process_local_batch(n, q, P) for q in range(P)]
    assert slices == [jax_fn(n, q, P) for q in range(P)]
    np.testing.assert_array_equal(
        np.concatenate([np.arange(n)[s] for s in slices]), np.arange(n))


def test_defaults_use_this_process():
    np.testing.assert_array_equal(dataset_shard_indices(8), np.arange(8))
    assert process_local_batch(8) == slice(0, 8)


def test_global_batch_round_trip_one_rank():
    mesh = make_mesh("cpu")
    rng = np.random.RandomState(0)
    local = {"xs": rng.randn(8, 5).astype(np.float32),
             "lengths": np.full(8, 7, np.int32)}
    g = global_batch_from_local(local, mesh)
    np.testing.assert_array_equal(g["xs"].numpy(), local["xs"])
    np.testing.assert_array_equal(g["lengths"].numpy(), local["lengths"])
    rows = shard_batch(g, mesh)
    np.testing.assert_array_equal(rows["xs"].numpy(), local["xs"])


@pytest.mark.parametrize("name", sorted(DP_LOSSES))
def test_one_rank_dp_step_matches_plain_and_jax(name):
    r"""The DP step on a one-rank mesh against the port's plain step and
    JAX's ``make_dp_train_step`` (its 8-device CPU mesh) on the same numpy
    inputs: losses, parameters after Adam within 1e-5."""
    import jax
    import optax
    from robustcap_tpu.nn.rnn import init_rnn_params as jax_init
    from robustcap_tpu.parallel import make_dp_train_step as jax_dp
    from robustcap_tpu.parallel import make_mesh as jax_mesh
    from robustcap_tpu.train import losses as jax_losses
    from robustcap_tpu.train import make_forward_fn as jax_forward
    from robustcap_tpu_torch.convert import params_from_numpy
    xs, ys, lengths = _dp_batch()
    jp = jax_init(jax.random.PRNGKey(0), DP_IN, DP_OUT, DP_H, 2)
    tx = optax.adam(DP_LR)
    step = jax_dp(jax_forward(0.0), getattr(jax_losses, name), tx,
                  jax_mesh())
    p_jax, _, loss_jax = step(jp, tx.init(jp), xs, ys, lengths, None,
                              jax.random.PRNGKey(1))

    tp = tree_map(lambda t: t.requires_grad_(),
                  params_from_numpy(jax.tree.map(np.array, jp), "cpu"))
    before = [t.detach().clone() for t in _tensor_leaves(tp)]
    leaves = _tensor_leaves(tp)
    ours = make_dp_train_step(make_forward_fn(0.0), DP_LOSSES[name],
                              _adam(leaves), make_mesh("cpu"))
    loss = float(ours(tp, xs, ys, lengths, None))
    assert abs(loss - float(loss_jax)) <= BOUND * abs(float(loss_jax))
    want = params_from_numpy(jax.tree.map(np.array, p_jax), "cpu")
    for a, b, c in zip(_tensor_leaves(tp), _tensor_leaves(want), before):
        assert float((a.detach() - b).abs().max()) < BOUND
        assert float((b - c).abs().max()) > 100 * BOUND    # it moved

    # against the plain step from the same start, clip on: the same ops
    p = _dp_params()
    leaves = _tensor_leaves(p)
    dp = make_dp_train_step(make_forward_fn(0.0), DP_LOSSES[name],
                            _adam(leaves), make_mesh("cpu"),
                            clip_grad_norm=1.0)
    loss = float(dp(p, xs, ys, lengths, None))
    grads = [t.grad for t in leaves]
    ref = _plain_step(DP_LOSSES[name], xs, ys, lengths, clip=1.0,
                      optimizer=_adam)
    assert max(_gaps(loss, grads, leaves, ref)) == 0.0


def test_train_with_mesh(tmp_path):
    r"""``train(mesh=)`` on a one-rank mesh: whole batches only (13 chunks
    at batch 4: 3 steps an epoch), metrics written, resume."""
    mesh = make_mesh("cpu")
    rng = np.random.RandomState(0)
    data = [rng.randn(int(n), 8).astype(np.float32)
            for n in rng.randint(5, 13, 13)]
    label = [d[:, :2] * 0.5 for d in data]
    ds = SeqDataset(data, label)
    params = init_rnn_params(torch.Generator().manual_seed(0), 8, 2, 16, 2)
    out = train(params, make_forward_fn(0.1), masked_mse, ds, ds,
                str(tmp_path), num_epoch=2, batch_size=4, learning_rate=1e-2,
                mesh=mesh, log_metrics=True, num_iter_between_vald=2)
    assert set(out) == set(params)
    with open(tmp_path / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["it"] for r in recs] == [2, 3, 2, 3]
    assert recs[-1]["total_it"] == 6
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["vald_loss"])
               for r in recs)
    with open(tmp_path / "train_info.json") as f:
        assert json.load(f)["total_it"] == 6
    with pytest.raises(ValueError, match="must divide"):
        train(params, make_forward_fn(0.1), masked_mse, ds, ds,
              str(tmp_path / "b"), num_epoch=1, batch_size=4,
              mesh=mesh.__class__(None, 0, 3, mesh.device))


if __name__ == "__main__" and sys.argv[1:2] == ["--child"]:
    _child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

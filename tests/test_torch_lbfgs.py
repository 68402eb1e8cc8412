r"""The port's lane-batched L-BFGS (``robustcap_tpu_torch/ops/lbfgs.py``)
against ``torch.optim.LBFGS(line_search_fn="strong_wolfe")`` and the JAX
package's ``lbfgs_minimize``.

Tolerances: against torch in float64 where the evaluation budget does not
bind, x within 1e-8 and the same evaluation and iteration counts (the same
algorithm, the same arithmetic up to reduction order); against JAX in
float32, x and f within 1e-5 relative; lanes against the same problem run
alone, bit for bit (per-lane arithmetic only). On the SMPLify objective of
``tests/test_torch_smplify.py``'s world, the iterates after 1, 2 and 3
iterations against JAX's: within 1e-4 relative at lr 1.0; at lr 0.001,
where a float32 trajectory is set by rounding, either within 1e-5 or parted
by a different line-search step, which dates the fork.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robustcap_tpu.math as JM
import robustcap_tpu.smplify.runner as JR
from robustcap_tpu.ops.lbfgs import lbfgs_minimize as jax_lbfgs
from robustcap_tpu.smplify import losses as jlosses
from robustcap_tpu_torch.ops import lbfgs as L
from robustcap_tpu_torch.smplify import runner as TR
from test_torch_smplify import _lanes, _one_thread, make_world  # noqa: F401

# a smooth 8-D problem: a positive-definite quadratic plus a tanh bump
_RNG = np.random.RandomState(0)
_A = _RNG.randn(8, 8)
A_NP = _A @ _A.T + 0.5 * np.eye(8)
B_NP = _RNG.randn(8)


def _torch_fn(dtype):
    A = torch.tensor(A_NP, dtype=dtype)
    b = torch.tensor(B_NP, dtype=dtype)

    def f(x):   # x [G, 8] -> [G]
        return (0.5 * ((x @ A) * x).sum(-1) - (x * b).sum(-1)
                + 0.1 * (torch.tanh(x) ** 2).sum(-1))
    return f


def _jax_fn():
    A = jnp.asarray(A_NP, jnp.float32)
    b = jnp.asarray(B_NP, jnp.float32)

    def f(x):
        return 0.5 * x @ A @ x - b @ x + 0.1 * jnp.sum(jnp.tanh(x) ** 2)
    return f


def _torch_optim(max_iter, lr, x0=None):
    r"""``torch.optim.LBFGS`` on the float64 problem: (x, func_evals,
    n_iter)."""
    f = _torch_fn(torch.float64)
    x = torch.zeros(8, dtype=torch.float64) if x0 is None else x0.clone()
    x.requires_grad_(True)
    opt = torch.optim.LBFGS([x], max_iter=max_iter, lr=lr,
                            line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        loss = f(x[None])[0]
        loss.backward()
        return loss

    opt.step(closure)
    state = opt.state[opt._params[0]]
    return x.detach(), state["func_evals"], state["n_iter"]


def test_quadratic():
    A = torch.diag(torch.tensor([1.0, 10.0, 100.0]))
    b = torch.tensor([1.0, -2.0, 3.0])
    x, _, _ = L.lbfgs_minimize(lambda x: 0.5 * x @ A @ x - b @ x,
                               torch.zeros(3), max_iter=50, lr=1.0)
    np.testing.assert_allclose(x.numpy(), [1.0, -0.2, 0.03], atol=1e-3)


def test_rosenbrock():
    def f(x):
        return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                         + (1 - x[:-1]) ** 2)

    x, fval, _ = L.lbfgs_minimize(f, torch.tensor([-1.2, 1.0, -0.5, 0.8]),
                                  max_iter=200, lr=1.0, history_size=20)
    assert float(fval) < 1e-3
    np.testing.assert_allclose(x.numpy(), 1.0, atol=0.05)


@pytest.mark.parametrize("max_iter,lr", [(3, 0.001), (3, 1.0), (20, 0.001),
                                         (20, 1.0)])
def test_one_lane_equals_torch_optim(max_iter, lr):
    r"""Where the budget does not bind: the same point, evaluations and
    iterations as ``torch.optim.LBFGS`` in float64."""
    want, evals, n_iter = _torch_optim(max_iter, lr)
    x, _, _, info = L.lbfgs_minimize_lanes(
        _torch_fn(torch.float64), torch.zeros(1, 8, dtype=torch.float64),
        max_iter=max_iter, lr=lr)
    np.testing.assert_allclose(x[0].numpy(), want.numpy(), rtol=0,
                               atol=1e-8)
    assert int(info.func_evals[0]) == evals
    assert int(info.n_iter[0]) == n_iter


@pytest.mark.parametrize("max_iter,lr", [(1, 0.001), (3, 0.001), (3, 1.0),
                                         (20, 1.0)])
def test_matches_jax_float32(max_iter, lr):
    r"""The same problem in float32 through JAX ``lbfgs_minimize``. (Not at
    20 iterations of lr 0.001: there the float32 trajectory is set by
    rounding, and JAX's own jitted and op-by-op programs end apart; the
    float64 case above holds it against torch to 1e-8.)"""
    xj, fj, _ = jax.jit(lambda x0: jax_lbfgs(_jax_fn(), x0, max_iter=max_iter,
                                             lr=lr))(jnp.zeros(8))
    x, f, _, _ = L.lbfgs_minimize_lanes(_torch_fn(torch.float32),
                                        torch.zeros(1, 8), max_iter=max_iter,
                                        lr=lr)
    np.testing.assert_allclose(x[0].numpy(), np.asarray(xj), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(xj)).max())
    np.testing.assert_allclose(float(f[0]), float(fj), rtol=1e-5)


def test_budget_binds_like_jax_not_torch():
    r"""At ``max_iter=1`` the budget (1 evaluation) binds: the line search
    keeps its fixed ``max_ls`` as in the JAX package, where the installed
    ``torch.optim.LBFGS`` may cap it at the budget left."""
    xj, _, _ = jax.jit(lambda x0: jax_lbfgs(_jax_fn(), x0, max_iter=1,
                                            lr=0.001))(jnp.zeros(8))
    x, _, _, info = L.lbfgs_minimize_lanes(_torch_fn(torch.float32),
                                           torch.zeros(1, 8), max_iter=1,
                                           lr=0.001)
    np.testing.assert_allclose(x[0].numpy(), np.asarray(xj), rtol=1e-5,
                               atol=1e-9)
    # the first line search extrapolates three times before Wolfe holds
    assert int(info.func_evals[0]) == 4 and int(info.n_iter[0]) == 1
    x64, _, _, _ = L.lbfgs_minimize_lanes(
        _torch_fn(torch.float64), torch.zeros(1, 8, dtype=torch.float64),
        max_iter=1, lr=0.001)
    want, evals, _ = _torch_optim(1, 0.001)
    if evals < 4:   # this torch caps the search at the budget left
        assert float((x64[0] - want).abs().max()) > 1e-3


@pytest.mark.parametrize("max_eval", [3, 6, 11])
def test_budget_stops_where_jax_stops(max_eval):
    r"""An explicit ``max_eval`` budget ends the loop after the step that
    spends it, at the point where the JAX loop ends."""
    xj, _, _ = jax.jit(lambda x0: jax_lbfgs(
        _jax_fn(), x0, max_iter=20, lr=1.0, max_eval=max_eval))(
        jnp.full(8, 0.5))
    x, _, _, info = L.lbfgs_minimize_lanes(
        _torch_fn(torch.float32), torch.full((1, 8), 0.5), max_iter=20,
        lr=1.0, max_eval=max_eval)
    np.testing.assert_allclose(x[0].numpy(), np.asarray(xj), rtol=1e-5,
                               atol=1e-6)
    assert int(info.func_evals[0]) >= max_eval
    assert int(info.n_iter[0]) < 20


_W = torch.tensor(np.linspace(1.0, 30.0, 8), dtype=torch.float32)
_C = torch.tensor(_RNG.randn(8), dtype=torch.float32)


def _coupled(x):
    r"""A non-separable objective of elementwise terms only ([G, 8] ->
    [G]): a lane's arithmetic is the same whatever the lane count, so its
    result can be held bit for bit (a matrix product may take another
    kernel at another row count)."""
    return ((_W * (x - _C) ** 2).sum(-1)
            + 0.5 * (torch.tanh(x[:, :-1] * x[:, 1:]) ** 2).sum(-1))


def _lane_problems():
    r"""Four different problems on the lanes of one objective: shifted,
    scaled, and one that starts at its minimum's neighbourhood."""
    shift = torch.tensor([[0.0], [0.3], [-0.7], [0.0]])
    scale = torch.tensor([1.0, 2.0, 0.5, 1.0])

    def lanes(x):
        return scale * _coupled(x - shift)
    x0 = torch.zeros(4, 8)
    x0[3] = _C
    return lanes, x0, shift, scale


def test_lanes_equal_each_lane_alone():
    r"""Each lane of a batch equals its problem run alone, bit for bit, and
    a lane that stops first keeps its point while the others go on."""
    lanes, x0, shift, scale = _lane_problems()
    x, fv, g, info = L.lbfgs_minimize_lanes(lanes, x0, max_iter=20, lr=1.0)
    assert len(set(info.n_iter.tolist())) > 1, info
    for k in range(4):
        def alone(x, k=k):
            return scale[k] * _coupled(x - shift[k])
        xa, fa, ga, ia = L.lbfgs_minimize_lanes(alone, x0[k:k + 1],
                                                max_iter=20, lr=1.0)
        assert torch.equal(x[k], xa[0]), k
        assert torch.equal(fv[k], fa[0]) and torch.equal(g[k], ga[0])
        assert int(ia.n_iter[0]) == int(info.n_iter[k])
        assert int(ia.func_evals[0]) == int(info.func_evals[k])
        # frozen: stopping the batch at this lane's last iteration gives the
        # same point for it
        xs, _, _, _ = L.lbfgs_minimize_lanes(
            lanes, x0, max_iter=max(int(info.n_iter[k]), 1), lr=1.0)
        assert torch.equal(xs[k], x[k]), k


def test_masked_lane_runs_no_line_search():
    r"""A lane whose objective is 0 (mask 0) is done at its start: one
    evaluation, no iteration, its point untouched; the other lane is as it
    is alone."""
    mask = torch.tensor([1.0, 0.0])
    x0 = torch.stack([torch.zeros(8), torch.full((8,), 0.25)])
    x, _, _, info = L.lbfgs_minimize_lanes(lambda x: mask * _coupled(x), x0,
                                           max_iter=20, lr=1.0)
    assert info.func_evals.tolist()[1] == 1
    assert info.n_iter.tolist()[1] == 0
    assert torch.equal(x[1], x0[1])
    xa, _, _, ia = L.lbfgs_minimize_lanes(_coupled, x0[:1], max_iter=20,
                                          lr=1.0)
    assert torch.equal(x[0], xa[0])
    assert int(ia.func_evals[0]) == int(info.func_evals[0])


def test_host_reads_are_the_loop_flags():
    r"""The host reads only the loops' flags: one per iteration (and the
    one that ends the loop) and one per line-search step, each of which
    either evaluates once or ends the search."""
    lanes, x0, _, _ = _lane_problems()
    L.HOST_READS = L.EVALUATIONS = 0
    _, _, _, info = L.lbfgs_minimize_lanes(lanes, x0, max_iter=20, lr=0.001)
    iters = int(info.n_iter.max())
    outer = iters + (1 if iters < 20 else 0)
    assert L.HOST_READS == L.EVALUATIONS - 1 + outer
    assert L.EVALUATIONS >= int(info.func_evals.max())


# ---------------------------------------------------------------------------
# Iterates on the SMPLify objective
# ---------------------------------------------------------------------------


def _jax_iterates(w):
    r"""JAX ``lbfgs_minimize`` on each lane's fit objective (built as
    ``make_smplify_fit`` builds it), ``max_iter`` and ``lr`` traced, so one
    program serves every count of iterations."""
    T = w.seqs[0].length
    m = w.jm

    def lane(pose0, tran0, kp, ori, cam_k, mask, k, lr):
        conf = kp[..., 2].at[:, jnp.asarray(JR.IGN_MP_JOINTS)].set(0.0) \
            * mask[:, None]

        def landmarks(pose_R, tran):
            gp, joints, verts = m.forward_kinematics(
                pose_R, tran=tran, calc_mesh=True, vertex_ids=JR._MP_MASK)
            return gp, JR._sync_mp3d_batch(verts, joints)

        _, lm0 = landmarks(pose0, tran0)
        target = jax.lax.stop_gradient(lm0)
        bp0 = JM.rotation_matrix_to_axis_angle(pose0).reshape(T, -1)
        x0 = jnp.concatenate([bp0.reshape(-1), tran0.reshape(-1)])

        def f(x):
            bp = x[:T * 72].reshape(T, 72)
            tr = x[T * 72:].reshape(T, 3)
            pose_R = JM.axis_angle_to_rotation_matrix(
                bp.reshape(-1, 3)).reshape(T, 24, 3, 3)
            gp, mj = landmarks(pose_R, tr)
            return jlosses.temporal_body_fitting_loss(
                bp, mj, kp[..., :2], conf, w.jp, cam_k, target, ori,
                gp[:, JR._JI_MASK], output="sum", frame_mask=mask)

        return jax_lbfgs(f, x0, max_iter=k, lr=lr, max_eval=25)[0]

    return jax.jit(jax.vmap(lane, in_axes=(0,) * 6 + (None, None)))


@pytest.fixture(scope="module")
def iterates():
    r"""x after 1, 2 and 3 iterations (budget 25, as in a 20-iteration fit)
    at lr 1.0 and 0.001: (JAX, port) per count."""
    world = make_world()
    prog = _jax_iterates(world)
    x0, objective, _, _ = TR._fit_problem(
        world.tm, world.tp, TR.IGN_MP_JOINTS, None, *_lanes(world, "torch"))
    out = {}
    for lr in (1.0, 0.001):
        for k in (1, 2, 3):
            want = np.asarray(prog(*_lanes(world, "jax"), k, lr))
            got = L.lbfgs_minimize_lanes(objective, x0, max_iter=k, lr=lr,
                                         max_eval=25)[0].numpy()
            out[lr, k] = want, got
    return out


def _rel_gaps(want, got):
    return np.abs(got - want).max(-1) / np.abs(want).max(-1)


def test_iterations_match_jax(iterates):
    r"""At lr 1.0, x after each of the first three iterations within 1e-4
    relative of JAX's, in every lane."""
    for k in (1, 2, 3):
        gaps = _rel_gaps(*iterates[1.0, k])
        assert (gaps <= 1e-4).all(), (k, gaps)


def test_iterations_at_lr_0001_part_by_steps(iterates):
    r"""At lr 0.001 a lane either agrees with JAX (within 1e-5 relative) or
    has parted by a different line-search step (more than 1e-3): no lane
    drifts by arithmetic. The first iteration at which each lane parts
    dates the fork (``fork_iterations``)."""
    for k in (1, 2, 3):
        gaps = _rel_gaps(*iterates[0.001, k])
        assert ((gaps <= 1e-5) | (gaps > 1e-3)).all(), (k, gaps)
    forks = fork_iterations(iterates)
    print("lr 0.001, the iteration at which each lane parts:", forks)
    # a lane that has parted stays parted
    for lane, k in enumerate(forks):
        if k is not None:
            for later in range(k, 4):
                assert _rel_gaps(*iterates[0.001, later])[lane] > 1e-3


def fork_iterations(iterates, lr=0.001):
    r"""Per lane, the first of iterations 1-3 after which the port's x is
    more than 1e-3 relative from JAX's (None if none)."""
    out = []
    for lane in range(iterates[lr, 1][0].shape[0]):
        out.append(next((k for k in (1, 2, 3)
                         if _rel_gaps(*iterates[lr, k])[lane] > 1e-3), None))
    return out

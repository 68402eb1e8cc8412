r"""L-BFGS with a strong-Wolfe line search over G independent lanes (port of
``robustcap_tpu/ops/lbfgs.py``, whose ``jax.vmap`` over sequences becomes
the lane axis here).

The semantics are those of ``torch.optim.LBFGS(line_search_fn=
"strong_wolfe")``, which the JAX package mirrors, lane by lane:

* two-loop recursion over a ring of ``history_size`` (s, y) pairs, indexed
  by the pairs stored (a rejected pair, ``ys <= 1e-10``, does not advance
  it);
* first-iteration step ``t0 = min(1, 1/||g||_1) * lr``, then ``t = lr``;
* bracket and zoom phases with cubic interpolation, Armijo ``c1=1e-4`` and
  curvature ``c2=0.9``; the exits are decided on the current trial before
  any new evaluation, and the zoom's insufficient-progress latch clamps
  only on the second edge-hugging trial;
* a budget of ``max_eval`` objective evaluations (default ``max_iter * 5 //
  4``), checked after each step, with the line search itself capped at a
  fixed ``max_ls`` (the JAX package's semantics; ``torch.optim.LBFGS``
  caps it at the budget left, which differs only where the budget binds);
* stops on the gradient's infinity norm, the step, the change of f and a
  flat direction, in torch's order (the flat-direction break keeps the
  previous point).

Lanes share no parameter, so one ``torch.autograd.grad`` of ``f.sum()``
gives every lane its own gradient. Every per-lane decision is a
``torch.where``; a lane that has finished keeps its state. The host reads
the device only for the loops' "any lane still active" flags, once per
iteration and once per line-search step; ``HOST_READS`` and
``EVALUATIONS`` (batched objective calls) count them.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["LBFGSInfo", "lbfgs_minimize", "lbfgs_minimize_lanes"]

# counts since they were last set to 0: reads of a loop flag from the device,
# and batched objective-and-gradient evaluations
HOST_READS = 0
EVALUATIONS = 0


class LBFGSInfo(NamedTuple):
    r"""Per-lane counts, as ``torch.optim.LBFGS`` keeps them in its state."""
    n_iter: torch.Tensor       # [G] iterations (``state["n_iter"]``)
    func_evals: torch.Tensor   # [G] evaluations (``state["func_evals"]``)


def _any(flags: torch.Tensor) -> bool:
    global HOST_READS
    HOST_READS += 1
    return bool(flags.any())


def _value_and_grad(fun: Callable, x: torch.Tensor):
    r"""``(f [G], df/dx [G, n])``, both detached."""
    global EVALUATIONS
    EVALUATIONS += 1
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        f = fun(xg)
        (g,) = torch.autograd.grad(f.sum(), xg)
    return f.detach(), g


def _dot(a, b):
    return (a * b).sum(-1)


def _cubic_interpolate(x1, f1, g1, x2, f2, g2, lo, hi):
    r"""Minimizer of the cubic through (x1, f1, g1), (x2, f2, g2), clamped to
    [lo, hi]; bisection where the cubic is degenerate."""
    d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2)
    d2_square = d1 ** 2 - g1 * g2
    d2 = torch.sqrt(torch.clamp_min(d2_square, 0.0))
    t = torch.where(
        x1 <= x2,
        x2 - (x2 - x1) * ((g2 + d2 - d1) / (g2 - g1 + 2 * d2)),
        x1 - (x1 - x2) * ((g1 + d2 - d1) / (g1 - g2 + 2 * d2)))
    ok = (d2_square >= 0) & torch.isfinite(t)
    return torch.where(ok, torch.minimum(torch.maximum(t, lo), hi),
                       (lo + hi) / 2.0)


def _pick(mask, a, b):
    r"""``a`` on the lanes of ``mask`` [G], else ``b`` ([G] or [G, n])."""
    if a.dim() > 1:
        mask = mask[:, None]
    return torch.where(mask, a, b)


def _strong_wolfe(eval_t: Callable, f0, g0, gtd0, t_init, d_norm, on,
                  c1=1e-4, c2=0.9, max_ls=25, tol_change=1e-9):
    r"""Strong-Wolfe line search of the lanes ``on`` [G] along their fixed
    directions.

    ``eval_t(t [G]) -> (f [G], g [G, n], gtd [G])`` evaluates every lane at
    its step ``t``. Returns ``(t, f, g, n_evals)`` per lane, ``n_evals``
    counted as torch's ``_strong_wolfe`` counts them. Each step first
    decides every lane on its current trial (exits before any new
    evaluation), then evaluates once: at the bracket phase's extrapolation
    or the zoom's trial of each lane that goes on, and at ``t = 0`` for the
    others, which keep their state. A lane not ``on`` is done from the
    start."""
    zero = torch.zeros_like(f0)
    f_t, g_t, gtd_t = eval_t(torch.where(on, t_init, zero))
    s = SimpleNamespace(
        ls_iter=torch.zeros_like(on, dtype=torch.long), done=~on,
        wolfe=torch.zeros_like(on),
        t=t_init, f_new=f_t, g_new=g_t, gtd_new=gtd_t,
        t_prev=zero, f_prev=f0, gtd_prev=gtd0, g_prev=g0,
        bracketing=torch.ones_like(on), insuf=torch.zeros_like(on),
        bl_t=zero, bl_f=f0, bl_g=g0, bl_gtd=gtd0,
        bh_t=t_init, bh_f=f_t, bh_g=g_t, bh_gtd=gtd_t)
    ends = ("t", "f", "g", "gtd")
    while True:
        act = ~s.done & (s.ls_iter < max_ls)

        # bracket phase: decide on the current trial; a lane that leaves
        # the phase takes its bracket ends, ordered
        br = act & s.bracketing
        armijo_fail = (s.f_new > f0 + c1 * s.t * gtd0) | \
            ((s.ls_iter > 1) & (s.f_new >= s.f_prev))
        wolfe_ok = s.gtd_new.abs() <= -c2 * gtd0
        enter_zoom = armijo_fail | (~wolfe_ok & (s.gtd_new >= 0))
        b_done = wolfe_ok & ~armijo_fail
        b_eval = br & ~(enter_zoom | b_done)
        t_next = _cubic_interpolate(
            s.t_prev, s.f_prev, s.gtd_prev, s.t, s.f_new, s.gtd_new,
            s.t + 0.01 * (s.t - s.t_prev), s.t * 10.0)
        cur = dict(t=s.t, f=s.f_new, g=s.g_new, gtd=s.gtd_new)
        prev = dict(t=s.t_prev, f=s.f_prev, g=s.g_prev, gtd=s.gtd_prev)
        for k in ends:
            setattr(s, "bl_" + k, _pick(br, _pick(armijo_fail, prev[k],
                                                  cur[k]),
                                        getattr(s, "bl_" + k)))
            setattr(s, "bh_" + k, _pick(br, _pick(armijo_fail, cur[k],
                                                  prev[k]),
                                        getattr(s, "bh_" + k)))
        s.done = torch.where(br, b_done, s.done)
        s.wolfe = torch.where(br, b_done, s.wolfe)
        s.bracketing = torch.where(br, b_eval, s.bracketing)

        # zoom phase (a lane that just left the bracket phase included):
        # stop on a converged bracket, else pick the next trial inside it
        zm = act & ~s.bracketing & ~s.done
        xmin = torch.minimum(s.bl_t, s.bh_t)
        xmax = torch.maximum(s.bl_t, s.bh_t)
        converged = (xmax - xmin) * d_norm < tol_change
        t_new = _cubic_interpolate(s.bl_t, s.bl_f, s.bl_gtd, s.bh_t, s.bh_f,
                                   s.bh_gtd, xmin, xmax)
        eps = 0.1 * (xmax - xmin)
        close = torch.minimum(xmax - t_new, t_new - xmin) < eps
        outside = (t_new >= xmax) | (t_new <= xmin)
        t_new = torch.where(
            close & (s.insuf | outside),
            torch.where((t_new - xmax).abs() < (t_new - xmin).abs(),
                        xmax - eps, xmin + eps),
            t_new)
        z_eval = zm & ~converged
        s.done = s.done | (zm & converged)

        # every lane still searching has a trial to evaluate
        if not _any(b_eval | z_eval):
            break
        f_n, g_n, gtd_n = eval_t(torch.where(
            b_eval, t_next, torch.where(z_eval, t_new, zero)))

        # zoom: the trial replaces the bracket end it improves on
        lo_first = s.bl_f <= s.bh_f
        bl = {k: getattr(s, "bl_" + k) for k in ends}
        bh = {k: getattr(s, "bh_" + k) for k in ends}
        low = {k: _pick(lo_first, bl[k], bh[k]) for k in ends}
        high = {k: _pick(lo_first, bh[k], bl[k]) for k in ends}
        new = dict(t=t_new, f=f_n, g=g_n, gtd=gtd_n)
        z_armijo_fail = (f_n > f0 + c1 * t_new * gtd0) | (f_n >= low["f"])
        z_wolfe_ok = gtd_n.abs() <= -c2 * gtd0
        new_high = z_armijo_fail | (~z_wolfe_ok
                                    & (gtd_n * (high["t"] - low["t"]) >= 0))
        z_done = z_wolfe_ok & ~z_armijo_fail
        for k in ends:
            setattr(s, "bl_" + k, _pick(z_eval, _pick(new_high, low[k],
                                                      new[k]), bl[k]))
            setattr(s, "bh_" + k, _pick(z_eval, _pick(new_high, new[k],
                                                      high[k]), bh[k]))
        s.done = torch.where(z_eval, z_done, s.done)
        s.wolfe = torch.where(z_eval, z_done, s.wolfe)
        s.insuf = torch.where(z_eval, close & ~(s.insuf | outside), s.insuf)

        # the bracket phase's new trial, or the zoom's accepted one
        take = b_eval | (z_eval & z_done)
        s.t_prev = _pick(b_eval, s.t, s.t_prev)
        s.f_prev = _pick(b_eval, s.f_new, s.f_prev)
        s.gtd_prev = _pick(b_eval, s.gtd_new, s.gtd_prev)
        s.g_prev = _pick(b_eval, s.g_new, s.g_prev)
        s.t = _pick(take, torch.where(b_eval, t_next, t_new), s.t)
        s.f_new = _pick(take, f_n, s.f_new)
        s.g_new = _pick(take, g_n, s.g_new)
        s.gtd_new = _pick(take, gtd_n, s.gtd_new)
        s.ls_iter = s.ls_iter + (b_eval | z_eval).long()

    # a Wolfe point returns itself; any other exit (bracket converged, zoom
    # or bracketing out of steps, where torch takes the bracket [0, t])
    # returns the bracket end of lower f, with the (f, g) it was evaluated at
    lo_t = torch.where(s.bracketing, zero, s.bl_t)
    lo_f = torch.where(s.bracketing, f0, s.bl_f)
    lo_g = _pick(s.bracketing, g0, s.bl_g)
    hi_t = torch.where(s.bracketing, s.t, s.bh_t)
    hi_f = torch.where(s.bracketing, s.f_new, s.bh_f)
    hi_g = _pick(s.bracketing, s.g_new, s.bh_g)
    lo_best = lo_f <= hi_f
    t = torch.where(s.wolfe, s.t, torch.where(lo_best, lo_t, hi_t))
    f = torch.where(s.wolfe, s.f_new, torch.where(lo_best, lo_f, hi_f))
    g = _pick(s.wolfe, s.g_new, _pick(lo_best, lo_g, hi_g))
    return t, f, g, s.ls_iter + 1


def _direction(g, s_hist, y_hist, rho, n_stored, n_max):
    r"""Two-loop recursion over each lane's ring, newest pair first; ``-g``
    in a lane with no pair. At most ``n_max`` pairs are stored in any lane
    (the iterations so far), so the loops stop there; a lane's missing
    pairs change nothing."""
    G, m = rho.shape
    lanes = torch.arange(G, device=g.device)
    q = -g
    alphas, slots, valids = [], [], []
    for i in range(n_max):
        j = torch.remainder(n_stored - 1 - i, m)
        valid = i < torch.clamp_max(n_stored, m)
        s_j, y_j, rho_j = s_hist[lanes, j], y_hist[lanes, j], rho[lanes, j]
        a = torch.where(valid, rho_j * _dot(s_j, q), torch.zeros_like(rho_j))
        q = q - (a * valid)[:, None] * y_j
        alphas.append(a)
        slots.append((s_j, y_j, rho_j))
        valids.append(valid)
    # H0 scaling by the most recently stored pair
    last = torch.remainder(n_stored - 1, m)
    s_l, y_l = s_hist[lanes, last], y_hist[lanes, last]
    gamma = torch.where(n_stored > 0,
                        _dot(s_l, y_l) / torch.clamp_min(_dot(y_l, y_l),
                                                         1e-10),
                        torch.ones_like(rho[:, 0]))
    r = q * gamma[:, None]
    for i in reversed(range(n_max)):
        s_j, y_j, rho_j = slots[i]
        b = torch.where(valids[i], rho_j * _dot(y_j, r),
                        torch.zeros_like(rho_j))
        r = r + ((alphas[i] - b) * valids[i])[:, None] * s_j
    return r


def lbfgs_minimize_lanes(fun: Callable, x0: torch.Tensor,
                         max_iter: int = 20, lr: float = 1.0,
                         history_size: int = 20,
                         tolerance_grad: float = 1e-7,
                         tolerance_change: float = 1e-9,
                         max_ls: int = 25, max_eval: Optional[int] = None):
    r"""Minimize ``fun`` (``x [G, n] -> f [G]``, lane g's value a function
    of ``x[g]`` alone) from ``x0`` in every lane at once.

    Returns ``(x [G, n], f [G], g [G, n], LBFGSInfo)``. A lane whose
    gradient at ``x0`` is already within ``tolerance_grad`` (a lane whose
    objective is 0, such as a padded one) is done from the start and runs
    no line search."""
    if max_eval is None:
        max_eval = max_iter * 5 // 4
    G, n = x0.shape
    m = history_size
    dev, dt = x0.device, x0.dtype
    lanes = torch.arange(G, device=dev)
    x = x0.detach()
    f, g = _value_and_grad(fun, x)
    s_hist = torch.zeros(G, m, n, dtype=dt, device=dev)
    y_hist = torch.zeros_like(s_hist)
    rho = torch.zeros(G, m, dtype=dt, device=dev)
    n_stored = torch.zeros(G, dtype=torch.long, device=dev)
    it = torch.zeros(G, dtype=torch.long, device=dev)
    n_evals = torch.ones(G, dtype=torch.long, device=dev)
    done = g.abs().amax(-1) <= tolerance_grad

    for k in range(max_iter):
        act = ~done
        if not _any(act):
            break
        d = _direction(g, s_hist, y_hist, rho, n_stored, min(k, m))
        gtd = _dot(g, d)
        flat = gtd > -tolerance_change
        t0 = (torch.clamp_max(1.0 / g.abs().sum(-1), 1.0) * lr if k == 0
              else torch.full_like(f, lr))

        def eval_t(t):
            f_t, g_t = _value_and_grad(fun, x + t[:, None] * d)
            return f_t, g_t, _dot(g_t, d)

        step = act & ~flat
        t, f_new, g_new, ls_evals = _strong_wolfe(
            eval_t, f, g, gtd, t0, d.abs().amax(-1), step, max_ls=max_ls,
            tol_change=tolerance_change)
        s_vec = t[:, None] * d
        y_vec = g_new - g
        ys = _dot(s_vec, y_vec)
        keep = step & (ys > 1e-10)
        slot = torch.remainder(n_stored, m)
        s_hist[lanes, slot] = _pick(keep, s_vec, s_hist[lanes, slot])
        y_hist[lanes, slot] = _pick(keep, y_vec, y_hist[lanes, slot])
        rho[lanes, slot] = torch.where(keep, 1.0 / ys, rho[lanes, slot])
        n_stored = n_stored + keep.long()
        n_evals = n_evals + torch.where(step, ls_evals,
                                        torch.zeros_like(ls_evals))
        stop = flat | (g_new.abs().amax(-1) <= tolerance_grad) \
            | (s_vec.abs().amax(-1) <= tolerance_change) \
            | ((f_new - f).abs() < tolerance_change) \
            | (n_evals >= max_eval)
        x = _pick(step, x + s_vec, x)
        f = torch.where(step, f_new, f)
        g = _pick(step, g_new, g)
        done = done | (act & stop)
        it = it + act.long()
    return x, f, g, LBFGSInfo(n_iter=it, func_evals=n_evals)


def lbfgs_minimize(fun: Callable, x0: torch.Tensor, max_iter: int = 20,
                   lr: float = 1.0, history_size: int = 20,
                   tolerance_grad: float = 1e-7,
                   tolerance_change: float = 1e-9, max_ls: int = 25,
                   max_eval: Optional[int] = None):
    r"""Minimize ``fun`` (flat vector ``[n]`` -> scalar) from ``x0``: one
    lane of :func:`lbfgs_minimize_lanes`. Returns ``(x, f, g)``."""
    x, f, g, _ = lbfgs_minimize_lanes(
        lambda x: fun(x[0])[None], x0[None], max_iter=max_iter, lr=lr,
        history_size=history_size, tolerance_grad=tolerance_grad,
        tolerance_change=tolerance_change, max_ls=max_ls, max_eval=max_eval)
    return x[0], f[0], g[0]

r"""Whole sequences, one after another, through the program's offline
entry ``models.sig_mp.forward_offline`` (closed loop, one client).

Each call hands one sequence over as numpy arrays and takes its poses and
translations back as numpy arrays. Under ``pallas_serve`` the steady step
of the whole sequence is one launch of the serve kernel, after the eager
first-frame prescan. The sequences come from a pool the generator makes
(``pool`` of them, lengths evenly spread over the traffic's range), in an
order drawn from the seed, the pool played again from its start when the
window needs more.
"""

from __future__ import annotations

import numpy as np

from .. import generate, inputs, program
from ..check import failed_part, gaps, merge, pick, reference_outputs
from ..harness import drive
from ..work import sigmp as work

__all__ = ["setup", "window", "release", "check"]


def setup(ctx, dev):
    from robustcap_tpu_torch.models import sig_mp
    t = ctx.traffic
    ctx.mark("program imported")
    bank = program.weights(ctx, dev)
    body = inputs.make_body(ctx.seed, dev, ctx.config["body"]["vertices"])
    model = program.body_model(ctx, body, dev)
    ctx.mark("weights and body")
    cfg = program.sigmp_config(t)
    pool = generate.make_pool(t, t["pool"], ctx.seed, dev)
    ctx.mark("traffic")
    state = dict(bank=bank, body=body, model=model, cfg=cfg, pool=pool,
                 forward=sig_mp.forward_offline,
                 gravity=np.asarray(t["gravity"], np.float32), dev=dev)
    # every shape the window uses: the prescan of each seeding and the
    # serve kernel (built on its first launch), on short sequences
    n = t["warmup_frames"]
    for i in range(len(t["seeding"])):
        j2dc, accc, oric = pool.frames(i)
        _call(state, i, j2dc[:n], accc[:n], oric[:n])
    return state


def _call(state, i, j2dc, accc, oric):
    first_tran, first_frame = state["pool"].seeding(i)
    pose, tran = state["forward"](
        state["bank"], state["model"], state["cfg"], j2dc, accc, oric,
        first_tran=first_tran, first_frame=first_frame,
        gravityc=state["gravity"], device=state["dev"])
    return pose.cpu().numpy(), tran.cpu().numpy()


def window(ctx, state, spans, tracer):
    r"""Sequences, the pool's in turn, until ``ctx.seconds`` have
    passed."""
    pool = state["pool"]
    outputs = []
    flags = program.flags(ctx.traffic)
    done = []
    for i in range(len(pool)):
        conf = pool.conf[pool.offsets[i]:pool.offsets[i + 1]]
        n = int(pool.lengths[i])
        done.append({"frames": n, "steps": n,
                     "refeeds": int(work.refeed_frames(conf, flags).sum()),
                     "inits": int(work.init_frame(conf, flags))})

    def call(k):
        i = k % len(pool)
        pose, tran = _call(state, i, *pool.frames(i))
        outputs.append((i, pose, tran))
        return done[i]

    calls, failed = drive(ctx, spans, tracer, "forward_offline", call)
    return {"calls": calls, "attempted": len(calls), "failed": failed,
            "outputs": outputs,
            "inputs": {k: state[k] for k in ("bank", "body", "pool")}}


def release(state):
    for key in ("model", "cfg", "forward"):
        state.pop(key, None)


def check(ctx, record, dev):
    r"""A sample of the sequences completed, drawn from the seed and with
    the longest among them, each against the reference run over the same
    frames with the same weights and body."""
    pool = record["inputs"]["pool"]
    done = [(i, p, tr) for i, p, tr in record["outputs"] if p is not None]
    if not done:
        return merge([failed_part()])
    sample = pick(ctx, sorted({i for i, _, _ in done}), pool.lengths)
    ref_pose, ref_tran = reference_outputs(ctx, record["inputs"], sample,
                                           dev)
    parts = []
    for row, i in enumerate(sample):
        n = pool.lengths[i]
        parts += [gaps(p, tr, ref_pose[row, :n], ref_tran[row, :n])
                  for j, p, tr in done if j == i]
    if record["failed"]:
        parts.append(failed_part())
    return merge(parts)

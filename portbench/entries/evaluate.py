r"""A corpus evaluated in buckets through the program's batched runner,
``eval.runner.run_sequences`` (calls back to back, each over the same
``rows`` sequence-views).

The views' lengths are evenly spread over the traffic's range, in a seeded
order, and the runner pads them into buckets of ``max_bucket`` rows, each
padded to a multiple of ``pad_to_multiple`` frames; the padding is real
work, and only valid frames count. The runner stacks the views on the
host, uploads them, runs the batched prescan and frame loop, and reads the
results back.
"""

from __future__ import annotations

import numpy as np

from .. import generate, inputs, program
from ..check import failed_part, gaps, merge, pick, reference_outputs
from ..harness import drive
from ..work import sigmp as work

__all__ = ["setup", "window", "release", "check"]


def _views(pool, gravity, n=None):
    r"""The pool's sequences as the runner's ``EvalSequence`` views (the
    runner reads no ground truth), cut to their first ``n`` frames where
    given."""
    from robustcap_tpu_torch.eval.datasets import EvalSequence
    seqs = []
    for i in range(len(pool)):
        j2dc, accc, oric = (x[:n] for x in pool.frames(i))
        T = len(j2dc)
        first_tran, first_frame = pool.seeding(i)
        seqs.append(EvalSequence(
            name=f"view_{i}", j2dc=j2dc, j2dc_px=j2dc, accc=accc, oric=oric,
            pose_gt=np.broadcast_to(np.eye(3, dtype=np.float32),
                                    (T, 24, 3, 3)),
            tran_gt=np.broadcast_to(np.zeros(3, np.float32), (T, 3)),
            gravityc=np.broadcast_to(gravity, (T, 3)),
            cam_K=np.eye(3, dtype=np.float32), first_tran=first_tran,
            first_frame=first_frame))
    return seqs


def setup(ctx, dev):
    from robustcap_tpu_torch.eval.runner import run_sequences
    t = ctx.traffic
    ctx.mark("program imported")
    bank = program.weights(ctx, dev)
    body = inputs.make_body(ctx.seed, dev, ctx.config["body"]["vertices"])
    model = program.body_model(ctx, body, dev)
    ctx.mark("weights and body")
    pool = generate.make_pool(t, t["rows"], ctx.seed, dev)
    gravity = np.asarray(t["gravity"], np.float32)
    state = dict(bank=bank, body=body, pool=pool, model=model,
                 cfg=program.sigmp_config(t), run=run_sequences,
                 seqs=_views(pool, gravity), dev=dev,
                 sample=pick(ctx, range(len(pool)), pool.lengths))
    ctx.mark("traffic")
    # the step at the bucket's rows: a call over the views' first frames
    _call(ctx, state, _views(pool, gravity, t["warmup_frames"]))
    return state


def _call(ctx, state, seqs):
    t = ctx.traffic
    return state["run"](state["bank"], state["model"], state["cfg"], seqs,
                        max_bucket=t["max_bucket"],
                        pad_to_multiple=t["pad_to_multiple"],
                        device=state["dev"])


def window(ctx, state, spans, tracer):
    r"""Calls over every view until ``ctx.seconds`` have passed."""
    pool = state["pool"]
    kept = []
    info = _work(ctx, pool)

    def call(k):
        kept.append(None)
        res = _call(ctx, state, state["seqs"])
        kept[-1] = {i: res[i] for i in state["sample"]}
        return info

    calls, failed = drive(ctx, spans, tracer, "run_sequences", call)
    return {"calls": calls, "attempted": len(calls), "failed": failed,
            "outputs": kept, "sample": state["sample"],
            "inputs": {k: state[k] for k in ("bank", "body", "pool")}}


def _work(ctx, pool):
    r"""What one call over the pool completes: its valid frames and
    frame-steps, the frames that take the plain step's extra work, and at
    each frame-step the tail evaluations it needs (one a row still inside
    its view, one more a refeed row)."""
    flags = program.flags(ctx.traffic)
    T = int(pool.lengths.max())
    valid = np.zeros(T, np.int64)
    refeed = np.zeros(T, np.int64)
    inits = 0
    for i in range(len(pool)):
        n = int(pool.lengths[i])
        conf = pool.conf[pool.offsets[i]:pool.offsets[i + 1]]
        valid[:n] += 1
        refeed[:n] += work.refeed_frames(conf, flags)
        inits += work.init_frame(conf, flags)
    return {"frames": int(valid.sum()), "steps": T,
            "refeeds": int(refeed.sum()), "inits": inits,
            "tail_rows": [int(x) for pair in zip(valid, refeed)
                          for x in pair]}


def release(state):
    for key in ("model", "cfg", "run", "seqs"):
        state.pop(key, None)


def check(ctx, record, dev):
    r"""A sample of the views, drawn from the seed and with the longest
    among them, from every call, each against the reference run over the
    whole view."""
    pool = record["inputs"]["pool"]
    sample = record["sample"]
    ref_pose, ref_tran = reference_outputs(ctx, record["inputs"], sample,
                                           dev)
    parts = []
    for out in record["outputs"]:
        if out is None:
            parts.append(failed_part())
            continue
        for row, i in enumerate(sample):
            n = pool.lengths[i]
            pose, tran = out[i]
            parts.append(gaps(pose, tran, ref_pose[row, :n],
                              ref_tran[row, :n]))
    return merge(parts)

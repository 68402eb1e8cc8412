r"""Live sessions served many at once through the program's multiplexer,
``streaming.multiplex.StreamingMultiplexer.step`` (closed loop: a tick's
frames are handed over as soon as the last tick's poses are back in
numpy, as a server catching up on buffered frames does).

Every slot always holds a session. When a session has played its last
frame, its slot is reset and the next session starts on the next tick with
a first frame on that row, so prescans of new subjects fall inside the
window. Each slot joins its first session part-way through, at a share of
its length drawn from the seed (the shares evenly spread over the slots),
so that sessions end and open at their steady rate from the first tick.
Session ``k`` plays sequence ``k mod pool`` of the generator's pool
(lengths evenly spread over the traffic's range, in a seeded order). A
tick's time runs from its inputs handed over (resets included) to its
poses and translations back as numpy arrays.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import generate, inputs, program
from ..check import failed_part, gaps, merge, pick, reference_outputs
from ..harness import drive
from ..inputs import generator
from ..work import sigmp as work

__all__ = ["setup", "window", "release", "check"]


class _Schedule:
    r"""Which session and frame each slot plays; session ``k`` is pool
    entry ``k mod len(pool)``, started in slot order as slots free up.
    ``age`` counts the frames since a slot's state was fresh and
    ``reached`` whether its state has fired the IMU re-init, for the
    count of the plain step's work."""

    def __init__(self, pool, capacity, seed, flags):
        self.pool, self.flags = pool, flags
        self.session = np.arange(capacity)
        share = (np.arange(capacity) + 0.5) / capacity
        perm = generator(seed, "stagger", "cpu")
        share = share[torch.randperm(capacity, generator=perm).numpy()]
        lens = pool.lengths[self.session % len(pool)]
        self.frame = np.floor(share * lens).astype(np.int64)
        self.age = np.zeros(capacity, np.int64)
        self.reached = np.zeros(capacity, bool)
        self.next = capacity

    def rows(self):
        r"""The pool rows of this tick's frames, and each slot's first
        flag."""
        seq = self.session % len(self.pool)
        return self.pool.offsets[seq] + self.frame, self.frame == 0

    def work(self, rows):
        r"""This tick's refeed frames and re-init firings."""
        conf = self.pool.conf[rows]
        refeeds = int(work.refeed_frames(conf, self.flags, self.age).sum())
        full = conf >= self.flags["conf_range"][1]
        inits = int((full & ~self.reached).sum())
        self.reached |= full
        return refeeds, inits

    def advance(self):
        r"""Move every slot one frame on; returns the slots whose session
        has ended, each given the next session from frame 0."""
        self.frame += 1
        self.age += 1
        seq = self.session % len(self.pool)
        ended = np.nonzero(self.frame >= self.pool.lengths[seq])[0]
        for s in ended:
            self.session[s] = self.next
            self.frame[s] = 0
            self.age[s] = 0
            self.reached[s] = False
            self.next += 1
        return ended


class _Kept:
    r"""The outputs of the sessions that play one of a few pool entries:
    the longest and ``2 * check_sequences - 1`` more drawn from the seed
    (the comparison's sample is drawn from those the window completes).
    Each such session's frames go into arrays of its own length, so that a
    tick keeps a few rows and not all 64: a run's host memory stays small,
    and with it the system time spent providing fresh memory, which
    otherwise took a tenth of the window and set fresh processes apart."""

    def __init__(self, pool, n, seed):
        longest = int(np.argmax(pool.lengths))
        rest = [i for i in range(len(pool)) if i != longest]
        order = torch.randperm(len(rest), generator=generator(
            seed, "keep", "cpu")).tolist()
        self.entries = np.zeros(len(pool), bool)
        self.entries[[longest] + [rest[j] for j in order[:n - 1]]] = True
        self.pool = pool
        self.out = {}    # session: [pose, tran, first frame, frames seen]

    def add(self, sched, pose, tran):
        seq = sched.session % len(self.pool)
        for s in np.nonzero(self.entries[seq])[0]:
            k, f = int(sched.session[s]), int(sched.frame[s])
            if k not in self.out:
                n = int(self.pool.lengths[seq[s]])
                self.out[k] = [np.empty((n, 24, 3, 3), np.float32),
                               np.empty((n, 3), np.float32), f, 0]
            o = self.out[k]
            o[0][f], o[1][f] = pose[s], tran[s]
            o[3] += 1

    def complete(self):
        r"""``{session: (pose, tran)}`` of those played from their first
        frame to their last."""
        return {k: (o[0], o[1]) for k, o in self.out.items()
                if o[2] == 0 and o[3] == len(o[0])}


def setup(ctx, dev):
    from robustcap_tpu_torch.streaming.multiplex import StreamingMultiplexer
    t = ctx.traffic
    ctx.mark("program imported")
    bank = program.weights(ctx, dev)
    body = inputs.make_body(ctx.seed, dev, ctx.config["body"]["vertices"])
    model = program.body_model(ctx, body, dev)
    ctx.mark("weights and body")
    pool = generate.make_pool(t, t["pool"], ctx.seed, dev)
    ctx.mark("traffic")
    mux = StreamingMultiplexer(bank, model, program.sigmp_config(t),
                               capacity=t["capacity"], device=dev)
    state = dict(bank=bank, body=body, pool=pool, mux=mux,
                 sched=_Schedule(pool, t["capacity"], ctx.seed,
                                 program.flags(t)),
                 gravity=np.broadcast_to(np.asarray(t["gravity"], np.float32),
                                         (t["capacity"], 3)),
                 kept=_Kept(pool, min(2 * t["check_sequences"], len(pool)),
                            ctx.seed),
                 reset=np.zeros(0, np.int64))
    # the first ticks of the traffic itself: the graph's capture at
    # capacity rows, replays, and the first sessions' ends, resets and
    # prescans
    for _ in range(t["warmup_ticks"]):
        _tick(state)
    return state


def _tick(state):
    r"""One tick; returns its start and end in ns and the work it
    completed, and records its outputs."""
    sched, pool, mux = state["sched"], state["pool"], state["mux"]
    rows, first = sched.rows()
    refeeds, inits = sched.work(rows)
    j2dc, accc, oric = pool.j2dc[rows], pool.accc[rows], pool.oric[rows]
    a = time.perf_counter_ns()
    for s in state["reset"]:
        mux.reset_slot(int(s))
    pose, tran = mux.step(j2dc, accc, oric,
                          first_frame=first if first.any() else None,
                          gravityc=state["gravity"])
    b = time.perf_counter_ns()
    state["kept"].add(sched, pose, tran)
    state["reset"] = sched.advance()
    n = len(rows)
    return a, b, {"frames": n, "steps": 1, "refeeds": refeeds,
                  "inits": inits, "tail_rows": [n, refeeds]}


def window(ctx, state, spans, tracer):
    r"""Ticks until ``ctx.seconds`` have passed."""
    def call(k):
        a, b, info = _tick(state)
        return dict(info, tick_ns=b - a)

    calls, failed = drive(ctx, spans, tracer, "multiplexer.step", call)
    return {"calls": calls, "attempted": len(calls), "failed": failed,
            "kept": state["kept"].complete(),
            "inputs": {k: state[k] for k in ("bank", "body", "pool")}}


def release(state):
    state.pop("mux", None)


def check(ctx, record, dev):
    r"""A sample of the sessions kept that played to their end, drawn from
    the seed and with the longest among them, each against the reference
    run over the whole session from its first frame."""
    pool = record["inputs"]["pool"]
    done = record["kept"]
    if not done:
        return merge([failed_part()])
    sample = pick(ctx, list(done),
                  {k: pool.lengths[k % len(pool)] for k in done})
    ref_pose, ref_tran = reference_outputs(
        ctx, record["inputs"], [k % len(pool) for k in sample], dev)
    parts = []
    for row, k in enumerate(sample):
        pose, tran = done[k]
        n = len(pose)
        parts.append(gaps(pose, tran, ref_pose[row, :n], ref_tran[row, :n]))
    if record["failed"]:
        parts.append(failed_part())
    return merge(parts)

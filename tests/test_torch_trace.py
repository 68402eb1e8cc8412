r"""The port's span recorder (``robustcap_tpu_torch.trace``): off it records
nothing; under a ``torch.profiler`` profile or between ``start`` and
``stop`` it records each span with its parent and root, on the wall clock,
up to its cap; and the three hot entries (``forward_offline``,
``run_sequences`` and the multiplexer's tick) emit their layer spans with
the right nesting. On the CPU the multiplexer's tick runs its step
directly, so the graph's spans show only on the card."""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from robustcap_tpu_torch import trace
from robustcap_tpu_torch.config import SigMPConfig
from robustcap_tpu_torch.eval.datasets import EvalSequence, bucket_sequences
from robustcap_tpu_torch.eval.runner import run_sequences
from robustcap_tpu_torch.models import sig_mp
from robustcap_tpu_torch.smpl import ParametricModel, synthetic_smpl_data
from robustcap_tpu_torch.streaming.multiplex import StreamingMultiplexer

SPECS = {"rnn2": (72, 69, 8, 0.4, True), "rnn3": (141, 3, 8, 0.4, False),
         "rnn4": (171, 69, 12, 0.4, False), "rnn6": (240, 3, 10, 0.4, False),
         "rnn7": (141, 144, 8, 0.1, False), "rnn8": (141, 2, 8, 0.4, False)}


@pytest.fixture(autouse=True)
def fresh():
    trace.stop()
    trace.clear()
    yield
    trace.stop()
    trace.clear()


@pytest.fixture(scope="module")
def world():
    params = sig_mp.init_params(torch.Generator().manual_seed(0), SPECS,
                                device="cpu")
    model = ParametricModel(data=synthetic_smpl_data(num_verts=100),
                            device="cpu")
    return params, model


def _frames(n, seed):
    rng = np.random.RandomState(seed)
    j2dc = rng.uniform(-0.3, 0.3, (n, 33, 3)).astype(np.float32)
    j2dc[..., 2] = rng.choice([0.2, 0.75, 0.95], (n, 1))
    accc = rng.normal(0, 1, (n, 6, 3)).astype(np.float32)
    oric = np.tile(np.eye(3, dtype=np.float32), (n, 6, 1, 1))
    return j2dc, accc, oric


def _tree(recorded):
    r"""Each span as ``(name, parent's name or None, root's name)``."""
    return [(n, recorded[p][0] if p >= 0 else None, recorded[r][0])
            for n, _, _, p, r in recorded]


def test_nothing_is_recorded_when_off():
    assert not trace.recording()
    assert trace.span("a") is trace.span("b")
    with trace.span("a"):
        with trace.span("b"):
            pass
    assert trace.spans() == [] and trace.dropped() == 0


def test_recorded_under_a_profile_and_between_start_and_stop():
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.recording()
        with trace.span("profiled"):
            pass
    assert not trace.recording()
    with trace.span("after"):
        pass
    trace.start()
    with trace.span("started"):
        pass
    trace.stop()
    with trace.span("stopped"):
        pass
    assert [s[0] for s in trace.spans()] == ["profiled", "started"]


def test_parents_roots_and_the_wall_clock():
    trace.start()
    before = time.time_ns()
    with trace.span("a"):
        with trace.span("b"):
            pass
        with trace.span("c"):
            with trace.span("d"):
                pass
    with trace.span("e"):
        pass
    after = time.time_ns()
    got = trace.spans()
    assert [(n, p, r) for n, _, _, p, r in got] == [
        ("a", -1, 0), ("b", 0, 0), ("c", 0, 0), ("d", 2, 0), ("e", -1, 4)]
    # a child lies inside its parent, and every span inside the wall-clock
    # interval read around them (the anchor pair's error is far below 1 ms)
    for n, a, b, p, _ in got:
        assert a <= b
        assert before - 10 ** 6 <= a and b <= after + 10 ** 6
        if p >= 0:
            assert got[p][1] <= a and b <= got[p][2]


def test_threads_do_not_nest_into_each_other():
    trace.start()
    inside, done = threading.Event(), threading.Event()

    def other():
        inside.wait(10)
        with trace.span("thread"):
            pass
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with trace.span("main"):
        inside.set()
        assert done.wait(10)
    t.join(10)
    assert not t.is_alive()
    got = {s[0]: s for s in trace.spans()}
    assert got["thread"][3] == -1 and got["main"][3] == -1


def test_open_spans_the_cap_and_clear(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 3)
    trace.start()
    with trace.span("open"):
        assert trace.spans()[0][2] is None
        for _ in range(4):
            with trace.span("child"):
                pass
    assert [s[0] for s in trace.spans()] == ["open", "child", "child"]
    assert all(s[2] is not None for s in trace.spans())
    assert trace.dropped() == 2
    trace.clear()
    assert trace.spans() == [] and trace.dropped() == 0
    with trace.span("across"):
        trace.clear()
        with trace.span("after"):
            pass
    assert [s[0] for s in trace.spans()] == ["after"]


@pytest.mark.parametrize("serve", [False, True])
def test_forward_offline_spans(world, serve):
    params, model = world
    cfg = SigMPConfig(pallas_serve=serve)
    trace.start()
    sig_mp.forward_offline(params, model, cfg, *_frames(6, 0),
                           first_frame=True, device="cpu")
    tail = (["offline.repack", "offline.launch"] if serve
            else ["offline.loop"])
    assert _tree(trace.spans()) == [("offline", None, "offline")] + [
        (n, "offline", "offline")
        for n in ["offline.inputs", "offline.prescan"] + tail]


def _views(lengths):
    seqs = []
    for i, n in enumerate(lengths):
        j2dc, accc, oric = _frames(n, i)
        seqs.append(EvalSequence(
            name=f"v{i}", j2dc=j2dc, j2dc_px=j2dc, accc=accc, oric=oric,
            pose_gt=np.tile(np.eye(3, dtype=np.float32), (n, 24, 1, 1)),
            tran_gt=np.zeros((n, 3), np.float32),
            gravityc=np.tile(sig_mp.DEFAULT_GRAVITY, (n, 1)),
            cam_K=np.eye(3, dtype=np.float32),
            first_tran=np.array([0.1, -0.2, 3.0], np.float32),
            first_frame=False))
    return seqs


def test_run_sequences_spans_one_loop_a_bucket(world):
    params, model = world
    seqs = _views([5, 7, 3, 6, 4])
    buckets = bucket_sequences(seqs, max_bucket=2, pad_to_multiple=4)
    assert len(buckets) == 3
    trace.start()
    run_sequences(params, model, SigMPConfig(), seqs, max_bucket=2,
                  pad_to_multiple=4, device="cpu")
    tree = _tree(trace.spans())
    per_bucket = [("runner.stack", "runner", "runner"),
                  ("batched.upload", "runner", "runner"),
                  ("batched.prescan", "runner", "runner"),
                  ("batched.loop", "runner", "runner")]
    assert tree == ([("runner", None, "runner")] + per_bucket * 3
                    + [("runner.readback", "runner", "runner")] * 3)
    assert sum(n == "batched.loop" for n, _, _ in tree) == len(buckets)


def test_multiplexer_spans(world):
    params, model = world
    mux = StreamingMultiplexer(params, model, SigMPConfig.live_mode(),
                               capacity=4, device="cpu")
    j2dc, accc, oric = _frames(4, 3)
    first = np.array([True, False, True, False])
    trace.start()
    mux.reset_slot(1)
    mux.step(j2dc, accc, oric, first_frame=first)
    mux.step(j2dc, accc, oric)
    assert _tree(trace.spans()) == [
        ("mux.reset", None, "mux.reset"),
        ("mux.step", None, "mux.step"),
        ("mux.inputs", "mux.step", "mux.step"),
        ("mux.prescan", "mux.step", "mux.step"),
        ("mux.readback", "mux.step", "mux.step"),
        ("mux.step", None, "mux.step"),
        ("mux.inputs", "mux.step", "mux.step"),
        ("mux.readback", "mux.step", "mux.step")]
    roots = [r for _, _, _, _, r in trace.spans()]
    assert roots == [0, 1, 1, 1, 1, 5, 5, 5]

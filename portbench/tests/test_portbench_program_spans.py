r"""The readers of the program's spans (:mod:`portbench.program_spans`) on
made-up spans and device events, a traced run of each cell on the CPU that
reports the cell's span metric, and on the card the clock check: a span
around one launch and its synchronize holds the kernel's interval in the
harness's device trace, whose profile alone turns the recorder on."""

import json
import os
import time

import pytest

from conftest import ROOT
from portbench import program_spans as ps
from portbench import run
from portbench.harness import Spans, Tracer, busy_union
from small import small_context

from robustcap_tpu_torch import trace

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
# the metric each cell reports from the program's spans
SPAN_METRIC = {cell: m["name"] for m in SPEC["per_layer"]
               if m["source"] == "program_span"
               and m["name"] != "seq_overhead_ms"
               for cell in m["workloads"]}


def _span(name, a, b, parent, root, index):
    return ps.Span(name, a, b, parent, root, index)


# two ticks: the first with a reset and a prescan, the second without
TICKS = [_span("mux.reset", 100, 110, -1, 0, 0),
         _span("mux.step", 112, 190, -1, 1, 1),
         _span("mux.inputs", 113, 120, 1, 1, 2),
         _span("mux.prescan", 120, 140, 1, 1, 3),
         _span("graph.replay", 141, 160, 1, 1, 4),
         _span("mux.readback", 160, 189, 1, 1, 5),
         _span("mux.step", 210, 260, -1, 6, 6),
         _span("mux.inputs", 211, 215, 6, 6, 7),
         _span("graph.replay", 215, 230, 6, 6, 8),
         _span("mux.readback", 230, 259, 6, 6, 9)]
CALLS = [{"start": 95, "end": 195}, {"start": 205, "end": 265}]


def _reading(calls, events=()):
    return {"record": {"calls": calls}, "events": list(events), "lo": 0,
            "hi": 300}


def test_self_time_is_less_the_children():
    own = ps.self_ns(TICKS)
    assert own[1] == 78 - (7 + 20 + 19 + 29)
    assert own[6] == 50 - (4 + 15 + 29)
    assert own[5] == 29


def test_tick_host_ms():
    got = ps.tick_host_ms(_reading(CALLS), TICKS)
    assert got == ((10 + 78 - 29) + (50 - 29)) / 2 / 1e6
    assert ps.tick_host_ms(_reading(CALLS), None) is None
    assert ps.tick_host_ms(_reading([{"start": 300, "end": 400}]),
                           TICKS) is None


def test_seq_host_ms_and_eval_stage_ms():
    seq = [_span("offline", 10, 40, -1, 0, 0),
           _span("offline.launch", 30, 39, 0, 0, 1),
           _span("offline", 50, 70, -1, 2, 2)]
    assert ps.seq_host_ms(_reading([]), seq) == 25 / 1e6
    # the first sequence's serve kernel starts inside its span at 36
    serve = [("serve_scan_kernel", 36, 48), ("other", 20, 60),
             ("serve_scan_kernel", 72, 80)]
    assert ps.seq_host_ms(_reading([], serve), seq) == (26 + 20) / 2 / 1e6
    assert ps.seq_host_ms(_reading([]), TICKS) is None
    ev = [_span("runner", 10, 100, -1, 0, 0),
          _span("runner.stack", 11, 20, 0, 0, 1),
          _span("batched.upload", 20, 24, 0, 0, 2),
          _span("batched.loop", 30, 60, 0, 0, 3),
          _span("runner.stack", 61, 65, 0, 0, 4),
          _span("batched.upload", 65, 66, 0, 0, 5),
          _span("runner.readback", 70, 99, 0, 0, 6)]
    got = ps.eval_stage_ms(_reading([{"start": 5, "end": 105}]), ev)
    assert got == (9 + 4 + 4 + 1) / 1e6


def test_idle_intervals_match_the_union():
    events = [("a", -5, 10), ("b", 5, 20), ("c", 30, 40), ("d", 41, 45),
              ("e", 290, 320)]
    idle = ps.idle_intervals(events, 0, 300)
    assert idle == [(20, 30), (40, 41), (45, 290)]
    assert sum(b - a for a, b in idle) == 300 - busy_union(events, 0, 300)
    assert ps.idle_intervals([], 0, 300) == [(0, 300)]


def test_idle_by_span_splits_three_ways():
    # the device runs in the prescan and the replays; idle elsewhere
    events = [("prescan", 125, 138), ("replay", 150, 170),
              ("replay", 220, 240)]
    calls = [("multiplexer.step", c["start"], c["end"]) for c in CALLS]
    got = ps.idle_by_span(events, TICKS, calls, 0, 300)
    assert got["idle_ns"] == 300 - busy_union(events, 0, 300)
    assert got["spans"] == {
        "mux.reset": 10, "mux.step": 1 + 1 + 1 + 1 + 1,
        "mux.inputs": 7 + 4, "mux.prescan": 5 + 2,
        "graph.replay": 9 + 5, "mux.readback": 19 + 19}
    # in a call with no program span open: 95-100, 110-112, 190-195,
    # 205-210, 260-265; the rest of the window lies between calls, the
    # gap from 195 to 205 among it
    assert got["calls"] == {"multiplexer.step": 5 + 2 + 5 + 5 + 5}
    assert got["between_calls"] == 95 + 10 + 35
    assert (sum(got["spans"].values()) + sum(got["calls"].values())
            + got["between_calls"]) == got["idle_ns"]


def test_recorded_clips_to_the_window_and_needs_one():
    trace.clear()
    trace.start()
    try:
        with trace.span("before"):
            pass
        lo = time.time_ns()
        with trace.span("inside"):
            with trace.span("child"):
                pass
        hi = time.time_ns()
        with trace.span("after"):
            pass
    finally:
        trace.stop()
    got = ps.recorded({"lo": lo, "hi": hi})
    assert [(s.name, s.parent, s.root, s.index) for s in got] == [
        ("inside", -1, 1, 1), ("child", 1, 1, 2)]
    assert ps.recorded({"lo": None, "hi": None}) is None
    trace.clear()
    assert ps.recorded({"lo": lo, "hi": hi}) is None


@pytest.mark.parametrize("cell", sorted(SPAN_METRIC))
def test_a_traced_run_reports_its_span_metric(cell):
    r"""On the CPU the harness traces no device, so the window is the
    traced calls' span; the recorder is started by hand."""
    trace.clear()
    trace.start()
    try:
        res, _, _, _ = run.run(small_context(cell, seconds=0.3, trace=True),
                               time.perf_counter(), device="cpu")
    finally:
        trace.stop()
        trace.clear()
    assert res["correct"]
    assert res["metrics"][SPAN_METRIC[cell]]["value"] > 0


@pytest.mark.card
def test_a_span_holds_its_kernel_on_the_device_clock(card):
    import torch
    x = torch.randn(4096, 4096, device=card)
    torch.cuda.synchronize(card)
    trace.clear()
    tr = Tracer(True, Spans(), lambda: torch.cuda.synchronize(card))
    tr.start()
    on = trace.recording()
    with trace.span("launch"):
        x @ x
        torch.cuda.synchronize(card)
    tr.stop()
    (_, a, b, _, _), = trace.spans()
    trace.clear()
    assert on and not trace.recording()
    kernels = [(s, e) for n, s, e in tr.events if "emcpy" not in n
               and "emset" not in n]
    assert kernels
    assert all(a <= s and e <= b for s, e in kernels), (a, b, kernels)

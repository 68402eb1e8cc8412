r"""Where a traced window's device idle time goes, by the program's spans,
and what a span costs.

    python3 portbench/spans_report.py --seed <n> --seconds <s> [--workload <cell> ...] [--out <file.json>]

from the root of a checkout, on the card. First it times a span site of
``robustcap_tpu_torch.trace`` off and on (ns a span, less an empty loop).
Then it runs each cell once with ``--trace 1`` in this process, as
``portbench/run.py`` does, and prints the cell's per-layer metrics, the
window's device idle time split by :func:`portbench.program_spans.idle_by_span`
(the innermost program span the host was in, the benchmark's call with no
program span, between calls; their sum against the idle time the union of
device events leaves), each span's count and mean self time a call, and
the counts of ``graph.capture`` and ``native.build`` in the window; then
once more with ``--trace 0`` and the recorder started by hand, without a
profile, each span's count and mean self time a call over the whole
window (the host's split without the profiler's own cost). With ``--out``
it writes the same as JSON.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def span_cost(n=200_000, repeats=5):
    r"""``{"off_ns", "on_ns"}``: the least time over ``repeats`` loops of
    ``n`` spans, less an empty loop's, per span; on, between
    ``trace.start`` and ``trace.stop``, the spans cleared after."""
    from robustcap_tpu_torch import trace

    def loop(body):
        best = None
        for _ in range(repeats):
            t = time.perf_counter_ns()
            body()
            t = time.perf_counter_ns() - t
            best = t if best is None else min(best, t)
        return best / n

    def empty():
        for _ in range(n):
            pass

    def spans():
        for _ in range(n):
            with trace.span("cost"):
                pass

    base = loop(empty)
    off = loop(spans) - base
    trace.start()
    try:
        on = loop(spans) - base
    finally:
        trace.stop()
        trace.clear()
    return {"off_ns": off, "on_ns": on}


def _per_call(spans, n):
    r"""Each span name's count and summed self time (ms) over ``n``
    calls, per call."""
    from portbench import program_spans
    own = program_spans.self_ns(spans)
    count, ns = {}, {}
    for s in spans:
        count[s.name] = count.get(s.name, 0) + 1
        ns[s.name] = ns.get(s.name, 0) + own[s.index]
    return ({k: c / n for k, c in count.items()},
            {k: t / n / 1e6 for k, t in ns.items()})


def traced_cell(workload, seed, seconds):
    r"""One ``--trace 1`` run of ``workload`` through :func:`run.run`,
    keeping its device trace; returns its metrics and the window's idle
    split, spans a call and counts."""
    from robustcap_tpu_torch import trace

    from portbench import harness, program_spans, run

    kept = []

    class Kept(harness.Tracer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            kept.append(self)

    trace.clear()
    calls_spans = harness.Spans()
    real = harness.Tracer
    harness.Tracer = Kept
    try:
        ctx = harness.Context(workload, seed, seconds, True)
        result, _, power, _ = run.run(ctx, time.perf_counter(),
                                      spans=calls_spans)
    finally:
        harness.Tracer = real
    tr = kept[-1]
    lo, hi = tr.lo, tr.hi
    spans = program_spans.recorded({"lo": lo, "hi": hi}) or []
    calls = [s for s in calls_spans.items if lo <= s[1] and s[2] <= hi]
    split = program_spans.idle_by_span(tr.events, spans, calls, lo, hi)
    idle = (hi - lo) - harness.busy_union(tr.events, lo, hi)
    parts = (sum(split["spans"].values()) + sum(split["calls"].values())
             + split["between_calls"])
    n = max(len(calls), 1)
    count, self_ms = _per_call(spans, n)
    return {
        "workload": workload, "seed": seed, "power_limit": power,
        "device": result["device"], "correct": result["correct"],
        "metrics": {k: v["value"] for k, v in result["metrics"].items()},
        "calls": len(calls),
        "call_mean_ms": sum(b - a for _, a, b in calls) / n / 1e6,
        "window_s": (hi - lo) / 1e9, "idle_s": idle / 1e9,
        "parts_over_idle": parts / idle if idle else None,
        "idle_by_span_ms": {k: v / 1e6 for k, v in sorted(
            split["spans"].items(), key=lambda x: -x[1])},
        "idle_in_call_ms": {k: v / 1e6 for k, v in split["calls"].items()},
        "idle_between_calls_ms": split["between_calls"] / 1e6,
        "spans_a_call": count, "self_ms_a_call": self_ms,
        "in_window": {k: round(count.get(k, 0) * n)
                      for k in ("graph.capture", "native.build")},
        "dropped": trace.dropped(),
    }


def recorded_cell(workload, seed, seconds):
    r"""One ``--trace 0`` run of ``workload`` with the recorder started by
    hand and no profile: the spans' split of the host's time without the
    profiler's own cost. Returns its end-to-end metrics and, over every
    call of the window, the mean call and each span's count and mean self
    time a call."""
    from robustcap_tpu_torch import trace

    from portbench import harness, program_spans, run

    trace.clear()
    calls_spans = harness.Spans()
    trace.start()
    try:
        ctx = harness.Context(workload, seed, seconds, False)
        result, _, _, _ = run.run(ctx, time.perf_counter(),
                                  spans=calls_spans)
    finally:
        trace.stop()
    calls = calls_spans.items
    lo, hi = calls[0][1], calls[-1][2]
    spans = program_spans.recorded({"lo": lo, "hi": hi}) or []
    trace.clear()
    n = len(calls)
    count, self_ms = _per_call(spans, n)
    return {
        "workload": workload, "seed": seed, "correct": result["correct"],
        "metrics": {k: v["value"] for k, v in result["metrics"].items()},
        "calls": n, "call_mean_ms": sum(b - a for _, a, b in calls) / n / 1e6,
        "spans_a_call": count, "self_ms_a_call": self_ms,
    }


def _print_recorded(rep):
    print(f"== {rep['workload']} seed {rep['seed']}, recorder on, no "
          f"profile: correct {rep['correct']}, {rep['calls']} calls of "
          f"{rep['call_mean_ms']:.3f} ms")
    print("metrics " + json.dumps(rep["metrics"]))
    for name, c in rep["spans_a_call"].items():
        print(f"  span {name:40s} {c:10.3f} a call, self "
              f"{rep['self_ms_a_call'][name]:.4f} ms a call")


def _print(rep):
    print(f"== {rep['workload']} seed {rep['seed']} on "
          f"{rep['device']['kind']}, power limit {rep['power_limit']}: "
          f"correct {rep['correct']}, {rep['calls']} calls of "
          f"{rep['call_mean_ms']:.3f} ms, window {rep['window_s']:.4f} s, "
          f"idle {rep['idle_s']:.4f} s, parts/idle "
          f"{rep['parts_over_idle']!r}")
    print("metrics " + json.dumps(rep["metrics"]))
    idle_ms = rep["idle_s"] * 1e3
    rows = list(rep["idle_by_span_ms"].items()) + [
        (f"{k} (no program span)", v)
        for k, v in rep["idle_in_call_ms"].items()] + [
        ("between calls", rep["idle_between_calls_ms"])]
    for name, ms in rows:
        print(f"  idle {name:40s} {ms:12.3f} ms "
              f"{100 * ms / idle_ms if idle_ms else 0:7.2f}%")
    for name, c in rep["spans_a_call"].items():
        print(f"  span {name:40s} {c:10.3f} a call, self "
              f"{rep['self_ms_a_call'][name]:.4f} ms a call")
    print(f"  in window {rep['in_window']}, dropped {rep['dropped']}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--workload", action="append", default=[])
    p.add_argument("--out")
    args = p.parse_args(argv)
    from portbench import run
    run._environment()
    import torch
    if not torch.cuda.is_available():
        print("spans_report: no CUDA device; nothing measured",
              file=sys.stderr)
        return 2
    out = {"span_cost": span_cost(), "cells": [], "recorded": []}
    print("span cost " + json.dumps(out["span_cost"]), flush=True)
    for k, cell in enumerate(args.workload):
        rep = traced_cell(cell, args.seed + 2 * k, args.seconds)
        _print(rep)
        out["cells"].append(rep)
        rep = recorded_cell(cell, args.seed + 2 * k + 1, args.seconds)
        _print_recorded(rep)
        out["recorded"].append(rep)
        sys.stdout.flush()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

r"""The pieces every cell shares: the benchmark's files found by name, the
card and its power limit, host-clock spans around the calls into the
program, the device trace of a ``--trace 1`` window, and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); the mix names the entry point
it drives (``entries/<entry>.py``), which sets the program up, runs the
window and hands the sampled outputs to the reference. Each metric of the
cell is read by ``metrics/<name>.py`` (see :func:`load_module`). Nothing
here names a cell.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import time

__all__ = ["ROOT", "Context", "Spans", "Tracer", "drive", "device_info",
           "busy_union", "breakdown", "load_module"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    r"""``portbench/<kind>/<name>.py`` as a module. A name may hold dots;
    where no file has the whole name, the file of the part before the
    first dot serves it: ``metrics/mfu.py`` reads ``mfu.seq`` and
    ``mfu.eval`` alike, unless ``metrics/mfu.eval.py`` is there."""
    path = os.path.join(ROOT, "portbench", kind, name + ".py")
    if not os.path.exists(path):
        path = os.path.join(ROOT, "portbench", kind,
                            name.split(".", 1)[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Context:
    r"""One run of one cell: its entry of ``BENCHMARK.json``, configuration,
    traffic file, seed and window length."""

    def __init__(self, workload: str, seed: int, seconds: float,
                 trace: bool, spec=None):
        self.spec = _json("BENCHMARK.json") if spec is None else spec
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if workload not in cells:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        configs = {c["name"]: c for c in self.spec["configs"]}
        self.config = _json(configs[self.cell["config"]]["file"])
        self.traffic = _json("portbench", "traffic",
                             self.cell["traffic"] + ".json")
        self.workload = workload
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.peaks = _json("portbench", "work", "peaks.json")
        self.marks = []

    def mark(self, stage: str):
        r"""Note that set-up has reached the end of ``stage`` (printed on
        standard error with its time)."""
        self.marks.append((stage, time.perf_counter()))

    def metrics_of(self, kind: str):
        r"""The cell's ``end_to_end`` or ``per_layer`` entries."""
        return [m for m in self.spec[kind]
                if self.workload in m.get("workloads", [self.workload])]


class Spans:
    r"""Host-clock spans around the calls into the program, kept in memory:
    ``(name, start_ns, end_ns)`` on the wall clock the device trace uses
    (``time.time_ns``), measured with ``time.perf_counter_ns``."""

    def __init__(self):
        self.items = []
        self._wall0 = time.time_ns()
        self._perf0 = time.perf_counter_ns()

    def now(self) -> int:
        return self._wall0 + time.perf_counter_ns() - self._perf0

    def add(self, name, start_ns, end_ns):
        self.items.append((name, start_ns, end_ns))


class Tracer:
    r"""The device profile of a ``--trace 1`` run's traced window (CUDA
    activity only, so that the host pays little): :meth:`start` and
    :meth:`stop` bound it, each after the device has finished its queued
    work, and afterwards :attr:`events` is the list of ``(name, start_ns,
    end_ns)`` of every kernel, copy and set on the device, on the host's
    wall clock, and :attr:`lo`, :attr:`hi` the window's ends. Off, it does
    nothing."""

    def __init__(self, on: bool, spans, sync):
        self.on = on
        self.spans = spans
        self.sync = sync
        self.events = []
        self.lo = self.hi = None
        self._prof = None

    def start(self):
        if not self.on or self._prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile
        self.sync()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.lo = self.spans.now()

    def stop(self):
        if self._prof is None or self.hi is not None:
            return
        self.sync()
        self.hi = self.spans.now()
        self._prof.__exit__(None, None, None)
        for e in self._prof.profiler.kineto_results.events():
            if str(e.device_type()).endswith("CUDA") \
                    and not e.is_user_annotation():
                start = e.start_ns()
                self.events.append((e.name(), start,
                                    start + e.duration_ns()))
        self.events.sort(key=lambda x: x[1])
        self._prof = None


def drive(ctx, spans, tracer, name, call):
    r"""The window of an entry: ``call(k)`` for ``k = 0, 1, ...``, each
    returning ``{"frames", "steps", "refeeds", "inits", ...}``
    of the work it completed (:mod:`portbench.readers`), until ``ctx.seconds`` have passed (each call runs whole);
    with ``ctx.trace`` the first ``trace_calls`` calls are the traced
    window. A call that raises ``RuntimeError`` counts as failed and
    completes nothing. Returns ``(calls, failed)``, each call's dict with
    its span's ``start`` and ``end``."""
    n_trace = ctx.traffic["trace_calls"] if ctx.trace else 0
    calls, failed = [], 0
    t_end = time.perf_counter() + ctx.seconds
    if n_trace:
        tracer.start()
    k = 0
    while True:
        a = spans.now()
        try:
            info = call(k)
        except RuntimeError:
            failed += 1
            info = {"frames": 0, "steps": 0, "refeeds": 0, "inits": 0,
                    "tail_rows": []}
        b = spans.now()
        spans.add(name, a, b)
        calls.append(dict(info, start=a, end=b))
        k += 1
        if k == n_trace:
            tracer.stop()
        if k >= n_trace and time.perf_counter() >= t_end:
            return calls, failed


def busy_union(events, lo=None, hi=None) -> int:
    r"""Nanoseconds in which at least one device event ran (the union of
    their intervals), clipped to ``[lo, hi]``."""
    busy, end = 0, None
    for _, a, b in events:
        if lo is not None:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def _short(name, n=48):
    return name if len(name) <= n else name[:n - 3] + "..."


def breakdown(events, spans, lo, hi, k=10):
    r"""The traced window's ``device_ops`` (the ``k`` device operations
    that took most time, summed by name, in seconds) and ``idle_gaps``
    (the ``k`` longest gaps between device operations, each named by the
    span the host was in at the gap's middle and the operations on either
    side)."""
    total = {}
    for name, a, b in events:
        total[name] = total.get(name, 0) + (b - a)
    ops = sorted(total.items(), key=lambda x: -x[1])[:k]
    gaps = []
    prev_end, prev_name = lo, "window start"
    for name, a, b in events:
        if a > prev_end:
            gaps.append((a - prev_end, prev_end, prev_name, name))
        if b > prev_end:
            prev_end, prev_name = b, name
    if hi > prev_end:
        gaps.append((hi - prev_end, prev_end, prev_name, "window end"))
    gaps.sort(key=lambda g: -g[0])

    def host_at(t):
        inside = [s for s in spans if s[1] <= t < s[2]]
        return inside[-1][0] if inside else "between calls"

    idle = [[f"{host_at(t + d // 2)}: {_short(p)} -> {_short(n)}", d / 1e9]
            for d, t, p, n in gaps[:k]]
    return {"device_ops": [[_short(n, 96), s / 1e9] for n, s in ops],
            "idle_gaps": idle}


def device_info(count: int):
    r"""``{"platform", "kind", "count"}`` of the card, and its power limit
    as ``nvidia-smi`` reads it (``None`` where it cannot)."""
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
        limit = out[0].split(",")[-1].strip() if out else None
    except (OSError, subprocess.SubprocessError):
        limit = None
    return info, limit

r"""The program's own spans (``robustcap_tpu_torch.trace``) in a traced
window, the per-layer metrics that read them, and the window's device idle
time put down to them.

A program span is ``(name, start_ns, end_ns, parent, root)`` on the device
trace's clock, ``parent`` and ``root`` its parent's and root's index in the
program's list (-1: none). The program records them while the window's
profile is active, so the spans of a ``--trace 1`` run are those of its
traced calls. A program older than its recorder gives none: the readers
then return ``None`` and the line leaves their metrics out.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

from portbench.readers import SERVE_KERNEL

__all__ = ["Span", "recorded", "self_ns", "idle_intervals", "idle_by_span",
           "seq_host_ms", "tick_host_ms", "eval_stage_ms"]


class Span(NamedTuple):
    name: str
    start: int
    end: int
    parent: int
    root: int
    index: int


def recorded(r):
    r"""The program's spans that closed inside the reading's traced window
    ``[lo, hi]``, each with its index, or ``None`` where the program has no
    recorder or recorded nothing there."""
    if r["lo"] is None:
        return None
    try:
        from robustcap_tpu_torch import trace
    except ImportError:
        return None
    lo, hi = r["lo"], r["hi"]
    out = [Span(*s, i) for i, s in enumerate(trace.spans())
           if s[2] is not None and lo <= s[1] and s[2] <= hi]
    return out or None


def self_ns(spans):
    r"""``{index: ns}``: each span's duration less the time its children
    (spans whose parent it is) cover."""
    own = {s.index: s.end - s.start for s in spans}
    for s in spans:
        if s.parent in own:
            own[s.parent] -= s.end - s.start
    return own


def _per_call(r, spans, root):
    r"""For each benchmark call of the window in which a ``root`` span
    opened, ``{name: ns}`` summed over the program spans inside it."""
    calls = r["record"]["calls"]
    starts = [c["start"] for c in calls]
    per = [None] * len(calls)
    for s in spans or ():
        k = bisect.bisect_right(starts, s.start) - 1
        if k < 0 or s.end > calls[k]["end"]:
            continue
        if per[k] is None:
            per[k] = {}
        per[k][s.name] = per[k].get(s.name, 0) + s.end - s.start
    return [p for p in per if p is not None and root in p]


def seq_host_ms(r, spans):
    r"""The host's time in ``forward_offline`` until its serve kernel runs
    (the ``offline`` span less the part of it the kernel covers on the
    device: the operator's return after the launch, which the kernel
    hides; the read-back is the caller's), the mean over the window's
    sequences, in ms."""
    serve = [(a, b) for n, a, b in r["events"] if SERVE_KERNEL in n]
    own = [s.end - s.start - sum(min(b, s.end) - max(a, s.start)
                                 for a, b in serve
                                 if a < s.end and b > s.start)
           for s in spans or () if s.name == "offline"]
    return sum(own) / len(own) / 1e6 if own else None


def tick_host_ms(r, spans):
    r"""Per tick (a benchmark call), the host's time in ``mux.reset`` and
    ``mux.step`` less ``mux.readback``, the wait on the device and the
    read-back; the mean over the window's ticks, in ms."""
    per = [p.get("mux.reset", 0) + p["mux.step"] - p.get("mux.readback", 0)
           for p in _per_call(r, spans, "mux.step")]
    return sum(per) / len(per) / 1e6 if per else None


def eval_stage_ms(r, spans):
    r"""Per evaluation call, the host's staging before each bucket's first
    kernel, ``runner.stack`` and ``batched.upload``; the mean over the
    window's calls, in ms."""
    per = [p.get("runner.stack", 0) + p.get("batched.upload", 0)
           for p in _per_call(r, spans, "runner")]
    return sum(per) / len(per) / 1e6 if per else None


def idle_intervals(events, lo, hi):
    r"""The intervals of ``[lo, hi]`` in which no device event ran (the
    events sorted by start), in order."""
    out, end = [], lo
    for _, a, b in events:
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            return out
    out.append((end, hi))
    return out


def _innermost(items):
    r"""The timeline cut wherever one of ``items`` (``name, start, end,
    ...``) begins or ends, as ``(a, b, name)`` pieces labelled by the
    innermost item over them (the one that began last), in order; pieces no
    item covers are left out."""
    items = sorted(items, key=lambda s: (s[1], -s[2]))
    bounds = sorted({t for s in items for t in (s[1], s[2])})
    out, active, j = [], [], 0
    for a, b in zip(bounds, bounds[1:]):
        while j < len(items) and items[j][1] <= a:
            active.append(items[j])
            j += 1
        active = [s for s in active if s[2] > a]
        if active:
            out.append((a, b, max(active, key=lambda s: (s[1], -s[2]))[0]))
    return out


def _split(pieces, labelled):
    r"""``pieces`` (``(a, b)``, in order) cut by ``labelled`` (``(a, b,
    label)``, disjoint, in order): ns by label, and what no label
    covers."""
    got, rest, j = {}, [], 0
    for a, b in pieces:
        while j < len(labelled) and labelled[j][1] <= a:
            j += 1
        t, k = a, j
        while t < b and k < len(labelled) and labelled[k][0] < b:
            s0, s1, name = labelled[k]
            if s0 > t:
                rest.append((t, s0))
                t = s0
            e = min(s1, b)
            if e > t:
                got[name] = got.get(name, 0) + e - t
                t = e
            k += 1
        if t < b:
            rest.append((t, b))
    return got, rest


def idle_by_span(events, spans, calls, lo, hi):
    r"""The device's idle time in ``[lo, hi]`` split three ways: by the
    innermost program span the host was in (``spans``), else by the
    benchmark's call it was in with no program span open (``calls``, as
    ``(name, start, end)``), else between calls. Returns ``{"idle_ns",
    "spans": {name: ns}, "calls": {name: ns}, "between_calls"}``; the three
    parts sum to ``idle_ns``."""
    idle = idle_intervals(events, lo, hi)
    by_span, rest = _split(idle, _innermost(spans))
    by_call, between = _split(rest, _innermost(calls))
    return {"idle_ns": sum(b - a for a, b in idle), "spans": by_span,
            "calls": by_call,
            "between_calls": sum(b - a for a, b in between)}

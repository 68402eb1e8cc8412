r"""How each metric is read, shared by the files under ``metrics/``: a
metric ``<name>`` is read by ``metrics/<name>.py``, whose ``read(r)``
returns its value from a run's reading ``r`` (``ctx``, the calls of the
window with their host-clock spans, ``spans``, and with ``--trace 1`` the
device ``events`` of the traced window ``[lo, hi]``, ``window_s`` long,
the calls and spans cut to it; ``host_calls``, the calls the profiler did
not trace), or ``None`` where the run gives it nothing to read. Each call
states the work it completed: ``frames`` (valid), ``steps``, ``refeeds``
and ``inits`` (frames that take the plain step's extra work,
:mod:`portbench.work.sigmp`) and, in the batched cells, ``tail_rows`` (the
rows of each tail evaluation its steps need).
"""

import numpy as np

from portbench.harness import busy_union
from portbench.work import geometry_tail, serve_scan, sigmp

__all__ = ["frames_per_s", "tick_ms", "mfu", "device_idle",
           "serve_roofline", "tail_roofline", "kernels_per_step",
           "seq_overhead_ms"]

SERVE_KERNEL = "serve_scan_kernel"
TAIL_KERNEL = "geometry_tail_kernel"
_PEAK = {"float32": "f32_flops", "bfloat16": "bf16_flops"}


def frames_per_s(r):
    r"""Every valid output frame completed in the window, over all the time
    from the first call's start to the last call's end (host clock; calls
    run whole)."""
    calls = r["record"]["calls"]
    if not calls:
        return None
    span_s = (calls[-1]["end"] - calls[0]["start"]) / 1e9
    return sum(c["frames"] for c in calls) / span_s


def tick_ms(r, q):
    r"""The ``q``-th percentile, over every tick the profiler did not
    trace (all of a ``--trace 0`` window's), of the time from a tick's
    inputs handed over as numpy to its poses and translations back in
    numpy (host clock), ticks that open sessions included."""
    ticks = [c["tick_ns"] for c in r["host_calls"] if "tick_ns" in c]
    return float(np.percentile(ticks, q)) / 1e6 if ticks else None


def mfu(r):
    r"""The network's operations for the valid frames completed in the
    traced window (the six stacks once a frame, the heads once more a
    refeed frame, the IMU re-init where it fired;
    :mod:`portbench.work.sigmp`, from the configuration's widths), per
    second of the window, as a share of the card's published peak in the
    served type."""
    calls = r["record"]["calls"]
    if not calls or not r["window_s"]:
        return None
    stacks = r["ctx"].config["stacks"]
    flops = sum(c["frames"] * sigmp.frame_flops(stacks)
                + c["refeeds"] * sigmp.refeed_flops(stacks)
                + c["inits"] * sigmp.init_flops(stacks) for c in calls)
    peak = r["ctx"].peaks[_PEAK[r["ctx"].config["dtype"]]]
    return 100.0 * flops / r["window_s"] / peak


def device_idle(r):
    r"""The share of the traced window in which no kernel, copy or set ran
    on the card (one minus the union of their intervals)."""
    if not r["events"] or not r["hi"] or r["hi"] <= r["lo"]:
        return None
    busy = busy_union(r["events"], r["lo"], r["hi"])
    return 100.0 * (1.0 - busy / (r["hi"] - r["lo"]))


def serve_roofline(r):
    r"""The serve kernel's least possible time for the sequences of the
    traced window (:mod:`portbench.work.serve_scan`) over its device time
    in the trace."""
    t = sum(b - a for n, a, b in r["events"] if SERVE_KERNEL in n)
    if t <= 0:
        return None
    ctx = r["ctx"]
    bound = sum(serve_scan.bound_s(ctx.config, c["frames"], ctx.peaks,
                                   c["refeeds"], c["inits"])[0]
                for c in r["record"]["calls"])
    return 100.0 * bound / (t / 1e9)


def tail_roofline(r):
    r"""The geometry-tail kernel's least possible time for the tail
    evaluations the traced window's steps need (one a valid row, one more
    a refeed row; :mod:`portbench.work.geometry_tail`), over the device
    time of its launches in the trace."""
    times = [b - a for n, a, b in r["events"] if TAIL_KERNEL in n]
    if not times:
        return None
    ctx = r["ctx"]
    blend = ctx.config["body"]["pose_blendshape"]
    bound = sum(geometry_tail.needed_s(c["tail_rows"], blend, ctx.peaks)
                for c in r["record"]["calls"])
    return 100.0 * bound / (sum(times) / 1e9)


def kernels_per_step(r):
    r"""The kernels, copies and sets the card ran in the traced window per
    step of the batched path (a tick of the multiplexer, a frame-step of a
    bucket)."""
    steps = sum(c["steps"] for c in r["record"]["calls"])
    if not r["events"] or not steps:
        return None
    return len(r["events"]) / steps


def seq_overhead_ms(r):
    r"""A sequence's wall time (host clock, from its arrays handed over to
    its poses back in numpy) less its serve kernel's device time, the mean
    over the traced window's sequences: the prescan, the weights'
    preparation, uploads and read-backs around the one launch."""
    serve = [(a, b) for n, a, b in r["events"] if SERVE_KERNEL in n]
    spans = [s for s in r["spans"] if s[0] == "forward_offline"]
    if not serve or not spans:
        return None
    rest = []
    for _, a, b in spans:
        inside = sum(min(e, b) - max(s, a) for s, e in serve
                     if s < b and e > a)
        rest.append((b - a - inside) / 1e6)
    return sum(rest) / len(rest)

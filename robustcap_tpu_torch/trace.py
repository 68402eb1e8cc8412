r"""Spans of the program's own host work, kept in memory while a profile runs.

A span is one interval of the host's time at a layer boundary of the
program (``with trace.span("mux.step"): ...``): its name, its start and end
in ns, the index of the span it opened inside (-1 at a root) and the index
of its root. Spans under one root share the root's index, which serves as
the request's identifier; each thread nests its own spans, so the live
server's threads do not nest into each other.

The times are on the clock of ``torch.profiler``'s device trace, the wall
clock: ``time.perf_counter_ns()`` is read at the boundaries and moved onto
``time.time_ns()`` by one anchor pair taken when this module is imported,
so that each idle gap of the device can be put down to the span the host
was in.

Spans are recorded while a ``torch.profiler`` profile is active, and
between :func:`start` and :func:`stop`. Otherwise a span site costs one
test and returns a shared no-op: no span is made and no clock is read.
They are kept in one list of at most :data:`CAP` spans (later ones are
counted by :func:`dropped`), read by :func:`spans` and emptied by
:func:`clear`; nothing is written anywhere.
"""

from __future__ import annotations

import threading
import time

import torch.autograd.profiler as _profiler

__all__ = ["CAP", "span", "recording", "start", "stop", "spans", "dropped",
           "clear"]

CAP = 1_000_000

_WALL0 = time.time_ns()
_PERF0 = time.perf_counter_ns()
_lock = threading.Lock()
_local = threading.local()
# (name, start, end or None, parent, root) in perf-counter ns; tuples of
# numbers, which the garbage collector stops tracking
_records = []
_forced = False   # between start() and stop()
_dropped = 0
_cleared = 0      # clear() calls: a span open across one is not kept


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "index", "stack", "cleared")

    def __init__(self, name):
        self.name = name
        self.index = -1

    def __enter__(self):
        global _dropped
        start = time.perf_counter_ns()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent, root = stack[-1] if stack else (-1, -1)
        with _lock:
            index = len(_records)
            if index >= CAP:
                _dropped += 1
                return None
            root = index if parent < 0 else root
            _records.append((self.name, start, None, parent, root))
            self.cleared = _cleared
        stack.append((index, root))
        self.index, self.stack = index, stack
        return None

    def __exit__(self, *exc):
        if self.index >= 0:
            end = time.perf_counter_ns()
            self.stack.pop()
            with _lock:
                if self.cleared == _cleared:
                    name, start, _, parent, root = _records[self.index]
                    _records[self.index] = (name, start, end, parent, root)
        return False


def recording() -> bool:
    r"""Whether span sites record now: a ``torch.profiler`` profile is
    active, or :func:`start` was called and :func:`stop` not since."""
    return _forced or _profiler._is_profiler_enabled


def span(name: str):
    r"""A context manager that records the block it encloses as a span
    named ``name`` while :func:`recording`, and does nothing otherwise."""
    if not (_forced or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name)


def start():
    r"""Record spans from now on, with or without a profile."""
    global _forced
    _forced = True


def stop():
    r"""Record spans only while a profile is active again."""
    global _forced
    _forced = False


def spans():
    r"""Every span recorded since :func:`clear`, in the order they opened,
    as ``(name, start_ns, end_ns, parent, root)`` on the device trace's
    clock; ``end_ns`` is ``None`` for a span still open. A span's index in
    this list is what ``parent`` and ``root`` refer to."""
    shift = _WALL0 - _PERF0
    with _lock:
        held = list(_records)
    return [(n, a + shift, None if b is None else b + shift, p, r)
            for n, a, b, p, r in held]


def dropped() -> int:
    r"""Spans not kept since :func:`clear` because :data:`CAP` were."""
    return _dropped


def clear():
    r"""Forget every span recorded and the count of those dropped. A span
    open across it is not kept; call it with no span open, since the
    parent indices of spans opened inside such a span refer to the old
    list."""
    global _dropped, _cleared
    with _lock:
        _records.clear()
        _dropped = 0
        _cleared += 1

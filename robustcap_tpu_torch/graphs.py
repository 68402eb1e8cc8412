r"""CUDA-graph replay of a fixed-shape step, the port's counterpart of
``jax.jit`` for a per-frame program.

PyTorch runs a step eagerly, one launch per operation, and a B=1 step of
the fusion network is hundreds of small launches, so the host bounds it.
A step whose shapes are fixed and which reads nothing back to the host
(``models.sig_mp.make_batched_step``, its exported form in
``serving.py``) can be captured once into a CUDA graph and replayed as one
launch per frame. :class:`GraphedStep` does that for
``step(params, carry, frame) -> (carry, out)``: the frame is copied into
static buffers, the carry lives in static buffers that the graph itself
updates, and the parameters stay where they were at capture.
:class:`GraphedCall` captures a call over static buffers that are all the
caller's (the multiplexer's tick, whose frames and outputs are packed).
"""

from __future__ import annotations

import torch

from . import trace
from .device import tree_map

__all__ = ["GraphedStep", "GraphedCall", "copy_into"]


def _pairs(dst, src):
    r"""``(dst leaf, src leaf)`` of two trees of one structure, matched by
    key, so that the two dicts may list their keys in other orders."""
    if isinstance(dst, dict):
        for k in dst:
            yield from _pairs(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src, strict=True):
            yield from _pairs(d, s)
    else:
        yield dst, src


def copy_into(dst, src):
    r"""Copy every leaf of ``src`` into the same leaf of ``dst``. A source
    leaf that shares memory with a destination buffer (a carry entry that
    a step passes through, or a view of one) is copied out first, so that
    no copy reads a buffer another copy has already written."""
    pairs = list(_pairs(dst, src))
    held = {d.untyped_storage().data_ptr() for d, _ in pairs}
    pairs = [(d, s.clone() if s is not d and s.device == d.device
              and s.untyped_storage().data_ptr() in held else s)
             for d, s in pairs]
    for d, s in pairs:
        if s is not d:
            d.copy_(s)


class GraphedStep:
    r"""``step(params, carry, frame) -> (carry, out)`` with the carry kept
    here (:attr:`carry`, :meth:`set_carry`); a call advances it by one
    frame and returns ``out``.

    On CUDA tensors the first call copies the frame into static buffers,
    runs the step once on a side stream (a warm-up whose result is thrown
    away; the step must not write its inputs), and captures one step into a
    CUDA graph, the carry's update copied into the carry's buffers inside
    the graph; that call and every later one replay the graph, after
    copying the frame (from the host or the card) into its buffers. Every
    call after the first must pass a frame of the same structure, shapes
    and types. A capture that fails raises: nothing falls back to running
    the step eagerly. The outputs are copied out of the graph's buffers, so
    the next replay does not overwrite what a call returned;
    :attr:`replays` counts the replays.

    On CPU tensors every call runs ``step`` directly."""

    def __init__(self, step, params, carry):
        self.step = step
        self.params = params
        first = next(_pairs(carry, carry))[0]
        self.device = first.device
        self._cuda = self.device.type == "cuda"
        self._carry = tree_map(torch.clone, carry) if self._cuda else carry
        self._frame = None
        self._graph = None
        self._out = None
        self.replays = 0

    @property
    def carry(self):
        r"""The carry after the last call (on the card: the static buffers
        the graph reads and writes)."""
        return self._carry

    def set_carry(self, carry):
        r"""Continue from ``carry`` (a tree of the carry's structure)."""
        if self._cuda:
            copy_into(self._carry, carry)
        else:
            self._carry = carry

    def __call__(self, frame):
        if not self._cuda:
            self._carry, out = self.step(self.params, self._carry, frame)
            return out
        captured = self._graph is None
        if captured:
            with trace.span("graph.capture"):
                self._capture(frame)
        with trace.span("graph.replay"):
            if not captured:
                copy_into(self._frame, frame)
            self._graph.replay()
            self.replays += 1
            return tree_map(torch.clone, self._out)

    def _capture(self, frame):
        self._frame = tree_map(lambda t: t.to(self.device, copy=True), frame)
        self._graph, (_, self._out) = _capture_graph(
            lambda: self.step(self.params, self._carry, self._frame),
            lambda result: copy_into(self._carry, result[0]), self.device)


def _capture_graph(run, commit, device):
    r"""A CUDA graph of ``commit(run())``: ``run()`` once on a side stream
    first (a warm-up whose result is thrown away, so ``run`` must not write
    what it reads), then captured together with ``commit``, which writes
    the result into static buffers. Returns ``(graph, result)``, the result
    in the graph's own memory."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        run()
    current.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        result = run()
        commit(result)
    return graph, result


class GraphedCall:
    r"""``commit(run())`` over static buffers (``run`` reads them and
    ``commit`` writes its result into them). On the card it is captured
    when this is made and each call replays the graph
    (:attr:`replays` counts them); on the CPU each call runs it directly."""

    def __init__(self, run, commit, device):
        self.replays = 0
        self._run, self._commit = run, commit
        self._graph = None
        if device.type == "cuda":
            with trace.span("graph.capture"):
                self._graph, _ = _capture_graph(run, commit, device)

    def __call__(self):
        if self._graph is None:
            self._commit(self._run())
            return
        with trace.span("graph.replay"):
            self._graph.replay()
            self.replays += 1

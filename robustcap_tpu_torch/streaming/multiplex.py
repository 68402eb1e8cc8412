r"""Batched live-stream multiplexer: N concurrent capture sessions, one
batched step per tick.

Port of ``robustcap_tpu/streaming/multiplex.py``. The reference serves one
subject per process; stepping N streams batched costs little more than one,
since a step's cost is its weight reads and its launches. The multiplexer
keeps up to ``capacity`` independent sessions in the rows of one carry and
advances all of them with one step of ``sig_mp.make_batched_step`` per
tick, with per-slot reset, so that a subject joins without disturbing the
others.

A tick moves its frames in one copy and its results in one: ``step``
writes the caller's arrays into one host staging buffer (pinned on the
card), which is copied to a device buffer whose blocks the step reads as
its frame fields, and the step writes pose and translation into one device
buffer, copied back once. ``reset_slot`` only marks its row; a tick on
which some row was reset or starts a session runs the opening tick, which
puts the fresh state into the reset rows, runs the batched prescan masked
to the first-frame rows, and then the steady step. On the card the steady
and the opening tick are each a CUDA graph (``graphs.GraphedCall``),
captured when the multiplexer is made, so a tick is one upload, one replay
and one read-back; on the CPU they run directly.

The JAX multiplexer vmaps ``make_step(fuse_spec_heads=True,
cond_updater=False)``; the port's branchless batched step computes the same
values in another order. With ``cfg.pallas_tail`` each tail of the tick is
one launch of the tail kernel over the ``capacity`` rows (the operator
``robustcap::geometry_tail``; two a tick with the vision updater), in the
eager and in the graphed tick, as the JAX multiplexer runs its tail kernel
under ``vmap``. The tick runs no other kernel, so a ``cfg`` with
``pallas_inertial`` or ``pallas_serve`` raises rather than being ignored.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import trace
from ..config import SigMPConfig
from ..device import resolve_device
from ..graphs import GraphedCall, copy_into
from ..models import sig_mp
from ..nn.rnn import prepare_scan_params

__all__ = ["StreamingMultiplexer"]

# a tick's inputs and outputs, each field a [capacity, *shape] float32
# block of one flat buffer; the two flags are 0 or 1
_INPUTS = (("j2dc", (33, 3)), ("accc", (6, 3)), ("oric", (6, 3, 3)),
           ("gravityc", (3,)), ("first_frame", ()), ("reset", ()))
_OUTPUTS = (("pose", (24, 3, 3)), ("tran", (3,)))
_ALIGN = 128   # floats: every block starts on 512 bytes, as a tensor does


def _layout(fields, n):
    r"""``({name: (offset, [n, *shape])}, length)`` of the fields' blocks
    laid end to end in one flat buffer, each starting on ``_ALIGN``."""
    blocks, end = {}, 0
    for name, shape in fields:
        blocks[name] = (end, (n,) + shape)
        end += -(-n * math.prod(shape) // _ALIGN) * _ALIGN
    return blocks, end


def _views(buf, blocks):
    r"""The blocks of a flat tensor or array as views ``[n, *shape]``."""
    return {k: buf[o:o + math.prod(s)].reshape(s)
            for k, (o, s) in blocks.items()}


def _reset_rows(carry, fresh, rows):
    r"""``carry`` with ``fresh`` (an unbatched carry) in the rows where
    ``rows [N]`` holds: the states ``[L, N, H]``, every other field
    ``[N, ...]``."""
    def pick(old, new, axis):
        cond = rows.reshape(rows.shape + (1,) * (old.dim() - axis - 1))
        return torch.where(cond, new.unsqueeze(axis), old)

    return {k: {n: tuple(pick(o, f, 1) for o, f in zip(hc, fresh[k][n]))
                for n, hc in v.items()} if k == "states"
            else pick(v, fresh[k], 0)
            for k, v in carry.items()}


class StreamingMultiplexer:
    r"""Fixed-capacity batch of independent streaming sessions."""

    def __init__(self, params, body_model, cfg: Optional[SigMPConfig] = None,
                 capacity: int = 8, device="cuda"):
        self.cfg = cfg or SigMPConfig.live_mode()
        if self.cfg.pallas_inertial or self.cfg.pallas_serve:
            raise ValueError("StreamingMultiplexer: the batched tick runs no "
                             "LSTM-scan or serve kernel; pass a cfg with "
                             "pallas_inertial and pallas_serve off")
        self.device = dev = resolve_device(device)
        sig_mp._require_device(params, body_model, dev)
        self.params = params
        self.body_model = body_model
        self.capacity = N = capacity
        self.active = np.zeros(N, bool)
        self._scan_params = prepare_scan_params(params,
                                                self.cfg.int8_compute)
        self._fresh = sig_mp.init_carry(params)
        self._carry = sig_mp.init_carry(params, batch_shape=(N,))
        self._batched_step = sig_mp.make_batched_step(body_model, self.cfg)
        self._pending = np.zeros(N, bool)   # rows reset since the last tick
        cuda = dev.type == "cuda"

        def buffers(fields):
            blocks, n = _layout(fields, N)
            host = torch.zeros(n, pin_memory=cuda)
            on_dev = host.to(dev) if cuda else host
            return host, on_dev, _views(host.numpy(), blocks), _views(
                on_dev, blocks)

        self._in_host, self._in_dev, self._in, in_dev = buffers(_INPUTS)
        self._out_host, self._out_dev, self._out, out_dev = buffers(_OUTPUTS)
        self._done = torch.cuda.Event() if cuda else None
        # the frame the step reads: views of the uploaded blocks, and no
        # first translation; a steady tick has no first frame
        no = torch.zeros(N, dtype=torch.bool, device=dev)
        steady_frame = dict(first_tran=torch.zeros(N, 3, device=dev),
                            first_tran_valid=no, first_frame=no,
                            **{k: in_dev[k] for k in ("j2dc", "accc", "oric",
                                                      "gravityc")})

        def steady():
            return self._batched_step(self._scan_params, self._carry,
                                      steady_frame)

        def opening():
            f = dict(steady_frame, first_frame=in_dev["first_frame"] > 0.5)
            carry = _reset_rows(self._carry, self._fresh,
                                in_dev["reset"] > 0.5)
            carry = sig_mp.prescan_first_frame(
                self._scan_params, body_model, carry, f,
                self.cfg.int8_compute)
            return self._batched_step(self._scan_params, carry, f)

        def commit(result):
            carry, (pose, tran) = result
            copy_into(self._carry, carry)
            out_dev["pose"].copy_(pose)
            out_dev["tran"].copy_(tran)

        # a frame the warm-ups of the captures can run on
        self._in["oric"][:] = np.eye(3, dtype=np.float32)
        self._in["gravityc"][:] = sig_mp.DEFAULT_GRAVITY
        if cuda:
            self._in_dev.copy_(self._in_host)
        self._steady = GraphedCall(steady, commit, dev)
        self._opening = GraphedCall(opening, commit, dev)

    @property
    def carries(self):
        r"""The sessions' carry, every field with a leading ``capacity``
        (states ``[L, capacity, H]``); rows reset since the last tick read
        fresh."""
        if self._pending.any():
            rows = torch.from_numpy(self._pending).to(self.device)
            copy_into(self._carry,
                      _reset_rows(self._carry, self._fresh, rows))
            self._pending[:] = False
        return self._carry

    # -- session management --------------------------------------------------

    def open_slot(self) -> int:
        r"""Claim a free slot for a new subject (state reset)."""
        free = np.where(~self.active)[0]
        if len(free) == 0:
            raise RuntimeError("multiplexer full")
        slot = int(free[0])
        self.reset_slot(slot)
        self.active[slot] = True
        return slot

    def close_slot(self, slot: int):
        self.active[slot] = False

    def reset_slot(self, slot: int):
        r"""Give ``slot`` a fresh state, from the next tick (or the next
        read of :attr:`carries`) on."""
        with trace.span("mux.reset"):
            self._pending[slot] = True

    # -- the tick -------------------------------------------------------------

    def step(self, j2dc: np.ndarray, accc: np.ndarray, oric: np.ndarray,
             first_frame: Optional[np.ndarray] = None,
             gravityc: Optional[np.ndarray] = None):
        r"""Advance every slot one frame.

        j2dc [N, 33, 3], accc [N, 6, 3], oric [N, 6, 3, 3] (rows of inactive
        slots can hold anything). Returns numpy (pose [N, 24, 3, 3],
        tran [N, 3]), arrays of their own."""
        ins, cuda = self._in, self._done is not None
        with trace.span("mux.step"):
            with trace.span("mux.inputs"):
                for k, x in (("j2dc", j2dc), ("accc", accc), ("oric", oric)):
                    ins[k][:] = np.reshape(x, ins[k].shape)
                ins["gravityc"][:] = (
                    sig_mp.DEFAULT_GRAVITY if gravityc is None
                    else np.reshape(gravityc, ins["gravityc"].shape))
                ins["first_frame"][:] = (0 if first_frame is None
                                         else np.asarray(first_frame, bool))
                ins["reset"][:] = self._pending
                opening = bool(ins["first_frame"].any() or self._pending.any())
                self._pending[:] = False
                if cuda:
                    self._in_dev.copy_(self._in_host, non_blocking=True)
            if opening:
                with trace.span("mux.prescan"):
                    self._opening()
            else:
                self._steady()
            with trace.span("mux.readback"):
                if cuda:
                    self._out_host.copy_(self._out_dev, non_blocking=True)
                    self._done.record(torch.cuda.current_stream(self.device))
                    self._done.synchronize()
                return self._out["pose"].copy(), self._out["tran"].copy()

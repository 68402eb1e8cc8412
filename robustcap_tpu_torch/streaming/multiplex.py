r"""Batched live-stream multiplexer: N concurrent capture sessions, one
batched step per tick.

Port of ``robustcap_tpu/streaming/multiplex.py``. The reference serves one
subject per process; stepping N streams batched costs little more than one,
since a step's cost is its weight reads and its launches. The multiplexer
keeps up to ``capacity`` independent sessions in the rows of one carry and
advances all of them with one step of ``sig_mp.make_batched_step`` per
tick, with per-slot reset, so that a subject joins without disturbing the
others. On the card the steady tick replays as a CUDA graph
(``graphs.GraphedStep``); a tick on which some slot starts a session first
runs the batched prescan, masked per row.

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

from typing import Optional

import numpy as np
import torch

from .. import trace
from ..config import SigMPConfig
from ..device import resolve_device
from ..graphs import GraphedStep
from ..models import sig_mp
from ..nn.rnn import prepare_scan_params

__all__ = ["StreamingMultiplexer"]


class StreamingMultiplexer:
    r"""Fixed-capacity batch of independent streaming sessions."""

    def __init__(self, params, body_model, cfg: Optional[SigMPConfig] = None,
                 capacity: int = 8, device="cuda"):
        self.cfg = cfg or SigMPConfig.live_mode()
        if self.cfg.pallas_inertial or self.cfg.pallas_serve:
            raise ValueError("StreamingMultiplexer: the batched tick runs no "
                             "LSTM-scan or serve kernel; pass a cfg with "
                             "pallas_inertial and pallas_serve off")
        self.device = resolve_device(device)
        sig_mp._require_device(params, body_model, self.device)
        self.params = params
        self.body_model = body_model
        self.capacity = capacity
        self._scan_params = prepare_scan_params(params,
                                                self.cfg.int8_compute)
        self._fresh = sig_mp.init_carry(params)
        self._tick = GraphedStep(
            sig_mp.make_batched_step(body_model, self.cfg),
            self._scan_params,
            sig_mp.init_carry(params, batch_shape=(capacity,)))
        self.active = np.zeros(capacity, bool)

    @property
    def carries(self):
        r"""The sessions' carry, every field with a leading ``capacity``
        (states ``[L, capacity, H]``)."""
        return self._tick.carry

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
        def fresh(x, f, axis):
            x = x.clone()
            x.select(axis, slot).copy_(f)
            return x

        with trace.span("mux.reset"):
            self._tick.set_carry({
                k: {n: tuple(fresh(x, f, 1) for x, f in
                             zip(hc, self._fresh["states"][n]))
                    for n, hc in v.items()} if k == "states"
                else fresh(v, self._fresh[k], 0)
                for k, v in self._tick.carry.items()})

    # -- the tick -------------------------------------------------------------

    def step(self, j2dc: np.ndarray, accc: np.ndarray, oric: np.ndarray,
             first_frame: Optional[np.ndarray] = None,
             gravityc: Optional[np.ndarray] = None):
        r"""Advance every slot one frame.

        j2dc [N, 33, 3], accc [N, 6, 3], oric [N, 6, 3, 3] (rows of inactive
        slots can hold anything). Returns numpy (pose [N, 24, 3, 3],
        tran [N, 3])."""
        N = self.capacity

        def f32(x, *shape):
            return torch.tensor(np.asarray(x, np.float32)).reshape(N, *shape)

        with trace.span("mux.step"):
            with trace.span("mux.inputs"):
                frames = {
                    "j2dc": f32(j2dc, 33, 3),
                    "accc": f32(accc, 6, 3),
                    "oric": f32(oric, 6, 3, 3),
                    "first_tran": torch.zeros(N, 3),
                    "gravityc": f32(
                        np.broadcast_to(sig_mp.DEFAULT_GRAVITY, (N, 3))
                        if gravityc is None else gravityc, 3),
                    "first_frame": torch.as_tensor(
                        np.zeros(N, bool) if first_frame is None
                        else np.asarray(first_frame, bool)),
                    "first_tran_valid": torch.zeros(N, dtype=torch.bool),
                }
            if first_frame is not None and np.any(first_frame):
                with trace.span("mux.prescan"):
                    frames = {k: v.to(self.device) for k, v in frames.items()}
                    self._tick.set_carry(sig_mp.prescan_first_frame(
                        self._scan_params, self.body_model, self._tick.carry,
                        frames, self.cfg.int8_compute))
            pose, tran = self._tick(frames)
            with trace.span("mux.readback"):
                return pose.cpu().numpy(), tran.cpu().numpy()

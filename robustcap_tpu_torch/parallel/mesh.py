r"""The data mesh and the data-parallel train step (port of
``robustcap_tpu/parallel/mesh.py``).

The model (~61M parameters) is far smaller than a card, so the port scales
along one axis, ``data``: every rank holds the whole parameter tree, takes
its rows of each batch, and the gradients are summed across ranks. A
:class:`Mesh` is a small record of the process group, this rank, the number
of ranks and this rank's device. Its collectives are built from
``all_reduce`` (sum) and ``broadcast`` alone, the two that gloo offers on
CUDA tensors as well as on the CPU, so one code path serves NCCL, gloo on
the CPU and gloo on the card. Without a process group the mesh has one rank
and its collectives are identities; a group of one rank still runs them
(NCCL's all-reduce at one rank is a copy on the card).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device, tree_map
from .distributed import process_local_batch

__all__ = ["Mesh", "make_mesh", "replicate", "shard_batch",
           "make_dp_train_step"]


@dataclass(frozen=True)
class Mesh:
    r"""A 1-D data mesh: ``group`` (None for one rank), this ``rank``, the
    number of ranks ``size``, this rank's ``device`` and the axis name."""
    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    axis_name: str = "data"

    def rows(self, n: int) -> slice:
        r"""This rank's contiguous rows of ``n`` (which the size divides)."""
        return process_local_batch(n, self.rank, self.size)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        r"""Sum ``t`` (on ``device``) over the ranks, in place."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        r"""Rank ``src``'s ``t`` (on ``device``) on every rank, in place."""
        if self.group is not None:
            dist.broadcast(t, src, group=self.group)
        return t

    def barrier(self):
        r"""Wait, on the host, until every rank gets here: an
        ``all_reduce`` of one zero, read back. NCCL only queues the
        collective on the card's stream; the read is what waits for it."""
        self.all_reduce_(torch.zeros(1, device=self.device)).item()

    def gather(self, local, axis: int = 0) -> torch.Tensor:
        r"""Every rank's ``local`` (equal shapes) joined rank-major along
        ``axis``, on every rank: each rank writes its part into a zero
        buffer and the buffers are summed."""
        x = torch.as_tensor(local).to(self.device)
        if self.size == 1:
            return x
        kind = x.dtype
        if kind == torch.bool:      # neither gloo nor NCCL sums booleans
            x = x.to(torch.uint8)
        shape = list(x.shape)
        n = shape[axis]
        shape[axis] = n * self.size
        out = torch.zeros(shape, dtype=x.dtype, device=self.device)
        out.narrow(axis, self.rank * n, n).copy_(x)
        return self.all_reduce_(out).to(kind)


def make_mesh(device="cuda", axis_name: str = "data") -> Mesh:
    r"""The mesh of this job on ``device``: every rank of the default
    process group (:func:`~.distributed.initialize_distributed`), or one
    rank when there is none. A process owns one card (``torchrun``'s
    layout), where the JAX package's single-process mesh spans a host's
    devices. ``device`` defaults to the card and raises without one."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(None, 0, 1, dev, axis_name)
    if dist.get_backend() == "nccl" and dev.type != "cuda":
        raise ValueError("the process group runs NCCL, whose tensors live "
                         "on the card; pass device='cuda'")
    return Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(),
                dev, axis_name)


def replicate(tree, mesh: Mesh):
    r"""Every tensor of ``tree`` as a copy on ``mesh.device`` holding rank
    0's values."""
    def put(x):
        return mesh.broadcast_(torch.as_tensor(x).to(mesh.device,
                                                     copy=True))
    return tree_map(put, tree)


def _local_rows(x, mesh: Mesh, axis: int):
    x = torch.as_tensor(x)
    rows = mesh.rows(x.shape[axis])
    return x.narrow(axis, rows.start, rows.stop - rows.start).contiguous() \
        .to(mesh.device, non_blocking=True)


def shard_batch(tree, mesh: Mesh, axis: int = 0):
    r"""This rank's rows of every tensor of ``tree`` along ``axis``
    (:func:`~.distributed.process_local_batch`), on ``mesh.device``."""
    return tree_map(lambda x: _local_rows(x, mesh, axis), tree)


def all_reduce_grads(leaves, mesh: Mesh):
    r"""Sum the gradients of ``leaves`` over the ranks, as one flat
    buffer (one collective a step)."""
    grads = [p.grad for p in leaves if p.grad is not None]
    if mesh.group is None or not grads:
        return
    flat = mesh.all_reduce_(torch.cat([g.reshape(-1) for g in grads]))
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def make_dp_train_step(forward_fn: Callable, loss_fn: Callable,
                       optimizer: torch.optim.Optimizer, mesh: Mesh,
                       batch_axis: int = 1, clip_grad_norm: float = 0.0):
    r"""The data-parallel train step: parameters replicated, rows sharded.

    ``step(params, xs, ys, lengths, init, generator=None) -> loss`` takes
    the **global** batch (host arrays or tensors; ``xs`` and ``ys`` carry
    the batch on ``batch_axis``, ``init`` on axis 0) and ``params``, the
    tree whose tensors ``optimizer`` holds. Each rank runs its rows: the
    forward is ``forward_fn(params, xs, lengths, init, generator)`` and the
    loss ``loss_fn(ys, labels, lengths, count_lengths=global_lengths)``,
    whose denominators count the global batch's valid frames, so the ranks'
    losses sum to the loss of the whole batch and their gradients, summed
    by one ``all_reduce``, to its gradient. Then the clip by global norm
    (``clip_grad_norm > 0``) and the optimizer's step run alike on every
    rank, which keeps the parameters replicated. Returns the global loss,
    detached. A mesh of one rank (``Mesh(None, 0, 1, device)``) makes it
    the single-device step."""
    from ..train.loop import _clip_by_global_norm
    leaves = [p for group in optimizer.param_groups for p in group["params"]]

    def step(params, xs, ys, lengths, init, generator=None):
        lengths = torch.as_tensor(np.asarray(lengths))
        local = lengths[mesh.rows(len(lengths))]
        out = forward_fn(params, _local_rows(xs, mesh, batch_axis), local,
                         None if init is None
                         else _local_rows(init, mesh, 0), generator)
        loss = loss_fn(out, _local_rows(ys, mesh, batch_axis), local,
                       count_lengths=lengths)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_grads(leaves, mesh)
        if clip_grad_norm > 0:
            _clip_by_global_norm(leaves, clip_grad_norm)
        optimizer.step()
        return mesh.all_reduce_(loss.detach().clone())

    return step

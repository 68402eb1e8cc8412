r"""Multi-process wiring on ``torch.distributed`` (port of
``robustcap_tpu/parallel/distributed.py``).

One process owns one card, as ``torchrun`` lays a job out, so a job of N
processes is a data mesh of N ranks:

* :func:`initialize_distributed` sets up the default process group when a
  coordinator is configured (arguments, ``ROBUSTCAP_*`` or ``torchrun``'s
  variables) and is a no-op otherwise, so local runs and tests never touch
  the distributed runtime. The backend follows the device: NCCL on the card,
  gloo on the CPU (``backend="gloo"`` asks for gloo on the card). Nothing
  falls back: a failed initialization raises.
* :func:`make_global_mesh` is the mesh over every rank.
* :func:`dataset_shard_indices` and :func:`process_local_batch` are the
  JAX package's numbers: a strided partition of dataset items and each
  rank's contiguous rows of a global batch.
* :func:`global_batch_from_local` stitches each rank's rows into the global
  batch on every rank.
"""

from __future__ import annotations

import os
import socket
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["DistContext", "initialize_distributed", "make_global_mesh",
           "dataset_shard_indices", "process_local_batch",
           "global_batch_from_local"]


@dataclass(frozen=True)
class DistContext:
    r"""What this process knows about the job. A process owns one card, so
    ``local_device_count`` is 1 and ``global_device_count`` the world
    size."""
    enabled: bool
    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int


def _rank_and_size():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _context() -> DistContext:
    rank, size = _rank_and_size()
    return DistContext(enabled=dist.is_initialized(),
                       process_index=rank, process_count=size,
                       local_device_count=1, global_device_count=size)


def _env_int(*names):
    for name in names:
        if os.environ.get(name) is not None:
            return int(os.environ[name])
    return None


def _init_method(coordinator_address):
    r"""The rendezvous of the group: the given or ``ROBUSTCAP_COORDINATOR``
    address over TCP, else ``torchrun``'s (``env://``, which also finds
    the store ``torchrun``'s agent already holds), else None."""
    address = (coordinator_address
               or os.environ.get("ROBUSTCAP_COORDINATOR"))
    if address:
        return f"tcp://{address}"
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return "env://"
    return None


def _check_one_rank_per_card(dev):
    r"""NCCL runs one rank per card: gather each rank's card over a gloo
    group and raise if two ranks hold the same one (NCCL itself would fail
    its first collective with "Duplicate GPU detected")."""
    props = torch.cuda.get_device_properties(dev)
    key = f"{socket.gethostname()}/{getattr(props, 'uuid', dev.index)}"
    group = dist.new_group(backend="gloo")
    slots = torch.zeros(dist.get_world_size(), dtype=torch.int64)
    slots[dist.get_rank()] = zlib.crc32(key.encode())
    dist.all_reduce(slots, group=group)
    dist.destroy_process_group(group)
    if len(set(slots.tolist())) < len(slots):
        raise RuntimeError(
            "NCCL needs one card per rank, and two ranks of this job share "
            f"a card (this rank: {key}); launch one process per card, or "
            "pass backend='gloo' to share a card")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda",
                           backend: Optional[str] = None) -> DistContext:
    r"""Set up the default process group when a coordinator is configured.

    Settings resolve in this order: the arguments; ``ROBUSTCAP_COORDINATOR``
    (``host:port``), ``ROBUSTCAP_NUM_PROCESSES``, ``ROBUSTCAP_PROCESS_ID``;
    ``torchrun``'s ``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK``. With no coordinator the call is a no-op and the job runs as
    one process. Idempotent. The backend is NCCL for a ``cuda`` device and
    gloo for ``cpu``; ``backend`` overrides it (gloo on the card). On the
    card this process takes ``device``'s index, else ``LOCAL_RANK``'s card,
    else card ``process_id % device_count``. Raises where the device is
    missing or the group does not come up; nothing falls back."""
    if dist.is_initialized():
        return _context()
    init_method = _init_method(coordinator_address)
    if init_method is None:
        return _context()
    if num_processes is None:
        num_processes = _env_int("ROBUSTCAP_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("ROBUSTCAP_PROCESS_ID", "RANK")
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator {init_method} is set but the world size "
            "or this process's rank is not: pass num_processes and "
            "process_id, or set ROBUSTCAP_NUM_PROCESSES/ROBUSTCAP_PROCESS_ID "
            "(WORLD_SIZE/RANK)")
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        index = dev.index
        if index is None:
            local = _env_int("LOCAL_RANK")
            index = (local if local is not None
                     else process_id % torch.cuda.device_count())
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("NCCL needs device='cuda'; the CPU runs gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    if backend == "nccl" and num_processes > 1:
        _check_one_rank_per_card(dev)
    return _context()


def make_global_mesh(axis_name: str = "data", device="cuda"):
    r"""The data mesh over every rank of the job: the same as
    :func:`~.mesh.make_mesh`, whose group is the whole job."""
    from .mesh import make_mesh
    return make_mesh(device, axis_name)


def dataset_shard_indices(n_items: int, process_index: Optional[int] = None,
                          process_count: Optional[int] = None) -> np.ndarray:
    r"""Rank p's dataset items: p, p + P, p + 2P, ... (strided, so the
    sequence lengths stay balanced across ranks)."""
    rank, size = _rank_and_size()
    process_index = rank if process_index is None else process_index
    process_count = size if process_count is None else process_count
    return np.arange(process_index, n_items, process_count)


def process_local_batch(global_batch_size: int,
                        process_index: Optional[int] = None,
                        process_count: Optional[int] = None) -> slice:
    r"""This rank's contiguous rows of a ``[global_batch, ...]`` array (the
    global batch is laid out rank-major)."""
    rank, size = _rank_and_size()
    process_index = rank if process_index is None else process_index
    process_count = size if process_count is None else process_count
    assert global_batch_size % process_count == 0, (
        f"global batch {global_batch_size} must divide process count "
        f"{process_count}")
    per = global_batch_size // process_count
    return slice(process_index * per, (process_index + 1) * per)


def global_batch_from_local(local_tree, mesh, axis: int = 0):
    r"""The global batch on every rank from each rank's rows.

    Each leaf of ``local_tree`` holds this rank's rows along ``axis``
    (shape ``[global / P, ...]`` there); the result is the whole
    rank-major batch on ``mesh.device``. One rank returns its input (on the
    device). Built from one ``all_reduce`` a leaf: each rank writes its rows
    into a zero buffer and the buffers are summed, which gloo offers on CPU
    and CUDA tensors and NCCL on the card."""
    from ..device import tree_map
    return tree_map(lambda x: mesh.gather(x, axis), local_tree)

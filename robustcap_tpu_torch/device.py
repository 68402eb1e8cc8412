r"""Device selection for the port's entry points, and moving parameter
trees (nested dicts, lists and tuples of tensors) between devices."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "tree_map"]


def resolve_device(device="cuda") -> torch.device:
    r"""``device`` as a ``torch.device``; raises when a CUDA device is asked
    for on a host that has none (the entry points never fall back to the
    CPU on their own: pass ``device="cpu"`` for that)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False on this host; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


def tree_map(fn, tree, is_leaf=None):
    r"""Apply ``fn`` to every leaf of a tree of dicts, lists and tuples;
    a node for which ``is_leaf`` is true counts as one leaf."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)

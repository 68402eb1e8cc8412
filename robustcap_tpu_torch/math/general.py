r"""General tensor helpers (port of ``robustcap_tpu/math/general.py``)."""

from __future__ import annotations

import torch

__all__ = ["lerp", "normalize_tensor", "append_value", "append_zero",
           "append_one", "vector_cross_matrix"]


def lerp(a, b, t):
    r"""Unclamped linear interpolation: ``a`` at ``t=0``, ``b`` at ``t=1``."""
    return a * (1 - t) + b * t


def normalize_tensor(x: torch.Tensor, dim: int = -1, return_norm: bool = False,
                     eps: float = 0.0):
    r"""Normalize ``x`` along ``dim`` to unit norm; with ``eps > 0`` the
    division is guarded by ``max(norm, eps)``."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    normalized = x / norm.clamp_min(eps) if eps > 0 else x / norm
    return (normalized, norm) if return_norm else normalized


def append_value(x: torch.Tensor, value: float, dim: int = -1) -> torch.Tensor:
    r"""Append a constant slab of ``value`` along ``dim`` (its size grows by
    one)."""
    dim = dim % x.dim()
    shape = list(x.shape)
    shape[dim] = 1
    return torch.cat((x, x.new_full(shape, value)), dim=dim)


def append_zero(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return append_value(x, 0.0, dim)


def append_one(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return append_value(x, 1.0, dim)


def vector_cross_matrix(x: torch.Tensor) -> torch.Tensor:
    r"""Skew-symmetric matrix ``[v]_x`` for each 3-vector -> [N, 3, 3]."""
    x = x.reshape(-1, 3)
    zeros = torch.zeros_like(x[:, 0])
    m = torch.stack((zeros, -x[:, 2], x[:, 1],
                     x[:, 2], zeros, -x[:, 0],
                     -x[:, 1], x[:, 0], zeros), dim=1)
    return m.reshape(-1, 3, 3)

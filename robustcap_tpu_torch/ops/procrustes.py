r"""Procrustes alignment and PA-MPJPE (port of
``robustcap_tpu/ops/procrustes.py``): one batched SVD over every frame of a
sequence, with the determinant's sign fixed."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["similarity_transform", "reconstruction_error",
           "reconstruction_error_np"]


def _reduce(re, reduction):
    if reduction == "mean":
        return re.mean()
    if reduction == "sum":
        return re.sum()
    return re


def similarity_transform(S1: torch.Tensor, S2: torch.Tensor) -> torch.Tensor:
    r"""Each ``S1[i]`` (N points x 3) aligned to ``S2[i]`` by the best
    similarity transform (scale, rotation, translation)."""
    mu1 = S1.mean(1, keepdim=True)
    mu2 = S2.mean(1, keepdim=True)
    X1, X2 = S1 - mu1, S2 - mu2
    var1 = (X1 ** 2).sum((1, 2))
    K = X1.transpose(1, 2) @ X2                               # [B, 3, 3]
    U, _, Vh = torch.linalg.svd(K)
    V = Vh.transpose(1, 2)
    Z = torch.eye(3, dtype=S1.dtype, device=S1.device).repeat(K.shape[0], 1, 1)
    Z[:, -1, -1] = torch.sign(torch.linalg.det(U @ Vh))
    R = V @ Z @ U.transpose(1, 2)
    scale = (R * K.transpose(1, 2)).sum((1, 2)) / var1
    t = mu2 - scale[:, None, None] * (mu1 @ R.transpose(1, 2))
    return scale[:, None, None] * (S1 @ R.transpose(1, 2)) + t


def reconstruction_error(S1: torch.Tensor, S2: torch.Tensor,
                         reduction: str = "mean"):
    r"""PA-MPJPE: Procrustes-align, then the mean joint distance."""
    S1_hat = similarity_transform(S1, S2)
    return _reduce(torch.sqrt(((S1_hat - S2) ** 2).sum(-1)).mean(-1),
                   reduction)


def reconstruction_error_np(S1, S2, reduction: str = "mean"):
    r"""PA-MPJPE in float64 on the host, batched over frames. A float32 SVD
    carries ~1 mm of noise, which matters against PA-MPJPE values of a few
    centimetres, so the final metrics take this path."""
    S1 = np.asarray(S1, np.float64)
    S2 = np.asarray(S2, np.float64)
    mu1 = S1.mean(axis=1, keepdims=True)
    mu2 = S2.mean(axis=1, keepdims=True)
    X1, X2 = S1 - mu1, S2 - mu2
    var1 = np.sum(X1 ** 2, axis=(1, 2))
    K = np.swapaxes(X1, 1, 2) @ X2
    U, _, Vh = np.linalg.svd(K)
    V = np.swapaxes(Vh, 1, 2)
    Z = np.broadcast_to(np.eye(3), K.shape).copy()
    Z[:, -1, -1] = np.sign(np.linalg.det(U @ Vh))
    R = V @ Z @ np.swapaxes(U, 1, 2)
    scale = np.einsum("bij,bij->b", R, np.swapaxes(K, 1, 2)) / var1
    t = mu2 - scale[:, None, None] * (mu1 @ np.swapaxes(R, 1, 2))
    S1_hat = scale[:, None, None] * (S1 @ np.swapaxes(R, 1, 2)) + t
    return _reduce(np.sqrt(((S1_hat - S2) ** 2).sum(axis=-1)).mean(axis=-1),
                   reduction)

r"""Pose priors for SMPLify fitting (port of ``robustcap_tpu/smplify/prior.py``):
a max-mixture GMM negative log-likelihood over the 69-D body pose, an
elbow/knee hyperextension prior and an L2 prior. The mixture is read from
the reference's ``gmm_08.pkl`` in ``prior_folder`` (by default
``config.paths.work_dir``) when present, else a deterministic synthetic
mixture stands in; either is reduced on the host in numpy exactly as the JAX
package reduces it, then moved to ``device`` as float32 (or ``dtype``)."""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch

from ..config import paths
from ..device import resolve_device

__all__ = ["MaxMixturePrior", "angle_prior", "l2_prior"]


def _load_gmm(prior_file: str):
    with open(prior_file, "rb") as f:
        gmm = pickle.load(f, encoding="latin1")
    if isinstance(gmm, dict):
        return (np.asarray(gmm["means"], np.float32),
                np.asarray(gmm["covars"], np.float32),
                np.asarray(gmm["weights"], np.float32))
    return (np.asarray(gmm.means_, np.float32),
            np.asarray(gmm.covars_, np.float32),
            np.asarray(gmm.weights_, np.float32))


def _synthetic_gmm(num_gaussians: int = 8, dim: int = 69, seed: int = 0):
    r"""Deterministic stand-in mixture: small-variance components near the
    rest pose with mild correlations."""
    rng = np.random.RandomState(seed)
    means = rng.normal(0, 0.2, (num_gaussians, dim)).astype(np.float32)
    covs = []
    for _ in range(num_gaussians):
        a = rng.normal(0, 0.05, (dim, dim)).astype(np.float32)
        covs.append(a @ a.T + 0.2 * np.eye(dim, dtype=np.float32))
    weights = rng.dirichlet(np.ones(num_gaussians)).astype(np.float32)
    return means, np.stack(covs), weights


class MaxMixturePrior:
    r"""Min-over-components GMM NLL (the reference's merged likelihood).

    nll(pose) = min_k [ 0.5 (pose-mu_k)' P_k (pose-mu_k) - log w'_k ]
    with w'_k = w_k / ((2 pi)^(D/2) * sqrtdet_k / min_j sqrtdet_j).
    """

    def __init__(self, prior_folder: Optional[str] = None,
                 num_gaussians: int = 8, epsilon: float = 1e-16,
                 device="cuda", dtype=torch.float32):
        dev = resolve_device(device)
        path = os.path.join(prior_folder or paths.work_dir,
                            "gmm_{:02d}.pkl".format(num_gaussians))
        if os.path.exists(path):
            means, covs, weights = _load_gmm(path)
        else:
            means, covs, weights = _synthetic_gmm(num_gaussians)
        precisions = np.stack([np.linalg.inv(c) for c in covs]
                              ).astype(np.float32)
        sqrdets = np.array([np.sqrt(np.linalg.det(c.astype(np.float64)))
                            for c in covs])
        const = (2 * np.pi) ** (means.shape[1] / 2.0)
        nll_weights = (weights / (const * (sqrdets / sqrdets.min()))
                       ).astype(np.float32)
        self.device = dev
        self.means = torch.as_tensor(means, dtype=dtype, device=dev)
        self.precisions = torch.as_tensor(precisions, dtype=dtype, device=dev)
        self.nll_weights = torch.as_tensor(nll_weights, dtype=dtype,
                                           device=dev)
        self._log_weights = torch.log(self.nll_weights)

    def __call__(self, pose: torch.Tensor, betas=None) -> torch.Tensor:
        r"""pose [..., 69] -> per-sample NLL [...]."""
        diff = pose[..., None, :] - self.means                 # [..., K, D]
        quad = torch.einsum("...kd,kde,...ke->...k", diff, self.precisions,
                            diff)
        return torch.amin(0.5 * quad - self._log_weights, dim=-1)


# elbow/knee hyperextension: indices into the 69-D body pose (without the
# global rotation) and the bending signs
_ANGLE_IDX = [55 - 3, 58 - 3, 12 - 3, 15 - 3]
_ANGLE_SIGN = (1.0, -1.0, -1.0, -1.0)


def angle_prior(pose: torch.Tensor) -> torch.Tensor:
    r"""exp(sign * angle)^2 on knees/elbows; pose [..., 69] -> [..., 4].
    (Indexed one entry at a time: an index list would be a host-to-device
    copy on every call.)"""
    return torch.exp(torch.stack([pose[..., i] * s for i, s in
                                  zip(_ANGLE_IDX, _ANGLE_SIGN)], -1)) ** 2


def l2_prior(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x ** 2)

r"""Temporal filters for live smoothing (port of
``robustcap_tpu/utils/filter.py``): a linear Kalman filter and an
exponential low-pass in float64 numpy on the host, and a rotation low-pass
by quaternion slerp whose matrix-quaternion conversions run through the
port's ``math.angular`` in float32 on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..math.angular import (quaternion_to_rotation_matrix,
                            rotation_matrix_to_quaternion)

__all__ = ["KalmanFilter", "LowPassFilter", "LowPassFilterRotation"]


class KalmanFilter:
    r"""x <- Fx + Bu + N(0, Q);  y = Hx + N(0, R)."""

    def __init__(self, F, H, B, Q=None, R=None, x0=None, P=None):
        F = np.asarray(F, np.float64)
        H = np.asarray(H, np.float64)
        B = np.asarray(B, np.float64)
        self.n, self.m, self.k = F.shape[0], H.shape[0], B.shape[1]
        self.F, self.H, self.B = F, H, B
        self.Q = np.eye(self.n) if Q is None else np.asarray(Q, np.float64)
        self.R = np.eye(self.m) if R is None else np.asarray(R, np.float64)
        self.reset(x0, P)

    def reset(self, x0=None, P=None):
        self.P = np.eye(self.n) if P is None else np.asarray(P, np.float64)
        self.x = (np.zeros((self.n, 1)) if x0 is None
                  else np.asarray(x0, np.float64).reshape(self.n, 1))

    def predict(self, u, Q=None):
        Q = self.Q if Q is None else np.asarray(Q)
        u = np.asarray(u, np.float64).reshape(self.k, 1)
        self.x = self.F @ self.x + self.B @ u
        self.P = self.F @ self.P @ self.F.T + Q
        return self.x.ravel()

    def correct(self, y, R=None):
        R = self.R if R is None else np.asarray(R)
        y = np.asarray(y, np.float64).reshape(self.m, 1)
        S = self.H @ self.P @ self.H.T + R
        K = self.P @ self.H.T @ np.linalg.inv(S)
        self.x = self.x + K @ (y - self.H @ self.x)
        self.P = (np.eye(self.n) - K @ self.H) @ self.P
        return self.x.ravel()


class LowPassFilter:
    r"""Exponential smoothing: y_t = a * x_t + (1 - a) * y_{t-1}."""

    def __init__(self, a: float = 0.8):
        self.a = a
        self.x = None

    def reset(self):
        self.x = None

    def __call__(self, x):
        x = np.asarray(x, np.float64)
        self.x = x if self.x is None else self.a * x + (1 - self.a) * self.x
        return self.x


def _slerp(q0, q1, t):
    q0 = q0 / np.linalg.norm(q0)
    q1 = q1 / np.linalg.norm(q1)
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        out = q0 + t * (q1 - q0)
        return out / np.linalg.norm(out)
    th = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


class LowPassFilterRotation:
    r"""Rotation smoothing by slerping toward each new rotation by ``a``."""

    def __init__(self, a: float = 0.8, device="cuda"):
        self.device = resolve_device(device)
        self.a = a
        self.q = None

    def reset(self):
        self.q = None

    def __call__(self, R):
        r"""R: rotation matrices [n, 3, 3] (or [3, 3]); returns smoothed."""
        single = np.asarray(R).ndim == 2
        q = rotation_matrix_to_quaternion(torch.as_tensor(
            np.asarray(R, np.float32), device=self.device)).cpu().numpy()
        if self.q is None or len(self.q) != len(q):
            self.q = q
        else:
            self.q = np.stack([_slerp(q0, q1, self.a)
                               for q0, q1 in zip(self.q, q)])
        out = quaternion_to_rotation_matrix(torch.as_tensor(
            self.q.astype(np.float32), device=self.device)).cpu().numpy()
        return out[0] if single else out

r"""IMU <-> camera synchronization and T-pose calibration (port of
``robustcap_tpu/streaming/sync.py``).

* ``tpose_calibration``: the frame alignment rotations from 2 s of quiet
  standing: R_MI (inertial -> mocap frame, from a flat-placed sensor), R_SB
  (per-sensor sensor -> bone offset), R_CI and R_CM (the camera chain);
* ``detect_jump_sync``: the offset between the IMU and camera clocks from a
  physical jump, acceleration-norm spikes against image-sharpness dips;
* ``ImuCamStream``: the runtime combiner, resampler ticks through the
  calibration chain R_CB = R_CI R_IS R_SB, accelerations rotated to the
  camera frame.

The quaternion mean and the quaternion-to-matrix conversions run through the
port's ``math.angular`` on ``device`` (the card by default); the rest is
float32 numpy on the host, as in the JAX module.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..math.angular import quaternion_mean, quaternion_to_rotation_matrix
from .native import ImuResampler

__all__ = ["tpose_calibration", "detect_spikes", "detect_jump_sync",
           "CalibrationResult", "ImuCamStream"]


def _quat_mean_np(qs, dev: torch.device) -> np.ndarray:
    q = torch.as_tensor(np.asarray(qs, np.float32), device=dev)
    return quaternion_mean(q).cpu().numpy()


def _q2R(q, dev: torch.device) -> np.ndarray:
    q = torch.as_tensor(np.asarray(q, np.float32).reshape(-1, 4), device=dev)
    return quaternion_to_rotation_matrix(q).cpu().numpy()


@dataclass
class CalibrationResult:
    R_MI: np.ndarray      # inertial -> mocap (world) frame, [3, 3]
    R_SB: np.ndarray      # per-sensor sensor -> bone, [n, 3, 3]
    R_CI: np.ndarray      # inertial -> camera frame, [3, 3]
    R_CM: np.ndarray      # mocap -> camera frame, [3, 3]

    def save(self, path: str):
        np.savez(path, R_MI=self.R_MI, R_SB=self.R_SB, R_CI=self.R_CI,
                 R_CM=self.R_CM)

    @staticmethod
    def load(path: str) -> "CalibrationResult":
        d = np.load(path)
        return CalibrationResult(R_MI=d["R_MI"], R_SB=d["R_SB"],
                                 R_CI=d["R_CI"], R_CM=d["R_CM"])


def tpose_calibration(flat_sensor_quats: np.ndarray,
                      tpose_quats: np.ndarray,
                      camera_up_in_cam: Optional[np.ndarray] = None,
                      device="cuda") -> CalibrationResult:
    r"""Two-step calibration.

    flat_sensor_quats [K, 4]: the reference sensor lying flat (x forward,
    y left, z up); its mean orientation gives R_MI = R_IS0^T. tpose_quats
    [n, K, 4]: every sensor during a T-pose, R_SB[i] = (R_MI R_IS_i)^T since
    the bone frames are the identity in a T-pose. The camera chain maps the
    mocap up axis to ``camera_up_in_cam`` (default -y of a level camera).
    The quaternion means and conversions run on ``device``."""
    dev = resolve_device(device)
    R_MI = _q2R(_quat_mean_np(flat_sensor_quats, dev), dev)[0].T

    n = tpose_quats.shape[0]
    R_SB = np.zeros((n, 3, 3), np.float32)
    for i in range(n):
        R_IS = _q2R(_quat_mean_np(tpose_quats[i], dev), dev)[0]
        R_SB[i] = (R_MI @ R_IS).T

    up_c = (np.asarray([0.0, -1.0, 0.0], np.float32)
            if camera_up_in_cam is None
            else np.asarray(camera_up_in_cam, np.float32))
    up_c = up_c / np.linalg.norm(up_c)
    # R_CM: mocap z (up) -> up_c, mocap x as close to camera x as it can
    # be. With gravity (near-)parallel to camera x (a portrait mount) the
    # guess axis is camera y instead: otherwise the cross product
    # degenerates to ~0 and the whole calibration turns NaN.
    z_c = up_c
    x_guess = np.asarray([1.0, 0, 0], np.float32)
    if abs(float(np.dot(z_c, x_guess))) > 0.99:
        x_guess = np.asarray([0.0, 1.0, 0], np.float32)
    y_c = np.cross(z_c, x_guess)
    y_c /= np.linalg.norm(y_c)
    x_c = np.cross(y_c, z_c)
    R_CM = np.stack([x_c, y_c, z_c], axis=1).astype(np.float32)
    R_CI = (R_CM @ R_MI).astype(np.float32)
    return CalibrationResult(R_MI=R_MI.astype(np.float32), R_SB=R_SB,
                             R_CI=R_CI, R_CM=R_CM)


def detect_spikes(signal: np.ndarray, threshold: float,
                  min_separation: int = 5) -> List[int]:
    r"""Indices of local maxima above ``threshold``, at least
    ``min_separation`` samples apart."""
    idx = []
    last = -min_separation
    for i in range(1, len(signal) - 1):
        if (signal[i] > threshold and signal[i] >= signal[i - 1]
                and signal[i] >= signal[i + 1] and i - last >= min_separation):
            idx.append(i)
            last = i
    return idx


def detect_jump_sync(imu_acc_norm: np.ndarray, imu_times: np.ndarray,
                     cam_sharpness: np.ndarray, cam_times: np.ndarray,
                     acc_threshold: float = 9.0,
                     require_two: bool = True) -> Optional[float]:
    r"""Clock offset (imu_time - cam_time) from jumps: landing spikes in
    ||acc|| paired with motion-blur dips (sharpness minima) in the camera.
    ``None`` unless the offsets of (two) jumps agree within 50 ms."""
    imu_peaks = detect_spikes(imu_acc_norm, acc_threshold)
    blur = -np.asarray(cam_sharpness)
    cam_peaks = detect_spikes(blur - blur.mean(), blur.std())
    if not imu_peaks or not cam_peaks:
        return None
    n = min(len(imu_peaks), len(cam_peaks))
    if require_two and n < 2:
        return None
    offsets = [imu_times[imu_peaks[k]] - cam_times[cam_peaks[k]]
               for k in range(n)]
    if require_two and abs(offsets[0] - offsets[1]) > 0.05:
        return None
    return float(np.mean(offsets[:2] if require_two else offsets))


class ImuCamStream:
    r"""Runtime combiner: resampled IMU ticks -> camera-frame
    (R_CB [n, 3, 3], acc_C [n, 3]) through R_CB = R_CI R_IS R_SB and
    acc_C = R_CI a_I. The quaternions are converted on ``device``."""

    def __init__(self, calib: CalibrationResult, n_imu: int = 6,
                 fps: float = 60.0, device="cuda"):
        self.device = resolve_device(device)
        self.calib = calib
        self.resampler = ImuResampler(n_imu, fps)
        self.n_imu = n_imu

    def push(self, imu: int, t: float, quat_wxyz, acc):
        self.resampler.push(imu, t, quat_wxyz, acc)

    def tick(self):
        r"""``(t, R_CB [n, 3, 3], acc_C [n, 3])``, or ``None`` until every
        sensor has a sample."""
        out = self.resampler.tick()
        if out is None:
            return None
        t, quats, accs = out
        R_IS = _q2R(quats, self.device).reshape(self.n_imu, 3, 3)
        R_CB = np.einsum("ij,njk,nkl->nil", self.calib.R_CI, R_IS,
                         self.calib.R_SB)
        acc_C = np.einsum("ij,nj->ni", self.calib.R_CI, accs)
        return t, R_CB.astype(np.float32), acc_C.astype(np.float32)

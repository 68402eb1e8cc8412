r"""IMU -> UDP bridge process and a synthetic sensor emulator (port of
``robustcap_tpu/sensors/bridge.py``).

Process 1 of the live pipeline: it reads the six sensors at the target rate
and forwards binary ``t | q(4n) | a(3n)`` packets to UDP (port
``live.imu_udp_port``). ``SyntheticImuSource`` plays a preprocessed motion
as six virtual IMUs, so that the whole live chain runs without hardware.
"""

from __future__ import annotations

import socket
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import LiveConfig
from ..device import resolve_device
from ..math.angular import rotation_matrix_to_quaternion
from ..streaming.native import encode_imu_packet
from .xsens import XsensDotSet

__all__ = ["run_imu_bridge", "SyntheticImuSource"]


class SyntheticImuSource:
    r"""A virtual 6-IMU stream of a preprocessed motion (ori [T, 6, 3, 3],
    acc [T, 6, 3] at ``fps``), looping; quaternions wxyz, converted once on
    ``device``."""

    def __init__(self, ori: np.ndarray, acc: np.ndarray, fps: float = 60.0,
                 device="cuda"):
        dev = resolve_device(device)
        T = len(ori)
        self.quats = rotation_matrix_to_quaternion(torch.as_tensor(
            np.asarray(ori, np.float32).reshape(-1, 3, 3), device=dev)
        ).cpu().numpy().reshape(T, -1, 4)
        self.acc = np.asarray(acc, np.float32)
        self.fps = fps
        self.t0 = time.time()

    def read(self):
        r"""-> (t, quats [6, 4], accs [6, 3]) of the frame due now."""
        t = time.time() - self.t0
        idx = int(t * self.fps) % len(self.quats)
        return t, self.quats[idx], self.acc[idx]


def run_imu_bridge(source=None, addresses: Optional[Sequence[str]] = None,
                   live: LiveConfig = LiveConfig(), dest=None,
                   max_packets=None, transport_factory=None,
                   reset_heading: bool = False):
    r"""Forward sensor samples to UDP at ``live.fps``; returns the packets
    sent.

    ``source``: an object with ``read() -> (t, quats [n, 4], accs [n, 3])``
    (e.g. ``SyntheticImuSource``). When ``None``, the Xsens DOTs at
    ``addresses`` (default ``live.imu_addrs``) are connected through
    ``XsensDotSet``, over bleak radio or any injected ``transport_factory``
    (e.g. ``FakeDotTransport``), and start streaming, their headings reset
    first if ``reset_heading``.
    """
    dots = None
    if source is None:
        dots = XsensDotSet(addresses or list(live.imu_addrs),
                           transport_factory=transport_factory)
        dots.connect()
        dots.start_streaming()
        if reset_heading:
            dots.reset_heading()

        class _HwSource:
            def read(self):
                samples = [dots.get(i) for i in range(dots.n)]
                t = samples[-1][0]
                quats = np.stack([s[1] for s in samples])
                accs = np.stack([s[2] for s in samples])
                return t, quats, accs

        source = _HwSource()

    dest = dest or ("127.0.0.1", live.imu_udp_port)
    udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    dt = 1.0 / live.fps
    n = 0
    next_t = time.time()
    try:
        while max_packets is None or n < max_packets:
            t, quats, accs = source.read()
            udp.sendto(encode_imu_packet(t, quats, accs), dest)
            n += 1
            next_t += dt
            sleep = next_t - time.time()
            if sleep > 0:
                time.sleep(sleep)
    finally:
        udp.close()
        if dots is not None:
            dots.shutdown()
    return n

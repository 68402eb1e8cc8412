r"""Unity3D motion-streaming viewer server (port of
``robustcap_tpu/streaming/unity.py``): a TCP server that handshakes
``n_subjects#colors#names$`` and then streams each frame as the subjects'
``pose#tran`` groups joined by '#' and ended by '$'. Rotation matrices are
converted to axis-angle on ``device`` (the card by default)."""

from __future__ import annotations

import colorsys
import socket
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..math.angular import rotation_matrix_to_axis_angle

__all__ = ["MotionViewer"]


class MotionViewer:
    r"""Stream several subjects' motions to a Unity client."""

    def __init__(self, n: int = 1, overlap: bool = False,
                 names: Optional[Sequence[str]] = None, port: int = 8888,
                 device="cuda"):
        self.device = resolve_device(device)
        self.n = n
        self.overlap = overlap
        self.names = list(names) if names else [f"subject{i}"
                                                for i in range(n)]
        self.port = port
        self.conn = None
        self.server = None
        # evenly spread display colors, sent as RGB in [0, 1]
        self.colors = [colorsys.hsv_to_rgb(i / max(n, 1), 0.7, 0.9)
                       for i in range(n)]

    def connect(self):
        self.server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.server.bind(("0.0.0.0", self.port))
        self.server.listen(1)
        print(f"MotionViewer: waiting for Unity on :{self.port}")
        self.conn, _ = self.server.accept()
        colors = ",".join("%g,%g,%g" % c for c in self.colors)
        names = ",".join(self.names)
        self.conn.sendall(f"{self.n}#{colors}#{names}$".encode())

    def update_all(self, poses: List[np.ndarray], trans: List[np.ndarray]):
        r"""poses[i] [24, 3, 3] or [24, 3] axis-angle; trans[i] [3]."""
        parts = []
        for pose, tran in zip(poses, trans):
            pose = np.asarray(pose, np.float32)
            if pose.ndim == 3:
                pose = rotation_matrix_to_axis_angle(torch.as_tensor(
                    pose, device=self.device)).cpu().numpy().reshape(24, 3)
            parts.append(",".join("%g" % v for v in pose.reshape(-1)))
            parts.append(",".join("%g" % v
                                  for v in np.asarray(tran).reshape(-1)))
        self.conn.sendall(("#".join(parts) + "$").encode())

    def close(self):
        if self.conn:
            self.conn.close()
        if self.server:
            self.server.close()

    def __enter__(self):
        self.connect()
        return self

    def __exit__(self, *a):
        self.close()

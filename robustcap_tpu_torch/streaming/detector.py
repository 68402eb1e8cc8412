r"""Live 2-D keypoint detector process, camera + MediaPipe -> UDP (port of
``robustcap_tpu/streaming/detector.py``).

Process 2 of the live pipeline: it takes synchronized IMU ticks, runs
MediaPipe Pose on the newest camera frame, normalizes the landmarks through
K^-1 and sends ``uv#ori#acc#RCM`` packets to the live server. MediaPipe is
an optional host dependency, imported when the loop starts. A frame without
a detection reuses the last keypoints (all zeros before the first).
"""

from __future__ import annotations

import socket
import time
from typing import Optional

import numpy as np

from ..config import LiveConfig
from .protocol import encode_detector_packet

__all__ = ["KeypointNormalizer", "run_detector"]


class KeypointNormalizer:
    r"""Pixel landmarks and visibility -> K^-1-plane coordinates."""

    def __init__(self, K, width: int, height: int):
        self.Kinv = np.linalg.inv(np.asarray(K, np.float32))
        self.width = width
        self.height = height
        self.last: Optional[np.ndarray] = None

    def __call__(self, landmarks: Optional[np.ndarray]) -> np.ndarray:
        r"""landmarks [33, 3] of (x_frac, y_frac, visibility), or ``None``
        for a frame without a detection; returns [33, 3] of
        (x_n, y_n, visibility)."""
        if landmarks is None:
            if self.last is None:
                return np.zeros((33, 3), np.float32)
            return self.last
        uv = np.asarray(landmarks, np.float32).copy()
        px = np.stack([uv[:, 0] * self.width, uv[:, 1] * self.height,
                       np.ones(33, np.float32)], 1)
        xy = px @ self.Kinv.T
        out = np.stack([xy[:, 0], xy[:, 1], uv[:, 2]], 1).astype(np.float32)
        self.last = out
        return out


def run_detector(sync_stream, camera_reader, rcm: np.ndarray,
                 live: LiveConfig = LiveConfig(), server_addr=None,
                 max_frames=None):
    r"""The detector loop.

    ``sync_stream.tick() -> (t, R_CB [6, 3, 3], acc_C [6, 3]) | None`` (see
    ``sync.ImuCamStream``); ``camera_reader() -> frame | None`` returns the
    newest camera image; MediaPipe runs on each frame and the packet goes by
    UDP to the live server (``server_addr``, default the local detector
    port of ``live``).
    """
    try:
        import mediapipe as mp
    except ImportError as e:
        raise ImportError(
            "run_detector requires mediapipe (the external 2-D pose "
            "detector); feed cached keypoints through the offline pipeline "
            "instead") from e

    pose = mp.solutions.pose.Pose(min_detection_confidence=0.5,
                                  model_complexity=1)
    norm = KeypointNormalizer(np.asarray(live.camera_intrinsic),
                              live.camera_width, live.camera_height)
    addr = server_addr or ("127.0.0.1", live.detector_udp_port)
    udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    # paced to the resampler's 60 Hz: its clock advances dt a tick whatever
    # the wall time, so an unpaced loop would flood the server and let the
    # stream's timestamps race ahead of real time
    dt = getattr(sync_stream, "dt", 1.0 / 60.0)
    next_t = time.monotonic()
    n = 0
    try:
        while max_frames is None or n < max_frames:
            tick = sync_stream.tick()
            if tick is None:
                time.sleep(0.001)
                continue
            _, ori, acc = tick
            next_t += dt
            delay = next_t - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            else:
                next_t = time.monotonic()   # fell behind: re-anchor
            frame = camera_reader()
            lm = None
            if frame is not None:
                res = pose.process(frame[..., ::-1])  # BGR -> RGB
                if res.pose_landmarks is not None:
                    lm = np.asarray([[p.x, p.y, p.visibility]
                                     for p in res.pose_landmarks.landmark],
                                    np.float32)
            udp.sendto(encode_detector_packet(norm(lm), ori, acc, rcm), addr)
            n += 1
    finally:
        udp.close()

r"""Live inference server: UDP sensor frames -> fused pose -> Unity TCP.

Port of ``robustcap_tpu/streaming/server.py``, process 3 of the live
pipeline: it receives ``uv#ori#acc#RCM`` packets from the detector process,
runs the streaming step (the live flag set: tighter confidence gates, the
throttled vision updater), rotates the root pose and translation back to
the world frame with R_CM^T, and streams axis-angle frames to a Unity
client over TCP.
"""

from __future__ import annotations

import socket
import time
from typing import Optional

import numpy as np
import torch

from ..config import LiveConfig, SigMPConfig
from ..math.angular import rotation_matrix_to_axis_angle
from ..models import sig_mp
from ..smpl.model import default_body_model
from .protocol import encode_unity_frame, parse_detector_packet

__all__ = ["LiveServer", "run_live_demo"]


class LiveServer:
    r"""Stateful live-inference engine (the transport-free core).

    ``net`` may be passed instead of ``params``: anything with the
    ``forward_online``/``reset_states`` API, notably a loaded
    ``serving.ServingBundle``, so that the live process runs exported
    programs without the model code path."""

    def __init__(self, params=None, model=None,
                 cfg: Optional[SigMPConfig] = None, net=None,
                 device="cuda"):
        if net is None:
            if params is None:
                raise ValueError("pass params or a net")
            model = model or default_body_model(device)
            cfg = cfg or SigMPConfig.live_mode()
            net = sig_mp.StreamingNet(params, model, cfg, device=device)
        self.net = net
        self.first = True
        self.tran_offset = None

    def reset(self):
        self.net.reset_states()
        self.first = True
        self.tran_offset = None

    def process(self, uv: np.ndarray, ori: np.ndarray, acc: np.ndarray,
                rcm: np.ndarray):
        r"""One sensor frame -> (pose_aa [24, 3] world, tran [3] world):
        gravity from R_CM, the first frame seeds the translation, outputs
        de-rotated by R_CM^T and zeroed at the start position."""
        gravity_c = rcm @ np.asarray([0.0, -1.0, 0.0], np.float32)
        pose, tran = self.net.forward_online(
            uv, acc, ori, first_frame=self.first, gravityc=gravity_c)
        self.first = False
        pose = pose.cpu().numpy().copy()
        tran = tran.cpu().numpy()
        pose[0] = rcm.T @ pose[0]
        tran_w = rcm.T @ tran
        if self.tran_offset is None:
            self.tran_offset = tran_w.copy()
        tran_w = tran_w - self.tran_offset
        pose_aa = rotation_matrix_to_axis_angle(
            torch.from_numpy(pose)).reshape(24, 3).numpy()
        return pose_aa, tran_w


def run_live_demo(params=None, model=None, cfg: Optional[SigMPConfig] = None,
                  live: LiveConfig = LiveConfig(), max_frames=None, net=None,
                  device="cuda"):
    r"""Socket loop: accept a Unity client on TCP ``live.unity_tcp_port``,
    then consume detector UDP packets on ``live.detector_udp_port`` and
    stream one frame back per packet, ``max_frames`` of them (``None``: until
    the process ends).

    Both sockets come up before the engine is built, so that clients can
    connect at once (building the engine can take seconds)."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    conn = None
    try:
        srv.bind(("0.0.0.0", live.unity_tcp_port))
        srv.listen(1)
        # bound before the viewer is accepted, so that packets sent as soon
        # as the client connects are not dropped
        udp.bind(("0.0.0.0", live.detector_udp_port))

        engine = LiveServer(params, model, cfg, net=net, device=device)

        print(f"waiting for Unity on :{live.unity_tcp_port}", flush=True)
        conn, addr = srv.accept()
        print("unity connected:", addr, flush=True)

        n = 0
        t0 = time.time()
        while max_frames is None or n < max_frames:
            buf, _ = udp.recvfrom(65536)
            uv, ori, acc, rcm = parse_detector_packet(buf)
            pose_aa, tran = engine.process(uv, ori, acc, rcm)
            conn.sendall(encode_unity_frame(pose_aa, tran))
            n += 1
            if n % 600 == 0:
                print(f"{n} frames, {n / (time.time() - t0):.1f} fps",
                      flush=True)
    finally:
        if conn is not None:
            conn.close()
        srv.close()
        udp.close()

r"""Wire formats of the live pipeline, byte for byte the JAX package's
(``robustcap_tpu/streaming/protocol.py``), so that the reference's detector
and Unity processes interoperate with the port's server:

* detector -> server: UDP, ASCII ``uv#ori#acc#RCM`` with ','-joined floats;
* server -> Unity: TCP, ASCII ``pose#tran$`` per frame.

Every float is written with ``%g`` after a cast to float32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["encode_detector_packet", "parse_detector_packet",
           "encode_unity_frame", "parse_unity_frame"]


def _csv(a) -> str:
    return ",".join("%g" % v for v in np.asarray(a, np.float32).reshape(-1))


def _parse(s: str, shape) -> np.ndarray:
    vals = np.asarray([float(v) for v in s.split(",") if v], np.float32)
    return vals.reshape(shape)


def encode_detector_packet(uv: np.ndarray, ori: np.ndarray, acc: np.ndarray,
                           rcm: np.ndarray) -> bytes:
    r"""uv [33, 3] (normalized x, y, visibility), ori [6, 3, 3], acc [6, 3],
    RCM [3, 3] -> ``uv#ori#acc#RCM``."""
    return "#".join([_csv(uv), _csv(ori), _csv(acc), _csv(rcm)]).encode()


def parse_detector_packet(buf: bytes
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray]:
    r"""``uv#ori#acc#RCM`` -> (uv [33, 3], ori [6, 3, 3], acc [6, 3],
    RCM [3, 3]); raises ``ValueError`` on a malformed packet."""
    parts = buf.decode().split("#")
    if len(parts) != 4:
        raise ValueError("malformed detector packet")
    return (_parse(parts[0], (33, 3)), _parse(parts[1], (6, 3, 3)),
            _parse(parts[2], (6, 3)), _parse(parts[3], (3, 3)))


def encode_unity_frame(pose_axis_angle: np.ndarray,
                       tran: np.ndarray) -> bytes:
    r"""pose [24, 3] axis-angle, tran [3] -> ``pose#tran$``."""
    return ("#".join([_csv(pose_axis_angle), _csv(tran)]) + "$").encode()


def parse_unity_frame(buf: bytes) -> Tuple[np.ndarray, np.ndarray]:
    r"""``pose#tran$`` -> (pose [24, 3] axis-angle, tran [3])."""
    pose_s, tran_s = buf.decode().rstrip("$").split("#")
    return _parse(pose_s, (24, 3)), _parse(tran_s, (3,))

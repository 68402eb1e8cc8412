r"""The native streaming datapath through ``ctypes``, with a pure-Python
fallback of the same semantics (port of
``robustcap_tpu/streaming/native.py``).

The library is the repository's shared ``native/robustcap_native.cpp``,
built with ``g++`` on first use into ``robustcap_tpu_torch/_build/`` by
``ops._build.host_library``: keyed by the source's hash and renamed into
place, so that concurrent processes never write one file at once and the
source tree is never written. Without a compiler the fallback runs;
:func:`native_available` says which one does. Everything here is host code:
drop-oldest rings of float32 records, the N-IMU resampler onto a fixed
clock, and the binary IMU packet codec.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from collections import deque
from typing import Optional

import numpy as np

from ..ops._build import host_library

__all__ = ["load_native", "RingBuffer", "ImuResampler",
           "parse_imu_packet", "encode_imu_packet", "native_available"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "robustcap_native.cpp")

_lib = None
_tried = False
_load_lock = threading.Lock()

_F32P = ctypes.POINTER(ctypes.c_float)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.rc_ring_new.restype = ctypes.c_void_p
    lib.rc_ring_new.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
    lib.rc_ring_push.restype = ctypes.c_int
    lib.rc_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.rc_ring_pop.restype = ctypes.c_int
    lib.rc_ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.rc_ring_size.restype = ctypes.c_size_t
    lib.rc_ring_size.argtypes = [ctypes.c_void_p]
    lib.rc_ring_dropped.restype = ctypes.c_uint64
    lib.rc_ring_dropped.argtypes = [ctypes.c_void_p]
    lib.rc_ring_clear.restype = None
    lib.rc_ring_clear.argtypes = [ctypes.c_void_p]
    lib.rc_ring_free.restype = None
    lib.rc_ring_free.argtypes = [ctypes.c_void_p]
    lib.rc_resampler_new.restype = ctypes.c_void_p
    lib.rc_resampler_new.argtypes = [ctypes.c_int, ctypes.c_double]
    lib.rc_resampler_push.restype = None
    lib.rc_resampler_push.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_double, _F32P, _F32P]
    lib.rc_resampler_tick.restype = ctypes.c_double
    lib.rc_resampler_tick.argtypes = [ctypes.c_void_p, _F32P, _F32P]
    lib.rc_resampler_free.restype = None
    lib.rc_resampler_free.argtypes = [ctypes.c_void_p]
    return lib


def load_native() -> Optional[ctypes.CDLL]:
    r"""Build (if needed) and load the native library; ``None`` when it
    cannot be built or loaded (the fallback then runs)."""
    global _lib, _tried
    with _load_lock:
        if not _tried:
            _tried = True
            try:
                _lib = _bind(ctypes.CDLL(host_library(_SRC)))
            except (OSError, subprocess.CalledProcessError):
                _lib = None
        return _lib


def native_available() -> bool:
    return load_native() is not None


class RingBuffer:
    r"""Thread-safe drop-oldest ring of fixed-size float32 records (the
    reference's Queue(180) with drop-on-full)."""

    def __init__(self, capacity: int, item_floats: int):
        self.item_floats = item_floats
        self._lib = load_native()
        if self._lib is not None:
            self._h = self._lib.rc_ring_new(capacity, 4 * item_floats)
        else:
            self._h = None
            self._q = deque(maxlen=capacity)
            self._mu = threading.Lock()
            self._dropped = 0
            self._cap = capacity

    def __del__(self):
        h = getattr(self, "_h", None)
        if h and getattr(self, "_lib", None) is not None:
            self._lib.rc_ring_free(h)
            self._h = None

    def _record(self, item) -> np.ndarray:
        item = np.ascontiguousarray(item, np.float32).reshape(-1)
        if item.size != self.item_floats:
            raise ValueError(f"ring record of {item.size} floats, expected "
                             f"{self.item_floats}")
        return item

    def push(self, item: np.ndarray) -> bool:
        r"""Append one record; returns whether the oldest was dropped."""
        item = self._record(item)
        if self._lib is not None:
            return bool(self._lib.rc_ring_push(
                self._h, item.ctypes.data_as(ctypes.c_void_p)))
        with self._mu:
            dropped = len(self._q) == self._cap
            self._dropped += dropped
            self._q.append(item.copy())
            return dropped

    def pop(self) -> Optional[np.ndarray]:
        r"""The oldest record, or ``None`` when the ring is empty."""
        if self._lib is not None:
            out = np.empty(self.item_floats, np.float32)
            if self._lib.rc_ring_pop(
                    self._h, out.ctypes.data_as(ctypes.c_void_p)) != 0:
                return None
            return out
        with self._mu:
            return self._q.popleft() if self._q else None

    def __len__(self):
        if self._lib is not None:
            return int(self._lib.rc_ring_size(self._h))
        with self._mu:
            return len(self._q)

    @property
    def dropped(self) -> int:
        if self._lib is not None:
            return int(self._lib.rc_ring_dropped(self._h))
        with self._mu:
            return self._dropped

    def clear(self):
        if self._lib is not None:
            self._lib.rc_ring_clear(self._h)
        else:
            with self._mu:
                self._q.clear()


def _slerp_np(q0, q1, t):
    d = float(np.dot(q0, q1))
    sign = 1.0
    if d < 0:
        d, sign = -d, -1.0
    if d > 0.9995:
        out = (1 - t) * q0 + sign * t * q1
    else:
        th = np.arccos(min(d, 1.0))
        out = (np.sin((1 - t) * th) * q0 + sign * np.sin(t * th) * q1) \
            / np.sin(th)
    return out / np.linalg.norm(out)


class ImuResampler:
    r"""N-IMU fixed-rate resampler: the latest two samples of each sensor,
    slerped (quaternions, wxyz) and interpolated linearly (accelerations)
    onto an internal clock that starts at the newest sample, advances
    ``1 / fps`` a tick, and jumps to one tick behind the newest sample when
    it falls more than two ticks behind."""

    def __init__(self, n_imu: int = 6, fps: float = 60.0):
        self.n_imu = n_imu
        self.fps = fps
        self._lib = load_native()
        if self._lib is not None:
            self._h = self._lib.rc_resampler_new(n_imu, fps)
        else:
            self._h = None
            self._prev = [None] * n_imu
            self._cur = [None] * n_imu
            self._clock = None
            self._dt = 1.0 / fps
            self._mu = threading.Lock()

    def __del__(self):
        h = getattr(self, "_h", None)
        if h and getattr(self, "_lib", None) is not None:
            self._lib.rc_resampler_free(h)
            self._h = None

    def push(self, imu: int, t: float, quat_wxyz: np.ndarray,
             acc: np.ndarray):
        q = np.ascontiguousarray(quat_wxyz, np.float32).reshape(-1)
        a = np.ascontiguousarray(acc, np.float32).reshape(-1)
        if q.size != 4 or a.size != 3:
            raise ValueError(f"IMU sample of {q.size} + {a.size} floats, "
                             "expected a quaternion (4) and an "
                             "acceleration (3)")
        if self._lib is not None:
            self._lib.rc_resampler_push(self._h, imu, t,
                                        q.ctypes.data_as(_F32P),
                                        a.ctypes.data_as(_F32P))
            return
        with self._mu:
            self._prev[imu] = self._cur[imu]
            self._cur[imu] = (t, q.copy(), a.copy())

    def tick(self):
        r"""``(t, quats [n, 4], accs [n, 3])`` at the clock, or ``None``
        until every sensor has a sample."""
        if self._lib is not None:
            q = np.empty((self.n_imu, 4), np.float32)
            a = np.empty((self.n_imu, 3), np.float32)
            t = self._lib.rc_resampler_tick(self._h, q.ctypes.data_as(_F32P),
                                            a.ctypes.data_as(_F32P))
            if t < 0:
                return None
            return t, q, a
        with self._mu:
            if any(c is None for c in self._cur):
                return None
            newest = max(c[0] for c in self._cur)
            if self._clock is None:
                self._clock = newest
            if newest - self._clock > 2 * self._dt:
                self._clock = newest - self._dt
            q = np.empty((self.n_imu, 4), np.float32)
            a = np.empty((self.n_imu, 3), np.float32)
            for i in range(self.n_imu):
                p, c = self._prev[i], self._cur[i]
                if p is not None and c[0] > p[0]:
                    alpha = np.clip((self._clock - p[0]) / (c[0] - p[0]),
                                    0, 1)
                    q[i] = _slerp_np(p[1], c[1], float(alpha))
                    a[i] = (1 - alpha) * p[2] + alpha * c[2]
                else:
                    q[i], a[i] = c[1], c[2]
            t = self._clock
            self._clock += self._dt
            return t, q, a


def encode_imu_packet(t: float, quats: np.ndarray, accs: np.ndarray) -> bytes:
    r"""float32 ``[t | q(4n) | a(3n)]``, the bridge's UDP layout."""
    q = np.ascontiguousarray(quats, np.float32).reshape(-1)
    a = np.ascontiguousarray(accs, np.float32).reshape(-1)
    return np.concatenate([[np.float32(t)], q, a]).astype(np.float32).tobytes()


def parse_imu_packet(buf: bytes, n_imu: int = 6):
    r"""Inverse of :func:`encode_imu_packet` -> ``(t, quats [n, 4],
    accs [n, 3])``; raises ``ValueError`` on a short packet."""
    f = np.frombuffer(buf, np.float32)
    need = 1 + 7 * n_imu
    if len(f) < need:
        raise ValueError(f"short IMU packet: {len(f)} < {need}")
    return (float(f[0]), f[1:1 + 4 * n_imu].reshape(n_imu, 4).copy(),
            f[1 + 4 * n_imu:need].reshape(n_imu, 3).copy())

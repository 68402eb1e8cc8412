r"""Xsens DOT BLE sensor stack (port of ``robustcap_tpu/sensors/xsens.py``).

BLE payload parsing is pure; radio I/O (bleak, asyncio) is isolated in
``XsensDotSet`` and gated on the ``bleak`` package + hardware presence. The
per-sensor rings are the port's ``streaming.native.RingBuffer``.

Payload: "complete quaternion" mode = 32 bytes of
``uint32 timestamp_us | float32 quat wxyz x4 | float32 free_acc x3``.
"""

from __future__ import annotations

import struct
import threading
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..streaming.native import RingBuffer

__all__ = ["CompleteQuaternionPayload", "parse_complete_quaternion",
           "encode_complete_quaternion", "XsensDotSet"]

# the canonical UUID / payload-mode tables live in xdc_codec (UUIDS,
# PayloadMode); this module holds only the stream-level driver

_FMT = "<I4f3f"


@dataclass
class CompleteQuaternionPayload:
    timestamp: float          # seconds
    quat_wxyz: np.ndarray     # [4]
    free_acc: np.ndarray      # [3]


def parse_complete_quaternion(data: bytes) -> CompleteQuaternionPayload:
    r"""Decode one 32-byte complete-quaternion notification
    (xdc.py MediumPayloadCompleteQuaternion)."""
    if len(data) < struct.calcsize(_FMT):
        raise ValueError(f"short payload: {len(data)} bytes")
    vals = struct.unpack_from(_FMT, data)
    return CompleteQuaternionPayload(
        timestamp=vals[0] * 1e-6,
        quat_wxyz=np.asarray(vals[1:5], np.float32),
        free_acc=np.asarray(vals[5:8], np.float32))


def encode_complete_quaternion(t: float, quat_wxyz, free_acc) -> bytes:
    r"""Inverse of ``parse_complete_quaternion`` (used by the synthetic
    sensor emulator and tests)."""
    q = np.asarray(quat_wxyz, np.float32)
    a = np.asarray(free_acc, np.float32)
    return struct.pack(_FMT, int(t * 1e6) & 0xFFFFFFFF, *q.tolist(),
                       *a.tolist())


class _BleakTransport:
    r"""DotClient transport over a live bleak connection (hardware path)."""

    def __init__(self, address: str):
        from bleak import BleakClient
        self.client = BleakClient(address)

    async def connect(self):
        await self.client.connect()

    async def disconnect(self):
        await self.client.disconnect()

    async def read(self, uuid):
        return bytes(await self.client.read_gatt_char(uuid))

    async def write(self, uuid, data):
        await self.client.write_gatt_char(uuid, data)

    async def start_notify(self, uuid, cb):
        await self.client.start_notify(uuid, cb)


# command verbs for the event loop (the reference uses integer
# _pending_event codes, xsens_dot_set.py:85-130)
_CMD_CLOSE = "close"
_CMD_RESET_HEADING = "reset_heading"
_CMD_REVERT_HEADING = "revert_heading"
_CMD_START = "start_streaming"
_CMD_STOP = "stop_streaming"
_CMD_BATTERY = "battery"


class XsensDotSet:
    r"""A set of Xsens DOT sensors with per-sensor ring buffers and the
    reference's connection/event protocol (xsens_dot_set.py:19-371):

    * BLE notifications land in drop-oldest rings (capacity 180, matching
      the reference's Queue(180)); ``get(i)`` pops the oldest sample,
    * ``connect()`` runs an asyncio event loop in a daemon thread that
      connects every sensor, reads battery levels, stops any stale
      streaming, subscribes payload + device-report notifications and sets
      the 60 Hz output rate (xsens_dot_set.py:42-83),
    * commands — ``start_streaming`` / ``stop_streaming`` /
      ``reset_heading`` / ``revert_heading_to_default`` /
      ``print_battery_info`` / ``shutdown`` — are queued to that loop like
      the reference's pending-event protocol (:160-334).

    The radio is injectable: ``transport_factory(address) -> transport``
    defaults to bleak (hardware) and tests pass
    :class:`~robustcap_tpu_torch.sensors.xdc_codec.FakeDotTransport`, so
    the full connect/configure/stream/heading logic is exercised without
    BLE.
    """

    def __init__(self, addresses: Sequence[str], buffer_len: int = 180,
                 transport_factory=None,
                 payload_mode: int = None):
        from .xdc_codec import PayloadMode
        self.addresses = list(addresses)
        self.n = len(self.addresses)
        # ring record: [t, qw, qx, qy, qz, ax, ay, az]
        self._buffers = [RingBuffer(buffer_len, 8) for _ in range(self.n)]
        self._connected = False
        self._started = False
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._transport_factory = transport_factory
        self._payload_mode = (PayloadMode.COMPLETE_QUATERNION
                              if payload_mode is None else payload_mode)
        self._cmds: "list" = []
        self._cmd_lock = threading.Lock()
        self._cmd_done = threading.Event()
        self._cmd_error: Optional[Exception] = None
        self.battery_levels: list = []
        self.reports: list = []

    # -- data path (no hardware needed) -------------------------------------

    def feed(self, i: int, payload: bytes, mode: int = None):
        r"""Inject one BLE measurement notification for sensor i (called
        from the radio callback or an emulator). Any payload mode carrying
        orientation + free acceleration is accepted; quaternion-free modes
        raise (the fusion model needs orientation)."""
        from .xdc_codec import PayloadMode, parse_payload
        mode = self._payload_mode if mode is None else mode
        if mode == PayloadMode.COMPLETE_QUATERNION:
            p = parse_complete_quaternion(payload)   # fast path
            t, quat, acc = p.timestamp, p.quat_wxyz, p.free_acc
        else:
            d = parse_payload(mode, payload)
            if "quaternion" not in d:
                raise ValueError(
                    f"payload mode {mode} carries no quaternion; the fusion "
                    f"pipeline needs orientation (use modes 2/3/5/24)")
            t = d["timestamp"]
            quat = d["quaternion"]
            acc = d.get("free_acceleration", np.zeros(3, np.float32))
        rec = np.concatenate([[t], quat, acc]).astype(np.float32)
        self._buffers[i].push(rec)

    def get(self, i: int, timeout: float = 3.0):
        r"""Pop the oldest sample of sensor i -> (t, quat [4], acc [3]);
        blocks up to ``timeout`` (xsens_dot_set.py:191)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            rec = self._buffers[i].pop()
            if rec is not None:
                return float(rec[0]), rec[1:5].copy(), rec[5:8].copy()
            time.sleep(0.001)
        raise TimeoutError(f"sensor {i}: no data within {timeout}s")

    def is_available(self, i: int) -> bool:
        return len(self._buffers[i]) > 0

    def is_connected(self) -> bool:
        return self._connected

    def is_started(self) -> bool:
        return self._started

    def clear(self, i: Optional[int] = None):
        for b in (self._buffers if i is None else [self._buffers[i]]):
            b.clear()

    # -- radio management (transport-injectable) ----------------------------

    def _default_transport_factory(self, address):
        try:
            import bleak  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "XsensDotSet.connect requires the 'bleak' BLE package and "
                "physical Xsens DOT sensors; pass transport_factory="
                "FakeDotTransport for hardware-free operation") from e
        return _BleakTransport(address)

    def _enqueue(self, cmd, wait: bool = True, timeout: float = 10.0):
        if not self._connected:
            raise RuntimeError("not connected; call connect() first")
        self._cmd_done.clear()
        self._cmd_error = None
        with self._cmd_lock:
            self._cmds.append(cmd)
        if wait:
            if not self._cmd_done.wait(timeout):
                raise TimeoutError(
                    f"command {cmd} not processed in {timeout}s")
            if self._cmd_error is not None:
                raise self._cmd_error

    def connect(self, timeout: float = 30.0):
        r"""Connect all sensors and run the event loop in a daemon thread;
        blocks until configuration completes (xsens_dot_set.py:210-233)."""
        import asyncio

        from .xdc_codec import DotClient, parse_device_report

        factory = self._transport_factory or self._default_transport_factory
        ready = threading.Event()
        error: list = []

        async def run():
            transports, clients = [], []
            try:
                for i, addr in enumerate(self.addresses):
                    tr = factory(addr)
                    if hasattr(tr, "connect"):
                        await tr.connect()
                    dot = DotClient(tr)
                    self.battery_levels.append(
                        (await dot.battery()).battery_level)
                    await dot.stop_streaming()    # clear stale streaming

                    def payload_cb(_, data, i=i):
                        self.feed(i, bytes(data))

                    def report_cb(_, data, i=i):
                        self.reports.append((i, parse_device_report(data)))

                    await dot.start_payload_notify(payload_cb)
                    await dot.start_report_notify(report_cb)
                    await dot.set_output_rate(60)
                    transports.append(tr)
                    clients.append(dot)
            except Exception as e:   # pragma: no cover - radio errors
                error.append(e)
                ready.set()
                return
            self._connected = True
            ready.set()
            while not self._stop.is_set():
                cmd = None
                with self._cmd_lock:
                    if self._cmds:
                        cmd = self._cmds.pop(0)
                if cmd is None:
                    await asyncio.sleep(0.005)
                    continue
                if cmd == _CMD_CLOSE:
                    break
                try:
                    if cmd == _CMD_START:
                        for d in clients:
                            await d.start_streaming(self._payload_mode)
                        self._started = True
                    elif cmd == _CMD_STOP:
                        for d in clients:
                            await d.stop_streaming()
                        self._started = False
                    elif cmd == _CMD_RESET_HEADING:
                        for d in clients:
                            await d.reset_heading()
                    elif cmd == _CMD_REVERT_HEADING:
                        for d in clients:
                            await d.revert_heading_to_default()
                    elif cmd == _CMD_BATTERY:
                        self.battery_levels = [
                            (await d.battery()).battery_level
                            for d in clients]
                except Exception as e:
                    # surface the command's real failure to the waiting
                    # caller instead of killing the loop thread (which
                    # would leave _connected stuck and every later
                    # command timing out)
                    self._cmd_error = e
                self._cmd_done.set()
            for tr in transports:
                if hasattr(tr, "disconnect"):
                    await tr.disconnect()
            self._connected = False
            self._cmd_done.set()

        self._thread = threading.Thread(
            target=lambda: __import__("asyncio").run(run()), daemon=True)
        self._thread.start()
        if not ready.wait(timeout):
            raise TimeoutError("sensor connection timed out")
        if error:
            raise error[0]

    def start_streaming(self):
        self._enqueue(_CMD_START)

    def stop_streaming(self):
        self._enqueue(_CMD_STOP)

    def reset_heading(self):
        self._enqueue(_CMD_RESET_HEADING)

    def revert_heading_to_default(self):
        self._enqueue(_CMD_REVERT_HEADING)

    def print_battery_info(self):
        self._enqueue(_CMD_BATTERY)
        for i, lvl in enumerate(self.battery_levels):
            print(f"\t[{i}] {lvl}%")

    def shutdown(self):
        if self._connected:
            try:
                self._enqueue(_CMD_CLOSE, wait=False)
            except RuntimeError:
                pass
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self._connected = False
        self._started = False

r"""Noitom Perception Neuron MocapApi ctypes bindings (alternative IMU vendor);
a copy of ``robustcap_tpu/sensors/noitom.py`` (ctypes and numpy).

Rebuild of the reference's ``articulate/utils/noitom/mocap_api.py`` (1041 LoC)
as a usable backend: the vendor ships a C shared library whose interfaces are
obtained as *procedure tables* via ``MCPGetGenericInterface("PROC_TABLE:..")``
— each table is a struct of C function pointers. This module types every
table the reference uses (application, settings, avatar, joint, rigid body,
sensor module), the event structures, and the error/joint-tag/event-type
enums, and adds:

* :class:`MocapLib` — per-library interface cache instead of the reference's
  module-level singleton tables (multiple libraries / test mocks coexist),
* :class:`NoitomSensorSet` — the 6-IMU polling loop the reference sketches
  in its ``__main__`` (mocap_api.py:1020-1041) packaged as a source usable
  by the IMU bridge, emitting :class:`NoitomFrame` records,
* a mock vendor library for tests (``native/mock_mocap_api.cpp``) so the
  whole FFI path — proc-table fetch, app lifecycle, event polling, sensor
  posture reads — runs without Noitom hardware or the proprietary SDK.

Vendor ABI fidelity notes: struct field ORDER inside each proc table is the
vendor ABI and must match mocap_api.py / MocapApi.h exactly; enum values
(MCPError codes 0-21, event types 0x000/0x100/.../0x600, joint tags -1..60)
are vendor constants.
"""

from __future__ import annotations

import ctypes
import os
from ctypes import (CFUNCTYPE, POINTER, Structure, Union, c_bool, c_char_p,
                    c_double, c_float, c_int32, c_uint16, c_uint32, c_uint64,
                    pointer, sizeof)
from dataclasses import dataclass
from enum import IntEnum
from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "MCPError", "MCPJointTag", "MCPEventType", "MCPBvhRotation",
    "MCPEvent", "MCPEventData", "MocapLib", "MCPApplication", "MCPSettings",
    "MCPAvatar", "MCPJoint", "MCPRigidBody", "MCPSensorModule",
    "NoitomSensorSet", "NoitomFrame", "MocapApi", "MocapApiError",
]

# handles are opaque 64-bit ids in the vendor ABI
_Handle = c_uint64


class MCPError(IntEnum):
    r"""EMCPError (mocap_api.py:24-47)."""
    NoError = 0
    MoreEvent = 1
    InsufficientBuffer = 2
    InvalidObject = 3
    InvalidHandle = 4
    InvalidParameter = 5
    NotSupported = 6
    IgnoreUDPSettings = 7
    IgnoreTCPSettings = 8
    IgnoreBvhSettings = 9
    JointNotFound = 10
    WithoutTransformation = 11
    NoneMessage = 12
    NoneParent = 13
    NoneChild = 14
    AddressInUse = 15
    ServerNotReady = 16
    ClientNotReady = 17
    IncompleteCommand = 18
    UDP = 19
    TCP = 20
    QueuedCommandFaild = 21


class MCPEventType(IntEnum):
    r"""EMCPEventType (mocap_api.py:616-624)."""
    InvalidEvent = 0
    AvatarUpdated = 256
    RigidBodyUpdated = 512
    Error = 768
    SensorModulesUpdated = 1024
    TrackerUpdated = 1280
    CommandReply = 1536


class MCPBvhRotation(IntEnum):
    XYZ = 0
    XZY = 1
    YXZ = 2
    YZX = 3
    ZXY = 4
    ZYX = 5


# EMCPJointTag (mocap_api.py:50-113): Invalid = -1, then 61 joints
_JOINT_TAG_NAMES = [
    "Invalid", "Hips", "RightUpLeg", "RightLeg", "RightFoot", "LeftUpLeg",
    "LeftLeg", "LeftFoot", "Spine", "Spine1", "Spine2", "Neck", "Neck1",
    "Head", "RightShoulder", "RightArm", "RightForeArm", "RightHand",
    "RightHandThumb1", "RightHandThumb2", "RightHandThumb3",
    "RightInHandIndex", "RightHandIndex1", "RightHandIndex2",
    "RightHandIndex3", "RightInHandMiddle", "RightHandMiddle1",
    "RightHandMiddle2", "RightHandMiddle3", "RightInHandRing",
    "RightHandRing1", "RightHandRing2", "RightHandRing3", "RightInHandPinky",
    "RightHandPinky1", "RightHandPinky2", "RightHandPinky3", "LeftShoulder",
    "LeftArm", "LeftForeArm", "LeftHand", "LeftHandThumb1", "LeftHandThumb2",
    "LeftHandThumb3", "LeftInHandIndex", "LeftHandIndex1", "LeftHandIndex2",
    "LeftHandIndex3", "LeftInHandMiddle", "LeftHandMiddle1",
    "LeftHandMiddle2", "LeftHandMiddle3", "LeftInHandRing", "LeftHandRing1",
    "LeftHandRing2", "LeftHandRing3", "LeftInHandPinky", "LeftHandPinky1",
    "LeftHandPinky2", "LeftHandPinky3", "Spine3", "JointsCount",
]
MCPJointTag = IntEnum("MCPJointTag",
                      {n: i - 1 for i, n in enumerate(_JOINT_TAG_NAMES)})


class MocapApiError(RuntimeError):
    def __init__(self, what: str, err: int):
        try:
            name = MCPError(err).name
        except ValueError:
            name = str(err)
        super().__init__(f"{what}: {name}")
        self.err = err


def _check(err: int, what: str):
    if err != MCPError.NoError:
        raise MocapApiError(what, err)


# ---------------------------------------------------------------------------
# Event structures (vendor ABI, mocap_api.py:577-633)
# ---------------------------------------------------------------------------


class _EventReserved(Structure):
    _fields_ = [("reserved%d" % i, c_uint64) for i in range(6)]


class _EventMotionData(Structure):
    _fields_ = [("avatar_handle", _Handle)]


class _EventSystemError(Structure):
    _fields_ = [("error", c_uint32), ("info0", c_uint64)]


class _EventSensorModuleData(Structure):
    _fields_ = [("sensor_module_handle", _Handle)]


class MCPEventData(Union):
    _fields_ = [("reserved", _EventReserved),
                ("motion_data", _EventMotionData),
                ("system_error", _EventSystemError),
                ("sensor_module_data", _EventSensorModuleData)]


class MCPEvent(Structure):
    _fields_ = [("size", c_uint32), ("event_type", c_int32),
                ("timestamp", c_double), ("event_data", MCPEventData)]


# ---------------------------------------------------------------------------
# Procedure tables (struct-of-function-pointers vendor ABI; field order is
# the ABI — identical to mocap_api.py's CFUNCTYPE tables)
# ---------------------------------------------------------------------------

_E = c_int32   # every vendor function returns an EMCPError


class _ApplicationTable(Structure):
    VERSION = b"PROC_TABLE:IMCPApplication_002"
    _fields_ = [
        ("CreateApplication", CFUNCTYPE(_E, POINTER(_Handle))),
        ("DestroyApplication", CFUNCTYPE(_E, _Handle)),
        ("SetApplicationSettings", CFUNCTYPE(_E, _Handle, _Handle)),
        ("SetApplicationRenderSettings", CFUNCTYPE(_E, _Handle, _Handle)),
        ("OpenApplication", CFUNCTYPE(_E, _Handle)),
        ("EnableApplicationCacheEvents", CFUNCTYPE(_E, _Handle)),
        ("DisableApplicationCacheEvents", CFUNCTYPE(_E, _Handle)),
        ("ApplicationCacheEventsIsEnabled",
         CFUNCTYPE(_E, POINTER(c_bool), _Handle)),
        ("CloseApplication", CFUNCTYPE(_E, _Handle)),
        ("GetApplicationRigidBodies",
         CFUNCTYPE(_E, POINTER(_Handle), POINTER(c_uint32), _Handle)),
        ("GetApplicationAvatars",
         CFUNCTYPE(_E, POINTER(_Handle), POINTER(c_uint32), _Handle)),
        ("PollApplicationNextEvent",
         CFUNCTYPE(_E, POINTER(MCPEvent), POINTER(c_uint32), _Handle)),
        ("GetApplicationSensorModules",
         CFUNCTYPE(_E, POINTER(_Handle), POINTER(c_uint32), _Handle)),
    ]


class _SettingsTable(Structure):
    VERSION = b"PROC_TABLE:IMCPSettings_001"
    _fields_ = [
        ("CreateSettings", CFUNCTYPE(_E, POINTER(_Handle))),
        ("DestroySettings", CFUNCTYPE(_E, _Handle)),
        ("SetSettingsUDP", CFUNCTYPE(_E, c_uint16, _Handle)),
        ("SetSettingsTCP", CFUNCTYPE(_E, c_char_p, c_uint16, _Handle)),
        ("SetSettingsBvhRotation", CFUNCTYPE(_E, c_int32, _Handle)),
        ("SetSettingsBvhTransformation", CFUNCTYPE(_E, c_int32, _Handle)),
        ("SetSettingsBvhData", CFUNCTYPE(_E, c_int32, _Handle)),
        ("SetSettingsCalcData", CFUNCTYPE(_E, _Handle)),
        ("SetSettingsUDPServer", CFUNCTYPE(_E, c_char_p, c_uint16, _Handle)),
    ]


class _SensorModuleTable(Structure):
    VERSION = b"PROC_TABLE:IMCPSensorModule_001"
    _FP = POINTER(c_float)
    _fields_ = [
        ("GetSensorModulePosture",
         CFUNCTYPE(_E, _FP, _FP, _FP, _FP, _Handle)),
        ("GetSensorModuleAngularVelocity",
         CFUNCTYPE(_E, _FP, _FP, _FP, _Handle)),
        ("GetSensorModuleAcceleratedVelocity",
         CFUNCTYPE(_E, _FP, _FP, _FP, _Handle)),
        ("GetSensorModuleId", CFUNCTYPE(_E, POINTER(c_uint32), _Handle)),
        ("GetSensorModuleCompassValue",
         CFUNCTYPE(_E, _FP, _FP, _FP, _Handle)),
        ("GetSensorModuleTemperature", CFUNCTYPE(_E, _FP, _Handle)),
    ]


class _AvatarTable(Structure):
    VERSION = b"PROC_TABLE:IMCPAvatar_003"
    _fields_ = [
        ("GetAvatarIndex", CFUNCTYPE(_E, POINTER(c_uint32), _Handle)),
        ("GetAvatarRootJoint", CFUNCTYPE(_E, POINTER(_Handle), _Handle)),
        ("GetAvatarJoints",
         CFUNCTYPE(_E, POINTER(_Handle), POINTER(c_uint32), _Handle)),
        ("GetAvatarJointByName",
         CFUNCTYPE(_E, c_char_p, POINTER(_Handle), _Handle)),
        ("GetAvatarName", CFUNCTYPE(_E, POINTER(c_char_p), _Handle)),
        ("GetAvatarRigidBodies",
         CFUNCTYPE(_E, POINTER(_Handle), POINTER(c_uint32), _Handle)),
        ("GetAvatarJointHierarchy", CFUNCTYPE(_E, POINTER(c_char_p))),
        ("GetAvatarPostureIndex",
         CFUNCTYPE(_E, POINTER(c_uint32), POINTER(_Handle))),
        ("GetAvatarPostureTimeCode",
         CFUNCTYPE(_E, POINTER(c_uint32), POINTER(c_uint32),
                   POINTER(c_uint32), POINTER(c_uint32), POINTER(_Handle))),
    ]


class _JointTable(Structure):
    VERSION = b"PROC_TABLE:IMCPJoint_003"
    _FP = POINTER(c_float)
    _fields_ = [
        ("GetJointName", CFUNCTYPE(_E, POINTER(c_char_p), _Handle)),
        ("GetJointLocalRotation",
         CFUNCTYPE(_E, _FP, _FP, _FP, _FP, _Handle)),
        ("GetJointLocalRotationByEuler",
         CFUNCTYPE(_E, _FP, _FP, _FP, _Handle)),
        ("GetJointLocalPosition", CFUNCTYPE(_E, _FP, _FP, _FP, _Handle)),
        ("GetJointDefaultLocalPosition",
         CFUNCTYPE(_E, _FP, _FP, _FP, _Handle)),
        ("GetJointChild",
         CFUNCTYPE(_E, POINTER(_Handle), POINTER(c_uint32), _Handle)),
        ("GetJointBodyPart", CFUNCTYPE(_E, POINTER(_Handle), _Handle)),
        ("GetJointSensorModule", CFUNCTYPE(_E, POINTER(_Handle), _Handle)),
        ("GetJointTag", CFUNCTYPE(_E, POINTER(c_int32), _Handle)),
        ("GetJointNameByTag", CFUNCTYPE(_E, POINTER(c_char_p), c_int32)),
        ("GetJointChildJointTag",
         CFUNCTYPE(_E, POINTER(c_int32), POINTER(c_uint32), c_int32)),
        ("GetJointParentJointTag", CFUNCTYPE(_E, POINTER(c_int32), c_int32)),
    ]


class _RigidBodyTable(Structure):
    VERSION = b"PROC_TABLE:IMCPRigidBody_001"
    _FP = POINTER(c_float)
    _fields_ = [
        ("GetRigidBodyRotation", CFUNCTYPE(_E, _FP, _FP, _FP, _FP, _Handle)),
        ("GetRigidBodyPosition", CFUNCTYPE(_E, _FP, _FP, _FP, _Handle)),
        ("GetRigidBodyStatus", CFUNCTYPE(_E, POINTER(c_int32), _Handle)),
        ("GetRigidBodyId", CFUNCTYPE(_E, POINTER(c_int32), _Handle)),
        ("GetRigidBodyJointTag", CFUNCTYPE(_E, POINTER(c_int32), _Handle)),
    ]


# ---------------------------------------------------------------------------
# Library loader + object wrappers
# ---------------------------------------------------------------------------


_DEFAULT_LIB_NAMES = ("MocapApi.dll", "libMocapApi.so", "libMocapApi.dylib")


class MocapLib:
    r"""Loads a MocapApi shared library and caches its procedure tables
    (the reference stores tables as class attributes, mocap_api.py:132 —
    per-library caching here lets a real vendor library and the test mock
    coexist in one process)."""

    def __init__(self, lib_path: Optional[str] = None):
        if lib_path is None:
            here = os.path.join(os.path.dirname(__file__), "lib")
            for name in _DEFAULT_LIB_NAMES:
                cand = os.path.join(here, name)
                if os.path.exists(cand):
                    lib_path = cand
                    break
        if lib_path is None or not os.path.exists(lib_path):
            raise FileNotFoundError(
                "Noitom MocapApi vendor library not found (searched "
                f"{_DEFAULT_LIB_NAMES} under sensors/lib). This optional IMU "
                "backend needs the vendor SDK; tests use the mock library "
                "built from native/mock_mocap_api.cpp.")
        self.lib_path = lib_path
        self.cdll = ctypes.cdll.LoadLibrary(lib_path)
        self.cdll.MCPGetGenericInterface.restype = c_int32
        self.cdll.MCPGetGenericInterface.argtypes = [c_char_p,
                                                     ctypes.c_void_p]
        self._tables: Dict[bytes, object] = {}

    def table(self, table_type):
        r"""Fetch (and cache) one interface procedure table."""
        key = table_type.VERSION
        if key not in self._tables:
            ptr = POINTER(table_type)()
            err = self.cdll.MCPGetGenericInterface(
                c_char_p(key), ctypes.cast(pointer(ptr), ctypes.c_void_p))
            _check(err, f"MCPGetGenericInterface({key.decode()})")
            self._tables[key] = ptr
        return self._tables[key].contents


class MCPSettings:
    r"""Connection settings (mocap_api.py:663-773)."""

    def __init__(self, lib: MocapLib):
        self._api = lib.table(_SettingsTable)
        self.handle = _Handle()
        _check(self._api.CreateSettings(pointer(self.handle)),
               "CreateSettings")

    def set_udp(self, local_port: int):
        _check(self._api.SetSettingsUDP(c_uint16(local_port), self.handle),
               "SetSettingsUDP")

    def set_tcp(self, ip: str, port: int):
        _check(self._api.SetSettingsTCP(ip.encode(), c_uint16(port),
                                        self.handle), "SetSettingsTCP")

    def set_bvh_rotation(self, order: int):
        _check(self._api.SetSettingsBvhRotation(c_int32(order), self.handle),
               "SetSettingsBvhRotation")

    def set_calc_data(self):
        _check(self._api.SetSettingsCalcData(self.handle),
               "SetSettingsCalcData")

    def set_udp_server(self, ip: str, port: int):
        _check(self._api.SetSettingsUDPServer(ip.encode(), c_uint16(port),
                                              self.handle),
               "SetSettingsUDPServer")

    def destroy(self):
        _check(self._api.DestroySettings(self.handle), "DestroySettings")


class MCPSensorModule:
    r"""One IMU sensor (mocap_api.py:184-258)."""

    def __init__(self, lib: MocapLib, handle):
        self._api = lib.table(_SensorModuleTable)
        self.handle = _Handle(handle) if not isinstance(handle, _Handle) \
            else handle

    def get_posture(self):
        w, x, y, z = c_float(), c_float(), c_float(), c_float()
        _check(self._api.GetSensorModulePosture(
            pointer(w), pointer(x), pointer(y), pointer(z), self.handle),
            "GetSensorModulePosture")
        return w.value, x.value, y.value, z.value

    def get_angular_velocity(self):
        x, y, z = c_float(), c_float(), c_float()
        _check(self._api.GetSensorModuleAngularVelocity(
            pointer(x), pointer(y), pointer(z), self.handle),
            "GetSensorModuleAngularVelocity")
        return x.value, y.value, z.value

    def get_accelerated_velocity(self):
        x, y, z = c_float(), c_float(), c_float()
        _check(self._api.GetSensorModuleAcceleratedVelocity(
            pointer(x), pointer(y), pointer(z), self.handle),
            "GetSensorModuleAcceleratedVelocity")
        return x.value, y.value, z.value

    def get_id(self) -> int:
        i = c_uint32()
        _check(self._api.GetSensorModuleId(pointer(i), self.handle),
               "GetSensorModuleId")
        return i.value

    def get_compass_value(self):
        x, y, z = c_float(), c_float(), c_float()
        _check(self._api.GetSensorModuleCompassValue(
            pointer(x), pointer(y), pointer(z), self.handle),
            "GetSensorModuleCompassValue")
        return x.value, y.value, z.value

    def get_temperature(self) -> float:
        t = c_float()
        _check(self._api.GetSensorModuleTemperature(pointer(t), self.handle),
               "GetSensorModuleTemperature")
        return t.value


class MCPJoint:
    r"""One skeleton joint (mocap_api.py:312-442)."""

    def __init__(self, lib: MocapLib, handle):
        self._lib = lib
        self._api = lib.table(_JointTable)
        self.handle = _Handle(handle) if not isinstance(handle, _Handle) \
            else handle

    def get_name(self) -> str:
        s = c_char_p()
        _check(self._api.GetJointName(pointer(s), self.handle),
               "GetJointName")
        return s.value.decode()

    def get_local_rotation(self):
        x, y, z, w = c_float(), c_float(), c_float(), c_float()
        _check(self._api.GetJointLocalRotation(
            pointer(x), pointer(y), pointer(z), pointer(w), self.handle),
            "GetJointLocalRotation")
        return w.value, x.value, y.value, z.value

    def get_local_position(self):
        x, y, z = c_float(), c_float(), c_float()
        _check(self._api.GetJointLocalPosition(
            pointer(x), pointer(y), pointer(z), self.handle),
            "GetJointLocalPosition")
        return x.value, y.value, z.value

    def get_default_local_position(self):
        x, y, z = c_float(), c_float(), c_float()
        _check(self._api.GetJointDefaultLocalPosition(
            pointer(x), pointer(y), pointer(z), self.handle),
            "GetJointDefaultLocalPosition")
        return x.value, y.value, z.value

    def get_children(self) -> List["MCPJoint"]:
        n = c_uint32()
        _check(self._api.GetJointChild(POINTER(_Handle)(), pointer(n),
                                       self.handle), "GetJointChild")
        handles = (_Handle * n.value)()
        _check(self._api.GetJointChild(handles, pointer(n), self.handle),
               "GetJointChild")
        return [MCPJoint(self._lib, handles[i]) for i in range(n.value)]

    def get_sensor_module(self) -> MCPSensorModule:
        h = _Handle()
        _check(self._api.GetJointSensorModule(pointer(h), self.handle),
               "GetJointSensorModule")
        return MCPSensorModule(self._lib, h)

    def get_tag(self) -> int:
        t = c_int32()
        _check(self._api.GetJointTag(pointer(t), self.handle), "GetJointTag")
        return t.value


class MCPRigidBody:
    r"""Tracked rigid body (mocap_api.py:119-180)."""

    def __init__(self, lib: MocapLib, handle):
        self._api = lib.table(_RigidBodyTable)
        self.handle = _Handle(handle) if not isinstance(handle, _Handle) \
            else handle

    def get_rotation(self):
        x, y, z, w = c_float(), c_float(), c_float(), c_float()
        _check(self._api.GetRigidBodyRotation(
            pointer(x), pointer(y), pointer(z), pointer(w), self.handle),
            "GetRigidBodyRotation")
        return w.value, x.value, y.value, z.value

    def get_position(self):
        x, y, z = c_float(), c_float(), c_float()
        _check(self._api.GetRigidBodyPosition(
            pointer(x), pointer(y), pointer(z), self.handle),
            "GetRigidBodyPosition")
        return x.value, y.value, z.value

    def get_joint_tag(self) -> int:
        t = c_int32()
        _check(self._api.GetRigidBodyJointTag(pointer(t), self.handle),
               "GetRigidBodyJointTag")
        return t.value


class MCPAvatar:
    r"""Full-body avatar (mocap_api.py:445-574)."""

    def __init__(self, lib: MocapLib, handle):
        self._lib = lib
        self._api = lib.table(_AvatarTable)
        self.handle = _Handle(handle) if not isinstance(handle, _Handle) \
            else handle

    def get_index(self) -> int:
        i = c_uint32()
        _check(self._api.GetAvatarIndex(pointer(i), self.handle),
               "GetAvatarIndex")
        return i.value

    def get_name(self) -> str:
        s = c_char_p()
        _check(self._api.GetAvatarName(pointer(s), self.handle),
               "GetAvatarName")
        return s.value.decode()

    def get_root_joint(self) -> MCPJoint:
        h = _Handle()
        _check(self._api.GetAvatarRootJoint(pointer(h), self.handle),
               "GetAvatarRootJoint")
        return MCPJoint(self._lib, h)

    def get_joints(self) -> List[MCPJoint]:
        n = c_uint32()
        _check(self._api.GetAvatarJoints(POINTER(_Handle)(), pointer(n),
                                         self.handle), "GetAvatarJoints")
        handles = (_Handle * n.value)()
        _check(self._api.GetAvatarJoints(handles, pointer(n), self.handle),
               "GetAvatarJoints")
        return [MCPJoint(self._lib, handles[i]) for i in range(n.value)]


class MCPApplication:
    r"""Application lifecycle + event polling (mocap_api.py:884-1016)."""

    def __init__(self, lib: MocapLib):
        self.lib = lib
        self._api = lib.table(_ApplicationTable)
        self.handle = _Handle()
        _check(self._api.CreateApplication(pointer(self.handle)),
               "CreateApplication")
        self._is_opened = False

    def set_settings(self, settings: MCPSettings):
        _check(self._api.SetApplicationSettings(settings.handle, self.handle),
               "SetApplicationSettings")

    def open(self):
        _check(self._api.OpenApplication(self.handle), "OpenApplication")
        self._is_opened = True

    def is_opened(self) -> bool:
        return self._is_opened

    def close(self):
        _check(self._api.CloseApplication(self.handle), "CloseApplication")
        self._is_opened = False

    def destroy(self):
        _check(self._api.DestroyApplication(self.handle),
               "DestroyApplication")

    def get_avatars(self) -> List[MCPAvatar]:
        n = c_uint32()
        _check(self._api.GetApplicationAvatars(POINTER(_Handle)(),
                                               pointer(n), self.handle),
               "GetApplicationAvatars")
        handles = (_Handle * n.value)()
        _check(self._api.GetApplicationAvatars(handles, pointer(n),
                                               self.handle),
               "GetApplicationAvatars")
        return [MCPAvatar(self.lib, handles[i]) for i in range(n.value)]

    def get_sensor_modules(self) -> List[MCPSensorModule]:
        n = c_uint32()
        _check(self._api.GetApplicationSensorModules(
            POINTER(_Handle)(), pointer(n), self.handle),
            "GetApplicationSensorModules")
        handles = (_Handle * n.value)()
        _check(self._api.GetApplicationSensorModules(handles, pointer(n),
                                                     self.handle),
               "GetApplicationSensorModules")
        return [MCPSensorModule(self.lib, handles[i]) for i in range(n.value)]

    def poll_next_event(self, max_events: int = 100) -> List[MCPEvent]:
        n = c_uint32(max_events)
        events = (MCPEvent * max_events)()
        for i in range(max_events):
            events[i].size = sizeof(MCPEvent)
        err = self._api.PollApplicationNextEvent(events, pointer(n),
                                                 self.handle)
        if err not in (MCPError.NoError, MCPError.MoreEvent,
                       MCPError.NoneMessage):
            raise MocapApiError("PollApplicationNextEvent", err)
        return [events[i] for i in range(n.value)]


# ---------------------------------------------------------------------------
# High-level sensor source
# ---------------------------------------------------------------------------


@dataclass
class NoitomFrame:
    timestamp: float
    quat_wxyz: np.ndarray   # [n_sensors, 4]
    acc: np.ndarray         # [n_sensors, 3]


class NoitomSensorSet:
    r"""The 6-IMU polling loop (reference mocap_api.py:1020-1041): open the
    app in sensor (calc-data) mode over UDP, discover sensor modules from
    SensorModulesUpdated events, then poll postures/accelerations into
    :class:`NoitomFrame` records usable by the IMU bridge."""

    def __init__(self, lib_path: Optional[str] = None, udp_port: int = 7777,
                 n_sensors: int = 6):
        self.lib = MocapLib(lib_path)
        self.n_sensors = n_sensors
        self.udp_port = udp_port
        self.app: Optional[MCPApplication] = None
        self.sensors: List[Optional[MCPSensorModule]] = [None] * n_sensors

    def connect(self, max_polls: int = 1000):
        self.app = MCPApplication(self.lib)
        settings = MCPSettings(self.lib)
        settings.set_udp(self.udp_port)
        settings.set_calc_data()
        self.app.set_settings(settings)
        self.app.open()
        polls = 0
        while not all(s is not None for s in self.sensors):
            events = self.app.poll_next_event()
            for evt in events:
                if evt.event_type == MCPEventType.SensorModulesUpdated:
                    sm = MCPSensorModule(
                        self.lib,
                        evt.event_data.sensor_module_data.sensor_module_handle)
                    idx = sm.get_id() - 1
                    if 0 <= idx < self.n_sensors:
                        self.sensors[idx] = sm
            polls += 1
            if polls > max_polls:
                missing = [i for i, s in enumerate(self.sensors) if s is None]
                raise TimeoutError(
                    f"sensors {missing} not discovered after {max_polls} "
                    f"polls")
        return self

    def poll(self) -> NoitomFrame:
        if self.app is None:
            raise RuntimeError("not connected; call connect() first")
        events = self.app.poll_next_event()
        t = max((e.timestamp for e in events), default=0.0)
        quat = np.zeros((self.n_sensors, 4), np.float32)
        acc = np.zeros((self.n_sensors, 3), np.float32)
        for i, s in enumerate(self.sensors):
            quat[i] = s.get_posture()
            acc[i] = s.get_accelerated_velocity()
        return NoitomFrame(timestamp=float(t), quat_wxyz=quat, acc=acc)

    def close(self):
        if self.app is not None:
            self.app.close()
            self.app.destroy()
            self.app = None


class MocapApi:
    r"""Back-compat facade over :class:`NoitomSensorSet` (the round-1 stub's
    public names)."""

    def __init__(self, lib_path: Optional[str] = None):
        self.lib_path = lib_path
        self._set: Optional[NoitomSensorSet] = None

    def connect(self, host: str = "127.0.0.1", port: int = 7777):
        self._set = NoitomSensorSet(self.lib_path, udp_port=port)
        self._set.connect()
        return self

    def poll(self) -> Optional[NoitomFrame]:
        if self._set is None:
            raise RuntimeError("not connected")
        return self._set.poll()

    def close(self):
        if self._set is not None:
            self._set.close()
            self._set = None

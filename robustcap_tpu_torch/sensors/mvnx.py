r"""MVNX (Xsens motion export XML) reader; a copy of
``robustcap_tpu/sensors/mvnx.py`` (standard-library XML, numpy).

Rebuild of the reference's ``articulate/utils/xsens/mvnx_reader.py`` with the
full output schema: joint kinematics (orientation/position/velocity/
acceleration/angular velocity/angular acceleration), IMU measurements
(orientation, free acceleration, magnetic field, and the sign-fixed mean
quaternion-offset **calibrated orientation**), foot contacts, center of
mass, timestamps, and the special T-pose frames — everything converted into
the SMPL coordinate frame by the axis cycle R = [[0,1,0],[0,0,1],[1,0,0]]
(mvnx_reader.py:168-207). Parses by TAG NAME (robust to extra children)
instead of the reference's positional child indices; cross-checked against
the reference reader in tests. Uses the standard-library XML parser, numpy
outputs.

For minimal files the flat convenience keys of the earlier reader
(``segment_names``/``sensor_names``/``frame_rate``/``orientation``/
``position``/``sensor_orientation``/``sensor_acceleration`` — RAW mvnx
frame, no conversion) are still emitted.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, Optional

import numpy as np

__all__ = ["read_mvnx"]

N_CALIBRATION_FRAMES = 150


def _local(tag: str) -> str:
    return tag.split("}")[-1]


def _axis_cycle_points(p: np.ndarray) -> np.ndarray:
    r"""smpl_point = R mvnx_point with R = [[0,1,0],[0,0,1],[1,0,0]]."""
    return np.stack([p[..., 1], p[..., 2], p[..., 0]], axis=-1)


def _axis_cycle_quats(q: np.ndarray) -> np.ndarray:
    r"""smpl_R = R mvnx_R R^T: cycles the quaternion vector part."""
    return np.stack([q[..., 0], q[..., 2], q[..., 3], q[..., 1]], axis=-1)


def _qmul(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    w1, v1 = q1[..., :1], q1[..., 1:]
    w2, v2 = q2[..., :1], q2[..., 1:]
    v = np.cross(v1, v2) + w1 * v2 + w2 * v1
    w = w1 * w2 - (v1 * v2).sum(-1, keepdims=True)
    return np.concatenate([w, v], axis=-1)


def _qinv(q: np.ndarray) -> np.ndarray:
    out = q.copy()
    out[..., 1:] *= -1
    return out


def _qnorm(q: np.ndarray) -> np.ndarray:
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _calibrated_orientation(imu_q: np.ndarray, joint_q: np.ndarray,
                            imu_idx, n_frames: int = N_CALIBRATION_FRAMES
                            ) -> np.ndarray:
    r"""Sensor-to-segment calibration from the first frames
    (mvnx_reader.py:209-217): per-IMU mean quaternion offset between the
    sensor orientation and its segment's orientation, with a per-frame sign
    fix on the dominant component before averaging."""
    q_off = _qmul(_qinv(imu_q[:n_frames]),
                  joint_q[:n_frames][:, imu_idx])        # [F, I, 4]
    dom = np.abs(q_off).mean(axis=0).argmax(axis=-1)     # [I]
    for i, d in enumerate(dom):
        q_off[:, i] *= np.sign(q_off[:, i, d:d + 1])
    q_off = _qnorm(_qnorm(q_off).mean(axis=0))           # [I, 4]
    return _qmul(imu_q, np.broadcast_to(q_off, imu_q.shape))


# frame child tag -> (group, key, width); width None = flat
_FRAME_FIELDS = {
    "orientation": ("joint", "orientation", 4),
    "position": ("joint", "position", 3),
    "velocity": ("joint", "velocity", 3),
    "acceleration": ("joint", "acceleration", 3),
    "angularVelocity": ("joint", "angular velocity", 3),
    "angularAcceleration": ("joint", "angular acceleration", 3),
    "footContacts": ("foot contact", "label", None),
    "sensorFreeAcceleration": ("imu", "free acceleration", 3),
    "sensorMagneticField": ("imu", "magnetic field", 3),
    "sensorOrientation": ("imu", "orientation", 4),
    "centerOfMass": (None, "center of mass", 3),
}


def read_mvnx(path: str) -> Dict:
    r"""Parse an MVNX file into the reference reader's dict schema (numpy):

    ``framerate``, ``timestamp ms`` [T], ``center of mass`` [T, 3],
    ``joint`` {name + 6 kinematic arrays [T, J, *]},
    ``imu`` {name, orientation/free acceleration/magnetic field +
    ``calibrated orientation``}, ``foot contact`` {name, label},
    ``tpose`` {type: {orientation, position}} — all in the SMPL frame.
    """
    root = ET.parse(path).getroot()
    out: Dict = {"segment_names": [], "sensor_names": [], "frame_rate": 60.0}
    contacts = []
    frames = []      # list of dicts: tag -> flat float array
    tposes = {}
    timestamps = []

    for el in root.iter():
        tag = _local(el.tag)
        if tag == "segment" and el.get("label"):
            out["segment_names"].append(el.get("label"))
        elif tag == "sensor" and el.get("label"):
            out["sensor_names"].append(el.get("label"))
        elif tag == "contactDefinition" and el.get("label"):
            contacts.append(el.get("label"))
        elif tag == "subject" and el.get("frameRate"):
            out["frame_rate"] = float(el.get("frameRate"))
        elif tag == "frame":
            fields = {}
            for child in el:
                if child.text and child.text.strip():
                    fields[_local(child.tag)] = np.fromstring(child.text,
                                                              sep=" ")
            if el.get("type") == "normal":
                frames.append(fields)
                timestamps.append(int(el.get("time", len(timestamps))))
            elif el.get("index", "0") == "" or el.get("type", ""
                                                      ).startswith(("identity",
                                                                    "tpose")):
                tposes[el.get("type")] = fields

    n_joints = max(len(out["segment_names"]), 1)

    def stacked(tag: str, width: Optional[int]) -> Optional[np.ndarray]:
        rows = [f[tag] for f in frames if tag in f]
        if not rows or len(rows) != len(frames):
            return None
        arr = np.stack(rows).astype(np.float32)
        return arr if width is None else arr.reshape(len(rows), -1, width)

    # flat convenience keys (RAW mvnx frame, back-compat)
    for tag, name, width in [("orientation", "orientation", 4),
                             ("position", "position", 3),
                             ("sensorOrientation", "sensor_orientation", 4),
                             ("sensorFreeAcceleration",
                              "sensor_acceleration", 3)]:
        arr = stacked(tag, width)
        if arr is not None:
            out[name] = arr

    # full reference schema (SMPL frame)
    out["framerate"] = int(out["frame_rate"])
    out["timestamp ms"] = np.asarray(timestamps, np.int64)
    joint: Dict = {"name": list(out["segment_names"])}
    imu: Dict = {"name": list(out["sensor_names"])}
    foot: Dict = {"name": contacts}
    for tag, (group, key, width) in _FRAME_FIELDS.items():
        arr = stacked(tag, width)
        if arr is None:
            continue
        if width == 4:
            arr = _axis_cycle_quats(arr)
        elif width == 3 and tag != "footContacts":
            arr = _axis_cycle_points(arr)
        if group == "joint":
            joint[key] = arr
        elif group == "imu":
            imu[key] = arr
        elif group == "foot contact":
            foot[key] = arr
        else:
            out[key] = arr.reshape(len(frames), 3)
    if tposes:
        out["tpose"] = {
            t: {"orientation": _axis_cycle_quats(
                    f["orientation"].astype(np.float32).reshape(n_joints, 4)),
                "position": _axis_cycle_points(
                    f["position"].astype(np.float32).reshape(n_joints, 3))}
            for t, f in tposes.items()
            if "orientation" in f and "position" in f}
    if ("orientation" in imu and "orientation" in joint
            and imu["name"] and all(n in joint["name"] for n in imu["name"])):
        imu_idx = [joint["name"].index(n) for n in imu["name"]]
        imu["calibrated orientation"] = _calibrated_orientation(
            imu["orientation"], joint["orientation"], imu_idx)
    if len(joint) > 1:
        out["joint"] = joint
    if len(imu) > 1:
        out["imu"] = imu
    if "label" in foot:
        out["foot contact"] = foot
    return out

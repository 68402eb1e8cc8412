r"""Interactive debug viewers (optional host GUI backends; port of
``robustcap_tpu/viz/viewers.py``).

Rebuild of the reference's debug-viewer sideband:

* ``RotationViewer`` / ``BulletMotionViewer`` — pybullet 3-D debug scenes
  (articulate/utils/bullet/view_rotation.py:18, view_motion.py:23),
* ``StreamingDataViewer`` — real-time scrolling signal plot
  (articulate/utils/pygame/view_streaming_data.py:15).

GUI backends (pybullet/pygame) are optional; every viewer exposes a
headless ``history`` so pipelines can log through them unconditionally and
tests can assert on the captured data. ``BulletMotionViewer`` runs the
forward kinematics on its body model's device.
"""

from __future__ import annotations

from collections import deque
from typing import List, Sequence

import numpy as np
import torch

from .. import math as M
from ..device import resolve_device
from ..smpl.model import _host

__all__ = ["RotationViewer", "BulletMotionViewer", "StreamingDataViewer",
           "Button", "Slider"]


class _HeadlessMixin:
    def __init__(self):
        self.history: deque = deque(maxlen=10_000)

    def _record(self, item):
        self.history.append(item)


class RotationViewer(_HeadlessMixin):
    r"""Visualize n live rotations as oriented frames."""

    def __init__(self, n: int = 1, order: str = "wxyz"):
        super().__init__()
        self.n = n
        self.order = order
        self._client = None

    def connect(self):
        try:
            import pybullet as p
        except ImportError:
            return self  # headless
        self._client = p.connect(p.GUI)
        return self

    def update_all(self, rotations: Sequence[np.ndarray]):
        self._record([np.asarray(r) for r in rotations])
        if self._client is not None:
            import pybullet as p
            if not hasattr(self, "_items"):
                self._items = {}
            axis_colors = ([1, 0, 0], [0, 1, 0], [0, 0, 1])
            for i, r in enumerate(rotations):
                R = self._to_R(r)
                origin = np.asarray([i * 0.5, 0.0, 0.0])
                # draw the rotated frame axes as three debug lines,
                # replacing the previously returned item ids (not the loop
                # index, which is not a valid debug-item id)
                for a in range(3):
                    end = origin + 0.2 * R[:, a]
                    prev = self._items.get((i, a), -1)
                    kw = ({"replaceItemUniqueId": prev} if prev >= 0 else {})
                    self._items[(i, a)] = p.addUserDebugLine(
                        origin.tolist(), end.tolist(), axis_colors[a],
                        lineWidth=2, **kw)
                label = self._items.get((i, "txt"), -1)
                kw = {"replaceItemUniqueId": label} if label >= 0 else {}
                self._items[(i, "txt")] = p.addUserDebugText(
                    f"R{i}", (origin + [0, 0, 0.25]).tolist(), **kw)

    def _to_R(self, r):
        r = np.asarray(r)
        if r.shape == (3, 3):
            return r
        return M.quaternion_to_rotation_matrix(torch.as_tensor(
            r[None], dtype=torch.float32)).numpy()[0]

    def _to_xyzw(self, r):
        r = np.asarray(r)
        if r.shape == (3, 3):
            q = M.rotation_matrix_to_quaternion(torch.as_tensor(
                r[None], dtype=torch.float32)).numpy()[0]
        else:
            q = r
        return [q[1], q[2], q[3], q[0]]

    def disconnect(self):
        if self._client is not None:
            import pybullet as p
            p.disconnect(self._client)

    def __enter__(self):
        return self.connect()

    def __exit__(self, *a):
        self.disconnect()


class BulletMotionViewer(_HeadlessMixin):
    r"""Multi-subject skeletal motion viewer (reference bullet MotionViewer,
    view_motion.py:23).

    The reference loads a urdf body asset; this builds the skeleton
    procedurally — one sphere body per joint and one capsule body per bone,
    created with pybullet's programmatic shape API — so no licensed asset is
    needed. ``update_all`` runs SMPL FK for every subject at once on the
    body model's device, copies the joints to the host once, and moves
    every primitive (sphere at the joint, capsule at the bone midpoint
    oriented along the bone). Without pybullet the viewer is headless and
    records history only. Without ``body_model`` it uses the process-wide
    ``default_body_model`` on ``device`` (the card by default; pass
    ``device="cpu"`` on a host without one).
    """

    JOINT_RADIUS = 0.035
    BONE_RADIUS = 0.018
    COLORS = [(0.85, 0.35, 0.3, 1), (0.3, 0.5, 0.85, 1), (0.35, 0.8, 0.4, 1),
              (0.9, 0.75, 0.2, 1), (0.7, 0.4, 0.85, 1), (0.4, 0.8, 0.8, 1)]

    def __init__(self, n: int = 1, body_model=None, overlap: bool = True,
                 device="cuda"):
        super().__init__()
        self.n = n
        self.overlap = overlap
        self._client = None
        self._bodies = []          # per subject: (joint_ids, bone_ids)
        self._model = body_model
        self.device = (body_model.device if body_model is not None
                       else resolve_device(device))
        self.offsets = [np.asarray(
            [0.0 if overlap else ((n - 1) / 2 - i) * 1.2, 0.0, 0.0],
            np.float32) for i in range(n)]

    def _body_model(self):
        if self._model is None:
            from ..smpl.model import default_body_model
            self._model = default_body_model(self.device)
        return self._model

    def connect(self):
        try:
            import pybullet as p
        except ImportError:
            return self
        self._client = p.connect(p.GUI)
        p.configureDebugVisualizer(flag=p.COV_ENABLE_Y_AXIS_UP, enable=1)
        model = self._body_model()
        parent = model.parent
        bone = model._bone_vector.cpu().numpy()   # [J, 3] rest bone vectors
        for s in range(self.n):
            color = self.COLORS[s % len(self.COLORS)]
            joints = []
            for _ in range(model.num_joints):
                vs = p.createVisualShape(p.GEOM_SPHERE,
                                         radius=self.JOINT_RADIUS,
                                         rgbaColor=color)
                joints.append(p.createMultiBody(baseMass=0,
                                                baseVisualShapeIndex=vs))
            bones = {}
            for j in range(1, model.num_joints):
                length = max(float(np.linalg.norm(bone[j]))
                             - 2 * self.JOINT_RADIUS, 0.01)
                vs = p.createVisualShape(p.GEOM_CAPSULE,
                                         radius=self.BONE_RADIUS,
                                         length=length, rgbaColor=color)
                bones[j] = (p.createMultiBody(baseMass=0,
                                              baseVisualShapeIndex=vs),
                            parent[j])
            self._bodies.append((joints, bones))
        return self

    @staticmethod
    def _capsule_quat_xyzw(d: np.ndarray):
        r"""Quaternion rotating the capsule's +z axis onto direction d."""
        z = np.asarray([0.0, 0.0, 1.0])
        d = d / max(np.linalg.norm(d), 1e-9)
        axis = np.cross(z, d)
        s = np.linalg.norm(axis)
        c = float(np.dot(z, d))
        if s < 1e-8:
            return [1.0, 0.0, 0.0, 0.0] if c < 0 else [0.0, 0.0, 0.0, 1.0]
        axis = axis / s
        half = np.arctan2(s, c) / 2.0
        sh = np.sin(half)
        return [axis[0] * sh, axis[1] * sh, axis[2] * sh, np.cos(half)]

    def update_all(self, poses: List[np.ndarray], trans: List[np.ndarray]):
        r"""Update every subject from SMPL (pose [24,3,3], tran [3]) —
        semantics of the reference's update_all (view_motion.py:66-75)."""
        assert len(poses) == len(trans) == self.n, (
            "number of motions differs from the viewer's subject count")
        self._record((poses, trans))
        if self._client is None:
            return
        import pybullet as p
        model = self._body_model()
        pose = torch.stack([torch.as_tensor(x).reshape(24, 3, 3)
                            for x in poses]).to(model.device, model._J.dtype)
        joints_all = model.forward_kinematics(pose)[1].cpu().numpy()
        for s, tran in enumerate(trans):
            tran = _host(tran, np.float32).reshape(3) + self.offsets[s]
            jpos = joints_all[s] + tran
            joint_ids, bone_ids = self._bodies[s]
            for j, bid in enumerate(joint_ids):
                p.resetBasePositionAndOrientation(bid, jpos[j].tolist(),
                                                  [0, 0, 0, 1])
            for j, (bid, par) in bone_ids.items():
                mid = (jpos[j] + jpos[par]) / 2.0
                quat = self._capsule_quat_xyzw(jpos[j] - jpos[par])
                p.resetBasePositionAndOrientation(bid, mid.tolist(), quat)

    def disconnect(self):
        if self._client is not None:
            import pybullet as p
            p.disconnect(self._client)
            self._client = None
        self._bodies = []


class Button:
    r"""pybullet debug-GUI button (reference bullet.py:90-121). Headless
    (no pybullet): ``click()`` simulates presses so control flow written
    against buttons stays testable."""

    def __init__(self, name: str, pybullet_server_id: int = 0):
        self.name = name
        self.pid = pybullet_server_id
        self._last = 0
        self._sim_clicks = 0
        try:
            import pybullet as p
            self._btn = p.addUserDebugParameter(f" {name} ", 1, 0, 0,
                                                pybullet_server_id)
        except Exception:
            self._btn = None

    def click(self):
        r"""Simulate one click (headless/testing)."""
        self._sim_clicks += 1

    def num_clicks(self) -> int:
        if self._btn is not None:
            import pybullet as p
            return int(p.readUserDebugParameter(self._btn, self.pid))
        return self._sim_clicks

    def is_click(self) -> bool:
        r"""True when clicked since the last call (bullet.py:104-113)."""
        c = self.num_clicks()
        r = c != self._last
        self._last = c
        return r


class Slider:
    r"""pybullet debug-GUI slider (reference bullet.py:123-160)."""

    def __init__(self, name: str, range=(0.0, 1.0), current=None,
                 pybullet_server_id: int = 0):
        self.name = name
        self.pid = pybullet_server_id
        self._value = float(current if current is not None else range[0])
        try:
            import pybullet as p
            self._sld = p.addUserDebugParameter(
                f" {name} ", range[0], range[1], self._value,
                pybullet_server_id)
        except Exception:
            self._sld = None

    def set(self, value: float):
        r"""Headless setter (the GUI slider drives the value otherwise)."""
        self._value = float(value)

    def get_float(self) -> float:
        if self._sld is not None:
            import pybullet as p
            return float(p.readUserDebugParameter(self._sld, self.pid))
        return self._value

    def get_int(self) -> int:
        return int(round(self.get_float()))


class StreamingDataViewer(_HeadlessMixin):
    r"""Real-time scrolling plot of n scalar channels
    (view_streaming_data.py:15). With pygame available, draws a scrolling
    window; headless, keeps the rolling buffer (``.history``) and exposes
    ``snapshot()`` for offline plotting."""

    def __init__(self, n: int = 1, y_range=(-1.0, 1.0), window: int = 300,
                 size=(640, 360)):
        super().__init__()
        self.n = n
        self.y_range = y_range
        self.window = window
        self.size = size
        self.buf = deque(maxlen=window)
        self._screen = None

    def connect(self):
        try:
            import pygame
            pygame.init()
            self._screen = pygame.display.set_mode(self.size)
        except Exception:
            self._screen = None
        return self

    def plot(self, values: Sequence[float]):
        values = np.asarray(values, np.float32).reshape(self.n)
        self.buf.append(values)
        self._record(values)
        if self._screen is not None:
            self._draw()

    def snapshot(self) -> np.ndarray:
        return (np.stack(self.buf) if self.buf
                else np.zeros((0, self.n), np.float32))

    def _draw(self):
        import pygame
        self._screen.fill((10, 10, 10))
        data = self.snapshot()
        w, h = self.size
        lo, hi = self.y_range
        for c in range(self.n):
            pts = [(int(i * w / self.window),
                    int(h - (v[c] - lo) / (hi - lo) * h))
                   for i, v in enumerate(data)]
            if len(pts) > 1:
                pygame.draw.lines(self._screen,
                                  ((50 + 60 * c) % 256, 200, 90), False,
                                  pts, 1)
        pygame.display.flip()

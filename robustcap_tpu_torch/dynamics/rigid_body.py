r"""Articulated rigid-body dynamics by automatic differentiation (port of
``robustcap_tpu/dynamics/rigid_body.py``).

The reference's RBDL wrapper surface (forward and inverse dynamics, mass
matrix, point Jacobians, CoM, ZMP), derived from the kinetic energy with
``torch.func`` (Lagrangian mechanics) instead of a C++ dynamics library.
Generalized coordinates: ``q = [root_tran (3) | pose axis-angle (24*3)]``.
Bodies are per-bone rigid segments with mass proportional to bone length and
rod inertia about the bone center.

  M(q)          = d^2 T / d qdot^2            (CRBA equivalent)
  tau_id        = M qddot + c(q, qdot) - g(q) (RNEA equivalent)
  qddot_fd      = M^{-1} (tau + g - c)        (forward dynamics)

with the bias c from the classic identity c = d/dt (dT/dqdot) - dT/dq,
evaluated with jvp's. Every quantity is computed on the body model's device
in its dtype; inputs may be numpy arrays or tensors.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, hessian, jacrev, jvp

from .. import math as M
from ..smpl.model import ParametricModel

__all__ = ["GRAVITY", "RigidBodyDynamics"]

# gravity in the SMPL world frame (y up); each instance keeps its own copy on
# the model's device in the model's dtype
GRAVITY = torch.tensor([0.0, -9.81, 0.0])


class RigidBodyDynamics:
    r"""Dynamics quantities for a parametric body model."""

    def __init__(self, model: ParametricModel, total_mass: float = 70.0):
        self.model = model
        j0 = model.get_zero_pose_joint_and_vertex()[0]
        dtype, dev = j0.dtype, j0.device
        j0 = j0.detach().cpu().numpy()
        parent = model.tree.parent
        bone_len = np.array(
            [0.1] + [np.linalg.norm(j0[i] - j0[parent[i]]) + 1e-3
                     for i in range(1, len(parent))])
        mass = bone_len / bone_len.sum() * total_mass
        self.mass = torch.as_tensor(mass, dtype=dtype, device=dev)    # [J]
        self.bone_len = torch.as_tensor(bone_len, dtype=dtype,
                                        device=dev)                   # [J]
        self.gravity = GRAVITY.to(dev, dtype)
        self._parent = torch.as_tensor(model.tree.parent_clamped,
                                       device=dev)
        self.num_q = 3 + model.num_joints * 3

    def _as(self, x):
        return torch.as_tensor(x, dtype=self.mass.dtype,
                               device=self.mass.device)

    # -- kinematics helpers --------------------------------------------------

    def _fk_points(self, q):
        r"""Body COM positions (bone midpoints), global orientations and
        joint positions from q."""
        tran = q[:3]
        pose = M.axis_angle_to_rotation_matrix(q[3:].reshape(-1, 3))
        R_glb, p_glb = self.model.forward_kinematics(pose[None])
        p_glb = p_glb[0] + tran
        com = 0.5 * (p_glb + p_glb[self._parent])
        return com, R_glb[0], p_glb

    def _kinetic_energy(self, q, qdot):
        r"""T = 1/2 sum_b m_b |v_com,b|^2 + rotational part (rod inertia)."""
        (_, R), (v_com, dR) = jvp(lambda qq: self._fk_points(qq)[:2], (q,),
                                  (qdot,))
        trans_T = 0.5 * (self.mass[:, None] * v_com ** 2).sum()
        # body angular velocity: [w]_x = R^T dR; rod inertia ~ m l^2 / 12
        omega_x = R.transpose(-1, -2) @ dR
        w2 = (omega_x[..., 0, 1] ** 2 + omega_x[..., 0, 2] ** 2
              + omega_x[..., 1, 2] ** 2)
        inertia = self.mass * self.bone_len ** 2 / 12.0
        return trans_T + 0.5 * (inertia * w2).sum()

    def _potential_energy(self, q):
        com = self._fk_points(q)[0]
        return -(self.mass[:, None] * com * self.gravity[None]).sum()

    # -- public API (RBDLModel surface) --------------------------------------

    def mass_matrix(self, q):
        r"""Joint-space inertia matrix M(q) [nq, nq] (model.py mass matrix)."""
        q = self._as(q)
        zero = torch.zeros_like(q)
        return hessian(lambda qd: self._kinetic_energy(q, qd))(zero)

    def bias_force(self, q, qdot):
        r"""Coriolis/centrifugal + gravity generalized forces h(q, qdot)."""
        q, qdot = self._as(q), self._as(qdot)
        dT_dqdot = grad(self._kinetic_energy, argnums=1)
        # d/dt (dT/dqdot) along the trajectory (qdot, qddot=0) minus dT/dq
        _, dt_term = jvp(lambda qq: dT_dqdot(qq, qdot), (q,), (qdot,))
        dq_term = grad(self._kinetic_energy, argnums=0)(q, qdot)
        g_term = grad(self._potential_energy)(q)
        return dt_term - dq_term + g_term

    def inverse_dynamics(self, q, qdot, qddot):
        r"""tau = M qddot + h (RBDLModel inverse_dynamics)."""
        return self.mass_matrix(q) @ self._as(qddot) + self.bias_force(q,
                                                                        qdot)

    def forward_dynamics(self, q, qdot, tau):
        r"""qddot = M^{-1} (tau - h) (RBDLModel forward_dynamics)."""
        Mm = self.mass_matrix(q) + 1e-6 * torch.eye(
            self.num_q, dtype=self.mass.dtype, device=self.mass.device)
        return torch.linalg.solve(Mm, self._as(tau) - self.bias_force(q, qdot))

    def point_jacobian(self, q, joint_id: int):
        r"""d p_joint / d q [3, nq] (RBDLModel jacobian)."""
        return jacrev(lambda qq: self._fk_points(qq)[2][joint_id])(self._as(q))

    def com(self, q):
        r"""Whole-body center of mass [3] (RBDLModel CoM)."""
        c = self._fk_points(self._as(q))[0]
        return (self.mass[:, None] * c).sum(0) / self.mass.sum()

    def zmp(self, q, qdot, qddot, ground_height: float = 0.0):
        r"""Zero-moment point on the ground plane from CoM dynamics
        (RBDLModel ZMP)."""
        q, qdot, qddot = self._as(q), self._as(qdot), self._as(qddot)
        c, _ = jvp(self.com, (q,), (qdot,))
        _, a1 = jvp(lambda qq: jvp(self.com, (qq,), (qdot,))[1], (q,),
                    (qdot,))
        _, a2 = jvp(self.com, (q,), (qddot,))
        a = a1 + a2
        g = -self.gravity[1]
        denom = a[1] + g
        x = c[0] - (c[1] - ground_height) * a[0] / denom
        z = c[2] - (c[1] - ground_height) * a[2] / denom
        return torch.stack([x, torch.full_like(x, ground_height), z])

r"""Differentiable articulated rigid-body dynamics (autodiff Lagrangian)."""

from .rigid_body import RigidBodyDynamics  # noqa: F401

__all__ = ["RigidBodyDynamics"]

r"""Rotation conversions and tree kinematics on torch tensors."""

from .general import *  # noqa: F401,F403
from .angular import *  # noqa: F401,F403
from .spatial import *  # noqa: F401,F403

from . import general, angular, spatial  # noqa: F401

__all__ = general.__all__ + angular.__all__ + spatial.__all__

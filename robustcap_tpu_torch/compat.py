r"""Reference-style namespace facade (port of ``robustcap_tpu/compat.py``).

Users of the reference write ``import articulate as art`` and reach
``art.math.*``, ``art.ParametricModel``, ``art.PositionErrorEvaluator``,
etc. (articulate/__init__). This module reproduces that surface over the
port's PyTorch implementations so existing call sites port with an import
swap:

    from robustcap_tpu_torch import compat as art

    R = art.math.axis_angle_to_rotation_matrix(aa)
    body = art.ParametricModel("models/SMPL_male.pkl")
    err = art.PositionErrorEvaluator()(pred, true)

The body model and the renderer's default model run on the card unless
``device="cpu"`` is passed.
"""

from . import math  # noqa: F401  (art.math.*)
from .smpl import (ParametricModel, SMPLJoint, MANOJoint,  # noqa: F401
                   SMPLHJoint)
from .eval.evaluator import (  # noqa: F401
    BinaryConfusionMatrixEvaluator, BinaryClassificationErrorEvaluator,
    PositionErrorEvaluator, RotationErrorEvaluator, PerJointErrorEvaluator,
    MeanPerJointErrorEvaluator, MeshErrorEvaluator, FullMotionEvaluator)
from .utils.filter import (KalmanFilter, LowPassFilter,  # noqa: F401
                           LowPassFilterRotation)
from .viz.render import Renderer  # noqa: F401

__all__ = [
    "math", "ParametricModel", "SMPLJoint", "MANOJoint", "SMPLHJoint",
    "BinaryConfusionMatrixEvaluator", "BinaryClassificationErrorEvaluator",
    "PositionErrorEvaluator", "RotationErrorEvaluator",
    "PerJointErrorEvaluator", "MeanPerJointErrorEvaluator",
    "MeshErrorEvaluator", "FullMotionEvaluator", "KalmanFilter",
    "LowPassFilter", "LowPassFilterRotation", "Renderer",
]

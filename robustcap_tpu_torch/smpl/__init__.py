r"""SMPL parametric body model on torch tensors, and the joint ids of the
supported armatures."""

from .armature import MANOJoint, SMPLHJoint, SMPLJoint  # noqa: F401
from .model import (ParametricModel, SmplData,  # noqa: F401
                    default_body_model, load_smpl_data, synthetic_smpl_data)

__all__ = ["SMPLJoint", "MANOJoint", "SMPLHJoint", "ParametricModel",
           "SmplData", "default_body_model", "load_smpl_data",
           "synthetic_smpl_data"]

r"""SMPL parametric body model on torch tensors."""

from .model import (ParametricModel, SmplData,  # noqa: F401
                    default_body_model, load_smpl_data, synthetic_smpl_data)

__all__ = ["ParametricModel", "SmplData", "default_body_model",
           "load_smpl_data", "synthetic_smpl_data"]

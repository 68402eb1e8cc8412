r"""SMPL parametric body model on torch tensors."""

from .model import (ParametricModel, SmplData, load_smpl_data,  # noqa: F401
                    synthetic_smpl_data)

__all__ = ["ParametricModel", "SmplData", "load_smpl_data",
           "synthetic_smpl_data"]

r"""Device-side ops: the hand-written CUDA kernels (``csrc/``) behind
wrappers that run their plain PyTorch versions on CPU tensors, Procrustes
and the lane-batched L-BFGS. Importing this package registers the kernels'
operators (``robustcap::geometry_tail``, ``robustcap::serve_scan``,
``robustcap::lstm_cell``), which exported serving programs hold."""

from . import geometry_tail, lstm_cell, serve_scan  # noqa: F401
from .procrustes import (reconstruction_error,  # noqa: F401
                         similarity_transform)

__all__ = ["similarity_transform", "reconstruction_error"]

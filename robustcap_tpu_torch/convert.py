r"""Carrying weights across: the JAX package's parameter pytree, and the
reference's torch checkpoints, as the port's parameter dicts.

Both sides already use torch's layout (``w [out, in]``, ``w_ih [4H, in]``,
gate order i, f, g, o), so conversion is a structural copy.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device, tree_map
from .models.sig_mp import RNN_SPECS
from .nn.rnn import rnn_params_from_torch

__all__ = ["params_from_numpy", "params_from_torch_state_dict",
           "load_torch_checkpoint"]


def params_from_numpy(tree, device):
    r"""The JAX parameter pytree, already converted to numpy by the caller
    (``jax.tree.map(np.array, params)``), as float32 tensors on
    ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda x: torch.tensor(np.array(x, dtype=np.float32),
                                           device=dev), tree)


def params_from_torch_state_dict(state_dict, device="cuda"):
    r"""The reference's merged ``best_weights.pt`` state dict (tensor or
    numpy values) as the six-module parameter dict on ``device``."""
    dev = resolve_device(device)
    return {name: rnn_params_from_torch(state_dict, prefix=f"{name}.",
                                        device=dev)
            for name in RNN_SPECS}


def load_torch_checkpoint(path, device="cuda"):
    r"""Load the reference's ``best_weights.pt`` onto ``device``."""
    state_dict = torch.load(path, map_location="cpu")
    return params_from_torch_state_dict(state_dict, device)

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


def _leaf_from_numpy(x, dev):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        # through float32, which holds every bf16 value exactly
        return torch.tensor(a.astype(np.float32), device=dev).to(
            torch.bfloat16)
    if a.dtype == np.int8:
        return torch.tensor(a, device=dev)
    return torch.tensor(a.astype(np.float32), device=dev)


def params_from_numpy(tree, device):
    r"""The JAX parameter pytree, already converted to numpy by the caller
    (``jax.tree.map(np.array, params)``), as tensors on ``device``. Each
    leaf keeps its kind: bfloat16 arrays become ``torch.bfloat16``, the
    int8 payload of a quantized record stays ``torch.int8``, and every other
    leaf becomes float32."""
    dev = resolve_device(device)
    return tree_map(lambda x: _leaf_from_numpy(x, dev), tree)


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

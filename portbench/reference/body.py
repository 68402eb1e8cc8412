r"""The body-model constants the reference's tail reads, worked out from the
raw body arrays the benchmark made (``portbench/body.py``): the kinematic
tree, the bones and zero-pose joints, and the skinning weights, rest
positions and pose blendshapes of the 33 landmark vertices.

Plain PyTorch; imports nothing of the program.
"""

from __future__ import annotations

import torch

__all__ = ["SMPL_PARENT", "MP_VERTEX_MASK", "constants"]

# SMPL's 24-joint kinematic tree (kintree_table row 0 of the official model)
SMPL_PARENT = (None, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
               16, 17, 18, 19, 20, 21)

# the SMPL mesh vertex of each of the 33 MediaPipe landmarks
MP_VERTEX_MASK = (332, 2809, 2800, 455, 6260, 3634, 3621, 583, 4071, 45, 3557,
                  1873, 4123, 1652, 5177, 2235, 5670, 2673, 6133, 2319, 5782,
                  2746, 6191, 3138, 6528, 1176, 4662, 3381, 6727, 3387, 6787,
                  3226, 6624)


def constants(raw, blendshape: bool):
    r"""``raw``: a dict of the body's tensors on one device (``joints
    [24, 3]``, ``v_template [V, 3]``, ``skinning [V, 24]``, ``posedirs
    [V, 3, 207]``). Returns the tail's constants as float32 tensors on that
    device: ``parent`` (root -> 0), ``anc`` (``anc[i, j] = 1`` where ``j``
    lies on the path from the root to ``i``), ``bone``, ``j0``, ``wsub``,
    ``v0sub`` and, with ``blendshape``, ``pd [3, 207, 33]``."""
    J = raw["joints"].float()
    dev = J.device
    n = len(SMPL_PARENT)
    parent = [0 if p is None else p for p in SMPL_PARENT]
    anc = torch.zeros((n, n), dtype=torch.float32)
    for i in range(n):
        j = i
        while True:
            anc[i, j] = 1.0
            if SMPL_PARENT[j] is None:
                break
            j = SMPL_PARENT[j]
    j0 = J - J[:1]
    bone = j0 - j0[parent]
    bone[0] = j0[0]
    V = raw["v_template"].shape[0]
    ids = torch.tensor([min(max(v, 0), V - 1) for v in MP_VERTEX_MASK],
                       device=dev)
    out = {
        "parent": torch.tensor(parent, device=dev),
        "anc": anc.to(dev),
        "bone": bone,
        "j0": j0,
        "wsub": raw["skinning"].float()[ids],
        "v0sub": raw["v_template"].float()[ids] - J[:1],
        "pd": None,
    }
    if blendshape:
        out["pd"] = raw["posedirs"].float()[ids].permute(1, 2, 0).contiguous()
    return out

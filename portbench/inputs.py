r"""What the benchmark makes from ``--seed`` and hands to the program and to
the reference alike: the network's weights and the procedural body, both
made on the device with a ``torch.Generator`` of the device in a few large
calls.

The weights have the layout of a bank of ``{"linear1": {"w", "b"},
"layers": [{"w_ih", "w_hh", "b_ih", "b_hh"}] * L, "linear2": {"w", "b"}}``
stacks, plus an ``init_net`` of three linears where the configuration asks
for one, each leaf uniform in +-1/sqrt(fan), as PyTorch initialises
``nn.Linear`` and ``nn.LSTM``. Trained weights are not public, so every
configuration assumes random ones.

The body stands in for SMPL, whose files are not public either: 6890
vertices scattered along the 23 bones of SMPL's 24-joint skeleton, each
skinned to its two nearest joints, with SMPL's shapes of pose blendshapes
(207 a vertex and coordinate) and shape blendshapes (10).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["generator", "make_weights", "make_body", "host", "SKELETON"]

# zero-pose joint positions of the procedural body (metres, y up)
SKELETON = (
    (0.000, 0.000, 0.000), (0.070, -0.085, 0.010), (-0.070, -0.085, 0.010),
    (0.000, 0.110, -0.010), (0.105, -0.470, 0.005), (-0.105, -0.470, 0.005),
    (0.000, 0.250, 0.000), (0.090, -0.850, -0.030), (-0.090, -0.850, -0.030),
    (0.000, 0.310, 0.010), (0.110, -0.900, 0.095), (-0.110, -0.900, 0.095),
    (0.000, 0.470, -0.020), (0.080, 0.400, -0.010), (-0.080, 0.400, -0.010),
    (0.000, 0.560, 0.020), (0.180, 0.420, -0.015), (-0.180, 0.420, -0.015),
    (0.440, 0.400, -0.030), (-0.440, 0.400, -0.030), (0.690, 0.400, -0.030),
    (-0.690, 0.400, -0.030), (0.780, 0.395, -0.025), (-0.780, 0.395, -0.025))

_SALTS = {"weights": 1, "body": 2, "traffic": 3, "sample": 4, "stagger": 5,
          "keep": 6}


def generator(seed: int, what: str, device) -> torch.Generator:
    r"""The generator of one kind of input (``weights``, ``body``,
    ``traffic``, ``sample``) for ``seed``, on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 8 + _SALTS[what]) % (1 << 63))
    return g


def _leaf_shapes(spec):
    r"""``(path, shape, bound)`` of every leaf of one stack, in a fixed
    order."""
    i, o, h, L = spec["input"], spec["output"], spec["hidden"], spec["layers"]
    out = [(("linear1", "w"), (h, i), i), (("linear1", "b"), (h,), i)]
    for l in range(L):
        out += [(("layers", l, k), shape, h) for k, shape in
                (("w_ih", (4 * h, h)), ("w_hh", (4 * h, h)),
                 ("b_ih", (4 * h,)), ("b_hh", (4 * h,)))]
    out += [(("linear2", "w"), (o, h), h), (("linear2", "b"), (o,), h)]
    if spec.get("init_net"):
        dims = (o, h, h * L, 2 * L * h)
        for n in range(3):
            out += [(("init_net", n, "w"), (dims[n + 1], dims[n]), dims[n]),
                    (("init_net", n, "b"), (dims[n + 1],), dims[n])]
    return out


def make_weights(stacks, seed: int, device, dtype=torch.float32):
    r"""The bank of ``stacks`` (the configuration's ``{"rnn2": {"input",
    "output", "hidden", "layers", "init_net"}, ...}``) from one draw of
    uniform numbers on ``device``, cast to ``dtype`` (float32 or bfloat16:
    the type the configuration serves). A stack's ``output_offset``, where
    the configuration gives one, is added to its output bias."""
    leaves = [(name, path, shape, bound) for name, spec in stacks.items()
              for path, shape, bound in _leaf_shapes(spec)]
    total = sum(math.prod(s) for _, _, s, _ in leaves)
    flat = torch.rand(total, generator=generator(seed, "weights", device),
                      device=device)
    flat.mul_(2).sub_(1)
    bank = {}
    off = 0
    for name, path, shape, bound in leaves:
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape) * (1.0 / math.sqrt(bound))
        if path == ("linear2", "b") and "output_offset" in stacks[name]:
            leaf = leaf + torch.tensor(stacks[name]["output_offset"],
                                       device=device)
        leaf = leaf.to(dtype)
        off += n
        node = bank.setdefault(name, {})
        for k, nxt in zip(path[:-1], path[1:]):
            if isinstance(k, int):
                while len(node) <= k:
                    node.append({})
            elif k not in node:
                node[k] = [] if isinstance(nxt, int) else {}
            node = node[k]
        node[path[-1]] = leaf
    return bank


def make_body(seed: int, device, num_verts: int = 6890):
    r"""The procedural body as a dict of tensors on ``device``: ``joints
    [24, 3]``, ``v_template [V, 3]``, ``skinning [V, 24]`` (each vertex to
    its two nearest joints), ``j_regressor [24, V]`` (each joint the mean
    of its 8 nearest vertices), ``posedirs [V, 3, 207]``, ``shapedirs
    [V, 3, 10]``, ``faces [2V, 3]``."""
    from .reference.body import SMPL_PARENT
    g = generator(seed, "body", device)
    J = torch.tensor(SKELETON, dtype=torch.float32, device=device)
    child = torch.arange(1, 24, device=device)
    parent = torch.tensor([SMPL_PARENT[c] for c in range(1, 24)],
                          device=device)
    per = num_verts // 23 + 1
    t = torch.rand((23, per, 1), generator=g, device=device)
    pts = J[parent][:, None] * (1 - t) + J[child][:, None] * t
    pts = pts + 0.05 * torch.randn(pts.shape, generator=g, device=device)
    v = pts.reshape(-1, 3)[:num_verts].contiguous()
    d = torch.cdist(v, J)
    w = torch.exp(-d / 0.03)
    top = w.topk(2, dim=1)
    skin = torch.zeros_like(w).scatter_(1, top.indices, top.values)
    skin = skin / skin.sum(1, keepdim=True)
    near = d.topk(8, dim=0, largest=False).indices             # [8, 24]
    jr = torch.zeros((24, num_verts), device=device)
    jr.scatter_(1, near.T, 1.0 / 8.0)
    return {
        "joints": J, "v_template": v, "skinning": skin, "j_regressor": jr,
        "posedirs": 0.001 * torch.randn((num_verts, 3, 207), generator=g,
                                        device=device),
        "shapedirs": 0.01 * torch.randn((num_verts, 3, 10), generator=g,
                                        device=device),
        "faces": torch.randint(0, num_verts, (2 * num_verts, 3), generator=g,
                               device=device, dtype=torch.int32),
    }


def host(body):
    r"""The body's arrays as numpy, for the program's body-model
    constructor, which takes host arrays."""
    return {k: np.asarray(v.cpu().numpy()) for k, v in body.items()}

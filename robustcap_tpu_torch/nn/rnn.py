r"""torch-layout LSTM stacks as plain functions on parameter dicts (port of
the f32 path of ``robustcap_tpu/nn/rnn.py``).

One module is linear1 -> ReLU -> an L-layer LSTM (gate order i, f, g, o;
``w_ih [4H, in]``, ``w_hh [4H, H]``, both biases) -> linear2, plus, for
``RNNWithInit``, a 3-layer MLP regressing the initial (h, c) from a label.
Parameters are nested dicts/lists of tensors in exactly that layout, so the
JAX package's parameter pytree and ``torch.nn.LSTM`` state dicts map one to
one. The bf16/int8 weight modes and the Pure/Cycle variants are not ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "init_linear", "init_lstm_layer", "init_rnn_params", "init_state",
    "lstm_cell", "rnn_step", "rnn_group_step", "rnn_pair_step", "rnn_scan",
    "init_net_apply", "rnn_params_from_torch",
]


def _uniform(gen, shape, bound):
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2 - 1) \
        * bound


def init_linear(gen: torch.Generator, in_size: int, out_size: int):
    bound = 1.0 / math.sqrt(in_size)
    return {"w": _uniform(gen, (out_size, in_size), bound),
            "b": _uniform(gen, (out_size,), bound)}


def init_lstm_layer(gen: torch.Generator, in_size: int, hidden_size: int):
    bound = 1.0 / math.sqrt(hidden_size)
    return {"w_ih": _uniform(gen, (4 * hidden_size, in_size), bound),
            "w_hh": _uniform(gen, (4 * hidden_size, hidden_size), bound),
            "b_ih": _uniform(gen, (4 * hidden_size,), bound),
            "b_hh": _uniform(gen, (4 * hidden_size,), bound)}


def init_rnn_params(gen: torch.Generator, input_size: int, output_size: int,
                    hidden_size: int, num_layers: int = 2,
                    with_init_net: bool = False):
    r"""Random parameters of one module, U(+-1/sqrt(fan)) like torch's
    defaults, drawn on the CPU from ``gen``."""
    params = {
        "linear1": init_linear(gen, input_size, hidden_size),
        "layers": [init_lstm_layer(gen, hidden_size, hidden_size)
                   for _ in range(num_layers)],
        "linear2": init_linear(gen, hidden_size, output_size),
    }
    if with_init_net:
        params["init_net"] = [
            init_linear(gen, output_size, hidden_size),
            init_linear(gen, hidden_size, hidden_size * num_layers),
            init_linear(gen, hidden_size * num_layers,
                        2 * num_layers * hidden_size),
        ]
    return params


def init_state(params, batch_shape=(), dtype=torch.float32):
    r"""Zero (h, c) state: each [num_layers, *batch_shape, hidden] on the
    parameters' device."""
    L = len(params["layers"])
    w_hh = params["layers"][0]["w_hh"]
    shape = (L,) + tuple(batch_shape) + (w_hh.shape[1],)
    return (torch.zeros(shape, dtype=dtype, device=w_hh.device),
            torch.zeros(shape, dtype=dtype, device=w_hh.device))


def _linear(p, x):
    return x @ p["w"].T + p["b"]


def lstm_cell(layer, x, h, c):
    r"""One LSTM cell step, gate order (i, f, g, o)."""
    z = x @ layer["w_ih"].T + h @ layer["w_hh"].T \
        + (layer["b_ih"] + layer["b_hh"])
    i, f, g, o = z.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def rnn_step(params, x, state):
    r"""One frame through linear1 -> ReLU -> LSTM stack -> linear2.
    ``state`` is (h, c), each [L, ..., H]; returns (out, (h, c))."""
    h, c = state
    inp = torch.relu(_linear(params["linear1"], x))
    new_h, new_c = [], []
    for l, layer in enumerate(params["layers"]):
        hn, cn = lstm_cell(layer, inp, h[l], c[l])
        new_h.append(hn)
        new_c.append(cn)
        inp = hn
    out = _linear(params["linear2"], inp)
    return out, (torch.stack(new_h), torch.stack(new_c))


def rnn_group_step(params_seq, x, states):
    r"""N stacks that read the same input, one after another (the JAX
    package batches their matmuls; the values are the same). Returns
    ``(outs, new_states)`` tuples."""
    outs, new_states = [], []
    for p, s in zip(params_seq, states):
        o, ns = rnn_step(p, x, s)
        outs.append(o)
        new_states.append(ns)
    return tuple(outs), tuple(new_states)


def rnn_pair_step(params_a, params_b, x, state_a, state_b):
    r"""Two stacks on one input; returns ``(out_a, out_b, state_a,
    state_b)``."""
    outs, sts = rnn_group_step((params_a, params_b), x, (state_a, state_b))
    return outs[0], outs[1], sts[0], sts[1]


def rnn_scan(params, xs, state0=None):
    r"""A whole sequence, one frame after another: xs [T, ..., in] ->
    (ys [T, ..., out], state)."""
    state = init_state(params, xs.shape[1:-1], xs.dtype) if state0 is None \
        else state0
    ys = []
    for t in range(xs.shape[0]):
        y, state = rnn_step(params, xs[t], state)
        ys.append(y)
    return torch.stack(ys), state


def init_net_apply(params, first_label):
    r"""RNNWithInit's (h0, c0) regression from the first label:
    ``first_label`` [..., out] -> (h, c) each [L, ..., H], in torch's
    ``view(B, 2, L, H).permute(1, 2, 0, 3)`` layout."""
    x = torch.relu(_linear(params["init_net"][0], first_label))
    x = torch.relu(_linear(params["init_net"][1], x))
    x = _linear(params["init_net"][2], x)
    L = len(params["layers"])
    H = params["layers"][0]["w_hh"].shape[1]
    hc = x.reshape(x.shape[:-1] + (2, L, H))
    h = torch.movedim(hc[..., 0, :, :], -2, 0)
    c = torch.movedim(hc[..., 1, :, :], -2, 0)
    return h, c


def rnn_params_from_torch(state_dict, prefix: str = "", device="cpu"):
    r"""One reference RNN module from a torch state_dict (numpy or tensor
    values): ``{prefix}linear1.weight``, ``{prefix}rnn.weight_ih_l{k}``, ...,
    optionally ``{prefix}init_net.{0,2,4}.weight``."""
    def get(name):
        v = state_dict[prefix + name]
        if isinstance(v, torch.Tensor):
            return v.detach().to(device=device, dtype=torch.float32,
                                 copy=True)
        return torch.tensor(np.array(v), dtype=torch.float32, device=device)

    params = {
        "linear1": {"w": get("linear1.weight"), "b": get("linear1.bias")},
        "linear2": {"w": get("linear2.weight"), "b": get("linear2.bias")},
        "layers": [],
    }
    k = 0
    while (prefix + f"rnn.weight_ih_l{k}") in state_dict:
        params["layers"].append({
            "w_ih": get(f"rnn.weight_ih_l{k}"),
            "w_hh": get(f"rnn.weight_hh_l{k}"),
            "b_ih": get(f"rnn.bias_ih_l{k}"),
            "b_hh": get(f"rnn.bias_hh_l{k}"),
        })
        k += 1
    if (prefix + "init_net.0.weight") in state_dict:
        params["init_net"] = [
            {"w": get(f"init_net.{i}.weight"), "b": get(f"init_net.{i}.bias")}
            for i in (0, 2, 4)
        ]
    return params

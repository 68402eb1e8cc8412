r"""torch-layout LSTM stacks as plain functions on parameter dicts (port of
``robustcap_tpu/nn/rnn.py``).

One module is linear1 -> ReLU -> an L-layer LSTM (gate order i, f, g, o;
``w_ih [4H, in]``, ``w_hh [4H, H]``, both biases) -> linear2, plus, for
``RNNWithInit``, a 3-layer MLP regressing the initial (h, c) from a label.
Parameters are nested dicts/lists of tensors in exactly that layout, so the
JAX package's parameter pytree and ``torch.nn.LSTM`` state dicts map one to
one.

Weights come in three kinds, with the JAX package's rules: float32;
bfloat16 (:func:`cast_params`), where the step computes in bf16 and returns
the input's dtype; and int8 (:func:`quantize_params`), where every 2-D
weight is a ``{"q": int8 [out, in], "scale": f32 [out, 1]}`` record that is
dequantized to bf16 for compute, or, with ``int8_compute``, whose gate
matrices meet dynamically quantized activations in an int8 x int8 product
with int32 sums.

Training runs :func:`rnn_forward_padded` over padded [T, B, in] batches with
a ``lengths`` vector: ``torch.nn.LSTM`` (cuDNN on the card) over a packed
sequence, so each row's output stops and its (h, c) freezes at its length,
as in the reference (``pack_padded_sequence``); dropout after linear1's
ReLU and between LSTM layers. :func:`rnn_forward_padded_plain` is the same
function as a per-frame loop over :func:`rnn_step`, kept as the reference
the cuDNN path is held against. The PureRNN (an LSTM with ``proj_size``)
and CycleRNN (autoregressive) variants have padded forwards too.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from ..device import resolve_device, tree_map

__all__ = [
    "init_linear", "init_lstm_layer", "init_rnn_params", "init_state",
    "lstm_cell", "rnn_step", "rnn_group_step", "rnn_pair_step", "rnn_scan",
    "rnn_forward_padded", "rnn_forward_padded_plain", "init_net_apply",
    "rnn_params_from_torch", "pure_rnn_params_from_torch",
    "pure_rnn_forward_padded", "cycle_rnn_params_from_torch",
    "cycle_rnn_forward_padded", "cast_params",
    "quantize_tensor", "dequantize_tensor", "quantize_params",
    "dequantize_params", "dequantize_non_gate_params", "is_quantized",
    "quantize_activation", "prepare_scan_params",
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


# ---------------------------------------------------------------------------
# Weight kinds: bf16 casts and int8 records
# ---------------------------------------------------------------------------

_QUANT_KEYS = {"q", "scale"}


def _is_qtensor(x) -> bool:
    return isinstance(x, dict) and set(x) == _QUANT_KEYS


def _leaves(tree):
    if _is_qtensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def is_quantized(params) -> bool:
    r"""True if ``params`` (any nesting) holds int8-quantized weights."""
    return any(_is_qtensor(leaf) for leaf in _leaves(params))


def cast_params(params, dtype):
    r"""Floating-point leaves cast to ``dtype``; a quantized tree is returned
    as it is (casting its payload would dequantize it)."""
    if is_quantized(params):
        return params
    return tree_map(lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
                    and x.is_floating_point() else x, params)


def quantize_tensor(w):
    r"""Symmetric per-output-channel int8 quantization of ``w [out, in]`` ->
    ``{"q": int8 [out, in], "scale": f32 [out, 1]}``. The row max and the
    scale are taken in ``w``'s dtype, as the JAX function does."""
    amax = w.abs().amax(-1, keepdim=True)
    scale = (torch.clamp_min(amax, 1e-12) / 127.0).to(torch.float32)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def dequantize_tensor(w, dtype=torch.float32):
    r"""Inverse of :func:`quantize_tensor` (up to rounding), computed in
    ``dtype``."""
    return w["q"].to(dtype) * w["scale"].to(dtype)


def quantize_params(params):
    r"""Every 2-D floating weight of a tree (one module or the six-module
    bank) as an int8 record; biases stay as they are. Idempotent."""
    def q(x):
        if _is_qtensor(x):
            return x
        if isinstance(x, torch.Tensor) and x.dim() == 2 \
                and x.is_floating_point():
            return quantize_tensor(x)
        return x
    return tree_map(q, params, is_leaf=_is_qtensor)


def dequantize_params(params, dtype=torch.bfloat16):
    r"""Every int8 record as a dense ``dtype`` tensor; an unquantized tree is
    returned as it is."""
    if not is_quantized(params):
        return params
    return tree_map(lambda x: dequantize_tensor(x, dtype) if _is_qtensor(x)
                    else x, params, is_leaf=_is_qtensor)


def quantize_activation(x):
    r"""Dynamic symmetric per-row int8 quantization ``x [..., K] -> (q int8
    [..., K], scale f32 [..., 1])``; the row max in ``x``'s dtype, the rest
    in float32. ``torch.round`` rounds half to even, as ``jnp.round``."""
    amax = x.abs().amax(-1, keepdim=True)
    scale = torch.clamp_min(amax.to(torch.float32), 1e-12) / 127.0
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8), scale


def _dot_i8(xq, wq):
    r"""``xq [..., K] @ wq [out, K]^T`` of int8 operands, exact, as int32.
    An f32 product is not exact (127 * 127 * 1280 > 2^24): the CPU sums in
    int32, a CUDA device in float64 (it has no int32 matmul), which holds
    every partial sum exactly."""
    if xq.device.type == "cpu":
        return xq.to(torch.int32) @ wq.to(torch.int32).T
    return (xq.to(torch.float64) @ wq.to(torch.float64).T).to(torch.int32)


def _qmatmul(x, w, out_dtype):
    r"""``x @ w^T`` with dynamic int8 activations against an int8 record
    ``w``; the int32 sums rescaled in float32, the result in ``out_dtype``."""
    xq, sx = quantize_activation(x)
    z = _dot_i8(xq, w["q"])
    return (z.to(torch.float32) * sx * w["scale"][:, 0]).to(out_dtype)


def dequantize_non_gate_params(params, dtype=torch.bfloat16):
    r"""Every int8 record dequantized to ``dtype`` except the LSTM gate
    matrices (``layers[*].w_ih/w_hh``), which ``int8_compute`` multiplies
    as they are."""
    if not is_quantized(params):
        return params

    def walk(node, under_layers=False):
        if _is_qtensor(node):
            return node if under_layers else dequantize_tensor(node, dtype)
        if isinstance(node, dict):
            return {k: walk(v, under_layers or k == "layers")
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, under_layers) for v in node)
        return node

    return walk(params)


def prepare_scan_params(params, int8_compute: bool = False,
                        dtype=torch.bfloat16):
    r"""A tree ready for a long scan: every int8 record dequantized once, or,
    with ``int8_compute``, every one but the gate matrices."""
    return (dequantize_non_gate_params(params, dtype) if int8_compute
            else dequantize_params(params, dtype))


def _wval(w, dtype):
    r"""A weight leaf as a dense tensor in ``dtype`` (dequantized if int8)."""
    if _is_qtensor(w):
        return dequantize_tensor(w, dtype)
    return w if w.dtype == dtype else w.to(dtype)


def _wshape(w):
    return tuple((w["q"] if _is_qtensor(w) else w).shape)


def _compute_dtype(params):
    r"""The dtype the gate math runs in: the stored weights', or bfloat16
    for int8 records."""
    w = params["linear1"]["w"]
    return torch.bfloat16 if _is_qtensor(w) else w.dtype


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def init_state(params, batch_shape=(), dtype=torch.float32):
    r"""Zero (h, c) state: each [num_layers, *batch_shape, hidden] on the
    parameters' device."""
    L = len(params["layers"])
    w_hh = params["layers"][0]["w_hh"]
    dev = (w_hh["q"] if _is_qtensor(w_hh) else w_hh).device
    shape = (L,) + tuple(batch_shape) + (_wshape(w_hh)[1],)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def _linear(p, x):
    return x @ _wval(p["w"], x.dtype).T + p["b"].to(x.dtype)


def lstm_cell(layer, x, h, c, *, int8_compute: bool = False):
    r"""One LSTM cell step, gate order (i, f, g, o), in ``x``'s dtype.

    ``int8_compute`` with int8 gate matrices runs the two gate products as
    :func:`_qmatmul` (x and h quantized separately); otherwise int8 records
    are dequantized to ``x``'s dtype first."""
    b = (layer["b_ih"] + layer["b_hh"]).to(x.dtype)
    if int8_compute and _is_qtensor(layer["w_ih"]):
        z = (_qmatmul(x, layer["w_ih"], x.dtype)
             + _qmatmul(h, layer["w_hh"], x.dtype) + b)
    else:
        z = x @ _wval(layer["w_ih"], x.dtype).T \
            + h @ _wval(layer["w_hh"], x.dtype).T + b
    i, f, g, o = z.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def _dropout(x, p, generator):
    r"""Inverted dropout: each entry kept with probability ``1 - p`` (mask
    drawn from ``generator``) and scaled by ``1 / (1 - p)``."""
    keep = 1.0 - p
    return x * torch.bernoulli(torch.full_like(x, keep),
                               generator=generator) / keep


def rnn_step(params, x, state, *, dropout: float = 0.0,
             generator: torch.Generator = None, int8_compute: bool = False):
    r"""One frame through linear1 -> ReLU -> LSTM stack -> linear2.
    ``state`` is (h, c), each [L, ..., H]; returns (out, (h, c)). The math
    runs in the weights' dtype (bf16 for int8 records) and the results come
    back in ``x``'s dtype. With ``dropout > 0`` and a ``generator`` (on
    ``x``'s device) it trains: dropout after linear1's ReLU and between
    LSTM layers, never after the last."""
    h, c = state
    w_dtype = _compute_dtype(params)
    out_dtype = x.dtype
    if x.dtype != w_dtype:
        x, h, c = x.to(w_dtype), h.to(w_dtype), c.to(w_dtype)
    train = dropout > 0.0 and generator is not None
    inp = torch.relu(_linear(params["linear1"], x))
    if train:
        inp = _dropout(inp, dropout, generator)
    new_h, new_c = [], []
    for l, layer in enumerate(params["layers"]):
        hn, cn = lstm_cell(layer, inp, h[l], c[l], int8_compute=int8_compute)
        new_h.append(hn)
        new_c.append(cn)
        inp = hn
        if train and l < len(params["layers"]) - 1:
            inp = _dropout(inp, dropout, generator)
    out = _linear(params["linear2"], inp)
    return (out.to(out_dtype), (torch.stack(new_h).to(out_dtype),
                                torch.stack(new_c).to(out_dtype)))


def rnn_group_step(params_seq, x, states, *, int8_compute: bool = False):
    r"""N stacks that read the same input, one after another (the JAX
    package batches their matmuls; the values are the same). Returns
    ``(outs, new_states)`` tuples."""
    outs, new_states = [], []
    for p, s in zip(params_seq, states):
        o, ns = rnn_step(p, x, s, int8_compute=int8_compute)
        outs.append(o)
        new_states.append(ns)
    return tuple(outs), tuple(new_states)


def rnn_pair_step(params_a, params_b, x, state_a, state_b, *,
                  int8_compute: bool = False):
    r"""Two stacks on one input; returns ``(out_a, out_b, state_a,
    state_b)``."""
    outs, sts = rnn_group_step((params_a, params_b), x, (state_a, state_b),
                               int8_compute=int8_compute)
    return outs[0], outs[1], sts[0], sts[1]


def rnn_scan(params, xs, state0=None, *, int8_compute: bool = False):
    r"""A whole sequence, one frame after another: xs [T, ..., in] ->
    (ys [T, ..., out], state). int8 records are dequantized once before the
    loop (all but the gate matrices with ``int8_compute``)."""
    params = prepare_scan_params(params, int8_compute)
    state = init_state(params, xs.shape[1:-1], xs.dtype) if state0 is None \
        else state0
    ys = []
    for t in range(xs.shape[0]):
        y, state = rnn_step(params, xs[t], state, int8_compute=int8_compute)
        ys.append(y)
    return torch.stack(ys), state


# ---------------------------------------------------------------------------
# Padded batches (training)
# ---------------------------------------------------------------------------


class _CallerWeightsLSTM(torch.nn.LSTM):
    r"""``nn.LSTM`` run on a parameter dict's own tensors through
    ``torch.func.functional_call``. ``flatten_parameters`` would move those
    tensors' storage into one buffer in place (bumping their autograd
    versions); left undone, cuDNN copies the weights itself each call (a
    train step takes as long either way, within its run-to-run spread:
    ``chip_smoke.py`` phase 10 times both), and its warning about that copy
    is silenced where the shell runs."""

    def flatten_parameters(self):
        pass


_CUDNN_COPY_WARNING = "RNN module weights are not part of single contiguous"


def _host_lengths(lengths) -> torch.Tensor:
    r"""``lengths`` as a CPU int64 tensor. A device tensor is refused: the
    packed sequence needs its lengths on the host, and reading them back
    would wait for the device."""
    if isinstance(lengths, torch.Tensor) and lengths.device.type != "cpu":
        raise ValueError("lengths must be on the host (numpy, a list or a "
                         "CPU tensor), not on " + str(lengths.device))
    return torch.as_tensor(np.asarray(lengths), dtype=torch.int64)


def _valid_mask(lengths, T, device):
    r"""[T, B] bool, true where frame t < the row's length, on ``device``
    (uploaded without waiting for the device)."""
    return torch.arange(T)[:, None].lt(lengths[None]).to(device,
                                                         non_blocking=True)


def _lstm_packed(layers, xs, lengths, state0=None, dropout: float = 0.0,
                 training: bool = False):
    r"""An LSTM stack over padded ``xs [T, B, in]`` as ``nn.LSTM`` runs a
    packed sequence: ``(out [T, B, H or proj], (h, c))``, out zero past each
    row's length and (h, c) each row's state at its length. ``layers`` may
    carry ``w_hr`` (an LSTM with ``proj_size``). Reads nothing back from
    the device."""
    l0 = layers[0]
    proj = _wshape(l0["w_hr"])[0] if "w_hr" in l0 else 0
    lstm = _CallerWeightsLSTM(
        _wshape(l0["w_ih"])[1], _wshape(l0["w_ih"])[0] // 4, len(layers),
        dropout=dropout if training else 0.0, proj_size=proj, device="meta")
    # cuDNN keeps what its backward needs only in training mode
    lstm.train(training or torch.is_grad_enabled())
    weights = {}
    for k, layer in enumerate(layers):
        weights.update({f"weight_ih_l{k}": layer["w_ih"],
                        f"weight_hh_l{k}": layer["w_hh"],
                        f"bias_ih_l{k}": layer["b_ih"],
                        f"bias_hh_l{k}": layer["b_hh"]})
        if proj:
            weights[f"weight_hr_l{k}"] = layer["w_hr"]
    # rows sorted by length on the host: with enforce_sorted=False the
    # packed sequence would carry its permutation to the device and read
    # it back to unpad, each a wait for the device
    order = torch.argsort(lengths, descending=True, stable=True)
    order_d, inverse_d = (i.to(xs.device, non_blocking=True)
                          for i in (order, torch.argsort(order)))
    packed = pack_padded_sequence(xs.index_select(1, order_d),
                                  lengths[order])
    args = (packed,) if state0 is None else (
        packed, tuple(s.index_select(1, order_d) for s in state0))
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=_CUDNN_COPY_WARNING)
        out, (h, c) = torch.func.functional_call(lstm, weights, args)
    out, _ = pad_packed_sequence(out, total_length=xs.shape[0])
    return out.index_select(1, inverse_d), (h.index_select(1, inverse_d),
                                            c.index_select(1, inverse_d))


def rnn_forward_padded(params, xs, lengths, state0=None, *,
                       dropout: float = 0.0,
                       generator: torch.Generator = None):
    r"""Padded-batch forward of one module: ``xs [T, B, in]``, ``lengths
    [B]`` (each >= 1, on the host) -> ``(ys [T, B, out], (h, c))``.

    The LSTM stack runs as ``torch.nn.LSTM`` over a packed sequence (cuDNN
    on the card), so past a row's length its output is zero and its (h, c)
    stays as it was at the length, as if each row ran alone. ``state0``
    (each [L, B, H]) seeds the stack, zeros by default. With ``dropout > 0``
    and a ``generator`` (on ``xs``' device) it trains: dropout after
    linear1's ReLU drawn from ``generator``, and the LSTM's own dropout
    between layers, drawn from the device's default generator. int8 records
    are dequantized first; the math runs in the weights' dtype and returns
    ``xs``' dtype."""
    params = dequantize_params(params)
    lengths = _host_lengths(lengths)
    T = xs.shape[0]
    mask = _valid_mask(lengths, T, xs.device)[..., None]
    w_dtype = _compute_dtype(params)
    out_dtype = xs.dtype
    x = xs.to(w_dtype)
    if state0 is not None:
        state0 = (state0[0].to(w_dtype), state0[1].to(w_dtype))
    train = dropout > 0.0 and generator is not None
    y = torch.relu(_linear(params["linear1"], x))
    if train:
        y = _dropout(y, dropout, generator)
    out, (h, c) = _lstm_packed(params["layers"], y, lengths, state0,
                               dropout, train)
    ys = torch.where(mask, _linear(params["linear2"], out), 0.0)
    return ys.to(out_dtype), (h.to(out_dtype), c.to(out_dtype))


def rnn_forward_padded_plain(params, xs, lengths, state0=None, *,
                             dropout: float = 0.0,
                             generator: torch.Generator = None):
    r""":func:`rnn_forward_padded` as a loop over frames of
    :func:`rnn_step`: at frame t a row past its length keeps its carry and
    outputs zero. Dropout (with ``generator``) is drawn per frame, in the
    same places. The reference the cuDNN path is held against."""
    params = dequantize_params(params)
    lengths = _host_lengths(lengths)
    T = xs.shape[0]
    mask = _valid_mask(lengths, T, xs.device)
    state = init_state(params, xs.shape[1:-1], xs.dtype) if state0 is None \
        else state0
    ys = []
    for t in range(T):
        out, new = rnn_step(params, xs[t], state, dropout=dropout,
                            generator=generator)
        valid = mask[t][:, None]
        state = (torch.where(valid, new[0], state[0]),
                 torch.where(valid, new[1], state[1]))
        ys.append(torch.where(valid, out, 0.0))
    return torch.stack(ys), state


def init_net_apply(params, first_label):
    r"""RNNWithInit's (h0, c0) regression from the first label:
    ``first_label`` [..., out] -> (h, c) each [L, ..., H], in torch's
    ``view(B, 2, L, H).permute(1, 2, 0, 3)`` layout. Runs in the label's
    dtype, whatever the weights' kind."""
    x = torch.relu(_linear(params["init_net"][0], first_label))
    x = torch.relu(_linear(params["init_net"][1], x))
    x = _linear(params["init_net"][2], x)
    L = len(params["layers"])
    H = _wshape(params["layers"][0]["w_hh"])[1]
    hc = x.reshape(x.shape[:-1] + (2, L, H))
    h = torch.movedim(hc[..., 0, :, :], -2, 0)
    c = torch.movedim(hc[..., 1, :, :], -2, 0)
    return h, c


def _tensor_getter(state_dict, prefix, device):
    device = resolve_device(device)

    def get(name):
        v = state_dict[prefix + name]
        if isinstance(v, torch.Tensor):
            return v.detach().to(device=device, dtype=torch.float32,
                                 copy=True)
        return torch.tensor(np.array(v), dtype=torch.float32, device=device)

    return get


def rnn_params_from_torch(state_dict, prefix: str = "", device="cuda"):
    r"""One reference RNN module from a torch state_dict (numpy or tensor
    values): ``{prefix}linear1.weight``, ``{prefix}rnn.weight_ih_l{k}``, ...,
    optionally ``{prefix}init_net.{0,2,4}.weight``; on ``device``, which
    raises without a card unless it is ``"cpu"`` (``resolve_device``)."""
    get = _tensor_getter(state_dict, prefix, device)
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


# ---------------------------------------------------------------------------
# PureRNN and CycleRNN (the reference's other module kinds)
# ---------------------------------------------------------------------------


def pure_rnn_params_from_torch(state_dict, prefix: str = "", device="cuda"):
    r"""A PureRNN (``nn.LSTM`` with ``proj_size``) from its state_dict:
    ``{"layers": [{"w_ih" [4H, in], "w_hh" [4H, proj], "b_ih", "b_hh",
    "w_hr" [proj, H]}, ...]}`` on ``device``."""
    get = _tensor_getter(state_dict, prefix, device)
    layers, k = [], 0
    while (prefix + f"rnn.weight_ih_l{k}") in state_dict:
        layers.append({name: get(f"rnn.{key}_l{k}") for name, key in (
            ("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
            ("b_ih", "bias_ih"), ("b_hh", "bias_hh"),
            ("w_hr", "weight_hr"))})
        k += 1
    return {"layers": layers}


def pure_rnn_forward_padded(params, xs, lengths):
    r"""PureRNN's forward: ``xs [T, B, in]`` -> ``ys [T, B, proj]``, zero
    past each row's length (``lengths`` on the host), through
    ``nn.LSTM`` over a packed sequence."""
    params = dequantize_params(params, torch.float32)
    ys, _ = _lstm_packed(params["layers"], xs, _host_lengths(lengths))
    return ys


# CycleRNN's state_dict has the plain module's layout
cycle_rnn_params_from_torch = rnn_params_from_torch


def cycle_rnn_forward_padded(params, xs, lengths, pred_weight: float = 1.0):
    r"""CycleRNN's forward, autoregressive: each frame's input tail (its
    last ``out`` entries) is replaced by ``pred_weight * previous output +
    (1 - pred_weight) * the given tail``, both detached; frame 0's
    "previous output" is its own given tail. ``xs [T, B, in]`` -> ``ys
    [T, B, out]``, zero past each row's length; a row past its length keeps
    its carry and its previous output."""
    params = dequantize_params(params)
    out_size = _wshape(params["linear2"]["w"])[0]
    mask = _valid_mask(_host_lengths(lengths), xs.shape[0], xs.device)
    state = init_state(params, xs.shape[1:2], xs.dtype)
    prev = xs[0, :, -out_size:]
    ys = []
    for t in range(xs.shape[0]):
        x = xs[t]
        tail = (prev.detach() * pred_weight
                + x[:, -out_size:].detach() * (1.0 - pred_weight))
        out, new = rnn_step(params, torch.cat([x[:, :-out_size], tail], -1),
                            state)
        valid = mask[t][:, None]
        state = (torch.where(valid, new[0], state[0]),
                 torch.where(valid, new[1], state[1]))
        prev = torch.where(valid, out, prev)
        ys.append(torch.where(valid, out, 0.0))
    return torch.stack(ys)

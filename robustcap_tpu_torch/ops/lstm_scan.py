r"""B=1 scan of a 2-layer LSTM stack over a frame sequence, chunk by chunk.

:func:`rnn_scan_chunked` takes the place of the JAX package's
``ops/pallas_lstm.py::rnn_scan_pallas_chunked``: it runs linear1 -> ReLU ->
two LSTM layers -> linear2 over ``xs [T, in]`` in chunks of at most
``max_chunk`` frames, chaining ``(h, c)`` from one chunk to the next. On a
CUDA tensor each chunk is one launch of the hand-written kernel
``csrc/lstm_scan.cu`` (the time loop runs inside the launch); on a CPU tensor
the wrapper runs the plain version, :func:`rnn_scan_plain`. There is no
other fallback: on any other device, or when the kernel cannot launch, it
raises. bf16 and int8-quantized weights are dequantized and cast to float32
first, as the JAX kernel's wrapper does: the kernel computes in float32.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import tree_map
from ..nn.rnn import dequantize_params, init_state, rnn_scan
from . import _build

__all__ = ["LAUNCHES", "rnn_scan_plain", "rnn_scan_chunked"]

# kernel launches so far (one per chunk on a CUDA tensor)
LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 20 + [_I] * 4 + [_P]


def rnn_scan_plain(params, xs, state):
    r"""The plain PyTorch version of one chunk: frame after frame through
    ``nn.rnn.rnn_step``. Returns ``(ys [T, out], (h, c) each [2, H])``."""
    return rnn_scan(params, xs, state)


def _lib():
    lib = _build.load("lstm_scan")
    fn = lib.lstm_scan_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32 on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(params, xs, state):
    global LAUNCHES
    dev = xs.device
    T, n_in = xs.shape
    l0, l1 = params["layers"]
    H = l0["w_hh"].shape[1]
    n_out = params["linear2"]["w"].shape[0]
    h0, c0 = state
    named = [
        ("xs", xs, (T, n_in)),
        ("linear1.w", params["linear1"]["w"], (H, n_in)),
        ("linear1.b", params["linear1"]["b"], (H,)),
    ]
    for i, layer in enumerate((l0, l1)):
        named += [(f"layers[{i}].w_ih", layer["w_ih"], (4 * H, H)),
                  (f"layers[{i}].w_hh", layer["w_hh"], (4 * H, H)),
                  (f"layers[{i}].b_ih", layer["b_ih"], (4 * H,)),
                  (f"layers[{i}].b_hh", layer["b_hh"], (4 * H,))]
    named += [("linear2.w", params["linear2"]["w"], (n_out, H)),
              ("linear2.b", params["linear2"]["b"], (n_out,)),
              ("h0", h0, (2, H)), ("c0", c0, (2, H))]
    for name, t, shape in named:
        _check(name, t, shape, dev)

    ys = torch.empty((T, n_out), dtype=torch.float32, device=dev)
    hN = torch.empty((2, H), dtype=torch.float32, device=dev)
    cN = torch.empty((2, H), dtype=torch.float32, device=dev)
    y1 = torch.empty((H,), dtype=torch.float32, device=dev)
    hbuf = torch.empty((2, 2, H), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for _, t, _ in named] + [
        ys.data_ptr(), hN.data_ptr(), cN.data_ptr(), y1.data_ptr(),
        hbuf.data_ptr()]
    err = _lib()(*ptrs, T, n_in, H, n_out, stream)
    if err != 0:
        raise RuntimeError(f"lstm_scan kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return ys, (hN, cN)


def rnn_scan_chunked(params, xs, state=None, max_chunk: int = 256):
    r"""Run ``xs [T, in]`` through a 2-layer stack in chunks of at most
    ``max_chunk`` frames -> ``(ys [T, out], (h, c) each [2, H])``.
    ``state`` seeds ``(h, c)`` (zeros for a fresh sequence). Weights of any
    kind are used as float32 values."""
    if len(params["layers"]) != 2:
        raise ValueError("the LSTM-scan kernel takes 2-layer stacks")
    if xs.dim() != 2:
        raise ValueError(f"xs must be [T, in], got {tuple(xs.shape)}")
    params = tree_map(lambda t: t.to(torch.float32),
                      dequantize_params(params))
    if state is None:
        state = init_state(params, (), xs.dtype)
    if xs.device.type == "cpu":
        run = rnn_scan_plain
    elif xs.device.type == "cuda":
        run = _launch
    else:
        raise ValueError(f"no LSTM-scan path for device {xs.device}")
    outs = []
    for s in range(0, xs.shape[0], max_chunk):
        ys, state = run(params, xs[s:s + max_chunk], state)
        outs.append(ys)
    return torch.cat(outs), state

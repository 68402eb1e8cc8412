r"""One LSTM layer's step over B rows as one operator, for the batched step.

``torch.ops.robustcap.lstm_cell(x, h, c, w_ih, w_hh, b_ih, b_hh, h_out,
c_out, layer)`` computes ``z = x W_ih^T + h W_hh^T + b_ih + b_hh``, the
gates (i, f, g, o) and the new ``(h, c)`` of ``x [B, K_in]``, ``h``/``c
[B, H]``, and writes them into row ``layer`` of ``h_out``/``c_out``
``[L, B, H]``, leaving their other rows as they are. On CPU tensors it runs
the plain version, ``nn.rnn.lstm_cell``'s arithmetic; on CUDA tensors the
hand-written kernel ``csrc/lstm_cell_batched.cu`` (float32 only) up to
:data:`ROWS_DIRECT` rows, with no fallback: a launch that fails raises.

The operator adapts to the rows by itself. Up to :data:`ROWS_DIRECT` rows
the kernel computes both gate products itself, one launch a layer; above,
cuBLAS's own tiles fill the card and ``torch.lstm_cell`` (two cuBLAS
products and a fused cell kernel) is faster, so the operator runs it and
copies its ``(h, c)`` into the rows. :func:`lstm_cell_plan` picks the
kernel's units and rows a block.

:func:`rnn_step_cells` is one stack's step (linear1 -> ReLU -> the layers
through the operator -> linear2) with ``nn.rnn.rnn_step``'s inputs and
results: the batched step (``models.sig_mp.make_batched_step``) runs it for
float32 weights, also when exported or captured in a CUDA graph. It has no
backward, and nothing that trains reaches it.
"""

from __future__ import annotations

import ctypes

import torch

from ..nn.rnn import lstm_cell
from . import _build

__all__ = ["LAUNCHES", "ROWS_DIRECT", "lstm_cell_plan", "lstm_cell_plain",
           "rnn_step_cells"]

# kernel launches so far (one per operator call of up to ROWS_DIRECT rows on
# CUDA tensors outside a CUDA graph's capture; a capture launches nothing
# and a replay does not come through here)
LAUNCHES = 0

# The most rows for which the kernel runs; above, torch.lstm_cell (chip
# timings at B = 1 to 2048 for H = 512, 1024 and 1280: PERF.md)
ROWS_DIRECT = 64

# hidden units a block may own (csrc/lstm_cell_batched.cu's instances), and
# the blocks a plan aims for: about one a streaming multiprocessor of an H100
_UNITS = (4, 8, 10)
_BLOCKS = 128

_P = ctypes.c_void_p
_I = ctypes.c_int
_F32 = torch.float32


def lstm_cell_plan(B: int, H: int):
    r"""``(units, row_groups)`` of the kernel for ``B`` rows of hidden size
    ``H``: each block owns ``units`` hidden units (4, 8 or 10, dividing
    ``H``; the one whose ``H / units`` blocks come nearest 128: 128 blocks at
    H = 512, 1024 and 1280) and ``8 row_groups`` rows (1, 2, 4 or 8 groups,
    the fewest that cover ``B``; more rows take more blocks). Raises
    ``ValueError`` for a hidden size that is not a multiple of 4."""
    fits = [u for u in _UNITS if H % u == 0]
    if H % 4 or not fits:
        raise ValueError(f"lstm_cell: hidden size {H} is not a multiple of 4")
    units = min(fits, key=lambda u: abs(H // u - _BLOCKS))
    row_groups = next((g for g in (1, 2, 4) if 8 * g >= B), 8)
    return units, row_groups


def lstm_cell_plain(x, h, c, w_ih, w_hh, b_ih, b_hh):
    r"""The plain version: ``nn.rnn.lstm_cell`` on the layer's weights;
    returns ``(h_new, c_new)`` each ``[B, H]``."""
    return lstm_cell({"w_ih": w_ih, "w_hh": w_hh, "b_ih": b_ih,
                      "b_hh": b_hh}, x, h, c)


def _lib():
    lib = _build.load("lstm_cell_batched")
    fn = lib.lstm_cell_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 9 + [_I] * 5 + [_P]
        fn.restype = ctypes.c_int
    return fn


def _check(name, t, shape, device):
    if t.device != device or t.dtype != _F32:
        raise ValueError(f"lstm_cell: {name} must be float32 on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"lstm_cell: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"lstm_cell: {name} must be contiguous")


def _launch(x, h, c, w_ih, w_hh, b_ih, b_hh, h_out, c_out, layer):
    r"""One kernel launch on the tensors' own device, without the
    dispatcher (the g++ stand-in tests run the kernel's source on CPU
    tensors through it)."""
    global LAUNCHES
    dev = x.device
    B, K_in = x.shape
    H = h.shape[-1]
    for name, t, shape in (("x", x, (B, K_in)), ("h", h, (B, H)),
                           ("c", c, (B, H)), ("w_ih", w_ih, (4 * H, K_in)),
                           ("w_hh", w_hh, (4 * H, H)),
                           ("b_ih", b_ih, (4 * H,)), ("b_hh", b_hh, (4 * H,)),
                           ("h_out", h_out, (h_out.shape[0], B, H)),
                           ("c_out", c_out, h_out.shape)):
        _check(name, t, shape, dev)
    if not 0 <= layer < h_out.shape[0]:
        raise ValueError(f"lstm_cell: layer {layer} outside the "
                         f"{h_out.shape[0]} rows of the state")
    units, row_groups = lstm_cell_plan(B, H)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(x.data_ptr(), h.data_ptr(), c.data_ptr(), w_ih.data_ptr(),
                 w_hh.data_ptr(), b_ih.data_ptr(), b_hh.data_ptr(),
                 h_out[layer].data_ptr(), c_out[layer].data_ptr(), B, K_in,
                 H, units, row_groups, stream)
    if err != 0:
        raise RuntimeError(f"lstm_cell kernel launch failed: CUDA error {err}")
    if dev.type != "cuda" or not torch.cuda.is_current_stream_capturing():
        LAUNCHES += 1


def _lstm_cell_cpu(x, h, c, w_ih, w_hh, b_ih, b_hh, h_out, c_out, layer):
    hn, cn = lstm_cell_plain(x, h, c, w_ih, w_hh, b_ih, b_hh)
    h_out[layer].copy_(hn)
    c_out[layer].copy_(cn)


def _lstm_cell_library(x, h, c, w_ih, w_hh, b_ih, b_hh, h_out, c_out,
                       layer):
    hn, cn = torch.lstm_cell(x, (h, c), w_ih, w_hh, b_ih, b_hh)
    h_out[layer].copy_(hn)
    c_out[layer].copy_(cn)


def _lstm_cell_cuda(x, h, c, w_ih, w_hh, b_ih, b_hh, h_out, c_out, layer):
    run = _launch if x.shape[0] <= ROWS_DIRECT else _lstm_cell_library
    run(x, h, c, w_ih, w_hh, b_ih, b_hh, h_out, c_out, layer)


def _lstm_cell_fake(x, h, c, w_ih, w_hh, b_ih, b_hh, h_out, c_out, layer):
    return None


# registered with the dispatcher's own API rather than
# torch.library.custom_op, whose Python wrappers cost ~100 us a call on the
# host: an eager batched step makes 16 calls a frame-step
_LIB = torch.library.Library("robustcap", "FRAGMENT")
_LIB.define("lstm_cell(Tensor x, Tensor h, Tensor c, Tensor w_ih, "
            "Tensor w_hh, Tensor b_ih, Tensor b_hh, Tensor(a!) h_out, "
            "Tensor(b!) c_out, int layer) -> ()")
_LIB.impl("lstm_cell", _lstm_cell_cpu, "CPU")
_LIB.impl("lstm_cell", _lstm_cell_cuda, "CUDA")
torch.library.register_fake("robustcap::lstm_cell", _lstm_cell_fake,
                            lib=_LIB)


def rnn_step_cells(params, x, state):
    r"""One frame of a stack with float32 weights, ``nn.rnn.rnn_step``'s
    inputs and results: linear1 -> ReLU, each LSTM layer one call of
    ``robustcap::lstm_cell`` writing its row of the new ``(h, c)`` (each
    ``[L, B, H]``, allocated here), then linear2 on the top layer's ``h``.
    On the CPU its values are ``rnn_step``'s bit for bit."""
    h, c = state
    l1, l2 = params["linear1"], params["linear2"]
    inp = torch.relu(x @ l1["w"].T + l1["b"])
    h_new = torch.empty(h.shape, dtype=h.dtype, device=h.device)
    c_new = torch.empty(c.shape, dtype=c.dtype, device=c.device)
    for l, layer in enumerate(params["layers"]):
        # a state may arrive strided (the IMU re-init's (h, c) is a view):
        # the kernel reads rows
        torch.ops.robustcap.lstm_cell(inp, h[l].contiguous(),
                                      c[l].contiguous(), layer["w_ih"],
                                      layer["w_hh"], layer["b_ih"],
                                      layer["b_hh"], h_new, c_new, l)
        inp = h_new[l]
    return inp @ l2["w"].T + l2["b"], (h_new, c_new)

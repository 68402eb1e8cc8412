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

The kernel reads the stack from a packed copy (``serve_scan.pack_stack``: a
unit's four ``w_ih`` and four ``w_hh`` gate rows and its summed biases side
by side). :func:`prepare_lstm_scan` dequantizes, casts and packs a stack
once; :func:`rnn_scan_chunked` takes its result as well as raw params, which
it prepares on every call. :func:`lstm_plan` gives every block of the launch
its fixed run of units of each layer, kept in shared memory for the whole
launch, and lays out the block's shared memory.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..device import tree_map
from ..nn.rnn import dequantize_params, init_state, rnn_scan
from . import _build
from .serve_scan import pack_stack, split_counts

__all__ = ["LAUNCHES", "LstmScanOperands", "prepare_lstm_scan", "lstm_plan",
           "ts_slots", "rnn_scan_plain", "rnn_scan_chunked"]

# kernel launches so far (one per chunk on a CUDA tensor)
LAUNCHES = 0

# The kernel's block (csrc/lstm_scan.cu): threads, and floats of the
# product's two tiles
_THREADS = 512
_TILE_FLOATS = 2 * 32 * 68

_P = ctypes.c_void_p
_I = ctypes.c_int


def ts_slots(T):
    r"""Timestamps of one launch over ``T`` frames (``timestamps=``): the
    start; linear1 done and its barrier passed; U0 done and its barrier
    passed; the weights resident; per step ``s`` in ``0..T`` its work done
    (slot ``6 + 2 s``) and its barrier passed (``7 + 2 s``); linear2 done
    (``8 + 2 T``)."""
    return 2 * T + 9


@dataclasses.dataclass
class LstmScanOperands:
    r"""A stack prepared once for the kernel (:func:`prepare_lstm_scan`):
    ``params``, its float32 tree (what the plain version runs); ``stack``,
    the operands of ``serve_scan.pack_stack`` with the packed copy under
    ``"packed"``; ``plans``, the kernel's plan per card, made at its first
    launch there."""
    params: dict
    stack: dict
    plans: dict = dataclasses.field(default_factory=dict)


def prepare_lstm_scan(params) -> LstmScanOperands:
    r"""A 2-layer stack dequantized (int8 records to bf16, as
    ``dequantize_params`` does), cast to float32 and packed for the kernel,
    on the params' device. Raises ``ValueError`` for another depth."""
    if len(params["layers"]) != 2:
        raise ValueError("the LSTM-scan kernel takes 2-layer stacks")
    p = tree_map(lambda t: t.to(torch.float32), dequantize_params(params))
    layers = p["layers"]
    w1, w2 = p["linear1"]["w"].contiguous(), p["linear2"]["w"].contiguous()
    s = {"w1": w1, "b1": p["linear1"]["b"].contiguous(),
         "w_ih": [l["w_ih"].contiguous() for l in layers],
         "w_hh": [l["w_hh"].contiguous() for l in layers],
         "bias": [(l["b_ih"] + l["b_hh"]).contiguous() for l in layers],
         "w2": w2, "b2": p["linear2"]["b"].contiguous(),
         "H": int(layers[0]["w_hh"].shape[1]), "in": int(w1.shape[1]),
         "out": int(w2.shape[0])}
    s["packed"] = pack_stack(s)
    return LstmScanOperands(p, s)


def lstm_plan(stack, n_blocks, smem_bytes):
    r"""The kernel's plan of a packed stack on a grid of ``n_blocks``
    blocks with ``smem_bytes`` of dynamic shared memory each:

    * ``starts`` ``int32 [2, n_blocks + 1]``: block b owns units
      ``[starts[l, b], starts[l, b + 1])`` of layer l, split as evenly as
      they go (layer 1's extra units on the blocks after layer 0's);
    * ``resident``: each block's bytes kept in shared memory, its layer-0
      units' ``w_hh`` rows with their biases (the second half of each
      packed record) and its layer-1 units' whole records;
    * ``layout``: byte offsets of the shared-memory areas (the mbarrier, the
      two h vectors, the gate sums of a step's jobs, the product's tiles,
      the resident records) and their ``total``.

    Raises ``ValueError`` for a hidden size over 1024, when a block owns
    more units than the kernel has threads, or when its areas do not fit
    ``smem_bytes``."""
    nb = int(n_blocks)
    H = stack["H"]
    _, _, rec, lens = stack["packed"]
    hp = lens[1]
    starts = np.zeros((2, nb + 1), np.int32)
    c0 = split_counts(H, nb)
    c1 = split_counts(H, nb, rot=H % nb)
    starts[0, 1:], starts[1, 1:] = np.cumsum(c0), np.cumsum(c1)
    if H > 2 * _THREADS:
        raise ValueError(f"LSTM-scan plan: the kernel takes hidden sizes up "
                         f"to {2 * _THREADS}")
    if int((c0 + c1).max()) > _THREADS:
        raise ValueError(f"LSTM-scan plan: {int((c0 + c1).max())} units a "
                         f"block, the kernel owns at most {_THREADS}")
    r0, r1 = 4 * hp * 4 + 16, rec[2]
    resident = c0 * r0 + c1 * r1
    jobs = int((c0 + 2 * c1).max())

    def align(n, a=16):
        return -(-n // a) * a

    layout, off = {}, 0
    for name, size, a in (("bar", 16, 16), ("hv", 2 * hp * 4, 16),
                          ("part", 16 * jobs, 16),
                          ("tile", 4 * _TILE_FLOATS, 16),
                          ("res", int(resident.max()), 128)):
        off = align(off, a)
        layout[name] = off
        off += size
    layout["total"] = off
    if off > smem_bytes:
        raise ValueError(f"LSTM-scan plan: {off} bytes of shared memory a "
                         f"block, the card gives {smem_bytes}")
    return {"blocks": nb, "starts": starts, "resident": resident,
            "layout": layout}


def rnn_scan_plain(params, xs, state):
    r"""The plain PyTorch version of one chunk: frame after frame through
    ``nn.rnn.rnn_step``. Returns ``(ys [T, out], (h, c) each [2, H])``."""
    return rnn_scan(params, xs, state)


def _lib():
    lib = _build.load("lstm_scan")
    fn = lib.lstm_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _P, _I, _P]
        fn.restype = ctypes.c_int
        lib.lstm_scan_device_info.argtypes = [_P]
        lib.lstm_scan_device_info.restype = ctypes.c_int
    return lib


def _device_plan(ops, dev):
    r"""The plan of ``ops`` for the card ``dev`` (one block per SM, all of a
    block's dynamic shared memory it may take) and its block table on the
    card, made once and kept in ``ops.plans``."""
    if dev.index not in ops.plans:
        info = np.zeros(2, np.int32)
        with torch.cuda.device(dev):
            err = _lib().lstm_scan_device_info(info.ctypes.data)
        if err != 0:
            raise RuntimeError(f"lstm_scan: reading the card's attributes "
                               f"failed: CUDA error {err}")
        plan = lstm_plan(ops.stack, int(info[0]), int(info[1]))
        ops.plans[dev.index] = (plan, torch.as_tensor(plan["starts"]).to(dev))
    return ops.plans[dev.index]


def _check(name, t, shape, device, dtype=torch.float32):
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(ops, xs, state, timestamps=None):
    global LAUNCHES
    dev = xs.device
    s = ops.stack
    T, H, n_in, n_out = xs.shape[0], s["H"], s["in"], s["out"]
    buf, offsets, rec, lens = s["packed"]
    h0, c0 = state
    _check("xs", xs, (T, n_in), dev)
    _check("h0", h0, (2, H), dev)
    _check("c0", c0, (2, H), dev)
    _check("packed stack", buf, buf.shape, dev, torch.uint8)
    if timestamps is not None:
        _check("timestamps", timestamps, (ts_slots(T),), dev, torch.int64)
    plan, table = _device_plan(ops, dev)

    f32 = torch.float32
    ys = torch.empty((T, n_out), dtype=f32, device=dev)
    hN = torch.empty((2, H), dtype=f32, device=dev)
    cN = torch.empty((2, H), dtype=f32, device=dev)
    # U0 [T, 4H], linear1's output [T, H], each layer's h [T + 1, H]
    scratch = torch.empty(7 * T * H + 2 * H, dtype=f32, device=dev)
    base = buf.data_ptr()
    ptrs = [xs.data_ptr(), *(base + o for o in offsets), h0.data_ptr(),
            c0.data_ptr(), ys.data_ptr(), hN.data_ptr(), cN.data_ptr(),
            scratch.data_ptr(), table.data_ptr(),
            0 if timestamps is None else timestamps.data_ptr()]
    lay = plan["layout"]
    ints = [T, n_in, H, n_out, *rec, *lens, plan["blocks"],
            *(lay[k] for k in ("bar", "hv", "part", "tile", "res", "total"))]
    p_arr = np.asarray(ptrs, dtype=np.int64)
    i_arr = np.asarray(ints, dtype=np.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().lstm_scan_launch(p_arr.ctypes.data, len(p_arr),
                                  i_arr.ctypes.data, len(i_arr), stream)
    if err != 0:
        raise RuntimeError(f"lstm_scan kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return ys, (hN, cN)


def rnn_scan_chunked(params, xs, state=None, max_chunk: int = 256,
                     timestamps=None):
    r"""Run ``xs [T, in]`` through a 2-layer stack in chunks of at most
    ``max_chunk`` frames -> ``(ys [T, out], (h, c) each [2, H])``.
    ``params`` is a parameter tree (weights of any kind, used as float32
    values) or its :func:`prepare_lstm_scan`; ``state`` seeds ``(h, c)``
    (zeros for a fresh sequence).

    ``timestamps``, on the card and for one chunk only: an int64 tensor of
    :func:`ts_slots` ``(T)`` zeros that the kernel fills with block 0's
    ``%globaltimer`` (ns); ``None`` on the main path."""
    if isinstance(params, LstmScanOperands):
        ops, tree = params, params.params
    elif len(params["layers"]) != 2:
        raise ValueError("the LSTM-scan kernel takes 2-layer stacks")
    else:
        ops = tree = None
    if xs.dim() != 2:
        raise ValueError(f"xs must be [T, in], got {tuple(xs.shape)}")
    if xs.device.type == "cpu":
        if timestamps is not None:
            raise ValueError("timestamps come from the kernel on the card")
        if tree is None:
            tree = tree_map(lambda t: t.to(torch.float32),
                            dequantize_params(params))

        def run(x, st):
            return rnn_scan_plain(tree, x, st)
    elif xs.device.type == "cuda":
        if timestamps is not None and xs.shape[0] > max_chunk:
            raise ValueError("timestamps cover one launch: at most "
                             f"max_chunk={max_chunk} frames")
        if ops is None:
            ops = prepare_lstm_scan(params)
            tree = ops.params

        def run(x, st):
            return _launch(ops, x, st, timestamps)
    else:
        raise ValueError(f"no LSTM-scan path for device {xs.device}")
    if state is None:
        state = init_state(tree, (), xs.dtype)
    outs = []
    for s in range(0, xs.shape[0], max_chunk):
        ys, state = run(xs[s:s + max_chunk], state)
        outs.append(ys)
    return torch.cat(outs), state

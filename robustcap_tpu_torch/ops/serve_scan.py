r"""The whole-chunk serving kernel: the branchless steady SigMP step over a
chunk of frames in one launch.

:func:`serve_scan` takes the place of the JAX package's
``ops/pallas_serve.py::serve_scan``. It runs every frame of a chunk through
rnn2, rnn3 and the speculative rnn7/rnn8 heads, the speculative tail, the
occluded-frame refeed of rnn4/rnn6, the confidence gate, the final heads and
tail, the one-shot IMU-updater rewrite and the live throttle, with the
semantics of ``make_step(include_first_frame_step=False,
cond_updater=False)``. On a CUDA tensor it is one launch of the hand-written
kernel ``csrc/serve_scan.cu``; on a CPU tensor it runs the plain version,
:func:`serve_scan_plain`, a frame loop of that step. There is no other
fallback: on any other device, or when the kernel cannot launch, it raises.

The kernel takes the weights in one of three modes, as the JAX kernel does
(:func:`prepare_serve_params`): float32; bfloat16 rows, each activation
rounded to bf16 before a product and every sum, gate and state kept in
float32; and int8 gate matrices with per-row scales under
``cfg.int8_compute``, whose activations are quantized per row as the XLA
``int8_compute`` step does, with linear1/linear2 in bf16.

It reads them from a packed copy (:func:`pack_stack`): per stack and phase
kind (linear1, layer 0, layer 1, linear2) one run of 16-byte-aligned
records, a unit's eight gate rows, its four biases and, in int8 mode, its
eight row scales side by side. :func:`serve_plan` gives every block of the
launch a fixed, balanced run of records per phase kind, decides which runs
stay in shared memory for the whole launch, and lays out the rest of shared
memory, with the ring the other runs stream through.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..math.spatial import mat3_mul
from ..nn.rnn import (_dot_i8, _is_qtensor, dequantize_params,
                      dequantize_tensor, quantize_activation,
                      quantize_tensor)
from . import _build
from .geometry_tail import PD_ROW

__all__ = ["LAUNCHES", "MODES", "TS_SLOTS", "KINDS", "prepare_serve_params",
           "pack_stack", "unpack_stack", "split_counts", "serve_plan",
           "check_serve_cfg",
           "serve_scan_plain", "serve_scan"]

# kernel launches so far (one per chunk on CUDA tensors)
LAUNCHES = 0

# in-launch timestamps per frame (``serve_scan(..., timestamps=)``)
TS_SLOTS = 56

# weight modes, in the order of the kernel's mode argument
MODES = ("f32", "bf16", "int8")

# stack order of the kernel's operands
_STACKS = ("rnn2", "rnn3", "rnn4", "rnn6", "rnn7", "rnn8")
_SYN = 267      # synthetic keypoints: 99 + 99 + 69

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] * 3 + [ctypes.c_void_p]

_F32, _BF16, _I8 = torch.float32, torch.bfloat16, torch.int8

# phase kinds of a stack, in the order of the packed copy
KINDS = ("linear1", "layer0", "layer1", "linear2")

# The kernel's block (csrc/serve_scan.cu): threads, mbarriers of the ring,
# floats of the linear1 input area, bytes of the block's state and of the
# tail's scratch and constants, floats of the tail's staging
_THREADS = 512
_WARPS = _THREADS // 32
_RING_BARS = 16
_XIN = 528
_STATE = 1152
_TAIL_SMEM = 4352
_TAIL_CONST = 4288   # the tail's body-model constants and flags
_TAIL_STAGE = 868    # floats: a tail's inputs, carry and outputs
# the least ring a mode keeps before runs stay resident (f32 keeps none)
_RING_MIN = {"f32": None, "bf16": 160 * 1024, "int8": 96 * 1024}
# pieces the ring is cut into, how many are in flight at once: on the H100
# every further piece cost more than the bytes it kept in flight saved
_PIECES = 2
# residency, first come first served: the heads run twice on an occluded
# frame, rnn2 and rnn3 once
_RESIDENT_ORDER = ("rnn7", "rnn8", "rnn2", "rnn3")
# stacks whose extra records rotate on from one to the next, so that the
# phases of both kinds of frame balance: {rnn2}, {rnn3, rnn7, rnn8}, {rnn4},
# {rnn7, rnn8, rnn6} where the refeed may fire, {rnn2, rnn4} and
# {rnn7, rnn8, rnn6, rnn3} where it cannot
_BALANCE = (("rnn2", "rnn4"), ("rnn3", "rnn7", "rnn8", "rnn6"))


def _padded(n, itemsize):
    r"""``n`` rounded up to whole 16-byte chunks of ``itemsize`` items."""
    per = 16 // itemsize
    return -(-n // per) * per


def split_counts(n, nb, rot=0):
    r"""``n`` items over ``nb`` blocks as evenly as they go: the
    ``n % nb`` blocks from block ``rot`` on (cyclically) take one more."""
    q, r = divmod(n, nb)
    return q + (((np.arange(nb) - rot) % nb) < r)


def _row_bytes(w):
    r"""Rows of ``w [n, m]`` zero-padded to whole 16-byte chunks, as bytes
    ``[n, bytes per row]``."""
    n, m = w.shape
    out = torch.zeros((n, _padded(m, w.element_size())), dtype=w.dtype,
                      device=w.device)
    out[:, :m] = w
    return out.view(torch.uint8)


def _f32_bytes(t):
    return t.to(_F32).contiguous().view(torch.uint8)


def _dense_records(w, b):
    r"""Rows of ``w`` with their bias after each (16 bytes: the bias, then
    zeros)."""
    tail = torch.zeros((w.shape[0], 4), dtype=_F32, device=w.device)
    tail[:, 0] = b
    return torch.cat([_row_bytes(w), tail.view(torch.uint8)], 1)


def pack_stack(s):
    r"""The packed copy of one stack of :func:`prepare_serve_params`:
    ``(bytes, offsets, record bytes, row lengths)``, each of the last three
    per kind of :data:`KINDS`. A linear1 or linear2 record is one weight
    row and its bias (f32, padded to 16 bytes); a layer record is unit j's
    four ``w_ih`` gate rows (i, f, g, o), its four ``w_hh`` gate rows, its
    four summed biases (f32) and, in int8 mode, the eight rows' scales
    (f32). Rows are zero-padded to whole 16-byte
    chunks (the row length in items), so every record, and every block's run
    of consecutive records, is 16-byte aligned."""
    H = s["H"]
    runs = [_dense_records(s["w1"], s["b1"])]
    for l in range(2):
        wih, whh = s["w_ih"][l], s["w_hh"][l]
        hp = _padded(H, wih.element_size())
        rows = torch.zeros((H, 2, 4, hp), dtype=wih.dtype, device=wih.device)
        rows[:, 0, :, :H] = wih.view(4, H, H).transpose(0, 1)
        rows[:, 1, :, :H] = whh.view(4, H, H).transpose(0, 1)
        parts = [rows.reshape(H, -1).view(torch.uint8),
                 _f32_bytes(s["bias"][l].view(4, H).T)]
        if "w_ih_s" in s:
            parts.append(_f32_bytes(torch.cat(
                [s["w_ih_s"][l].view(4, H).T, s["w_hh_s"][l].view(4, H).T],
                1)))
        runs.append(torch.cat(parts, 1))
    runs.append(_dense_records(s["w2"], s["b2"]))
    offsets, rec, lens, off = [], [], [], 0
    for k, r in enumerate(runs):
        offsets.append(off)
        rec.append(int(r.shape[1]))
        off += r.numel()
        w = s["w1"] if k == 0 else s["w2"] if k == 3 else s["w_hh"][0]
        lens.append(_padded(w.shape[1], w.element_size()))
    return (torch.cat([r.reshape(-1) for r in runs]), offsets, rec, lens)


def unpack_stack(s):
    r"""The torch-layout weights of a stack back from its packed copy
    (``s["packed"]``): ``{"w1", "b1", "w_ih", "w_hh", "bias", "w2", "b2"}``
    and in int8 mode ``"w_ih_s"``/``"w_hh_s"``; the inverse of
    :func:`pack_stack`."""
    H, n_in, n_out = s["H"], s["in"], s["out"]
    buf, offsets, rec, lens = s["packed"]

    def run(k, n):
        return buf[offsets[k]:offsets[k] + n * rec[k]].view(n, rec[k])

    def rows(k, n, m, dtype):
        r = run(k, n)
        w = r[:, :rec[k] - 16].contiguous().view(dtype)[:, :m]
        return w, r[:, rec[k] - 16:].contiguous().view(_F32)[:, 0]

    gate_t = s["w_hh"][0].dtype
    hp = lens[1]
    es = torch.tensor([], dtype=gate_t).element_size()
    out = {"w_ih": [], "w_hh": [], "bias": [], "w_ih_s": [], "w_hh_s": []}
    out["w1"], out["b1"] = rows(0, H, n_in, s["w1"].dtype)
    out["w2"], out["b2"] = rows(3, n_out, H, s["w2"].dtype)
    for l in (1, 2):
        r = run(l, H)
        g = r[:, :8 * hp * es].contiguous().view(gate_t).view(H, 2, 4, hp)
        out["w_ih"].append(g[:, 0, :, :H].transpose(0, 1).reshape(4 * H, H))
        out["w_hh"].append(g[:, 1, :, :H].transpose(0, 1).reshape(4 * H, H))
        tail = r[:, 8 * hp * es:].contiguous().view(_F32)
        out["bias"].append(tail[:, :4].T.reshape(4 * H))
        if tail.shape[1] > 4:
            out["w_ih_s"].append(tail[:, 4:8].T.reshape(4 * H))
            out["w_hh_s"].append(tail[:, 8:12].T.reshape(4 * H))
    if not out["w_ih_s"]:
        del out["w_ih_s"], out["w_hh_s"]
    return out


def serve_plan(prepped, n_sms, smem_bytes):
    r"""The kernel's plan of one weight set on a grid of ``n_sms`` blocks
    with ``smem_bytes`` of dynamic shared memory each; the same plan serves
    every frame and chunk.

    * ``starts`` ``int32 [6, 4, n_sms + 1]``: block b owns records
      ``[starts[s, k, b], starts[s, k, b + 1])`` of stack s (order of the
      kernel's operands) and kind k (:data:`KINDS`): units of a layer, rows
      of linear1/linear2. Each kind's records are split as evenly as they
      go, the blocks with one more record rotating on through the stacks
      that share a phase (``_BALANCE``), so that each phase balances.
    * ``resident`` ``[6][4]``: runs copied into shared memory once per
      launch and kept there: in the order of ``_RESIDENT_ORDER``, while the
      ring keeps at least the mode's ``_RING_MIN`` bytes (float32 keeps
      nothing resident). ``res_off``: each run's byte offset in the
      resident area, which holds the largest block's run.
    * ``cap``: records per piece of a streamed run (a ``_PIECES``-th of the
      ring, or one record), so that that many pieces are in flight.
    * ``layout``: byte offsets of the shared-memory areas, the ring last.

    Raises ``ValueError`` when the ring cannot hold two of the largest
    streamed records."""
    mode, st = prepped["mode"], prepped["stacks"]
    nb = int(n_sms)
    starts = np.zeros((len(_STACKS), 4, nb + 1), np.int32)
    for k in range(4):
        for chain in _BALANCE:
            rot = 0
            for name in chain:
                si = _STACKS.index(name)
                n = st[name]["out"] if k == 3 else st[name]["H"]
                starts[si, k, 1:] = np.cumsum(split_counts(n, nb, rot))
                rot = (rot + n % nb) % nb
    rec = [st[n]["packed"][2] for n in _STACKS]
    most = (starts[:, :, 1:] - starts[:, :, :-1]).max(axis=2)
    mc = [int(most[si, 1:3].max()) for si in range(len(_STACKS))]
    run_bytes = [[int(most[si, k]) * rec[si][k] for k in range(4)]
                 for si in range(len(_STACKS))]

    def align(n, a=16):
        return -(-n // a) * a

    # per phase, each job's [x ; h] as floats (and int8: quantized bytes),
    # padded to 16 items; init_net's inputs and a tail's staging use the
    # same area. The block's own units' committed c and h, both layers of
    # every stack, have an area of their own.
    hpa = {n: _padded(st[n]["H"], 1) for n in _STACKS}
    floats = {n: 2 * hpa[n] for n in _STACKS}
    groups = (("rnn2",), ("rnn3", "rnn7", "rnn8"), ("rnn4",),
              ("rnn7", "rnn8", "rnn6"), ("rnn2", "rnn4"),
              ("rnn7", "rnn8", "rnn6", "rnn3"))
    act = max(max(sum(floats[n] for n in g) for g in groups),
              *(int(w.shape[0]) for w, _ in (prepped["init"] or [])[:2]),
              st["rnn2"]["out"], _TAIL_STAGE)
    actq = max(2 * sum(hpa[n] for n in g) for g in groups)
    layout, off = {}, 0
    for name, size, a in (
            ("bars", 8 * (_RING_BARS + 1), 16),
            ("state", _STATE, 16),
            ("xin", 4 * _XIN, 16),
            ("act", 4 * act, 16),
            ("actq", actq if mode == "int8" else 0, 16),
            ("parts", 2 * 4 * 20 * _WARPS, 16),
            ("red", 4 * (8 * _WARPS + 4), 16),
            ("own", 4 * sum(4 * _padded(m, 4) for m in mc), 16),
            ("tail", _TAIL_SMEM, 16),
            ("tconst", _TAIL_CONST, 16)):
        off = align(off, a)
        layout[name] = off
        off += size
    layout["res"] = off = align(off, 128)
    ring_min = _RING_MIN[mode]
    resident = [[False] * 4 for _ in _STACKS]
    res_off = [[0] * 4 for _ in _STACKS]
    res = 0
    if ring_min is not None:
        for name in _RESIDENT_ORDER:
            si = _STACKS.index(name)
            for k in (1, 2, 0, 3):
                b = run_bytes[si][k]
                if off + res + b + ring_min <= smem_bytes:
                    resident[si][k], res_off[si][k] = True, res
                    res += b
    layout["ring"] = off = align(off + res, 128)
    ring = (smem_bytes - off) // 16 * 16
    if max(st[n]["H"] for n in _STACKS) > 3 * _THREADS:
        raise ValueError(f"serve plan: the kernel takes hidden sizes up to "
                         f"{3 * _THREADS}")
    largest = max([rec[si][k] for si in range(len(_STACKS)) for k in range(4)
                   if not resident[si][k]], default=0)
    if ring < 2 * largest:
        raise ValueError(f"serve plan: a ring of {ring} bytes cannot hold two "
                         f"records of {largest} bytes")
    cap = [[max(1, (ring // _PIECES) // rec[si][k]) for k in range(4)]
           for si in range(len(_STACKS))]
    layout["ring_bytes"] = ring
    layout["total"] = off + ring
    return {"blocks": nb, "starts": starts, "mc": mc, "resident": resident,
            "res_off": res_off, "res_bytes": res, "cap": cap, "rec": rec,
            "layout": layout}


def _gate_record(w):
    r"""An int8 gate matrix and its per-row scales: the record as it is, or
    ``quantize_tensor`` of a dense matrix (what ``quantize_params``
    stores)."""
    return w if _is_qtensor(w) else quantize_tensor(w)


def prepare_serve_params(params, dtype=None, int8_gates=False):
    r"""The kernel's operands of one weight set, built once and reused
    across chunks, as the JAX ``prepare_serve_params`` builds them:

    * ``int8_gates``: int8 ``w_ih``/``w_hh`` with per-row f32 scales (a
      dense matrix is quantized here), linear1/linear2 in bf16 (int8
      records dequantized to bf16);
    * else ``dtype`` (``None``: the weights' own; a quantized tree is first
      dequantized to bf16): every weight matrix in that dtype, float32 or
      bfloat16;
    * in every mode float32 biases, the gate biases summed ``b_ih + b_hh``
      in the tree's dtype, and rnn2's ``init_net`` held in float32 (int8
      records dequantized to bf16 first).

    ``"params"`` holds the same tensors as a parameter tree for the plain
    version: the summed gate bias under ``b_ih`` and zeros under
    ``b_hh``. Each stack also holds the kernel's packed copy of its weights
    (``"packed"``, :func:`pack_stack`). Raises ``ValueError`` for another
    dtype, for stacks that are not 2 layers deep, or unless rnn2/3/7/8
    share one hidden size, as the JAX kernel requires."""
    if int8_gates:
        mode, dtype = "int8", _BF16
    else:
        params = dequantize_params(params)
        if dtype is None:
            dtype = params["rnn2"]["layers"][0]["w_ih"].dtype
        if dtype not in (_F32, _BF16):
            raise ValueError(f"serve kernel: no mode for {dtype} weights; it "
                             "takes float32, bfloat16 or int8 gates")
        mode = "f32" if dtype == _F32 else "bf16"

    def dense(w):
        w = dequantize_tensor(w, dtype) if _is_qtensor(w) else w.to(dtype)
        return w.contiguous()

    stacks, plain = {}, {}
    for name in _STACKS:
        p = params[name]
        if len(p["layers"]) != 2:
            raise ValueError("the serve kernel takes 2-layer stacks")
        w1, w2 = dense(p["linear1"]["w"]), dense(p["linear2"]["w"])
        s = {"w1": w1, "b1": p["linear1"]["b"].to(_F32).contiguous(),
             "bias": [(l["b_ih"] + l["b_hh"]).to(_F32).contiguous()
                      for l in p["layers"]],
             "w2": w2, "b2": p["linear2"]["b"].to(_F32).contiguous(),
             "in": int(w1.shape[1]), "out": int(w2.shape[0])}
        if mode == "int8":
            for k in ("w_ih", "w_hh"):
                recs = [_gate_record(l[k]) for l in p["layers"]]
                s[k] = [r["q"].contiguous() for r in recs]
                s[k + "_s"] = [r["scale"][:, 0].contiguous() for r in recs]
            gates = [{k: {"q": s[k][i], "scale": s[k + "_s"][i][:, None]}
                      for k in ("w_ih", "w_hh")} for i in range(2)]
        else:
            for k in ("w_ih", "w_hh"):
                s[k] = [dense(l[k]) for l in p["layers"]]
            gates = [{k: s[k][i] for k in ("w_ih", "w_hh")}
                     for i in range(2)]
        s["H"] = int(s["w_hh"][0].shape[1])
        s["packed"] = pack_stack(s)
        stacks[name] = s
        plain[name] = {
            "linear1": {"w": w1, "b": s["b1"]},
            "layers": [dict(g, b_ih=b, b_hh=torch.zeros_like(b))
                       for g, b in zip(gates, s["bias"])],
            "linear2": {"w": w2, "b": s["b2"]},
        }
    H = {n: stacks[n]["H"] for n in _STACKS}
    if not H["rnn2"] == H["rnn3"] == H["rnn7"] == H["rnn8"]:
        raise ValueError("serve kernel packs rnn2/3/7/8 state jointly; "
                         "their hidden sizes must match")
    init = params["rnn2"].get("init_net")
    if init is not None:
        init = [((dequantize_tensor(l["w"], _BF16) if _is_qtensor(l["w"])
                  else l["w"]).to(_F32).contiguous(),
                 l["b"].to(_F32).contiguous()) for l in init]
        plain["rnn2"]["init_net"] = [{"w": w, "b": b} for w, b in init]
    return {"params": plain, "stacks": stacks, "init": init, "H": H,
            "mode": mode}


def check_serve_cfg(cfg):
    r"""Refuse what the serve path does not take: the reprojection
    refinement or a disabled vision updater (the JAX serve kernel refuses
    them too)."""
    if cfg.use_reproj_opt or not cfg.use_vision_updater:
        raise ValueError("pallas_serve supports the standard serving "
                         "configuration (vision updater on, no reproj)")


def _bf(t):
    r"""``t`` rounded to bfloat16, held in float32."""
    return t.to(_BF16).to(_F32)


def _plain_stack_step(mode):
    r"""One stack evaluation with the kernel's arithmetic in ``mode``, on a
    stack of ``prepare_serve_params(...)["params"]``: ``(params, x,
    (h, c)) -> (out, (h, c))``, all float32; ``None`` for f32, whose
    arithmetic is ``nn.rnn.rnn_step``'s (the step's default).

    * bf16: the activation side of every product rounded to bf16; sums,
      gates and state in float32.
    * int8: the rounding points of the JAX kernel's int8 cell
      (``pallas_serve.py`` ``cells``, ``lin1``, ``head_out``): x and h cast
      to bf16 and quantized per row, int32 sums, the rescale in float32 and
      bf16 ``zx``, ``zh`` and their sum with the bias; transcendentals in
      float32 rounded to bf16; the cell update in bf16; linear1 and linear2
      with bf16 bias adds."""
    if mode == "f32":
        return None

    def dense_out(lin, x):
        z = _bf(x) @ lin["w"].to(_F32).T
        return _bf(_bf(z) + _bf(lin["b"])) if mode == "int8" else z + lin["b"]

    def int8_cell(layer, x, h, c):
        def gate_half(v, rec):
            q, s = quantize_activation(_bf(v))
            return _bf(_dot_i8(q, rec["q"]).to(_F32) * s * rec["scale"][:, 0])
        z = _bf(_bf(gate_half(x, layer["w_ih"]) + gate_half(h, layer["w_hh"]))
                + _bf(layer["b_ih"]))
        i, f, g, o = z.chunk(4, dim=-1)
        i, f, o = (_bf(torch.sigmoid(v)) for v in (i, f, o))
        g = _bf(torch.tanh(g))
        c_new = _bf(_bf(f * _bf(c)) + _bf(i * g))
        h_new = _bf(o * _bf(torch.tanh(c_new)))
        return h_new, c_new

    def bf16_cell(layer, x, h, c):
        z = _bf(x) @ layer["w_ih"].to(_F32).T \
            + _bf(h) @ layer["w_hh"].to(_F32).T \
            + (layer["b_ih"] + layer["b_hh"])
        i, f, g, o = z.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, c_new

    run_cell = int8_cell if mode == "int8" else bf16_cell

    def step(params, x, state):
        h, c = state
        inp = torch.relu(dense_out(params["linear1"], x))
        new_h, new_c = [], []
        for l, layer in enumerate(params["layers"]):
            inp, cn = run_cell(layer, inp, h[l], c[l])
            new_h.append(inp)
            new_c.append(cn)
        return (dense_out(params["linear2"], inp),
                (torch.stack(new_h), torch.stack(new_c)))

    return step


def serve_scan_plain(prepped, consts, cfg, frames, carry):
    r"""The plain PyTorch version: frame after frame through the branchless
    steady step (``make_step(include_first_frame_step=False,
    cond_updater=False, fuse_spec_heads=False, output_contacts=True)``) with
    the plain tail, every stack evaluated with the kernel's arithmetic in
    the prepared mode. Returns ``(pose [T,24,3,3], tran [T,3],
    contact [T,2], new_carry)``."""
    from ..models import sig_mp   # sig_mp imports this module
    cfg = dataclasses.replace(cfg, pallas_tail=False, pallas_inertial=False,
                              pallas_serve=False)
    step = sig_mp.step_from_constants(
        consts, cfg, include_first_frame_step=False, output_contacts=True,
        fuse_spec_heads=False, cond_updater=False,
        stack_step=_plain_stack_step(prepped["mode"]))
    outs = []
    for t in range(len(frames["conf"])):
        carry, out = step(prepped["params"], carry,
                          sig_mp._frame_at(frames, t))
        outs.append(out)
    pose, tran, contact = (torch.stack(x) for x in zip(*outs))
    return pose, tran, contact, carry


def _lib():
    lib = _build.load("serve_scan")
    fn = lib.serve_scan_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.serve_scan_device_info.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.serve_scan_device_info.restype = ctypes.c_int
    return lib


def _device_plan(prepped, dev):
    r"""The plan of ``prepped`` for the card ``dev`` (one block per SM, all
    of a block's dynamic shared memory) and its block table on the card,
    made once and kept in ``prepped``."""
    key = ("plan", dev.index)
    if key not in prepped:
        info = np.zeros(2, np.int32)
        with torch.cuda.device(dev):
            err = _lib().serve_scan_device_info(MODES.index(prepped["mode"]),
                                                info.ctypes.data)
        if err != 0:
            raise RuntimeError(f"serve_scan: reading the card's attributes "
                               f"failed: CUDA error {err}")
        plan = serve_plan(prepped, int(info[0]), int(info[1]))
        prepped[key] = (plan, torch.as_tensor(plan["starts"]).to(dev))
    return prepped[key]


def _frame_operands(cfg, frames):
    r"""Per-frame kernel inputs of a chunk, as the step computes them frame
    by frame: the IMU in the root frame (rnn2's input) and in the camera
    frame, bbox-normalised and raw keypoints, the root orientation, the
    confidence and its lerp weight, the first-frame flags, first_tran and
    gravity."""
    from ..models.sig_mp import _bbox_center_normalize
    dev = frames["j2dc"].device
    f32, i32 = torch.float32, torch.int32
    j2dc, accc, oric = frames["j2dc"], frames["accc"], frames["oric"]
    T = j2dc.shape[0]
    Rcr = oric[:, -1]
    accr = (accc[:, :, :, None] * Rcr[:, None]).sum(2)
    orir = mat3_mul(Rcr.transpose(-1, -2)[:, None], oric)
    conf_lo, conf_hi = cfg.conf_range
    c = frames["c"]
    return {
        "in2": torch.cat([accr.reshape(T, 18), orir.reshape(T, 54)], 1),
        "raw72": torch.cat([accc.reshape(T, 18), oric.reshape(T, 54)], 1),
        "j2n": _bbox_center_normalize(j2dc).reshape(T, 99),
        "j2r": j2dc.reshape(T, 99),
        "rcr": Rcr.reshape(T, 9),
        "c": c,
        "k_lerp": torch.clamp((c - conf_lo) * (1.0 / (conf_hi - conf_lo)),
                              0.0, 1.0),
        "ff": torch.as_tensor(np.asarray(frames["first_frame"]), dtype=i32
                              ).to(dev),
        "ftv": torch.as_tensor(np.asarray(frames["first_tran_valid"]),
                               dtype=i32).to(dev),
        "first_tran": frames["first_tran"].to(f32),
        "grav": frames["gravityc"].to(f32),
    }


def _launch(prepped, consts, cfg, frames, carry, timestamps=None):
    global LAUNCHES
    dev = frames["j2dc"].device
    f32, i32 = torch.float32, torch.int32
    T = int(frames["j2dc"].shape[0])
    if T < 1:
        raise ValueError("serve_scan needs at least one frame")
    keep = []   # every tensor whose pointer the kernel gets

    def ptr(t, dtype=f32, shape=None):
        if t is None:
            return 0
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"serve kernel operand: expected {dtype} on "
                             f"{dev}, got {t.dtype} on {t.device}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"serve kernel operand: expected shape "
                             f"{tuple(shape)}, got {tuple(t.shape)}")
        t = t.contiguous()
        keep.append(t)
        return t.data_ptr()

    mode = prepped["mode"]
    plan, table = _device_plan(prepped, dev)
    ptrs, ints = [], [MODES.index(mode)]
    states, work = carry["states"], {}
    for si, name in enumerate(_STACKS):
        s = prepped["stacks"][name]
        H, n_out = s["H"], s["out"]
        buf, offsets, rec, lens = s["packed"]
        h0, c0 = states[name]
        hs = torch.zeros((2, 2, H), dtype=f32, device=dev)  # layer, slot
        hs[:, 0] = h0
        cs = c0.to(f32).clone().contiguous()
        work[name] = (hs, cs)
        base = ptr(buf, torch.uint8)
        ptrs += [base + o for o in offsets]
        ptrs += [ptr(hs), ptr(cs, shape=(2, H)),
                 ptr(torch.empty(H, dtype=f32, device=dev)),
                 ptr(torch.empty((2, H), dtype=f32, device=dev)),
                 ptr(torch.zeros(n_out, dtype=f32, device=dev))]
        ints += [s["in"], H, n_out, plan["mc"][si]]
        for k in range(4):
            ints += [rec[k], lens[k], int(plan["resident"][si][k]),
                     plan["res_off"][si][k], plan["cap"][si][k]]

    fo = _frame_operands(cfg, frames)
    for key, width in (("in2", 72), ("raw72", 72), ("j2n", 99), ("j2r", 99),
                       ("rcr", 9)):
        ptrs.append(ptr(fo[key], shape=(T, width)))
    ptrs += [ptr(fo["c"], shape=(T,)), ptr(fo["k_lerp"], shape=(T,)),
             ptr(fo["ff"], i32, (T,)), ptr(fo["ftv"], i32, (T,)),
             ptr(fo["first_tran"], shape=(T, 3)),
             ptr(fo["grav"], shape=(T, 3))]

    last_pfoot = carry["last_pfoot"].to(f32).clone()
    has = torch.stack([carry["has_pfoot"], carry["has_tran"]]).to(
        torch.uint8)
    last_tran = carry["last_tran"].to(f32).clone()
    floor_buf = carry["floor_buf"].to(f32).clone()
    flags = torch.stack([carry["floor_cnt"].to(i32),
                         carry["vision_count"].to(i32),
                         carry["first_reach"].to(i32),
                         torch.zeros((), dtype=i32, device=dev)])
    j_temp = carry["j_temp"].to(f32).clone()
    ptrs += [ptr(last_pfoot, shape=(2, 3)), ptr(has, torch.uint8, (2,)),
             ptr(last_tran, shape=(3,)), ptr(floor_buf, shape=(11, 3)),
             ptr(flags, i32, (4,)), ptr(j_temp, shape=(33, 3)),
             ptr(carry["pc_first"], shape=(3,)),
             ptr(carry["out4_first"], shape=(prepped["stacks"]["rnn4"]["out"],
                                              ))]

    blendshape = bool(consts["blendshape"])
    ptrs += [ptr(consts["parent"], i32, (24,)),
             ptr(consts["bone"], shape=(24, 3)),
             ptr(consts["j0"], shape=(24, 3)),
             ptr(consts["wsub"], shape=(33, 24)),
             ptr(consts["v0sub"], shape=(33, 3)),
             ptr(consts["pd_rows"] if blendshape else None,
                 shape=(99, PD_ROW))]

    use_imu = bool(cfg.use_imu_updater)
    init_n = [0, 0, 0]
    if use_imu:
        if prepped["init"] is None:
            raise ValueError("cfg.use_imu_updater needs rnn2's init_net")
        m = prepped["stacks"]["rnn2"]["out"]
        for i, (w, b) in enumerate(prepped["init"]):
            init_n[i] = int(w.shape[0])
            ptrs += [ptr(w, shape=(init_n[i], m)), ptr(b, shape=(init_n[i],))]
            m = init_n[i]
        if init_n[2] != 4 * prepped["H"]["rnn2"]:
            raise ValueError("rnn2's init_net must give (h, c) of both "
                             "layers")
    else:
        ptrs += [0] * 6

    pose = torch.empty((T, 24, 3, 3), dtype=f32, device=dev)
    tran = torch.empty((T, 3), dtype=f32, device=dev)
    contact = torch.empty((T, 2), dtype=f32, device=dev)
    ptrs += [ptr(torch.empty(_SYN, dtype=f32, device=dev)),
             ptr(torch.empty(max(1, init_n[0] + init_n[1]), dtype=f32,
                             device=dev)),
             ptr(pose), ptr(tran), ptr(contact),
             ptr(table, i32, (len(_STACKS), 4, plan["blocks"] + 1)),
             ptr(timestamps, torch.int64, (T, TS_SLOTS))]
    layout = plan["layout"]
    ints += [T, int(use_imu), int(cfg.live), int(cfg.update_vision_freq),
             int(cfg.use_flat_floor), *init_n,
             plan["blocks"]]
    ints += [layout[k] for k in ("bars", "state", "xin", "act", "actq",
                                 "parts", "red", "own", "tail", "tconst",
                                 "res", "ring", "ring_bytes", "total")]
    conf_lo, conf_hi = cfg.conf_range
    flts = [conf_lo, conf_hi, cfg.contact_threshold, cfg.distance_threshold,
            cfg.tran_filter_num, cfg.height_threshold]

    p_arr = np.asarray(ptrs, dtype=np.int64)
    i_arr = np.asarray(ints, dtype=np.int32)
    f_arr = np.asarray(flts, dtype=np.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().serve_scan_launch(p_arr.ctypes.data, len(p_arr),
                                   i_arr.ctypes.data, len(i_arr),
                                   f_arr.ctypes.data, len(f_arr), stream)
    if err != 0:
        raise RuntimeError(f"serve_scan kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1

    slot = T % 2
    new_carry = dict(carry)
    new_carry.update({
        "states": {n: (work[n][0][:, slot].contiguous(), work[n][1])
                   for n in _STACKS},
        "last_pfoot": last_pfoot, "has_pfoot": has[0].bool(),
        "last_tran": last_tran, "has_tran": has[1].bool(),
        "floor_buf": floor_buf, "floor_cnt": flags[0],
        "vision_count": flags[1], "first_reach": flags[2].bool(),
        "j_temp": j_temp,
    })
    return pose, tran, contact, new_carry


def serve_scan(prepped, consts, cfg, frames, carry, timestamps=None):
    r"""Run a chunk through the serving step: one kernel launch on CUDA
    tensors, the plain version on CPU tensors.

    ``prepped`` from :func:`prepare_serve_params`; ``consts`` the tail
    constants (``ops.geometry_tail.tail_constants``); ``frames`` as from
    ``models.sig_mp._sequence_frames`` (the kernel reads the confidence
    ``c`` computed there and compares it in float32); ``carry`` the steady
    carry after ``prescan_first_frame``. Returns ``(pose [T,24,3,3],
    tran [T,3], contact [T,2], new_carry)``.

    ``timestamps``, on the card only: an int64 ``[T, TS_SLOTS]`` tensor of
    zeros that the kernel fills with block 0's ``%globaltimer`` (ns) at
    fixed points of each frame (``chip_smoke.py``'s ``serve_split`` reads
    them); ``None`` on the main path."""
    check_serve_cfg(cfg)
    dev = frames["j2dc"].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no serve path for device {dev}")
    if bool(cfg.int8_compute) != (prepped["mode"] == "int8"):
        raise ValueError("cfg.int8_compute requires int8_gates prepped "
                         "params (and vice versa)")
    if dev.type == "cpu":
        if timestamps is not None:
            raise ValueError("timestamps come from the kernel on the card")
        return serve_scan_plain(prepped, consts, cfg, frames, carry)
    return _launch(prepped, consts, cfg, frames, carry, timestamps)

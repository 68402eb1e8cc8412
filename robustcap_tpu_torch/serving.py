r"""Serving bundles: the streaming step exported ahead of time.

Port of ``robustcap_tpu/serving.py``. :func:`export_serving_bundle` writes
the per-frame steady step and the first-frame prescan as ``torch.export``
programs, with the weights and the configuration, into a directory that
:meth:`ServingBundle.load` restores without the model code path: no
re-trace, and the programs take the weights at run time, so the same
programs serve re-trained weights of the same shapes.

Bundle layout (directory)::

    manifest.json   format version, device type, config, torch version,
                    chunk lengths and chunk mode
    weights.pt      the parameter tree (torch.save; int8 records kept)
    step.pt2        step(params, carry, frame) -> (carry, (pose, tran))
    prescan.pt2     prescan(params, carry, frame) -> carry
    chunk.pt2       with cfg.pallas_serve: chunk(bank, carry, frames)
    chunk_<K>.pt2   -> (carry, (poses, trans)), one per extra length

What differs from the JAX bundle, with the same values:

* The step is the branchless batched step (``sig_mp.make_batched_step``)
  at B=1, where the JAX bundle exports the ``lax.cond`` form. Both compute
  the same values; the branchless one reads nothing back to the host, so it
  exports as one program and replays as a CUDA graph
  (``graphs.GraphedStep``): on the card ``forward_online`` replays the
  step program through a graph, after the prescan program on a first frame.
  The programs take the prepared weights (``nn.rnn.prepare_scan_params``,
  keys sorted), which ``load`` makes once from ``weights.pt``.
* With ``cfg.pallas_serve`` a chunk program is the serve kernel, the
  operator ``torch.ops.robustcap.serve_scan`` (``ops/serve_scan.py``) around
  the frame operands: one launch per chunk, as in JAX. ``load`` rebuilds the
  kernel's bank from ``weights.pt`` (``serve_params_for``, the mode
  ``StreamingNet`` picks) and passes it to the program.
* Without it the chunk mode is ``"step_loop"``: ``torch.export`` has no scan
  that would hold K frames of the step, so ``forward_chunk`` runs the step
  program K times (graphed on the card), where JAX exports an XLA scan
  (``"xla_scan"``). The manifest lists the lengths it takes, as in JAX.
* ``device`` takes the place of JAX's ``platforms``: the programs are
  exported for one device type and load only there.
* With ``cfg.pallas_tail`` the step program holds the tail kernel as the
  operator ``torch.ops.robustcap.geometry_tail`` (``ops/geometry_tail.py``,
  one launch over the batch's rows), twice a frame with the vision updater
  (the speculative and the final tail), as the JAX step carries its tail
  kernel; the graph that ``forward_online`` replays holds those launches,
  and so do the step-loop chunks. A program that holds the operator loads
  where ``robustcap_tpu_torch`` is imported, which registers it.
* ``cfg.pallas_inertial`` raises at export. The JAX bundle accepts it and
  never runs the LSTM-scan kernel: its step and prescan take no chunk
  pre-scan, and its ``xla_scan`` chunks scan the per-frame step. The port
  refuses the flag rather than export a program that ignores it.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from .config import SigMPConfig
from .device import resolve_device, tree_map
from .graphs import GraphedStep
from .models import sig_mp
from .nn.rnn import prepare_scan_params
from .ops import serve_scan as S
from .ops.geometry_tail import tail_constants

__all__ = ["export_serving_bundle", "ServingBundle"]

_FORMAT_VERSION = 1


class _Program(torch.nn.Module):
    r"""A function of tensor trees as a module, for ``torch.export``."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export(fn, args, path):
    r"""Export ``fn`` on ``args`` to ``path``. The example inputs (the
    weights among them) are dropped before saving, so that the file holds
    the program alone."""
    prog = torch.export.export(_Program(fn), tuple(args), strict=False)
    prog.example_inputs = None
    torch.export.save(prog, path)


def _program_params(params, cfg):
    r"""The weights as the step and prescan programs take them: prepared
    (``prepare_scan_params``) and every dict's keys sorted, since an
    exported program checks the order of its inputs' keys, and trees of
    the same weights come in several orders (``init_params``, a JAX tree,
    a checkpoint)."""
    def tidy(tree):
        if isinstance(tree, dict):
            return {k: tidy(tree[k]) for k in sorted(tree)}
        if isinstance(tree, (list, tuple)):
            return type(tree)(tidy(v) for v in tree)
        return tree

    return tidy(prepare_scan_params(params, cfg.int8_compute))


def _online_frame(j2dc, accc, oric, first_tran=None, first_frame=False,
                  gravityc=None):
    r"""One frame as the B=1 step program takes it: ``[1, ...]`` host
    tensors, the flags as ``[1]`` bool tensors. This function also makes the
    export's example, so the key order always matches the program's."""
    def f32(x, *shape):
        return torch.tensor(np.asarray(x, np.float32)).reshape(1, *shape)

    return {
        "j2dc": f32(j2dc, 33, 3),
        "accc": f32(accc, 6, 3),
        "oric": f32(oric, 6, 3, 3),
        "first_tran": f32(np.zeros(3) if first_tran is None else first_tran,
                          3),
        "gravityc": f32(sig_mp.DEFAULT_GRAVITY if gravityc is None
                        else gravityc, 3),
        "first_frame": torch.tensor([bool(first_frame)]),
        "first_tran_valid": torch.tensor([first_tran is not None]),
    }


def _chunk_frames(j2dc, accc, oric, gravityc, dev):
    r"""K frames as a chunk program takes them (``sig_mp._sequence_frames``
    with its host fields as tensors): the confidence computed on the host
    as ``StreamingNet`` computes it, so the kernel gets the same operands."""
    frames = sig_mp._sequence_frames(j2dc, accc, oric, None, False, gravityc,
                                     dev)
    out = {k: frames[k].contiguous() for k in
           ("j2dc", "accc", "oric", "first_tran", "gravityc", "c")}
    for k in ("first_frame", "first_tran_valid"):
        out[k] = torch.as_tensor(frames[k]).to(dev)
    return out


def _unbatch(carry):
    r"""The B=1 carry (states ``[L, 1, H]``, the rest ``[1, ...]``) as the
    single-stream carry, its keys in the same order (an exported program
    checks the order of its inputs' keys)."""
    return {k: {n: tuple(x[:, 0] for x in hc) for n, hc in v.items()}
            if k == "states" else v[0] for k, v in carry.items()}


def _batch(carry):
    r"""The inverse of :func:`_unbatch`."""
    return {k: {n: tuple(x[:, None] for x in hc) for n, hc in v.items()}
            if k == "states" else v[None] for k, v in carry.items()}


def _chunk_program(prepped, consts, cfg):
    r"""``chunk(bank, carry, frames) -> (carry, (poses, trans))``: the serve
    kernel over one chunk, on the bank of :func:`ops.serve_scan.serve_bank`
    (given at run time) laid out as ``prepped``'s."""
    mode, layout = S.bank_layout(prepped)

    def chunk(bank, carry, frames):
        pose, tran, _, new_carry = S.serve_scan(
            S.bank_prepped(mode, layout, bank), consts, cfg, frames, carry)
        return new_carry, (pose, tran)

    return chunk


def _check_export_cfg(cfg):
    if cfg.pallas_inertial:
        raise ValueError(
            "export_serving_bundle: no exported program runs the LSTM-scan "
            "chunk pre-scan (cfg.pallas_inertial); export with it off")


def export_serving_bundle(params, body_model, cfg: SigMPConfig, path: str,
                          chunk_len: int = 0, extra_chunk_lens=(),
                          device="cuda") -> dict:
    r"""Export the steady streaming step and the first-frame prescan, and
    with ``chunk_len > 0`` or ``extra_chunk_lens`` chunk programs of those
    lengths, to the directory ``path``; returns the manifest.

    The programs are exported for ``device``'s type (params and body model
    must already be on ``device``) and take the weights at run time, so
    ``step.pt2`` does not grow with the network's widths. With
    ``cfg.pallas_serve`` each chunk length gets a program around the serve
    kernel (``chunk.pt2`` for ``chunk_len``, ``chunk_<K>.pt2`` for the
    others); without it the chunk mode is ``"step_loop"`` and no chunk
    program is written (see the module docstring). With
    ``cfg.pallas_tail`` the step program holds the tail operator. Raises
    ``ValueError`` for ``cfg.pallas_inertial``."""
    _check_export_cfg(cfg)
    dev = resolve_device(device)
    sig_mp._require_device(params, body_model, dev)
    os.makedirs(path, exist_ok=True)
    scan_p = _program_params(params, cfg)
    carry = sig_mp.init_carry(params, batch_shape=(1,))
    frame = tree_map(lambda t: t.to(dev),
                     _online_frame(np.zeros((33, 3)), np.zeros((6, 3)),
                                   np.tile(np.eye(3), (6, 1, 1))))
    step = sig_mp.make_batched_step(body_model, cfg)

    def prescan(params_, carry_, frame_):
        return sig_mp.prescan_first_frame(params_, body_model, carry_, frame_,
                                          cfg.int8_compute)

    _export(step, (scan_p, carry, frame), os.path.join(path, "step.pt2"))
    _export(prescan, (scan_p, carry, frame),
            os.path.join(path, "prescan.pt2"))

    extra_chunk_lens = tuple(int(k) for k in extra_chunk_lens)
    lengths = ((int(chunk_len),) if chunk_len > 0 else ()) + extra_chunk_lens
    chunk_mode = None
    if lengths:
        chunk_mode = "pallas_serve" if cfg.pallas_serve else "step_loop"
    if chunk_mode == "pallas_serve":
        prepped = S.serve_params_for(params, cfg)
        chunk = _chunk_program(prepped, tail_constants(body_model), cfg)
        carry1 = sig_mp.init_carry(params)
        for K in lengths:
            frames = _chunk_frames(np.zeros((K, 33, 3)), np.zeros((K, 6, 3)),
                                   np.tile(np.eye(3), (K, 6, 1, 1)), None,
                                   dev)
            name = "chunk.pt2" if K == chunk_len else f"chunk_{K}.pt2"
            _export(chunk, (S.serve_bank(prepped), carry1, frames),
                    os.path.join(path, name))

    torch.save(tree_map(lambda t: t.detach().cpu(), params),
               os.path.join(path, "weights.pt"))
    manifest = {
        "format_version": _FORMAT_VERSION,
        "device": dev.type,
        "config": dataclasses.asdict(cfg),
        "torch_version": torch.__version__,
        "chunk_len": int(chunk_len),
        "extra_chunk_lens": list(extra_chunk_lens),
        "chunk_mode": chunk_mode,
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


class ServingBundle:
    r"""A loaded bundle: the reference's ``forward_online`` API (and
    ``forward_chunk``) over the exported programs, without the model code.

    ``step_fn`` and ``prescan_fn`` are the loaded programs, callable eagerly
    as ``step_fn(scan_params, carry, frame)`` on the prepared weights
    ``scan_params``; ``forward_online`` replays the step through a CUDA
    graph on the card."""

    def __init__(self, step_fn, prescan_fn, params, cfg: SigMPConfig,
                 manifest: dict, device):
        self.step_fn = step_fn
        self.prescan_fn = prescan_fn
        self.params = params
        self.cfg = cfg
        self.manifest = manifest
        self.device = device
        self.scan_params = _program_params(params, cfg)
        self._online = GraphedStep(
            step_fn, self.scan_params,
            sig_mp.init_carry(params, batch_shape=(1,)))
        self._chunks = {}
        self._bank = None
        self.reset_states()

    @classmethod
    def load(cls, path: str, device="cuda") -> "ServingBundle":
        r"""Load the bundle at ``path`` onto ``device``. Raises
        ``ValueError`` for another format version or a bundle exported for
        another device type."""
        dev = resolve_device(device)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest.get("format_version") != _FORMAT_VERSION:
            raise ValueError(
                f"serving bundle format {manifest.get('format_version')} "
                f"!= {_FORMAT_VERSION}")
        if manifest["device"] != dev.type:
            raise ValueError(
                f"bundle exported for device type {manifest['device']!r}, "
                f"cannot load on {dev}")
        cfg_dict = dict(manifest["config"])
        # JSON degrades tuples to lists
        cfg_dict["conf_range"] = tuple(cfg_dict["conf_range"])
        cfg = SigMPConfig(**cfg_dict)
        params = torch.load(os.path.join(path, "weights.pt"),
                            map_location=dev, weights_only=True)

        def program(name):
            return torch.export.load(os.path.join(path, name)).module()

        bundle = cls(program("step.pt2"), program("prescan.pt2"), params,
                     cfg, manifest, dev)
        lengths = list(manifest.get("extra_chunk_lens") or ())
        if manifest.get("chunk_len"):
            lengths.insert(0, int(manifest["chunk_len"]))
        for K in lengths:
            if manifest["chunk_mode"] == "pallas_serve":
                name = ("chunk.pt2" if K == manifest["chunk_len"]
                        else f"chunk_{K}.pt2")
                bundle._chunks[K] = program(name)
            else:
                bundle._chunks[K] = None
        if manifest["chunk_mode"] == "pallas_serve":
            bundle._bank = S.serve_bank(S.serve_params_for(params, cfg))
        return bundle

    @property
    def carry(self):
        r"""The stream's carry, B=1 (the step program's layout)."""
        return self._online.carry

    def reset_states(self):
        self._online.set_carry(sig_mp.init_carry(self.params,
                                                 batch_shape=(1,)))

    def forward_online(self, j2dc, accc, oric, first_tran=None,
                       first_frame=False, gravityc=None):
        r"""One frame -> (pose [24, 3, 3], tran [3]): the prescan program
        first on a first frame, then the step program (replayed through a
        CUDA graph on the card)."""
        frame = _online_frame(j2dc, accc, oric, first_tran, first_frame,
                              gravityc)
        if first_frame:
            frame = tree_map(lambda t: t.to(self.device), frame)
            self._online.set_carry(self.prescan_fn(
                self.scan_params, self._online.carry, frame))
        pose, tran = self._online(frame)
        return pose[0], tran[0]

    def forward_chunk(self, j2dc, accc, oric, gravityc=None):
        r"""Advance K frames (no first-frame flags) -> (pose [K, 24, 3, 3],
        tran [K, 3]), for an exported length K: one chunk program (one
        serve-kernel launch) with ``chunk_mode == "pallas_serve"``, else K
        steps of the step program. Raises ``ValueError`` for another
        length."""
        if not self._chunks:
            raise ValueError("bundle was exported without a chunk program "
                             "(export_serving_bundle(chunk_len=K))")
        K = int(np.asarray(j2dc).reshape(-1, 33, 3).shape[0])
        if K not in self._chunks:
            raise ValueError(
                f"no chunk program for {K} frames (exported lengths: "
                f"{sorted(self._chunks)})")
        if self._chunks[K] is not None:
            frames = _chunk_frames(j2dc, accc, oric, gravityc, self.device)
            carry, (pose, tran) = self._chunks[K](
                self._bank, _unbatch(self._online.carry), frames)
            self._online.set_carry(_batch(carry))
            return pose, tran
        j2dc = np.asarray(j2dc, np.float32).reshape(K, 33, 3)
        accc = np.asarray(accc, np.float32).reshape(K, 6, 3)
        oric = np.asarray(oric, np.float32).reshape(K, 6, 3, 3)
        grav = (None if gravityc is None else np.broadcast_to(
            np.asarray(gravityc, np.float32).reshape(-1, 3), (K, 3)))
        outs = [self._online(_online_frame(
            j2dc[t], accc[t], oric[t],
            gravityc=None if grav is None else grav[t])) for t in range(K)]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))


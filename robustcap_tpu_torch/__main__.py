r"""Command-line interface of the port: the offline evaluation and the
serving workflows.

    python -m robustcap_tpu_torch eval [--dataset aist|tc|pw3d|pw3d_occ]
        [--weights W] [--no-smplify] [--no-cache] [--device cuda]
    python -m robustcap_tpu_torch export --out DIR [--weights W] [--live]
        [--int8-compute] [--chunk-len K --pallas-serve] [--device cuda]
    python -m robustcap_tpu_torch latency [--weights W] [--frames N]
        [--trace-dir DIR] [--int8-compute] [--device cuda]
    python -m robustcap_tpu_torch live-server [--weights W | --bundle DIR]
        [--device cuda]

The flags are the JAX package's (``python -m robustcap_tpu``), with
``--device`` in place of ``--platforms``. ``--weights`` reads the
reference's ``.pt`` checkpoint, or a pickle of the JAX package's parameter
tree (``train.save_pytree``) whose arrays are float32 or int8; without it
the weights are random (seed 0). ``eval`` reads the datasets and caches
under ``config.paths`` and prints the mean MPJPE, PVE, PA-MPJPE and root
position error in metres. The other subcommands are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pickle
import sys

__all__ = ["main"]


class _NumpyTreeUnpickler(pickle.Unpickler):
    r"""Unpickles a tree of numpy arrays and nothing else."""

    def find_class(self, module, name):
        if module.split(".")[0] == "ml_dtypes":
            raise ValueError(
                "this pickle holds bfloat16 arrays, which need the ml_dtypes "
                "package; save the tree with float32 (or int8) arrays instead")
        if module.split(".")[0] == "numpy" or (module, name) in (
                ("builtins", "dict"), ("builtins", "list"),
                ("builtins", "tuple"), ("collections", "OrderedDict")):
            return super().find_class(module, name)
        raise ValueError(f"weights pickle: refusing to load {module}.{name}")


def _load_params(args):
    from robustcap_tpu_torch.models import sig_mp
    if args.weights:
        if args.weights.endswith(".pt"):
            from robustcap_tpu_torch.convert import load_torch_checkpoint
            return load_torch_checkpoint(args.weights, args.device)
        from robustcap_tpu_torch.convert import params_from_numpy
        with open(args.weights, "rb") as f:
            tree = _NumpyTreeUnpickler(f).load()
        return params_from_numpy(tree, args.device)
    import torch
    print("warning: no --weights given; using random parameters",
          file=sys.stderr)
    return sig_mp.init_params(torch.Generator().manual_seed(0),
                              device=args.device)


def cmd_eval(args):
    r"""Evaluate on one dataset (``eval/evaluate.py``), SMPLify included
    unless ``--no-smplify``."""
    from robustcap_tpu_torch.eval import (evaluate_aist_ours,
                                          evaluate_pw3d_ours,
                                          evaluate_tc_ours)
    kw = dict(run_smplify=not args.no_smplify, params=_load_params(args),
              use_cache=not args.no_cache, device=args.device)
    if args.dataset == "aist":
        out = evaluate_aist_ours(**kw)
    elif args.dataset in ("tc", "totalcapture"):
        out = evaluate_tc_ours(**kw)
    else:
        out = evaluate_pw3d_ours(occ=args.dataset == "pw3d_occ", **kw)
    print(json.dumps({k: out[k] for k in
                      ("mpjpe", "pve", "pampjpe", "tran_error")}))


def _int8_mode(params, cfg):
    r"""Quantize the weights and set ``cfg.int8_compute``."""
    from robustcap_tpu_torch.nn.rnn import quantize_params
    return quantize_params(params), dataclasses.replace(cfg,
                                                        int8_compute=True)


def cmd_latency(args):
    from robustcap_tpu_torch.config import SigMPConfig
    from robustcap_tpu_torch.smpl import default_body_model
    from robustcap_tpu_torch.streaming import measure_streaming_latency
    params = _load_params(args)
    cfg = None
    if args.int8_compute:
        params, cfg = _int8_mode(params, SigMPConfig.live_mode())
    stats = measure_streaming_latency(params, default_body_model(args.device),
                                      cfg=cfg, n_frames=args.frames,
                                      trace_dir=args.trace_dir,
                                      device=args.device)
    print(json.dumps(stats))


def cmd_live_server(args):
    from robustcap_tpu_torch.streaming import run_live_demo
    if args.bundle:
        from robustcap_tpu_torch.serving import ServingBundle
        run_live_demo(net=ServingBundle.load(args.bundle, args.device),
                      device=args.device)
    else:
        run_live_demo(_load_params(args), device=args.device)


def cmd_export(args):
    r"""Export the streaming step to a serving bundle
    (``robustcap_tpu_torch/serving.py``)."""
    from robustcap_tpu_torch.config import SigMPConfig
    from robustcap_tpu_torch.serving import export_serving_bundle
    from robustcap_tpu_torch.smpl import default_body_model
    params = _load_params(args)
    cfg = SigMPConfig.live_mode() if args.live else SigMPConfig()
    if args.int8_compute:
        params, cfg = _int8_mode(params, cfg)
    if args.chunk_len and args.pallas_serve:
        cfg = dataclasses.replace(cfg, pallas_serve=True)
    manifest = export_serving_bundle(
        params, default_body_model(args.device), cfg, args.out,
        chunk_len=args.chunk_len, device=args.device)
    print(json.dumps({"out": args.out, "device": manifest["device"],
                      "chunk_mode": manifest["chunk_mode"]}))


def main(argv=None):
    p = argparse.ArgumentParser(prog="robustcap_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_flag(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device (default: the CUDA card)")

    pe = sub.add_parser("eval", help="offline dataset evaluation")
    pe.add_argument("--dataset", default="aist",
                    choices=["aist", "tc", "totalcapture", "pw3d",
                             "pw3d_occ"])
    pe.add_argument("--weights")
    pe.add_argument("--no-smplify", action="store_true")
    pe.add_argument("--no-cache", action="store_true")
    device_flag(pe)
    pe.set_defaults(fn=cmd_eval)

    pl = sub.add_parser("latency", help="streaming latency harness")
    pl.add_argument("--weights")
    pl.add_argument("--frames", type=int, default=600)
    pl.add_argument("--trace-dir")
    pl.add_argument("--int8-compute", action="store_true",
                    help="int8-gate serving mode (quantizes the weights if "
                         "the checkpoint is not already int8)")
    device_flag(pl)
    pl.set_defaults(fn=cmd_latency)

    ps = sub.add_parser("live-server", help="live inference server")
    ps.add_argument("--weights")
    ps.add_argument("--bundle",
                    help="serve an exported bundle (export subcommand)")
    device_flag(ps)
    ps.set_defaults(fn=cmd_live_server)

    px = sub.add_parser("export",
                        help="export the streaming step to a serving "
                             "bundle (no re-trace at load)")
    px.add_argument("--weights")
    px.add_argument("--out", required=True, help="bundle directory")
    px.add_argument("--live", action="store_true",
                    help="live-demo flag set (conf gates, throttle)")
    px.add_argument("--int8-compute", action="store_true",
                    help="quantize weights and export the int8-gate mode")
    px.add_argument("--chunk-len", type=int, default=0,
                    help="also export a K-frame chunk program")
    px.add_argument("--pallas-serve", action="store_true",
                    help="chunk program = the serve kernel "
                         "(ops/serve_scan.py)")
    device_flag(px)
    px.set_defaults(fn=cmd_export)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

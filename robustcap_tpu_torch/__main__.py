r"""Command-line interface of the port: the offline evaluation, training
and the serving workflows.

    python -m robustcap_tpu_torch eval [--dataset aist|tc|pw3d|pw3d_occ]
        [--weights W] [--no-smplify] [--no-cache] [--device cuda]
    python -m robustcap_tpu_torch train --aist DIR [--amass DIR]
        [--rnn all|2|3|4|6|7|8] [--device cuda]
    python -m robustcap_tpu_torch quantize --weights W --out PATH
        [--torch-save] [--device cuda]
    python -m robustcap_tpu_torch export --out DIR [--weights W] [--live]
        [--int8-compute] [--chunk-len K --pallas-serve] [--device cuda]
    python -m robustcap_tpu_torch latency [--weights W] [--frames N]
        [--trace-dir DIR] [--int8-compute] [--device cuda]
    python -m robustcap_tpu_torch live-server [--weights W | --bundle DIR]
        [--device cuda]
    python -m robustcap_tpu_torch imu-bridge
    python -m robustcap_tpu_torch preprocess --dataset aist|aist_pre|tc_pre|
        tc|pw3d|pw3d_occ|amass --raw DIR [--out DIR] [--kinds test]
        [--device cuda]

The flags are the JAX package's (``python -m robustcap_tpu``), with
``--device`` in place of ``--platforms``. ``--weights`` reads the
reference's ``.pt`` checkpoint, or a pickle of a parameter tree
(``train.save_pytree`` of either package) whose arrays are float32 or int8;
without it the weights are random (seed 0). ``eval`` reads the datasets and
caches under ``config.paths`` and prints the mean MPJPE, PVE, PA-MPJPE and
root position error in metres. ``train`` reads ``train.pt`` and ``val.pt``
from each directory, trains the chosen modules into
``config.paths.weight_dir/sig_mp`` (``all`` trains the six and merges them
into ``best_weights.pkl``). ``quantize`` writes the int8 tree as a pickle,
or with ``--torch-save`` as a ``torch.save`` checkpoint
(``train.save_checkpoint``). ``preprocess`` turns a raw corpus tree into
the work ``.pt`` dicts (``preprocess/corpus.py``; ``amass`` walks the
``config.AmassSplits`` corpora into ``train.pt`` and ``val.pt``).
``imu-bridge`` connects the Xsens DOTs of ``config.LiveConfig`` over BLE
(it needs the ``bleak`` package) and forwards their samples as UDP packets
(``sensors/bridge.py``); it does no tensor work, so it takes no
``--device`` and joins no distributed job.

Under ``torchrun`` (or with ``ROBUSTCAP_COORDINATOR`` and its companions
set) the command first joins the job (``parallel.initialize_distributed``),
and ``train`` and ``eval`` then split their batches over its ranks.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

__all__ = ["main"]


def _load_params(args):
    from robustcap_tpu_torch.models import sig_mp
    if args.weights:
        if args.weights.endswith(".pt"):
            from robustcap_tpu_torch.convert import load_torch_checkpoint
            return load_torch_checkpoint(args.weights, args.device)
        from robustcap_tpu_torch.train.loop import load_pytree
        return load_pytree(args.weights, args.device)
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
              use_cache=not args.no_cache, device=args.device,
              mesh=args.mesh)
    if args.dataset == "aist":
        out = evaluate_aist_ours(**kw)
    elif args.dataset in ("tc", "totalcapture"):
        out = evaluate_tc_ours(**kw)
    else:
        out = evaluate_pw3d_ours(occ=args.dataset == "pw3d_occ", **kw)
    print(json.dumps({k: out[k] for k in
                      ("mpjpe", "pve", "pampjpe", "tran_error")}))


def cmd_train(args):
    r"""Train one module or all six (``train/trainers.py``)."""
    from robustcap_tpu_torch.eval.datasets import load_torch_file
    from robustcap_tpu_torch.train import trainers

    def pair(root):
        if not root:
            return None, None
        return tuple(load_torch_file(os.path.join(root, f"{kind}.pt"))
                     for kind in ("train", "val"))

    aist_tr, aist_va = pair(args.aist)
    amass_tr, amass_va = pair(args.amass)
    kw = {"device": args.device}
    if args.mesh is not None:
        kw.update(device=args.mesh.device, mesh=args.mesh)
    if args.rnn == "all":
        trainers.train_all(aist_tr, aist_va, amass_tr, amass_va, **kw)
    elif args.rnn == "8":
        trainers.train_rnn8(amass_tr, amass_va, **kw)
    else:
        getattr(trainers, f"train_rnn{args.rnn}")(aist_tr, aist_va, amass_tr,
                                                   amass_va, **kw)


def cmd_preprocess(args):
    r"""A raw corpus tree into work dicts (``preprocess/corpus.py``); prints
    what was written."""
    from robustcap_tpu_torch.preprocess import corpus
    dev = args.device
    if args.dataset == "aist":
        out = corpus.preprocess_aist(args.raw, args.out,
                                     kinds=args.kinds.split(","), device=dev)
    elif args.dataset == "aist_pre":
        out = {"not_aligned": corpus.write_not_aligned(
            args.raw, out_path=args.out or None, device=dev)}
    elif args.dataset in ("tc_pre", "totalcapture_pre"):
        out = {"out": corpus.preprocess_totalcapture_pre(args.raw,
                                                         device=dev)}
    elif args.dataset in ("tc", "totalcapture"):
        out = {"sequences": corpus.preprocess_totalcapture(
            args.raw, args.out, device=dev)}
    elif args.dataset in ("pw3d", "pw3d_occ"):
        out = {"person_sequences": corpus.preprocess_3dpw(
            args.raw, args.out, occ=args.dataset.endswith("occ"),
            device=dev)}
    else:
        from robustcap_tpu_torch.config import AmassSplits
        from robustcap_tpu_torch.preprocess import preprocess_amass
        from robustcap_tpu_torch.smpl import default_body_model
        done = preprocess_amass(
            default_body_model(dev), args.raw, args.out,
            {"train": AmassSplits.train, "val": AmassSplits.val}, device=dev)
        out = {kind: len(agg["pose"]) for kind, agg in done.items()}
    print(json.dumps(out))


def cmd_quantize(args):
    r"""The int8 serving weights of a checkpoint: every 2-D weight as an
    int8 record (``nn.rnn.quantize_params``)."""
    from robustcap_tpu_torch.nn.rnn import quantize_params
    from robustcap_tpu_torch.train import save_checkpoint, save_pytree
    from robustcap_tpu_torch.train.loop import _tensor_leaves
    qp = quantize_params(_load_params(args))
    (save_checkpoint if args.torch_save else save_pytree)(qp, args.out)
    nbytes = sum(t.numel() * t.element_size() for t in _tensor_leaves(qp))
    print(json.dumps({"out": args.out, "bytes": int(nbytes)}))


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


def cmd_imu_bridge(args):
    from robustcap_tpu_torch.sensors import run_imu_bridge
    run_imu_bridge()


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

    pb = sub.add_parser("imu-bridge", help="BLE IMU -> UDP bridge")
    pb.set_defaults(fn=cmd_imu_bridge, device=None)

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

    pt = sub.add_parser("train", help="train fusion RNNs")
    pt.add_argument("--rnn", default="all",
                    choices=["all", "2", "3", "4", "6", "7", "8"])
    pt.add_argument("--aist", required=True)
    pt.add_argument("--amass")
    device_flag(pt)
    pt.set_defaults(fn=cmd_train)

    pq = sub.add_parser("quantize",
                        help="int8-quantize a checkpoint for serving")
    pq.add_argument("--weights", required=True,
                    help="reference .pt or a parameter-tree pickle")
    pq.add_argument("--out", required=True, help="output path")
    pq.add_argument("--torch-save", action="store_true",
                    help="write a torch.save checkpoint instead of a pickle")
    device_flag(pq)
    pq.set_defaults(fn=cmd_quantize)

    pp = sub.add_parser("preprocess", help="raw corpus -> work .pt dicts")
    pp.add_argument("--dataset", required=True,
                    choices=["aist", "aist_pre", "tc_pre", "totalcapture_pre",
                             "tc", "totalcapture", "pw3d", "pw3d_occ",
                             "amass"])
    pp.add_argument("--raw", required=True, help="raw corpus root")
    pp.add_argument("--out", default="", help="output work dir / file")
    pp.add_argument("--kinds", default="test",
                    help="comma-separated splits (aist)")
    device_flag(pp)
    pp.set_defaults(fn=cmd_preprocess)

    args = p.parse_args(argv)
    # a no-op unless a coordinator is configured (torchrun's variables or
    # ROBUSTCAP_COORDINATOR and its companions)
    from robustcap_tpu_torch.parallel import (initialize_distributed,
                                              make_global_mesh)
    args.mesh = None
    if (args.device is not None
            and initialize_distributed(device=args.device).enabled):
        args.mesh = make_global_mesh(device=args.device)
    args.fn(args)


if __name__ == "__main__":
    main()

r"""Readings for the limits of a cell's comparison, many seeds in one
process on the card:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 10 [--control]

Without ``--control``: a run of the cell per seed (``--seconds`` of
window, as ``run.py`` runs it), printing the numbers compared. With it:
the control's numbers per seed (``portbench/control.py``). One JSON line
per seed.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import run
    run._environment()
    import torch
    from portbench.control import control_numbers
    from portbench.harness import Context
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = Context(args.workload, seed, args.seconds, False)
        if args.control:
            out = {"numbers": control_numbers(ctx, dev)}
        else:
            res, _, _, numbers = run.run(ctx, t0)
            out = {"numbers": numbers, "correct": res["correct"],
                   "metrics": res["metrics"]}
        out.update(workload=args.workload, seed=seed,
                   control=args.control,
                   seconds=round(time.perf_counter() - t0, 3))
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

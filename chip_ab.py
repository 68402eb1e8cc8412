r"""Compare the port's kernels across checkouts of the repo on one card, in
one call.

    python3 chip_ab.py [--split] DIR [DIR ...]

Each ``DIR`` is a checkout of the repo, for example the parent commit and a
change unpacked side by side with ``git archive``. List them in the order
to run, such as parent, change, change, parent, so that drift of the card
over the call falls on both sides. For each ``DIR`` the script prints what
``ptxas`` reports for every ``robustcap_tpu_torch/csrc/*.cu`` of that
checkout (each entry function, its registers, stack, spills), then runs that
checkout's ``chip_smoke.py`` LSTM-scan, tail and serve phases (2, 3 and 5;
a checkout without the serve kernel skips 5) in a fresh process and prints
their result lines. With ``--split`` it runs only the serve kernel's
in-launch timestamp split of each checkout (``chip_smoke.serve_split_modes``;
the checkout's kernel must take the timestamp buffer) and prints only the
serve kernel's ``ptxas`` report. Needs a CUDA card and ``nvcc``; the cubins
go to each checkout's ``robustcap_tpu_torch/_build/``.
"""

import glob
import os
import re
import subprocess
import sys

_KEEP = re.compile(r"^\[(ptxas|lstm_scan|geometry_tail|serve_scan)\]"
                   r"|^\[main\] serve_scan")


def _ptxas(build, names=None):
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    for src in sorted(glob.glob(os.path.join(build.CSRC, "*.cu"))):
        name = os.path.splitext(os.path.basename(src))[0]
        if names is not None and name not in names:
            continue
        out = os.path.join(build.BUILD_DIR, f"{name}.cubin")
        res = subprocess.run([build._nvcc(), *flags, "-cubin", "-Xptxas",
                              "-v", "-o", out, src], capture_output=True,
                             text=True, timeout=600, check=True)
        for line in res.stderr.splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry function" in line):
                print(f"[ptxas] {name}: {line.strip()}", flush=True)
        print(f"[ptxas] {name}: cubin {os.path.getsize(out)} bytes",
              flush=True)


def _one(checkout, split):
    r"""Phases 2, 3 and 5 of one checkout's ``chip_smoke.py``, or with
    ``split`` only its serve split, in this process."""
    import torch
    sys.path.insert(0, checkout)
    import chip_smoke
    from robustcap_tpu_torch.models import sig_mp
    from robustcap_tpu_torch.ops import _build
    from robustcap_tpu_torch.smpl import ParametricModel, synthetic_smpl_data

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    params = sig_mp.init_params(gen, device=dev)
    data = synthetic_smpl_data()
    model = ParametricModel(data=data, device=dev)
    if split:
        _ptxas(_build, ["serve_scan"])
        _build.build_all(["serve_scan"])
        chip_smoke.serve_split_modes(params, model, dev)
        return
    _ptxas(_build)
    _build.build_all()
    model_bs = ParametricModel(data=data, use_pose_blendshape=True,
                               device=dev)
    chip_smoke.check_lstm(params, dev, gen)
    chip_smoke.check_tail([model, model_bs], dev, gen)
    if hasattr(chip_smoke, "check_serve"):
        chip_smoke.check_serve(params, model, dev)


def main(argv):
    opts = [a for a in argv if a == "--split"]
    argv = [a for a in argv if a not in opts]
    if len(argv) == 3 and argv[1] == "--one":
        _one(os.path.abspath(argv[2]), bool(opts))
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    ok = True
    for i, checkout in enumerate(argv[1:]):
        print(f"== {i + 1}: {checkout}", flush=True)
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", checkout] + opts,
                             capture_output=True, text=True, timeout=900)
        for line in res.stdout.splitlines():
            if _KEEP.match(line):
                print(line, flush=True)
        if res.returncode != 0:
            ok = False
            print(f"== {checkout} failed (exit {res.returncode}):\n"
                  f"{res.stderr[-4000:]}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))

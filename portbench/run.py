r"""Run one cell of the benchmark once on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It makes the weights, the body and the
traffic from ``--seed``, sets up the program (``robustcap_tpu_torch``)
and warms up every shape the cell uses, then drives the cell's traffic for
``--seconds`` seconds: with ``--trace 0`` it reports the cell's end-to-end
metrics; with ``--trace 1`` it profiles the device over the window's first
``trace_calls`` calls (the traffic file's) and reports the cell's
per-layer metrics from that traced window. Once the window has closed
it reads the card's memory peak, frees the program, and holds a sample of
what the window produced against the plain reference
(``portbench/reference/``). It prints the numbers compared beside their
limits on standard error and, as the last line of standard output, one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (and ``breakdown`` with ``--trace 1``), then ``checks``.

Without a card, or with fewer cards than the cell asks for, it prints no
result and exits 2; if ``jax``, ``jaxlib``, ``flax`` or the JAX package
``robustcap_tpu`` has been loaded by the time the window has closed, it
exits 3.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "robustcap_tpu")


def _environment():
    r"""Build and kernel caches at fixed paths inside the checkout, and no
    JAX behind ``transformers``; the program's own kernel builds go to its
    fixed ``robustcap_tpu_torch/_build/``."""
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def loaded_forbidden():
    r"""Top-level names of loaded modules that the benchmark must not load,
    compared whole (``robustcap_tpu_torch`` is not ``robustcap_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(ctx, t_start, device=None, spans=None):
    r"""Set up, run the window, check and measure one cell on ``device``
    (the card by default; the tests drive it on the CPU). Returns the
    result line's dict, the forbidden modules loaded by the time the window
    closed, the card's power limit, and every number the comparison
    read (those the cell holds are in the result's ``checks``)."""
    import torch
    torch.zeros(1, device=device or "cuda")
    from portbench import check
    from portbench.harness import (Spans, Tracer, busy_union, breakdown,
                                   device_info, load_module)
    dev = torch.device(device) if device else torch.device("cuda", 0)
    torch.set_num_threads(4)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entry = load_module("entries", ctx.traffic["entry"])
    ctx.mark("torch on the device")
    state = entry.setup(ctx, dev)
    _sync(dev)
    ctx.mark("warm-up")
    setup_s = time.perf_counter() - t_start
    print("portbench: set-up " + ", ".join(
        f"{name} {t - t_start:.3f} s" for name, t in ctx.marks),
        file=sys.stderr)
    spans = Spans() if spans is None else spans
    tr = Tracer(ctx.trace and dev.type == "cuda", spans,
                lambda: _sync(dev))
    record = entry.window(ctx, state, spans, tr)
    _sync(dev)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    entry.release(state)
    del state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    forbidden = loaded_forbidden()
    t_check = time.perf_counter()
    numbers = entry.check(ctx, record, dev)
    print(f"portbench: set-up {setup_s:.3f} s, {record['attempted']} calls, "
          f"check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    correct, checks = check.judge(numbers, check.load_limits(ROOT,
                                                             ctx.workload))
    correct = correct and record["failed"] == 0

    if ctx.trace:
        lo, hi = tr.lo, tr.hi
        if lo is None:               # traced on the CPU: no device trace
            lo, hi = record["calls"][0]["start"], record["calls"][-1]["end"]
        traced = dict(record, calls=[c for c in record["calls"]
                                     if c["start"] >= lo and c["end"] <= hi])
        reading = dict(ctx=ctx, record=traced, spans=[
            s for s in spans.items if s[1] >= lo and s[2] <= hi],
            events=tr.events, lo=lo, hi=hi, window_s=(hi - lo) / 1e9,
            host_calls=[c for c in record["calls"] if tr.lo is None
                        or c["end"] <= tr.lo or c["start"] >= tr.hi])
    else:
        reading = dict(ctx=ctx, record=record, spans=spans.items, events=[],
                       lo=None, hi=None, window_s=None,
                       host_calls=record["calls"])
    metrics = {}
    for m in ctx.metrics_of("per_layer" if ctx.trace else "end_to_end"):
        if m["name"] == "setup_s":
            value = setup_s
        else:
            value = load_module("metrics", m["name"]).read(reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if dev.type == "cuda":
        device, power = device_info(ctx.cell["chips"])
    else:
        device, power = {"platform": "cpu", "kind": "cpu", "count": 1}, None
    device["memory_peak_bytes"] = int(peak)
    result = {"correct": bool(correct), "attempted": record["attempted"],
              "failed": record["failed"], "metrics": metrics,
              "device": device}
    if ctx.trace:
        device["busy_s"] = busy_union(tr.events, lo, hi) / 1e9
        device["window_s"] = (hi - lo) / 1e9
        result["breakdown"] = breakdown(tr.events, spans.items, lo, hi)
    result["checks"] = checks
    return result, forbidden, power, numbers


def _finite(x):
    r"""``x`` with every infinite or NaN float as the largest float, so
    that the line stays JSON (a failed comparison reads infinity)."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return sys.float_info.max
    return x


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    import torch
    from portbench.harness import Context
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    ctx = Context(args.workload, args.seed, args.seconds, args.trace)
    if torch.cuda.device_count() < ctx.cell["chips"]:
        print(f"portbench: {ctx.workload} needs {ctx.cell['chips']} cards, "
              f"{torch.cuda.device_count()} present; nothing measured",
              file=sys.stderr)
        return 2
    result, forbidden, power, numbers = run(ctx, _T_START)
    forbidden = sorted(set(forbidden) | set(loaded_forbidden()))
    if forbidden:
        print("portbench: the run loaded " + ", ".join(forbidden)
              + "; no result", file=sys.stderr)
        return 3
    print(f"portbench: {ctx.workload} seed {ctx.seed} on "
          f"{result['device']['kind']}, power limit {power}", file=sys.stderr)
    for name, value in numbers.items():
        if name not in result["checks"]:
            print(f"portbench: read {name} {value!r} (not held)",
                  file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

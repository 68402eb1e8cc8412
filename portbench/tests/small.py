r"""Tiny widths and traffic for driving the benchmark on the CPU; the
comparison there takes every sequence or session the window completed."""

import copy

SMALL_STACKS = {
    "rnn2": (72, 69, 8, True), "rnn3": (141, 3, 8, False),
    "rnn4": (171, 69, 12, False), "rnn6": (240, 3, 10, False),
    "rnn7": (141, 144, 8, False), "rnn8": (141, 2, 8, False)}

SMALL_TRAFFIC = {
    "sequences": dict(lengths=[20, 40], pool=4, warmup_frames=4,
                      trace_calls=2, check_sequences=4),
    "multiplex": dict(lengths=[6, 15], pool=5, capacity=4, warmup_ticks=2,
                      trace_calls=5, check_sequences=64),
    "evaluate": dict(lengths=[10, 20], rows=6, max_bucket=6,
                     warmup_frames=2, trace_calls=1, check_sequences=6),
}


def small_context(cell, seed=2 ** 31 + 12345, seconds=0.5, trace=False):
    r"""The cell's :class:`~portbench.harness.Context` at tiny widths, a
    100-vertex body and short traffic."""
    from portbench.harness import Context
    ctx = Context(cell, seed, seconds, trace)
    ctx.config = copy.deepcopy(ctx.config)
    ctx.config["stacks"] = {
        k: {"input": i, "output": o, "hidden": h, "layers": 2, "init_net": w}
        for k, (i, o, h, w) in SMALL_STACKS.items()}
    ctx.config["body"]["vertices"] = 100
    ctx.traffic = dict(ctx.traffic, **SMALL_TRAFFIC[ctx.traffic["entry"]])
    return ctx

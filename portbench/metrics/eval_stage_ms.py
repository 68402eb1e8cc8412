r"""``eval_stage_ms``: an evaluation call's host staging before each bucket's first kernel, from the program's spans (:func:`portbench.program_spans.eval_stage_ms`)."""

from portbench import program_spans


def read(r):
    return program_spans.eval_stage_ms(r, program_spans.recorded(r))

r"""``seq_host_ms``: a sequence's host time in ``forward_offline`` until its serve launch is queued, from the program's spans (:func:`portbench.program_spans.seq_host_ms`)."""

from portbench import program_spans


def read(r):
    return program_spans.seq_host_ms(r, program_spans.recorded(r))

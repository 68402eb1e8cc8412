r"""``tick_host_ms``: a tick's host time in the multiplexer outside its read-back, from the program's spans (:func:`portbench.program_spans.tick_host_ms`)."""

from portbench import program_spans


def read(r):
    return program_spans.tick_host_ms(r, program_spans.recorded(r))

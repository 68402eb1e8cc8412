r"""``tick_p50_ms``: the median tick of the multiplexer (:func:`portbench.readers.tick_ms`)."""

from portbench import readers


def read(r):
    return readers.tick_ms(r, 50)

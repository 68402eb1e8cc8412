r"""``tick_p95_ms``: the 95th percentile tick of the multiplexer, prescan ticks included (:func:`portbench.readers.tick_ms`)."""

from portbench import readers


def read(r):
    return readers.tick_ms(r, 95)

r"""``seq_overhead_ms``: a sequence's time outside its serve kernel (:func:`portbench.readers.seq_overhead_ms`)."""

from portbench.readers import seq_overhead_ms as read  # noqa: F401

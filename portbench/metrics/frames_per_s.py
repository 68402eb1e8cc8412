r"""``frames_per_s`` and its cells' variants (``frames_per_s.eval``, ...): valid frames completed per second of the window (host clock) (:func:`portbench.readers.frames_per_s`)."""

from portbench.readers import frames_per_s as read  # noqa: F401

r"""``device_idle`` and its cells' variants: the card's idle share of the traced window (:func:`portbench.readers.device_idle`)."""

from portbench.readers import device_idle as read  # noqa: F401

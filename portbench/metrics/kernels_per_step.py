r"""``kernels_per_step`` and its cells' variants: kernels and copies per step of the batched path (:func:`portbench.readers.kernels_per_step`)."""

from portbench.readers import kernels_per_step as read  # noqa: F401

r"""``tail_roofline`` and its cells' variants: the tail kernel's share of its roofline (:func:`portbench.readers.tail_roofline`)."""

from portbench.readers import tail_roofline as read  # noqa: F401

r"""``mfu`` and its cells' variants (``mfu.seq``, ...): the whole step's share of the card's peak (:func:`portbench.readers.mfu`)."""

from portbench.readers import mfu as read  # noqa: F401

r"""``serve_roofline``: the serve kernel's share of its roofline (:func:`portbench.readers.serve_roofline`)."""

from portbench.readers import serve_roofline as read  # noqa: F401

r"""The SigMP fusion network on torch tensors."""

from . import sig_mp  # noqa: F401

__all__ = ["sig_mp"]

r"""Recurrent building blocks on torch tensors."""

from .rnn import *  # noqa: F401,F403
from .rnn import __all__  # noqa: F401

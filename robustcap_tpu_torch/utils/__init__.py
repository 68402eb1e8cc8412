r"""Host-side utilities: filters, printing, text I/O."""

from .filter import (KalmanFilter, LowPassFilter,  # noqa: F401
                     LowPassFilterRotation)
from .io import load_txt_mat, save_txt_mat  # noqa: F401
from .print_utils import (print_red, print_green, print_yellow,  # noqa: F401
                          print_blue, print_magenta, print_cyan, print_white)

__all__ = ["KalmanFilter", "LowPassFilter", "LowPassFilterRotation",
           "load_txt_mat", "save_txt_mat", "print_red", "print_green",
           "print_yellow", "print_blue", "print_magenta", "print_cyan",
           "print_white"]

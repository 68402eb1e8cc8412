r"""ANSI color printing helpers (a copy of
``robustcap_tpu/utils/print_utils.py``)."""

__all__ = ["print_red", "print_green", "print_yellow", "print_blue",
           "print_magenta", "print_cyan", "print_white"]

_CODES = {"red": 31, "green": 32, "yellow": 33, "blue": 34, "magenta": 35,
          "cyan": 36, "white": 37}


def _make(color):
    code = _CODES[color]

    def p(*args, **kwargs):
        print(f"\033[{code}m", end="")
        print(*args, **kwargs)
        print("\033[0m", end="", flush=True)

    p.__name__ = f"print_{color}"
    return p


print_red = _make("red")
print_green = _make("green")
print_yellow = _make("yellow")
print_blue = _make("blue")
print_magenta = _make("magenta")
print_cyan = _make("cyan")
print_white = _make("white")

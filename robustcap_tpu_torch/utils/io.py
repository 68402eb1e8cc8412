r"""Text matrix I/O (a copy of ``robustcap_tpu/utils/io.py``)."""

from __future__ import annotations

import numpy as np

__all__ = ["load_txt_mat", "save_txt_mat"]


def load_txt_mat(path: str, delimiter: str = ",") -> np.ndarray:
    r"""Load a 2-D float matrix from a delimited text file."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append([float(v) for v in line.split(delimiter)])
    return np.asarray(rows, np.float32)


def save_txt_mat(mat, path: str, delimiter: str = ",", fmt: str = "%.6f"):
    r"""Save a 2-D matrix as delimited text."""
    mat = np.asarray(mat)
    with open(path, "w") as f:
        for row in mat.reshape(mat.shape[0], -1):
            f.write(delimiter.join(fmt % v for v in row) + "\n")

r"""Camera intrinsics calibration from chessboard views; a copy of
``robustcap_tpu/sensors/calibration.py`` (numpy, cv2 for the corners).

Rebuild of ``articulate/utils/executables/RGB_camera_calibration.py``:
estimates K and distortion from chessboard corner detections. Corner
detection needs cv2 (hardware/capture-side); the DLT/optimization core
(Zhang's method) is implemented here in numpy so it is testable from
synthetic corner data.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["calibrate_intrinsics_zhang", "calibrate_camera_chessboard"]


def _homography(obj_xy: np.ndarray, img_xy: np.ndarray) -> np.ndarray:
    r"""DLT homography from planar points (normalized)."""
    n = len(obj_xy)
    A = []
    for i in range(n):
        X, Y = obj_xy[i]
        u, v = img_xy[i]
        A.append([-X, -Y, -1, 0, 0, 0, u * X, u * Y, u])
        A.append([0, 0, 0, -X, -Y, -1, v * X, v * Y, v])
    _, _, Vt = np.linalg.svd(np.asarray(A))
    H = Vt[-1].reshape(3, 3)
    return H / H[2, 2]


def calibrate_intrinsics_zhang(obj_points: Sequence[np.ndarray],
                               img_points: Sequence[np.ndarray]
                               ) -> np.ndarray:
    r"""Zhang's closed-form intrinsics from >= 3 planar views.

    obj_points[i] [N, 2] board coordinates, img_points[i] [N, 2] pixels.
    Returns K [3, 3] (zero skew enforced afterwards).
    """
    def v_ij(H, i, j):
        return np.array([
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j]])

    V = []
    for o, im in zip(obj_points, img_points):
        H = _homography(np.asarray(o, np.float64), np.asarray(im, np.float64))
        V.append(v_ij(H, 0, 1))
        V.append(v_ij(H, 0, 0) - v_ij(H, 1, 1))
    _, _, Vt = np.linalg.svd(np.asarray(V))
    b11, b12, b22, b13, b23, b33 = Vt[-1]

    v0 = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 ** 2)
    lam = b33 - (b13 ** 2 + v0 * (b12 * b13 - b11 * b23)) / b11
    alpha = np.sqrt(lam / b11)
    beta = np.sqrt(lam * b11 / (b11 * b22 - b12 ** 2))
    u0 = -b13 * alpha ** 2 / lam
    return np.array([[alpha, 0, u0], [0, beta, v0], [0, 0, 1]], np.float64)


def calibrate_camera_chessboard(images: List[np.ndarray],
                                board_size: Tuple[int, int] = (9, 6),
                                square_mm: float = 25.0):
    r"""Full pipeline on captured images (needs cv2 for corner detection)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "chessboard corner detection needs cv2; use "
            "calibrate_intrinsics_zhang with your own corners") from e
    objp = np.zeros((board_size[0] * board_size[1], 3), np.float32)
    objp[:, :2] = np.mgrid[0:board_size[0], 0:board_size[1]
                           ].T.reshape(-1, 2) * square_mm
    obj_points, img_points = [], []
    for im in images:
        gray = cv2.cvtColor(im, cv2.COLOR_BGR2GRAY) if im.ndim == 3 else im
        ok, corners = cv2.findChessboardCorners(gray, board_size)
        if ok:
            obj_points.append(objp)
            img_points.append(corners.reshape(-1, 2))
    ret, K, dist, _, _ = cv2.calibrateCamera(
        obj_points, img_points, gray.shape[::-1], None, None)
    return K, dist

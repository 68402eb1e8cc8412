r"""Video capture utility (reference: articulate/utils/executables/
record_video.py): grab frames from a camera to disk for calibration or
offline detection. cv2-gated (capture hardware side). A copy of
``robustcap_tpu/sensors/capture.py``."""

from __future__ import annotations

import os
import time
from typing import Optional

__all__ = ["record_video", "read_dot_export_csvs"]


def record_video(out_path: str, camera_id: int = 0, fps: int = 30,
                 duration_s: Optional[float] = None, width: int = 640,
                 height: int = 480, show: bool = False):
    r"""Record webcam frames to ``out_path`` (mp4). Returns frames written."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("record_video requires cv2 (capture-side)") from e
    cap = cv2.VideoCapture(camera_id)
    cap.set(cv2.CAP_PROP_FRAME_WIDTH, width)
    cap.set(cv2.CAP_PROP_FRAME_HEIGHT, height)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (width, height))
    n = 0
    t0 = time.time()
    try:
        while duration_s is None or time.time() - t0 < duration_s:
            ok, frame = cap.read()
            if not ok:
                break
            writer.write(frame)
            n += 1
            if show:
                cv2.imshow("record", frame)
                if cv2.waitKey(1) & 0xFF == ord("q"):
                    break
    finally:
        cap.release()
        writer.release()
    return n


def read_dot_export_csvs(input_dir: str):
    r"""Read an Xsens DOT Data Exporter session directory of per-sensor CSV
    files into {sensor_id: {"q": [T, 4] wxyz, "a": [T, 3]}} (the reference's
    ``xsens_offline_data_reader.py``). Detects the separator from the first
    line like the reference, maps columns by header name (Quat_W..Z,
    Acc_X..Z), and keys each sensor by the second underscore-separated token
    of its filename."""
    import glob
    import os

    import numpy as np

    data = {}
    for file in sorted(glob.glob(os.path.join(input_dir, "*.csv"))):
        with open(file) as f:
            first = f.readline().rstrip("\n")
            sep = first[-1] if first else ","
            header = f.readline().rstrip("\n").split(sep)
            cols = [header.index(c) for c in
                    ("Quat_W", "Quat_X", "Quat_Y", "Quat_Z",
                     "Acc_X", "Acc_Y", "Acc_Z")]
            quats, accs = [], []
            for line in f:
                parts = line.rstrip("\n").split(sep)
                if len(parts) <= max(cols):
                    continue
                vals = [float(parts[c]) for c in cols]
                quats.append(vals[:4])
                accs.append(vals[4:])
        key = os.path.basename(file).split("_")[1] \
            if "_" in os.path.basename(file) else os.path.basename(file)
        data[key] = {"q": np.asarray(quats, np.float32),
                     "a": np.asarray(accs, np.float32)}
    return data

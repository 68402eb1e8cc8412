r"""Synthetic occlusion augmentation: paste object cutouts over video frames.

The port's own copy of ``robustcap_tpu/preprocess/occlusion.py`` (numpy and
scipy only, so the port needs nothing of the JAX package).

Rebuild of the reference's ``scripts/occlusion.py`` (load_occluders:56,
occlude_with_objects:109, paste_over:130, resize_by_factor:165): Pascal-VOC
object cutouts with alpha channels are pasted at random (or fixed per-video)
positions so the 2-D detector sees occluded bodies — the data-level fault
injection that trains the confidence-gated fusion (SURVEY.md §5).

Implemented with numpy only (the reference needs cv2+PIL); VOC parsing is
gated on the dataset being present.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["paste_over", "occlude_with_objects", "resize_by_factor",
           "load_occluders", "random_occluders"]


def resize_by_factor(im: np.ndarray, factor: float) -> np.ndarray:
    r"""Nearest-neighbor resize by a scalar factor (occlusion.py:165)."""
    h, w = im.shape[:2]
    nh, nw = max(1, int(round(h * factor))), max(1, int(round(w * factor)))
    ys = np.clip((np.arange(nh) / factor).astype(int), 0, h - 1)
    xs = np.clip((np.arange(nw) / factor).astype(int), 0, w - 1)
    return im[ys][:, xs]


def paste_over(im_src: np.ndarray, im_dst: np.ndarray,
               center: Sequence[float]) -> np.ndarray:
    r"""Alpha-paste ``im_src`` (RGBA) onto ``im_dst`` centered at ``center``,
    clipped at the borders (occlusion.py:130-162)."""
    h_src, w_src = im_src.shape[:2]
    h_dst, w_dst = im_dst.shape[:2]
    cx, cy = int(round(center[0])), int(round(center[1]))
    x0 = cx - w_src // 2
    y0 = cy - h_src // 2
    x1, y1 = x0 + w_src, y0 + h_src
    dx0, dy0 = max(x0, 0), max(y0, 0)
    dx1, dy1 = min(x1, w_dst), min(y1, h_dst)
    if dx0 >= dx1 or dy0 >= dy1:
        return im_dst
    sx0, sy0 = dx0 - x0, dy0 - y0
    sx1, sy1 = sx0 + (dx1 - dx0), sy0 + (dy1 - dy0)
    src = im_src[sy0:sy1, sx0:sx1]
    alpha = src[..., 3:4].astype(np.float32) / 255.0
    region = im_dst[dy0:dy1, dx0:dx1].astype(np.float32)
    blended = alpha * src[..., :3].astype(np.float32) + (1 - alpha) * region
    out = im_dst.copy()
    out[dy0:dy1, dx0:dx1] = blended.astype(im_dst.dtype)
    return out


def random_occluders(rng: np.random.RandomState, n: int = 4,
                     size_range=(40, 160)) -> List[np.ndarray]:
    r"""Procedural RGBA occluders (soft-edged blobs) used when the VOC
    dataset is absent — same interface as ``load_occluders``."""
    occs = []
    for _ in range(n):
        s = rng.randint(*size_range)
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
        c = (s - 1) / 2
        r = np.sqrt((yy - c) ** 2 + (xx - c) ** 2) / c
        alpha = np.clip(1.4 - r * 1.4, 0, 1) ** 0.5
        color = rng.randint(0, 255, 3)
        im = np.zeros((s, s, 4), np.uint8)
        im[..., :3] = color
        im[..., 3] = (alpha * 255).astype(np.uint8)
        occs.append(im)
    return occs


def load_occluders(voc_root: str, max_objects: int = 1000
                   ) -> List[np.ndarray]:
    r"""Extract RGBA object cutouts from Pascal VOC segmentation masks
    (occlusion.py:56-107). Requires the VOC dataset on disk; raises with a
    pointer to ``random_occluders`` otherwise."""
    seg_dir = os.path.join(voc_root, "SegmentationObject")
    img_dir = os.path.join(voc_root, "JPEGImages")
    if not os.path.isdir(seg_dir):
        raise FileNotFoundError(
            f"VOC segmentation not found at {seg_dir}; use "
            "random_occluders() for procedural occluders")
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("load_occluders needs PIL for VOC images") from e
    occluders = []
    for name in sorted(os.listdir(seg_dir)):
        if not name.endswith(".png"):
            continue
        seg = np.asarray(Image.open(os.path.join(seg_dir, name)))
        img = np.asarray(Image.open(
            os.path.join(img_dir, name.replace(".png", ".jpg"))))
        for obj_id in np.unique(seg):
            if obj_id in (0, 255):
                continue
            mask = seg == obj_id
            ys, xs = np.where(mask)
            if len(ys) < 500:
                continue
            y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
            cut = np.zeros((y1 - y0, x1 - x0, 4), np.uint8)
            cut[..., :3] = img[y0:y1, x0:x1]
            cut[..., 3] = (mask[y0:y1, x0:x1] * 255).astype(np.uint8)
            occluders.append(cut)
            if len(occluders) >= max_objects:
                return occluders
    return occluders


def occlude_with_objects(im: np.ndarray, occluders: List[np.ndarray],
                         rng: np.random.RandomState,
                         count_range=(1, 8),
                         centers: Optional[List[Tuple[float, float]]] = None
                         ) -> np.ndarray:
    r"""Paste 1-8 occluders at random (or fixed per-video) centers
    (occlusion.py:109-127; run_aist_detector.py:96-107 keeps centers fixed
    across a video so occlusion is temporally coherent)."""
    h, w = im.shape[:2]
    out = im
    if centers is None:
        n = rng.randint(count_range[0], count_range[1] + 1)
        centers = [(rng.uniform(0, w), rng.uniform(0, h)) for _ in range(n)]
    for k, center in enumerate(centers):
        occ = occluders[rng.randint(len(occluders))]
        factor = rng.uniform(0.5, 1.5)
        out = paste_over(resize_by_factor(occ, factor), out, center)
    return out

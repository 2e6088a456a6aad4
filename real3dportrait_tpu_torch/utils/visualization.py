"""Debug views of a frame (port of ``real3dportrait_tpu/utils/visualization.py``:
``to_uint8``, ``depth_to_colormap``, ``side_by_side``), for the
``concat_debug`` output mode. cv2 on the host."""

from __future__ import annotations

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1,1] float image -> uint8."""
    if img.dtype == np.uint8:
        return img
    return ((np.clip(img, -1, 1) + 1) * 127.5).astype(np.uint8)


def depth_to_colormap(depth: np.ndarray) -> np.ndarray:
    """[H,W] depth -> uint8 heat image (min-max over the positive depths)."""
    import cv2

    d = np.asarray(depth, np.float32)
    mask = d > 0
    if mask.any():
        lo, hi = d[mask].min(), d[mask].max()
        norm = np.where(mask, (d - lo) / max(hi - lo, 1e-9), 0.0)
    else:
        norm = np.zeros_like(d)
    return cv2.applyColorMap((norm * 255).astype(np.uint8), cv2.COLORMAP_VIRIDIS)


def side_by_side(*images: np.ndarray) -> np.ndarray:
    """Horizontal concat, each image resized to the tallest one's height."""
    ims = [to_uint8(im) for im in images]
    h = max(im.shape[0] for im in ims)
    padded = []
    for im in ims:
        if im.ndim == 2:
            im = np.repeat(im[..., None], 3, -1)
        if im.shape[0] != h:
            import cv2

            im = cv2.resize(im, (int(im.shape[1] * h / im.shape[0]), h))
        padded.append(im[..., :3])
    return np.concatenate(padded, axis=1)

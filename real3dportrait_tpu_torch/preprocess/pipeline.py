"""The dependency-free person segmenter of the preprocessing pipeline (port
of ``real3dportrait_tpu/preprocess/pipeline.py``, ``naive_person_segmenter``)."""

from __future__ import annotations

import numpy as np


def naive_person_segmenter(frames: np.ndarray) -> np.ndarray:
    """[T,H,W,3] uint8 -> [T,H,W] int segmap with the MediaPipe classes
    (0 bg, 1 hair, 2 body/neck, 3 face, 4 clothes, 5 other): median
    background subtraction and a vertical prior. On one frame the median is
    the frame itself, so every pixel is background; the JAX package's
    ``run`` prepares its source from such a map, and so does the port's."""
    bg = np.median(frames[:: max(len(frames) // 16, 1)], axis=0)
    diff = np.abs(frames.astype(np.int16) - bg.astype(np.int16)).sum(-1)
    person = diff > 40
    h = frames.shape[1]
    yy = np.arange(h)[:, None]
    segs = np.zeros(frames.shape[:3], np.int64)
    face_band = (yy > h * 0.15) & (yy < h * 0.55)
    body_band = yy >= h * 0.55
    hair_band = yy <= h * 0.15
    segs[person & np.broadcast_to(face_band, person.shape)] = 3
    segs[person & np.broadcast_to(body_band, person.shape)] = 4
    segs[person & np.broadcast_to(hair_band, person.shape)] = 1
    return segs

"""SECC eye editing for blinks (port of
``real3dportrait_tpu/inference/edit_secc.py``, ``blink_eye_for_secc``, and of
the periodic schedule of ``real3dportrait_tpu/inference/pipeline.py``).

The eyeball faces are not rasterised, so the eye openings are background
holes inside the face region of a SECC map; closing an eye by ``p`` slides
the upper eyelid's colour down each hole column. Numpy on the host: only
the frames of a blink make the round trip.
"""

from __future__ import annotations

import numpy as np


def _eye_holes(secc: np.ndarray) -> np.ndarray:
    """[H,W,3] secc in [-1,1] -> bool mask of eye holes (bg inside the eye region)."""
    h, w = secc.shape[:2]
    face = np.any(secc > -0.99, axis=-1)
    prior = np.zeros((h, w), bool)
    prior[h // 4: h // 2, w // 4: 3 * w // 4] = True
    return (~face) & prior


def blink_eye_for_secc(secc: np.ndarray, close_percent: float = 0.5) -> np.ndarray:
    """Close the eyes of one SECC map [H,W,3] by ``close_percent`` in [0,1]."""
    if close_percent <= 0:
        return secc
    secc = secc.copy()
    holes = _eye_holes(secc)
    if not holes.any():
        return secc
    h = secc.shape[0]
    cols = np.nonzero(holes.any(axis=0))[0]
    row_idx = np.arange(h)
    for c in cols:
        rows = row_idx[holes[:, c]]
        top, bot = rows.min(), rows.max()
        lid = max(top - 1, 0)
        new_top = int(round(top + close_percent * (bot - top)))
        # the upper eyelid (the skin colour just above the hole) slides down
        secc[top: new_top + 1, c] = secc[lid, c]
    return secc


BLINK_PERIOD = 25 * 5  # frames: one blink every 5 s at 25 fps
BLINK_FRAMES = 5


def periodic_blink_percent(n_frames: int) -> np.ndarray:
    """Per-frame eye-close fractions [T]: a 5-frame close-open profile every
    5 s from frame 62, each blink only if it ends before the last frame (so
    the first needs T >= 68)."""
    percent = np.zeros((n_frames,), np.float32)
    profile = np.concatenate([np.linspace(0.25, 1.0, BLINK_FRAMES // 2 + 1)[1:],
                              np.linspace(1.0, 0.25, BLINK_FRAMES - BLINK_FRAMES // 2)])
    start = BLINK_PERIOD // 2
    while start + BLINK_FRAMES < n_frames:
        percent[start: start + BLINK_FRAMES] = profile
        start += BLINK_PERIOD
    return percent


def inject_blink_to_secc_sequence(secc_seq: np.ndarray, fps: int = 25, period_s: float = 5.0,
                                  blink_frames: int = 5, seed: int = 0) -> np.ndarray:
    """Blinks added to [T,H,W,3] SECC maps at seeded times: the first at a
    frame in [period / 2, period), then every period plus a shift in
    [-fps, fps), each a close-open profile over ``blink_frames`` frames
    that must end before the last frame. ``numpy.random.RandomState(seed)``
    draws the times, as the JAX package's helper does, so a seed gives the
    same blinks. The pipeline's schedule is :func:`periodic_blink_percent`."""
    t = len(secc_seq)
    out = secc_seq.copy()
    rng = np.random.RandomState(seed)
    period = int(period_s * fps)
    profile = np.concatenate([np.linspace(0.25, 1.0, blink_frames // 2 + 1)[1:],
                              np.linspace(1.0, 0.25, blink_frames - blink_frames // 2)])
    start = rng.randint(period // 2, period)
    while start + len(profile) < t:
        for k, p in enumerate(profile):
            out[start + k] = blink_eye_for_secc(out[start + k], float(p))
        start += period + rng.randint(-fps, fps)
    return out

"""Binarizer (port of ``real3dportrait_tpu/data/binarizer.py``): per-video
feature dicts -> the indexed record store. Each video is one record
``{id, exp, euler, trans, f0, hubert | mel, blink, ...}``, and the image
keys (``head_imgs``, ``com_imgs``, ``torso_imgs``, ``segmaps``,
``bg_img``) where the video has them. Feature extraction runs before, on
the host; this module validates and packs."""

from __future__ import annotations

import os
from typing import Iterable

import numpy as np

from real3dportrait_tpu_torch.data.indexed_dataset import IndexedDatasetBuilder

REQUIRED_KEYS = ("id", "exp", "euler", "trans", "f0")
AUDIO_KEYS = ("hubert", "mel")


def validate_record(rec: dict) -> dict:
    """``rec`` itself, or ``ValueError`` naming what is wrong: a missing
    key, no audio features, the shapes of the motion coefficients, audio
    (50 Hz) not twice the motion's length (25 Hz) within 4 frames."""
    for k in REQUIRED_KEYS:
        if k not in rec:
            raise ValueError(f"missing key {k}")
    if not any(k in rec for k in AUDIO_KEYS):
        raise ValueError("need hubert or mel features")
    t = len(rec["exp"])
    if np.asarray(rec["exp"]).shape[-1] != 64:
        raise ValueError(f"exp must be [T,64], got {np.shape(rec['exp'])}")
    for k in ("euler", "trans"):
        if np.asarray(rec[k]).shape != (t, 3):
            raise ValueError(f"{k} must be [{t},3], got {np.shape(rec[k])}")
    audio_key = "hubert" if "hubert" in rec else "mel"
    t_audio = len(rec[audio_key])
    if abs(t_audio - 2 * t) > 4:
        raise ValueError(f"{audio_key} has {t_audio} frames for {t} motion frames "
                         f"(50 Hz against 25 Hz)")
    return rec


def binarize(records: Iterable[dict], out_path: str, compress: bool = False) -> int:
    """Write validated records to the store ``out_path``; returns how many."""
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    n = 0
    with IndexedDatasetBuilder(out_path, compress=compress) as builder:
        for rec in records:
            builder.add_item(validate_record(rec))
            n += 1
    return n


def make_synthetic_records(n_videos: int = 2, t: int = 64, seed: int = 0,
                           audio_key: str = "hubert") -> list[dict]:
    """A small seeded corpus (the JAX package's, array for array) for tests
    and smoke training."""
    rng = np.random.RandomState(seed)
    dim = 1024 if audio_key == "hubert" else 80
    recs = []
    for _ in range(n_videos):
        recs.append({
            "id": rng.randn(t, 80).astype(np.float32) * 0.1,
            "exp": rng.randn(t, 64).astype(np.float32) * 0.1,
            "euler": rng.randn(t, 3).astype(np.float32) * 0.1,
            "trans": rng.randn(t, 3).astype(np.float32) * 0.05,
            "f0": np.abs(rng.randn(2 * t)).astype(np.float32) * 200,
            audio_key: rng.randn(2 * t, dim).astype(np.float32),
            "blink": np.zeros((2 * t, 1), np.int64),
        })
    return recs

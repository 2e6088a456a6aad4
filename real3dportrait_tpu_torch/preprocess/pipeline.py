"""Offline preprocessing: raw video -> training record (port of
``real3dportrait_tpu/preprocess/pipeline.py``).

1. resample the video to 25 fps and 512^2 (cv2);
2. person segmentation -> head / torso / background images and a median
   background;
3. 68-point landmarks (a pluggable extractor; the naive one places the
   morphable model's neutral landmarks in the face box);
4. 3DMM fitting against the landmarks (``geometry/fit_3dmm.py``, on the
   device);
5. audio: 16 kHz wav -> log-mel and F0 (and HuBERT where its weights are
   given);
6. the record the binarizer takes.

Every extractor is a plain callable, so a real landmark or segmentation
runtime plugs in where one exists. Everything but the fit runs on the host
in numpy.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from real3dportrait_tpu_torch import entry_device
from real3dportrait_tpu_torch.audio.features import extract_f0, extract_mel
from real3dportrait_tpu_torch.geometry.bfm import load_or_synthetic_bfm
from real3dportrait_tpu_torch.geometry.face3d_helper import reconstruct_lm2d
from real3dportrait_tpu_torch.geometry.fit_3dmm import fit_coeffs

# --- video -----------------------------------------------------------------


def resample_video(path: str, fps: int = 25, size: int = 512,
                   max_frames: int | None = None) -> np.ndarray:
    """Video file -> [T, size, size, 3] uint8 RGB at the target fps (frames
    kept at the source's rate over ``fps``, resized with INTER_AREA)."""
    import cv2

    cap = cv2.VideoCapture(path)
    src_fps = cap.get(cv2.CAP_PROP_FPS) or fps
    step = src_fps / fps
    frames = []
    idx, next_keep = 0, 0.0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if idx >= next_keep:
            frame = cv2.resize(frame, (size, size), interpolation=cv2.INTER_AREA)
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            next_keep += step
            if max_frames and len(frames) >= max_frames:
                break
        idx += 1
    cap.release()
    return np.stack(frames) if frames else np.zeros((0, size, size, 3), np.uint8)


# --- segmentation ------------------------------------------------------------


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


def segment_frames(frames: np.ndarray,
                   segmenter: Callable[[np.ndarray], np.ndarray] | None = None) -> dict:
    """frames -> {segmap, head_imgs, torso_imgs, com_imgs, bg_img}; the
    background is the median of the non-person pixels over time (127 where
    a pixel is never background)."""
    segmap = (segmenter or naive_person_segmenter)(frames)
    person = segmap > 0
    head = (segmap == 1) | (segmap == 3)
    torso = (segmap == 2) | (segmap == 4)
    masked = np.where(person[..., None], np.nan, frames.astype(np.float32))
    with np.errstate(invalid="ignore"):
        bg = np.nanmedian(masked, axis=0)
    bg = np.nan_to_num(bg, nan=127.0).astype(np.uint8)

    def cut(mask):
        return np.where(mask[..., None], frames, 0).astype(np.uint8)

    return {
        "segmap": segmap.astype(np.int8),
        "head_imgs": cut(head),
        "torso_imgs": cut(torso),
        "com_imgs": np.where(person[..., None], frames, bg[None]).astype(np.uint8),
        "bg_img": bg,
    }


# --- landmarks ----------------------------------------------------------------


def _neutral_lm_template(bfm_dir: str | None = None) -> np.ndarray:
    """The morphable model's 68 landmarks at zero coefficients, normalised
    to their own bounding box ([68,2] in [0,1])."""
    assets = load_or_synthetic_bfm(bfm_dir)
    z = lambda n: torch.zeros((1, n))  # noqa: E731
    lm = reconstruct_lm2d(assets, z(80), z(64), z(3), z(3))[0].numpy()
    lo, hi = lm.min(0), lm.max(0)
    return (lm - lo) / np.maximum(hi - lo, 1e-6)


def naive_landmark_extractor(frames: np.ndarray,
                             bfm_dir: str | None = None) -> np.ndarray:
    """[T,H,W,3] uint8 -> [T,68,2] normalised landmarks: each frame's face
    box from the naive segmenter's face class (the previous box, first a
    central one, where it has 16 pixels or fewer) with the neutral template
    placed in it. The landmarks follow the head's translation and scale
    only, no expression; a real extractor plugs in where one exists."""
    h, w = frames.shape[1:3]
    segs = naive_person_segmenter(frames)
    template = _neutral_lm_template(bfm_dir)
    out = np.zeros((len(frames), 68, 2), np.float32)
    prev_box = (0.3 * w, 0.2 * h, 0.7 * w, 0.6 * h)  # fallback center box
    for t in range(len(frames)):
        ys, xs = np.nonzero(segs[t] == 3)
        if len(xs) > 16:
            box = (xs.min(), ys.min(), xs.max(), ys.max())
            prev_box = box
        else:
            box = prev_box
        x0, y0, x1, y1 = box
        lm = template * np.array([max(x1 - x0, 4), max(y1 - y0, 4)]) + np.array([x0, y0])
        out[t] = lm / np.array([w, h])
    return out


# --- audio --------------------------------------------------------------------


def extract_audio_features(wav: np.ndarray, hubert_path: str | None = None,
                           device: torch.device | str = "cuda") -> dict:
    """16 kHz wav -> {mel [T,80], f0 [T], hubert [T,1024] where
    ``hubert_path`` loads} at 50 Hz, mel and f0 cut to a common length.
    HuBERT (a ``.msgpack`` tree, ``inference.pipeline.load_hubert``) runs
    on ``device``."""
    from real3dportrait_tpu_torch.inference.pipeline import load_hubert

    out = {"mel": extract_mel(wav), "f0": extract_f0(wav)}
    hub = load_hubert(hubert_path, entry_device(device)) if hubert_path else None
    if hub is not None:
        out["hubert"] = hub(wav)
    t = min(len(out["mel"]), len(out["f0"]))
    return {k: v[:t] if k != "hubert" else v for k, v in out.items()}


def extract_blink(lm2d_seq: np.ndarray) -> np.ndarray:
    """68-landmark sequence [T,68,2] -> blink units [T,1] in {0,1}: the
    mean eye aspect ratio of both eyes below 0.21."""
    def ear(lm, idx):
        p = lm[:, idx]
        v1 = np.linalg.norm(p[:, 1] - p[:, 5], axis=-1)
        v2 = np.linalg.norm(p[:, 2] - p[:, 4], axis=-1)
        h = np.linalg.norm(p[:, 0] - p[:, 3], axis=-1)
        return (v1 + v2) / np.maximum(2 * h, 1e-8)

    left = ear(lm2d_seq, [36, 37, 38, 39, 40, 41])
    right = ear(lm2d_seq, [42, 43, 44, 45, 46, 47])
    ratio = (left + right) / 2
    return (ratio < 0.21).astype(np.int64)[:, None]


# --- end-to-end ------------------------------------------------------------------


def process_video_to_record(
    video_path: str,
    wav: np.ndarray,
    lm2d_seq: np.ndarray | None = None,
    landmark_extractor: Callable | None = None,
    segmenter: Callable | None = None,
    hubert_path: str | None = None,
    bfm_dir: str | None = None,
    max_frames: int | None = None,
    store_images: bool = False,
    device: torch.device | str = "cuda",
) -> dict:
    """One video and its audio -> a binarizer-ready record of numpy arrays.

    ``lm2d_seq``: precomputed [T,68,2] normalised landmarks; otherwise
    ``landmark_extractor(frames) -> lm2d_seq`` must be given. The 3DMM fit
    runs on ``device``; the motion (25 Hz) is cut to the audio (50 Hz)."""
    dev = entry_device(device)
    frames = resample_video(video_path, max_frames=max_frames)
    t = len(frames)
    if lm2d_seq is None:
        if landmark_extractor is None:
            raise ValueError("no landmarks: pass lm2d_seq or a landmark_extractor")
        lm2d_seq = landmark_extractor(frames)
    lm2d_seq = np.asarray(lm2d_seq)[:t]

    fit = fit_coeffs(load_or_synthetic_bfm(bfm_dir), lm2d_seq, device=dev)
    fit = fit._replace(**{k: getattr(fit, k).cpu().numpy() for k in fit._fields})
    audio = extract_audio_features(wav, hubert_path, dev)
    t = min(t, len(audio["f0"]) // 2, len(fit.exp))
    record = {
        "id": np.broadcast_to(fit.id, (t, 80)).copy(),
        "exp": fit.exp[:t],
        "euler": fit.euler[:t],
        "trans": fit.trans[:t],
        "f0": audio["f0"][: 2 * t],
        "mel": audio["mel"][: 2 * t],
        "blink": np.repeat(extract_blink(lm2d_seq[:t]), 2, axis=0)[: 2 * t],
    }
    if "hubert" in audio:
        record["hubert"] = audio["hubert"][: 2 * t]
    if store_images:
        record.update(segment_frames(frames[:t], segmenter))
    return record

"""Inference helpers (port of ``real3dportrait_tpu/inference/infer_utils.py``):
temporal smoothing of feature sequences, the video-driven motion (a driving
video's landmarks fitted to 3DMM coefficients), motion-coefficient files
and the driving-pose normalisation."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from real3dportrait_tpu_torch.geometry.fit_3dmm import fit_coeffs
from real3dportrait_tpu_torch.preprocess.pipeline import naive_landmark_extractor, resample_video


def smooth_features_1d(x: torch.Tensor, kernel_size: int = 7,
                       sigma: float = 2.0) -> torch.Tensor:
    """Gaussian smoothing along the time axis of [T, ...] features, with
    reflect padding (the kernel shrinks to an odd size below 2T)."""
    t = x.shape[0]
    kernel_size = min(kernel_size, 2 * t - 1)
    if kernel_size % 2 == 0:
        kernel_size -= 1
    if t < 2 or kernel_size < 3:
        return x
    half = kernel_size // 2
    g = torch.exp(-0.5 * ((torch.arange(kernel_size, device=x.device) - half) / sigma) ** 2)
    g = g / g.sum()
    flat = x.reshape(t, -1)
    padded = torch.cat([flat[1:half + 1].flip(0), flat, flat[t - 1 - half:t - 1].flip(0)])
    sm = F.conv1d(padded.T[:, None], g.flip(0)[None, None].to(flat.dtype))[:, 0].T
    return sm.reshape(x.shape)


def motion_from_video_landmarks(assets, lm2d_seq: np.ndarray, smooth: bool = True,
                                device: torch.device | str = "cuda") -> dict:
    """Driving-video landmarks [T,68,2] -> {exp, euler, trans, id}
    coefficient sequences on ``device``, fitted by
    :func:`~real3dportrait_tpu_torch.geometry.fit_3dmm.fit_coeffs`; with
    ``smooth`` and more than 7 frames, exp is smoothed over time with a
    kernel of 5 at sigma 1 and the pose with the defaults (7, sigma 2)."""
    fit = fit_coeffs(assets, lm2d_seq, device=device)
    exp, euler, trans = fit.exp, fit.euler, fit.trans
    if smooth and len(exp) > 7:
        exp = smooth_features_1d(exp, kernel_size=5, sigma=1.0)
        euler = smooth_features_1d(euler)
        trans = smooth_features_1d(trans)
    return {"exp": exp, "euler": euler, "trans": trans, "id": fit.id}


def motion_from_video(video_path: str, assets, landmark_extractor=None,
                      max_frames: int | None = None, smooth: bool = True,
                      device: torch.device | str = "cuda") -> dict:
    """Driving video file -> {exp, euler, trans, id} coefficient sequences:
    decoded and resampled to 25 fps, 68 landmarks a frame
    (``landmark_extractor``, by default the naive box-template one), then
    :func:`motion_from_video_landmarks`."""
    frames = resample_video(video_path, max_frames=max_frames)
    if len(frames) == 0:
        raise ValueError(f"no frames decoded from {video_path}")
    extractor = landmark_extractor or naive_landmark_extractor
    lm2d_seq = np.asarray(extractor(frames))
    return motion_from_video_landmarks(assets, lm2d_seq, smooth=smooth, device=device)


def load_motion_coeff_npy(path: str) -> dict | None:
    """A motion-coefficient dict (exp / euler / trans arrays) from .npy, or
    None when the file holds a plain array (precomputed HuBERT features)."""
    arr = np.load(path, allow_pickle=True)
    obj = arr.item() if isinstance(arr, np.ndarray) and arr.dtype == object else arr
    if isinstance(obj, dict) and ("exp" in obj or "euler" in obj):
        return {k: np.asarray(v) for k, v in obj.items()}
    return None


def map_pose_to_source(euler: torch.Tensor, trans: torch.Tensor, src_euler: torch.Tensor,
                       src_trans: torch.Tensor, z_fix: bool = True,
                       map_to_init: bool = True):
    """Driving-pose normalisation: hold the driving depth at frame 0
    (``z_fix``) and offset the sequence so that frame 0 coincides with the
    source pose (``map_to_init``)."""
    euler, trans = euler.float().clone(), trans.float().clone()
    if z_fix:
        trans[:, 2] = trans[0, 2]
    if map_to_init:
        euler = euler + (src_euler.reshape(1, 3) - euler[:1])
        trans = trans + (src_trans.reshape(1, 3) - trans[:1])
    return euler, trans

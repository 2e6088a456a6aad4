"""Landmark-space morphable-model helpers (port of
``real3dportrait_tpu/geometry/face3d_helper.py``): the packed-coefficient
split, the landmark reconstructions, 3D and in the 224 fit frame, and the
landmark edits (eye and mouth subsets, closing the mouth or the eyes)."""

from __future__ import annotations

import torch

from real3dportrait_tpu_torch.geometry import bfm as bfm_ops
from real3dportrait_tpu_torch.geometry.bfm import BFMAssets

IDEXP_LM3D_SCALE = 10.0


def split_coeff(coeff: torch.Tensor) -> dict:
    """Split a packed 257-dim 3DMM coefficient vector."""
    return {
        "identity": coeff[..., :80],
        "expression": coeff[..., 80:144],
        "texture": coeff[..., 144:224],
        "euler": coeff[..., 224:227],
        "gamma": coeff[..., 227:254],
        "translation": coeff[..., 254:257],
    }


def reconstruct_idexp_lm3d(assets: BFMAssets, id_coeff: torch.Tensor,
                           exp_coeff: torch.Tensor) -> torch.Tensor:
    """[T,80],[T,64] -> [T,K,3] identity+expression landmark offsets, x10."""
    flat = id_coeff @ assets.key_id_base.T + exp_coeff @ assets.key_exp_base.T
    return flat.reshape(id_coeff.shape[0], -1, 3) * IDEXP_LM3D_SCALE


def reconstruct_cano_lm3d(assets: BFMAssets, id_coeff: torch.Tensor,
                          exp_coeff: torch.Tensor) -> torch.Tensor:
    """[T,80],[T,64] -> [T,K,3] canonical (pose-free) landmarks."""
    return bfm_ops.compute_key_shape(assets, id_coeff, exp_coeff)


def reconstruct_lm3d(assets: BFMAssets, id_coeff: torch.Tensor, exp_coeff: torch.Tensor,
                     euler: torch.Tensor, trans: torch.Tensor,
                     to_camera: bool = True) -> torch.Tensor:
    """coeffs -> [T,K,3] posed landmarks, optionally in the camera frame."""
    lm = bfm_ops.compute_key_shape(assets, id_coeff, exp_coeff)
    lm = bfm_ops.transform(lm, bfm_ops.compute_rotation(euler), trans)
    return bfm_ops.to_camera(lm) if to_camera else lm


def reconstruct_lm2d(assets: BFMAssets, id_coeff: torch.Tensor, exp_coeff: torch.Tensor,
                     euler: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """coeffs -> [T,K,2] normalised [0,1] image landmarks (224 fit frame,
    y flipped); [B,T,C] inputs give [B,T,K,2]."""
    btc = id_coeff.dim() == 3
    if btc:
        b, t = id_coeff.shape[:2]
        id_coeff, exp_coeff, euler, trans = (
            a.reshape(b * t, -1) for a in (id_coeff, exp_coeff, euler, trans))
    lm2d = bfm_ops.to_image(reconstruct_lm3d(assets, id_coeff, exp_coeff, euler, trans))
    lm2d = torch.stack([lm2d[..., 0], 224.0 - lm2d[..., 1]], dim=-1) / 224.0
    return lm2d.reshape(b, t, -1, 2) if btc else lm2d


def get_eye_mouth_lm(lm3d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., 68, 3] -> (eye landmarks [...,31,3], mouth landmarks [...,20,3])."""
    return lm3d[..., 17:48, :], lm3d[..., 48:68, :]


def _meet(x: torch.Tensor, upper: list, lower: list, up_eps: float = 0.0,
          low_eps: float = 0.0) -> None:
    """In place on y (x[:, :, 1]): the upper points to the pair's mean (+
    ``up_eps``), then the lower to the new pair's mean (+ ``low_eps``)."""
    x[:, upper, 1] = (x[:, upper, 1] + x[:, lower, 1]) / 2 + up_eps
    x[:, lower, 1] = (x[:, upper, 1] + x[:, lower, 1]) / 2 + low_eps


def close_mouth_for_idexp_lm3d(idexp_lm3d: torch.Tensor,
                               freeze_as_first_frame: bool = True) -> torch.Tensor:
    """Snap the upper and lower lip landmarks together (a new tensor): the
    outer and inner lips meet, then the outer lips open 0.03 about the
    inner ones; ``freeze_as_first_frame`` zeroes the mouth's offsets."""
    x = idexp_lm3d.reshape(-1, 68, 3).clone()
    upper_out, lower_out = list(range(49, 54)), list(range(59, 54, -1))
    upper_in, lower_in = list(range(61, 64)), list(range(67, 64, -1))
    _meet(x, upper_out, lower_out)
    _meet(x, upper_in, lower_in)
    x[:, upper_out, 1] += (0.03 - x[:, upper_out, 1].mean(dim=1)
                           + x[:, upper_in, 1].mean(dim=1))[:, None]
    x[:, lower_out, 1] += (-0.03 - x[:, lower_out, 1].mean(dim=1)
                           + x[:, lower_in, 1].mean(dim=1))[:, None]
    if freeze_as_first_frame:
        x[:, 48:68] = 0.0
    return x.reshape(idexp_lm3d.shape)


def close_eyes_for_idexp_lm3d(idexp_lm3d: torch.Tensor, eps: float = 0.003) -> torch.Tensor:
    """Snap the eyelid landmarks together (a new tensor), ``eps`` apart."""
    x = idexp_lm3d.reshape(-1, 68, 3).clone()
    for upper, lower in ((list(range(37, 39)), list(range(41, 39, -1))),
                         (list(range(43, 45)), list(range(47, 45, -1)))):
        _meet(x, upper, lower, eps, -eps)
    return x.reshape(idexp_lm3d.shape)

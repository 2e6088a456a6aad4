"""Landmark-space morphable-model helpers (port of
``real3dportrait_tpu/geometry/face3d_helper.py``): the packed-coefficient
split and the landmark reconstructions, 3D and in the 224 fit frame."""

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

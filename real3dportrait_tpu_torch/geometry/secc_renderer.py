"""SECC (Semantic-aware Explicit Camera Condition) map rendering.

Port of ``real3dportrait_tpu/geometry/secc_renderer.py``: the BFM mesh,
coloured with the fixed NCC code and with the eyeball faces removed, is
rasterized from (id, exp, euler, trans) into a map in [-1, 1] plus a
coverage mask. The z-buffer runs at ``rasterize_size`` (192² in the
pipeline, 256² in training) and both maps are bilinearly resized to
``output_resolution`` (antialiased where that shrinks them, as JAX's
``jax.image.resize`` does).
The mesh goes through kernel K4 in one call for all frames, from the
camera-space vertices, and K4 writes the map in [-1, 1] itself; no face
bucketing is needed.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from real3dportrait_tpu_torch import entry_device
from real3dportrait_tpu_torch.geometry import bfm as bfm_ops
from real3dportrait_tpu_torch.geometry.bfm import BFMAssets
from real3dportrait_tpu_torch.geometry.rasterizer import rasterize_verts
from real3dportrait_tpu_torch.ops.resize import resize_linear


def load_eye_free_faces(assets: BFMAssets, bfm_dir: str | None) -> torch.Tensor:
    """Faces with the eyeball triangles removed, as int32 [F,3]."""
    faces = assets.face_buf.cpu().numpy()
    if bfm_dir:
        re_p = os.path.join(bfm_dir, "bfm_right_eye_faces.npy")
        le_p = os.path.join(bfm_dir, "bfm_left_eye_faces.npy")
        if os.path.isfile(re_p) and os.path.isfile(le_p):
            delete = np.concatenate([np.load(re_p), np.load(le_p)]) - 1
            keep = np.ones(len(faces), bool)
            keep[delete] = False
            faces = faces[keep]
    return torch.from_numpy(np.ascontiguousarray(faces, np.int32))


def resize_bilinear_nhwc(x: torch.Tensor, size: int) -> torch.Tensor:
    """[B,H,W,C] -> [B,size,size,C], ``jax.image.resize(..., "bilinear")``:
    half-pixel bilinear (align_corners=False) when enlarging, antialiased
    (the triangle filter widened by the scale) when shrinking."""
    if size < x.shape[1]:
        return resize_linear(x, size, size).contiguous()
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1).contiguous()


class SECCRenderer:
    """Holds the mesh and NCC colours on ``device`` (default ``"cuda"``;
    raises without a CUDA device); :meth:`render` rasterizes."""

    def __init__(self, assets: BFMAssets, bfm_dir: str | None = None,
                 rasterize_size: int = 512, output_resolution: int | None = None,
                 device: torch.device | str = "cuda"):
        device = entry_device(device)
        self.assets = assets.to(device)
        self.faces = load_eye_free_faces(assets, bfm_dir).to(device)
        self.rasterize_size = rasterize_size
        self.output_resolution = output_resolution or rasterize_size
        # NCC colours are stored in [-1,1]; the rasterizer interpolates them in
        # [0,1] and writes its map back in [-1,1]
        self.ncc_01 = ((self.assets.ncc_code + 1.0) / 2.0).contiguous()

    def render(self, id_coeff: torch.Tensor, exp_coeff: torch.Tensor,
               euler: torch.Tensor, trans: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """[B,C] coeffs -> (mask [B,H,W,1], secc [B,H,W,3] in [-1,1])."""
        verts = bfm_ops.compute_face_vertex(self.assets, id_coeff, exp_coeff, euler, trans)
        mask, secc = rasterize_verts(verts, self.faces, self.ncc_01,
                                     image_size=self.rasterize_size)
        mask = mask[..., None]
        if self.output_resolution != self.rasterize_size:
            secc = resize_bilinear_nhwc(secc, self.output_resolution)
            mask = resize_bilinear_nhwc(mask, self.output_resolution)
        return mask, secc

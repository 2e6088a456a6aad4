"""Bilinear and trilinear sampling of channels-last feature maps (port of
``real3dportrait_tpu/ops/grid_sample.py``: ``grid_sample_2d`` and
``grid_sample_3d``).

Semantics of ``torch.nn.functional.grid_sample``. The 2D sampler is the
renderer's mode (``align_corners=False``, zero padding), the sampling half
of kernel K1's plain version. The 3D sampler takes both corner conventions
and zero or border padding; border padding clamps the continuous
coordinate before the weights are computed, as torch's
``clip_coordinates`` and the JAX ``_source_coord`` do. The TPU gather
layouts (``pack_trigrid_cells``, ``grid_sample_3d_prepacked*``,
``grid_sample_3d_packed``) are not ported: the torso's two warps are
kernels K5a and K5b (``models/torso.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_2d(features: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """features [B,H,W,C], coords [B,M,2] (x indexes W, y indexes H) in
    [-1,1] -> [B,M,C]."""
    out = F.grid_sample(features.permute(0, 3, 1, 2), coords[:, None],
                        mode="bilinear", padding_mode="zeros", align_corners=False)
    return out[:, :, 0].permute(0, 2, 1)


def grid_sample_3d(features: torch.Tensor, coords: torch.Tensor,
                   align_corners: bool = False, padding_mode: str = "zeros") -> torch.Tensor:
    """features [B,D,H,W,C], coords [B,M,3] (x indexes W, y H, z D) in
    [-1,1] -> [B,M,C]."""
    out = F.grid_sample(features.permute(0, 4, 1, 2, 3), coords[:, :, None, None],
                        mode="bilinear", padding_mode=padding_mode,
                        align_corners=align_corners)
    return out[:, :, :, 0, 0].permute(0, 2, 1)

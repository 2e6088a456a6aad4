"""Bilinear sampling of channels-last feature maps (port of
``real3dportrait_tpu/ops/grid_sample.py:grid_sample_2d``).

Semantics of ``torch.nn.functional.grid_sample`` with ``align_corners=False``
and zero padding, the only mode the renderer uses; this is the sampling
half of kernel K1's plain version.
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

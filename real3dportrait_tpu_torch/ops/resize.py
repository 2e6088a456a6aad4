"""Channels-last image resizes shared by the renderer, the losses, the
perceptual criteria and the training tasks."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_linear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NHWC ``jax.image.resize(x, (B, h, w, C), "linear")``: half-pixel
    bilinear, antialiased (the triangle filter widened by the scale) when
    shrinking. Returns a channels-last view of an NCHW result."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)

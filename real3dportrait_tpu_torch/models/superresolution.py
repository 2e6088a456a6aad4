"""GAN super-resolution head, raw neural render -> final image (port of
``real3dportrait_tpu/models/superresolution.py``)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from real3dportrait_tpu_torch.models.stylegan2 import SynthesisBlock


def resize_bilinear(x: torch.Tensor, size: int, antialias: bool = True) -> torch.Tensor:
    """NHWC bilinear resize, half-pixel centres (align_corners=False); the
    identity when the size is unchanged, as in the JAX package."""
    if x.shape[1] == size and x.shape[2] == size:
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=antialias)
    return y.permute(0, 2, 3, 1)


def filtered_resizing(x: torch.Tensor, size: int, filter_mode: str = "antialiased"
                      ) -> torch.Tensor:
    """NHWC resize of the dual discriminator's raw image: antialiased
    bilinear (a plain differentiable resize, not kernel K6a), or plain
    bilinear for ``filter_mode="none"``."""
    if filter_mode == "antialiased":
        return resize_bilinear(x, size, antialias=True)
    if filter_mode == "none":
        return resize_bilinear(x, size, antialias=False)
    raise NotImplementedError(filter_mode)


class SuperresolutionHybrid8XDC(nn.Module):
    """128 -> 512 SR head: two skip SynthesisBlocks, both in bf16 with
    ``conv_clamp=256`` when ``sr_num_fp16_res > 0``."""

    def __init__(self, channels: int, w_dim: int = 512, sr_num_fp16_res: int = 0,
                 sr_antialias: bool = True, input_resolution: int = 128,
                 block0_channels: int = 256, block1_channels: int = 128,
                 final_resolution: int = 512):
        super().__init__()
        use_fp16 = sr_num_fp16_res > 0
        clamp = 256.0 if use_fp16 else None
        self.sr_antialias = sr_antialias
        self.final_resolution = final_resolution
        self.block0 = SynthesisBlock(channels, block0_channels, w_dim=w_dim,
                                     resolution=final_resolution // 2, img_channels=3,
                                     is_last=False, conv_clamp=clamp, use_fp16=use_fp16)
        self.block1 = SynthesisBlock(block0_channels, block1_channels, w_dim=w_dim,
                                     resolution=final_resolution, img_channels=3,
                                     is_last=True, conv_clamp=clamp, use_fp16=use_fp16)

    def forward(self, rgb: torch.Tensor, x: torch.Tensor, ws: torch.Tensor,
                noise_mode: str = "none") -> torch.Tensor:
        """rgb [B,h,w,3], x [B,h,w,C] (NHWC), ws [B,*,w_dim] -> [B,H,W,3]."""
        ws = ws[:, -1:, :].expand(-1, 3, -1)
        if x.shape[1] != self.final_resolution // 4:
            x = resize_bilinear(x, self.final_resolution // 4, self.sr_antialias)
            rgb = resize_bilinear(rgb, self.final_resolution // 4, self.sr_antialias)
        x, rgb = x.permute(0, 3, 1, 2), rgb.permute(0, 3, 1, 2)
        x, rgb = self.block0.forward_nchw(x, rgb, ws, noise_mode=noise_mode)
        x, rgb = self.block1.forward_nchw(x, rgb, ws, noise_mode=noise_mode)
        return rgb.permute(0, 2, 3, 1)

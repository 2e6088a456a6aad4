"""EG3D dual discriminator (port of
``real3dportrait_tpu/models/dual_discriminator.py``): a StyleGAN2
discriminator over the SR image concatenated with the raw neural render,
antialias-resized to the final resolution (6 channels), conditioned on the
25-d camera through a mapping network. Images come in NHWC, as in the JAX
package; the blocks run NCHW. Blocks at the ``num_fp16_res`` highest
resolutions run bf16 (kernels K6a and K6b in bf16). With ``disc_c_noise >
0`` the camera takes normal noise scaled by its batch standard deviation
(1 for a batch of one) times ``disc_c_noise``, drawn from the caller's
``draws`` (``utils/draws.py``); the training tasks run 0.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from real3dportrait_tpu_torch.models.stylegan2 import (
    DiscriminatorBlock,
    DiscriminatorEpilogue,
    MappingNetwork,
)
from real3dportrait_tpu_torch.models.superresolution import filtered_resizing


class DualDiscriminator(nn.Module):
    def __init__(self, img_resolution: int = 512, channel_base: int = 32768,
                 channel_max: int = 512, num_fp16_res: int = 4, conv_clamp: float = 256.0,
                 camera_dim: int = 25, mbstd_group_size: int = 2, disc_c_noise: float = 0.0):
        super().__init__()
        self.img_resolution, self.disc_c_noise = img_resolution, disc_c_noise
        log2 = int(math.log2(img_resolution))
        self.resolutions = [2 ** i for i in range(log2, 2, -1)]

        def channels(res):
            return min(channel_base // res, channel_max)

        cmap_dim = channels(4)
        fp16_resolution = max(2 ** (log2 + 1 - num_fp16_res), 8)
        for res in self.resolutions:
            setattr(self, f"b{res}", DiscriminatorBlock(
                channels(res) if res < img_resolution else 0, channels(res),
                channels(res // 2), res, img_channels=6, conv_clamp=conv_clamp,
                use_fp16=num_fp16_res > 0 and res >= fp16_resolution))
        self.mapping = MappingNetwork(camera_dim, cmap_dim)
        self.b4 = DiscriminatorEpilogue(channels(4), cmap_dim=cmap_dim,
                                        mbstd_group_size=mbstd_group_size,
                                        conv_clamp=conv_clamp)

    def forward(self, image: torch.Tensor, image_raw: torch.Tensor,
                camera: torch.Tensor, draws=None) -> torch.Tensor:
        """image [B,R,R,3] (SR output), image_raw [B,r,r,3] (raw render),
        both in [-1,1], camera [B,25] -> logits [B,1]. ``draws`` makes the
        camera noise where ``disc_c_noise > 0``."""
        raw_up = filtered_resizing(image_raw, image.shape[1])
        img = torch.clamp(torch.cat([image, raw_up], dim=-1), -1.0, 1.0).permute(0, 3, 1, 2)
        x = None
        for res in self.resolutions:
            x = getattr(self, f"b{res}")(x, img if x is None else None)
        if self.disc_c_noise > 0:
            if draws is None:
                raise ValueError("DualDiscriminator: disc_c_noise > 0 needs draws")
            c_std = camera.std(dim=0, unbiased=False) if camera.shape[0] > 1 else 1.0
            camera = camera + draws.normal(tuple(camera.shape), camera.device) * c_std \
                * self.disc_c_noise
        cmap = self.mapping(camera)
        return self.b4(x, cmap)

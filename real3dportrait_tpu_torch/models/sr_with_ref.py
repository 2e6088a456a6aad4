"""Torso/background-aware super-resolution head (port of
``real3dportrait_tpu/models/sr_with_ref.py``).

The 128^2 head render is lifted to 256^2 by a SynthesisBlock, alpha-fused
with the keypoint-warped torso (:class:`WarpBasedTorsoModel`) by the NeRF
weights image, composited over the encoded background with an occlusion
union, then lifted to 512^2. Fuse modes ``v2`` (alpha-cat + a NoUp
SynthesisBlock, the released one) and ``v1`` (additive blend), or no weight
fusion (plain concatenation). Resizes are antialiased bilinear. With
``sr_num_fp16_res > 0`` block0 and block1 run in bf16 (``conv_clamp=256``);
the fusion convs and ``head_torso_block`` stay fp32, and block0's bf16
features become fp32 where the fp32 weights image multiplies them, as in
the JAX package.

Two per-video caches have entry points of their own:

* :meth:`SuperresolutionHybrid8XDCWarp.torso_appearance` -> the masked
  torso appearance volume. Recompute it when the source torso image or its
  segmap changes. Pass it back as ``appearance_volume``.
* :meth:`SuperresolutionHybrid8XDCWarp.encode_bg` -> ``bg_feat``, the
  mid-resolution background RGB and its encoded feature. Recompute it when
  the background image changes. A given ``bg_feat`` overrides
  ``ref_bg_rgb``: the frame step then never reads the background image.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from real3dportrait_tpu_torch.models.segformer import nchw, nhwc
from real3dportrait_tpu_torch.models.stylegan2 import SynthesisBlock
from real3dportrait_tpu_torch.models.superresolution import resize_bilinear
from real3dportrait_tpu_torch.models.torso import TORSO_PRESETS, WarpBasedTorsoModel


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class SuperresolutionHybrid8XDCWarp(nn.Module):
    def __init__(self, channels: int, w_dim: int = 512, sr_num_fp16_res: int = 0,
                 sr_antialias: bool = True, input_resolution: int = 128,
                 mid_resolution: int = 256, final_resolution: int = 512,
                 block0_channels: int = 256, block1_channels: int = 128,
                 torso_kp_num: int = 4, torso_scale: str = "standard", fuse_mode: str = "v2",
                 head_threshold: float = 0.9, weight_fuse: bool = True,
                 torso_version: str = "v2", torso_norm_mode: str = "gn",
                 torso_inp_mode: str = "rgb_alpha"):
        super().__init__()
        use_fp16 = sr_num_fp16_res > 0
        clamp = 256.0 if use_fp16 else None
        if fuse_mode not in ("v1", "v2"):
            raise ValueError(f"fuse_mode must be 'v1' or 'v2', got {fuse_mode!r}")
        self.sr_antialias, self.mid = sr_antialias, mid_resolution
        self.fuse_mode, self.head_threshold = fuse_mode, head_threshold
        self.weight_fuse, self.torso_version = weight_fuse, torso_version
        c0 = block0_channels
        self.bg_enc_conv0 = _conv3(3, 64)
        self.bg_enc_conv1 = _conv3(64, c0)
        self.bg_enc_conv2 = _conv3(c0, c0)
        self.block0 = SynthesisBlock(channels, c0, w_dim=w_dim, resolution=mid_resolution,
                                     img_channels=3, is_last=False, conv_clamp=clamp,
                                     use_fp16=use_fp16)
        self.torso_model = WarpBasedTorsoModel(
            torso_kp_num=torso_kp_num, scale=torso_scale, norm_mode=torso_norm_mode,
            version=torso_version, inp_mode=torso_inp_mode)
        self.torso_encoder = nn.Conv2d(TORSO_PRESETS[torso_scale]["gen_up_seq"][-1], c0, 1)
        if weight_fuse and fuse_mode == "v2":
            self.fuse_ht_conv0 = _conv3(2 * c0, c0)
            self.fuse_ht_conv1 = _conv3(c0, c0)
            self.head_torso_block = SynthesisBlock(
                c0, c0, w_dim=w_dim, resolution=mid_resolution, img_channels=3,
                is_last=False, conv_clamp=None, up=1)
        self.fuse_fb_conv0 = nn.Conv2d((2 if weight_fuse else 3) * c0, 64, 1)
        self.fuse_fb_conv1 = _conv3(64, c0)
        self.fuse_fb_conv2 = _conv3(c0, c0)
        self.block1 = SynthesisBlock(c0, block1_channels, w_dim=w_dim,
                                     resolution=final_resolution, img_channels=3,
                                     is_last=True, conv_clamp=clamp, use_fp16=use_fp16)

    def _resize(self, x: torch.Tensor, size: int) -> torch.Tensor:
        return resize_bilinear(x, size, self.sr_antialias)

    def encode_bg(self, ref_bg_rgb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Background image [B,H,W,3] -> ``bg_feat`` = (mid-resolution RGB
        [B,mid,mid,3], encoded feature [B,mid,mid,block0_channels])."""
        bg_mid = self._resize(ref_bg_rgb, self.mid)
        x = self.bg_enc_conv0(nchw(bg_mid))
        x = self.bg_enc_conv1(F.leaky_relu(x, 0.01))
        x = self.bg_enc_conv2(F.leaky_relu(x, 0.01))
        return bg_mid, nhwc(x)

    def torso_appearance(self, ref_torso_rgb: torch.Tensor,
                         segmap: torch.Tensor) -> torch.Tensor:
        """Source torso image [B,H,W,3] + segmap -> appearance volume
        [B,D,h,w,C] (see :meth:`WarpBasedTorsoModel.appearance`)."""
        return self.torso_model.appearance(self._resize(ref_torso_rgb, self.mid), segmap)

    def forward(self, rgb: torch.Tensor, x: torch.Tensor, ws: torch.Tensor,
                ref_torso_rgb: torch.Tensor | None, ref_bg_rgb: torch.Tensor | None,
                weights_img: torch.Tensor, segmap: torch.Tensor, kp_s: torch.Tensor,
                kp_d: torch.Tensor, noise_mode: str = "none",
                appearance_volume: torch.Tensor | None = None,
                bg_feat: tuple[torch.Tensor, torch.Tensor] | None = None,
                target_torso_mask: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, dict]:
        """rgb [B,r,r,3] raw head render, x [B,r,r,C] feature image,
        ws [B,*,w_dim], ref_torso_rgb / ref_bg_rgb [B,H,W,3], weights_img
        [B,r,r,1], segmap [B,H,W,6], kp_s / kp_d [B,68,3] -> (image
        [B,final,final,3], the torso model's outputs). ``ref_torso_rgb`` is
        not read when ``appearance_volume`` is given, nor ``ref_bg_rgb``
        when ``bg_feat`` is; ``target_torso_mask`` [B,H,W] weighs the torso
        model's occlusion regularisers (its ``losses``)."""
        mid = self.mid
        ws = ws[:, -1:, :].expand(rgb.shape[0], 3, ws.shape[-1])
        # block0 doubles: land on mid // 2 for any render resolution
        if x.shape[1] != mid // 2:
            x = self._resize(x, mid // 2)
            rgb = self._resize(rgb, mid // 2)
        rgb_mid = self._resize(rgb, mid)
        weights_mid = self._resize(weights_img, mid)
        # the source torso image only feeds the appearance volume
        torso_mid = (self._resize(ref_torso_rgb, mid) if appearance_volume is None
                     else None)
        bg_mid, x_bg = bg_feat if bg_feat is not None else self.encode_bg(ref_bg_rgb)

        x, rgb = self.block0.forward_nchw(nchw(x), nchw(rgb), ws, noise_mode=noise_mode)
        head = {}
        if self.torso_version == "v2":
            head = dict(tgt_head_img=rgb_mid, tgt_head_weights=weights_mid)
        torso_ret = self.torso_model(torso_mid, segmap, kp_s, kp_d,
                                     target_torso_mask=target_torso_mask,
                                     appearance_volume=appearance_volume, **head)
        rgb_torso = nchw(torso_ret["deformed_torso_img"])
        x_torso = self.torso_encoder(nchw(torso_ret["deformed_torso_hid"]))

        if self.weight_fuse:
            alpha = nchw(weights_mid)
            rgb = rgb * alpha + rgb_torso * (1 - alpha)
            if self.fuse_mode == "v1":
                x = x * alpha + x_torso * (1 - alpha)
            else:
                x = torch.cat([x * alpha, x_torso * (1 - alpha)], dim=1)
                x = self.fuse_ht_conv0(x)
                x = self.fuse_ht_conv1(F.leaky_relu(x, 0.01))
                x, rgb = self.head_torso_block.forward_nchw(x, rgb, ws, noise_mode=noise_mode)
            head_occlusion = torch.where(alpha > self.head_threshold,
                                         torch.ones_like(alpha), alpha)
            torso_occlusion = nchw(self._resize(torso_ret["occlusion_2"], mid))
            person = torch.clamp(torso_occlusion + head_occlusion, 0.0, 1.0)
            rgb = rgb * person + nchw(bg_mid) * (1 - person)
            x = torch.cat([x * person, nchw(x_bg) * (1 - person)], dim=1)
        else:
            x = torch.cat([x, x_torso, nchw(x_bg)], dim=1)

        x = self.fuse_fb_conv0(x)
        x = self.fuse_fb_conv1(F.leaky_relu(x, 0.01))
        x = self.fuse_fb_conv2(F.leaky_relu(x, 0.01))
        x, rgb = self.block1.forward_nchw(x, rgb, ws, noise_mode=noise_mode)
        return nhwc(rgb), torso_ret

"""Composite one-shot image-to-triplane backbone (port of
``real3dportrait_tpu/models/img2plane_composite.py``), the released
checkpoints' canonical backbone: a dilated ResNet34 + norm-free ASPP and a
global-attention ViT (low resolution), a detail CNN (high resolution), and
a predictor ViT fusing both into the raw planes.

The ResNet's BatchNorms are the exact eval-time per-channel affines of
converted checkpoints (``norm_mode="affine"``) or GroupNorms
(``norm_mode="gn"``, the JAX package's default, which every training stage
uses). Public layouts are NHWC; convolutions run NCHW inside.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from real3dportrait_tpu_torch.models.segformer import (
    Conv,
    MiTBlock,
    OverlapPatchEmbed,
    _to_planes,
    nchw,
    nhwc,
)

COMPOSITE_SCALES = {"small": (2, 1), "standard": (5, 1), "large": (10, 3)}


def pixel_shuffle(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """NHWC [B,H,W,C*r*r] -> [B,H*r,W*r,C] in ``nn.PixelShuffle`` order."""
    return nhwc(F.pixel_shuffle(nchw(x), factor))


class ChannelAffine(nn.Module):
    """Per-channel ``x * weight + bias`` on NC... (NCHW, NCDHW): a folded
    eval-time BatchNorm."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (-1,) + (1,) * (x.dim() - 2)
        return x * self.weight.view(shape) + self.bias.view(shape)


def _norm(c: int, mode: str) -> nn.Module:
    """``affine``: a folded eval-time BatchNorm; ``gn``: Flax's GroupNorm
    (epsilon 1e-6) with at most 32 groups of at least 8 channels, fewer
    until the count divides ``c``."""
    if mode == "affine":
        return ChannelAffine(c)
    if mode != "gn":
        raise ValueError(f"norm_mode must be 'affine' or 'gn', got {mode!r}")
    groups = max(1, min(32, c // 8))
    while c % groups:
        groups -= 1
    return nn.GroupNorm(groups, c, eps=1e-6)


class BasicBlock(nn.Module):
    """ResNet BasicBlock with SMP's dilation patching."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1, dilation: int = 1,
                 use_downsample: bool = False, norm_mode: str = "affine"):
        super().__init__()
        self.conv1 = Conv(in_planes, planes, 3, stride=stride, padding=dilation,
                          dilation=dilation, bias=False)
        self.bn1 = _norm(planes, norm_mode)
        self.conv2 = Conv(planes, planes, 3, padding=dilation, dilation=dilation, bias=False)
        self.bn2 = _norm(planes, norm_mode)
        self.use_downsample = use_downsample
        if use_downsample:
            self.downsample_conv = Conv(in_planes, planes, 1, stride=stride, bias=False)
            self.downsample_norm = _norm(planes, norm_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = self.downsample_norm(self.downsample_conv(x)) if self.use_downsample else x
        return F.relu(y + identity)


class ResNet34Encoder(nn.Module):
    """ResNet34 at output stride 8 (layers 3/4 dilated 2/4)."""

    def __init__(self, in_ch: int, layers: Sequence[int] = (3, 4, 6, 3),
                 planes: Sequence[int] = (64, 128, 256, 512),
                 stage_cfg: Sequence[tuple] = ((1, 1), (2, 1), (1, 2), (1, 4)),
                 norm_mode: str = "affine"):
        super().__init__()
        self.conv1 = Conv(in_ch, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _norm(64, norm_mode)
        self.block_names = []
        c = 64
        for li, (n_blocks, p, (stride, dil)) in enumerate(zip(layers, planes, stage_cfg), 1):
            for bi in range(n_blocks):
                use_ds = bi == 0 and (stride != 1 or c != p)
                name = f"layer{li}_{bi}"
                setattr(self, name, BasicBlock(c, p, stride=stride if bi == 0 else 1,
                                               dilation=dil, use_downsample=use_ds,
                                               norm_mode=norm_mode))
                self.block_names.append(name)
                c = p

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW -> NCHW
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x


class DeepLabDecoder(nn.Module):
    """ASPP + 3x3 projection, norm-free."""

    def __init__(self, in_ch: int = 512, out_channels: int = 256,
                 rates: Sequence[int] = (12, 24, 36)):
        super().__init__()
        c = out_channels
        self.rates = tuple(rates)
        self.aspp_conv0 = Conv(in_ch, c, 1, bias=False)
        for i, r in enumerate(rates, 1):
            setattr(self, f"aspp_conv{i}", Conv(in_ch, c, 3, padding=r, dilation=r, bias=False))
        self.aspp_pool_conv = Conv(in_ch, c, 1, bias=False)
        self.aspp_project = Conv(c * (len(rates) + 2), c, 1, bias=False)
        self.out_conv = Conv(c, c, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        branches = [F.relu(self.aspp_conv0(x))]
        for i in range(1, len(self.rates) + 1):
            branches.append(F.relu(getattr(self, f"aspp_conv{i}")(x)))
        pooled = F.relu(self.aspp_pool_conv(x.mean(dim=(2, 3), keepdim=True)))
        branches.append(pooled.expand(-1, -1, *x.shape[2:]))
        h = F.relu(self.aspp_project(torch.cat(branches, dim=1)))
        return self.out_conv(h)


class DeepLabV3LowEncoder(nn.Module):
    def __init__(self, in_ch: int, norm_mode: str = "affine"):
        super().__init__()
        self.encoder = ResNet34Encoder(in_ch, norm_mode=norm_mode)
        self.decoder = DeepLabDecoder()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(x))


class HighResoEncoder(nn.Module):
    """Stride-2 detail CNN (the reference never applies its activation after
    ``first``)."""

    def __init__(self, in_ch: int, out_channels: int = 96):
        super().__init__()
        self.first = Conv(in_ch, 64, 7, stride=2, padding=3)
        for i in range(4):
            setattr(self, f"conv{i}", Conv(64 if i == 0 else 96, 96, 3, padding=1))
        self.final = Conv(96, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        h = self.first(x)
        for i in range(4):
            h = F.leaky_relu(getattr(self, f"conv{i}")(h), 0.01)
        return self.final(h)


class LowResolutionViT(nn.Module):
    """Global attention over the semantic features, upsampled 8x."""

    def __init__(self, in_ch: int = 256, num_blocks: int = 5, vit_dim: int = 1024,
                 out_channels: int = 96):
        super().__init__()
        self.num_blocks = num_blocks
        self.patch_embed = OverlapPatchEmbed(in_ch, vit_dim, 3, 2, ln_eps=1e-5)
        for i in range(num_blocks):
            setattr(self, f"block{i + 1}", MiTBlock(vit_dim, num_heads=4, sr_ratio=1,
                                                    mlp_ratio=2, ln_eps=1e-5))
        self.conv_after_upsample1 = Conv(vit_dim // 4, 128, 3, padding=1)
        self.conv_after_upsample2 = Conv(128, 128, 3, padding=1)
        self.final_conv = Conv(128, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NHWC -> NCHW
        h = self.patch_embed(x)
        for i in range(self.num_blocks):
            h = getattr(self, f"block{i + 1}")(h)
        h = F.pixel_shuffle(nchw(h), 2)
        h = F.interpolate(h, scale_factor=2, mode="bilinear", align_corners=True)
        h = F.relu(self.conv_after_upsample1(h))
        h = F.interpolate(h, scale_factor=2, mode="bilinear", align_corners=True)
        h = F.relu(self.conv_after_upsample2(h))
        return self.final_conv(h)


class TriplanePredictorViT(nn.Module):
    """Fuses low-res semantic + high-res detail features into raw planes."""

    def __init__(self, in_ch: int, low_ch: int = 96, num_blocks: int = 1,
                 vit_dim: int = 1024, out_channels: int = 96):
        super().__init__()
        self.num_blocks = num_blocks
        self.first_conv = Conv(in_ch, 256, 3, padding=1)
        self.second_conv = Conv(256, 128, 3, padding=1)
        self.patch_embed = OverlapPatchEmbed(128, vit_dim, 3, 2, ln_eps=1e-5)
        for i in range(num_blocks):
            setattr(self, f"block{i + 1}", MiTBlock(vit_dim, num_heads=4, sr_ratio=2,
                                                    mlp_ratio=2, ln_eps=1e-5))
        self.first_conv_after_cat = Conv(vit_dim // 4 + low_ch, 256, 3, padding=1)
        self.second_conv_after_cat = Conv(256, 128, 3, padding=1)
        self.third_conv_after_cat = Conv(128, 128, 3, padding=1)
        self.final_conv = Conv(128, out_channels, 3, padding=1)

    def forward(self, x_low: torch.Tensor, x_high: torch.Tensor) -> torch.Tensor:  # NCHW
        h = F.leaky_relu(self.first_conv(torch.cat([x_low, x_high], dim=1)), 0.01)
        h = F.leaky_relu(self.second_conv(h), 0.01)
        h = self.patch_embed(nhwc(h))
        for i in range(self.num_blocks):
            h = getattr(self, f"block{i + 1}")(h)
        h = torch.cat([F.pixel_shuffle(nchw(h), 2), x_low], dim=1)
        for name in ("first_conv_after_cat", "second_conv_after_cat", "third_conv_after_cat"):
            h = F.leaky_relu(getattr(self, name)(h), 0.01)
        return self.final_conv(h)


class CompositeImg2PlaneBackbone(nn.Module):
    """image [B,H,W,3] (NHWC) -> planes [B,3,H/2,W/2,C]. ``input_mode``
    "rgb", "rgb_alpha" (an alpha channel: ``cond["ref_alphas"]`` [B,H,W,1],
    else 1 where the pixel's channel mean is at least -0.999), "rgb_camera"
    (three channels of ``camera_to_channel(cond["ref_cameras"])``, a dense
    layer of the 25-d camera broadcast over the image) or
    "rgb_alpha_camera" (both, alpha first)."""

    def __init__(self, plane_channels: int = 96, scale: str = "standard",
                 vit_dim: int = 1024, input_mode: str = "rgb", norm_mode: str = "affine"):
        super().__init__()
        if input_mode not in ("rgb", "rgb_alpha", "rgb_camera", "rgb_alpha_camera"):
            raise ValueError(f"input_mode {input_mode!r}")
        self.plane_channels, self.input_mode = plane_channels, input_mode
        low_blocks, pred_blocks = COMPOSITE_SCALES[scale]
        # rgb, alpha, camera channels, the xy coordinate channels
        in_ch = 3 + ("alpha" in input_mode) + 3 * ("camera" in input_mode) + 2
        if "camera" in input_mode:
            self.camera_to_channel = nn.Linear(25, 3)       # the packed camera
        self.low_reso_encoder = DeepLabV3LowEncoder(in_ch, norm_mode)
        self.low_reso_vit = LowResolutionViT(256, low_blocks, vit_dim)
        self.high_reso_encoder = HighResoEncoder(in_ch)
        self.triplane_predictor_vit = TriplanePredictorViT(
            96 + 96, num_blocks=pred_blocks, vit_dim=vit_dim,
            out_channels=plane_channels * 3)

    def forward(self, img: torch.Tensor, cond: dict | None = None) -> torch.Tensor:
        b, h, w, _ = img.shape
        x = [nchw(img)]
        if "alpha" in self.input_mode:
            alphas = (cond or {}).get("ref_alphas")
            if alphas is None:
                alphas = (img.mean(dim=-1, keepdim=True) >= -0.999).to(img.dtype)
            x.append(nchw(alphas.to(img.dtype)))
        if "camera" in self.input_mode:
            cam = self.camera_to_channel((cond or {})["ref_cameras"].to(img.dtype))
            x.append(cam[:, :, None, None].expand(b, 3, h, w))
        # both axes normalized by H; channel 0 is the ROW coordinate
        gy, gx = torch.meshgrid(torch.arange(h, device=img.device) / h,
                                torch.arange(w, device=img.device) / h, indexing="ij")
        x.append(torch.stack([gy, gx], dim=0)[None].expand(b, 2, h, w).to(img.dtype))
        x = torch.cat(x, dim=1)
        feat_low = self.low_reso_vit(nhwc(self.low_reso_encoder(x)))
        feat_high = self.high_reso_encoder(x)
        raw = self.triplane_predictor_vit(feat_low, feat_high)
        return _to_planes(nhwc(raw), self.plane_channels)

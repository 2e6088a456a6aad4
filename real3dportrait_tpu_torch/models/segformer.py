"""SegFormer / Mix-Vision-Transformer backbones (port of
``real3dportrait_tpu/models/segformer.py``).

Module and parameter names follow the JAX tree (``patch_embed1/Conv_0``,
``block1_0/attn/q``, ...), so :func:`weights.torch_state_dict_from_jax`
maps it name for name. Public inputs and outputs are NHWC; convolutions
run NCHW inside. Attention is ``F.scaled_dot_product_attention``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

MIT_CONFIGS: dict[str, dict] = {
    "nano": {"embed_dims": (8, 16, 40, 32), "depths": (1, 1, 1, 1)},
    "b0": {"embed_dims": (32, 64, 160, 256), "depths": (2, 2, 2, 2)},
    "b1": {"embed_dims": (64, 128, 320, 512), "depths": (2, 2, 2, 2)},
    "b2": {"embed_dims": (64, 128, 320, 512), "depths": (3, 4, 6, 3)},
    "b3": {"embed_dims": (64, 128, 320, 512), "depths": (3, 4, 18, 3)},
    "b4": {"embed_dims": (64, 128, 320, 512), "depths": (3, 8, 27, 3)},
    "b5": {"embed_dims": (64, 128, 320, 512), "depths": (3, 6, 40, 3)},
}
MIT_NUM_HEADS = (1, 2, 5, 8)
MIT_SR_RATIOS = (8, 4, 2, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Conv(nn.Conv2d):
    """``nn.Conv2d`` with Flax's default ``"SAME"`` padding available:
    ``padding=None`` pads like Flax/XLA (extra row/column at the end)."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1,
                 padding: int | None = None, dilation: int = 1, groups: int = 1,
                 bias: bool = True):
        super().__init__(in_ch, out_ch, k, stride=stride,
                         padding=0 if padding is None else padding,
                         dilation=dilation, groups=groups, bias=bias)
        self.same = padding is None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.same:
            pads = []
            for size, k, s, d in zip(x.shape[:1:-1], self.kernel_size[::-1],
                                     self.stride[::-1], self.dilation[::-1]):
                total = max((math.ceil(size / s) - 1) * s + (k - 1) * d + 1 - size, 0)
                pads += [total // 2, total - total // 2]
            x = F.pad(x, pads)
        return super().forward(x)


def resize_nhwc(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with half-pixel centres (align_corners=False)."""
    return nhwc(F.interpolate(nchw(x), size=tuple(hw), mode="bilinear",
                              align_corners=False))


def upsample_align_corners(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """NHWC bilinear resize with align_corners=True
    (``nn.UpsamplingBilinear2d``)."""
    return nhwc(F.interpolate(nchw(x), size=tuple(hw), mode="bilinear",
                              align_corners=True))


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.Conv_0 = Conv(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NHWC
        return nhwc(self.Conv_0(nchw(x)))


class MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.Dense_0 = nn.Linear(dim, hidden)
        self.DWConv_0 = DWConv(hidden)
        self.Dense_1 = nn.Linear(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.gelu(self.DWConv_0(self.Dense_0(x))))


class SRAttention(nn.Module):
    """Attention with spatial reduction of K/V."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1, ln_eps: float = 1e-6):
        super().__init__()
        self.dim, self.num_heads, self.sr_ratio = dim, num_heads, sr_ratio
        self.q = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = Conv(dim, dim, sr_ratio, stride=sr_ratio)
            self.sr_norm = nn.LayerNorm(dim, eps=ln_eps)
        self.kv = nn.Linear(dim, dim * 2)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NHWC
        b, h, w, c = x.shape
        hd = self.dim // self.num_heads
        q = self.q(x).reshape(b, h * w, self.num_heads, hd).transpose(1, 2)
        kv_in = x
        if self.sr_ratio > 1:
            kv_in = self.sr_norm(nhwc(self.sr(nchw(x))))
        n_kv = kv_in.shape[1] * kv_in.shape[2]
        kv = self.kv(kv_in).reshape(b, n_kv, 2, self.num_heads, hd)
        k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
        out = F.scaled_dot_product_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(b, h, w, self.dim))


class MiTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int, mlp_ratio: int = 4,
                 ln_eps: float = 1e-6):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn = SRAttention(dim, num_heads, sr_ratio, ln_eps=ln_eps)
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.mlp = MixFFN(dim, dim * mlp_ratio, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_ch: int, embed_dim: int, patch_size: int, stride: int,
                 ln_eps: float = 1e-6):
        super().__init__()
        self.Conv_0 = Conv(in_ch, embed_dim, patch_size, stride=stride,
                           padding=patch_size // 2)
        self.LayerNorm_0 = nn.LayerNorm(embed_dim, eps=ln_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NHWC -> NHWC
        return self.LayerNorm_0(nhwc(self.Conv_0(nchw(x))))


class MixVisionTransformer(nn.Module):
    """4-stage MiT encoder returning the multi-scale pyramid (NHWC)."""

    def __init__(self, in_chans: int = 3, scale: str = "b0"):
        super().__init__()
        cfg = MIT_CONFIGS[scale]
        self.embed_dims, self.depths = cfg["embed_dims"], cfg["depths"]
        patch = [(7, 4), (3, 2), (3, 2), (3, 2)]
        prev = in_chans
        for stage in range(4):
            dim = self.embed_dims[stage]
            setattr(self, f"patch_embed{stage + 1}",
                    OverlapPatchEmbed(prev, dim, *patch[stage]))
            for i in range(self.depths[stage]):
                setattr(self, f"block{stage + 1}_{i}",
                        MiTBlock(dim, MIT_NUM_HEADS[stage], MIT_SR_RATIOS[stage]))
            setattr(self, f"norm{stage + 1}", nn.LayerNorm(dim, eps=1e-6))
            prev = dim

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        for stage in range(4):
            x = getattr(self, f"patch_embed{stage + 1}")(x)
            for i in range(self.depths[stage]):
                x = getattr(self, f"block{stage + 1}_{i}")(x)
            x = getattr(self, f"norm{stage + 1}")(x)
            feats.append(x)
        return feats


class SegFormerHead(nn.Module):
    """All-MLP decode head fusing the 4-scale pyramid.

    ``norm_mode``: ``"gn"`` (GroupNorm after the fuse conv) or
    ``"folded_bn"`` (no norm; the BatchNorm affine lives in the fuse conv).
    """

    def __init__(self, in_dims: Sequence[int], embedding_dim: int = 256,
                 norm_mode: str = "gn"):
        super().__init__()
        self.norm_mode = norm_mode
        for i, d in enumerate(in_dims):
            setattr(self, f"linear_c{i + 1}", nn.Linear(d, embedding_dim))
        self.n_in = len(in_dims)
        self.linear_fuse = Conv(embedding_dim * len(in_dims), embedding_dim, 1,
                                bias=(norm_mode == "folded_bn"))
        if norm_mode == "gn":
            self.fuse_norm = nn.GroupNorm(32, embedding_dim, eps=1e-6)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        target_hw = tuple(feats[0].shape[1:3])
        projected = []
        for i, f in enumerate(feats):
            p = getattr(self, f"linear_c{i + 1}")(f)
            if tuple(p.shape[1:3]) != target_hw:
                p = resize_nhwc(p, target_hw)
            projected.append(p)
        x = self.linear_fuse(nchw(torch.cat(projected[::-1], dim=-1)))
        if self.norm_mode == "gn":
            x = self.fuse_norm(x)
        return nhwc(F.relu(x))


class PlaneCNN(nn.Module):
    """Fused feature map -> raw planes: 3 convs, 2x upsample, projection."""

    def __init__(self, in_ch: int, out_channels: int):
        super().__init__()
        for i in range(3):
            setattr(self, f"conv{i}", Conv(in_ch if i == 0 else 256, 256, 3, padding=1))
        self.to_plane = Conv(256, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NHWC -> NHWC
        x = nchw(x)
        for i in range(3):
            x = F.leaky_relu(getattr(self, f"conv{i}")(x), 0.01)
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        return nhwc(self.to_plane(x))


def apply_plane_flips(planes: torch.Tensor) -> torch.Tensor:
    """hide-nerf axis alignment on [B,3,H,W,C]: xy and xz planes flip H; the
    zy plane flips H and W."""
    return torch.stack([planes[:, 0].flip(1), planes[:, 1].flip(1),
                        planes[:, 2].flip((1, 2))], dim=1)


def _to_planes(raw: torch.Tensor, plane_channels: int) -> torch.Tensor:
    """[B,H,W,3*C] -> flipped planes [B,3,H,W,C]."""
    b, h, w, _ = raw.shape
    planes = raw.reshape(b, h, w, 3, plane_channels).movedim(3, 1)
    return apply_plane_flips(planes)


class SegFormerImg2PlaneBackbone(nn.Module):
    """Portrait image [B,H,W,3] -> canonical tri-plane [B,3,H/2,W/2,C]."""

    def __init__(self, scale: str = "b0", plane_channels: int = 96,
                 head_norm_mode: str = "gn"):
        super().__init__()
        self.plane_channels = plane_channels
        self.mix_vit = MixVisionTransformer(3, scale)
        self.fuse_head = SegFormerHead(self.mix_vit.embed_dims, norm_mode=head_norm_mode)
        self.to_plane_cnn = PlaneCNN(256, plane_channels * 3)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        fused = self.fuse_head(self.mix_vit(img))
        return _to_planes(self.to_plane_cnn(fused), self.plane_channels)


class SegFormerSECC2PlaneBackbone(nn.Module):
    """(cano, src, tgt) SECC maps [B,H,W,9] (or [B,H,W,6] for cano_tgt) ->
    residual motion plane [B,3,H/2,W/2,C]."""

    def __init__(self, scale: str = "b0", plane_channels: int = 96,
                 pncc_cond_mode: str = "cano_src_tgt", head_norm_mode: str = "gn"):
        super().__init__()
        from real3dportrait_tpu_torch.models.stylegan2 import Conv2dLayer

        self.plane_channels = plane_channels
        in_ch = 9 if pncc_cond_mode == "cano_src_tgt" else 6
        self.prenet = Conv2dLayer(in_ch, 3, kernel_size=1)
        self.mix_vit = MixVisionTransformer(3, scale)
        self.fuse_head = SegFormerHead(self.mix_vit.embed_dims, norm_mode=head_norm_mode)
        self.to_plane_cnn = PlaneCNN(256, plane_channels * 3)

    def forward(self, secc: torch.Tensor) -> torch.Tensor:
        x = nhwc(self.prenet(nchw(secc)))
        fused = self.fuse_head(self.mix_vit(x))
        return _to_planes(self.to_plane_cnn(fused), self.plane_channels)

"""Keypoint-driven warp-based torso model and kernels K5a, K5b, K7b (port of
``real3dportrait_tpu/models/torso.py``).

Components: :class:`AppearanceFeatureExtractor` (2D conv pyramid -> 3D
appearance volume), :class:`MotionFieldEstimator` (keypoint heatmaps and K+1
candidate warps -> dense deformation and two occlusion maps),
:class:`WarpGenerator` (warped volume -> torso RGB and hidden features) and
the :class:`WarpBasedTorsoModel` wrapper, driven by a subset of the 68
landmarks. Parameter names follow the JAX tree. Convolutions run NCDHW /
NCHW inside; public tensors keep the JAX layouts (volumes [B,D,H,W,C],
images NHWC, keypoints [B,K,3]).

The two trilinear warps (``csrc/torso_warp.cu``) and the estimator's tail
(``csrc/conv3d.cu``) are kernels, each with its plain PyTorch version
beside it (every 3D convolution of the model is kernel K7a,
``ops/conv3d.py``):

* :func:`torso_deform_input` (K5a) writes the motion-field estimator's
  input: keypoint heatmaps and the K+1 candidate warps of the compressed
  volume (align_corners=True, zero padding), plain version
  :func:`torso_deform_input_plain`;
* :func:`torso_warp_volume` (K5b) warps the appearance volume by the dense
  deformation (align_corners=True, border padding) into the generator's
  depth-folded input, plain version :func:`torso_warp_volume_plain`;
* :func:`mfe_tail` (K7b) computes the estimator's tail: the 7^3 mask conv,
  its softmax and the deformation, and both 7^2 occlusion heads on the
  depth fold, plain version :func:`mfe_tail_plain` (the reference's
  ``direct`` form; the JAX package's default ``fused`` tail computes the
  same taps as one depth-folded convolution, a TPU lane layout).

Inference only: the training outputs of the JAX model (the occlusion
regularisers in ``losses`` and the 0.1 gradient scale on the motion field)
come with the training slice.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from real3dportrait_tpu_torch import kernels
from real3dportrait_tpu_torch.models.img2plane_composite import ChannelAffine
from real3dportrait_tpu_torch.models.segformer import nchw, nhwc
from real3dportrait_tpu_torch.models.superresolution import resize_bilinear
from real3dportrait_tpu_torch.ops.conv3d import Conv3D, kernel_tiles, sm_count
from real3dportrait_tpu_torch.ops.grid_sample import grid_sample_3d


def _gn(c: int) -> int:
    """GroupNorm group count: at most 32 groups, dividing ``c``."""
    for g in (min(32, c), 16, 8, 4, 2, 1):
        if c % g == 0:
            return g
    return 1


def _norm(c: int, mode: str) -> nn.Module:
    """``affine``: a folded eval-time BatchNorm; ``gn``: Flax's GroupNorm
    (epsilon 1e-6, not torch's default 1e-5)."""
    if mode == "affine":
        return ChannelAffine(c)
    if mode == "gn":
        return nn.GroupNorm(_gn(c), c, eps=1e-6)
    raise ValueError(f"norm_mode must be 'affine' or 'gn', got {mode!r}")


class ConvBlock2D(nn.Module):
    """conv -> norm -> activation in ``pattern`` order ("CNA" or "NAC")."""

    conv_cls = nn.Conv2d

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 pattern: str = "CNA", lrelu: bool = False, norm_mode: str = "gn"):
        super().__init__()
        self.pattern, self.lrelu = pattern, lrelu
        self.conv = self.conv_cls(in_channels, out_channels, kernel, padding=kernel // 2)
        normed = out_channels if pattern.index("C") < pattern.index("N") else in_channels
        self.norm = _norm(normed, norm_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for op in self.pattern:
            if op == "C":
                x = self.conv(x)
            elif op == "N":
                x = self.norm(x)
            else:
                x = F.leaky_relu(x, 0.2) if self.lrelu else F.relu(x)
        return x


class ConvBlock3D(ConvBlock2D):
    conv_cls = Conv3D


class ResBlock2D(nn.Module):
    block_cls = ConvBlock2D

    def __init__(self, channels: int, norm_mode: str = "gn"):
        super().__init__()
        self.block0 = self.block_cls(channels, channels, pattern="NAC", norm_mode=norm_mode)
        self.block1 = self.block_cls(channels, channels, pattern="NAC", norm_mode=norm_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.block1(self.block0(x))


class ResBlock3D(ResBlock2D):
    block_cls = ConvBlock3D


def avg_pool_2d(x: torch.Tensor) -> torch.Tensor:
    """Halve H, W of NCHW."""
    return F.avg_pool2d(x, 2)


def avg_pool_3d_hw(x: torch.Tensor) -> torch.Tensor:
    """Halve H, W of NCDHW, keep D."""
    return F.avg_pool3d(x, (1, 2, 2))


def upsample_2d(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x of NCHW."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def upsample_3d_hw(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x of H, W of NCDHW."""
    return F.interpolate(x, scale_factor=(1, 2, 2), mode="nearest")


# ---------------------------------------------------------------------------
# keypoint / volume helpers
# ---------------------------------------------------------------------------


def _axis(n: int, device) -> torch.Tensor:
    """n points 2 i / (n - 1) - 1 in [-1, 1]."""
    return 2 * (torch.arange(n, device=device) / (n - 1)) - 1


def make_coordinate_grid_3d(d: int, h: int, w: int, device="cpu") -> torch.Tensor:
    """[-1,1]^3 grid, (x, y, z) ordering -> [D,H,W,3]."""
    zz, yy, xx = torch.meshgrid(_axis(d, device), _axis(h, device), _axis(w, device),
                                indexing="ij")
    return torch.stack([xx, yy, zz], dim=-1)


def kp2gaussian_3d(kp: torch.Tensor, d: int, h: int, w: int,
                   kp_variance: float = 0.01) -> torch.Tensor:
    """kp [B,K,3] in [-1,1] -> gaussian volumes [B,K,D,H,W], the separable
    form of exp(-|g - kp|^2 / 2v)."""
    dev = kp.device
    gz = torch.exp(-0.5 * (_axis(d, dev) - kp[..., 2:3]) ** 2 / kp_variance)
    gy = torch.exp(-0.5 * (_axis(h, dev) - kp[..., 1:2]) ** 2 / kp_variance)
    gx = torch.exp(-0.5 * (_axis(w, dev) - kp[..., 0:1]) ** 2 / kp_variance)
    return gz[:, :, :, None, None] * gy[:, :, None, :, None] * gx[:, :, None, None, :]


def create_sparse_motions(kp_s: torch.Tensor, kp_d: torch.Tensor, d: int, h: int,
                          w: int) -> torch.Tensor:
    """[B,K,3] source/driving keypoints -> [B,K+1,D,H,W,3] candidate
    back-warps: the identity grid, then grid - kp_d[k] + kp_s[k] (identity
    rotations, as the torso always uses)."""
    b = kp_s.shape[0]
    grid = make_coordinate_grid_3d(d, h, w, kp_s.device)[None, None]
    moved = grid - kp_d[:, :, None, None, None, :] + kp_s[:, :, None, None, None, :]
    return torch.cat([grid.expand(b, 1, d, h, w, 3), moved], dim=1)


def dilate_mask(mask: torch.Tensor, ksize: int = 7) -> torch.Tensor:
    """Max-pool dilation of [B,H,W,1] masks."""
    return nhwc(F.max_pool2d(nchw(mask), ksize, stride=1, padding=ksize // 2))


def torso_deform_input_plain(fs: torch.Tensor, kp_s: torch.Tensor,
                             kp_d: torch.Tensor) -> torch.Tensor:
    """fs [B,D,H,W,C] compressed volume, kp_s / kp_d [B,K,3] -> the motion
    field estimator's input [B,(K+1)*(1+C),D,H,W]: for candidate k, channel
    k*(1+C) is its heatmap (0 for the identity candidate) and the next C are
    the volume warped by its sparse motion (zero padding)."""
    b, d, h, w, c = fs.shape
    k1 = kp_s.shape[1] + 1
    heat = kp2gaussian_3d(kp_d, d, h, w) - kp2gaussian_3d(kp_s, d, h, w)
    heat = torch.cat([torch.zeros_like(heat[:, :1]), heat], dim=1)
    motions = create_sparse_motions(kp_s, kp_d, d, h, w)
    vol = fs[:, None].expand(b, k1, d, h, w, c).reshape(b * k1, d, h, w, c)
    warped = grid_sample_3d(vol, motions.reshape(b * k1, -1, 3), align_corners=True,
                            padding_mode="zeros").reshape(b, k1, d, h, w, c)
    out = torch.cat([heat[..., None], warped], dim=-1)          # [B,K+1,D,H,W,1+C]
    return out.permute(0, 1, 5, 2, 3, 4).reshape(b, k1 * (1 + c), d, h, w)


def torso_deform_input(fs: torch.Tensor, kp_s: torch.Tensor,
                       kp_d: torch.Tensor) -> torch.Tensor:
    """K5a wrapper, same contract as :func:`torso_deform_input_plain`.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes fp32 volumes of 4 channels (the estimator's compressed
    width) with D, H, W >= 2, or raise.
    """
    if fs.device.type == "cpu":
        return torso_deform_input_plain(fs, kp_s, kp_d)
    name = "torso_deform_input"
    fs, kp_s, kp_d = fs.contiguous(), kp_s.contiguous(), kp_d.contiguous()
    for arg, t in (("fs", fs), ("kp_s", kp_s), ("kp_d", kp_d)):
        kernels.require(name, arg, t)
    b, d, h, w, c = fs.shape
    k = kp_s.shape[1]
    if c != 4 or min(d, h, w) < 2 or tuple(kp_s.shape) != (b, k, 3) \
            or kp_d.shape != kp_s.shape:
        raise ValueError(f"{name}: kernel takes fs [B,D,H,W,4] (D,H,W >= 2) and "
                         f"keypoints [B,K,3]; got fs {tuple(fs.shape)}, kp_s "
                         f"{tuple(kp_s.shape)}, kp_d {tuple(kp_d.shape)}")
    out = torch.empty((b, (k + 1) * (1 + c), d, h, w), device=fs.device)
    kernels.launch("r3dp_torso_deform_input", fs, kp_s, kp_d, b, k, d, h, w, c, out)
    torso_deform_input.launches += 1
    return out


torso_deform_input.launches = 0


def torso_warp_volume_plain(fs: torch.Tensor, deformation: torch.Tensor) -> torch.Tensor:
    """fs [B,D,H,W,C], deformation [B,D,H,W,3] (x, y, z) -> the volume
    warped with border padding, folded C-major [B,C*D,H,W] (channel c*D + d)."""
    b, d, h, w, c = fs.shape
    warped = grid_sample_3d(fs, deformation.reshape(b, -1, 3), align_corners=True,
                            padding_mode="border").reshape(b, d, h, w, c)
    return warped.permute(0, 4, 1, 2, 3).reshape(b, c * d, h, w)


def torso_warp_volume(fs: torch.Tensor, deformation: torch.Tensor) -> torch.Tensor:
    """K5b wrapper, same contract as :func:`torso_warp_volume_plain`.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes fp32 volumes of 32 or 4 channels (the released and the tiny
    presets' feature widths) with D, H, W >= 2, or raise.
    """
    if fs.device.type == "cpu":
        return torso_warp_volume_plain(fs, deformation)
    name = "torso_warp_volume"
    fs, deformation = fs.contiguous(), deformation.contiguous()
    kernels.require(name, "fs", fs)
    kernels.require(name, "deformation", deformation)
    b, d, h, w, c = fs.shape
    if c not in (4, 32) or min(d, h, w) < 2 \
            or tuple(deformation.shape) != (b, d, h, w, 3):
        raise ValueError(f"{name}: kernel takes fs [B,D,H,W,4|32] (D,H,W >= 2) and "
                         f"deformation [B,D,H,W,3]; got fs {tuple(fs.shape)}, "
                         f"deformation {tuple(deformation.shape)}")
    out = torch.empty((b, c * d, h, w), device=fs.device)
    kernels.launch("r3dp_torso_warp_volume", fs, deformation, b, d, h, w, c, out)
    torso_warp_volume.launches += 1
    return out


torso_warp_volume.launches = 0


def mfe_tail_plan(b: int, c: int, h: int, w: int, tile: tuple[int, int], sms: int) -> dict:
    """The kernel's split of the ``c`` input channels into ``n_split``
    groups of ``c_per_split``, so that its pixel tiles (``tile``: rows,
    columns, from :func:`~real3dportrait_tpu_torch.ops.conv3d.kernel_tiles`)
    times the groups fill the card's ``sms`` SMs about once."""
    tiles = b * math.ceil(h / tile[0]) * math.ceil(w / tile[1])
    splits = min(c, max(1, math.ceil(sms / tiles)))
    per = math.ceil(c / splits)
    return dict(c_per_split=per, n_split=math.ceil(c / per))


def mfe_tail_plain(x: torch.Tensor, mask_w: torch.Tensor, mask_b: torch.Tensor,
                   occ_w: torch.Tensor, occ_b: torch.Tensor, kp_s: torch.Tensor,
                   kp_d: torch.Tensor):
    """The motion-field estimator's tail. x [B,C,D,H,W]; mask_w [K+1,C,7,7,7],
    mask_b [K+1]; occ_w [2,C*D,7,7], occ_b [2] (both occlusion heads);
    kp_s, kp_d [B,K,3] -> (deformation [B,D,H,W,3], occlusion [B,H,W,1],
    occlusion_2 [B,H,W,1]): the mask conv's logits, softmax over the K+1
    candidates, the deformation as the mask-weighted sum of the sparse
    motions, and both occlusion heads on the C-major depth fold (channel
    c*D + d, the reference's view(N, -1, H, W)) through a sigmoid."""
    b, _, d, h, w = x.shape
    mask = F.conv3d(x, mask_w, mask_b, padding=3)
    occ = torch.sigmoid(F.conv2d(x.reshape(b, -1, h, w), occ_w, occ_b, padding=3))
    mask = torch.softmax(mask.float(), dim=1)[..., None]   # over the K+1 candidates
    sparse = create_sparse_motions(kp_s, kp_d, d, h, w)
    deformation = (sparse * mask).sum(dim=1)
    return deformation, nhwc(occ[:, :1]), nhwc(occ[:, 1:])


def mfe_tail(x: torch.Tensor, mask_w: torch.Tensor, mask_b: torch.Tensor,
             occ_w: torch.Tensor, occ_b: torch.Tensor, kp_s: torch.Tensor,
             kp_d: torch.Tensor):
    """K7b wrapper, same contract as :func:`mfe_tail_plain`.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes fp32, K + 1 = 5 candidates and a depth of 16 (the standard
    and small presets) or 2 (tiny), or raise.
    """
    if x.device.type == "cpu":
        return mfe_tail_plain(x, mask_w, mask_b, occ_w, occ_b, kp_s, kp_d)
    name = "mfe_tail"
    args = [t.detach().contiguous() for t in (x, mask_w, mask_b, occ_w, occ_b, kp_s, kp_d)]
    for arg, t in zip(("x", "mask_w", "mask_b", "occ_w", "occ_b", "kp_s", "kp_d"), args):
        kernels.require(name, arg, t)
    x = args[0]
    b, c, d, h, w = x.shape if x.dim() == 5 else (0,) * 5
    k1 = args[1].shape[0]
    if x.dim() != 5 or k1 != 5 or d not in (2, 16) or min(h, w) < 2 \
            or tuple(args[1].shape) != (k1, c, 7, 7, 7) or tuple(args[2].shape) != (k1,) \
            or tuple(args[3].shape) != (2, c * d, 7, 7) or tuple(args[4].shape) != (2,) \
            or tuple(args[5].shape) != (b, k1 - 1, 3) or args[6].shape != args[5].shape:
        raise ValueError(f"{name}: kernel takes x [B,C,D,H,W] with D in (2, 16), H, W >= 2, "
                         f"mask_w [5,C,7,7,7], occ_w [2,C*D,7,7] and keypoints [B,4,3]; got "
                         f"{[tuple(t.shape) for t in args]}")
    plan = mfe_tail_plan(b, c, h, w, kernel_tiles()["tail_tile"], sm_count(x.device))
    partial = torch.empty((plan["n_split"], b, d * k1 + 2, h, w), device=x.device)
    deformation = torch.empty((b, d, h, w, 3), device=x.device)
    occ1, occ2 = (torch.empty((b, h, w, 1), device=x.device) for _ in range(2))
    kernels.launch("r3dp_mfe_tail", *args, b, c, d, h, w, k1, plan["c_per_split"],
                   plan["n_split"], partial, deformation, occ1, occ2)
    mfe_tail.launches += 1
    return deformation, occ1, occ2


mfe_tail.launches = 0


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------


class AppearanceFeatureExtractor(nn.Module):
    """Image [B,Cin,H,W] -> appearance volume [B,C,D,H/4,W/4] (NCDHW)."""

    def __init__(self, in_channels: int, feat_channels: int = 32, depth: int = 16,
                 down_seq: Sequence[int] = (64, 128, 256), n_res: int = 6,
                 norm_mode: str = "gn"):
        super().__init__()
        self.feat_channels, self.depth = feat_channels, depth
        self.n_down, self.n_res = len(down_seq) - 1, n_res
        self.in_conv = ConvBlock2D(in_channels, down_seq[0], kernel=7, norm_mode=norm_mode)
        for i in range(self.n_down):
            setattr(self, f"down_{i}", ConvBlock2D(down_seq[i], down_seq[i + 1],
                                                   norm_mode=norm_mode))
        self.mid_conv = nn.Conv2d(down_seq[-1], feat_channels * depth, 1)
        for i in range(n_res):
            setattr(self, f"res_{i}", ResBlock3D(feat_channels, norm_mode))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.in_conv(x)
        for i in range(self.n_down):
            x = avg_pool_2d(getattr(self, f"down_{i}")(x))
        x = self.mid_conv(x)
        b, _, h, w = x.shape
        # channel c * D + d, the reference's view(N, C, D, H, W)
        x = x.view(b, self.feat_channels, self.depth, h, w)
        for i in range(self.n_res):
            x = getattr(self, f"res_{i}")(x)
        return x


class MotionFieldEstimator(nn.Module):
    """Keypoint heatmaps + candidate warps -> dense deformation and two
    occlusion maps; v2 (``use_head_cond``) conditions the field on the
    rendered target head and its NeRF weights."""

    def __init__(self, in_channels: int, depth: int, num_keypoints: int = 4,
                 compress_channels: int = 4,
                 down_seq: Sequence[int] = (32, 64, 128, 256, 512),
                 up_seq: Sequence[int] = (512, 256, 128, 64, 32, 16),
                 norm_mode: str = "gn", use_head_cond: bool = False,
                 head_hid_dim: int = 32):
        super().__init__()
        self.num_keypoints, self.use_head_cond = num_keypoints, use_head_cond
        self.n_down, self.n_up = len(down_seq), len(up_seq) - 1
        k1 = num_keypoints + 1
        self.compress = nn.Conv3d(in_channels, compress_channels, 1)
        prev = c_inp = k1 * (1 + compress_channels)
        for i, ch in enumerate(down_seq):
            setattr(self, f"down_{i}", ConvBlock3D(prev, ch, norm_mode=norm_mode))
            prev = ch
        for i, ch in enumerate(up_seq[1:]):
            setattr(self, f"up_{i}", ConvBlock3D(prev, ch, norm_mode=norm_mode))
            prev = ch
        c_tail = c_inp + prev
        if use_head_cond:
            self.tgt_head_in_conv = ConvBlock2D(4, head_hid_dim, kernel=7, norm_mode=norm_mode)
            for i in range(3):
                setattr(self, f"tgt_head_res_{i}", ResBlock2D(head_hid_dim, norm_mode))
            self.tgt_head_fuser = Conv3D(c_tail + head_hid_dim, head_hid_dim, 7)
            c_tail = head_hid_dim
        self.mask_conv = Conv3D(c_tail, k1, 7)
        self.occlusion_conv = nn.Conv2d(c_tail * depth, 1, 7, padding=3)
        self.occlusion_conv2 = nn.Conv2d(c_tail * depth, 1, 7, padding=3)

    def forward(self, fs: torch.Tensor, kp_s: torch.Tensor, kp_d: torch.Tensor,
                tgt_head_img: torch.Tensor | None = None,
                tgt_head_weights: torch.Tensor | None = None):
        """fs [B,D,H,W,C]; kp_* [B,K,3]; the v2 head images NHWC. Returns
        (deformation [B,D,H,W,3], occlusion [B,H,W,1], occlusion_2 [B,H,W,1])."""
        b, d, h, w, _ = fs.shape
        # the 1x1x1 compress conv as a channels-last matmul: K5a reads it so
        compressed = F.linear(fs, self.compress.weight.flatten(1), self.compress.bias)
        inp = torso_deform_input(compressed, kp_s, kp_d)

        x = inp
        for i in range(self.n_down):
            x = avg_pool_3d_hw(getattr(self, f"down_{i}")(x))
        for i in range(self.n_up):
            x = getattr(self, f"up_{i}")(upsample_3d_hw(x))
        x = torch.cat([inp, x], dim=1)

        if self.use_head_cond:
            if tgt_head_img is None:
                tgt_head_img = fs.new_zeros((b, h, w, 3))
            if tgt_head_weights is None:
                tgt_head_weights = fs.new_zeros((b, h, w, 1))
            head = torch.cat([tgt_head_img, tgt_head_weights], dim=-1)
            head = nchw(resize_bilinear(head, 2 * h, antialias=False))
            head = self.tgt_head_in_conv(head)
            for i in range(3):
                head = getattr(self, f"tgt_head_res_{i}")(head)
            head = F.interpolate(head, size=(h, w), mode="bilinear", align_corners=False)
            x = torch.cat([x, head[:, :, None].expand(-1, -1, d, -1, -1)], dim=1)
            x = self.tgt_head_fuser(x)

        occ_w = torch.cat([self.occlusion_conv.weight, self.occlusion_conv2.weight])
        occ_b = torch.cat([self.occlusion_conv.bias, self.occlusion_conv2.bias])
        return mfe_tail(x, self.mask_conv.weight, self.mask_conv.bias, occ_w, occ_b,
                        kp_s, kp_d)


class WarpGenerator(nn.Module):
    """Appearance volume warped by the deformation -> torso RGB and hidden
    features at 4x the volume's H, W."""

    def __init__(self, feat_channels: int, depth: int, up_seq: Sequence[int] = (256, 128, 64),
                 n_res: int = 6, norm_mode: str = "gn"):
        super().__init__()
        self.n_res, self.n_up = n_res, len(up_seq) - 1
        self.in_conv = ConvBlock2D(feat_channels * depth, up_seq[0], lrelu=True,
                                   norm_mode=norm_mode)
        self.mid_conv = nn.Conv2d(up_seq[0], up_seq[0], 1)
        for i in range(n_res):
            setattr(self, f"res_{i}", ResBlock2D(up_seq[0], norm_mode))
        for i in range(self.n_up):
            setattr(self, f"up_{i}", ConvBlock2D(up_seq[i], up_seq[i + 1],
                                                 norm_mode=norm_mode))
        self.out_conv = nn.Conv2d(up_seq[-1], 3, 7, padding=3)

    def forward(self, fs: torch.Tensor, deformation: torch.Tensor):
        """fs [B,D,H,W,C], deformation [B,D,H,W,3] -> (rgb [B,4H,4W,3],
        hid [B,4H,4W,up_seq[-1]])."""
        x = self.mid_conv(self.in_conv(torso_warp_volume(fs, deformation)))
        for i in range(self.n_res):
            x = getattr(self, f"res_{i}")(x)
        for i in range(self.n_up):
            x = getattr(self, f"up_{i}")(upsample_2d(x))
        return nhwc(self.out_conv(x)), nhwc(x)


# architecture presets of the reference's model_scale choices, plus a tiny
# preset for tests
TORSO_PRESETS: dict[str, dict] = {
    "standard": dict(
        feat_channels=32, depth=16, app_down_seq=(64, 128, 256), app_n_res=6,
        motion_down_seq=(64, 128, 256, 512, 1024),
        motion_up_seq=(1024, 512, 256, 128, 64, 32),
        gen_up_seq=(256, 128, 64), gen_n_res=6,
    ),
    "small": dict(
        feat_channels=32, depth=16, app_down_seq=(64, 128, 256), app_n_res=6,
        motion_down_seq=(32, 64, 128, 256, 512),
        motion_up_seq=(512, 256, 128, 64, 32, 16),
        gen_up_seq=(256, 128, 64), gen_n_res=6,
    ),
    "tiny": dict(
        feat_channels=4, depth=2, app_down_seq=(8, 16), app_n_res=1,
        motion_down_seq=(8, 16), motion_up_seq=(16, 16, 8),
        gen_up_seq=(16, 8), gen_n_res=1,
    ),
}

# landmark indices (of the 68) that drive the torso
KP_SUBSETS = {4: (0, 8, 16, 27), 9: (0, 3, 6, 8, 10, 13, 16, 27, 33)}


class WarpBasedTorsoModel(nn.Module):
    """The torso branch: appearance volume (cacheable per video) -> motion
    field from the keypoints -> warped torso RGB, hidden features and the
    torso occlusion ``occlusion_2``.

    ``version`` "v2" (the released one) conditions the motion field on the
    rendered target head; ``inp_mode`` "rgb_alpha" (released) lets the
    appearance extractor also see the neck/torso segmap channels.
    """

    def __init__(self, torso_kp_num: int = 4, scale: str = "standard",
                 norm_mode: str = "gn", version: str = "v2", inp_mode: str = "rgb_alpha"):
        super().__init__()
        arch = TORSO_PRESETS[scale]
        self.version, self.inp_mode = version, inp_mode
        feat, depth = arch["feat_channels"], arch["depth"]
        self.appearance_extractor = AppearanceFeatureExtractor(
            5 if inp_mode == "rgb_alpha" else 3, feat, depth,
            down_seq=arch["app_down_seq"], n_res=arch["app_n_res"], norm_mode=norm_mode)
        self.motion_field_estimator = MotionFieldEstimator(
            feat + 2, depth, num_keypoints=torso_kp_num,
            down_seq=arch["motion_down_seq"], up_seq=arch["motion_up_seq"],
            norm_mode=norm_mode, use_head_cond=(version == "v2"))
        self.deform_based_generator = WarpGenerator(
            feat, depth, up_seq=arch["gen_up_seq"], n_res=arch["gen_n_res"],
            norm_mode=norm_mode)
        hid = arch["gen_up_seq"][-1]
        self.occ2_pred_conv0 = nn.Conv2d(hid + 1, 32, 3, padding=1)
        self.occ2_pred_conv1 = nn.Conv2d(32, 32, 3, padding=1)
        self.occ2_pred_conv2 = nn.Conv2d(32, 1, 3, padding=1)
        self.register_buffer("kp_subset", torch.tensor(KP_SUBSETS[torso_kp_num]),
                             persistent=False)

    @staticmethod
    def _torso_seg(segmap: torch.Tensor, size: int) -> torch.Tensor:
        """Neck (2) and torso (4) channels of the [B,H,W,6] segmap at ``size``."""
        return resize_bilinear(segmap[..., [2, 4]], size, antialias=False)

    def appearance(self, torso_src_img: torch.Tensor, segmap: torch.Tensor) -> torch.Tensor:
        """Source torso image [B,H,W,3] + segmap [B,H',W',6] -> the masked
        appearance volume [B,D,H/4,W/4,C]. It depends on the source only:
        compute it once per video (and again whenever the source torso image
        or its segmap changes) and pass it back as ``appearance_volume``."""
        x = torso_src_img
        if self.inp_mode == "rgb_alpha":
            x = torch.cat([x, self._torso_seg(segmap, x.shape[1])], dim=-1)
        feats = self.appearance_extractor(nchw(x))                 # [B,C,D,h,w]
        mask = dilate_mask(self._torso_seg(segmap, feats.shape[-1]).sum(-1, keepdim=True))
        feats = feats * nchw(mask)[:, :, None]
        return feats.permute(0, 2, 3, 4, 1).contiguous()

    def forward(self, torso_src_img: torch.Tensor, segmap: torch.Tensor, kp_s: torch.Tensor,
                kp_d: torch.Tensor, tgt_head_img: torch.Tensor | None = None,
                tgt_head_weights: torch.Tensor | None = None,
                appearance_volume: torch.Tensor | None = None,
                appearance_only: bool = False) -> dict:
        """kp_s, kp_d [B,68,3]; the v2 head render and weights NHWC.
        Returns deformed_torso_img [B,4h,4w,3], deformed_torso_hid,
        occlusion [B,h,w,1], occlusion_2 [B,4h,4w,1], kp_src, kp_drv (the
        keypoint subset); with ``appearance_only`` just the volume."""
        if appearance_volume is None:
            appearance_volume = self.appearance(torso_src_img, segmap)
        if appearance_only:
            return {"appearance_volume": appearance_volume}
        feats = appearance_volume
        b, d, h, w, _ = feats.shape
        seg_vol = self._torso_seg(segmap, h)[:, None].expand(b, d, h, w, 2)
        motion_inp = torch.cat([feats, seg_vol], dim=-1)
        kps, kpd = kp_s[:, self.kp_subset], kp_d[:, self.kp_subset]
        head = {}
        if self.version == "v2":
            head = dict(tgt_head_img=tgt_head_img, tgt_head_weights=tgt_head_weights)
        deformation, occlusion, occlusion_2 = self.motion_field_estimator(
            motion_inp, kps, kpd, **head)
        rgb, hid = self.deform_based_generator(feats, deformation)
        occ2_up = resize_bilinear(occlusion_2, hid.shape[1], antialias=False)
        x = torch.cat([nchw(hid), nchw(occ2_up)], dim=1)
        x = F.relu(self.occ2_pred_conv0(x))
        x = F.relu(self.occ2_pred_conv1(x))
        occ2 = torch.sigmoid(self.occ2_pred_conv2(x))
        return {
            "deformed_torso_img": rgb,
            "deformed_torso_hid": hid,
            "occlusion": occlusion,
            "occlusion_2": nhwc(occ2),
            "kp_src": kps,
            "kp_drv": kpd,
        }

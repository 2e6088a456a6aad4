"""Keypoint-driven warp-based torso model and kernels K5a, K5b, K7b (port of
``real3dportrait_tpu/models/torso.py``).

Components: :class:`AppearanceFeatureExtractor` (2D conv pyramid -> 3D
appearance volume), :class:`MotionFieldEstimator` (keypoint heatmaps and K+1
candidate warps -> dense deformation and two occlusion maps),
:class:`WarpGenerator` (warped volume -> torso RGB and hidden features) and
the :class:`WarpBasedTorsoModel` wrapper, driven by a subset of the 68
landmarks, and the torso stage's :class:`PatchDiscriminator`. Parameter
names follow the JAX tree. Convolutions run NCDHW / NCHW inside; public
tensors keep the JAX layouts (volumes [B,D,H,W,C], images NHWC, keypoints
[B,K,3]).

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

On CUDA tensors each of the three wrappers is a ``torch.autograd.Function``
(under ``no_grad`` too) whose backward is a kernel with its plain version
beside it: :func:`torso_deform_input_backward` and
:func:`torso_warp_volume_backward` (``csrc/torso_warp.cu``: two scatters
with 16 B atomics over whole lines, K5a's summing the terms of neighbouring
voxels that share a corner first), and :func:`mfe_tail_backward`
(``csrc/conv3d.cu``: the tail's whole data gradient in one kernel, the mask
conv's weight gradient through K7a's weight-gradient kernel). The model's
training outputs follow the JAX model's: the 0.1 gradient scale on the
motion field, the detached head conditioning and the occlusion regularisers
in ``losses``.
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
from real3dportrait_tpu_torch.ops.conv3d import (
    Conv3D,
    conv3d_weight_grad,
    kernel_tiles,
    sm_count,
)
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
                 pattern: str = "CNA", lrelu: bool = False, norm_mode: str = "gn",
                 stride: int = 1):
        super().__init__()
        self.pattern, self.lrelu = pattern, lrelu
        self.conv = self.conv_cls(in_channels, out_channels, kernel, padding=kernel // 2,
                                  **({"stride": stride} if stride != 1 else {}))
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


def make_coordinate_grid_2d(h: int, w: int, device="cpu") -> torch.Tensor:
    """[-1,1]^2 grid, (x, y) ordering -> [H,W,2]."""
    yy, xx = torch.meshgrid(_axis(h, device), _axis(w, device), indexing="ij")
    return torch.stack([xx, yy], dim=-1)


def kp2gaussian_2d(kp: torch.Tensor, h: int, w: int, kp_variance: float = 0.01
                   ) -> torch.Tensor:
    """kp [B,K,2] (x, y) in [-1,1] -> gaussian heatmaps [B,K,H,W],
    exp(-|g - kp|^2 / 2v)."""
    diff = make_coordinate_grid_2d(h, w, kp.device)[None, None] - kp[:, :, None, None, :]
    return torch.exp(-0.5 * diff.square().sum(dim=-1) / kp_variance)


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


def torso_deform_plan(b: int, k: int, d: int, h: int, w: int) -> dict:
    """K5a's launch: CTAs of ``tile_w`` = 64 voxels along w (two warps a
    candidate) by ``cand`` = min(k + 1, 8) candidates (a thread loops over
    the rest), each over ``rows`` = 4 rows h of one (b, d), the last row
    group and tile ragged; ``grid`` is (w tiles, row groups, b * d). At
    [1,16,64,64] with k = 4 that is 256 CTAs of 320 threads, two an SM at
    the kernel's registers: one wave, each thread's x gaussians reused over
    4 rows (1, 2, 3, 5 and 8 rows ran slower on an H100, PERF.md)."""
    rows = 4
    return dict(tile_w=64, rows=rows, cand=min(k + 1, 8),
                grid=(math.ceil(w / 64), math.ceil(h / rows), b * d))


def _trilinear_adjoint(vol_shape: tuple, coords: torch.Tensor, gout: torch.Tensor,
                       border: bool, vol: torch.Tensor | None = None) -> tuple:
    """The adjoint of ``grid_sample_3d(vol, coords, align_corners=True)``,
    written out: vol_shape (B,D,H,W,C), coords [B,N,3] (x, y, z), the
    samples' gradient gout [B,N,C] -> (d vol [B,D,H,W,C], d coords [B,N,3]
    where ``vol`` is given, else None). ``border``: border padding (the
    coordinate clamped first; its gradient 0 on a clamped axis, at the bound
    too, torch's rule), else zero padding (a corner outside adds nothing)."""
    b, d, h, w, c = vol_shape
    sizes = (w, h, d)
    raw = [(coords[..., i] + 1) / 2 * (sizes[i] - 1) for i in range(3)]
    pos = [r.clamp(0, n - 1) for r, n in zip(raw, sizes)] if border else raw
    fl = [p.floor() for p in pos]
    lerp = [((f + 1) - p, p - f) for p, f in zip(pos, fl)]
    flat_vol = None if vol is None else vol.reshape(b, -1, c)
    dvol = torch.zeros((b, d * h * w, c), dtype=gout.dtype, device=gout.device)
    dcoord = [torch.zeros_like(raw[0]) for _ in range(3)]
    for corner in range(8):
        cs = (corner & 1, (corner >> 1) & 1, corner >> 2)
        ix = [f + k for f, k in zip(fl, cs)]
        ok = torch.ones_like(raw[0], dtype=torch.bool)
        for i, n in zip(ix, sizes):
            ok = ok & (i >= 0) & (i <= n - 1)
        wts = [lerp[a][cs[a]] for a in range(3)]
        flat = ((ix[2].clamp(0, d - 1) * h + ix[1].clamp(0, h - 1)) * w
                + ix[0].clamp(0, w - 1)).long()
        wgt = torch.where(ok, wts[0] * wts[1] * wts[2], torch.zeros_like(wts[0]))
        dvol.scatter_add_(1, flat[..., None].expand(-1, -1, c), gout * wgt[..., None])
        if flat_vol is not None:
            v = torch.gather(flat_vol, 1, flat[..., None].expand(-1, -1, c))
            dot = torch.where(ok, (gout * v).sum(-1), torch.zeros_like(wgt))
            for a in range(3):
                term = dot * (1.0 if cs[a] else -1.0)
                for o in range(3):
                    if o != a:
                        term = term * wts[o]
                dcoord[a] = dcoord[a] + term
    dcoords = None
    if vol is not None:
        mult = [torch.where((r > 0) & (r < n - 1), torch.full_like(r, (n - 1) / 2),
                            torch.zeros_like(r)) if border else torch.full_like(r, (n - 1) / 2)
                for r, n in zip(raw, sizes)]
        dcoords = torch.stack([g * m for g, m in zip(dcoord, mult)], dim=-1)
    return dvol.reshape(vol_shape), dcoords


def torso_deform_input_backward_plain(dout: torch.Tensor, kp_s: torch.Tensor,
                                      kp_d: torch.Tensor, vol_shape: tuple) -> torch.Tensor:
    """The gradient of :func:`torso_deform_input_plain`'s volume ``fs`` of
    shape ``vol_shape`` (B,D,H,W,C) from the output's gradient ``dout``
    [B,(K+1)*(1+C),D,H,W]: the warped channels' gradients scattered back
    through each candidate's zero-padded trilinear warp (the heatmaps do not
    depend on ``fs``; the keypoints are data)."""
    b, d, h, w, c = vol_shape
    k1 = kp_s.shape[1] + 1
    motions = create_sparse_motions(kp_s, kp_d, d, h, w).reshape(b, -1, 3)
    gout = dout.reshape(b, k1, 1 + c, d, h, w)[:, :, 1:].permute(0, 1, 3, 4, 5, 2)
    return _trilinear_adjoint(vol_shape, motions, gout.reshape(b, -1, c), border=False)[0]


def torso_deform_input_backward(dout: torch.Tensor, kp_s: torch.Tensor, kp_d: torch.Tensor,
                                vol_shape: tuple) -> torch.Tensor:
    """K5a's adjoint wrapper, same contract as
    :func:`torso_deform_input_backward_plain`. CPU tensors take the plain
    version; CUDA tensors launch the kernel (fp32, C = 4) or raise.
    ``torso_deform_input_backward.launches`` counts its launches."""
    if dout.device.type == "cpu":
        return torso_deform_input_backward_plain(dout, kp_s, kp_d, vol_shape)
    name = "torso_deform_input_backward"
    dout, kp_s, kp_d = dout.contiguous(), kp_s.contiguous(), kp_d.contiguous()
    for arg, t in (("dout", dout), ("kp_s", kp_s), ("kp_d", kp_d)):
        kernels.require(name, arg, t)
    b, d, h, w, c = vol_shape
    k = kp_s.shape[1]
    if c != 4 or min(d, h, w) < 2 or tuple(dout.shape) != (b, (k + 1) * (1 + c), d, h, w) \
            or tuple(kp_s.shape) != (b, k, 3) or kp_d.shape != kp_s.shape \
            or b * d > 65535 or d * h * w * c >= 2 ** 31:
        raise ValueError(f"{name}: kernel takes dout [B,(K+1)*5,D,H,W] of a volume "
                         f"[B,D,H,W,4] (D,H,W >= 2, B*D <= 65535) and keypoints [B,K,3]; got "
                         f"dout {tuple(dout.shape)}, volume {tuple(vol_shape)}, kp_s "
                         f"{tuple(kp_s.shape)}")
    dvol = torch.zeros(vol_shape, device=dout.device)
    kernels.launch("r3dp_torso_deform_input_backward", dout, kp_s, kp_d, b, k, d, h, w, c, dvol)
    torso_deform_input_backward.launches += 1
    return dvol


torso_deform_input_backward.launches = 0


def _no_keypoint_grad(name: str, *kps: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in kps):
        raise ValueError(f"{name}: keypoints that need a gradient are not supported (the "
                         "torso's keypoints are data)")


class _TorsoDeformInput(torch.autograd.Function):
    """K5a forward; backward: its trilinear adjoint into the volume."""

    @staticmethod
    def forward(ctx, fs, kp_s, kp_d):
        ctx.save_for_backward(kp_s, kp_d)
        ctx.vol_shape = tuple(fs.shape)
        b, d, h, w, c = fs.shape
        k = kp_s.shape[1]
        plan = torso_deform_plan(b, k, d, h, w)
        out = torch.empty((b, (k + 1) * (1 + c), d, h, w), device=fs.device)
        kernels.launch("r3dp_torso_deform_input", fs, kp_s, kp_d, b, k, d, h, w, c,
                       plan["rows"], plan["cand"], out)
        torso_deform_input.launches += 1
        return out

    @staticmethod
    def backward(ctx, dout):
        kp_s, kp_d = ctx.saved_tensors
        return torso_deform_input_backward(dout, kp_s, kp_d, ctx.vol_shape), None, None


def torso_deform_input(fs: torch.Tensor, kp_s: torch.Tensor,
                       kp_d: torch.Tensor) -> torch.Tensor:
    """K5a wrapper, same contract as :func:`torso_deform_input_plain`.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (:func:`torso_deform_plan`), which takes fp32 volumes of 4 channels (the
    estimator's compressed width) with D, H, W >= 2, or raise. The call is a
    ``torch.autograd.Function`` whose backward is
    :func:`torso_deform_input_backward`; keypoints that need a gradient
    raise.
    """
    if fs.device.type == "cpu":
        return torso_deform_input_plain(fs, kp_s, kp_d)
    name = "torso_deform_input"
    fs, kp_s, kp_d = fs.contiguous(), kp_s.contiguous(), kp_d.contiguous()
    for arg, t in (("fs", fs), ("kp_s", kp_s), ("kp_d", kp_d)):
        kernels.require(name, arg, t)
    _no_keypoint_grad(name, kp_s, kp_d)
    b, d, h, w, c = fs.shape
    k = kp_s.shape[1]
    plan = torso_deform_plan(b, k, d, h, w)
    if c != 4 or min(d, h, w) < 2 or tuple(kp_s.shape) != (b, k, 3) \
            or kp_d.shape != kp_s.shape or max(plan["grid"][1:]) > 65535 \
            or d * h * w * c >= 2 ** 31:
        raise ValueError(f"{name}: kernel takes fs [B,D,H,W,4] (D,H,W >= 2, B*D <= 65535) "
                         f"and keypoints [B,K,3]; got fs {tuple(fs.shape)}, kp_s "
                         f"{tuple(kp_s.shape)}, kp_d {tuple(kp_d.shape)}")
    return _TorsoDeformInput.apply(fs, kp_s, kp_d)


torso_deform_input.launches = 0


def torso_warp_volume_plain(fs: torch.Tensor, deformation: torch.Tensor) -> torch.Tensor:
    """fs [B,D,H,W,C], deformation [B,D,H,W,3] (x, y, z) -> the volume
    warped with border padding, folded C-major [B,C*D,H,W] (channel c*D + d)."""
    b, d, h, w, c = fs.shape
    warped = grid_sample_3d(fs, deformation.reshape(b, -1, 3), align_corners=True,
                            padding_mode="border").reshape(b, d, h, w, c)
    return warped.permute(0, 4, 1, 2, 3).reshape(b, c * d, h, w)


def torso_warp_volume_backward_plain(fs: torch.Tensor, deformation: torch.Tensor,
                                     dout: torch.Tensor) -> tuple:
    """The gradients of :func:`torso_warp_volume_plain` from the output's
    gradient ``dout`` [B,C*D,H,W]: (d fs [B,D,H,W,C], d deformation
    [B,D,H,W,3]), the border-padded trilinear adjoint written out."""
    b, d, h, w, c = fs.shape
    gout = dout.reshape(b, c, d, h, w).permute(0, 2, 3, 4, 1).reshape(b, -1, c)
    dfs, dgrid = _trilinear_adjoint(tuple(fs.shape), deformation.reshape(b, -1, 3), gout,
                                    border=True, vol=fs)
    return dfs, dgrid.reshape(deformation.shape)


def torso_warp_volume_backward(fs: torch.Tensor, deformation: torch.Tensor,
                               dout: torch.Tensor) -> tuple:
    """K5b's adjoint wrapper, same contract as
    :func:`torso_warp_volume_backward_plain`. CPU tensors take the plain
    version; CUDA tensors launch the kernel (fp32, C = 32 or 4) or raise.
    ``torso_warp_volume_backward.launches`` counts its launches."""
    if fs.device.type == "cpu":
        return torso_warp_volume_backward_plain(fs, deformation, dout)
    name = "torso_warp_volume_backward"
    fs, deformation, dout = fs.contiguous(), deformation.contiguous(), dout.contiguous()
    for arg, t in (("fs", fs), ("deformation", deformation), ("dout", dout)):
        kernels.require(name, arg, t)
    b, d, h, w, c = fs.shape
    if c not in (4, 32) or min(d, h, w) < 2 or tuple(deformation.shape) != (b, d, h, w, 3) \
            or tuple(dout.shape) != (b, c * d, h, w) or max(b * d, h) > 65535 \
            or d * h * w * c >= 2 ** 31:
        raise ValueError(f"{name}: kernel takes fs [B,D,H,W,4|32] (D,H,W >= 2, B*D and H <= "
                         f"65535), deformation [B,D,H,W,3] and dout [B,C*D,H,W]; got "
                         f"{tuple(fs.shape)}, {tuple(deformation.shape)}, {tuple(dout.shape)}")
    dfs = torch.zeros_like(fs)
    dgrid = torch.empty_like(deformation)
    kernels.launch("r3dp_torso_warp_volume_backward", fs, deformation, dout, b, d, h, w, c,
                   dfs, dgrid)
    torso_warp_volume_backward.launches += 1
    return dfs, dgrid


torso_warp_volume_backward.launches = 0


class _TorsoWarpVolume(torch.autograd.Function):
    """K5b forward; backward: its trilinear adjoint into the volume and the
    deformation."""

    @staticmethod
    def forward(ctx, fs, deformation):
        ctx.save_for_backward(fs, deformation)
        b, d, h, w, c = fs.shape
        out = torch.empty((b, c * d, h, w), device=fs.device)
        kernels.launch("r3dp_torso_warp_volume", fs, deformation, b, d, h, w, c, out)
        torso_warp_volume.launches += 1
        return out

    @staticmethod
    def backward(ctx, dout):
        fs, deformation = ctx.saved_tensors
        dfs, dgrid = torso_warp_volume_backward(fs, deformation, dout)
        return (dfs if ctx.needs_input_grad[0] else None,
                dgrid if ctx.needs_input_grad[1] else None)


def torso_warp_volume(fs: torch.Tensor, deformation: torch.Tensor) -> torch.Tensor:
    """K5b wrapper, same contract as :func:`torso_warp_volume_plain`.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes fp32 volumes of 32 or 4 channels (the released and the tiny
    presets' feature widths) with D, H, W >= 2, or raise. The call is a
    ``torch.autograd.Function`` whose backward is
    :func:`torso_warp_volume_backward`.
    """
    if fs.device.type == "cpu":
        return torso_warp_volume_plain(fs, deformation)
    name = "torso_warp_volume"
    fs, deformation = fs.contiguous(), deformation.contiguous()
    kernels.require(name, "fs", fs)
    kernels.require(name, "deformation", deformation)
    b, d, h, w, c = fs.shape
    if c not in (4, 32) or min(d, h, w) < 2 \
            or tuple(deformation.shape) != (b, d, h, w, 3) or max(b * d, h) > 65535 \
            or d * h * w * c >= 2 ** 31:
        raise ValueError(f"{name}: kernel takes fs [B,D,H,W,4|32] (D,H,W >= 2, B*D and H "
                         f"<= 65535) and deformation [B,D,H,W,3]; got fs {tuple(fs.shape)}, "
                         f"deformation {tuple(deformation.shape)}")
    return _TorsoWarpVolume.apply(fs, deformation)


torso_warp_volume.launches = 0


def mfe_tail_plan(b: int, c: int, d: int, h: int, w: int, tiles: dict, sms: int) -> dict:
    """The kernel's launch for ``tiles`` (from
    :func:`~real3dportrait_tpu_torch.ops.conv3d.kernel_tiles`) on ``sms``
    SMs: ``tile`` (pixel rows, columns of a CTA at depth ``d``), ``n_tiles``
    (over the batch), and the split of the ``c`` input channels into
    ``n_split`` ranges of ``c_per_split`` (the last may be shorter, none is
    empty), so that the grid of ``(n_tiles, n_split)`` CTAs fills the card's
    ``tail_ctas_per_sm`` CTAs an SM about once."""
    th, tw = tiles["tail_tiles"][d]
    n_tiles = b * math.ceil(h / th) * math.ceil(w / tw)
    splits = min(c, max(1, math.ceil(tiles["tail_ctas_per_sm"] * sms / n_tiles)))
    per = math.ceil(c / splits)
    return dict(tile=(th, tw), n_tiles=n_tiles, c_per_split=per, n_split=math.ceil(c / per))


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
    # over the K+1 candidates, in fp32 at least
    mask = torch.softmax(mask if mask.dtype == torch.float64 else mask.float(), dim=1)[..., None]
    sparse = create_sparse_motions(kp_s, kp_d, d, h, w)
    deformation = (sparse * mask).sum(dim=1)
    return deformation, nhwc(occ[:, :1]), nhwc(occ[:, 1:])


def mfe_tail_backward_plain(x: torch.Tensor, mask_w: torch.Tensor, occ_w: torch.Tensor,
                            kp_s: torch.Tensor, kp_d: torch.Tensor, mask: torch.Tensor,
                            occ1: torch.Tensor, occ2: torch.Tensor,
                            ddef: torch.Tensor | None, docc1: torch.Tensor | None,
                            docc2: torch.Tensor | None) -> tuple:
    """The gradients of :func:`mfe_tail_plain` written out: x [B,C,D,H,W],
    mask_w [K+1,C,7,7,7], occ_w [2,C*D,7,7], the keypoints, the forward's
    softmax ``mask`` [B,K+1,D,H,W] and occlusions [B,H,W,1], and the
    gradients of the deformation and both occlusions (None for zero) ->
    (d x, d mask_w, d mask_b, d occ_w, d occ_b): the softmax adjoint
    against the sparse motions, the sigmoid adjoints, and the convolutions'
    data and weight gradients (``torch.nn.grad``)."""
    b, c, d, h, w = x.shape
    zero = torch.zeros_like(occ1)
    ddef = torch.zeros((b, d, h, w, 3), dtype=x.dtype, device=x.device) if ddef is None \
        else ddef
    sparse = create_sparse_motions(kp_s, kp_d, d, h, w)
    g = (sparse * ddef[:, None]).sum(-1)
    dlog = mask * (g - (mask * g).sum(1, keepdim=True))
    dpre = torch.cat([nchw((zero if t is None else t) * o * (1 - o))
                      for t, o in ((docc1, occ1), (docc2, occ2))], dim=1)
    fold = x.reshape(b, c * d, h, w)
    dx = torch.nn.grad.conv3d_input(x.shape, mask_w, dlog, padding=3) \
        + torch.nn.grad.conv2d_input(fold.shape, occ_w, dpre, padding=3).reshape(x.shape)
    return (dx, torch.nn.grad.conv3d_weight(x, mask_w.shape, dlog, padding=3),
            dlog.sum(dim=(0, 2, 3, 4)),
            torch.nn.grad.conv2d_weight(fold, occ_w.shape, dpre, padding=3),
            dpre.sum(dim=(0, 2, 3)))


# tail_dgrad_kernel's packing (csrc/conv3d.cu): output channels of a channel
# block, k-steps of 8 (k, tap) slots of a depth tap of the mask conv (5 x 49
# pairs) and of the occlusion heads at a depth (2 x 49), float4s a k-step
TAIL_N = 32
TAIL_MASK_KS = 31
TAIL_OCC_KS = 13
# occ_wgrad_kernel: fold channels a CTA, pixel rows and columns of a unit
TAIL_OCC_CD, TAIL_OCC_ROWS, TAIL_OCC_TW = 32, 4, 64


def mfe_tail_backward_layout(c: int, d: int, b: int, h: int, w: int, sms: int) -> dict:
    """The host side of K7b's backward kernels for x [b,c,d,h,w] on ``sms``
    SMs: ``n_cb`` channel blocks of ``TAIL_N``; ``pack_floats``, the floats of
    both convolutions' weights packed in mma fragment order (a channel
    block: 7 depth taps of ``TAIL_MASK_KS`` k-steps, then ``d`` depths of
    ``TAIL_OCC_KS``; 4 n8 tiles x 32 lanes x a float4 a k-step); ``units``,
    the heads' weight gradient's pixel units (``TAIL_OCC_ROWS`` rows x
    ``TAIL_OCC_TW`` columns of one b), and ``n_split``, the CTAs that share
    them for each ``TAIL_OCC_CD`` fold channels: at most two CTAs an SM (the
    kernel's shared memory holds two), so that they run in one wave, and at
    least two units a CTA."""
    n_cb = math.ceil(c / TAIL_N)
    units = b * math.ceil(h / TAIL_OCC_ROWS) * math.ceil(w / TAIL_OCC_TW)
    n_cd = math.ceil(c * d / TAIL_OCC_CD)
    n_split = max(1, min(2 * sms // n_cd, math.ceil(units / 2), 65535))
    return dict(n_cb=n_cb, pack_floats=4 * n_cb * (7 * TAIL_MASK_KS + d * TAIL_OCC_KS) * 128,
                units=units, n_split=n_split)


def mfe_tail_backward_steps(x: torch.Tensor, mask_w: torch.Tensor, occ_w: torch.Tensor,
                            kp_s: torch.Tensor, kp_d: torch.Tensor, mask: torch.Tensor,
                            occ1: torch.Tensor, occ2: torch.Tensor, ddef: torch.Tensor | None,
                            docc1: torch.Tensor | None, docc2: torch.Tensor | None
                            ) -> tuple[list, dict]:
    """The launches of :func:`mfe_tail_backward` on CUDA tensors, checked,
    each a call of its own in the order the wrapper runs them, and the
    tensors they fill (``dx``, ``dmask_w``, ``dmask_b``, ``docc_w``,
    ``docc_b``): the adjoint (with the weights packed for the data
    gradient), the tail's whole data gradient, the mask conv's weight
    gradient (:func:`conv3d_weight_grad`), the occlusion heads' weight
    gradient. A timing tool can run each alone after the ones before it."""
    name = "mfe_tail_backward"
    x, mask_w, occ_w, kp_s, kp_d, mask, occ1, occ2 = (
        t.contiguous() for t in (x, mask_w, occ_w, kp_s, kp_d, mask, occ1, occ2))
    grads = [None if t is None else t.contiguous() for t in (ddef, docc1, docc2)]
    for arg, t in zip(("x", "mask_w", "occ_w", "kp_s", "kp_d", "mask", "occ1", "occ2", "ddef",
                       "docc1", "docc2"), (x, mask_w, occ_w, kp_s, kp_d, mask, occ1, occ2,
                                           *grads)):
        if t is not None:
            kernels.require(name, arg, t)
    b, c, d, h, w = x.shape
    k1 = mask_w.shape[0]
    shapes = [(b, d, h, w, 3), (b, h, w, 1), (b, h, w, 1)]
    if k1 != 5 or min(d, h, w) < 2 or w > 256 or tuple(mask.shape) != (b, k1, d, h, w) \
            or tuple(occ_w.shape) != (2, c * d, 7, 7) or tuple(occ1.shape) != (b, h, w, 1) \
            or occ2.shape != occ1.shape or tuple(kp_s.shape) != (b, k1 - 1, 3) \
            or kp_d.shape != kp_s.shape \
            or any(t is not None and tuple(t.shape) != s for t, s in zip(grads, shapes)):
        raise ValueError(f"{name}: kernel takes x [B,C,D,H,W] (D,H,W >= 2, W <= 256), "
                         f"mask_w [5,C,7,7,7], occ_w [2,C*D,7,7], mask [B,5,D,H,W], "
                         f"occlusions [B,H,W,1] and their gradients; got x {tuple(x.shape)}, "
                         f"mask {tuple(mask.shape)}, occ_w {tuple(occ_w.shape)}, gradients "
                         f"{[None if t is None else tuple(t.shape) for t in grads]}")
    if grads[0] is None:
        grads[0] = torch.zeros((b, d, h, w, 3), device=x.device)
    lay = mfe_tail_backward_layout(c, d, b, h, w, sm_count(x.device))
    dlogits = torch.empty((b, k1, d, h, w), device=x.device)
    dpre = torch.empty((b, 2, h, w), device=x.device)
    packed = torch.empty((lay["pack_floats"],), device=x.device)
    out = dict(dx=torch.empty_like(x), docc_w=torch.empty_like(occ_w),
               docc_b=torch.empty((2,), device=x.device))

    def adjoint():
        kernels.launch("r3dp_mfe_tail_backward_adjoint", grads[0], grads[1], grads[2], mask,
                       occ1, occ2, kp_s, kp_d, mask_w, occ_w, b, c, d, h, w, dlogits, dpre,
                       packed)

    def data():
        kernels.launch("r3dp_mfe_tail_backward_data", dlogits, dpre, packed, b, c, d, h, w,
                       out["dx"])

    def weight():
        out["dmask_w"], out["dmask_b"] = conv3d_weight_grad(x, dlogits, 7)

    def occlusion():
        out["docc_w"].zero_()
        out["docc_b"].zero_()
        kernels.launch("r3dp_mfe_tail_backward_occ", x, dpre, b, c * d, h, w, lay["n_split"],
                       out["docc_w"], out["docc_b"])
    return [("adjoint and weight packing", adjoint), ("data gradient", data),
            ("mask conv weight gradient", weight),
            ("occlusion heads' weight gradient", occlusion)], out


def mfe_tail_backward(x: torch.Tensor, mask_w: torch.Tensor, occ_w: torch.Tensor,
                      kp_s: torch.Tensor, kp_d: torch.Tensor, mask: torch.Tensor,
                      occ1: torch.Tensor, occ2: torch.Tensor, ddef: torch.Tensor | None,
                      docc1: torch.Tensor | None, docc2: torch.Tensor | None) -> tuple:
    """K7b's backward wrapper, same contract as
    :func:`mfe_tail_backward_plain`. CPU tensors take the plain version;
    CUDA tensors launch the kernels (fp32, K + 1 = 5, W <= 256): the softmax
    and sigmoid adjoints, then the tail's whole data gradient (the mask
    conv's and both occlusion heads'), the mask conv's weight gradient
    through :func:`conv3d_weight_grad` and the heads' weight gradient
    (:func:`mfe_tail_backward_steps`); or raise.
    ``mfe_tail_backward.launches`` counts its calls (the weight-gradient
    launches count on their own wrapper)."""
    if x.device.type == "cpu":
        return mfe_tail_backward_plain(x, mask_w, occ_w, kp_s, kp_d, mask, occ1, occ2, ddef,
                                       docc1, docc2)
    steps, out = mfe_tail_backward_steps(x, mask_w, occ_w, kp_s, kp_d, mask, occ1, occ2, ddef,
                                         docc1, docc2)
    for _, step in steps:
        step()
    mfe_tail_backward.launches += 1
    return out["dx"], out["dmask_w"], out["dmask_b"], out["docc_w"], out["docc_b"]


mfe_tail_backward.launches = 0


class _MfeTail(torch.autograd.Function):
    """K7b forward (with its softmax kept where ``keep`` asks for the
    backward); backward: :func:`mfe_tail_backward`."""

    @staticmethod
    def forward(ctx, x, mask_w, mask_b, occ_w, occ_b, kp_s, kp_d, keep):
        b, c, d, h, w = x.shape
        k1 = mask_w.shape[0]
        tiles = kernel_tiles()
        plan = mfe_tail_plan(b, c, d, h, w, tiles, sm_count(x.device))
        partial = torch.empty((plan["n_split"], b, d * k1 + 2 * tiles["tail_groups"][d], h, w),
                              device=x.device)
        deformation = torch.empty((b, d, h, w, 3), device=x.device)
        occ1, occ2 = (torch.empty((b, h, w, 1), device=x.device) for _ in range(2))
        mask = torch.empty((b, k1, d, h, w), device=x.device) if keep else None
        kernels.launch("r3dp_mfe_tail", x, mask_w, mask_b, occ_w, occ_b, kp_s, kp_d, b, c, d,
                       h, w, k1, plan["c_per_split"], plan["n_split"], partial, deformation,
                       occ1, occ2, mask)
        mfe_tail.launches += 1
        if keep:
            ctx.save_for_backward(x, mask_w, occ_w, kp_s, kp_d, mask, occ1, occ2)
        return deformation, occ1, occ2

    @staticmethod
    def backward(ctx, ddef, docc1, docc2):
        grads = mfe_tail_backward(*ctx.saved_tensors, ddef, docc1, docc2)
        return (*grads, None, None, None)


def mfe_tail(x: torch.Tensor, mask_w: torch.Tensor, mask_b: torch.Tensor,
             occ_w: torch.Tensor, occ_b: torch.Tensor, kp_s: torch.Tensor,
             kp_d: torch.Tensor):
    """K7b wrapper, same contract as :func:`mfe_tail_plain`.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes fp32, K + 1 = 5 candidates and a depth of 16 (the standard
    and small presets) or 2 (tiny), or raise. The input channels are split
    over CTAs (:func:`mfe_tail_plan`) that write partial sums; a second
    launch adds them in split order, so two calls are bit-equal. The call is
    a ``torch.autograd.Function`` whose backward is
    :func:`mfe_tail_backward`; where a gradient is wanted the second launch
    also keeps the softmax. Keypoints that need a gradient raise.
    """
    if x.device.type == "cpu":
        return mfe_tail_plain(x, mask_w, mask_b, occ_w, occ_b, kp_s, kp_d)
    name = "mfe_tail"
    args = [t.contiguous() for t in (x, mask_w, mask_b, occ_w, occ_b, kp_s, kp_d)]
    for arg, t in zip(("x", "mask_w", "mask_b", "occ_w", "occ_b", "kp_s", "kp_d"), args):
        kernels.require(name, arg, t)
    _no_keypoint_grad(name, args[5], args[6])
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
    keep = torch.is_grad_enabled() and any(t.requires_grad for t in args[:5])
    return _MfeTail.apply(*args, keep)


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


class PatchDiscriminator(nn.Module):
    """Patch discriminator over the image and its keypoints' gaussian
    heatmaps (``kp2gaussian_2d`` of the keypoints' (x, y), no gradient to
    them): ``ConvBlock2D_0`` .. ``ConvBlock2D_{n-1}`` (lrelu, stride 2 but
    the last), then a 1-channel conv + norm, ``ConvBlock2D_n``; GroupNorms.
    img [B,H,W,3] (NHWC), kp [B,K,2 or 3] -> (logits [B,h,w,1], the blocks'
    features, NHWC)."""

    def __init__(self, down_seq: Sequence[int] = (64, 128, 256, 512), num_keypoints: int = 4):
        super().__init__()
        self.n = len(down_seq)
        chans = [3 + num_keypoints] + list(down_seq)      # RGB and the heatmaps
        for i in range(self.n):
            setattr(self, f"ConvBlock2D_{i}", ConvBlock2D(
                chans[i], chans[i + 1], lrelu=True, stride=2 if i < self.n - 1 else 1))
        setattr(self, f"ConvBlock2D_{self.n}", ConvBlock2D(chans[-1], 1, pattern="CN"))

    def forward(self, img: torch.Tensor, kp: torch.Tensor):
        heat = kp2gaussian_2d(kp[..., :2].detach(), img.shape[1], img.shape[2])
        x = torch.cat([nchw(img), heat.to(img.dtype)], dim=1)
        feats = []
        for i in range(self.n):
            x = getattr(self, f"ConvBlock2D_{i}")(x)
            feats.append(nhwc(x))
        return nhwc(getattr(self, f"ConvBlock2D_{self.n}")(x)), feats


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
GRAD_SCALE = 0.1       # the share of the motion field's gradient that flows back
UNMASK_WEIGHT = 0.3    # the occlusion regularisers' weight on the target torso


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

    @staticmethod
    def _scale_grad(t: torch.Tensor) -> torch.Tensor:
        """``t`` forward, ``GRAD_SCALE`` times its gradient backward (JAX's
        ``t * s + stop_gradient(t) * (1 - s)``); ``t`` itself where no
        gradient is recorded, so that inference is unchanged."""
        if not (torch.is_grad_enabled() and t.requires_grad):
            return t
        return t * GRAD_SCALE + t.detach() * (1 - GRAD_SCALE)

    @staticmethod
    def occlusion_losses(occlusion: torch.Tensor, occ2: torch.Tensor,
                         target_torso_mask: torch.Tensor | None = None) -> dict:
        """The JAX model's occlusion regularisers: the means of both
        occlusions (weighted 1 off and ``UNMASK_WEIGHT`` on the target torso
        where ``target_torso_mask`` [B,H,W] is given, the mask resized to each
        map by half-pixel nearest) and the binary entropy of ``occ2``."""
        def masked(occ):
            if target_torso_mask is None:
                return occ.mean()
            non = 1.0 - target_torso_mask.float()[:, None]
            non = F.interpolate(non, size=occ.shape[1:3], mode="nearest-exact")
            wts = nhwc(non) + (1.0 - nhwc(non)) * UNMASK_WEIGHT
            return (occ.abs() * wts).mean()

        alphas = occ2.clamp(1e-5, 1 - 1e-5)
        return {
            "facev2v/occlusion_reg_l1": masked(occlusion),
            "facev2v/occlusion_2_reg_l1": masked(occ2),
            "facev2v/occlusion_2_weights_entropy": (
                -alphas * torch.log2(alphas) - (1 - alphas) * torch.log2(1 - alphas)).mean(),
        }

    def forward(self, torso_src_img: torch.Tensor, segmap: torch.Tensor, kp_s: torch.Tensor,
                kp_d: torch.Tensor, tgt_head_img: torch.Tensor | None = None,
                tgt_head_weights: torch.Tensor | None = None,
                target_torso_mask: torch.Tensor | None = None,
                appearance_volume: torch.Tensor | None = None,
                appearance_only: bool = False) -> dict:
        """kp_s, kp_d [B,68,3]; the v2 head render and weights NHWC (taken
        as data: no gradient flows back into them); ``target_torso_mask``
        [B,H,W] weighs the occlusion regularisers. Returns
        deformed_torso_img [B,4h,4w,3], deformed_torso_hid, occlusion
        [B,h,w,1], occlusion_2 [B,4h,4w,1], kp_src, kp_drv (the keypoint
        subset) and, where a gradient is recorded, ``losses``
        (:meth:`occlusion_losses`); with ``appearance_only`` just the
        volume. The motion field's outputs carry ``GRAD_SCALE`` of their
        gradient back."""
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
            head = dict(tgt_head_img=None if tgt_head_img is None else tgt_head_img.detach(),
                        tgt_head_weights=None if tgt_head_weights is None
                        else tgt_head_weights.detach())
        deformation, occlusion, occlusion_2 = (self._scale_grad(t) for t in
                                               self.motion_field_estimator(motion_inp, kps,
                                                                           kpd, **head))
        rgb, hid = self.deform_based_generator(feats, deformation)
        occ2_up = resize_bilinear(occlusion_2, hid.shape[1], antialias=False)
        x = torch.cat([nchw(hid), nchw(occ2_up)], dim=1)
        x = F.relu(self.occ2_pred_conv0(x))
        x = F.relu(self.occ2_pred_conv1(x))
        occ2 = nhwc(torch.sigmoid(self.occ2_pred_conv2(x)))
        ret = {
            "deformed_torso_img": rgb,
            "deformed_torso_hid": hid,
            "occlusion": occlusion,
            "occlusion_2": occ2,
            "kp_src": kps,
            "kp_drv": kpd,
        }
        if torch.is_grad_enabled():
            ret["losses"] = self.occlusion_losses(occlusion, occ2, target_torso_mask)
        return ret

"""Plane feature decoder (the tiny NeRF MLP) and kernels K1 and K1-trigrid.

Port of ``real3dportrait_tpu/models/decoder.py``: EG3D's ``OSGDecoder``,
two equalized-LR dense layers with softplus and MipNeRF sigmoid clamping.

:func:`triplane_decode` is the wrapper of kernel K1
(``csrc/triplane_decode.cu``), which fuses the tri-plane sampling, the plane
mean and this MLP; :func:`triplane_decode_plain` is its plain PyTorch
version (``F.grid_sample`` + :class:`OSGDecoder`). :func:`trigrid_decode`
and :func:`trigrid_decode_plain` are the same for tri-grids (kernel
K1-trigrid, trilinear sampling, in the same source). Both kernels take the
decoder's folded weights packed in their fragment order and split for the
tensor cores (:func:`pack_decoder_mlp`), cached on the decoder
(:func:`packed_decoder_mlp`), a forward-only copy that never carries a
gradient.

On CUDA tensors :func:`triplane_decode` and :func:`trigrid_decode` are
``torch.autograd.Function`` calls over the planes and the decoder's parameters
(the backward folds them as ``FullyConnectedLayer.folded`` does and maps
the folded weights' gradients through the equalised-LR gains); their
backwards are kernels :func:`triplane_decode_backward` and
:func:`trigrid_decode_backward` (one template in the same source), their
plain version :func:`decode_backward_plain` (both layouts). Coordinates
take no gradient (rays come from the camera, the density regulariser's
points are data).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from real3dportrait_tpu_torch import kernels
from real3dportrait_tpu_torch.models.stylegan2 import FullyConnectedLayer
from real3dportrait_tpu_torch.rendering.renderer import (
    _PLANE_PERMS,
    sample_from_planes,
    sample_from_trigrids,
)


class OSGDecoder(nn.Module):
    """[B, n_planes, M, C] features -> {'rgb': [B,M,out_dim], 'sigma': [B,M,1]}."""

    def __init__(self, n_features: int, hidden_dim: int = 64, output_dim: int = 32,
                 lr_multiplier: float = 1.0):
        super().__init__()
        self.output_dim = output_dim
        self.net0 = FullyConnectedLayer(n_features, hidden_dim, lr_multiplier=lr_multiplier)
        self.net1 = FullyConnectedLayer(hidden_dim, 1 + output_dim,
                                        lr_multiplier=lr_multiplier)

    def forward(self, sampled_features: torch.Tensor) -> dict:
        x = sampled_features.mean(dim=1)
        b, m, c = x.shape
        x = torch.nn.functional.softplus(self.net0(x.reshape(b * m, c)))
        x = self.net1(x).reshape(b, m, -1)
        rgb = torch.sigmoid(x[..., 1:]) * (1 + 2 * 0.001) - 0.001
        return {"rgb": rgb, "sigma": x[..., 0:1]}

    def decode_points(self, planes: torch.Tensor, coords: torch.Tensor,
                      box_warp: float) -> tuple[torch.Tensor, torch.Tensor]:
        """Sample tri-planes [B,3,H,W,C] (kernel K1) or tri-grids
        [B,3,D,H,W,C] (kernel K1-trigrid) at world ``coords`` and decode."""
        if planes.dim() == 6:
            return trigrid_decode(planes, coords, box_warp, self)
        return triplane_decode(planes, coords, box_warp, self)


def triplane_decode_plain(planes: torch.Tensor, coords: torch.Tensor, box_warp: float,
                          decoder: OSGDecoder) -> tuple[torch.Tensor, torch.Tensor]:
    """planes [B,3,H,W,C], coords [B,M,3] -> (rgb [B,M,out], sigma [B,M,1])."""
    out = decoder(sample_from_planes(planes, coords, box_warp))
    return out["rgb"], out["sigma"]


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: fp32 rounded to 10 mantissa bits, ties away
    from zero (the kernels' split; an fp32 tensor in, its bits kept)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _hi_lo(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def pack_decoder_mlp(w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor,
                     b1: torch.Tensor) -> torch.Tensor:
    """The folded decoder (w0 [64,32], b0 [64], w1 [33,64], b1 [33]) in the
    K1 kernels' order (``csrc/triplane_decode.cu``): 9,320 fp32.

    First the B fragments of both mma.sync m16n8k8 products, split into
    TF32 hi and lo parts, as float4 (hi0, hi1, lo0, lo1) by [k-step][n-tile]
    [lane], lane = 4 g + t: for hidden = features . w0^T, [4][8][32] with
    b0 = w0[8j + g, 8s + t], b1 = w0[8j + g, 8s + t + 4]; for out = hidden .
    w1p^T, [8][5][32] with b0 = w1p[8m + g, 8j + 2t], b1 = w1p[8m + g, 8j +
    2t + 1] (the hidden units in the order the first product's accumulator
    holds them). w1p is w1 with its rows permuted and padded to 40: rows
    0..31 the rgb outputs 1..32, row 32 sigma (output 0), rows 33..39 zero.
    Then b0, and b1 with the rows of w1p.
    """
    f32 = dict(dtype=torch.float32, device=w0.device)
    w0, w1 = w0.to(**f32), w1.to(**f32)
    w1p = torch.zeros((40, 64), **f32)
    w1p[:32], w1p[32] = w1[1:], w1[0]
    b1p = torch.zeros((40,), **f32)
    b1p[:32], b1p[32] = b1[1:], b1[0]
    ar = functools.partial(torch.arange, device=w0.device)
    g, t = ar(8)[:, None], ar(4)[None, :]                       # [8,4] -> lane 4g + t
    s, j = ar(4)[:, None, None, None], ar(8)[None, :, None, None]
    rows, k = 8 * j + g, 8 * s + t                              # [4,8,8,4]
    first = (w0[rows, k], w0[rows, k + 4])
    j, m = ar(8)[:, None, None, None], ar(5)[None, :, None, None]
    rows, k = 8 * m + g, 8 * j + 2 * t                          # [8,5,8,4]
    second = (w1p[rows, k], w1p[rows, k + 1])
    frags = []
    for e0, e1 in (first, second):
        (h0, l0), (h1, l1) = _hi_lo(e0), _hi_lo(e1)
        frags.append(torch.stack((h0, h1, l0, l1), dim=-1).flatten())
    return torch.cat(frags + [b0.to(**f32), b1p]).contiguous()


def packed_decoder_mlp(decoder: OSGDecoder) -> torch.Tensor:
    """:func:`pack_decoder_mlp` of ``decoder``'s folded weights, cached on
    the decoder: packed once, and again when a parameter changes (in
    place, by ``load_state_dict``, or moved), which the key of each
    parameter's ``_version`` and ``data_ptr`` shows."""
    params = (decoder.net0.weight, decoder.net0.bias, decoder.net1.weight, decoder.net1.bias)
    key = tuple((p._version, p.data_ptr(), p.device) for p in params) + (
        decoder.net0.lr_multiplier, decoder.net1.lr_multiplier)
    cached = decoder.__dict__.get("_packed_mlp")
    if cached is None or cached[0] != key:
        with torch.no_grad():
            w0, b0 = decoder.net0.folded()
            w1, b1 = decoder.net1.folded()
            if w0.shape != (64, 32) or w1.shape != (33, 64):
                raise ValueError(f"the K1 kernels take a 32->64->33 decoder; got net0 "
                                 f"{tuple(w0.shape)}, net1 {tuple(w1.shape)}")
            cached = (key, pack_decoder_mlp(w0, b0, w1, b1))
        decoder.__dict__["_packed_mlp"] = cached
    return cached[1]


def _packed_mlp(name: str, decoder: OSGDecoder, planes: torch.Tensor,
                coords: torch.Tensor) -> torch.Tensor:
    """Check what the K1 kernels take; return the packed decoder weights."""
    kernels.require(name, "planes", planes)
    kernels.require(name, "coords", coords)
    if planes.shape[1] != 3 or planes.shape[-1] != 32 or coords.dim() != 3 \
            or coords.shape[0] != planes.shape[0] or coords.shape[-1] != 3:
        raise ValueError(f"{name}: kernel takes planes [B,3,...,32] and coords [B,M,3]; got "
                         f"planes {tuple(planes.shape)}, coords {tuple(coords.shape)}")
    packed = packed_decoder_mlp(decoder)
    kernels.require(name, "decoder weights", packed)
    return packed


def k1_cost(planes_shape: tuple, n_points: int) -> dict:
    """What a K1 / K1-trigrid call must move and compute: ``bytes``, the
    planes once, the coordinates, rgb and sigma (fp32); ``mma_ops``, the
    MLP's 2 x (32 x 64 + 64 x 33) a point, which the kernels run on the
    tensor cores in split TF32 (3 products each); ``fp32_ops``, the
    corner lerps (2 a corner channel, 4 or 8 corners on each of 3 planes)
    and 96 transcendentals (softplus, sigmoid) a point, on the CUDA cores."""
    corners = 8 if len(planes_shape) == 6 else 4
    return dict(bytes=4 * (math.prod(planes_shape) + n_points * (3 + 32 + 1)),
                mma_ops=n_points * 2 * (32 * 64 + 64 * 33),
                fp32_ops=n_points * (3 * corners * 32 * 2 + 96))


def trigrid_decode_plain(planes: torch.Tensor, coords: torch.Tensor, box_warp: float,
                         decoder: OSGDecoder) -> tuple[torch.Tensor, torch.Tensor]:
    """planes [B,3,D,H,W,C], coords [B,M,3] -> (rgb [B,M,out], sigma [B,M,1])."""
    out = decoder(sample_from_trigrids(planes, coords, box_warp))
    return out["rgb"], out["sigma"]


def _trigrid_corners(planes_shape: tuple, uvt: torch.Tensor) -> tuple:
    """The 8 trilinear corners of grid coordinates ``uvt`` [B,M,3] in
    [-1,1] (u indexes W, v H, t D) in [B,D,H,W,C] grids, by
    ``F.grid_sample``'s rules (align_corners=False, zero padding): flat
    row indices [8,B,M] (clamped), weights [8,B,M] (0 for a corner
    outside)."""
    _, d, h, w, _ = planes_shape
    x = ((uvt[..., 0] + 1) * w - 1) / 2
    y = ((uvt[..., 1] + 1) * h - 1) / 2
    z = ((uvt[..., 2] + 1) * d - 1) / 2
    x0, y0, z0 = x.floor(), y.floor(), z.floor()
    idx, wts = [], []
    for cz in (0, 1):
        for cy in (0, 1):
            for cx in (0, 1):
                xi, yi, zi = x0 + cx, y0 + cy, z0 + cz
                wgt = ((x - x0) if cx else (1 - (x - x0))) * \
                      ((y - y0) if cy else (1 - (y - y0))) * \
                      ((z - z0) if cz else (1 - (z - z0)))
                ok = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1) & \
                     (zi >= 0) & (zi <= d - 1)
                flat = (zi.clamp(0, d - 1) * h + yi.clamp(0, h - 1)) * w + xi.clamp(0, w - 1)
                idx.append(flat.long())
                wts.append(torch.where(ok, wgt, torch.zeros_like(wgt)))
    return torch.stack(idx), torch.stack(wts)


def _plane_corners(planes_shape: tuple, uv: torch.Tensor) -> tuple:
    """The 4 bilinear corners of plane coordinates ``uv`` [B,M,2] in
    [-1,1] (u indexes W, v H) in [B,H,W,C] planes, by ``F.grid_sample``'s
    rules (align_corners=False, zero padding): flat row indices [4,B,M]
    (clamped), weights [4,B,M] (0 for a corner outside)."""
    _, h, w, _ = planes_shape
    x = ((uv[..., 0] + 1) * w - 1) / 2
    y = ((uv[..., 1] + 1) * h - 1) / 2
    x0, y0 = x.floor(), y.floor()
    idx, wts = [], []
    for cy in (0, 1):
        for cx in (0, 1):
            xi, yi = x0 + cx, y0 + cy
            wgt = ((x - x0) if cx else (1 - (x - x0))) * ((y - y0) if cy else (1 - (y - y0)))
            ok = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            idx.append((yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long())
            wts.append(torch.where(ok, wgt, torch.zeros_like(wgt)))
    return torch.stack(idx), torch.stack(wts)


def decode_backward_plain(planes: torch.Tensor, coords: torch.Tensor, box_warp: float,
                          w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor,
                          b1: torch.Tensor, drgb: torch.Tensor | None,
                          dsigma: torch.Tensor | None) -> tuple:
    """Plain PyTorch K1 and K1-trigrid backward: tri-planes [B,3,H,W,C]
    (bilinear) or tri-grids [B,3,D,H,W,C] (trilinear), coords [B,M,3], the
    folded decoder (w0 [64,C], b0, w1 [1+C',64], b1) and the gradients of
    rgb [B,M,C'] and sigma [B,M,1] (either None for zero) -> (d planes,
    d w0, d b0, d w1, d b1), written out (no autograd)."""
    grid = planes.dim() == 6
    bsz, k, c = planes.shape[0], planes.shape[1], planes.shape[-1]
    m = coords.shape[1]
    coords = (2.0 / box_warp) * coords
    rows = planes.reshape(bsz, k, -1, c)
    corners = []
    feats = torch.zeros((bsz, m, c), dtype=planes.dtype, device=planes.device)
    for i, perm in enumerate(_PLANE_PERMS):
        if grid:
            idx, wts = _trigrid_corners((bsz,) + tuple(planes.shape[2:]), coords[..., list(perm)])
        else:
            idx, wts = _plane_corners((bsz,) + tuple(planes.shape[2:]),
                                      coords[..., list(perm[:2])])
        corners.append((idx, wts))
        for j in range(idx.shape[0]):
            got = torch.gather(rows[:, i], 1, idx[j][..., None].expand(-1, -1, c))
            feats = feats + got * wts[j][..., None]
    f = (feats / 3).reshape(bsz * m, c)
    hpre = f @ w0.T + b0
    hid = F.softplus(hpre)
    out = hid @ w1.T + b1
    dout = torch.zeros_like(out)
    if dsigma is not None:
        dout[:, 0] = dsigma.reshape(-1)
    if drgb is not None:
        sg = torch.sigmoid(out[:, 1:])
        dout[:, 1:] = drgb.reshape(bsz * m, -1) * (1 + 2 * 0.001) * (sg * (1 - sg))
    dw1, db1 = dout.T @ hid, dout.sum(0)
    dhp = (dout @ w1) * torch.sigmoid(hpre)
    dw0, db0 = dhp.T @ f, dhp.sum(0)
    df = (dhp @ w0 / 3).reshape(bsz, m, c)
    drows = torch.zeros_like(rows)
    for i, (idx, wts) in enumerate(corners):
        for j in range(idx.shape[0]):
            drows[:, i].scatter_add_(1, idx[j][..., None].expand(-1, -1, c),
                                     df * wts[j][..., None])
    return drows.reshape(planes.shape), dw0, db0, dw1, db1


def _backward_launch(name: str, planes: torch.Tensor, coords: torch.Tensor, box_warp: float,
                     w0, b0, w1, b1, drgb, dsigma) -> tuple:
    """Check and launch K1's (tri-planes) or K1-trigrid's backward kernel."""
    grid = planes.dim() == 6
    planes, coords = planes.contiguous(), coords.contiguous()
    weights = [t.detach().float().contiguous() for t in (w0, b0, w1, b1)]
    for arg, t in zip(("planes", "coords", "w0", "b0", "w1", "b1"), [planes, coords] + weights):
        kernels.require(name, arg, t)
    bsz, c = planes.shape[0], planes.shape[-1]
    m = coords.shape[1] if coords.dim() == 3 else -1
    if planes.dim() != (6 if grid else 5) or planes.shape[1] != 3 or c != 32 \
            or coords.shape != (bsz, m, 3) or weights[0].shape != (64, 32) \
            or weights[2].shape != (33, 64):
        raise ValueError(f"{name}: kernel takes planes [B,3,{'D,' if grid else ''}H,W,32], "
                         f"coords [B,M,3] and a 32->64->33 decoder; got "
                         f"{tuple(planes.shape)}, {tuple(coords.shape)}, "
                         f"{tuple(weights[0].shape)}, {tuple(weights[2].shape)}")
    grads = []
    for arg, t, shape in (("drgb", drgb, (bsz, m, 32)), ("dsigma", dsigma, (bsz, m, 1))):
        if t is not None:
            t = t.contiguous()
            kernels.require(name, arg, t)
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: {arg} must be {shape}, got {tuple(t.shape)}")
        grads.append(t)
    dplanes = torch.zeros_like(planes)
    dw = [torch.zeros_like(t) for t in weights]
    dims = planes.shape[2:5] if grid else planes.shape[2:4]
    kernels.launch(f"r3dp_{name}", planes, bsz, *dims, coords, m, 2.0 / box_warp, *weights,
                   *grads, dplanes, *dw)
    return (dplanes, *dw)


def triplane_decode_backward(planes: torch.Tensor, coords: torch.Tensor, box_warp: float,
                             w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor,
                             b1: torch.Tensor, drgb: torch.Tensor | None,
                             dsigma: torch.Tensor | None) -> tuple:
    """K1 backward wrapper, same contract as
    :func:`decode_backward_plain` on tri-planes. CPU tensors take the plain
    version; CUDA tensors launch the kernel (fp32, C = 32, a 64-wide hidden
    layer, 33 outputs; the tri-plane instantiation of K1-trigrid's
    backward) or raise. ``triplane_decode_backward.launches`` counts its
    launches."""
    if planes.device.type == "cpu":
        return decode_backward_plain(planes, coords, box_warp, w0, b0, w1, b1, drgb, dsigma)
    out = _backward_launch("triplane_decode_backward", planes, coords, box_warp, w0, b0, w1,
                           b1, drgb, dsigma)
    triplane_decode_backward.launches += 1
    return out


triplane_decode_backward.launches = 0


class _TriplaneDecode(torch.autograd.Function):
    """K1 forward (packed split-TF32 weights) with the backward kernel; the
    inputs are the tri-planes and the decoder's raw parameters, whose
    gradients are the folded weights' times the equalised-LR ``gains``."""

    @staticmethod
    def forward(ctx, planes, coords, w0, b0, w1, b1, gains, box_warp, packed):
        ctx.save_for_backward(planes, coords, w0, b0, w1, b1)
        ctx.gains, ctx.box_warp = gains, box_warp
        b, _, h, w, _ = planes.shape
        m = coords.shape[1]
        rgb = torch.empty((b, m, 32), device=planes.device)
        sigma = torch.empty((b, m, 1), device=planes.device)
        kernels.launch("r3dp_triplane_decode", planes, b, h, w, coords, m, 2.0 / box_warp,
                       packed, rgb, sigma)
        triplane_decode.launches += 1
        return rgb, sigma

    @staticmethod
    def backward(ctx, drgb, dsigma):
        planes, coords, *raw = ctx.saved_tensors
        folded = [p * g for p, g in zip(raw, ctx.gains)]
        dplanes, *dw = triplane_decode_backward(planes, coords, ctx.box_warp, *folded, drgb,
                                                dsigma)
        return (dplanes if ctx.needs_input_grad[0] else None, None,
                *(d * g for d, g in zip(dw, ctx.gains)), None, None, None)


def triplane_decode(planes: torch.Tensor, coords: torch.Tensor, box_warp: float,
                    decoder: OSGDecoder) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 wrapper, same contract as :func:`triplane_decode_plain`.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes fp32 planes [B,3,H,W,32], a 64-wide hidden layer and 33
    outputs, or raise. The call is a ``torch.autograd.Function`` whose
    backward is :func:`triplane_decode_backward`; coordinates that need a
    gradient raise.
    """
    if planes.device.type == "cpu":
        return triplane_decode_plain(planes, coords, box_warp, decoder)
    name = "triplane_decode"
    planes, coords = planes.contiguous(), coords.contiguous()
    if planes.dim() != 5:
        raise ValueError(f"{name}: planes must be [B,3,H,W,32], got {tuple(planes.shape)}")
    if torch.is_grad_enabled() and coords.requires_grad:
        raise ValueError(f"{name}: coordinates that need a gradient are not supported")
    packed = _packed_mlp(name, decoder, planes, coords)
    n0, n1 = decoder.net0, decoder.net1
    gains = (n0.weight_gain, n0.lr_multiplier, n1.weight_gain, n1.lr_multiplier)
    return _TriplaneDecode.apply(planes, coords, n0.weight, n0.bias, n1.weight, n1.bias, gains,
                                 box_warp, packed)


triplane_decode.launches = 0


def trigrid_decode_backward(planes: torch.Tensor, coords: torch.Tensor, box_warp: float,
                            w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor,
                            b1: torch.Tensor, drgb: torch.Tensor | None,
                            dsigma: torch.Tensor | None) -> tuple:
    """K1-trigrid backward wrapper, same contract as
    :func:`decode_backward_plain` on tri-grids. CPU tensors take the plain
    version; CUDA tensors launch the kernel (fp32, C = 32, a 64-wide hidden
    layer, 33 outputs) or raise. ``trigrid_decode_backward.launches``
    counts its launches."""
    if planes.device.type == "cpu":
        return decode_backward_plain(planes, coords, box_warp, w0, b0, w1, b1, drgb, dsigma)
    out = _backward_launch("trigrid_decode_backward", planes, coords, box_warp, w0, b0, w1,
                           b1, drgb, dsigma)
    trigrid_decode_backward.launches += 1
    return out


trigrid_decode_backward.launches = 0


class _TrigridDecode(torch.autograd.Function):
    """K1-trigrid forward (packed split-TF32 weights) with the backward
    kernel; the inputs are the tri-grids and the decoder's raw parameters,
    whose gradients are the folded weights' times the equalised-LR
    ``gains``."""

    @staticmethod
    def forward(ctx, planes, coords, w0, b0, w1, b1, gains, box_warp, packed):
        ctx.save_for_backward(planes, coords, w0, b0, w1, b1)
        ctx.gains, ctx.box_warp = gains, box_warp
        b, _, d, h, w, _ = planes.shape
        m = coords.shape[1]
        rgb = torch.empty((b, m, 32), device=planes.device)
        sigma = torch.empty((b, m, 1), device=planes.device)
        kernels.launch("r3dp_trigrid_decode", planes, b, d, h, w, coords, m, 2.0 / box_warp,
                       packed, rgb, sigma)
        trigrid_decode.launches += 1
        return rgb, sigma

    @staticmethod
    def backward(ctx, drgb, dsigma):
        planes, coords, *raw = ctx.saved_tensors
        folded = [p * g for p, g in zip(raw, ctx.gains)]
        dplanes, *dw = trigrid_decode_backward(planes, coords, ctx.box_warp, *folded, drgb,
                                               dsigma)
        return (dplanes if ctx.needs_input_grad[0] else None, None,
                *(d * g for d, g in zip(dw, ctx.gains)), None, None, None)


def trigrid_decode(planes: torch.Tensor, coords: torch.Tensor, box_warp: float,
                   decoder: OSGDecoder) -> tuple[torch.Tensor, torch.Tensor]:
    """K1-trigrid wrapper, same contract as :func:`trigrid_decode_plain`.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes fp32 tri-grids [B,3,D,H,W,32] (any D, H, W >= 1), a
    64-wide hidden layer and 33 outputs, or raise. The call is a
    ``torch.autograd.Function`` whose backward is
    :func:`trigrid_decode_backward`; coordinates that need a gradient
    raise.
    """
    if planes.device.type == "cpu":
        return trigrid_decode_plain(planes, coords, box_warp, decoder)
    name = "trigrid_decode"
    planes, coords = planes.contiguous(), coords.contiguous()
    if planes.dim() != 6:
        raise ValueError(f"{name}: planes must be [B,3,D,H,W,32], got "
                         f"{tuple(planes.shape)}")
    if torch.is_grad_enabled() and coords.requires_grad:
        raise ValueError(f"{name}: coordinates that need a gradient are not supported")
    packed = _packed_mlp(name, decoder, planes, coords)
    n0, n1 = decoder.net0, decoder.net1
    gains = (n0.weight_gain, n0.lr_multiplier, n1.weight_gain, n1.lr_multiplier)
    return _TrigridDecode.apply(planes, coords, n0.weight, n0.bias, n1.weight, n1.bias, gains,
                                box_warp, packed)


trigrid_decode.launches = 0

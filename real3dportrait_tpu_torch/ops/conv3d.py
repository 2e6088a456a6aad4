"""3D convolution of the torso model, kernel K7a (port of
``real3dportrait_tpu/ops/conv3d.py``).

The JAX package lowers every torso 3D convolution as ``kd`` batched 2D
convolutions (``conv3d_via_2d``), a TPU form. Here the same function, a
stride-1 3D convolution with zero "same" padding and a cubic kernel of 3 or
7, is one hand-written kernel (``csrc/conv3d.cu``) on NCDHW activations and
``[Co,Ci,k,k,k]`` weights, with its plain PyTorch version
:func:`conv3d_plain` (``F.conv3d``) beside it. :class:`Conv3D` is
``nn.Conv3d`` with that forward, so parameter names, ``mock_init_`` and the
weight bridge stay as they are.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from real3dportrait_tpu_torch import kernels


@functools.cache
def kernel_tiles() -> dict:
    """The tiles ``csrc/conv3d.cu`` is compiled for, read from the built
    library: K7a's ``pixel_groups`` (groups of 4 output columns per CTA),
    ``co_block`` (output channels per CTA) and ``ci_chunk`` (input
    channels staged at once, by k); K7b's ``tail_tile`` (pixel rows,
    columns per CTA)."""
    out = (ctypes.c_int * 6)()
    kernels.library().r3dp_k7_tiles(out)
    return dict(pixel_groups=out[0], co_block=out[1], ci_chunk={3: out[2], 7: out[3]},
                tail_tile=(out[4], out[5]))


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def conv3d_plan(b: int, ci: int, co: int, d: int, h: int, w: int, k: int, tiles: dict,
                sms: int) -> dict:
    """The kernel's tiling of one call for ``tiles`` (:func:`kernel_tiles`)
    on ``sms`` SMs: ``TD`` depth slices x ``TH`` rows x ``4 G`` columns of
    output voxels per CTA (the whole width up to 64, so that small planes
    stack depth slices), and ``n_split`` groups of ``ci_per_split`` input
    channels, so that the call gives at least two CTAs per SM where its
    tiles and output-channel blocks alone do not."""
    g = min(math.ceil(w / 4), 16)
    rows = tiles["pixel_groups"] // g
    th = min(h, rows)
    td = min(d, rows // th)
    ctas = b * math.ceil(d / td) * math.ceil(h / th) * math.ceil(w / (4 * g)) \
        * math.ceil(co / tiles["co_block"])
    chunk = tiles["ci_chunk"][k]
    chunks = math.ceil(ci / chunk)
    splits = min(chunks, max(1, math.ceil(2 * sms / ctas)))
    per = math.ceil(chunks / splits) * chunk
    return dict(TD=td, TH=th, G=g, ci_per_split=per, n_split=math.ceil(ci / per))


def conv3d_ops(ci: int, co: int, d: int, h: int, w: int, k: int, b: int = 1) -> int:
    """The operations (2 per product) of a stride-1 conv with zero "same"
    padding: only the taps that fall inside the volume, none of the
    padding's."""
    p = k // 2

    def taps(n: int) -> int:
        return sum(min(n - 1, o + p) - max(0, o - p) + 1 for o in range(n))

    return 2 * b * co * ci * taps(d) * taps(h) * taps(w)


def conv3d_plain(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor | None = None) -> torch.Tensor:
    """x [B,Ci,D,H,W], weight [Co,Ci,k,k,k], bias [Co] -> [B,Co,D,H,W]:
    stride 1, zero padding k // 2 on every side."""
    return F.conv3d(x, weight, bias, padding=weight.shape[-1] // 2)


def conv3d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """K7a wrapper, same contract as :func:`conv3d_plain`.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes fp32 and a cubic kernel of 3 or 7, or raise.
    """
    if x.device.type == "cpu":
        return conv3d_plain(x, weight, bias)
    name = "conv3d"
    x, weight = x.contiguous(), weight.detach().contiguous()
    kernels.require(name, "x", x)
    kernels.require(name, "weight", weight)
    if bias is not None:
        bias = bias.detach().contiguous()
        kernels.require(name, "bias", bias)
    k = weight.shape[-1]
    if x.dim() != 5 or weight.dim() != 5 or tuple(weight.shape[2:]) != (k, k, k) \
            or k not in (3, 7) or weight.shape[1] != x.shape[1] \
            or (bias is not None and tuple(bias.shape) != (weight.shape[0],)):
        raise ValueError(f"{name}: kernel takes x [B,Ci,D,H,W], weight [Co,Ci,k,k,k] with "
                         f"k in (3, 7) and bias [Co]; got x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}, bias "
                         f"{None if bias is None else tuple(bias.shape)}")
    b, ci, d, h, w = x.shape
    co = weight.shape[0]
    plan = conv3d_plan(b, ci, co, d, h, w, k, kernel_tiles(), sm_count(x.device))
    out = torch.empty((b, co, d, h, w), device=x.device)
    partial = (torch.empty((plan["n_split"], b, co, d, h, w), device=x.device)
               if plan["n_split"] > 1 else None)
    kernels.launch("r3dp_conv3d", x, weight, bias, out, partial, b, ci, co,
                   d, h, w, k, plan["TD"], plan["TH"], plan["G"], plan["ci_per_split"],
                   plan["n_split"])
    conv3d.launches += 1
    return out


conv3d.launches = 0


class Conv3D(nn.Conv3d):
    """``nn.Conv3d`` (stride 1, padding k // 2, cubic k) computed by
    :func:`conv3d`."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding: int | None = None, bias: bool = True):
        if padding is not None and padding != kernel_size // 2:
            raise ValueError(f"Conv3D pads k // 2 = {kernel_size // 2}, got {padding}")
        super().__init__(in_channels, out_channels, kernel_size, padding=kernel_size // 2,
                         bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3d(x, self.weight, self.bias)

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

On CUDA tensors :func:`conv3d` is a ``torch.autograd.Function``: the data
gradient is K7a itself on the output's gradient (the taps flipped, the
input and output channels swapped), the weight and bias gradients kernel
:func:`conv3d_weight_grad` (same source), plain version
:func:`conv3d_weight_grad_plain` (``torch.nn.grad.conv3d_weight``).
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
    library: K7a's ``threads`` per CTA, ``warp_tile`` (a warp's output tile
    is that many voxels x output channels), ``ci_chunk`` (input channels
    per step), ``stages`` (of the copy ring) and ``smem_max`` (bytes of
    shared memory a CTA may use); K7b's ``tail_tiles`` (pixel rows and
    columns of a CTA, by the volume's depth), ``tail_ctas_per_sm`` and
    ``tail_groups`` (a pixel's depth groups, by depth, each with its own
    occlusion sums)."""
    out = (ctypes.c_int * 11)()
    kernels.library().r3dp_k7_tiles(out)
    return dict(threads=out[0], warp_tile=out[1], ci_chunk=out[2], stages=out[3],
                smem_max=out[4], tail_tiles={16: (out[5], out[7]), 2: (out[6], out[7])},
                tail_ctas_per_sm=out[8], tail_groups={16: out[9], 2: out[10]})


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def conv3d_smem(k: int, kh: int, bn: int, td: int, th: int, tw: int, tiles: dict) -> int:
    """Bytes of shared memory of a K7a CTA whose steps cover ``kh`` rows of
    taps: ``stages`` stage buffers and one buffer of low parts, each the
    halo tiles of ``ci_chunk`` input channels plus their weights for the
    ``kh * k`` taps, laid out as ``csrc/conv3d.cu`` ``k7_layout`` does (row
    stride a multiple of 4 floats after an offset that aligns the interior,
    channel strides 8 mod 32, so that fragment loads are free of bank
    conflicts)."""
    off = (4 - (k // 2) % 4) % 4
    rs = (off + tw + k - 1 + 3) // 4 * 4
    cs = td * (th + kh - 1) * rs
    cs += (8 - cs % 32) % 32
    ts = tiles["ci_chunk"] * (bn + 8) + 8
    return 4 * (tiles["stages"] + 1) * (tiles["ci_chunk"] * cs + kh * k * ts)


def _balanced(n: int, cap: int) -> int:
    """The tile length at most ``cap`` that cuts ``n`` into the fewest,
    most even tiles."""
    return math.ceil(n / math.ceil(n / cap))


def conv3d_plan(b: int, ci: int, co: int, d: int, h: int, w: int, k: int, tiles: dict,
                sms: int) -> dict:
    """The kernel's tiling of one call for ``tiles`` (:func:`kernel_tiles`)
    on ``sms`` SMs: ``BN`` output channels per CTA (one warp tile, or two
    at k = 3 on the 4x4 planes, where a one-tile CTA's halo of 16 depth
    slices would cost more than its weights) and ``TD`` depth slices x ``TH``
    rows x ``TW`` columns of output voxels, at most the CTA's M of
    ``threads / 32 * warp_tile^2 / BN`` (the whole width up to 64, a power
    of 2, so that small planes stack rows and depth slices); ``KH``, the
    rows of taps a step stages: all k where two CTAs fit an SM's shared
    memory, else one (k = 7 always), and fewer depth slices where even that
    does not fit; and ``n_split`` groups of ``ci_per_split`` input
    channels, so that a call whose tiles and output-channel blocks give
    fewer CTAs than SMs gets two CTAs per SM."""
    wt = tiles["warp_tile"]
    bn = 2 * wt if k == 3 and co > wt and h * w <= 16 else wt
    bm = tiles["threads"] // 32 * wt * wt // bn
    tw = min(64, 1 << max(2, (w - 1).bit_length()))
    th = _balanced(h, bm // tw)
    td = _balanced(d, bm // (tw * th))
    kh = k if k == 3 and conv3d_smem(k, k, bn, td, th, tw, tiles) <= tiles["smem_max"] // 2 \
        else 1
    while td > 1 and conv3d_smem(k, kh, bn, td, th, tw, tiles) > tiles["smem_max"]:
        td = _balanced(d, td - 1)
    ctas = b * math.ceil(d / td) * math.ceil(h / th) * math.ceil(w / tw) * math.ceil(co / bn)
    chunk = tiles["ci_chunk"]
    chunks = math.ceil(ci / chunk)
    splits = 1 if ctas >= sms else min(chunks, math.ceil(2 * sms / ctas))
    per = math.ceil(chunks / splits) * chunk
    return dict(KH=kh, BN=bn, TD=td, TH=th, TW=tw, ci_per_split=per,
                n_split=math.ceil(ci / per))


@functools.lru_cache(maxsize=256)
def _cached_plan(b: int, ci: int, co: int, d: int, h: int, w: int, k: int, index: int) -> dict:
    return conv3d_plan(b, ci, co, d, h, w, k, kernel_tiles(),
                       sm_count(torch.device("cuda", index)))


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


def _conv3d_launch(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor | None) -> torch.Tensor:
    """Check and launch K7a on CUDA tensors (no autograd)."""
    name = "conv3d"
    x, weight = x.contiguous(), weight.contiguous()
    kernels.require(name, "x", x)
    kernels.require(name, "weight", weight)
    if bias is not None:
        bias = bias.contiguous()
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
    plan = _cached_plan(b, ci, co, d, h, w, k, x.get_device())
    out = torch.empty((b, co, d, h, w), device=x.device)
    partial = (torch.empty((plan["n_split"], b, co, d, h, w), device=x.device)
               if plan["n_split"] > 1 else None)
    # the halo rows' interiors copy in 16 B pieces where they are 16 B aligned
    vec = int(w % 4 == 0 and x.data_ptr() % 16 == 0)
    kernels.launch("r3dp_conv3d", x, weight, bias, out, partial, b, ci, co, d, h, w, k,
                   plan["KH"], plan["BN"], plan["TD"], plan["TH"], plan["TW"],
                   plan["ci_per_split"], plan["n_split"], vec)
    conv3d.launches += 1
    return out


def conv3d_data_grad(dy: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The gradient of a K7a call's input from its output's gradient ``dy``
    [B,Co,D,H,W]: the same stride-1 same-padded conv on ``dy`` with the
    taps flipped and the channels swapped, launched as K7a (CPU tensors:
    its plain version)."""
    flipped = weight.transpose(0, 1).flip((2, 3, 4))
    if dy.device.type == "cpu":
        return conv3d_plain(dy, flipped)
    return _conv3d_launch(dy, flipped, None)


def conv3d_weight_grad_plain(x: torch.Tensor, dy: torch.Tensor,
                             k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,Ci,D,H,W], dy [B,Co,D,H,W] -> (d weight [Co,Ci,k,k,k], d bias
    [Co]) of the stride-1 conv with zero padding k // 2."""
    shape = (dy.shape[1], x.shape[1], k, k, k)
    return (torch.nn.grad.conv3d_weight(x, shape, dy, padding=k // 2),
            dy.sum(dim=(0, 2, 3, 4)))


# the weight-gradient kernel's tiles (csrc/conv3d.cu conv3d_wgrad_kernel):
# input channels a CTA (M), voxels a brick at most, stages of its copy ring,
# the shared memory a CTA plans for (two CTAs an SM)
WGRAD_M = 32
WGRAD_BRICK = 128
WGRAD_STAGES = 2
WGRAD_SMEM = 112 * 1024


def conv3d_weight_grad_layout(k: int, bn: int, vp: int, sw: int, r: int) -> dict:
    """The weight-gradient kernel's shared-memory layout (floats), as
    ``csrc/conv3d.cu`` ``wg_layout`` computes it, for units of ``sw``
    columns, ``r`` units a brick, ``bn`` output channels and ``vp`` groups
    of k warps: ``OFF`` and ``RS``, where a unit's x row starts and its
    stride (k // 2 halo columns on each side, the interior 16 B aligned);
    ``CS``, an input channel's rows and 8 zero floats, and ``DS``, an output
    channel's ``8 NK`` voxels (``NK`` k-steps of 8), both 4 mod 8; ``smem``,
    the bytes of a CTA (the ring's stages, the voxel offsets, a slot of
    unit descriptors a stage and one more)."""
    p = k // 2
    off = (4 - p % 4) % 4
    rs = (off + sw + 2 * p + 3) // 4 * 4
    nk = (r * sw + 7) // 8
    cs = r * rs + 8
    cs += (12 - cs % 8) % 8
    ds = 8 * nk + 4
    stage = WGRAD_M * cs + bn * ds
    area = max(WGRAD_STAGES * stage, (vp - 1) * k * bn * 32)
    return dict(OFF=off, RS=rs, CS=cs, DS=ds, NK=nk,
                smem=4 * area + 4 * 8 * nk + (WGRAD_STAGES + 1) * r * 20)


def conv3d_weight_grad_plan(b: int, ci: int, co: int, d: int, h: int, w: int, k: int,
                            sms: int) -> dict:
    """The weight-gradient kernel's decomposition of one call on ``sms``
    SMs. A CTA owns a row of taps (kd, kh), ``WGRAD_M`` input channels and
    ``BN`` output channels (8 where ``co`` <= 8, else 32), with ``VP``
    groups of k warps (2 at k = 3, 1 at k = 7); its voxels are the units (a
    row's ``SW`` columns, ``nseg`` a row; with ``vec``, where w is a
    multiple of 4, so is ``SW``) of the rows whose shifted row lies inside
    the volume, ``R`` units a brick (at most ``WGRAD_BRICK`` voxels, fewer
    where two stages would pass ``WGRAD_SMEM``), and ``n_split`` shares of
    them: about 16 CTAs an SM at k = 7 and 6 at k = 3 (on the card the
    fuser's rows of taps, whose units differ most at the volume's edges,
    balance better in smaller shares; the 3^3 convs lose more to each
    CTA's start), each share at least four bricks of the full volume's
    units."""
    vec = w % 4 == 0
    nseg = math.ceil(w / WGRAD_BRICK)
    sw = 4 * math.ceil(w / (4 * nseg)) if vec else math.ceil(w / nseg)
    r = max(1, WGRAD_BRICK // sw)
    bn = 8 if co <= 8 else 32
    vp = 2 if k == 3 else 1
    while r > 1 and conv3d_weight_grad_layout(k, bn, vp, sw, r)["smem"] > WGRAD_SMEM:
        r -= 1
    tiles = k * k * math.ceil(ci / WGRAD_M) * math.ceil(co / bn)
    units = b * d * h * nseg
    per_sm = 16 if k == 7 else 6
    n_split = max(1, min(math.ceil(per_sm * sms / tiles), math.ceil(units / (4 * r)), 65535))
    return dict(BN=bn, VP=vp, SW=sw, nseg=nseg, R=r, vec=vec, n_split=n_split)


def conv3d_weight_grad(x: torch.Tensor, dy: torch.Tensor,
                       k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K7a's weight-gradient wrapper, same contract as
    :func:`conv3d_weight_grad_plain`. CPU tensors take the plain version;
    CUDA tensors launch the kernel (fp32, k 3 or 7) or raise.
    ``conv3d_weight_grad.launches`` counts its launches."""
    if x.device.type == "cpu":
        return conv3d_weight_grad_plain(x, dy, k)
    name = "conv3d_weight_grad"
    x, dy = x.contiguous(), dy.contiguous()
    kernels.require(name, "x", x)
    kernels.require(name, "dy", dy)
    if x.dim() != 5 or dy.dim() != 5 or x.shape[0] != dy.shape[0] \
            or x.shape[2:] != dy.shape[2:] or k not in (3, 7) \
            or math.prod(x.shape) // x.shape[1] >= 2 ** 31:
        raise ValueError(f"{name}: kernel takes x [B,Ci,D,H,W], dy [B,Co,D,H,W] and k in "
                         f"(3, 7); got x {tuple(x.shape)}, dy {tuple(dy.shape)}, k {k}")
    b, ci, d, h, w = x.shape
    co = dy.shape[1]
    dw = torch.zeros((co, ci, k, k, k), device=x.device)
    db = torch.zeros((co,), device=x.device)
    plan = conv3d_weight_grad_plan(b, ci, co, d, h, w, k, sm_count(x.device))
    vec = int(plan["vec"] and x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0)
    kernels.launch("r3dp_conv3d_weight_grad", x, dy, b, ci, co, d, h, w, k, plan["SW"],
                   plan["R"], plan["n_split"], vec, dw, db)
    conv3d_weight_grad.launches += 1
    return dw, db


conv3d_weight_grad.launches = 0


class _Conv3D(torch.autograd.Function):
    """K7a forward; backward: K7a on the flipped taps for the input, the
    weight-gradient kernel for the weight and bias."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return _conv3d_launch(x, weight, bias)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dy = dy.contiguous()
        dx = conv3d_data_grad(dy, weight) if ctx.needs_input_grad[0] else None
        dw = db = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = conv3d_weight_grad(x, dy, weight.shape[-1])
        return dx, dw, db if ctx.needs_input_grad[2] else None


def conv3d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """K7a wrapper, same contract as :func:`conv3d_plain`.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes fp32 and a cubic kernel of 3 or 7, or raise. The call is a
    ``torch.autograd.Function`` (:class:`_Conv3D`) under ``no_grad`` too.
    """
    if x.device.type == "cpu":
        return conv3d_plain(x, weight, bias)
    return _Conv3D.apply(x, weight, bias)


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

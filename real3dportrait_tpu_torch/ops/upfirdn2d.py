"""Upsample-FIR-downsample resampling, resampling convolutions and kernel
K6a (port of ``real3dportrait_tpu/ops/upfirdn2d.py``).

:func:`upfirdn2d` is the wrapper of kernel K6a
(``csrc/stylegan_epilogue.cu``); :func:`upfirdn2d_plain` is its plain
PyTorch version (zero insertion, pad/crop, depthwise ``F.conv2d``).

Tensors here are NCHW and conv weights OIHW, PyTorch's own layouts; the
modules that call these convert from the port's NHWC public layout once.
Padding is applied to the upsampled image and negative padding crops, as
in the reference.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from real3dportrait_tpu_torch import kernels


def setup_filter(f, normalize: bool = True, gain: float = 1.0,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """2D FIR filter [fh, fw] float32; 1-D inputs are outer-product expanded."""
    if f is None:
        f = [1.0]
    f = np.asarray(f, dtype=np.float32)
    if f.ndim == 0:
        f = f[None]
    if f.ndim == 1:
        f = np.outer(f, f)
    if normalize:
        f = f / f.sum()
    f = f * (gain ** (f.ndim / 2))
    return torch.tensor(f, dtype=torch.float32, device=device)


def _parse_padding(padding) -> tuple[int, int, int, int]:
    if isinstance(padding, int):
        padding = [padding, padding]
    if len(padding) == 2:
        px, py = padding
        return px, px, py, py
    px0, px1, py0, py1 = padding
    return px0, px1, py0, py1


def _pad(x: torch.Tensor, px0: int, px1: int, py0: int, py1: int) -> torch.Tensor:
    """Zero-pad (positive) or crop (negative) the last two axes."""
    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    h, w = x.shape[-2:]
    return x[..., max(-py0, 0):h - max(-py1, 0), max(-px0, 0):w - max(-px1, 0)]


def _zero_insert(x: torch.Tensor, up: int) -> torch.Tensor:
    """[B,C,H,W] -> [B,C,H*up,W*up] with the samples at multiples of ``up``."""
    if up == 1:
        return x
    b, c, h, w = x.shape
    y = x.new_zeros((b, c, h * up, w * up))
    y[:, :, ::up, ::up] = x
    return y


def _taps(f: torch.Tensor | None, gain: float, x: torch.Tensor) -> torch.Tensor:
    """The flipped, gain-scaled filter both versions correlate with."""
    if f is None:
        f = torch.ones((1, 1), dtype=x.dtype, device=x.device)
    return (torch.flip(f, (0, 1)) * gain).to(x.dtype)


def upfirdn2d_plain(x: torch.Tensor, f: torch.Tensor | None, up: int = 1, down: int = 1,
                    padding=0, gain: float = 1.0) -> torch.Tensor:
    """x [B,C,H,W] -> upsample(up), pad, FIR(f), downsample(down).

    ``f`` is a [fh,fw] filter applied as a true convolution (flipped).
    """
    c = x.shape[1]
    px0, px1, py0, py1 = _parse_padding(padding)
    kernel = _taps(f, gain, x)
    x = _pad(_zero_insert(x, up), px0, px1, py0, py1)
    x = F.conv2d(x, kernel[None, None].expand(c, 1, *kernel.shape), groups=c)
    return x[:, :, ::down, ::down] if down > 1 else x


def upfirdn2d(x: torch.Tensor, f: torch.Tensor | None, up: int = 1, down: int = 1,
              padding=0, gain: float = 1.0) -> torch.Tensor:
    """K6a wrapper, same contract as :func:`upfirdn2d_plain`.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes fp32 NCHW ``x``, any small filter and ``up``, ``down`` of 1
    or 2, or raise.
    """
    if x.device.type == "cpu":
        return upfirdn2d_plain(x, f, up, down, padding, gain)
    name = "upfirdn2d"
    x = x.contiguous()
    kernels.require(name, "x", x)
    taps = _taps(f, gain, x).detach().contiguous()
    kernels.require(name, "f", taps)
    if x.dim() != 4 or taps.dim() != 2 or up not in (1, 2) or down not in (1, 2):
        raise ValueError(f"{name}: kernel takes x [B,C,H,W], a [fh,fw] filter and "
                         f"up, down in (1, 2); got x {tuple(x.shape)}, f {tuple(taps.shape)}, "
                         f"up {up}, down {down}")
    b, c, h, w = x.shape
    fh, fw = taps.shape
    px0, px1, py0, py1 = _parse_padding(padding)
    ho = (h * up + py0 + py1 - fh) // down + 1
    wo = (w * up + px0 + px1 - fw) // down + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"{name}: empty output {ho}x{wo}")
    y = torch.empty((b, c, ho, wo), device=x.device)
    kernels.launch("r3dp_upfirdn2d", x, taps, b * c, h, w, up, down, px0, py0, fh, fw,
                   ho, wo, y)
    upfirdn2d.launches += 1
    return y


upfirdn2d.launches = 0


def upsample2d(x: torch.Tensor, f: torch.Tensor, up: int = 2, padding=0,
               gain: float = 1.0) -> torch.Tensor:
    fh, fw = f.shape
    px0, px1, py0, py1 = _parse_padding(padding)
    return upfirdn2d(x, f, up=up, padding=(
        px0 + (fw + up - 1) // 2, px1 + (fw - up) // 2,
        py0 + (fh + up - 1) // 2, py1 + (fh - up) // 2,
    ), gain=gain * up * up)


def downsample2d(x: torch.Tensor, f: torch.Tensor, down: int = 2, padding=0,
                 gain: float = 1.0) -> torch.Tensor:
    fh, fw = f.shape
    px0, px1, py0, py1 = _parse_padding(padding)
    return upfirdn2d(x, f, down=down, padding=(
        px0 + (fw - down + 1) // 2, px1 + (fw - down) // 2,
        py0 + (fh - down + 1) // 2, py1 + (fh - down) // 2,
    ), gain=gain)


def conv2d_resample(x: torch.Tensor, w: torch.Tensor, f: torch.Tensor | None = None,
                    up: int = 1, down: int = 1, padding=0, groups: int = 1,
                    flip_weight: bool = True) -> torch.Tensor:
    """2D conv with optional up/downsampling; x [B,Cin,H,W], w OIHW.

    Padding is relative to the upsampled image and applied once. The
    up-path runs the conv on the zero-inserted input, then the FIR, the
    order the JAX package uses.
    """
    kh, kw = w.shape[-2:]
    fh, fw = (f.shape if f is not None else (1, 1))
    px0, px1, py0, py1 = _parse_padding(padding)
    if not flip_weight and (kh > 1 or kw > 1):
        w = torch.flip(w, (2, 3))
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    if up > 1:
        if kh > 1 or kw > 1:
            y = F.conv2d(_pad(_zero_insert(x, up), px0, px1, py0, py1), w, groups=groups)
            x = upfirdn2d(y, f, gain=up * up)
        else:
            x = upfirdn2d(x, f, up=up, padding=(px0, px1, py0, py1), gain=up * up)
            x = F.conv2d(x, w, groups=groups)
        if down > 1:
            x = upfirdn2d(x, f, down=down)
        return x
    if down > 1:
        x = upfirdn2d(x, f, padding=(px0, px1, py0, py1))
        return F.conv2d(x, w, stride=down, groups=groups)
    return F.conv2d(_pad(x, px0, px1, py0, py1), w, groups=groups)

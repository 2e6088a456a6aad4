"""Upsample-FIR-downsample resampling and resampling convolutions in plain
PyTorch (port of ``real3dportrait_tpu/ops/upfirdn2d.py``; a hand kernel for
the FIR is queued as K6).

Tensors here are NCHW and conv weights OIHW, PyTorch's own layouts; the
modules that call these convert from the port's NHWC public layout once.
Padding is applied to the upsampled image and negative padding crops, as
in the reference.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


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


def upfirdn2d(x: torch.Tensor, f: torch.Tensor | None, up: int = 1, down: int = 1,
              padding=0, gain: float = 1.0) -> torch.Tensor:
    """x [B,C,H,W] -> upsample(up), pad, FIR(f), downsample(down).

    ``f`` is a [fh,fw] filter applied as a true convolution (flipped).
    """
    c = x.shape[1]
    px0, px1, py0, py1 = _parse_padding(padding)
    if f is None:
        f = torch.ones((1, 1), dtype=x.dtype, device=x.device)
    x = _pad(_zero_insert(x, up), px0, px1, py0, py1)
    kernel = (torch.flip(f, (0, 1)) * gain).to(x.dtype)
    kernel = kernel[None, None].expand(c, 1, *f.shape)
    x = F.conv2d(x, kernel, groups=c)
    return x[:, :, ::down, ::down] if down > 1 else x


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

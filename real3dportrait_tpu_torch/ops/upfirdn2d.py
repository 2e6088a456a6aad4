"""Upsample-FIR-downsample resampling, resampling convolutions and kernel
K6a with its gradient (port of ``real3dportrait_tpu/ops/upfirdn2d.py``).

:func:`upfirdn2d` is the wrapper of kernel K6a
(``csrc/stylegan_epilogue.cu``), in fp32 or bf16; :func:`upfirdn2d_plain`
is its plain PyTorch version (zero insertion, pad/crop, depthwise
``F.conv2d``). In bf16 the taps are rounded to bf16, as the JAX package
casts them, and the sum is taken in fp32 and rounded once. The kernel's
taps (:func:`fir_taps`) and the rest of its arguments are computed on the
host once per filter tensor, gain, type, input shape and resampling
(:func:`_plan`), so a call launches nothing but the kernel.

On CUDA tensors :func:`upfirdn2d` is a
``torch.autograd.Function`` whose backward is K6a itself on the flipped
filter with ``up`` and ``down`` swapped and the adjoint padding
(:func:`upfirdn2d_backward`, StyleGAN2-ADA's design); the backward calls
the same Function, so R1's second derivative is K6a again.
:func:`upfirdn2d_backward_plain` is the adjoint's plain version.

Tensors here are NCHW and conv weights OIHW, PyTorch's own layouts; the
modules that call these convert from the port's NHWC public layout once.
Padding is applied to the upsampled image and negative padding crops, as
in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

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


@dataclass(frozen=True)
class FirTaps:
    """The kernel's taps of one (filter, gain, type): ``taps`` (= ``_taps``
    in fp32), whether they have rank 1, and the by-value launch argument."""

    taps: np.ndarray
    separable: bool
    arg: kernels.FirTaps


def fir_taps(f: torch.Tensor | None, gain: float, dtype: torch.dtype) -> FirTaps:
    """:func:`_taps` of ``f`` for activations of ``dtype`` as a host
    :class:`FirTaps` (one device-to-host copy of the filter). A rank-1
    filter (the path's ``[1,3,3,1]``) carries its factors for the kernel's
    staged tile at up 1, down 1; any other takes the general path there."""
    src = torch.ones((1, 1)) if f is None else f.detach().to("cpu", torch.float32)
    t = _taps(src, gain, torch.empty((), dtype=dtype)).float().numpy()
    if t.ndim != 2 or max(t.shape) > 8:
        raise ValueError(f"upfirdn2d: the kernel takes filters up to 8x8, got {t.shape}")
    # rank 1: factor on the first entry that is not small against the
    # largest, which keeps [1,3,3,1]'s factors exact
    big = np.abs(t).max()
    p, q = np.argwhere(np.abs(t) >= 1e-3 * big)[0] if big > 0 else (0, 0)
    u = t[:, q].copy()
    v = t[p, :] / t[p, q] if big > 0 else np.zeros(t.shape[1], np.float32)
    separable = bool(big > 0 and np.abs(np.outer(u, v) - t).max() <= 1e-6 * big)
    arg = kernels.FirTaps()
    arg.t[:t.size] = t.ravel().tolist()
    if separable:
        arg.u[:len(u)] = u.tolist()
        arg.v[:len(v)] = v.astype(np.float32).tolist()
    return FirTaps(t, separable, arg)


_IDENTITY_PLANS: dict = {}


def _plan(x: torch.Tensor, f: torch.Tensor | None, up: int, down: int, padding,
          gain: float) -> tuple[kernels.Upfirdn2dPlan, tuple[int, int, int, int]]:
    """The kernel's launch plan for ``x``'s shape and type and the output
    shape, built at the first such call and cached on the filter tensor,
    keyed by the tensor's version (an in-place change rebuilds it), so that
    a call launches nothing but the kernel and converts four arguments."""
    cache = _IDENTITY_PLANS if f is None else f.__dict__.setdefault("_k6a_plans", {})
    key = (None if f is None or f.is_inference() else f._version, gain, x.dtype, x.shape, up,
           down, padding if isinstance(padding, int) else tuple(padding))
    hit = cache.get(key)
    if hit is not None:
        return hit
    fir = fir_taps(f, gain, x.dtype)
    b, c, h, w = x.shape
    fh, fw = fir.taps.shape
    px0, px1, py0, py1 = _parse_padding(padding)
    ho = (h * up + py0 + py1 - fh) // down + 1
    wo = (w * up + px0 + px1 - fw) // down + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"upfirdn2d: empty output {ho}x{wo}")
    plan = kernels.Upfirdn2dPlan(fir.arg, fir.separable, b * c, h, w, up, down, px0, py0, fh,
                                 fw, ho, wo)
    cache[key] = plan, (b, c, ho, wo)
    return cache[key]


_ENTRY = {torch.float32: "r3dp_upfirdn2d", torch.bfloat16: "r3dp_upfirdn2d_bf16"}


def adjoint_padding(f: torch.Tensor | None, up: int, down: int, padding,
                    in_hw: tuple[int, int], out_hw: tuple[int, int]
                    ) -> tuple[int, int, int, int]:
    """The padding of the adjoint of ``upfirdn2d(., f, up, down, padding)``
    from ``in_hw`` to ``out_hw``: ``upfirdn2d(dy, flip(f), up=down,
    down=up, padding=adjoint_padding(...))`` maps an output gradient back to
    the input's shape (StyleGAN2-ADA's ``_upfirdn2d_cuda`` backward)."""
    fh, fw = (1, 1) if f is None else f.shape
    px0, _, py0, _ = _parse_padding(padding)
    (h, w), (ho, wo) = in_hw, out_hw
    return (fw - px0 - 1, w * up - wo * down + px0 - up + 1,
            fh - py0 - 1, h * up - ho * down + py0 - up + 1)


def _flipped(f: torch.Tensor | None) -> torch.Tensor | None:
    """``flip(f)``, cached on ``f`` by its version, so that the adjoint's
    launch plans are cached on one tensor too."""
    if f is None:
        return None
    key = None if f.is_inference() else f._version
    hit = f.__dict__.get("_k6a_flipped")
    if hit is None or hit[0] != key:
        hit = (key, torch.flip(f.detach(), (0, 1)))
        f.__dict__["_k6a_flipped"] = hit
    return hit[1]


def upfirdn2d_backward_plain(dy: torch.Tensor, f: torch.Tensor | None, up: int = 1,
                             down: int = 1, padding=0, gain: float = 1.0,
                             in_hw: tuple[int, int] | None = None) -> torch.Tensor:
    """Plain PyTorch K6a gradient: the gradient of :func:`upfirdn2d_plain`'s
    input of spatial size ``in_hw`` from its output's gradient ``dy``, as
    the adjoint FIR."""
    pads = adjoint_padding(f, up, down, padding, in_hw, tuple(dy.shape[-2:]))
    g = None if f is None else torch.flip(f, (0, 1))
    return upfirdn2d_plain(dy, g, up=down, down=up, padding=pads, gain=gain)


class _Upfirdn2d(torch.autograd.Function):
    """K6a on CUDA tensors; its gradient is K6a itself on the flipped filter
    (:func:`upfirdn2d_backward`), through this Function again, so every
    further derivative is K6a too. ``counter`` is the wrapper whose launch
    count the call adds to."""

    @staticmethod
    def forward(ctx, x, f, up, down, padding, gain, counter):
        name = "upfirdn2d"
        if x.dim() != 4 or up not in (1, 2) or down not in (1, 2):
            raise ValueError(f"{name}: kernel takes x [B,C,H,W] and up, down in (1, 2); got x "
                             f"{tuple(x.shape)}, up {up}, down {down}")
        x = x.contiguous()
        kernels.require(name, "x", x, (torch.float32, torch.bfloat16))
        plan, shape = _plan(x, f, up, down, padding, gain)
        y = x.new_empty(shape)
        kernels.launch(_ENTRY[x.dtype], x, plan, y)
        counter.launches += 1
        counter.launches_bf16 += x.dtype == torch.bfloat16
        ctx.f, ctx.args = f, (up, down, padding, gain, tuple(x.shape[-2:]))
        return y

    @staticmethod
    def backward(ctx, dy):
        return upfirdn2d_backward(dy, ctx.f, *ctx.args), None, None, None, None, None, None


def upfirdn2d(x: torch.Tensor, f: torch.Tensor | None, up: int = 1, down: int = 1,
              padding=0, gain: float = 1.0) -> torch.Tensor:
    """K6a wrapper, same contract as :func:`upfirdn2d_plain`.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes fp32 or bf16 NCHW ``x``, a filter up to 8x8 and ``up``,
    ``down`` of 1 or 2, or raise; the gradient is K6a's adjoint launch
    (:func:`upfirdn2d_backward`). ``upfirdn2d.launches`` counts every
    launch, ``launches_bf16`` the bf16 ones among them.
    """
    if x.device.type == "cpu":
        return upfirdn2d_plain(x, f, up, down, padding, gain)
    return _Upfirdn2d.apply(x, f, up, down, padding, gain, upfirdn2d)


upfirdn2d.launches = 0
upfirdn2d.launches_bf16 = 0


def upfirdn2d_backward(dy: torch.Tensor, f: torch.Tensor | None, up: int = 1,
                       down: int = 1, padding=0, gain: float = 1.0,
                       in_hw: tuple[int, int] | None = None) -> torch.Tensor:
    """K6a gradient wrapper, same contract as
    :func:`upfirdn2d_backward_plain`: K6a's own kernel on the flipped filter
    with ``up`` and ``down`` swapped and the adjoint padding. CPU tensors
    take the plain version. ``upfirdn2d_backward.launches`` counts its
    launches (those of the training step's backward passes, second
    derivatives included), ``launches_bf16`` the bf16 ones."""
    if dy.device.type == "cpu":
        return upfirdn2d_backward_plain(dy, f, up, down, padding, gain, in_hw)
    pads = adjoint_padding(f, up, down, padding, in_hw, tuple(dy.shape[-2:]))
    return _Upfirdn2d.apply(dy, _flipped(f), down, up, pads, gain, upfirdn2d_backward)


upfirdn2d_backward.launches = 0
upfirdn2d_backward.launches_bf16 = 0


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

"""Bias + activation (+gain, +clamp), the StyleGAN2 epilogue, and kernel K6b
with its gradient (port of ``real3dportrait_tpu/ops/bias_act.py`` with the
demodulation and noise tail of ``models/stylegan2.py:modulated_conv2d``).

:func:`bias_act` is the wrapper of kernel K6b (``csrc/stylegan_epilogue.cu``),
one fused pass of ``clamp(gain * act(x * scale + noise + b))`` in fp32 or
bf16; :func:`bias_act_plain` is its plain PyTorch version. ``scale``,
``noise`` and ``b`` are cast to ``x``'s dtype first, as the JAX package
casts them (the kernel rounds them as it loads them, so the wrapper
launches nothing but the kernel), and in bf16 every step rounds to bf16.

On CUDA tensors :func:`bias_act` is a ``torch.autograd.Function`` whose
backward is kernel K6b's gradient, :func:`bias_act_grad` (same source):
``dz = dy * gain * act'(y)``, zero where the clamp saturated, ``dx = dz *
scale`` and the sums ``db = sum dz``, ``dscale = sum_hw dz * x``, ``dnoise =
sum_bc dz`` in fp32. :func:`bias_act_grad_plain` is its plain version. For
the piecewise-linear activations the kernel takes, ``dx`` is linear in
``dy`` with a piecewise-constant factor, so the gradient of the gradient
(R1's double backward) is the same masked multiply: the same kernel again
(StyleGAN2-ADA's ``BiasActCudaGrad`` design). CPU tensors take the plain
forward, which autograd differentiates.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from real3dportrait_tpu_torch import kernels


class _Act(NamedTuple):
    fn: Callable
    def_gain: float


ACTIVATIONS: dict[str, _Act] = {
    "linear": _Act(lambda x: x, 1.0),
    "relu": _Act(F.relu, math.sqrt(2.0)),
    "lrelu": _Act(lambda x: F.leaky_relu(x, 0.2), math.sqrt(2.0)),
    "tanh": _Act(torch.tanh, 1.0),
    "sigmoid": _Act(torch.sigmoid, 1.0),
    "elu": _Act(F.elu, 1.0),
    "selu": _Act(F.selu, 1.0),
    "softplus": _Act(F.softplus, 1.0),
    "swish": _Act(F.silu, math.sqrt(2.0)),
}

# activation -> code of the CUDA kernel; the others run only in the plain version
KERNEL_ACTS = {"linear": 0, "relu": 1, "lrelu": 2}


def bias_act_plain(x: torch.Tensor, b: torch.Tensor | None = None, act: str = "linear",
                   gain: float | None = None, clamp: float | None = None, axis: int = -1,
                   scale: torch.Tensor | None = None,
                   noise: torch.Tensor | None = None) -> torch.Tensor:
    """y = clamp(gain * act(x * scale + noise + b)); ``b`` broadcasts along
    ``axis``. ``scale`` [B,C] (the demodulation coefficients) and ``noise``
    [H,W] apply to NCHW ``x`` only."""
    spec = ACTIVATIONS[act]
    if scale is not None:
        x = x * scale.to(x.dtype)[:, :, None, None]
    if noise is not None:
        x = x + noise.to(x.dtype)
    if b is not None:
        shape = [1] * x.dim()
        shape[axis] = b.shape[0]
        x = x + b.reshape(shape).to(x.dtype)
    x = spec.fn(x)
    g = spec.def_gain if gain is None else gain
    if g != 1.0:
        x = x * g
    if clamp is not None and clamp >= 0:
        x = torch.clamp(x, -clamp, clamp)
    return x


def _aux(name: str, t: torch.Tensor | None, shape: tuple, dtype: torch.dtype
         ) -> torch.Tensor | None:
    """An fp32 term of the kernel as it comes (the kernel rounds it to
    ``dtype``); another dtype takes ``dtype``'s values first, as the plain
    version casts it."""
    if t is None:
        return None
    t = t.detach()
    if t.dtype != torch.float32:
        t = t.to(dtype).float()
    t = t.contiguous()
    kernels.require("bias_act", name, t)
    if tuple(t.shape) != shape:
        raise ValueError(f"bias_act: {name} must be {shape}, got {tuple(t.shape)}")
    return t


def _layout(x: torch.Tensor, axis: int, scale, noise) -> tuple[int, int, int]:
    """(rows' batch, channels, elements a row) of what the kernel takes:
    NCHW ``x`` with ``axis=1`` or [N,C] ``x`` with the channel axis last."""
    if x.dim() == 4 and axis in (1, -3):
        bsz, c, h, w = x.shape
        return bsz, c, h * w
    if x.dim() == 2 and axis in (1, -1) and scale is None and noise is None:
        return x.shape[0], x.shape[1], 1
    raise ValueError(f"bias_act: kernel takes NCHW x with axis=1 or [N,C] x with "
                     f"axis=-1; got {tuple(x.shape)}, axis {axis}")


def _act_slope(y: torch.Tensor, act: str, gain: float, clamp: float | None) -> torch.Tensor:
    """``gain * act'`` at the output ``y`` in fp32, 0 where the clamp
    saturated (the clamp bound rounded to ``y``'s dtype, as the forward
    rounds it)."""
    f32 = dict(dtype=torch.float32)
    one = torch.ones_like(y, **f32)
    if act == "relu":
        one = torch.where(y > 0, one, torch.zeros_like(y, **f32))
    elif act == "lrelu":
        one = torch.where(y > 0, one, torch.full_like(y, 0.2, **f32))
    slope = one * gain
    if clamp is not None and clamp >= 0:
        bound = torch.tensor(clamp, dtype=y.dtype).float()
        slope = torch.where(y.float().abs() < bound, slope, torch.zeros_like(slope))
    return slope


def bias_act_grad_plain(dy: torch.Tensor, y: torch.Tensor, x: torch.Tensor | None = None,
                        act: str = "linear", gain: float | None = None,
                        clamp: float | None = None, axis: int = -1,
                        scale: torch.Tensor | None = None, need_b: bool = True,
                        need_scale: bool = True, need_noise: bool = False) -> tuple:
    """Plain PyTorch K6b gradient: the output ``y`` and its gradient ``dy``
    -> ``(dx, db [C] or None, dscale [B,C] or None, dnoise [H,W] or None)``,
    the sums in fp32. ``db`` is computed where ``need_b``; ``dscale`` where
    ``scale`` is given and ``need_scale``, from ``x`` (the input before
    ``scale``); ``dnoise`` (NCHW only) where ``need_noise``."""
    g = ACTIVATIONS[act].def_gain if gain is None else gain
    dz = dy.float() * _act_slope(y, act, g, clamp)
    dims = [d for d in range(dy.dim()) if d != axis % dy.dim()]
    db = dz.sum(dim=dims) if need_b else None
    dscale = dnoise = None
    if scale is not None:
        if need_scale:
            dscale = (dz * x.float()).sum(dim=(2, 3))
        dz_x = dz * scale.to(dy.dtype).float()[:, :, None, None]
    else:
        dz_x = dz
    if need_noise:
        dnoise = dz.sum(dim=(0, 1))
    return dz_x.to(dy.dtype), db, dscale, dnoise


class _BiasActGrad(torch.autograd.Function):
    """K6b's gradient as a function of ``dy``; its own gradient (the double
    backward of R1) is the same masked multiply, through the same kernel."""

    @staticmethod
    def forward(ctx, dy, y, x, scale, act, gain, clamp, axis, need_b, need_scale, need_noise):
        ctx.save_for_backward(y)
        ctx.args = (act, gain, clamp, axis)
        ctx.has_terms = scale is not None or need_noise
        return bias_act_grad(dy, y, x, act, gain, clamp, axis, scale, need_b, need_scale,
                             need_noise)

    @staticmethod
    def backward(ctx, ddx, ddb, ddscale, ddnoise):
        if ctx.has_terms:
            raise RuntimeError("bias_act: no second derivative through the fused "
                               "demodulation scale or noise")
        (y,) = ctx.saved_tensors
        act, gain, clamp, axis = ctx.args
        u = torch.zeros_like(y) if ddx is None else ddx
        if ddb is not None:
            shape = [1] * y.dim()
            shape[axis] = ddb.shape[0]
            u = u + ddb.reshape(shape).to(u.dtype)
        ddy = _BiasActGrad.apply(u, y, None, None, act, gain, clamp, axis, False, False,
                                 False)[0]
        return (ddy,) + (None,) * 10


class _BiasAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, b, scale, noise, act, gain, clamp, axis):
        name = "bias_act"
        if act not in KERNEL_ACTS:
            raise ValueError(f"{name}: the kernel takes {sorted(KERNEL_ACTS)}, got {act!r}")
        x = x.contiguous()
        kernels.require(name, "x", x, (torch.float32, torch.bfloat16))
        bsz, c, hw = _layout(x, axis, scale, noise)
        h, w = (x.shape[2], x.shape[3]) if x.dim() == 4 else (1, 1)
        y = torch.empty_like(x)
        bf16 = x.dtype == torch.bfloat16
        kernels.launch("r3dp_bias_act_bf16" if bf16 else "r3dp_bias_act", x,
                       _aux("scale", scale, (bsz, c), x.dtype),
                       _aux("noise", noise, (h, w), x.dtype), _aux("b", b, (c,), x.dtype),
                       x.numel(), c, hw, KERNEL_ACTS[act], float(gain),
                       -1.0 if clamp is None else float(clamp), y)
        bias_act.launches += 1
        bias_act.launches_bf16 += bf16
        keep_x = scale is not None and ctx.needs_input_grad[2]
        ctx.save_for_backward(y, x if keep_x else None, scale)
        ctx.args = (act, gain, clamp, axis)
        return y

    @staticmethod
    def backward(ctx, dy):
        y, x, scale = ctx.saved_tensors
        act, gain, clamp, axis = ctx.args
        need_b, need_scale, need_noise = ctx.needs_input_grad[1:4]
        dx, db, dscale, dnoise = _BiasActGrad.apply(
            dy.contiguous(), y, x, scale, act, gain, clamp, axis, need_b, need_scale,
            need_noise)
        return dx, db, dscale, dnoise, None, None, None, None


def bias_act(x: torch.Tensor, b: torch.Tensor | None = None, act: str = "linear",
             gain: float | None = None, clamp: float | None = None, axis: int = -1,
             scale: torch.Tensor | None = None,
             noise: torch.Tensor | None = None) -> torch.Tensor:
    """K6b wrapper, same contract as :func:`bias_act_plain`.

    CPU tensors take the plain version. CUDA tensors launch the kernel,
    which takes fp32 or bf16 NCHW ``x`` with ``axis=1`` or [N,C] ``x`` with
    the channel axis last, and a linear, relu or lrelu activation, or
    raise; gradients reach ``x``, ``b``, ``scale`` and ``noise`` through
    :func:`bias_act_grad`. ``bias_act.launches`` counts every launch,
    ``launches_bf16`` the bf16 ones among them.
    """
    if x.device.type == "cpu":
        return bias_act_plain(x, b, act, gain, clamp, axis, scale, noise)
    g = ACTIVATIONS[act].def_gain if gain is None else gain
    return _BiasAct.apply(x, b, scale, noise, act, g, clamp, axis)


bias_act.launches = 0
bias_act.launches_bf16 = 0


def bias_act_grad(dy: torch.Tensor, y: torch.Tensor, x: torch.Tensor | None = None,
                  act: str = "linear", gain: float | None = None,
                  clamp: float | None = None, axis: int = -1,
                  scale: torch.Tensor | None = None, need_b: bool = True,
                  need_scale: bool = True, need_noise: bool = False) -> tuple:
    """K6b gradient wrapper, same contract as :func:`bias_act_grad_plain`.

    CPU tensors take the plain version; CUDA tensors launch the gradient
    kernel (fp32 or bf16 ``dy``, ``y`` and ``x``, fp32 sums) or raise.
    ``bias_act_grad.launches`` counts every launch, ``launches_bf16`` the
    bf16 ones among them.
    """
    g = ACTIVATIONS[act].def_gain if gain is None else gain
    if dy.device.type == "cpu":
        return bias_act_grad_plain(dy, y, x, act, g, clamp, axis, scale, need_b, need_scale,
                                   need_noise)
    name = "bias_act_grad"
    if act not in KERNEL_ACTS:
        raise ValueError(f"{name}: the kernel takes {sorted(KERNEL_ACTS)}, got {act!r}")
    dy, y = dy.contiguous(), y.contiguous()
    kernels.require(name, "dy", dy, (torch.float32, torch.bfloat16))
    kernels.require(name, "y", y, dy.dtype)
    if y.shape != dy.shape:
        raise ValueError(f"{name}: y {tuple(y.shape)} and dy {tuple(dy.shape)} differ")
    bsz, c, hw = _layout(dy, axis, scale, None)
    if need_noise and dy.dim() != 4:
        raise ValueError(f"{name}: a noise gradient needs NCHW dy")
    need_scale = need_scale and scale is not None
    if need_scale:
        if x is None:
            raise ValueError(f"{name}: the scale gradient needs x")
        x = x.contiguous()
        kernels.require(name, "x", x, dy.dtype)
        if x.shape != dy.shape:
            raise ValueError(f"{name}: x {tuple(x.shape)} and dy {tuple(dy.shape)} differ")
    else:
        x = None
    scale = _aux("scale", scale, (bsz, c), dy.dtype)
    f32 = dict(dtype=torch.float32, device=dy.device)
    dx = torch.empty_like(dy)
    db = torch.zeros((c,), **f32) if need_b else None
    dscale = torch.zeros((bsz, c), **f32) if need_scale else None
    dnoise = torch.zeros(tuple(dy.shape[2:]), **f32) if need_noise else None
    bf16 = dy.dtype == torch.bfloat16
    kernels.launch("r3dp_bias_act_grad_bf16" if bf16 else "r3dp_bias_act_grad", dy, y, x,
                   scale, dy.numel(), c, hw, KERNEL_ACTS[act], float(g),
                   -1.0 if clamp is None else float(clamp), dx, db, dscale, dnoise)
    bias_act_grad.launches += 1
    bias_act_grad.launches_bf16 += bf16
    return dx, db, dscale, dnoise


bias_act_grad.launches = 0
bias_act_grad.launches_bf16 = 0

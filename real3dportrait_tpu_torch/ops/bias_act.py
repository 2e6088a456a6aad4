"""Bias + activation (+gain, +clamp), the StyleGAN2 epilogue, and kernel K6b
(port of ``real3dportrait_tpu/ops/bias_act.py`` with the demodulation and
noise tail of ``models/stylegan2.py:modulated_conv2d``).

:func:`bias_act` is the wrapper of kernel K6b (``csrc/stylegan_epilogue.cu``),
one fused pass of ``clamp(gain * act(x * scale + noise + b))``;
:func:`bias_act_plain` is its plain PyTorch version.
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
        x = x * scale[:, :, None, None]
    if noise is not None:
        x = x + noise
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


def bias_act(x: torch.Tensor, b: torch.Tensor | None = None, act: str = "linear",
             gain: float | None = None, clamp: float | None = None, axis: int = -1,
             scale: torch.Tensor | None = None,
             noise: torch.Tensor | None = None) -> torch.Tensor:
    """K6b wrapper, same contract as :func:`bias_act_plain`.

    CPU tensors take the plain version. CUDA tensors launch the kernel,
    which takes fp32 NCHW ``x`` with ``axis=1`` or [N,C] ``x`` with the
    channel axis last, and a linear, relu or lrelu activation, or raise.
    """
    if x.device.type == "cpu":
        return bias_act_plain(x, b, act, gain, clamp, axis, scale, noise)
    name = "bias_act"
    if act not in KERNEL_ACTS:
        raise ValueError(f"{name}: the kernel takes {sorted(KERNEL_ACTS)}, got {act!r}")
    x = x.contiguous()
    kernels.require(name, "x", x)
    if x.dim() == 4 and axis in (1, -3):
        bsz, c, h, w = x.shape
    elif x.dim() == 2 and axis in (1, -1) and scale is None and noise is None:
        (bsz, c), h, w = x.shape, 1, 1
    else:
        raise ValueError(f"{name}: kernel takes NCHW x with axis=1 or [N,C] x with "
                         f"axis=-1; got {tuple(x.shape)}, axis {axis}")
    extras = []
    for arg, t, shape in (("b", b, (c,)), ("scale", scale, (bsz, c)), ("noise", noise, (h, w))):
        if t is not None:
            t = t.detach().to(torch.float32).contiguous()
            kernels.require(name, arg, t)
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: {arg} must be {shape}, got {tuple(t.shape)}")
        extras.append(t)
    b, scale, noise = extras
    g = ACTIVATIONS[act].def_gain if gain is None else gain
    y = torch.empty_like(x)
    kernels.launch("r3dp_bias_act", x, scale, noise, b, x.numel(), c, h * w,
                   KERNEL_ACTS[act], float(g), -1.0 if clamp is None else float(clamp), y)
    bias_act.launches += 1
    return y


bias_act.launches = 0

"""Bias + activation (+gain, +clamp), the StyleGAN2 epilogue, in plain
PyTorch (port of ``real3dportrait_tpu/ops/bias_act.py``; a fused kernel for
it is queued as K6)."""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F


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


def bias_act(x: torch.Tensor, b: torch.Tensor | None = None, act: str = "linear",
             gain: float | None = None, clamp: float | None = None,
             axis: int = -1) -> torch.Tensor:
    """y = clamp(gain * act(x + b)); ``b`` broadcasts along ``axis``."""
    spec = ACTIVATIONS[act]
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

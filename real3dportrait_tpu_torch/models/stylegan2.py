"""StyleGAN2 synthesis building blocks (port of the synthesis side of
``real3dportrait_tpu/models/stylegan2.py``).

Parameter names and shapes follow the reference torch modules (which the
JAX tree reuses): dense weights [out, in], conv weights OIHW. Modulated
convolution uses the activation-scaling form (``fused_modconv=False``).
The blocks run fp32; the reference's fp16 layers are not ported (the
released configuration uses none in its SR head).

Internally the convolutions run NCHW; :class:`SynthesisBlock.forward` keeps
the port's NHWC public layout.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn

from real3dportrait_tpu_torch.ops.bias_act import ACTIVATIONS, bias_act
from real3dportrait_tpu_torch.ops.upfirdn2d import conv2d_resample, setup_filter, upsample2d


def modulated_conv2d(x: torch.Tensor, weight: torch.Tensor, styles: torch.Tensor,
                     up: int = 1, down: int = 1, padding: int = 0,
                     resample_filter: torch.Tensor | None = None,
                     demodulate: bool = True) -> tuple[torch.Tensor, torch.Tensor | None]:
    """x [B,Cin,H,W], weight OIHW [Cout,Cin,kh,kw], styles [B,Cin] ->
    (convolution [B,Cout,H',W'] before demodulation, coefficients d
    [B,Cout] or None).

    The demodulation multiply and the noise add of the reference run in
    the fused epilogue, ``bias_act(..., scale=d, noise=...)`` (kernel K6b).
    """
    x = x * styles[:, :, None, None]
    x = conv2d_resample(x, weight, f=resample_filter, up=up, down=down,
                        padding=padding, flip_weight=(up == 1))
    d = None
    if demodulate:
        w_sq = weight.square().sum(dim=(2, 3))                     # [Cout,Cin]
        d = torch.rsqrt(styles.square() @ w_sq.T + 1e-8)            # [B,Cout]
    return x, d


class FullyConnectedLayer(nn.Module):
    """Equalized-LR dense layer; ``weight`` [out, in]."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 activation: str = "linear", lr_multiplier: float = 1.0,
                 bias_init: float = 0.0):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.bias_init = bias_init
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self.reset_parameters()

    @property
    def weight_gain(self) -> float:
        return self.lr_multiplier / math.sqrt(self.in_features)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            self.weight.normal_(generator=generator).div_(self.lr_multiplier)
            if self.bias is not None:
                self.bias.fill_(self.bias_init)

    def folded(self) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(weight, bias) with the equalized-LR gains applied."""
        b = self.bias * self.lr_multiplier if self.bias is not None else None
        return self.weight * self.weight_gain, b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.folded()
        return bias_act(x @ w.T, b, act=self.activation)


class Conv2dLayer(nn.Module):
    """Plain (non-modulated) equalized-LR conv; the resampling and clamp
    options of the reference layer have no caller on the port's path."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 bias: bool = True, activation: str = "linear"):
        super().__init__()
        self.activation = activation
        self.padding = kernel_size // 2
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            self.weight.normal_(generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B,Cin,H,W] -> [B,Cout,H,W]."""
        x = conv2d_resample(x, self.weight * self.weight_gain, padding=self.padding)
        return bias_act(x, self.bias, act=self.activation, axis=1)


class SynthesisLayer(nn.Module):
    """Modulated conv + noise + bias/act."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 resolution: int, kernel_size: int = 3, up: int = 1,
                 use_noise: bool = True, activation: str = "lrelu",
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: float | None = 256.0):
        super().__init__()
        self.resolution, self.up, self.use_noise = resolution, up, use_noise
        self.activation, self.conv_clamp = activation, conv_clamp
        self.padding = kernel_size // 2
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        if use_noise:
            self.noise_strength = nn.Parameter(torch.zeros(()))
            self.register_buffer("noise_const", torch.empty(resolution, resolution))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.register_buffer("resample_filter", setup_filter(resample_filter),
                             persistent=False)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            self.affine.reset_parameters(generator)
            self.weight.normal_(generator=generator)
            if self.use_noise:
                self.noise_strength.zero_()
                self.noise_const.normal_(generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor, w: torch.Tensor, noise_mode: str = "none",
                gain: float = 1.0) -> torch.Tensor:
        """x [B,Cin,H,W], w [B,w_dim] -> [B,Cout,H*up,W*up].

        ``noise_mode`` is ``"none"`` (inference) or ``"const"``; per-call
        random noise is a training option and not ported.
        """
        if noise_mode not in ("const", "none"):
            raise ValueError(f"noise_mode {noise_mode!r}: only 'const' and 'none'")
        styles = self.affine(w)
        noise = None
        if self.use_noise and noise_mode == "const":
            noise = self.noise_const * self.noise_strength
        f = self.resample_filter if self.up > 1 else None
        x, d = modulated_conv2d(x, self.weight, styles, up=self.up,
                                padding=self.padding, resample_filter=f)
        act_gain = ACTIVATIONS[self.activation].def_gain * gain
        clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias, act=self.activation, gain=act_gain,
                        clamp=clamp, axis=1, scale=d, noise=noise)


class ToRGBLayer(nn.Module):
    """Modulated 1x1 projection to image channels (no demodulation)."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 kernel_size: int = 1, conv_clamp: float | None = 256.0):
        super().__init__()
        self.conv_clamp = conv_clamp
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            self.affine.reset_parameters(generator)
            self.weight.normal_(generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        styles = self.affine(w) * self.weight_gain
        x, _ = modulated_conv2d(x, self.weight, styles, demodulate=False)
        return bias_act(x, self.bias, clamp=self.conv_clamp, axis=1)


class SynthesisBlock(nn.Module):
    """One resolution level: up-conv0 + conv1 + skip toRGB.

    ``ws`` [B, 3, w_dim]: conv0 and conv1 take the first two latents, toRGB
    the third. Only blocks with an input (``in_channels > 0``) are ported.
    """

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 resolution: int, img_channels: int, is_last: bool,
                 architecture: str = "skip",
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: float | None = 256.0, use_fp16: bool = False, up: int = 2):
        super().__init__()
        if in_channels == 0 or use_fp16:
            raise NotImplementedError(
                "SynthesisBlock: const-input and fp16 blocks are not ported "
                "(ROADMAP queue 1, training slice)")
        self.up, self.is_last, self.architecture = up, is_last, architecture
        self.conv0 = SynthesisLayer(in_channels, out_channels, w_dim, resolution,
                                    up=up, resample_filter=resample_filter,
                                    conv_clamp=conv_clamp)
        self.conv1 = SynthesisLayer(out_channels, out_channels, w_dim, resolution,
                                    conv_clamp=conv_clamp)
        if is_last or architecture == "skip":
            self.torgb = ToRGBLayer(out_channels, img_channels, w_dim,
                                    conv_clamp=conv_clamp)
        self.register_buffer("resample_filter", setup_filter(resample_filter),
                             persistent=False)

    def forward_nchw(self, x: torch.Tensor, img: torch.Tensor | None,
                     ws: torch.Tensor, noise_mode: str = "none"
                     ) -> tuple[torch.Tensor, torch.Tensor | None]:
        x = self.conv0(x, ws[:, 0], noise_mode=noise_mode)
        x = self.conv1(x, ws[:, 1], noise_mode=noise_mode)
        if img is not None and self.up > 1:
            img = upsample2d(img, self.resample_filter, up=self.up)
        if self.is_last or self.architecture == "skip":
            y = self.torgb(x, ws[:, 2])
            img = img + y if img is not None else y
        return x, img

    def forward(self, x: torch.Tensor, img: torch.Tensor | None, ws: torch.Tensor,
                noise_mode: str = "none") -> tuple[torch.Tensor, torch.Tensor | None]:
        """x [B,H,W,Cin], img [B,H,W,3] or None (NHWC) -> (x, img) NHWC."""
        x, img = self.forward_nchw(
            x.permute(0, 3, 1, 2), None if img is None else img.permute(0, 3, 1, 2),
            ws, noise_mode)
        return x.permute(0, 2, 3, 1), None if img is None else img.permute(0, 2, 3, 1)

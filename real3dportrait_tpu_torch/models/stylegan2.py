"""StyleGAN2 (port of ``real3dportrait_tpu/models/stylegan2.py``): the
synthesis side of the SR heads and of the EG3D tri-plane generator
(``SynthesisBlock`` with or without a constant input, ``SynthesisNetwork``,
``MappingNetwork`` with latents, its w average and truncation), the
discriminator side of the dual discriminator (``MappingNetwork`` without
latents, ``MinibatchStdLayer``, ``DiscriminatorBlock``,
``DiscriminatorEpilogue``), and the whole ``Generator`` (mapping plus
synthesis) and conditional ``Discriminator``.

Noise modes: ``"none"``, ``"const"`` (each layer's buffer ``noise_const``)
and ``"random"`` (a fresh [B,H,W] normal plane per layer and call, drawn
from the ``draws`` object the caller passes, ``utils/draws.py``, in the
JAX package's shape [B,H,W,1] and order, so that a test replays JAX's
draws). The port's blocks default to ``"none"``, the mode its SR heads run;
the JAX package's default ``"random"`` is the default of ``Generator``
alone.

Parameter names and shapes follow the reference torch modules (which the
JAX tree reuses): dense weights [out, in], conv weights OIHW. Modulated
convolution uses the activation-scaling form (``fused_modconv=False``).
Blocks flagged ``use_fp16`` (the reference's fp16 resolutions) run their
activations in bf16, as the JAX package does; parameters stay fp32, the
demodulation coefficients are computed in fp32 and the toRGB output joins
the fp32 skip image.

Internally the convolutions run NCHW; :class:`SynthesisBlock.forward` keeps
the port's NHWC public layout. The epilogue's ``fc`` weight takes its input
flattened in the JAX package's (H, W, C) order, the order its tree holds
(the port's ``tools/convert_torch_ckpt.py:convert_stylegan2_discriminator`` permutes
the reference's (C, H, W) weight into it).
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

    The convolution runs in ``x``'s dtype. In bf16 (or fp16) the weight and
    styles are first normalised by their largest magnitudes, against
    overflow, and ``d`` is computed in fp32 from the normalised values. The
    demodulation multiply and the noise add of the reference run in the
    fused epilogue, ``bias_act(..., scale=d, noise=...)`` (kernel K6b),
    which casts ``d`` and the noise to ``x``'s dtype.
    """
    dtype = x.dtype
    if dtype in (torch.float16, torch.bfloat16) and demodulate:
        cout, cin, kh, kw = weight.shape
        w_norm = weight.abs().amax(dim=(1, 2, 3), keepdim=True)
        weight = weight * (1.0 / math.sqrt(cin * kh * kw) / (w_norm + 1e-12))
        styles = styles / (styles.abs().amax(dim=1, keepdim=True) + 1e-12)
    x = x * styles.to(dtype)[:, :, None, None]
    x = conv2d_resample(x, weight.to(dtype), f=resample_filter, up=up, down=down,
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
    """Plain (non-modulated) equalized-LR conv with optional resampling
    (``up`` / ``down`` through ``conv2d_resample``: kernel K6a and a
    convolution), bias, activation, gain and clamp (kernel K6b). The
    weight is cast to the activations' dtype, as the JAX package casts
    it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 bias: bool = True, activation: str = "linear", up: int = 1, down: int = 1,
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: float | None = None):
        super().__init__()
        self.activation, self.up, self.down, self.conv_clamp = activation, up, down, conv_clamp
        self.padding = kernel_size // 2
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.register_buffer("resample_filter", setup_filter(resample_filter)
                             if up > 1 or down > 1 else None, persistent=False)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            self.weight.normal_(generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
        """x [B,Cin,H,W] -> [B,Cout,H*up/down,W*up/down]."""
        w = (self.weight * self.weight_gain).to(x.dtype)
        x = conv2d_resample(x, w, f=self.resample_filter, up=self.up, down=self.down,
                            padding=self.padding, flip_weight=(self.up == 1))
        act_gain = ACTIVATIONS[self.activation].def_gain * gain
        clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias, act=self.activation, gain=act_gain, clamp=clamp, axis=1)


class SynthesisLayer(nn.Module):
    """Modulated conv + noise + bias/act, with activations in ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 resolution: int, kernel_size: int = 3, up: int = 1,
                 use_noise: bool = True, activation: str = "lrelu",
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: float | None = 256.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
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
                gain: float = 1.0, draws=None) -> torch.Tensor:
        """x [B,Cin,H,W], w [B,w_dim] -> [B,Cout,H*up,W*up].

        ``noise_mode`` ``"none"``, ``"const"`` (the buffer, [H,W], shared by
        the batch) or ``"random"`` (a [B,H,W] normal plane from ``draws``,
        reaching kernel K6b by a batch stride).
        """
        if noise_mode not in ("random", "const", "none"):
            raise ValueError(f"noise_mode {noise_mode!r}: 'random', 'const' or 'none'")
        styles = self.affine(w)
        noise = None
        if self.use_noise and noise_mode == "const":
            noise = self.noise_const * self.noise_strength
        elif self.use_noise and noise_mode == "random":
            if draws is None:
                raise ValueError("noise_mode 'random' needs draws")
            r = self.resolution
            noise = draws.normal((x.shape[0], r, r, 1), x.device).reshape(-1, r, r) \
                * self.noise_strength
        f = self.resample_filter if self.up > 1 else None
        x, d = modulated_conv2d(x.to(self.dtype), self.weight, styles, up=self.up,
                                padding=self.padding, resample_filter=f)
        act_gain = ACTIVATIONS[self.activation].def_gain * gain
        clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias, act=self.activation, gain=act_gain,
                        clamp=clamp, axis=1, scale=d, noise=noise)


class ToRGBLayer(nn.Module):
    """Modulated 1x1 projection to image channels (no demodulation), with
    activations in ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 kernel_size: int = 1, conv_clamp: float | None = 256.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_clamp, self.dtype = conv_clamp, dtype
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
        x, _ = modulated_conv2d(x.to(self.dtype), self.weight, styles, demodulate=False)
        return bias_act(x, self.bias, clamp=self.conv_clamp, axis=1)


class SynthesisBlock(nn.Module):
    """One resolution level: (up-)conv0 + conv1 + skip toRGB.

    With an input (``in_channels > 0``), ``ws`` [B, 3, w_dim]: conv0 and
    conv1 take the first two latents, toRGB the third. A first block
    (``in_channels == 0``) starts from the learned constant ``const``
    [C, res, res] (the JAX tree's [res, res, C]) and has conv1 alone: ``ws``
    [B, 2, w_dim]. ``use_fp16`` runs the block's activations in bf16; ``x``
    leaves the block in that dtype and the image in fp32.
    """

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 resolution: int, img_channels: int, is_last: bool,
                 architecture: str = "skip",
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: float | None = 256.0, use_fp16: bool = False, up: int = 2):
        super().__init__()
        self.up, self.is_last, self.architecture = up, is_last, architecture
        self.in_channels = in_channels
        self.dtype = torch.bfloat16 if use_fp16 else torch.float32
        if in_channels == 0:
            self.const = nn.Parameter(torch.empty(out_channels, resolution, resolution))
            self.reset_parameters()
        else:
            self.conv0 = SynthesisLayer(in_channels, out_channels, w_dim, resolution,
                                        up=up, resample_filter=resample_filter,
                                        conv_clamp=conv_clamp, dtype=self.dtype)
        self.conv1 = SynthesisLayer(out_channels, out_channels, w_dim, resolution,
                                    conv_clamp=conv_clamp, dtype=self.dtype)
        if is_last or architecture == "skip":
            self.torgb = ToRGBLayer(out_channels, img_channels, w_dim,
                                    conv_clamp=conv_clamp, dtype=self.dtype)
        self.register_buffer("resample_filter", setup_filter(resample_filter),
                             persistent=False)

    @property
    def num_conv(self) -> int:
        return 1 if self.in_channels == 0 else 2

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The constant's N(0, 1) draw (the layers reset their own)."""
        with torch.no_grad():
            self.const.normal_(generator=generator)

    def forward_nchw(self, x: torch.Tensor | None, img: torch.Tensor | None,
                     ws: torch.Tensor, noise_mode: str = "none", draws=None
                     ) -> tuple[torch.Tensor, torch.Tensor | None]:
        if self.in_channels == 0:
            x = self.const[None].expand(ws.shape[0], -1, -1, -1).to(self.dtype)
        else:
            x = self.conv0(x, ws[:, 0], noise_mode=noise_mode, draws=draws)
        x = self.conv1(x, ws[:, self.num_conv - 1], noise_mode=noise_mode, draws=draws)
        if img is not None and self.up > 1:
            img = upsample2d(img, self.resample_filter, up=self.up)
        if self.is_last or self.architecture == "skip":
            y = self.torgb(x, ws[:, self.num_conv]).float()
            img = img + y if img is not None else y
        return x, img

    def forward(self, x: torch.Tensor | None, img: torch.Tensor | None, ws: torch.Tensor,
                noise_mode: str = "none", draws=None
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """x [B,H,W,Cin] (None for a first block), img [B,H,W,3] or None
        (NHWC) -> (x, img) NHWC."""
        x, img = self.forward_nchw(
            None if x is None else x.permute(0, 3, 1, 2),
            None if img is None else img.permute(0, 3, 1, 2), ws, noise_mode, draws)
        return x.permute(0, 2, 3, 1), None if img is None else img.permute(0, 2, 3, 1)


class SynthesisNetwork(nn.Module):
    """The progressive synthesis stack, 4^2 -> ``img_resolution``: blocks
    ``b4``, ``b8``, ... with ``min(channel_base // res, channel_max)``
    channels, the first from a constant; block i takes ``ws[:, w : w +
    num_conv + 1]`` and the next starts ``num_conv`` on (each toRGB shares
    its latent with the next block's first conv); the last
    ``num_fp16_res`` resolutions (not below 8^2) in bf16."""

    def __init__(self, w_dim: int, img_resolution: int, img_channels: int,
                 channel_base: int = 32768, channel_max: int = 512, num_fp16_res: int = 0,
                 conv_clamp: float | None = 256.0):
        super().__init__()
        self.img_resolution = img_resolution
        self.block_resolutions = [2 ** i for i in range(2, int(math.log2(img_resolution)) + 1)]
        fp16_resolution = max(2 ** (int(math.log2(img_resolution)) + 1 - num_fp16_res), 8)

        def channels(res: int) -> int:
            return min(channel_base // res, channel_max)

        for res in self.block_resolutions:
            setattr(self, f"b{res}", SynthesisBlock(
                channels(res // 2) if res > 4 else 0, channels(res), w_dim=w_dim,
                resolution=res, img_channels=img_channels, is_last=res == img_resolution,
                conv_clamp=conv_clamp, use_fp16=num_fp16_res > 0 and res >= fp16_resolution))
        self.num_ws = sum(1 if res == 4 else 2 for res in self.block_resolutions) + 1

    def forward_nchw(self, ws: torch.Tensor, noise_mode: str = "none",
                     draws=None) -> torch.Tensor:
        """ws [B, num_ws, w_dim] -> the image [B, img_channels, res, res] (fp32)."""
        x = img = None
        w_idx = 0
        for res in self.block_resolutions:
            block = getattr(self, f"b{res}")
            x, img = block.forward_nchw(x, img, ws[:, w_idx:w_idx + block.num_conv + 1],
                                        noise_mode=noise_mode, draws=draws)
            w_idx += block.num_conv
        return img

    def forward(self, ws: torch.Tensor, noise_mode: str = "none",
                draws=None) -> torch.Tensor:
        """ws [B, num_ws, w_dim] -> the image [B, res, res, img_channels] (NHWC)."""
        return self.forward_nchw(ws, noise_mode, draws).permute(0, 2, 3, 1)


def normalize_2nd_moment(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


class MappingNetwork(nn.Module):
    """z and / or c -> w: the latent normalised, the conditioning embedded
    and normalised, the two concatenated (z first), then ``num_layers``
    lrelu layers at ``lr_multiplier``. Without latents (``z_dim = 0``, the
    dual discriminator's use) it maps c alone. With ``num_ws`` the result
    is repeated to [B, num_ws, w_dim] and the buffer ``w_avg`` (the JAX
    tree's ``ema`` collection) tracks its mean: ``update_emas`` moves it by
    ``w_avg_beta``, and ``truncation_psi`` pulls w toward it (the first
    ``truncation_cutoff`` latents only, where given)."""

    def __init__(self, c_dim: int, w_dim: int, num_layers: int = 8,
                 embed_features: int | None = None, activation: str = "lrelu",
                 lr_multiplier: float = 0.01, z_dim: int = 0, num_ws: int | None = None,
                 w_avg_beta: float | None = 0.998):
        super().__init__()
        embed = embed_features or w_dim
        self.z_dim, self.c_dim, self.num_layers = z_dim, c_dim, num_layers
        self.num_ws, self.w_avg_beta = num_ws, w_avg_beta
        if c_dim > 0:
            self.embed = FullyConnectedLayer(c_dim, embed)
        in0 = z_dim + (embed if c_dim > 0 else 0)
        for i in range(num_layers):
            setattr(self, f"fc{i}", FullyConnectedLayer(
                in0 if i == 0 else w_dim, w_dim, activation=activation,
                lr_multiplier=lr_multiplier))
        self.track_ema = num_ws is not None and w_avg_beta is not None
        if self.track_ema:
            self.register_buffer("w_avg", torch.zeros(w_dim))

    def forward(self, c: torch.Tensor | None = None, z: torch.Tensor | None = None,
                truncation_psi: float = 1.0, truncation_cutoff: int | None = None,
                update_emas: bool = False) -> torch.Tensor:
        x = normalize_2nd_moment(z.float()) if self.z_dim > 0 else None
        if self.c_dim > 0:
            y = normalize_2nd_moment(self.embed(c.float()))
            x = torch.cat([x, y], dim=1) if x is not None else y
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
        if update_emas and self.track_ema:
            with torch.no_grad():
                self.w_avg.copy_(x.detach().mean(dim=0) * (1 - self.w_avg_beta)
                                 + self.w_avg * self.w_avg_beta)
        if self.num_ws is not None:
            x = x[:, None].expand(-1, self.num_ws, -1)
        if truncation_psi != 1.0:
            if not self.track_ema:
                raise ValueError("MappingNetwork: truncation needs the w average")
            if self.num_ws is None or truncation_cutoff is None:
                x = self.w_avg + truncation_psi * (x - self.w_avg)
            else:
                head = self.w_avg + truncation_psi * (x[:, :truncation_cutoff] - self.w_avg)
                x = torch.cat([head, x[:, truncation_cutoff:]], dim=1)
        return x


class MinibatchStdLayer(nn.Module):
    """Cross-sample std feature, NCHW: sample k is in group k mod (N/G)
    (torch's ``repeat``, JAX's ``tile``)."""

    def __init__(self, group_size: int | None = 4, num_channels: int = 1):
        super().__init__()
        self.group_size, self.num_channels = group_size, num_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        g = min(self.group_size, n) if self.group_size is not None else n
        f = self.num_channels
        y = x.reshape(g, n // g, f, c // f, h, w).float()
        y = y - y.mean(dim=0)
        y = torch.sqrt(y.square().mean(dim=0) + 1e-8)       # [n/g, F, c/F, H, W]
        y = y.mean(dim=(2, 3, 4))                            # [n/g, F]
        y = y.reshape(-1, f, 1, 1).repeat(g, 1, h, w).to(x.dtype)
        return torch.cat([x, y], dim=1)


class DiscriminatorBlock(nn.Module):
    """Resnet downsampling block (``fromrgb`` where ``in_channels`` is 0),
    NCHW. ``use_fp16`` runs the block's activations in bf16, as the JAX
    package does; parameters stay fp32."""

    def __init__(self, in_channels: int, tmp_channels: int, out_channels: int,
                 resolution: int, img_channels: int, conv_clamp: float | None = 256.0,
                 use_fp16: bool = False):
        super().__init__()
        self.in_channels = in_channels
        self.dtype = torch.bfloat16 if use_fp16 else torch.float32
        if in_channels == 0:
            self.fromrgb = Conv2dLayer(img_channels, tmp_channels, kernel_size=1,
                                       activation="lrelu", conv_clamp=conv_clamp)
        self.skip = Conv2dLayer(tmp_channels, out_channels, kernel_size=1, bias=False, down=2)
        self.conv0 = Conv2dLayer(tmp_channels, tmp_channels, activation="lrelu",
                                 conv_clamp=conv_clamp)
        self.conv1 = Conv2dLayer(tmp_channels, out_channels, activation="lrelu", down=2,
                                 conv_clamp=conv_clamp)

    def forward(self, x: torch.Tensor | None, img: torch.Tensor | None) -> torch.Tensor:
        if x is not None:
            x = x.to(self.dtype)
        if self.in_channels == 0:
            y = self.fromrgb(img.to(self.dtype))
            x = x + y if x is not None else y
        y = self.skip(x, gain=math.sqrt(0.5))
        x = self.conv0(x)
        x = self.conv1(x, gain=math.sqrt(0.5))
        return y + x


class DiscriminatorEpilogue(nn.Module):
    """4x4 head: minibatch std -> conv -> fc -> out, projected on ``cmap``."""

    def __init__(self, in_channels: int, cmap_dim: int, resolution: int = 4,
                 mbstd_group_size: int = 4, mbstd_num_channels: int = 1,
                 conv_clamp: float | None = 256.0):
        super().__init__()
        self.cmap_dim = cmap_dim
        self.mbstd = (MinibatchStdLayer(mbstd_group_size, mbstd_num_channels)
                      if mbstd_num_channels > 0 else None)
        self.conv = Conv2dLayer(in_channels + mbstd_num_channels, in_channels,
                                activation="lrelu", conv_clamp=conv_clamp)
        self.fc = FullyConnectedLayer(in_channels * resolution ** 2, in_channels,
                                      activation="lrelu")
        self.out = FullyConnectedLayer(in_channels, 1 if cmap_dim == 0 else cmap_dim)

    def forward(self, x: torch.Tensor, cmap: torch.Tensor | None = None) -> torch.Tensor:
        x = x.float()
        if self.mbstd is not None:
            x = self.mbstd(x)
        x = self.conv(x)
        x = self.fc(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))   # (H, W, C) order
        x = self.out(x)
        if self.cmap_dim > 0:
            x = (x * cmap).sum(dim=1, keepdim=True) / math.sqrt(self.cmap_dim)
        return x


class Generator(nn.Module):
    """Mapping plus synthesis: z [B,z_dim] (and c [B,c_dim]) -> the image
    [B,res,res,img_channels] (NHWC, fp32). ``noise_mode`` defaults to
    ``"random"``, as in the JAX package: each synthesis layer then draws its
    noise plane from ``draws``."""

    def __init__(self, z_dim: int, c_dim: int, w_dim: int, img_resolution: int,
                 img_channels: int, mapping_layers: int = 8, channel_base: int = 32768,
                 channel_max: int = 512, num_fp16_res: int = 0):
        super().__init__()
        self.synthesis = SynthesisNetwork(w_dim, img_resolution, img_channels,
                                          channel_base=channel_base, channel_max=channel_max,
                                          num_fp16_res=num_fp16_res)
        self.mapping = MappingNetwork(c_dim, w_dim, num_layers=mapping_layers, z_dim=z_dim,
                                      num_ws=self.synthesis.num_ws)

    def forward(self, z: torch.Tensor, c: torch.Tensor | None = None,
                truncation_psi: float = 1.0, truncation_cutoff: int | None = None,
                update_emas: bool = False, noise_mode: str = "random",
                draws=None) -> torch.Tensor:
        ws = self.mapping(c, z, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff, update_emas=update_emas)
        return self.synthesis(ws, noise_mode=noise_mode, draws=draws)


class Discriminator(nn.Module):
    """The conditional StyleGAN2 discriminator: resnet blocks from
    ``img_resolution`` down to 8^2 (the ``num_fp16_res`` highest in bf16,
    through bf16 kernels K6a and K6b), the camera (or any condition c)
    mapped to ``cmap``, the 4^2 epilogue. img [B,res,res,C] (NHWC), c
    [B,c_dim] -> logits [B,1]."""

    def __init__(self, c_dim: int, img_resolution: int, img_channels: int,
                 channel_base: int = 32768, channel_max: int = 512, num_fp16_res: int = 4,
                 conv_clamp: float | None = 256.0, cmap_dim: int | None = None,
                 mbstd_group_size: int = 4, mapping_layers: int = 8):
        super().__init__()
        log2 = int(math.log2(img_resolution))
        self.resolutions = [2 ** i for i in range(log2, 2, -1)]

        def channels(res: int) -> int:
            return min(channel_base // res, channel_max)

        cmap_dim = channels(4) if cmap_dim is None else cmap_dim
        if c_dim == 0:
            cmap_dim = 0
        fp16_resolution = max(2 ** (log2 + 1 - num_fp16_res), 8)
        for res in self.resolutions:
            setattr(self, f"b{res}", DiscriminatorBlock(
                channels(res) if res < img_resolution else 0, channels(res),
                channels(res // 2), res, img_channels, conv_clamp=conv_clamp,
                use_fp16=num_fp16_res > 0 and res >= fp16_resolution))
        self.mapping = (MappingNetwork(c_dim, cmap_dim, num_layers=mapping_layers,
                                       w_avg_beta=None) if c_dim > 0 else None)
        self.b4 = DiscriminatorEpilogue(channels(4), cmap_dim=cmap_dim,
                                        mbstd_group_size=mbstd_group_size,
                                        conv_clamp=conv_clamp)

    def forward(self, img: torch.Tensor, c: torch.Tensor | None = None) -> torch.Tensor:
        img = img.permute(0, 3, 1, 2)
        x = None
        for res in self.resolutions:
            x = getattr(self, f"b{res}")(x, img if x is None else None)
        cmap = self.mapping(c) if self.mapping is not None else None
        return self.b4(x, cmap)

"""Audio -> 3DMM expression: the conditional flow-VAE (port of
``real3dportrait_tpu/models/audio2motion.py``).

HuBERT features (1024-d at 50 Hz, halved to 25 Hz) plus pitch, blink and
mouth-amplitude conditioning drive a conv VAE with a stride-4 latent, a
WaveNet-conditioned decoder and a residual-coupling (Glow) prior, sampled
with a temperature at inference. Public tensors keep the JAX layout
([B, T, C]); the convolutions run [B, C, T] inside. Parameter names follow
the Flax tree. At inference the prior noise comes from an explicit
``torch.Generator`` or a given ``z`` (Flax's RNG streams have no
counterpart here, so the two packages agree at ``temperature=0`` or for
the same ``z``). The training branch (``train=True``: the posterior
encoder, the decoder from its draw and the KL through the prior flow run
forward) takes its posterior draw from a ``utils/draws.Draws``, in the
JAX layout [B, T/4, 16], so that a test can replay the JAX package's. Norm epsilons are Flax's 1e-6; every GELU is the exact
(erf) form, as in the JAX module.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

F0_BIN = 256
F0_MAX = 1100.0
F0_MIN = 50.0
_F0_MEL_MIN = 1127 * math.log(1 + F0_MIN / 700)
_F0_MEL_MAX = 1127 * math.log(1 + F0_MAX / 700)


def f0_to_coarse(f0: torch.Tensor) -> torch.Tensor:
    """Hz -> 1..255 mel-scaled pitch bins, in fp32 and in the JAX order."""
    f0_mel = 1127 * torch.log(1 + f0 / 700)
    scaled = (f0_mel - _F0_MEL_MIN) * (F0_BIN - 2) / (_F0_MEL_MAX - _F0_MEL_MIN) + 1
    f0_mel = torch.where(f0_mel > 0, scaled, f0_mel)
    f0_mel = torch.clip(f0_mel, 1, F0_BIN - 1)
    return torch.floor(f0_mel + 0.5).long()


def downsample_time(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """[B,T,...] -> [B,T//factor,...], nearest: output i reads input i*factor."""
    return x[:, : (x.shape[1] // factor) * factor : factor]


def _conv(ci: int, co: int, k: int, stride: int = 1, padding: int = 0, dilation: int = 1,
          bias: bool = True) -> nn.Conv1d:
    return nn.Conv1d(ci, co, k, stride=stride, padding=padding, dilation=dilation, bias=bias)


class ConvTranspose1d(nn.Conv1d):
    """Flax ``nn.ConvTranspose`` with kernel = stride (no overlap, "SAME"
    padding), kept in a Conv1d's ``[Co, Ci, k]`` weight so that the weight
    bridge's rank-3 rule applies; Flax does not flip the kernel, torch's
    transposed convolution does."""

    def __init__(self, in_channels: int, out_channels: int, stride: int):
        super().__init__(in_channels, out_channels, stride)
        self.up = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.flip(-1).transpose(0, 1)
        return F.conv_transpose1d(x, w, self.bias, stride=self.up)


class WN(nn.Module):
    """Non-causal WaveNet stack with gated units and global conditioning."""

    def __init__(self, hidden: int, kernel_size: int, dilation_rate: int, n_layers: int,
                 gin_channels: int):
        super().__init__()
        self.hidden, self.n_layers = hidden, n_layers
        self.cond_layer = _conv(gin_channels, 2 * hidden * n_layers, 1)
        for i in range(n_layers):
            dil = dilation_rate ** i
            setattr(self, f"in_{i}", _conv(hidden, 2 * hidden, kernel_size, dilation=dil,
                                           padding=(kernel_size * dil - dil) // 2))
            setattr(self, f"res_skip_{i}",
                    _conv(hidden, 2 * hidden if i < n_layers - 1 else hidden, 1))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """x [B,H,T], x_mask [B,1,T], g [B,Cg,T]."""
        h = self.hidden
        g_all = self.cond_layer(g)
        output = torch.zeros_like(x)
        for i in range(self.n_layers):
            x_in = getattr(self, f"in_{i}")(x) + g_all[:, i * 2 * h:(i + 1) * 2 * h]
            acts = torch.tanh(x_in[:, :h]) * torch.sigmoid(x_in[:, h:])
            res_skip = getattr(self, f"res_skip_{i}")(acts)
            if i < self.n_layers - 1:
                x = (x + res_skip[:, :h]) * x_mask
                output = output + res_skip[:, h:]
            else:
                output = output + res_skip
        return output * x_mask


class ResidualCouplingLayer(nn.Module):
    """Mean-only affine coupling; its ``post`` conv starts at zero, as in
    JAX, so an untrained flow is the identity."""

    def __init__(self, channels: int, hidden: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, gin_channels: int):
        super().__init__()
        self.half = channels // 2
        self.pre = _conv(self.half, hidden, 1)
        self.enc = WN(hidden, kernel_size, dilation_rate, n_layers, gin_channels)
        self.post = _conv(hidden, self.half, 1)
        self.post.zero_init = True

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor,
                reverse: bool = False) -> torch.Tensor:
        x0, x1 = x[:, :self.half], x[:, self.half:]
        h = self.enc(self.pre(x0) * x_mask, x_mask, g)
        m = self.post(h) * x_mask
        x1 = (x1 - m) * x_mask if reverse else (m + x1) * x_mask
        return torch.cat([x0, x1], dim=1)


class ResidualCouplingBlock(nn.Module):
    """n_flows x (coupling + channel flip); the reverse pass runs the flips
    and couplings in reverse order."""

    def __init__(self, channels: int, hidden: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, n_flows: int, gin_channels: int):
        super().__init__()
        self.n_flows = n_flows
        for i in range(n_flows):
            setattr(self, f"flow_{i}", ResidualCouplingLayer(
                channels, hidden, kernel_size, dilation_rate, n_layers, gin_channels))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor,
                reverse: bool = False) -> torch.Tensor:
        if not reverse:
            for i in range(self.n_flows):
                x = torch.flip(getattr(self, f"flow_{i}")(x, x_mask, g), dims=(1,))
            return x
        for i in reversed(range(self.n_flows)):
            x = getattr(self, f"flow_{i}")(torch.flip(x, dims=(1,)), x_mask, g, reverse=True)
        return x


class FVAEEncoder(nn.Module):
    """Strided convs (``Conv_0``, ``Conv_1``, ... one a latent stride) + WN
    -> the posterior (training)."""

    def __init__(self, in_channels: int, hidden: int, latent: int, kernel_size: int,
                 n_layers: int, gin_channels: int, strides: Sequence[int]):
        super().__init__()
        self.stride, self.latent, self.n_convs = math.prod(strides), latent, len(strides)
        for i, s in enumerate(strides):
            setattr(self, f"Conv_{i}", _conv(in_channels if i == 0 else hidden, hidden, 2 * s,
                                             stride=s, padding=s // 2))
        self.wn = WN(hidden, kernel_size, 1, n_layers, gin_channels)
        self.out_proj = _conv(hidden, 2 * latent, 1)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor, draws
                ) -> tuple:
        """x [B,C,T], x_mask [B,1,T], g [B,Cg,T/s] -> (z, m, logs [B,latent,T/s],
        the mask at T/s: every s-th frame of ``x_mask``, s the strides'
        product). ``z = m + eps * exp(logs)`` with eps from ``draws``, drawn
        [B,T/s,latent]."""
        for i in range(self.n_convs):
            x = getattr(self, f"Conv_{i}")(x)
        mask = x_mask[:, :, ::self.stride][:, :, :x.shape[2]]
        x = self.wn(x * mask, mask, g) * mask
        m, logs = torch.split(self.out_proj(x), self.latent, dim=1)
        eps = draws.normal((m.shape[0], m.shape[2], m.shape[1]), m.device).transpose(1, 2)
        return m + eps * torch.exp(logs), m, logs, mask


class FVAEDecoder(nn.Module):
    """Transposed-conv upsample (``ConvTranspose_0``, ... one a latent
    stride) + WN decoder."""

    def __init__(self, latent: int, hidden: int, out_channels: int, kernel_size: int,
                 n_layers: int, gin_channels: int, strides: Sequence[int]):
        super().__init__()
        self.n_convs = len(strides)
        for i, s in enumerate(strides):
            setattr(self, f"ConvTranspose_{i}",
                    ConvTranspose1d(latent if i == 0 else hidden, hidden, s))
        self.wn = WN(hidden, kernel_size, 1, n_layers, gin_channels)
        self.out_proj = _conv(hidden, out_channels, 1)

    def forward(self, z: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        x = z
        for i in range(self.n_convs):
            x = getattr(self, f"ConvTranspose_{i}")(x)
        x = x * x_mask
        x = self.wn(x, x_mask, g) * x_mask
        return self.out_proj(x)


class FVAE(nn.Module):
    """Flow-prior VAE; :meth:`forward` is the inference branch,
    :meth:`forward_train` the training one. The latent runs at T over the
    product of ``strides``; the condition's pre-net is one strided conv a
    stride: ``g_pre_net`` for one stride (the JAX tree's name), else
    ``g_pre_net_0``, ``g_pre_net_1``, ... (the JAX module names every one
    ``g_pre_net`` and cannot build with more than one)."""

    def __init__(self, in_out_channels: int = 64, hidden: int = 256, latent_size: int = 16,
                 kernel_size: int = 5, enc_n_layers: int = 8, dec_n_layers: int = 4,
                 gin_channels: int = 64, strides: Sequence[int] = (4,),
                 use_prior_glow: bool = True, glow_hidden: int = 64,
                 glow_kernel_size: int = 3, glow_n_blocks: int = 4):
        super().__init__()
        self.latent_size, self.use_prior_glow = latent_size, use_prior_glow
        self.g_pre_nets = ["g_pre_net"] if len(strides) == 1 else \
            [f"g_pre_net_{i}" for i in range(len(strides))]
        for name, s in zip(self.g_pre_nets, strides):
            setattr(self, name, _conv(gin_channels, gin_channels, 2 * s, stride=s,
                                      padding=s // 2))
        self.encoder = FVAEEncoder(in_out_channels, hidden, latent_size, kernel_size,
                                   enc_n_layers, gin_channels, strides)
        self.decoder = FVAEDecoder(latent_size, hidden, in_out_channels, kernel_size,
                                   dec_n_layers, gin_channels, strides)
        if use_prior_glow:
            self.prior_flow = ResidualCouplingBlock(latent_size, glow_hidden, glow_kernel_size,
                                                    1, glow_n_blocks, 4, gin_channels)

    def g_pre(self, g: torch.Tensor) -> torch.Tensor:
        """The condition [B,Cg,T] at the latent's rate."""
        for name in self.g_pre_nets:
            g = getattr(self, name)(g)
        return g

    def forward_train(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor,
                      draws) -> tuple:
        """The training branch: x [B,C,T], x_mask [B,1,T], g [B,Cg,T] ->
        (x_recon [B,C,T], loss_kl, z_p, m_q, logs_q). The decoder runs from
        the posterior draw z_q with the full mask; the KL is E_q[log q(z) -
        log p(flow(z))] over the masked latent frames, divided by the latent
        size (the coupling layers are mean-only and the flips permute, so
        the flow's log-determinant is 0)."""
        g_sqz = self.g_pre(g)
        z_q, m_q, logs_q, mask_sqz = self.encoder(x, x_mask, g_sqz, draws)
        x_recon = self.decoder(z_q, x_mask, g)
        log2pi = math.log(2 * math.pi)
        logqx = -0.5 * (((z_q - m_q) * torch.exp(-logs_q)).square() + 2 * logs_q + log2pi)
        z_p = self.prior_flow(z_q, mask_sqz, g_sqz) if self.use_prior_glow else z_q
        logpx = -0.5 * (z_p.square() + log2pi)
        loss_kl = ((logqx - logpx) * mask_sqz).sum() / torch.clamp(mask_sqz.sum(), min=1.0) \
            / self.latent_size
        return x_recon, loss_kl, z_p, m_q, logs_q

    def forward(self, g: torch.Tensor, temperature: float = 1.0,
                z: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        """g [B,Cg,T] -> (x_recon [B,C,T], z_p [B,latent,T/s]). The prior
        noise is ``z`` ([B,latent,T/s]) if given, else drawn from
        ``generator`` (on the CPU, then moved: the same seed gives the same
        noise on every device), times ``temperature``."""
        g_sqz = self.g_pre(g)
        b, t_sqz = g_sqz.shape[0], g_sqz.shape[2]
        if z is None:
            z = torch.randn((b, self.latent_size, t_sqz), generator=generator)
        z_p = z.to(g.device, g.dtype) * temperature
        if self.use_prior_glow:
            z_p = self.prior_flow(z_p, torch.ones_like(z_p[:, :1]), g_sqz, reverse=True)
        x_recon = self.decoder(z_p, torch.ones_like(g[:, :1]), g)
        return x_recon, z_p


class PitchContourVAEModel(nn.Module):
    """The audio-to-motion model with pitch, blink and amplitude
    conditioning. ``norm_mode`` "gn": GroupNorm in the mel and pitch
    encoders; "folded_bn": no norm and a biased first conv (converted
    reference checkpoints with the BatchNorm folded in)."""

    def __init__(self, in_out_dim: int = 64, audio_in_dim: int = 1024, feat_dim: int = 128,
                 use_prior_flow: bool = True, use_pitch: bool = True,
                 use_mouth_amp_embed: bool = True, use_eye_amp_embed: bool = False,
                 norm_mode: str = "gn"):
        super().__init__()
        if norm_mode not in ("gn", "folded_bn"):
            raise ValueError(f"norm_mode must be 'gn' or 'folded_bn', got {norm_mode!r}")
        fd = self.feat_dim = feat_dim
        self.norm_mode, self.use_pitch = norm_mode, use_pitch
        self._add_cond_encoder("mel_encoder", audio_in_dim)
        if use_pitch:
            self.pitch_embed = nn.Embedding(300, fd)
            self._add_cond_encoder("pitch_encoder", fd)
        self.blink_embed = nn.Embedding(2, fd)
        # N(0, 1) at initialisation, as the JAX module draws them
        self.mouth_amp_embed = nn.Parameter(torch.zeros(fd)) if use_mouth_amp_embed else None
        self.eye_amp_embed = nn.Parameter(torch.zeros(fd)) if use_eye_amp_embed else None
        n_cond = 2 + use_pitch + use_mouth_amp_embed + use_eye_amp_embed
        self.cond_proj = nn.Linear(n_cond * fd, fd)
        self.vae = FVAE(in_out_channels=in_out_dim, hidden=256, latent_size=16, kernel_size=5,
                        enc_n_layers=8, dec_n_layers=4, gin_channels=fd,
                        use_prior_glow=use_prior_flow, glow_hidden=64, glow_kernel_size=3,
                        glow_n_blocks=4)

    def _add_cond_encoder(self, name: str, in_dim: int) -> None:
        """conv -> norm -> GELU -> conv."""
        fd = self.feat_dim
        setattr(self, f"{name}_conv0", _conv(in_dim, fd, 3, padding=1,
                                             bias=self.norm_mode == "folded_bn"))
        if self.norm_mode == "gn":
            setattr(self, f"{name}_gn", nn.GroupNorm(8, fd, eps=1e-6))
        setattr(self, f"{name}_conv1", _conv(fd, fd, 3, padding=1, bias=False))

    def _cond_encoder(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """[B,T,C] -> [B,T,feat_dim]."""
        x = getattr(self, f"{name}_conv0")(x.transpose(1, 2))
        if self.norm_mode == "gn":
            x = getattr(self, f"{name}_gn")(x)
        return getattr(self, f"{name}_conv1")(F.gelu(x)).transpose(1, 2)

    def forward(self, batch: dict, temperature: float = 1.0, z: torch.Tensor | None = None,
                generator: torch.Generator | None = None, train: bool = False,
                draws=None) -> dict:
        """batch: audio [B,T,C] at 50 Hz, f0 [B,T], y_mask [B,T/2] at 25 Hz,
        blink [B,T,1] (optional, 0), mouth_amp [B,1] (optional, 0.4);
        ``z`` [B,T/8,16] replaces the prior noise. Returns pred [B,T/2,64]
        (masked), mask and z_p [B,T/8,16] (after the flow). ``train=True``
        encodes ``batch["y"]`` [B,T/2,64] with the posterior draw from
        ``draws`` and adds ``loss_kl``, ``m_q`` and ``logs_q``."""
        mask = batch["y_mask"]
        audio = batch["audio"]
        b = audio.shape[0]
        mel = downsample_time(audio, 2)
        mel_feat = self._cond_encoder(mel, "mel_encoder")
        cond_feats = [mel_feat]
        if self.use_pitch:
            f0 = downsample_time(batch["f0"], 2)
            cond_feats.append(self._cond_encoder(self.pitch_embed(f0_to_coarse(f0)),
                                                 "pitch_encoder"))
        blink = batch.get("blink")
        if blink is None:
            blink = torch.zeros(audio.shape[:2] + (1,), dtype=torch.long, device=audio.device)
        cond_feats.append(downsample_time(self.blink_embed(blink[..., 0].long()), 2))
        t_cond = mel_feat.shape[1]
        for key, embed in (("mouth_amp", self.mouth_amp_embed), ("eye_amp", self.eye_amp_embed)):
            if embed is not None:
                amp = batch.get(key)
                if amp is None:
                    amp = torch.full((b, 1), 0.4, device=audio.device)
                cond_feats.append((amp[:, :, None] * embed[None, None]).expand(
                    b, t_cond, self.feat_dim))
        cond = self.cond_proj(torch.cat(cond_feats, dim=-1))
        if train:
            x_recon, loss_kl, z_p, m_q, logs_q = self.vae.forward_train(
                batch["y"].transpose(1, 2), mask[:, None], cond.transpose(1, 2), draws)
            return {"pred": x_recon.transpose(1, 2) * mask[..., None], "mask": mask,
                    "loss_kl": loss_kl, "z_p": z_p.transpose(1, 2),
                    "m_q": m_q.transpose(1, 2), "logs_q": logs_q.transpose(1, 2)}
        x_recon, z_p = self.vae(cond.transpose(1, 2), temperature,
                                None if z is None else z.transpose(1, 2), generator)
        return {"pred": x_recon.transpose(1, 2) * mask[..., None], "mask": mask,
                "z_p": z_p.transpose(1, 2)}


class VAEModel(PitchContourVAEModel):
    """The plain audio-only variant: no pitch or amplitude conditioning."""

    def __init__(self, in_out_dim: int = 64, audio_in_dim: int = 1024, feat_dim: int = 64,
                 use_prior_flow: bool = True, norm_mode: str = "gn"):
        super().__init__(in_out_dim, audio_in_dim, feat_dim, use_prior_flow, use_pitch=False,
                         use_mouth_amp_embed=False, use_eye_amp_embed=False,
                         norm_mode=norm_mode)

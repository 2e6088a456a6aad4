"""HuBERT encoder on PyTorch (port of ``real3dportrait_tpu/audio/hubert.py``).

The HF ``HubertModel`` architecture in both released families:
``feat_extract_norm='group'`` (base: GroupNorm after conv0 only, post-LN
transformer blocks) and ``'layer'`` (large, the reference's checkpoint
family: LayerNorm after every conv, pre-LN blocks and a final LayerNorm).
Parameter names follow the Flax tree; norm epsilons are Flax's 1e-6 and
every GELU is the exact (erf) form, as in the JAX module. Attention is
``F.scaled_dot_product_attention``: the JAX module computes it in plain XLA,
not in a kernel of its own.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


class ConvFeatureExtractor(nn.Module):
    """Raw 16 kHz wav [B, N] -> frame features [B, T, dims[-1]] at 50 Hz."""

    def __init__(self, dims: Sequence[int] = (512,) * 7,
                 kernels: Sequence[int] = (10, 3, 3, 3, 3, 2, 2),
                 strides: Sequence[int] = (5, 2, 2, 2, 2, 2, 2), norm: str = "layer"):
        super().__init__()
        self.norm, self.n = norm, len(dims)
        prev = 1
        for i, (d, k, s) in enumerate(zip(dims, kernels, strides)):
            setattr(self, f"conv_{i}", nn.Conv1d(prev, d, k, stride=s, bias=False))
            if norm == "layer":
                setattr(self, f"ln_{i}", nn.LayerNorm(d, eps=1e-6))
            elif norm == "group" and i == 0:
                # per-channel normalisation over time
                self.gn_0 = nn.GroupNorm(d, d, eps=1e-6)
            prev = d

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = wav[:, None]                                      # [B, 1, N]
        for i in range(self.n):
            x = getattr(self, f"conv_{i}")(x)
            if self.norm == "layer":
                x = getattr(self, f"ln_{i}")(x.transpose(1, 2)).transpose(1, 2)
            elif self.norm == "group" and i == 0:
                x = self.gn_0(x)
            x = F.gelu(x)
        return x.transpose(1, 2)


class PositionalConvEmbedding(nn.Module):
    """Grouped-conv relative positional embedding; an even kernel pads
    k // 2 and trims the last step (HF's ``HubertSamePadLayer``)."""

    def __init__(self, hidden: int = 1024, kernel: int = 128, groups: int = 16):
        super().__init__()
        self.trim = kernel % 2 == 0
        self.conv = nn.Conv1d(hidden, hidden, kernel, padding=kernel // 2, groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:      # [B, T, H]
        y = self.conv(x.transpose(1, 2))
        if self.trim:
            y = y[:, :, :-1]
        return F.gelu(y).transpose(1, 2)


class MultiHeadAttention(nn.Module):
    """Flax ``MultiHeadDotProductAttention`` (self-attention): query, key
    and value projections of ``heads x head_dim`` features, softmax of
    q k^T / sqrt(head_dim), output projection."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        for name in ("query", "key", "value", "out"):
            setattr(self, name, nn.Linear(hidden, hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape

        def split(y):
            return y.view(b, t, self.heads, -1).transpose(1, 2)

        y = F.scaled_dot_product_attention(split(self.query(x)), split(self.key(x)),
                                           split(self.value(x)))
        return self.out(y.transpose(1, 2).reshape(b, t, -1))


class TransformerLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, ffn: int, stable_layer_norm: bool = True):
        super().__init__()
        self.stable = stable_layer_norm
        self.attention = MultiHeadAttention(hidden, heads)
        self.ffn_in = nn.Linear(hidden, ffn)
        self.ffn_out = nn.Linear(ffn, hidden)
        self.ln_attn = nn.LayerNorm(hidden, eps=1e-6)
        self.ln_ffn = nn.LayerNorm(hidden, eps=1e-6)

    def _ffn(self, h: torch.Tensor) -> torch.Tensor:
        return self.ffn_out(F.gelu(self.ffn_in(h)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stable:  # pre-LN (large)
            x = x + self.attention(self.ln_attn(x))
            return x + self._ffn(self.ln_ffn(x))
        x = self.ln_attn(x + self.attention(x))             # post-LN (base)
        return self.ln_ffn(x + self._ffn(x))


class HubertEncoder(nn.Module):
    """HF ``HubertModel`` equivalent: wav [B, N] -> hidden states [B, T, H]."""

    def __init__(self, hidden: int = 1024, layers: int = 24, heads: int = 16, ffn: int = 4096,
                 conv_dims: Sequence[int] = (512,) * 7,
                 conv_kernels: Sequence[int] = (10, 3, 3, 3, 3, 2, 2),
                 conv_strides: Sequence[int] = (5, 2, 2, 2, 2, 2, 2),
                 feat_extract_norm: str = "layer", do_stable_layer_norm: bool = True,
                 pos_conv_kernel: int = 128, pos_conv_groups: int = 16,
                 feat_proj_layer_norm: bool = True):
        super().__init__()
        self.n_layers, self.stable = layers, do_stable_layer_norm
        self.feature_extractor = ConvFeatureExtractor(conv_dims, conv_kernels, conv_strides,
                                                      feat_extract_norm)
        self.feat_ln = nn.LayerNorm(conv_dims[-1], eps=1e-6) if feat_proj_layer_norm else None
        self.feat_proj = nn.Linear(conv_dims[-1], hidden)
        self.pos_conv = PositionalConvEmbedding(hidden, pos_conv_kernel, pos_conv_groups)
        self.encoder_ln = nn.LayerNorm(hidden, eps=1e-6)
        for i in range(layers):
            setattr(self, f"layer_{i}", TransformerLayer(hidden, heads, ffn,
                                                         do_stable_layer_norm))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        feats = self.feature_extractor(wav)
        if self.feat_ln is not None:
            feats = self.feat_ln(feats)
        x = self.feat_proj(feats)
        x = x + self.pos_conv(x)
        if not self.stable:
            x = self.encoder_ln(x)
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x)
        if self.stable:
            x = self.encoder_ln(x)
        return x


def hubert_large() -> HubertEncoder:
    """The reference's checkpoint family (hubert-large: 24L/1024H/16A)."""
    return HubertEncoder()


def hubert_base() -> HubertEncoder:
    return HubertEncoder(hidden=768, layers=12, heads=12, ffn=3072, feat_extract_norm="group",
                         do_stable_layer_norm=False, feat_proj_layer_norm=False)


def make_hubert_extractor(model: HubertEncoder):
    """``fn(wav16k [N]) -> [T, H]`` at 50 Hz on the model's device: the wav
    normalised per utterance (zero mean, unit variance, as
    Wav2Vec2Processor), in chunks of 320 * 32 * 100 samples with 80 samples
    of overlap for the conv stack's kernel; a chunk under 400 samples (one
    frame's receptive field) ends it."""
    dev = next(model.parameters()).device

    @torch.no_grad()
    def extract(wav: np.ndarray) -> np.ndarray:
        wav = np.asarray(wav, np.float32)
        wav = (wav - wav.mean()) / (wav.std() + 1e-7)
        chunk = 320 * 32 * 100
        outs = []
        for start in range(0, max(len(wav), 1), chunk):
            seg = wav[start:start + chunk + 80]
            if len(seg) < 400:
                break
            outs.append(model(torch.from_numpy(seg)[None].to(dev))[0].float().cpu().numpy())
        return np.concatenate(outs, axis=0).astype(np.float32)

    return extract

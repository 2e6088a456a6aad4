"""Audio / mouth-landmark sync discriminator (port of
``real3dportrait_tpu/models/syncnet.py``): two 1-D conv towers embed
5-frame landmark clips and 10-frame HuBERT clips into one space, compared
by cosine similarity with a BCE loss. Convs are cuDNN's (``F.conv1d``), as
JAX computes them outside any kernel.

Parameters keep the Flax tree's names (``hubert_encoder.layer_<i>.Conv_0``,
``...GroupNorm_0`` or, for converted checkpoints, ``...norm``), so
``weights.py`` carries them both ways. Activations are [B, T, C] at the
module's edges, as in JAX; the towers run in [B, C, T].
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn as nn
import torch.nn.functional as F

from real3dportrait_tpu_torch.models.img2plane_composite import ChannelAffine


def group_count(channels: int) -> int:
    """At least 4 channels a group, at most 32 groups, fewer until the count
    divides ``channels``."""
    g = max(1, min(channels // 4, 32))
    while channels % g:
        g -= 1
    return g


class ConvGNRelu1d(nn.Module):
    """conv -> norm -> (+ residual) -> relu. ``norm_mode`` ``"gn"``:
    GroupNorm (epsilon 1e-6, Flax's); ``"affine"``: the folded eval-time
    BatchNorm of a converted checkpoint."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1, residual: bool = False, norm_mode: str = "gn"):
        super().__init__()
        self.stride, self.padding, self.residual = stride, padding, residual
        self.Conv_0 = nn.Conv1d(in_channels, out_channels, kernel)
        if norm_mode == "affine":
            self.norm = ChannelAffine(out_channels)
        elif norm_mode == "gn":
            self.GroupNorm_0 = nn.GroupNorm(group_count(out_channels), out_channels, eps=1e-6)
        else:
            raise ValueError(f"norm_mode must be 'gn' or 'affine', got {norm_mode!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B,C,T]
        y = F.conv1d(x, self.Conv_0.weight, self.Conv_0.bias, stride=self.stride,
                     padding=self.padding)
        y = self.norm(y) if hasattr(self, "norm") else self.GroupNorm_0(y)
        if self.residual:
            y = y + x
        return F.relu(y)


class _Tower(nn.Sequential):
    """The two towers' shared topology; layers ``layer_<i>`` as the
    reference's ``nn.Sequential`` indices."""

    def __init__(self, in_dim: int, base: int, out_dim: int, n_res: int, first_ch: int,
                 second_stride: int, norm_mode: str = "gn"):
        specs = [(first_ch, 3, 1, 1, False), (base, 3, 1, 1, False)]
        specs += [(base, 3, 1, 1, True)] * n_res
        specs += [(2 * base, 3, 2, 1, False)] + [(2 * base, 3, 1, 1, True)] * n_res
        specs += [(4 * base, 3, second_stride, 1, False)] + [(4 * base, 3, 1, 1, True)] * n_res
        specs += [(4 * base, 3, 1, 1, False), (4 * base, 3, 1, 0, False),
                  (4 * base, 1, 1, 0, False), (out_dim, 1, 1, 0, False)]
        layers, ch = OrderedDict(), in_dim
        for i, (co, k, s, p, res) in enumerate(specs):
            layers[f"layer_{i}"] = ConvGNRelu1d(ch, co, k, s, p, res, norm_mode)
            ch = co
        super().__init__(layers)


class LandmarkHubertSyncNet(nn.Module):
    """``lm_dim`` 60 is 20 mouth landmarks x 3; the released lineage trains
    with ``syncnet_keypoint_mode: lm468``, 468 x 3 = 1404."""

    def __init__(self, lm_dim: int = 60, audio_dim: int = 1024, num_layers_per_block: int = 3,
                 base_hid_size: int = 128, out_dim: int = 1024, norm_mode: str = "gn"):
        super().__init__()
        n_res = num_layers_per_block - 1
        self.hubert_encoder = _Tower(audio_dim, base_hid_size, out_dim, n_res, base_hid_size,
                                     2, norm_mode)
        self.mouth_encoder = _Tower(lm_dim, base_hid_size, out_dim, n_res, 96, 1, norm_mode)

    def forward(self, hubert: torch.Tensor, mouth_lm: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """hubert [B,10,A], mouth_lm [B,5,lm_dim] -> (audio_emb, mouth_emb),
        both L2-normalised [B, out_dim]."""
        audio = self.hubert_encoder(hubert.transpose(1, 2)).transpose(1, 2)
        mouth = self.mouth_encoder(mouth_lm.transpose(1, 2)).transpose(1, 2)
        audio = audio.reshape(audio.shape[0], -1)
        mouth = mouth.reshape(mouth.shape[0], -1)
        audio = audio / (torch.linalg.vector_norm(audio, dim=-1, keepdim=True) + 1e-8)
        mouth = mouth / (torch.linalg.vector_norm(mouth, dim=-1, keepdim=True) + 1e-8)
        return audio, mouth


def cal_sync_loss(audio_emb: torch.Tensor, mouth_emb: torch.Tensor,
                  label) -> tuple[torch.Tensor, torch.Tensor]:
    """Cosine-similarity BCE: (per-sample loss [B], cosine similarity [B])."""
    d = (audio_emb * mouth_emb).sum(dim=-1)
    gt = torch.broadcast_to(torch.as_tensor(label, dtype=torch.float32, device=d.device),
                            d.shape)
    p = torch.clamp(d, 1e-7, 1 - 1e-7)
    loss = -(gt * torch.log(p) + (1 - gt) * torch.log(1 - p))
    return loss, d


def clip_loss(audio_features: torch.Tensor, motion_features: torch.Tensor,
              logit_scale=1.0) -> dict:
    """Symmetric InfoNCE over the batch's pairs."""
    logits_a = logit_scale * audio_features @ motion_features.T
    labels = torch.arange(logits_a.shape[0], device=logits_a.device)
    audio_loss = F.cross_entropy(logits_a, labels)
    motion_loss = F.cross_entropy(logits_a.T, labels)
    return {"audio_loss": audio_loss, "motion_loss": motion_loss,
            "clip_loss": (audio_loss + motion_loss) / 2}

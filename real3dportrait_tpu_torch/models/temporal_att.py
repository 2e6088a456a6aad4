"""Temporal attention net for motion-plane smoothing (port of
``real3dportrait_tpu/models/temporal_att.py``): a window of T planes is
reduced to one weight a frame, and the planes' softmax-weighted average is
the smoothed plane.

The probe resize is ``jax.image.resize``'s bilinear (``ops/resize.py``,
antialiased when shrinking); the three convolutions, pools and the dense
layer are plain PyTorch (the JAX package has no kernel here). Parameter
names follow the Flax tree: ``Conv_0`` .. ``Conv_2`` and
``to_attention_weights``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from real3dportrait_tpu_torch.ops.resize import resize_linear


class TemporalAttNet(nn.Module):
    def __init__(self, in_channels: int, seq_len: int = 5, probe_size: int = 32):
        super().__init__()
        self.seq_len, self.probe_size = seq_len, probe_size
        for i, (ci, co) in enumerate(((in_channels, 64), (64, 32), (32, 16))):
            setattr(self, f"Conv_{i}", nn.Conv2d(ci, co, 3, padding=1))
        self.to_attention_weights = nn.Linear(seq_len, seq_len)

    def forward(self, planes_window: torch.Tensor) -> torch.Tensor:
        """[B, T, H, W, C] window of planes (NHWC) -> the smoothed plane
        [B, H, W, C]."""
        b, t, h, w, c = planes_window.shape
        if t != self.seq_len:
            raise ValueError(f"TemporalAttNet: a window of {self.seq_len} planes, got {t}")
        x = resize_linear(planes_window.reshape(b * t, h, w, c), self.probe_size,
                          self.probe_size).permute(0, 3, 1, 2)
        for i in range(3):
            x = F.avg_pool2d(F.leaky_relu(getattr(self, f"Conv_{i}")(x), 0.02), 2)
        x = x.mean(dim=(2, 3)).reshape(b, t, -1).mean(-1)           # [B, T]
        weights = torch.softmax(self.to_attention_weights(x), dim=-1)
        return torch.einsum("bt,bthwc->bhwc", weights, planes_window)

"""Plane feature decoder (the tiny NeRF MLP) and kernels K1 and K1-trigrid.

Port of ``real3dportrait_tpu/models/decoder.py``: EG3D's ``OSGDecoder``,
two equalized-LR dense layers with softplus and MipNeRF sigmoid clamping.

:func:`triplane_decode` is the wrapper of kernel K1
(``csrc/triplane_decode.cu``), which fuses the tri-plane sampling, the plane
mean and this MLP; :func:`triplane_decode_plain` is its plain PyTorch
version (``F.grid_sample`` + :class:`OSGDecoder`). :func:`trigrid_decode`
and :func:`trigrid_decode_plain` are the same for tri-grids (kernel
K1-trigrid, trilinear sampling, in the same source).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from real3dportrait_tpu_torch import kernels
from real3dportrait_tpu_torch.models.stylegan2 import FullyConnectedLayer
from real3dportrait_tpu_torch.rendering.renderer import sample_from_planes, sample_from_trigrids


class OSGDecoder(nn.Module):
    """[B, n_planes, M, C] features -> {'rgb': [B,M,out_dim], 'sigma': [B,M,1]}."""

    def __init__(self, n_features: int, hidden_dim: int = 64, output_dim: int = 32,
                 lr_multiplier: float = 1.0):
        super().__init__()
        self.output_dim = output_dim
        self.net0 = FullyConnectedLayer(n_features, hidden_dim, lr_multiplier=lr_multiplier)
        self.net1 = FullyConnectedLayer(hidden_dim, 1 + output_dim,
                                        lr_multiplier=lr_multiplier)

    def forward(self, sampled_features: torch.Tensor) -> dict:
        x = sampled_features.mean(dim=1)
        b, m, c = x.shape
        x = torch.nn.functional.softplus(self.net0(x.reshape(b * m, c)))
        x = self.net1(x).reshape(b, m, -1)
        rgb = torch.sigmoid(x[..., 1:]) * (1 + 2 * 0.001) - 0.001
        return {"rgb": rgb, "sigma": x[..., 0:1]}

    def decode_points(self, planes: torch.Tensor, coords: torch.Tensor,
                      box_warp: float) -> tuple[torch.Tensor, torch.Tensor]:
        """Sample tri-planes [B,3,H,W,C] (kernel K1) or tri-grids
        [B,3,D,H,W,C] (kernel K1-trigrid) at world ``coords`` and decode."""
        if planes.dim() == 6:
            return trigrid_decode(planes, coords, box_warp, self)
        return triplane_decode(planes, coords, box_warp, self)


def triplane_decode_plain(planes: torch.Tensor, coords: torch.Tensor, box_warp: float,
                          decoder: OSGDecoder) -> tuple[torch.Tensor, torch.Tensor]:
    """planes [B,3,H,W,C], coords [B,M,3] -> (rgb [B,M,out], sigma [B,M,1])."""
    out = decoder(sample_from_planes(planes, coords, box_warp))
    return out["rgb"], out["sigma"]


def _folded_mlp(name: str, decoder: OSGDecoder, planes: torch.Tensor,
                coords: torch.Tensor) -> list[torch.Tensor]:
    """Check what the K1 kernels take; return the folded MLP weights."""
    kernels.require(name, "planes", planes)
    kernels.require(name, "coords", coords)
    w0, b0 = decoder.net0.folded()
    w1, b1 = decoder.net1.folded()
    if planes.shape[1] != 3 or planes.shape[-1] != 32 or w0.shape != (64, 32) \
            or w1.shape != (33, 64) or coords.dim() != 3 \
            or coords.shape[0] != planes.shape[0] or coords.shape[-1] != 3:
        raise ValueError(f"{name}: kernel takes planes [B,3,...,32] with a 32->64->33 "
                         f"decoder; got planes {tuple(planes.shape)}, coords "
                         f"{tuple(coords.shape)}, net0 {tuple(w0.shape)}, "
                         f"net1 {tuple(w1.shape)}")
    return [t.detach().contiguous() for t in (w0, b0, w1, b1)]


def triplane_decode(planes: torch.Tensor, coords: torch.Tensor, box_warp: float,
                    decoder: OSGDecoder) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 wrapper, same contract as :func:`triplane_decode_plain`.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes fp32 planes [B,3,H,W,32], a 64-wide hidden layer and 33
    outputs, or raise.
    """
    if planes.device.type == "cpu":
        return triplane_decode_plain(planes, coords, box_warp, decoder)
    name = "triplane_decode"
    planes, coords = planes.contiguous(), coords.contiguous()
    if planes.dim() != 5:
        raise ValueError(f"{name}: planes must be [B,3,H,W,32], got {tuple(planes.shape)}")
    w0, b0, w1, b1 = _folded_mlp(name, decoder, planes, coords)
    b, _, h, w, _ = planes.shape
    m = coords.shape[1]
    rgb = torch.empty((b, m, 32), device=planes.device)
    sigma = torch.empty((b, m, 1), device=planes.device)
    kernels.launch("r3dp_triplane_decode", planes, b, h, w, coords, m, 2.0 / box_warp,
                   w0, b0, w1, b1, rgb, sigma)
    triplane_decode.launches += 1
    return rgb, sigma


triplane_decode.launches = 0


def trigrid_decode_plain(planes: torch.Tensor, coords: torch.Tensor, box_warp: float,
                         decoder: OSGDecoder) -> tuple[torch.Tensor, torch.Tensor]:
    """planes [B,3,D,H,W,C], coords [B,M,3] -> (rgb [B,M,out], sigma [B,M,1])."""
    out = decoder(sample_from_trigrids(planes, coords, box_warp))
    return out["rgb"], out["sigma"]


def trigrid_decode(planes: torch.Tensor, coords: torch.Tensor, box_warp: float,
                   decoder: OSGDecoder) -> tuple[torch.Tensor, torch.Tensor]:
    """K1-trigrid wrapper, same contract as :func:`trigrid_decode_plain`.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes fp32 tri-grids [B,3,D,H,W,32] (any D, H, W >= 1), a
    64-wide hidden layer and 33 outputs, or raise.
    """
    if planes.device.type == "cpu":
        return trigrid_decode_plain(planes, coords, box_warp, decoder)
    name = "trigrid_decode"
    planes, coords = planes.contiguous(), coords.contiguous()
    if planes.dim() != 6:
        raise ValueError(f"{name}: planes must be [B,3,D,H,W,32], got "
                         f"{tuple(planes.shape)}")
    w0, b0, w1, b1 = _folded_mlp(name, decoder, planes, coords)
    b, _, d, h, w, _ = planes.shape
    m = coords.shape[1]
    rgb = torch.empty((b, m, 32), device=planes.device)
    sigma = torch.empty((b, m, 1), device=planes.device)
    kernels.launch("r3dp_trigrid_decode", planes, b, d, h, w, coords, m, 2.0 / box_warp,
                   w0, b0, w1, b1, rgb, sigma)
    trigrid_decode.launches += 1
    return rgb, sigma


trigrid_decode.launches = 0

"""Volume-rendering equation over sampled colours and densities (port of
``real3dportrait_tpu/rendering/ray_marcher.py``): midpoint quadrature,
softplus(sigma - 1), alpha compositing, rgb mapped to [-1, 1].

These are the plain semantics; on the render path the coarse march runs
inside kernel K2 and the merged march inside kernel K3
(``rendering/renderer.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def march_weights(densities: torch.Tensor, depths: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """densities/depths [B,M,S,1] -> (weights [B,M,S-1,1], w_c [B,M,S],
    depths_mid [B,M,S-1,1]).

    ``w_c`` is the per-sample composite weight:
    ``sum_s w_c[s] v[s] == sum_i weights[i] (v[i] + v[i+1]) / 2``.
    """
    deltas = depths[:, :, 1:] - depths[:, :, :-1]
    densities_mid = F.softplus((densities[:, :, :-1] + densities[:, :, 1:]) / 2 - 1.0)
    depths_mid = (depths[:, :, :-1] + depths[:, :, 1:]) / 2
    alpha = 1.0 - torch.exp(-(densities_mid * deltas))
    alpha_shifted = torch.cat([torch.ones_like(alpha[:, :, :1]), 1.0 - alpha + 1e-10], dim=-2)
    transmittance = torch.cumprod(alpha_shifted, dim=-2)[:, :, :-1]
    weights = alpha * transmittance
    w = weights[..., 0]
    zero = torch.zeros_like(w[..., :1])
    w_c = (torch.cat([zero, w], dim=-1) + torch.cat([w, zero], dim=-1)) / 2.0
    return weights, w_c, depths_mid


def march_rays(colors: torch.Tensor, densities: torch.Tensor, depths: torch.Tensor,
               white_back: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """colors [B,M,S,C], densities/depths [B,M,S,1] ->
    (rgb [B,M,C] in [-1,1], depth [B,M,1], weights [B,M,S-1,1])."""
    weights, w_c, depths_mid = march_weights(densities, depths)
    composite_rgb = torch.einsum("bms,bmsc->bmc", w_c, colors)
    weight_total = weights.sum(dim=-2)
    composite_depth = (weights * depths_mid).sum(dim=-2) / weight_total
    composite_depth = torch.nan_to_num(composite_depth, nan=float("inf"))
    composite_depth = torch.clamp(composite_depth, depths.min(), depths.max())
    if white_back:
        composite_rgb = composite_rgb + 1.0 - weight_total
    return composite_rgb * 2.0 - 1.0, composite_depth, weights

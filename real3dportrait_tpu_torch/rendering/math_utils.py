"""Ray/box math for the volume renderer (port of
``real3dportrait_tpu/rendering/math_utils.py``)."""

from __future__ import annotations

import torch


def get_ray_limits_box(rays_o: torch.Tensor, rays_d: torch.Tensor,
                       box_side_length: float
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Intersect rays [...,3] with the centred AABB of side ``box_side_length``.

    Returns (t_min [...,1], t_max [...,1], is_valid [...]); invalid rays get
    t_min = -1, t_max = -2.
    """
    half = box_side_length / 2.0
    invdir = 1.0 / rays_d
    t_lo = (-half - rays_o) * invdir
    t_hi = (half - rays_o) * invdir
    tmin = torch.minimum(t_lo, t_hi).amax(dim=-1)
    tmax = torch.maximum(t_lo, t_hi).amin(dim=-1)
    is_valid = tmin <= tmax
    tmin = torch.where(is_valid, tmin, torch.full_like(tmin, -1.0))
    tmax = torch.where(is_valid, tmax, torch.full_like(tmax, -2.0))
    return tmin[..., None], tmax[..., None], is_valid


def broadcast_linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """Evenly spaced values, shape [num, *start.shape]."""
    steps = torch.arange(num, dtype=torch.float32, device=start.device) / (num - 1)
    steps = steps.reshape((num,) + (1,) * start.dim())
    return start[None] + steps * (stop - start)[None]

"""Camera rays from cam2world + intrinsics (port of
``real3dportrait_tpu/rendering/ray_sampler.py``): OpenCV convention,
normalized intrinsics, pixel centres at (i + 0.5) / resolution, row-major."""

from __future__ import annotations

import torch


def sample_rays(cam2world: torch.Tensor, intrinsics: torch.Tensor, resolution: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B,4,4], [B,3,3], res -> (origins [B,res*res,3], dirs [B,res*res,3])."""
    n = cam2world.shape[0]
    dev = cam2world.device
    fx = intrinsics[:, 0, 0][:, None]
    fy = intrinsics[:, 1, 1][:, None]
    cx = intrinsics[:, 0, 2][:, None]
    cy = intrinsics[:, 1, 2][:, None]
    sk = intrinsics[:, 0, 1][:, None]

    coords = (torch.arange(resolution, dtype=torch.float32, device=dev) + 0.5) / resolution
    yy, xx = torch.meshgrid(coords, coords, indexing="ij")
    x_cam = xx.reshape(1, -1)
    y_cam = yy.reshape(1, -1)
    z_cam = torch.ones_like(x_cam)

    x_lift = (x_cam - cx + cy * sk / fy - sk * y_cam / fy) / fx * z_cam
    y_lift = (y_cam - cy) / fy * z_cam
    m = x_cam.shape[1]
    cam_rel = torch.stack([x_lift.expand(n, m), y_lift.expand(n, m),
                           z_cam.expand(n, m), torch.ones((n, m), device=dev)], dim=-1)

    world = torch.einsum("bij,bmj->bmi", cam2world, cam_rel)[..., :3]
    origins = cam2world[:, :3, 3][:, None, :]
    dirs = world - origins
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return origins.expand_as(dirs).contiguous(), dirs

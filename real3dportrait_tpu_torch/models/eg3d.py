"""The EG3D tri-plane generator (port of ``real3dportrait_tpu/models/eg3d.py``),
trained by ``training/tasks/eg3d_task.py`` and the frozen teacher of the
img2plane distillation.

A latent z and a camera map to 14 latents (:class:`MappingNetwork`); the
const-input StyleGAN2 :class:`SynthesisNetwork` turns them into a
[B, 256, 256, 96] image, split into three 32-channel planes
[B, 3, 256, 256, 32] (:meth:`TriPlaneGenerator.cal_planes`); the shared
renderer draws them at ``neural_rendering_resolution`` (kernels K1, K2,
K3 on the card) and :class:`SuperresolutionHybrid8XDC` lifts the render,
on all-ones latents, to ``final_resolution`` (kernels K6a, K6b, in bf16
with ``sr_num_fp16_res > 0``). Parameter names follow the Flax tree.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn as nn

from real3dportrait_tpu_torch.geometry.camera import unpack_camera
from real3dportrait_tpu_torch.models.decoder import OSGDecoder
from real3dportrait_tpu_torch.models.stylegan2 import MappingNetwork, SynthesisNetwork
from real3dportrait_tpu_torch.models.superresolution import SuperresolutionHybrid8XDC
from real3dportrait_tpu_torch.rendering.ray_sampler import sample_rays
from real3dportrait_tpu_torch.rendering.renderer import RenderOptions, render_rays


class TriPlaneGenerator(nn.Module):
    def __init__(self, z_dim: int = 512, w_dim: int = 512, camera_dim: int = 25,
                 plane_resolution: int = 256, triplane_hid_dim: int = 32,
                 neural_rendering_resolution: int = 128, final_resolution: int = 512,
                 channel_base: int = 32768, channel_max: int = 512, mapping_layers: int = 2,
                 sr_num_fp16_res: int = 4, num_samples_coarse: int = 48,
                 num_samples_fine: int = 48, box_warp: float = 1.0,
                 ray_near: Any = "auto", ray_far: Any = "auto"):
        super().__init__()
        self.z_dim, self.w_dim = z_dim, w_dim
        self.triplane_hid_dim = triplane_hid_dim
        self.neural_rendering_resolution = neural_rendering_resolution
        self.render_options = RenderOptions(
            depth_resolution=num_samples_coarse, depth_resolution_importance=num_samples_fine,
            box_warp=box_warp, ray_start=ray_near, ray_end=ray_far)
        self.backbone = SynthesisNetwork(w_dim, plane_resolution, 3 * triplane_hid_dim,
                                         channel_base=channel_base, channel_max=channel_max)
        self.mapping = MappingNetwork(camera_dim, w_dim, num_layers=mapping_layers, z_dim=z_dim,
                                      num_ws=self.backbone.num_ws)
        self.decoder = OSGDecoder(triplane_hid_dim, hidden_dim=64, output_dim=triplane_hid_dim)
        self.superresolution = SuperresolutionHybrid8XDC(
            triplane_hid_dim, w_dim=w_dim, sr_num_fp16_res=sr_num_fp16_res,
            input_resolution=neural_rendering_resolution, final_resolution=final_resolution)

    def map_latents(self, z: torch.Tensor, camera: torch.Tensor, truncation_psi: float = 1.0,
                    update_emas: bool = False) -> torch.Tensor:
        """z [B,z_dim], camera [B,25] -> ws [B,num_ws,w_dim]."""
        return self.mapping(camera, z, truncation_psi=truncation_psi, update_emas=update_emas)

    def cal_planes(self, ws: torch.Tensor, noise_mode: str = "const") -> torch.Tensor:
        """ws -> tri-planes [B,3,H,W,C], contiguous (the layout K1 reads):
        channel k * C + c of the synthesis image is channel c of plane k."""
        img = self.backbone.forward_nchw(ws, noise_mode=noise_mode)    # [B,3C,H,W]
        b, _, h, w = img.shape
        planes = img.reshape(b, 3, self.triplane_hid_dim, h, w).permute(0, 1, 3, 4, 2)
        return planes.contiguous()

    def sample_points(self, planes: torch.Tensor, coordinates: torch.Tensor) -> dict:
        """Decode {'rgb', 'sigma'} at world ``coordinates`` [B or 1,M,3] (the
        density regulariser's points; a batch of 1 serves every plane)."""
        if coordinates.shape[0] == 1 and planes.shape[0] > 1:
            coordinates = coordinates.expand(planes.shape[0], -1, -1)
        rgb, sigma = self.decoder.decode_points(planes, coordinates,
                                                self.render_options.box_warp)
        return {"rgb": rgb, "sigma": sigma}

    def synthesis(self, ws: torch.Tensor, camera: torch.Tensor, draws=None,
                  noise_mode: str = "const") -> dict:
        """Planes from ``ws``, rendered under ``camera`` [B,25] (random depths
        from ``draws`` where given, else the deterministic render), then SR
        on all-ones latents: {image [B,H,W,3], image_raw, image_depth,
        plane}."""
        planes = self.cal_planes(ws, noise_mode=noise_mode)
        c2w, intrinsics = unpack_camera(camera)
        res = self.neural_rendering_resolution
        origins, dirs = sample_rays(c2w, intrinsics, res)
        out = render_rays(planes, self.decoder, origins, dirs, self.render_options, draws)
        b = camera.shape[0]
        feature_image = out["rgb"].reshape(b, res, res, -1)
        rgb_image = feature_image[..., :3]
        ones_ws = torch.ones((b, 14, self.w_dim), device=feature_image.device)
        sr_image = self.superresolution(rgb_image, feature_image, ones_ws,
                                        noise_mode=noise_mode)
        return {"image": torch.clamp(sr_image, -1, 1),
                "image_raw": torch.clamp(rgb_image, -1, 1),
                "image_depth": out["depth"].reshape(b, res, res, 1),
                "plane": planes}

    def forward(self, z: torch.Tensor, camera: torch.Tensor, truncation_psi: float = 1.0,
                update_emas: bool = False, draws=None, noise_mode: str = "const") -> dict:
        ws = self.map_latents(z, camera, truncation_psi=truncation_psi, update_emas=update_emas)
        return self.synthesis(ws, camera, draws=draws, noise_mode=noise_mode)

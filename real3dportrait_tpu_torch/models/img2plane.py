"""One-shot avatar models: image -> tri-plane -> rendered portrait.

Port of ``real3dportrait_tpu/models/img2plane.py`` for plain tri-planes
(``triplane_feature_type="triplane"``, the released configuration) in
fp32:

* :class:`OSAvatarImg2Plane` — canonical backbone + ``OSGDecoder`` +
  volume renderer + SR head;
* :class:`OSAvatarSECCImg2Plane` — adds the SECC SegFormer whose residual
  plane is fused with the cached canonical plane.

The canonical plane is an explicit input: :meth:`cal_cano_plane` runs once
per video and the per-frame path takes its result.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn as nn

from real3dportrait_tpu_torch.geometry.camera import unpack_camera
from real3dportrait_tpu_torch.models.decoder import OSGDecoder
from real3dportrait_tpu_torch.models.segformer import (
    SegFormerImg2PlaneBackbone,
    SegFormerSECC2PlaneBackbone,
)
from real3dportrait_tpu_torch.models.superresolution import SuperresolutionHybrid8XDC
from real3dportrait_tpu_torch.rendering.ray_sampler import sample_rays
from real3dportrait_tpu_torch.rendering.renderer import RenderOptions, render_rays


class OSAvatarImg2Plane(nn.Module):
    """One-shot image -> canonical plane -> rendered image."""

    def __init__(self, triplane_hid_dim: int = 32, triplane_depth: int = 1,
                 triplane_feature_type: str = "triplane",
                 neural_rendering_resolution: int = 128, final_resolution: int = 512,
                 backbone_mode: str = "composite", backbone_scale: str = "standard",
                 composite_vit_dim: int = 1024, w_dim: int = 512,
                 sr_num_fp16_res: int = 0, sr_channel0: int = 256,
                 sr_channel1: int = 128, num_samples_coarse: int = 48,
                 num_samples_fine: int = 48, box_warp: float = 1.0,
                 ray_near: Any = "auto", ray_far: Any = "auto",
                 head_norm_mode: str = "folded_bn"):
        super().__init__()
        if triplane_feature_type != "triplane" or triplane_depth != 1:
            raise NotImplementedError(
                "only plain tri-planes (depth 1) are ported; tri-grids need the "
                "K1-trigrid kernel (ROADMAP queue 2)")
        self.triplane_hid_dim = triplane_hid_dim
        self.neural_rendering_resolution = neural_rendering_resolution
        self.w_dim = w_dim
        self.render_options = RenderOptions(
            depth_resolution=num_samples_coarse,
            depth_resolution_importance=num_samples_fine,
            box_warp=box_warp, ray_start=ray_near, ray_end=ray_far)
        plane_channels = triplane_hid_dim * triplane_depth
        if backbone_mode == "composite":
            from real3dportrait_tpu_torch.models.img2plane_composite import (
                CompositeImg2PlaneBackbone,
            )

            self.img2plane_backbone = CompositeImg2PlaneBackbone(
                plane_channels=plane_channels,
                scale=backbone_scale if backbone_scale in ("small", "standard", "large")
                else "standard",
                vit_dim=composite_vit_dim,
                norm_mode="affine" if head_norm_mode == "folded_bn" else head_norm_mode)
        else:
            self.img2plane_backbone = SegFormerImg2PlaneBackbone(
                scale=backbone_scale, plane_channels=plane_channels,
                head_norm_mode=head_norm_mode)
        self.decoder = OSGDecoder(plane_channels, hidden_dim=64,
                                  output_dim=triplane_hid_dim)
        self.superresolution = SuperresolutionHybrid8XDC(
            triplane_hid_dim, w_dim=w_dim, sr_num_fp16_res=sr_num_fp16_res,
            input_resolution=neural_rendering_resolution,
            block0_channels=sr_channel0, block1_channels=sr_channel1,
            final_resolution=final_resolution)

    def cal_cano_plane(self, img: torch.Tensor) -> torch.Tensor:
        """Source image [B,H,W,3] -> canonical plane [B,3,H/2,W/2,C]."""
        return self.img2plane_backbone(img)

    def render_planes(self, planes: torch.Tensor, camera: torch.Tensor,
                      noise_mode: str = "none") -> dict:
        """Volume-render planes under ``camera`` [B,25], then SR."""
        c2w, intrinsics = unpack_camera(camera)
        res = self.neural_rendering_resolution
        origins, dirs = sample_rays(c2w, intrinsics, res)
        out = render_rays(planes, self.decoder, origins, dirs, self.render_options)
        b = camera.shape[0]
        feature_image = out["rgb"].reshape(b, res, res, -1)
        depth_image = out["depth"].reshape(b, res, res, 1)
        weights_image = out["weights_sum"].reshape(b, res, res, 1)
        rgb_image = feature_image[..., :3]
        ones_ws = torch.ones((b, 14, self.w_dim), device=feature_image.device)
        sr_image = self.superresolution(rgb_image, feature_image, ones_ws,
                                        noise_mode=noise_mode)
        return {
            "image": torch.clamp(sr_image, -1, 1),
            "image_raw": torch.clamp(rgb_image, -1, 1),
            "image_depth": depth_image,
            "image_feature": feature_image[..., 3:],
            "weights_img": weights_image,
            "plane": planes,
        }

    def synthesis(self, img: torch.Tensor, camera: torch.Tensor,
                  planes: torch.Tensor | None = None, noise_mode: str = "none") -> dict:
        if planes is None:
            planes = self.cal_cano_plane(img)
        return self.render_planes(planes, camera, noise_mode=noise_mode)

    def forward(self, img, camera, **kw) -> dict:
        return self.synthesis(img, camera, **kw)


class OSAvatarSECCImg2Plane(OSAvatarImg2Plane):
    """Adds SECC motion conditioning."""

    def __init__(self, pncc_cond_mode: str = "cano_src_tgt",
                 secc_segformer_scale: str = "b0", plane_fusion_mode: str = "add",
                 **kwargs):
        super().__init__(**kwargs)
        self.plane_fusion_mode = plane_fusion_mode
        self.secc_img2plane_backbone = SegFormerSECC2PlaneBackbone(
            scale=secc_segformer_scale,
            plane_channels=self.triplane_hid_dim,
            pncc_cond_mode=pncc_cond_mode,
            head_norm_mode=kwargs.get("head_norm_mode", "folded_bn"))

    def cal_secc_plane(self, secc: torch.Tensor) -> torch.Tensor:
        """SECC condition maps [B,H,W,6|9] -> motion residual plane."""
        return self.secc_img2plane_backbone(secc)

    def cal_plane_given_cano(self, cano_plane: torch.Tensor, secc: torch.Tensor
                             ) -> torch.Tensor:
        secc_plane = self.cal_secc_plane(secc)
        if self.plane_fusion_mode == "add":
            return cano_plane + secc_plane
        return cano_plane * secc_plane

    def synthesis(self, img: torch.Tensor | None, camera: torch.Tensor,
                  secc: torch.Tensor | None = None,
                  cano_planes: torch.Tensor | None = None,
                  noise_mode: str = "none") -> dict:
        if cano_planes is None:
            cano_planes = self.cal_cano_plane(img)
        planes = (self.cal_plane_given_cano(cano_planes, secc)
                  if secc is not None else cano_planes)
        out = self.render_planes(planes, camera, noise_mode=noise_mode)
        out["cano_plane"] = cano_planes
        return out

    def forward(self, img, camera, secc=None, **kw) -> dict:
        return self.synthesis(img, camera, secc=secc, **kw)

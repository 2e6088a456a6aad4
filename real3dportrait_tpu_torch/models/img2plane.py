"""One-shot avatar models: image -> tri-plane or tri-grid -> rendered portrait.

Port of ``real3dportrait_tpu/models/img2plane.py``:

* :class:`OSAvatarImg2Plane` — canonical backbone + ``OSGDecoder`` +
  volume renderer + SR head;
* :class:`OSAvatarSECCImg2Plane` — adds the SECC SegFormer whose residual
  plane is fused with the cached canonical plane;
* :class:`OSAvatarSECCImg2PlaneTorso` — replaces the SR head with the
  torso/background fusion head of ``models/sr_with_ref.py``.

``triplane_feature_type`` is ``triplane`` (planes [B,3,H,W,C], the released
checkpoints, depth 1), ``trigrid`` (tri-grids [B,3,D,H,W,C], the class
default and every training stage's geometry) or ``trigrid_v2`` (tri-grids
refined by :class:`Plane2GridModule`). The backbones emit ``C*D`` channels
per plane; :meth:`OSAvatarImg2Plane.to_render_layout` splits them. The
class defaults are the JAX package's: tri-grids of depth 3 x 32 channels,
the SegFormer-b0 canonical backbone, GroupNorm heads and four bf16 SR
resolutions.

The per-video caches are explicit inputs: :meth:`cal_cano_plane` (and, for
the torso model, ``cal_torso_appearance`` and ``cal_bg_feat``) run once per
video and the per-frame path takes their results.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn as nn
import torch.nn.functional as F

from real3dportrait_tpu_torch.geometry.camera import unpack_camera
from real3dportrait_tpu_torch.models.decoder import OSGDecoder
from real3dportrait_tpu_torch.models.segformer import (
    SegFormerImg2PlaneBackbone,
    SegFormerSECC2PlaneBackbone,
)
from real3dportrait_tpu_torch.models.superresolution import SuperresolutionHybrid8XDC
from real3dportrait_tpu_torch.rendering.ray_sampler import sample_rays
from real3dportrait_tpu_torch.rendering.renderer import RenderOptions, render_rays


class SameBlock3d(nn.Module):
    """3D-conv residual block on NCDHW: GroupNorm(4) -> relu -> edge-padded
    3x3x3 conv, twice, added back with a learned scale ``alpha`` (init
    0.01)."""

    def __init__(self, feats: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(4, feats, eps=1e-6)
        self.conv1 = nn.Conv3d(feats, feats, 3)
        self.norm2 = nn.GroupNorm(4, feats, eps=1e-6)
        self.conv2 = nn.Conv3d(feats, feats, 3)
        self.alpha = nn.Parameter(torch.full((1,), 0.01))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.pad(F.relu(self.norm1(x)), (1,) * 6, mode="replicate"))
        h = self.conv2(F.pad(F.relu(self.norm2(h)), (1,) * 6, mode="replicate"))
        return x + self.alpha * h


class Plane2GridModule(nn.Module):
    """3D-conv refinement of tri-grids [B,3,D,H,W,C] for
    ``triplane_feature_type="trigrid_v2"``, shared by the canonical and
    SECC plane paths: one :class:`SameBlock3d` (two above depth 3) over
    each plane's [D,H,W] volume."""

    def __init__(self, triplane_depth: int = 3, channels: int = 32):
        super().__init__()
        self.n_blocks = 1 if triplane_depth <= 3 else 2
        for i in range(self.n_blocks):
            setattr(self, f"block{i}", SameBlock3d(channels))

    def forward(self, planes: torch.Tensor) -> torch.Tensor:
        b, k, d, h, w, c = planes.shape
        x = planes.reshape(b * k, d, h, w, c).permute(0, 4, 1, 2, 3)
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
        return x.permute(0, 2, 3, 4, 1).reshape(b, k, d, h, w, c)


class OSAvatarImg2Plane(nn.Module):
    """One-shot image -> canonical plane -> rendered image."""

    def __init__(self, triplane_hid_dim: int = 32, triplane_depth: int = 3,
                 triplane_feature_type: str = "trigrid",
                 neural_rendering_resolution: int = 128, final_resolution: int = 512,
                 backbone_mode: str = "segformer", backbone_scale: str = "b0",
                 composite_vit_dim: int = 1024, w_dim: int = 512,
                 sr_num_fp16_res: int = 4, sr_channel0: int = 256,
                 sr_channel1: int = 128, num_samples_coarse: int = 48,
                 num_samples_fine: int = 48, box_warp: float = 1.0,
                 ray_near: Any = "auto", ray_far: Any = "auto",
                 head_norm_mode: str = "gn"):
        super().__init__()
        if triplane_feature_type not in ("triplane", "trigrid", "trigrid_v2"):
            raise ValueError("triplane_feature_type must be triplane, trigrid or "
                             f"trigrid_v2, got {triplane_feature_type!r}")
        self.triplane_hid_dim = triplane_hid_dim
        self.triplane_depth = triplane_depth
        self.triplane_feature_type = triplane_feature_type
        self.head_norm_mode = head_norm_mode
        self.neural_rendering_resolution = neural_rendering_resolution
        self.final_resolution = final_resolution
        self.w_dim = w_dim
        self.render_options = RenderOptions(
            depth_resolution=num_samples_coarse,
            depth_resolution_importance=num_samples_fine,
            box_warp=box_warp, ray_start=ray_near, ray_end=ray_far)
        plane_channels = self.plane_channels
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
        # a tri-grid's sample has C channels, a tri-plane's all C*D
        self.decoder = OSGDecoder(
            plane_channels if triplane_feature_type == "triplane" else triplane_hid_dim,
            hidden_dim=64, output_dim=triplane_hid_dim)
        if triplane_feature_type == "trigrid_v2":
            self.plane2grid_module = Plane2GridModule(triplane_depth, triplane_hid_dim)
        self.superresolution = self._make_superresolution(dict(
            channels=triplane_hid_dim, w_dim=w_dim, sr_num_fp16_res=sr_num_fp16_res,
            input_resolution=neural_rendering_resolution,
            block0_channels=sr_channel0, block1_channels=sr_channel1,
            final_resolution=final_resolution))

    def _make_superresolution(self, sr_kwargs: dict) -> nn.Module:
        """SR-head factory; the torso model builds its warp/fusion head."""
        return SuperresolutionHybrid8XDC(**sr_kwargs)

    @property
    def plane_channels(self) -> int:
        return self.triplane_hid_dim * self.triplane_depth

    def to_render_layout(self, planes: torch.Tensor) -> torch.Tensor:
        """Backbone planes [B,3,H,W,C*D] -> tri-planes [B,3,H,W,C] or
        tri-grids [B,3,D,H,W,C]: channel ``c*D + d`` is depth slice d of
        feature c."""
        if self.triplane_feature_type == "triplane":
            return planes
        b, k, h, w, _ = planes.shape
        planes = planes.reshape(b, k, h, w, self.triplane_hid_dim, self.triplane_depth)
        planes = planes.movedim(-1, 2)
        if self.triplane_feature_type == "trigrid_v2":
            planes = self.plane2grid_module(planes)
        return planes

    def cal_cano_plane(self, img: torch.Tensor) -> torch.Tensor:
        """Source image [B,H,W,3] -> canonical plane in render layout,
        contiguous: laid out once per video, so that the per-frame fusion
        (``cano_plane`` first) writes the planes in the layout kernels K1
        and K1-trigrid read, and their wrappers copy nothing."""
        return self.to_render_layout(self.img2plane_backbone(img)).contiguous()

    def _forward_sr(self, rgb_image: torch.Tensor, feature_image: torch.Tensor,
                    ws: torch.Tensor, weights_image: torch.Tensor, cond: dict | None,
                    noise_mode: str) -> tuple[torch.Tensor, dict]:
        """(SR image, extra outputs); the plain SR head ignores ``cond``."""
        return self.superresolution(rgb_image, feature_image, ws, noise_mode=noise_mode), {}

    def render_planes(self, planes: torch.Tensor, camera: torch.Tensor,
                      noise_mode: str = "none", cond: dict | None = None,
                      draws=None) -> dict:
        """Volume-render planes under ``camera`` [B,25], then SR. ``draws``
        (``utils/draws.Draws``) makes the training render's random depths
        (the JAX package's ``key``); without it the render is
        deterministic."""
        c2w, intrinsics = unpack_camera(camera)
        res = self.neural_rendering_resolution
        origins, dirs = sample_rays(c2w, intrinsics, res)
        out = render_rays(planes, self.decoder, origins, dirs, self.render_options, draws)
        b = camera.shape[0]
        feature_image = out["rgb"].reshape(b, res, res, -1)
        depth_image = out["depth"].reshape(b, res, res, 1)
        weights_image = out["weights_sum"].reshape(b, res, res, 1)
        rgb_image = feature_image[..., :3]
        ones_ws = torch.ones((b, 14, self.w_dim), device=feature_image.device)
        sr_image, extra = self._forward_sr(rgb_image, feature_image, ones_ws,
                                           weights_image, cond, noise_mode)
        return {
            "image": torch.clamp(sr_image, -1, 1),
            "image_raw": torch.clamp(rgb_image, -1, 1),
            "image_depth": depth_image,
            "image_feature": feature_image[..., 3:],
            "weights_img": weights_image,
            "plane": planes,
            **extra,
        }

    def sample_points(self, planes: torch.Tensor, coordinates: torch.Tensor) -> dict:
        """Decode {'rgb', 'sigma'} at world ``coordinates`` [B or 1,M,3] (the
        density regulariser's points; a batch of 1 serves every plane)."""
        if coordinates.shape[0] == 1 and planes.shape[0] > 1:
            coordinates = coordinates.expand(planes.shape[0], -1, -1)
        rgb, sigma = self.decoder.decode_points(planes, coordinates,
                                                self.render_options.box_warp)
        return {"rgb": rgb, "sigma": sigma}

    def synthesis(self, img: torch.Tensor, camera: torch.Tensor,
                  planes: torch.Tensor | None = None, noise_mode: str = "none",
                  draws=None) -> dict:
        if planes is None:
            planes = self.cal_cano_plane(img)
        return self.render_planes(planes, camera, noise_mode=noise_mode, draws=draws)

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
            plane_channels=self.plane_channels,
            pncc_cond_mode=pncc_cond_mode,
            head_norm_mode=self.head_norm_mode)

    def cal_secc_plane(self, secc: torch.Tensor) -> torch.Tensor:
        """SECC condition maps [B,H,W,6|9] -> motion residual plane in
        render layout."""
        return self.to_render_layout(self.secc_img2plane_backbone(secc))

    def cal_plane_given_cano(self, cano_plane: torch.Tensor, secc: torch.Tensor
                             ) -> torch.Tensor:
        secc_plane = self.cal_secc_plane(secc)
        if self.plane_fusion_mode == "add":
            return cano_plane + secc_plane
        return cano_plane * secc_plane

    def synthesis(self, img: torch.Tensor | None, camera: torch.Tensor,
                  secc: torch.Tensor | None = None,
                  cano_planes: torch.Tensor | None = None,
                  noise_mode: str = "none", cond: dict | None = None, draws=None) -> dict:
        if cano_planes is None:
            cano_planes = self.cal_cano_plane(img)
        planes = (self.cal_plane_given_cano(cano_planes, secc)
                  if secc is not None else cano_planes)
        out = self.render_planes(planes, camera, noise_mode=noise_mode, cond=cond,
                                 draws=draws)
        out["cano_plane"] = cano_planes
        return out

    def forward(self, img, camera, secc=None, **kw) -> dict:
        return self.synthesis(img, camera, secc=secc, **kw)


class OSAvatarSECCImg2PlaneTorso(OSAvatarSECCImg2Plane):
    """Head + torso + background: the plain SR head is replaced by the
    warp-based torso/background fusion head
    (:class:`SuperresolutionHybrid8XDCWarp`); plane caching, SECC fusion and
    the renderer are inherited. ``cond`` carries ``ref_torso_img``,
    ``bg_img``, ``segmap`` [B,H,W,6], ``kp_src`` and ``kp_drv`` [B,68,3],
    and optionally the per-video caches ``torso_appearance``
    (:meth:`cal_torso_appearance`) and ``bg_feat`` (:meth:`cal_bg_feat`),
    and ``target_torso_mask`` [B,H,W] (weighs the occlusion regularisers).
    Besides the renders, the output carries the torso model's outputs
    (``torso_ret``) and, where a gradient is recorded, its occlusion
    regularisers (``facev2v_losses``).
    """

    def __init__(self, torso_kp_num: int = 4, torso_scale: str = "standard",
                 fuse_mode: str = "v2", head_threshold: float = 0.9,
                 torso_version: str = "v2", torso_inp_mode: str = "rgb_alpha", **kwargs):
        norm = kwargs.get("head_norm_mode", "gn")
        # read by _make_superresolution during the base class's __init__
        self.torso_kwargs = dict(
            torso_kp_num=torso_kp_num, torso_scale=torso_scale, fuse_mode=fuse_mode,
            head_threshold=head_threshold, torso_version=torso_version,
            torso_inp_mode=torso_inp_mode,
            torso_norm_mode="affine" if norm == "folded_bn" else norm)
        super().__init__(**kwargs)

    def _make_superresolution(self, sr_kwargs: dict) -> nn.Module:
        from real3dportrait_tpu_torch.models.sr_with_ref import SuperresolutionHybrid8XDCWarp

        final = sr_kwargs["final_resolution"]
        return SuperresolutionHybrid8XDCWarp(mid_resolution=final // 2, **sr_kwargs,
                                             **self.torso_kwargs)

    def cal_torso_appearance(self, cond: dict) -> torch.Tensor:
        """Per-video torso appearance volume [B,D,h,w,C] from
        ``cond["ref_torso_img"]`` and ``cond["segmap"]``; pass it back as
        ``cond["torso_appearance"]``."""
        return self.superresolution.torso_appearance(cond["ref_torso_img"], cond["segmap"])

    def cal_bg_feat(self, cond: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-video background cache from ``cond["bg_img"]``; pass it back
        as ``cond["bg_feat"]``, which then overrides ``cond["bg_img"]``."""
        return self.superresolution.encode_bg(cond["bg_img"])

    def _forward_sr(self, rgb_image, feature_image, ws, weights_image, cond, noise_mode):
        sr_image, torso_ret = self.superresolution(
            rgb_image, feature_image, ws,
            ref_torso_rgb=cond["ref_torso_img"], ref_bg_rgb=cond.get("bg_img"),
            weights_img=weights_image, segmap=cond["segmap"], kp_s=cond["kp_src"],
            kp_d=cond["kp_drv"], noise_mode=noise_mode,
            appearance_volume=cond.get("torso_appearance"), bg_feat=cond.get("bg_feat"),
            target_torso_mask=cond.get("target_torso_mask"))
        extra = {"torso_ret": {k: v for k, v in torso_ret.items() if k != "losses"}}
        if "losses" in torso_ret:
            extra["facev2v_losses"] = torso_ret["losses"]
        return sr_image, extra

    def synthesis(self, img: torch.Tensor | None, camera: torch.Tensor,
                  cond: dict | None = None, secc: torch.Tensor | None = None,
                  cano_planes: torch.Tensor | None = None, noise_mode: str = "none",
                  draws=None) -> dict:
        if cond is None:
            raise ValueError("the torso model needs the cond dict")
        return super().synthesis(img, camera, secc=secc, cano_planes=cano_planes,
                                 noise_mode=noise_mode, cond=cond, draws=draws)

    def forward(self, img, camera, cond=None, secc=None, **kw) -> dict:
        return self.synthesis(img, camera, cond=cond, secc=secc, **kw)

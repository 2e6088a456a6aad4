"""One-shot talking-portrait synthesis on PyTorch.

Port of ``real3dportrait_tpu/inference/pipeline.py`` (``Real3DPortraitPipeline``)
from an expression sequence to frames, with the torso/background model
(``use_torso=True``, the default, as in the JAX package) or the head only.
Per video it rasterizes the canonical and source SECC maps and computes the
canonical tri-plane once, and for the torso model the torso appearance
volume and the background feature; per frame it rasterizes the target SECC
map (kernel K4) and runs the frame step: SECC SegFormer -> plane fusion ->
two-pass render (kernels K1-K3) -> SR head (the StyleGAN2 epilogue and
resampling are kernels K6a/K6b; the torso head adds the warped torso,
kernels K5a/K5b).

Without source preparation the torso is driven as the JAX pipeline drives
it then: the source image is also the torso and background image, the
segmap is all torso (class 4) and the keypoints are zero, so every warp is
an identity warp. ``bg_img`` replaces the background.

Without a config the model is the JAX pipeline's default,
``configs/secc_img2plane_torso.yaml``: tri-grids of depth 3 x 32 channels
(kernel K1-trigrid), the composite canonical backbone with GroupNorms and
bf16 SR blocks; ``configs/real3d_orig.yaml`` is the released checkpoints'
geometry (tri-planes of depth 1, kernel K1, folded BatchNorms, fp32 SR).
The pipeline runs on ``device="cuda"`` unless it is given another device.

Without released checkpoints, ``mock_weights=True`` draws every weight from
a ``torch.Generator`` seeded with ``seed``; the graph is the same, only the
pixels are untrained.
"""

from __future__ import annotations

import os
import time
from collections.abc import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from real3dportrait_tpu_torch import entry_device
from real3dportrait_tpu_torch.config import load_config
from real3dportrait_tpu_torch.geometry.bfm import BFMAssets, load_or_synthetic_bfm
from real3dportrait_tpu_torch.geometry.camera import (
    convert_eg3d_convention,
    pack_camera,
    smooth_camera_sequence,
)
from real3dportrait_tpu_torch.geometry.secc_renderer import SECCRenderer
from real3dportrait_tpu_torch.models.img2plane import (
    OSAvatarSECCImg2Plane,
    OSAvatarSECCImg2PlaneTorso,
)
from real3dportrait_tpu_torch.weights import mock_init_

# Shared by value with the JAX package's pipeline (SAMPLING_PRESETS and the
# shipped default).
SAMPLING_PRESETS: dict[str, tuple[int, int] | None] = {
    "reference": (48, 48),
    "balanced": (24, 32),
    "fast": (16, 32),
    "config": None,
}
SHIPPED_SAMPLING_PRESET = "fast"

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the JAX pipeline's default model
DEFAULT_CONFIG = os.path.join(_ROOT, "configs", "secc_img2plane_torso.yaml")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, {item})")


def mirror_index(idx: torch.Tensor, length: int) -> torch.Tensor:
    """Ping-pong looping index."""
    period = 2 * (length - 1) if length > 1 else 1
    r = torch.remainder(idx, period)
    return torch.where(r < length, r, period - r)


def map_pose_to_source(euler, trans, src_euler, src_trans, z_fix: bool = True,
                       map_to_init: bool = True):
    """Hold the driving depth at frame 0 and offset the sequence so frame 0
    coincides with the source pose."""
    euler, trans = euler.clone(), trans.clone()
    if z_fix:
        trans[:, 2] = trans[0, 2]
    if map_to_init:
        euler = euler + (src_euler.reshape(1, 3) - euler[:1])
        trans = trans + (src_trans.reshape(1, 3) - trans[:1])
    return euler, trans


def build_model(cfg: Mapping, use_torso: bool = True) -> torch.nn.Module:
    """The synthesis model a config describes, from the keys the JAX
    pipeline reads, with the sampling preset's sample counts."""
    preset = cfg.get("sampling_preset", "config")
    if preset not in SAMPLING_PRESETS:
        raise ValueError(f"sampling_preset must be one of {sorted(SAMPLING_PRESETS)}, "
                         f"got {preset!r}")
    picked = SAMPLING_PRESETS[preset]
    if picked is None:
        n_coarse = int(cfg.get("num_samples_coarse", 48))
        n_fine = int(cfg.get("num_samples_fine", 48))
    else:
        n_coarse, n_fine = picked
    model_kwargs = dict(
        triplane_hid_dim=int(cfg.get("triplane_hid_dim", 32)),
        triplane_depth=int(cfg.get("triplane_depth", 3)),
        triplane_feature_type=cfg.get("triplane_feature_type", "trigrid"),
        neural_rendering_resolution=int(cfg.get("neural_rendering_resolution", 128)),
        final_resolution=int(cfg.get("final_resolution", 512)),
        backbone_mode=cfg.get("img2plane_backbone_mode", "segformer"),
        backbone_scale=cfg.get("img2plane_backbone_scale", "b0"),
        head_norm_mode=cfg.get("head_norm_mode", "gn"),
        plane_fusion_mode=cfg.get("phase1_plane_fusion_mode", "add"),
        secc_segformer_scale=cfg.get("secc_segformer_scale", "b0"),
        pncc_cond_mode=cfg.get("pncc_cond_mode", "cano_src_tgt"),
        sr_num_fp16_res=int(cfg.get("num_fp16_layers_in_super_resolution", 4)),
        num_samples_coarse=n_coarse,
        num_samples_fine=n_fine,
        sr_channel0=int(cfg.get("sr_channel0", 256)),
        sr_channel1=int(cfg.get("sr_channel1", 128)),
    )
    if not use_torso:
        return OSAvatarSECCImg2Plane(**model_kwargs)
    return OSAvatarSECCImg2PlaneTorso(
        torso_kp_num=int(cfg.get("torso_kp_num", 4)),
        torso_scale=cfg.get("torso_model_scale", "standard"),
        fuse_mode=cfg.get("htbsr_head_weight_fuse_mode", "v2"),
        head_threshold=float(cfg.get("htbsr_head_threshold", 0.9)),
        torso_version=cfg.get("torso_model_version", "v2"),
        torso_inp_mode=cfg.get("torso_inp_mode", "rgb_alpha"),
        **model_kwargs)


class Real3DPortraitPipeline:
    """Synthesis with the torso/background model (``use_torso=True``) or
    the head only, of ``cfg`` (default :data:`DEFAULT_CONFIG`), on
    ``device`` (default ``"cuda"``; raises without a CUDA device).
    ``assets`` overrides the morphable model that ``bfm_dir`` would load
    (BFM09 if present there, else the small synthetic stand-in); a
    benchmark passes ``synthetic_bfm(n_vertices=35709)`` to run the raster
    at the real mesh's scale. Below 256^2 the torso needs
    ``torso_model_scale: tiny`` (the standard motion-field U-Net pools the
    volume's H, W five times)."""

    def __init__(self, cfg: Mapping | None = None, use_torso: bool = True,
                 mock_weights: bool = True, bfm_dir: str | None = None,
                 assets: BFMAssets | None = None, seed: int = 0,
                 device: torch.device | str = "cuda"):
        if not mock_weights:
            raise _not_ported("loading released checkpoints into the port",
                              "queue 1 item 1, weight bridge")
        self.device = entry_device(device)
        if cfg is None:
            cfg = load_config(DEFAULT_CONFIG)
        self.cfg = cfg
        self.use_torso = use_torso
        self.res = int(cfg.get("final_resolution", 512))

        self.assets = assets if assets is not None else load_or_synthetic_bfm(bfm_dir)
        self.secc_renderer = SECCRenderer(
            self.assets, bfm_dir, rasterize_size=int(cfg.get("secc_resolution", 192)),
            output_resolution=self.res, device=self.device)

        self.model = build_model(cfg, use_torso)
        mock_init_(self.model, torch.Generator().manual_seed(seed))
        self.model.to(self.device).eval()

    def fit_source(self, src_lm2d: np.ndarray | None) -> dict:
        """Source 3DMM coefficients; only the neutral mock (``None``) is ported."""
        if src_lm2d is not None:
            raise _not_ported("3DMM fitting from landmarks", "queue 1 item 9")
        z = lambda n: torch.zeros((1, n), device=self.device)  # noqa: E731
        return {"id": z(80), "exp": z(64), "euler": z(3), "trans": z(3)}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _image(self, img: np.ndarray | torch.Tensor) -> torch.Tensor:
        """[H,W,3] uint8 or float in [-1,1] -> [1,res,res,3] float on the
        device (antialiased bilinear resize)."""
        img = torch.as_tensor(np.asarray(img) if not torch.is_tensor(img) else img)
        if img.dtype == torch.uint8:
            img = img.float() / 127.5 - 1.0
        img = img.to(self.device, torch.float32)[None]
        if img.shape[1] != self.res or img.shape[2] != self.res:
            img = F.interpolate(img.permute(0, 3, 1, 2), size=(self.res, self.res),
                                mode="bilinear", align_corners=False,
                                antialias=True).permute(0, 2, 3, 1)
        return img

    def mock_cond(self, img: torch.Tensor, bg_img: torch.Tensor | None = None) -> dict:
        """The torso cond without source preparation: the source image as
        torso and background (unless ``bg_img``), an all-torso segmap and
        zero keypoints."""
        seg = torch.zeros((1, self.res, self.res, 6), device=self.device)
        seg[..., 4] = 1.0
        kp = torch.zeros((1, 68, 3), device=self.device)
        return {"ref_torso_img": img, "bg_img": img if bg_img is None else bg_img,
                "segmap": seg, "kp_src": kp, "kp_drv": kp}

    @torch.no_grad()
    def synthesize(self, src_img: np.ndarray | torch.Tensor, exp_seq: torch.Tensor,
                   src_coeffs: dict, pose_seq: tuple | None = None,
                   bg_img: np.ndarray | torch.Tensor | None = None,
                   blink_mode: str = "none", prepare_source_images: bool = False,
                   frame_batch: int = 1, timings: dict | None = None) -> torch.Tensor:
        """Render all frames; returns [T,H,W,3] in [-1,1] on the device.

        ``src_img`` [H,W,3] float in [-1,1] or uint8; ``exp_seq`` [T,64];
        ``pose_seq`` optional (euler [T,3], trans [T,3]); ``bg_img``
        optional [H,W,3], uint8 or [-1,1], for the torso model. With
        ``timings`` (a dict) the device is synchronised around each stage
        and the dict receives ``cano_ms``, for the torso model
        ``appearance_ms`` and ``bg_ms`` (the per-video caches), and
        ``frame_ms`` (one entry per frame: SECC raster + frame step).
        """
        if blink_mode != "none":
            raise _not_ported("the blink SECC edit", "next order item 1")
        if prepare_source_images:
            raise _not_ported("source preparation (head/torso/bg split)",
                              "next order item 1")
        if frame_batch != 1:
            raise _not_ported("frame batching", "next order item 1")
        dev = self.device
        img = self._image(src_img)

        exp_seq = torch.as_tensor(exp_seq, dtype=torch.float32, device=dev)
        t = exp_seq.shape[0]
        idc = src_coeffs["id"].expand(t, 80)
        if pose_seq is None:
            euler = src_coeffs["euler"].expand(t, 3)
            trans = src_coeffs["trans"].expand(t, 3)
        else:
            euler, trans = (torch.as_tensor(p, dtype=torch.float32, device=dev)
                            for p in pose_seq)
            if euler.shape[0] < t:
                idx = mirror_index(torch.arange(t, device=dev), euler.shape[0])
                euler, trans = euler[idx], trans[idx]
            euler, trans = map_pose_to_source(
                euler[:t], trans[:t], src_coeffs["euler"], src_coeffs["trans"],
                map_to_init=bool(self.cfg.get("map_to_init_pose", True)))

        _, conv_c2w, intr = convert_eg3d_convention(euler, trans)
        cameras = smooth_camera_sequence(pack_camera(conv_c2w, intr[0]))

        zero = torch.zeros((1, 3), device=dev)
        _, cano_secc = self.secc_renderer.render(
            src_coeffs["id"], torch.zeros((1, 64), device=dev), zero, zero)
        _, src_secc = self.secc_renderer.render(
            src_coeffs["id"], src_coeffs["exp"], zero, zero)

        def timed(key, fn, *args):
            self._sync()
            t0 = time.perf_counter()
            out = fn(*args)
            if timings is not None:
                self._sync()
                timings[key] = (time.perf_counter() - t0) * 1e3
            return out

        cano_plane = timed("cano_ms", self.model.cal_cano_plane, img)
        cond = None
        if self.use_torso:
            cond = self.mock_cond(img, None if bg_img is None else self._image(bg_img))
            cond["torso_appearance"] = timed("appearance_ms",
                                             self.model.cal_torso_appearance, cond)
            cond["bg_feat"] = timed("bg_ms", self.model.cal_bg_feat, cond)
        if timings is not None:
            timings["frame_ms"] = []

        frames = []
        for i in range(t):
            t0 = time.perf_counter()
            _, tgt_secc = self.secc_renderer.render(idc[i:i + 1], exp_seq[i:i + 1],
                                                    zero, zero)
            secc_cond = torch.cat([cano_secc, src_secc, tgt_secc], dim=-1)
            if self.use_torso:
                out = self.model.synthesis(None, cameras[i:i + 1], cond, secc=secc_cond,
                                           cano_planes=cano_plane)
            else:
                out = self.model.synthesis(None, cameras[i:i + 1], secc=secc_cond,
                                           cano_planes=cano_plane)
            frames.append(out["image"][0])
            if timings is not None:
                self._sync()
                timings["frame_ms"].append((time.perf_counter() - t0) * 1e3)
        return torch.stack(frames)

"""The flagship frame step: one 512^2 frame of the torso model with every
per-video cache precomputed, the port's counterpart of the JAX package's
``__graft_entry__._flagship``.

    frame_step, args = flagship(device="cuda")
    image = frame_step(*args)            # [1,512,512,3]

The model is ``configs/real3d_orig.yaml`` (the released checkpoints'
geometry: composite backbone, tri-planes of depth 1, folded-BN affines,
standard v2 torso with rgb_alpha input, v2 head/torso fusion) in fp32 with
seeded mock weights, sampled at the shipped ``fast`` preset unless
``samples`` says otherwise. The inputs come from a seeded
``torch.Generator``: a uniform source image (also the torso and background
image) and SECC map, a frontal look-at camera, an all-torso segmap (class
4), and source and driving keypoints uniform in [-0.8, 0.8], so that the
torso warps interpolate for real (the pipeline without source preparation
drives them with zero keypoints). The canonical plane, the torso
appearance volume and the background feature are computed once.

``tiny=True`` is a 64^2 configuration for the CPU: tri-planes of depth 1
(the JAX tiny flagship uses a depth-2 tri-grid, which the port does not
run), the composite ``small`` backbone and the ``tiny`` torso.
"""

from __future__ import annotations

import os

import torch

from real3dportrait_tpu_torch.config import load_config
from real3dportrait_tpu_torch.geometry.camera import fov_to_intrinsics, lookat_pose, pack_camera
from real3dportrait_tpu_torch.inference.pipeline import SHIPPED_SAMPLING_PRESET, build_model
from real3dportrait_tpu_torch.models.img2plane import OSAvatarSECCImg2PlaneTorso
from real3dportrait_tpu_torch.weights import mock_init_

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_MODEL = dict(
    triplane_hid_dim=8, triplane_depth=1, triplane_feature_type="triplane",
    neural_rendering_resolution=16, final_resolution=64, backbone_mode="composite",
    backbone_scale="small", composite_vit_dim=32, head_norm_mode="folded_bn",
    sr_num_fp16_res=0, sr_channel0=16, sr_channel1=8, num_samples_coarse=8,
    num_samples_fine=8, torso_scale="tiny")


@torch.no_grad()
def flagship(tiny: bool = False, samples: tuple[int, int] | None = None,
             device: torch.device | str = "cpu", seed: int = 0):
    """(frame_step, args): ``frame_step(camera, secc, cano_planes, cond)``
    returns the frame's image [1,res,res,3]; ``frame_step.model`` is the
    model. ``samples`` (coarse, fine) overrides the sample counts. The same
    seed gives the same weights and inputs on any device."""
    if tiny:
        model = OSAvatarSECCImg2PlaneTorso(**TINY_MODEL)
    else:
        model = build_model(load_config(os.path.join(_ROOT, "configs", "real3d_orig.yaml"),
                                        {"sampling_preset": SHIPPED_SAMPLING_PRESET}))
    if samples is not None:
        model.render_options = model.render_options._replace(
            depth_resolution=samples[0], depth_resolution_importance=samples[1])
    mock_init_(model, torch.Generator().manual_seed(seed))
    dev = torch.device(device)
    model.to(dev).eval()

    res = model.final_resolution
    gen = torch.Generator().manual_seed(seed + 1)

    def uniform(shape, lo=-1.0, hi=1.0):
        return (lo + (hi - lo) * torch.rand(shape, generator=gen)).to(dev)

    img = uniform((1, res, res, 3))
    secc = uniform((1, res, res, 9))
    zero = torch.zeros((1,))
    cam = pack_camera(lookat_pose(zero, zero, torch.zeros((1, 3))), fov_to_intrinsics()).to(dev)
    seg = torch.zeros((1, res, res, 6), device=dev)
    seg[..., 4] = 1.0
    cond = {"ref_torso_img": img, "bg_img": img, "segmap": seg,
            "kp_src": uniform((1, 68, 3), -0.8, 0.8), "kp_drv": uniform((1, 68, 3), -0.8, 0.8)}
    cano = model.cal_cano_plane(img)
    cond["torso_appearance"] = model.cal_torso_appearance(cond)
    cond["bg_feat"] = model.cal_bg_feat(cond)

    @torch.no_grad()
    def frame_step(camera, secc, cano_planes, cond):
        return model.synthesis(None, camera, cond, secc=secc, cano_planes=cano_planes)["image"]

    frame_step.model = model
    return frame_step, (cam, secc, cano, cond)

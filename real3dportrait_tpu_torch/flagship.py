"""The flagship frame step: one 512^2 frame of the torso model with every
per-video cache precomputed, the port's counterpart of the JAX package's
``__graft_entry__._flagship``.

    frame_step, args = flagship()        # on "cuda"
    image = frame_step(*args)            # [1,512,512,3]

The model is ``configs/real3d_orig.yaml`` (the released checkpoints'
geometry: composite backbone, tri-planes of depth 1, folded-BN affines,
standard v2 torso with rgb_alpha input, v2 head/torso fusion) in fp32 with
seeded mock weights, sampled at the shipped ``fast`` preset unless
``samples`` says otherwise. The inputs come from a
seeded ``torch.Generator``: a uniform source image (also the torso and
background image) and SECC map, a frontal look-at camera, an all-torso
segmap (class 4), and source and driving keypoints uniform in [-0.8, 0.8],
so that the torso warps interpolate for real (the pipeline without source
preparation drives them with zero keypoints). The canonical plane, the
torso appearance volume and the background feature are computed once.

``frame_batch`` b > 1 renders b frames a step, as the JAX flagship does
under ``BENCH_FRAME_BATCH``: the source image is one image broadcast over
the batch, the SECC maps, cameras and keypoints are drawn at b, and the
canonical plane and the per-video caches are computed for one frame and
broadcast along the batch as views.

``tiny=True`` is the JAX tiny flagship's model, :data:`TINY_MODEL`, for the
CPU: 64^2 output, 16^2 render, tri-grids of depth 2 x 8 channels (kernel
K1-trigrid on a card), the SegFormer-b0 canonical backbone with GroupNorm
heads, fp32 SR blocks of 16/8 channels, 8+8 samples and the ``tiny``
torso. It runs on ``device="cuda"`` unless it is given another device.
"""

from __future__ import annotations

import os

import torch

from real3dportrait_tpu_torch import entry_device
from real3dportrait_tpu_torch.config import load_config
from real3dportrait_tpu_torch.geometry.camera import fov_to_intrinsics, lookat_pose, pack_camera
from real3dportrait_tpu_torch.inference.pipeline import SHIPPED_SAMPLING_PRESET, build_model
from real3dportrait_tpu_torch.models.img2plane import OSAvatarSECCImg2PlaneTorso
from real3dportrait_tpu_torch.weights import mock_init_

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# __graft_entry__._flagship(tiny=True), with the class defaults it leaves
# unset written out
TINY_MODEL = dict(
    triplane_hid_dim=8, triplane_depth=2, triplane_feature_type="trigrid",
    neural_rendering_resolution=16, final_resolution=64, backbone_mode="segformer",
    backbone_scale="b0", head_norm_mode="gn", sr_num_fp16_res=0, sr_channel0=16,
    sr_channel1=8, num_samples_coarse=8, num_samples_fine=8, torso_scale="tiny")


@torch.no_grad()
def flagship(tiny: bool = False, samples: tuple[int, int] | None = None,
             device: torch.device | str = "cuda", seed: int = 0, frame_batch: int = 1):
    """(frame_step, args): ``frame_step(camera, secc, cano_planes, cond)``
    returns the step's images [b,res,res,3] (b = ``frame_batch``);
    ``frame_step.model`` is the model and ``frame_step.frames_per_call`` is
    b. ``samples`` (coarse, fine) overrides the sample counts. The same
    seed gives the same weights and inputs on any device."""
    dev = entry_device(device)
    if tiny:
        model = OSAvatarSECCImg2PlaneTorso(**TINY_MODEL)
    else:
        model = build_model(load_config(os.path.join(_ROOT, "configs", "real3d_orig.yaml"),
                                        {"sampling_preset": SHIPPED_SAMPLING_PRESET}))
    if samples is not None:
        model.render_options = model.render_options._replace(
            depth_resolution=samples[0], depth_resolution_importance=samples[1])
    mock_init_(model, torch.Generator().manual_seed(seed))
    model.to(dev).eval()

    res, b = model.final_resolution, max(int(frame_batch), 1)
    gen = torch.Generator().manual_seed(seed + 1)

    def uniform(shape, lo=-1.0, hi=1.0):
        return (lo + (hi - lo) * torch.rand(shape, generator=gen)).to(dev)

    def tiled(x):
        return x.expand(b, *x.shape[1:])

    img = uniform((1, res, res, 3))
    secc = uniform((b, res, res, 9))
    zero = torch.zeros((b,))
    cam = pack_camera(lookat_pose(zero, zero, torch.zeros((b, 3))), fov_to_intrinsics()).to(dev)
    seg = torch.zeros((1, res, res, 6), device=dev)
    seg[..., 4] = 1.0
    cond = {"ref_torso_img": img, "bg_img": img, "segmap": seg}
    cano = tiled(model.cal_cano_plane(img))
    appearance = tiled(model.cal_torso_appearance(cond))
    bg_feat = tuple(tiled(x) for x in model.cal_bg_feat(cond))
    cond = {k: tiled(v) for k, v in cond.items()}
    cond.update(kp_src=uniform((b, 68, 3), -0.8, 0.8), kp_drv=uniform((b, 68, 3), -0.8, 0.8),
                torso_appearance=appearance, bg_feat=bg_feat)

    @torch.no_grad()
    def frame_step(camera, secc, cano_planes, cond):
        return model.synthesis(None, camera, cond, secc=secc, cano_planes=cano_planes)["image"]

    frame_step.model = model
    frame_step.frames_per_call = b
    return frame_step, (cam, secc, cano, cond)

"""Where a torso frame's time goes on a CUDA device.

    python -m real3dportrait_tpu_torch.inference.profile_frame [--config NAME]

For the ``fast`` and ``reference`` presets of ``configs/NAME`` (default
``secc_img2plane_torso.yaml``, the pipeline's default model with tri-grids
and bf16 SR blocks; ``real3d_orig.yaml`` is the released geometry), with
the torso model, seeded mock weights, the 35,709-vertex synthetic mesh and
source and driving keypoints uniform in [-0.8, 0.8], it prints:

* the CUDA-event median of each stage run alone: the per-video caches
  (canonical plane, torso appearance volume, background feature), SECC
  raster, SECC backbone + fusion, render, the SR-with-ref head, the frame
  step, raster + step;
* the frame step's breakdown by module, timed in place by CUDA events
  around each module's forward (block0, the torso model and inside it the
  motion-field estimator and generator, the fusion convs and the
  head/torso and final SR blocks), each with its share of the step;
* the MFE's 7^3 fuser (kernel K7a) and its tail (kernel K7b: the 7^3
  mask conv, softmax, deformation and both 7^2 occlusion heads) timed
  alone at the frame's shapes, beside cuDNN's convolutions of the same
  shapes with its default algorithm choice and with ``cudnn.benchmark``,
  and K7a at each 3^3 conv of the U-Net beside cuDNN's;
* the wall time per frame of ``synthesize`` over 16 frames without
  per-frame synchronisation, driven as chip_smoke's slices drive it
  (without source preparation or blinks);
* a ``torch.profiler`` table of device kernel time per frame and the
  device's busy share.

fp32 with TF32 off, like chip_smoke. An event pair also counts the device
idling while the host enqueues, so in-place module times include launch
gaps and do not add up to the step exactly.
"""

from __future__ import annotations

import argparse
import os
import time
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

from real3dportrait_tpu_torch.config import load_config
from real3dportrait_tpu_torch.geometry import camera
from real3dportrait_tpu_torch.geometry.bfm import synthetic_bfm
from real3dportrait_tpu_torch.inference.pipeline import Real3DPortraitPipeline
from real3dportrait_tpu_torch.kernels import card_line, cuda_ms
from real3dportrait_tpu_torch.models.torso import mfe_tail
from real3dportrait_tpu_torch.rendering.ray_sampler import sample_rays
from real3dportrait_tpu_torch.rendering.renderer import render_rays

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class ModuleTimer:
    """CUDA events around each call of the named modules (a name may stand
    for several modules, whose times add up)."""

    def __init__(self, modules: dict):
        self.pairs = {name: [] for name in modules}
        self.handles = []
        for name, mods in modules.items():
            for mod in mods:
                self.handles.append(mod.register_forward_pre_hook(partial(self._start, name)))
                self.handles.append(mod.register_forward_hook(partial(self._end, name)))

    def _start(self, name, *_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.pairs[name].append([ev])

    def _end(self, name, *_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.pairs[name][-1].append(ev)

    def per_call_ms(self, calls: int) -> dict:
        torch.cuda.synchronize()
        for h in self.handles:
            h.remove()
        return {name: sum(s.elapsed_time(e) for s, e in pairs) / calls
                for name, pairs in self.pairs.items()}


def profile_preset(config: str, preset: str, dev: torch.device, n_frames: int = 16) -> None:
    cfg = load_config(os.path.join(_ROOT, "configs", config), {"sampling_preset": preset})
    pipe = Real3DPortraitPipeline(cfg, assets=synthetic_bfm(n_vertices=35709), seed=0,
                                  device=dev)
    m, res = pipe.model, pipe.res
    sr = m.superresolution
    rng = np.random.RandomState(0)
    src = rng.randint(0, 256, (res, res, 3)).astype(np.uint8)
    exp = torch.from_numpy(rng.randn(n_frames, 64).astype(np.float32) * 0.3)
    coeffs = pipe.fit_source(None)
    zero = torch.zeros((1, 3), device=dev)
    e = exp[:1].to(dev)
    img = torch.from_numpy(src[None].astype(np.float32) / 127.5 - 1.0).to(dev)
    _, c2w, intr = camera.convert_eg3d_convention(zero, zero)
    cam = camera.pack_camera(c2w, intr[0])
    r = m.neural_rendering_resolution

    def raster():
        return pipe.secc_renderer.render(coeffs["id"], e, zero, zero)[1]

    def step():
        return m.synthesis(None, cam, cond, secc=secc, cano_planes=cano)

    with torch.no_grad():
        cano = m.cal_cano_plane(img)
        cond = pipe.mock_cond(img)
        kps = torch.from_numpy(rng.uniform(-0.8, 0.8, (2, 1, 68, 3)).astype(np.float32))
        cond.update(kp_src=kps[0].to(dev), kp_drv=kps[1].to(dev))
        cond.update(torso_appearance=m.cal_torso_appearance(cond), bg_feat=m.cal_bg_feat(cond))
        secc = torch.cat([raster()] * 3, dim=-1)
        planes = m.cal_plane_given_cano(cano, secc)
        origins, dirs = sample_rays(*camera.unpack_camera(cam), r)
        out = render_rays(planes, m.decoder, origins, dirs, m.render_options)
        feat = out["rgb"].reshape(1, r, r, -1)
        weights = out["weights_sum"].reshape(1, r, r, 1)
        ws = torch.ones((1, 14, m.w_dim), device=dev)
        stages = {
            "canonical plane (once per video)": lambda: m.cal_cano_plane(img),
            "torso appearance volume (once per video)": lambda: m.cal_torso_appearance(cond),
            "background feature (once per video)": lambda: m.cal_bg_feat(cond),
            "SECC raster (K4 + upsample)": raster,
            "SECC backbone + fusion": lambda: m.cal_plane_given_cano(cano, secc),
            "render_rays (K1 or K1-trigrid, K2, K3)": lambda: render_rays(
                planes, m.decoder, origins, dirs, m.render_options),
            "SR-with-ref head (torso, fusion, SR blocks)": lambda: m._forward_sr(
                feat[..., :3], feat, ws, weights, cond, "none"),
            "frame step": step,
            "frame (raster + step)": lambda: (raster(), step()),
        }
        for name, fn in stages.items():
            print(f"[{preset}] {name}: {cuda_ms(fn):.3f} ms")

        # the frame step's breakdown, timed in place (a SynthesisBlock by its
        # three layers, which leaves out the skip image's upsample)
        tm = sr.torso_model
        mfe = tm.motion_field_estimator

        def layers(block):
            return [block.conv0, block.conv1, block.torgb]

        modules = {"SECC backbone": [m.secc_img2plane_backbone], "SR-with-ref head": [sr],
                   "block0 layers (128->256)": layers(sr.block0), "torso model": [tm],
                   "  motion-field estimator (MFE)": [mfe],
                   "    MFE 7^3 tgt_head_fuser (89->32, K7a)": [mfe.tgt_head_fuser],
                   "    MFE U-Net 3^3 convs (K7a)": [getattr(mfe, n).conv for n in (
                       *(f"down_{i}" for i in range(mfe.n_down)),
                       *(f"up_{i}" for i in range(mfe.n_up)))],
                   "  warp generator (K5b + convs)": [tm.deform_based_generator],
                   "fusion convs": [getattr(sr, n) for n in (
                       "torso_encoder", "fuse_ht_conv0", "fuse_ht_conv1", "fuse_fb_conv0",
                       "fuse_fb_conv1", "fuse_fb_conv2")],
                   "head_torso_block layers (256, up 1)": layers(sr.head_torso_block),
                   "block1 layers (256->512)": layers(sr.block1)}
        reps = 8
        step()
        timer = ModuleTimer(modules)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            step()
        end.record()
        ms = timer.per_call_ms(reps)
        frame = start.elapsed_time(end) / reps
        print(f"[{preset}] in-step frame step (events around it): {frame:.3f} ms")
        for name, t in ms.items():
            print(f"[{preset}] in-step {name}: {t:.3f} ms ({100 * t / frame:.1f}% of the step)")

        # K7 alone at the frame's shapes: the kernels, and cuDNN's convs of
        # the same shapes (the port's path before K7a/K7b)
        d, h = cond["torso_appearance"].shape[1:3]
        x89 = torch.randn((1, mfe.tgt_head_fuser.in_channels, d, h, h), device=dev)
        x32 = torch.randn((1, mfe.mask_conv.in_channels, d, h, h), device=dev)
        occ_w = torch.cat([mfe.occlusion_conv.weight, mfe.occlusion_conv2.weight])
        occ_b = torch.cat([mfe.occlusion_conv.bias, mfe.occlusion_conv2.bias])
        kps = [cond["kp_src"][:, :4].contiguous(), cond["kp_drv"][:, :4].contiguous()]
        fuser, mask = mfe.tgt_head_fuser, mfe.mask_conv
        kernels = {"K7a tgt_head_fuser 7^3": lambda: fuser(x89),
                   "K7b tail (mask 7^3 + softmax + deformation + occlusion 7^2)":
                   lambda: mfe_tail(x32, mask.weight, mask.bias, occ_w, occ_b, *kps)}
        cudnn = {"tgt_head_fuser 7^3": lambda: F.conv3d(x89, fuser.weight, fuser.bias,
                                                        padding=3),
                 "mask_conv 7^3": lambda: F.conv3d(x32, mask.weight, mask.bias, padding=3),
                 "occlusion heads 7^2 (512->2)": lambda: F.conv2d(
                     x32.reshape(1, -1, h, h), occ_w, occ_b, padding=3)}
        k7_ms = {name: cuda_ms(fn) for name, fn in kernels.items()}
        for name, t in k7_ms.items():
            print(f"[{preset}] K7 alone {name}: {t:.3f} ms")
        cudnn_ms = {name: cuda_ms(fn) for name, fn in cudnn.items()}
        # the same convs with cuDNN's algorithm search
        torch.backends.cudnn.benchmark = True
        tuned = {name: cuda_ms(fn) for name, fn in cudnn.items()}
        torch.backends.cudnn.benchmark = False
        for name, t in cudnn_ms.items():
            print(f"[{preset}] cuDNN alone {name}: {t:.3f} ms (cudnn.benchmark: "
                  f"{tuned[name]:.3f} ms)")
        total = sum(k7_ms.values())
        print(f"[{preset}] K7a fuser + K7b alone: {total:.3f} ms ({100 * total / frame:.1f}% "
              f"of the in-place frame step); cuDNN's three convs: "
              f"{sum(cudnn_ms.values()):.3f} ms (cudnn.benchmark: {sum(tuned.values()):.3f})")
        # K7a at each 3^3 conv of the U-Net, beside cuDNN's conv3d of the shape
        size, ours, theirs = h, 0.0, 0.0
        for name in [f"down_{i}" for i in range(mfe.n_down)] + \
                [f"up_{i}" for i in range(mfe.n_up)]:
            conv = getattr(mfe, name).conv
            size = size * 2 if name.startswith("up") else size
            x = torch.randn((1, conv.in_channels, d, size, size), device=dev)
            k_ms = cuda_ms(lambda: conv(x))
            c_ms = cuda_ms(lambda: F.conv3d(x, conv.weight, conv.bias, padding=1))
            ours, theirs = ours + k_ms, theirs + c_ms
            print(f"[{preset}] K7a alone U-Net {name} [1,{conv.in_channels},{d},{size},{size}]"
                  f"->{conv.out_channels}: {k_ms:.4f} ms (cuDNN {c_ms:.4f} ms)")
            size = size // 2 if name.startswith("down") else size
        print(f"[{preset}] K7a alone U-Net, ten 3^3 convs: {ours:.3f} ms (cuDNN {theirs:.3f} ms)")

        mock = dict(blink_mode="none", prepare_source_images=False)
        pipe.synthesize(src, exp[:2], coeffs, **mock)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.synthesize(src, exp, coeffs, **mock)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_frames
        print(f"[{preset}] synthesize {n_frames} frames, no per-frame sync: {wall:.3f} "
              f"ms/frame of wall (with the per-video caches and SECC maps once)")

        # one traced but discarded frame first, so that the profiler's
        # start-up is not in a measured frame; the trace is collected when
        # the context exits, after the wall clock has stopped
        reps = 4
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=reps, repeat=1)) as prof:
            raster()
            step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                prof.step()
                raster()
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / reps
    # ProfilerStep ranges also appear on the device timeline: not kernels
    rows = [x for x in prof.key_averages() if x.device_type == DeviceType.CUDA
            and not x.key.startswith("ProfilerStep")]
    busy = sum(x.self_device_time_total for x in rows) / reps / 1e3
    print(f"[{preset}] profiler: kernel time {busy:.3f} ms/frame, wall {wall:.3f} "
          f"ms/frame, busy share {busy / wall:.3f}")
    for x in sorted(rows, key=lambda x: -x.self_device_time_total)[:20]:
        print(f"[{preset}]   {x.self_device_time_total / reps / 1e3:8.3f} ms/frame "
              f"x{x.count // reps:4d}  {x.key[:100]}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="secc_img2plane_torso.yaml",
                        help="a file of configs/ (default: the pipeline's default model)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame: no CUDA device is visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card_line()}")
    print(f"config: {args.config}")
    for preset in ("fast", "reference"):
        profile_preset(args.config, preset, torch.device("cuda"))
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

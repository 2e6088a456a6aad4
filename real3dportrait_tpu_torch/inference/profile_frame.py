"""Where a head-only frame's time goes on a CUDA device.

    python -m real3dportrait_tpu_torch.inference.profile_frame

For the ``fast`` and ``reference`` presets of ``configs/real3d_orig.yaml``
(seeded mock weights, the 35,709-vertex synthetic mesh) it prints the
CUDA-event median of each stage run alone (canonical plane, SECC raster,
SECC backbone + fusion, render, SR, the frame step, raster + step), the
wall time per frame of ``synthesize`` over 16 frames without per-frame
synchronisation, and a ``torch.profiler`` table of device kernel time per
frame with the device's busy share. fp32 with TF32 off, like chip_smoke.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

from real3dportrait_tpu_torch.config import load_config
from real3dportrait_tpu_torch.geometry import camera
from real3dportrait_tpu_torch.geometry.bfm import synthetic_bfm
from real3dportrait_tpu_torch.inference.pipeline import Real3DPortraitPipeline
from real3dportrait_tpu_torch.kernels import card_line, cuda_ms
from real3dportrait_tpu_torch.rendering.ray_sampler import sample_rays
from real3dportrait_tpu_torch.rendering.renderer import render_rays

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def profile_preset(preset: str, dev: torch.device, n_frames: int = 16) -> None:
    cfg = load_config(os.path.join(_ROOT, "configs", "real3d_orig.yaml"),
                      {"sampling_preset": preset})
    pipe = Real3DPortraitPipeline(cfg, assets=synthetic_bfm(n_vertices=35709), seed=0,
                                  device=dev)
    m, res = pipe.model, pipe.res
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
        return m.synthesis(None, cam, secc=secc, cano_planes=cano)

    with torch.no_grad():
        cano = m.cal_cano_plane(img)
        secc = torch.cat([raster()] * 3, dim=-1)
        planes = m.cal_plane_given_cano(cano, secc)
        origins, dirs = sample_rays(*camera.unpack_camera(cam), r)
        feat = render_rays(planes, m.decoder, origins, dirs, m.render_options)["rgb"]
        feat = feat.reshape(1, r, r, -1)
        ws = torch.ones((1, 14, m.w_dim), device=dev)
        stages = {
            "canonical plane (once per video)": lambda: m.cal_cano_plane(img),
            "SECC raster (K4 + upsample)": raster,
            "SECC backbone + fusion": lambda: m.cal_plane_given_cano(cano, secc),
            "render_rays (K1-K3)": lambda: render_rays(planes, m.decoder, origins, dirs,
                                                       m.render_options),
            "superresolution": lambda: m.superresolution(feat[..., :3], feat, ws),
            "frame step": step,
            "frame (raster + step)": lambda: (raster(), step()),
        }
        for name, fn in stages.items():
            print(f"[{preset}] {name}: {cuda_ms(fn):.3f} ms")

        pipe.synthesize(src, exp[:2], coeffs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.synthesize(src, exp, coeffs)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_frames
        print(f"[{preset}] synthesize {n_frames} frames, no per-frame sync: {wall:.3f} "
              f"ms/frame of wall (with the canonical plane and SECC maps once)")

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
    for x in sorted(rows, key=lambda x: -x.self_device_time_total)[:16]:
        print(f"[{preset}]   {x.self_device_time_total / reps / 1e3:8.3f} ms/frame "
              f"x{x.count // reps:4d}  {x.key[:100]}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame: no CUDA device is visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card_line()}")
    for preset in ("fast", "reference"):
        profile_preset(preset, torch.device("cuda"))
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

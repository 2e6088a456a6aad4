#!/usr/bin/env python3
"""Drive the PyTorch port's torso flagship slice once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

1. toolchain: ``nvidia-smi`` name and power limit, torch and CUDA versions,
   ``nvcc --version``; exits non-zero when no CUDA device is visible;
2. build every kernel of ``real3dportrait_tpu_torch/csrc`` with nvcc for
   sm_90a (one nvcc per source, in parallel), or reuse the library built
   from identical sources (registers and spills from ptxas are printed
   either way);
3. each kernel (K1-K6b) against its plain PyTorch version at the slice's
   shapes, fp32 with TF32 off, with the tolerance stated beside it, and the
   median CUDA-event time of both;
4. the slice: ``Real3DPortraitPipeline`` with ``configs/real3d_orig.yaml``
   (the torso model, seeded mock weights) synthesises 8 frames of 512^2
   from a seeded source image and 8 expression frames at the ``fast``
   preset with a background image, with every kernel's launch counter
   checked; then again at ``reference``; then the head-only model at
   ``fast``;
5. the flagship frame step (``real3dportrait_tpu_torch.flagship``) with
   random keypoints, so that the torso warps interpolate;
6. small configurations run on both the GPU and the CPU (plain versions),
   whose frames and torso frame-step outputs must agree.

The last lines are the kernels JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

# one card: the smoke drives device 0 and reports the cards it can see
os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from real3dportrait_tpu_torch.kernels import card_line, cuda_ms  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
REPLACES = {
    "triplane_decode": "real3dportrait_tpu/rendering/renderer.py:113",
    "importance_sample": "real3dportrait_tpu/rendering/renderer.py:300",
    "merge_composite": "real3dportrait_tpu/rendering/renderer.py:367",
    "secc_raster": "real3dportrait_tpu/geometry/rasterizer.py:248",
    "torso_deform_input": "real3dportrait_tpu/models/torso.py:378",
    "torso_warp_volume": "real3dportrait_tpu/models/torso.py:500",
    "upfirdn2d": "real3dportrait_tpu/ops/upfirdn2d.py:59",
    "bias_act": "real3dportrait_tpu/ops/bias_act.py:37",
}
SOURCES = {
    "triplane_decode": "real3dportrait_tpu_torch/csrc/triplane_decode.cu",
    "importance_sample": "real3dportrait_tpu_torch/csrc/render_march.cu",
    "merge_composite": "real3dportrait_tpu_torch/csrc/render_march.cu",
    "secc_raster": "real3dportrait_tpu_torch/csrc/secc_raster.cu",
    "torso_deform_input": "real3dportrait_tpu_torch/csrc/torso_warp.cu",
    "torso_warp_volume": "real3dportrait_tpu_torch/csrc/torso_warp.cu",
    "upfirdn2d": "real3dportrait_tpu_torch/csrc/stylegan_epilogue.cu",
    "bias_act": "real3dportrait_tpu_torch/csrc/stylegan_epilogue.cu",
}


def wrappers() -> dict:
    """The eight kernel wrappers, by kernel name; each counts its launches."""
    from real3dportrait_tpu_torch.geometry.rasterizer import secc_raster
    from real3dportrait_tpu_torch.models.decoder import triplane_decode
    from real3dportrait_tpu_torch.models.torso import torso_deform_input, torso_warp_volume
    from real3dportrait_tpu_torch.ops.bias_act import bias_act
    from real3dportrait_tpu_torch.ops.upfirdn2d import upfirdn2d
    from real3dportrait_tpu_torch.rendering.renderer import importance_sample, merge_composite

    return {"triplane_decode": triplane_decode, "importance_sample": importance_sample,
            "merge_composite": merge_composite, "secc_raster": secc_raster,
            "torso_deform_input": torso_deform_input, "torso_warp_volume": torso_warp_volume,
            "upfirdn2d": upfirdn2d, "bias_act": bias_act}


def reset_launches() -> None:
    for w in wrappers().values():
        w.launches = 0


def read_launches() -> dict:
    return {k: w.launches for k, w in wrappers().items()}


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def mean_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().mean())


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def phase_toolchain() -> None:
    print(f"card: {card_line()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    from real3dportrait_tpu_torch import kernels

    nvcc = subprocess.run([kernels.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()
    print(f"nvcc: {nvcc[0]} | {nvcc[-1]}")


def phase_build() -> None:
    from real3dportrait_tpu_torch import kernels

    t0 = time.perf_counter()
    path, log = kernels.build()
    kernels.library()
    print(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "Function properties" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def phase_kernels(dev: torch.device) -> dict:
    """Each kernel vs its plain version at the slice's shapes."""
    from real3dportrait_tpu_torch.geometry import bfm
    from real3dportrait_tpu_torch.geometry.rasterizer import (
        project_to_screen, secc_raster, secc_raster_plain)
    from real3dportrait_tpu_torch.models.decoder import (
        OSGDecoder, triplane_decode, triplane_decode_plain)
    from real3dportrait_tpu_torch.rendering.renderer import (
        importance_sample, importance_sample_plain, importance_u, merge_composite,
        merge_composite_plain)
    from real3dportrait_tpu_torch.weights import mock_init_

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def record(name, tag, outs, tol, ms, plain_ms, extra=""):
        """``outs``: (kernel output, plain output) pairs."""
        err = max(max_err(k, p) for k, p in outs)
        merr = max(mean_err(k, p) for k, p in outs)
        print(f"{name}[{tag}]: max_abs_err {err:.3e} mean {merr:.3e} (tol {tol:g}) "
              f"{extra}kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        check(err <= tol, f"{name}[{tag}] disagrees with its plain version: {err} > {tol}")
        # the JSON line keeps each kernel's first (fast-preset) shape
        rows.setdefault(name, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms))

    # K1: planes of one frame [1,3,256,256,32]; coarse (16 x 128^2) and
    # fine-pass (48 x 128^2) point counts. fp32 sums in another order:
    # tolerance 1e-4 absolute on rgb in [-0.001, 1.001] and sigma O(1).
    planes = torch.randn((1, 3, 256, 256, 32), device=dev, generator=gen)
    dec = mock_init_(OSGDecoder(32, 64, 32), torch.Generator().manual_seed(1)).to(dev)
    for n in (262144, 786432):
        coords = torch.rand((1, n, 3), device=dev, generator=gen) - 0.5
        with torch.no_grad():
            k_rgb, k_sig = triplane_decode(planes, coords, 1.0, dec)
            p_rgb, p_sig = triplane_decode_plain(planes, coords, 1.0, dec)
            ms = cuda_ms(lambda: triplane_decode(planes, coords, 1.0, dec))
            pms = cuda_ms(lambda: triplane_decode_plain(planes, coords, 1.0, dec))
        record("triplane_decode", f"{n} pts", [(k_rgb, p_rgb), (k_sig, p_sig)], 1e-4,
               ms, pms)

    # K2/K3: 16,384 rays (128^2) at 16+32 and 48+48. Depths O(2-3); sums in
    # another order (cdf, transmittance): tolerance 1e-4 absolute on depths,
    # composited rgb in [-1,1] and weights.
    r = 16384
    for s_c, s_f in ((16, 32), (48, 48)):
        start = 2.0 + 0.2 * torch.rand((1, r, 1, 1), device=dev, generator=gen)
        steps = (torch.arange(s_c, device=dev) + 0.5)[None, None, :, None] / s_c
        depths = start + 0.8 * steps
        sigma = 3 * torch.randn((1, r, s_c, 1), device=dev, generator=gen)
        u = importance_u(r, s_f, dev)
        fine_k = importance_sample(depths, sigma, u)
        fine_p = importance_sample_plain(depths, sigma, u)
        record("importance_sample", f"{s_c}+{s_f}", [(fine_k, fine_p)], 1e-4,
               cuda_ms(lambda: importance_sample(depths, sigma, u)),
               cuda_ms(lambda: importance_sample_plain(depths, sigma, u)))
        c1 = torch.rand((1, r, s_c, 32), device=dev, generator=gen)
        c2 = torch.rand((1, r, s_f, 32), device=dev, generator=gen)
        s2 = 3 * torch.randn((1, r, s_f, 1), device=dev, generator=gen)
        args = (depths, c1, sigma, fine_p, c2, s2)
        outs = list(zip(merge_composite(*args), merge_composite_plain(*args)))
        record("merge_composite", f"{s_c}+{s_f}", outs, 1e-4,
               cuda_ms(lambda: merge_composite(*args)),
               cuda_ms(lambda: merge_composite_plain(*args)))

    # K4: 16 frames of the 35,709-vertex synthetic mesh at 192^2, zero pose.
    # The kernel rounds every operation as the plain version does and breaks
    # depth ties by face id: expected bit-equal; tolerance 0 differing mask
    # pixels and 1e-6 on the NCC.
    assets = bfm.synthetic_bfm(n_vertices=35709).to(dev)
    rng = np.random.RandomState(0)
    idc = torch.from_numpy(np.tile(rng.randn(1, 80).astype(np.float32) * 0.1, (16, 1))).to(dev)
    exp = torch.from_numpy(rng.randn(16, 64).astype(np.float32) * 0.1).to(dev)
    zero = torch.zeros((16, 3), device=dev)
    verts = bfm.compute_face_vertex(assets, idc, exp, zero, zero)
    uv, z = project_to_screen(verts, 1015.0, 112.0, 192)
    uv, z = uv.contiguous(), z.contiguous()
    attr = ((assets.ncc_code + 1) / 2).contiguous()
    faces = assets.face_buf
    km, ki = secc_raster(uv, z, faces, attr, 192)
    pm, pi = secc_raster_plain(uv, z, faces, attr, 192)
    n_mask = int((km != pm).sum())
    check(n_mask == 0, f"secc_raster: {n_mask} mask pixels differ")
    check(0.2 < float(km.mean()) < 0.9, f"secc_raster coverage {float(km.mean())}")
    record("secc_raster", "16x192^2", [(ki, pi)], 1e-6,
           cuda_ms(lambda: secc_raster(uv, z, faces, attr, 192)),
           cuda_ms(lambda: secc_raster_plain(uv, z, faces, attr, 192), reps=5),
           f"coverage {float(km.mean()):.3f} ")

    # K5a: the compressed volume of one 512^2 frame [1,16,64,64,4] and 4 of
    # the 68 keypoints, uniform in [-0.8,0.8]; then offsets up to 3.2 that
    # push samples outside the volume (zero padding). The plain version's
    # grid coordinates are i * (1 / (n-1)) (torch's CUDA division by a
    # scalar), the kernel's i / (n-1): one rounding of a coordinate moves a
    # sample by up to ~4e-6 voxel at n = 64, and neighbouring voxels of the
    # N(0,1) volume differ by up to ~6, so the two differ by up to ~3e-5
    # (each is ~2-4e-5 off a float64 evaluation): tolerance 1e-4 absolute.
    # K5b: the appearance volume [1,16,64,64,32], deformation uniform in
    # [-1.2,1.2] (border clamp); the same coordinates reach both versions:
    # 1e-5 absolute.
    from real3dportrait_tpu_torch.models import torso

    fs = torch.randn((1, 16, 64, 64, 4), device=dev, generator=gen)
    for tag, reach in (("kp 0.8", 0.8), ("kp 1.6, outside", 1.6)):
        kp_s = reach * (2 * torch.rand((1, 4, 3), device=dev, generator=gen) - 1)
        kp_d = reach * (2 * torch.rand((1, 4, 3), device=dev, generator=gen) - 1)
        record("torso_deform_input", f"[1,16,64,64,4] {tag}",
               [(torso.torso_deform_input(fs, kp_s, kp_d),
                 torso.torso_deform_input_plain(fs, kp_s, kp_d))], 1e-4,
               cuda_ms(lambda: torso.torso_deform_input(fs, kp_s, kp_d)),
               cuda_ms(lambda: torso.torso_deform_input_plain(fs, kp_s, kp_d)))
    vol = torch.randn((1, 16, 64, 64, 32), device=dev, generator=gen)
    grid = 2.4 * torch.rand((1, 16, 64, 64, 3), device=dev, generator=gen) - 1.2
    record("torso_warp_volume", "[1,16,64,64,32]",
           [(torso.torso_warp_volume(vol, grid), torso.torso_warp_volume_plain(vol, grid))],
           1e-5, cuda_ms(lambda: torso.torso_warp_volume(vol, grid)),
           cuda_ms(lambda: torso.torso_warp_volume_plain(vol, grid)))

    # K6a: the FIR after block1's and block0's up-convolutions (4x4 taps,
    # gain 4), the skip image's 2x upsample at both blocks, and a crop
    # (negative padding) with a downsample. 16 taps summed in another
    # order: 1e-5 absolute on N(0,1) inputs.
    from real3dportrait_tpu_torch.ops import bias_act as ba
    from real3dportrait_tpu_torch.ops import upfirdn2d as ufd

    f = ufd.setup_filter([1, 3, 3, 1], device=dev)
    cases = (("block1 FIR [1,128,515^2]", (1, 128, 515, 515), dict(gain=4)),
             ("block0 FIR [1,256,259^2]", (1, 256, 259, 259), dict(gain=4)),
             ("skip up2 [1,3,128^2]", (1, 3, 128, 128), dict(up=2, padding=(2, 1, 2, 1), gain=4)),
             ("skip up2 [1,3,256^2]", (1, 3, 256, 256), dict(up=2, padding=(2, 1, 2, 1), gain=4)),
             ("crop up2 down2 [1,8,99^2]", (1, 8, 99, 99), dict(up=2, down=2,
                                                              padding=(-3, 1, 2, -2))))
    for tag, shape, kw in cases:
        x = torch.randn(shape, device=dev, generator=gen)
        record("upfirdn2d", tag, [(ufd.upfirdn2d(x, f, **kw), ufd.upfirdn2d_plain(x, f, **kw))],
               1e-5, cuda_ms(lambda: ufd.upfirdn2d(x, f, **kw)),
               cuda_ms(lambda: ufd.upfirdn2d_plain(x, f, **kw)))
        del x

    # K6b: block1's conv epilogue [1,128,512,512] (demodulation, noise, bias,
    # lrelu, gain sqrt 2, clamp) and toRGB's [1,3,512,512] (bias only).
    # Rounded in the plain version's order: 1e-6 absolute.
    x = 4 * torch.randn((1, 128, 512, 512), device=dev, generator=gen)
    kw = dict(act="lrelu", gain=2 ** 0.5, clamp=4.0, axis=1,
              scale=torch.rand((1, 128), device=dev, generator=gen) + 0.5,
              noise=0.3 * torch.randn((512, 512), device=dev, generator=gen))
    b = torch.randn((128,), device=dev, generator=gen)
    record("bias_act", "[1,128,512^2] lrelu demod noise clamp",
           [(ba.bias_act(x, b, **kw), ba.bias_act_plain(x, b, **kw))], 1e-6,
           cuda_ms(lambda: ba.bias_act(x, b, **kw)),
           cuda_ms(lambda: ba.bias_act_plain(x, b, **kw)))
    x, b = x[:, :3].contiguous(), b[:3].contiguous()
    record("bias_act", "[1,3,512^2] linear",
           [(ba.bias_act(x, b, axis=1), ba.bias_act_plain(x, b, axis=1))], 1e-6,
           cuda_ms(lambda: ba.bias_act(x, b, axis=1)),
           cuda_ms(lambda: ba.bias_act_plain(x, b, axis=1)))
    return rows


def make_pipeline(preset: str, dev, use_torso: bool = True, n_vertices: int = 35709,
                  **overrides):
    """The pipeline (torso model or head only) on the synthetic morphable
    model at the BFM09 mesh's scale (35,709 vertices, ~70k faces), seeded
    mock weights."""
    from real3dportrait_tpu_torch.config import load_config
    from real3dportrait_tpu_torch.geometry.bfm import synthetic_bfm
    from real3dportrait_tpu_torch.inference.pipeline import Real3DPortraitPipeline

    cfg = load_config(os.path.join(ROOT, "configs", "real3d_orig.yaml"),
                      dict(sampling_preset=preset, **overrides))
    return Real3DPortraitPipeline(cfg, use_torso=use_torso, mock_weights=True,
                                  assets=synthetic_bfm(n_vertices=n_vertices), seed=0,
                                  device=dev)


def slice_inputs(res: int, n_frames: int):
    rng = np.random.RandomState(0)
    src = rng.randint(0, 256, (res, res, 3)).astype(np.uint8)
    exp = torch.from_numpy(rng.randn(n_frames, 64).astype(np.float32) * 0.3)
    bg = rng.randint(0, 256, (res, res, 3)).astype(np.uint8)
    return src, exp, bg


def run_slice(name: str, pipe, src, exp, bg, expect: set) -> dict:
    """Warm up over the whole sequence (cuDNN plans, allocator, first
    launches), then synthesise it again with the launch counters from 0;
    check the frames and that every kernel in ``expect`` launched."""
    coeffs = pipe.fit_source(None)
    pipe.synthesize(src, exp, coeffs, bg_img=bg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tm: dict = {}
    reset_launches()
    t0 = time.perf_counter()
    frames = pipe.synthesize(src, exp, coeffs, bg_img=bg, timings=tm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    res = pipe.res
    check(tuple(frames.shape) == (len(exp), res, res, 3), f"frames shape {tuple(frames.shape)}")
    check(frames.is_cuda, "frames must stay on the GPU")
    check(bool(torch.isfinite(frames).all()), "non-finite frames")
    check(all(counts[k] > 0 for k in expect), f"{name}: a kernel was not launched: {counts}")
    p50 = statistics.median(tm["frame_ms"])
    caches = "".join(f", {k[:-3]} {tm[k]:.2f} ms" for k in ("cano_ms", "appearance_ms", "bg_ms")
                     if k in tm)
    print(f"slice[{name}]: frames {tuple(frames.shape)} p50 {p50:.2f} ms/frame "
          f"({1e3 / p50:.2f} fps), frame ms {[round(x, 2) for x in tm['frame_ms']]}"
          f"{caches}, wall {wall:.2f} s, launches {counts}, "
          f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts


def phase_slice(dev: torch.device) -> dict:
    """The torso pipeline at ``fast`` (with a background image, the main
    path, whose launch counts the JSON line reports) and ``reference``, then
    the head-only pipeline at ``fast``."""
    src, exp, bg = slice_inputs(512, 8)
    every = set(REPLACES)
    launches = {}
    for name, preset, use_torso, bg_img in (("torso fast", "fast", True, bg),
                                            ("torso reference", "reference", True, None),
                                            ("head-only fast", "fast", False, None)):
        pipe = make_pipeline(preset, dev, use_torso=use_torso)
        head_only = every - {"torso_deform_input", "torso_warp_volume"}
        counts = run_slice(name, pipe, src, exp, bg_img, every if use_torso else head_only)
        if name == "torso fast":
            launches = counts
        del pipe
        torch.cuda.empty_cache()
    return launches


def phase_flagship(dev: torch.device, steps: int = 16) -> None:
    """The flagship frame step at 512^2 (``fast``) with random keypoints:
    p50 of the CUDA-event time of ``steps`` steps after 3 warm-up steps."""
    from real3dportrait_tpu_torch.flagship import flagship

    t0 = time.perf_counter()
    frame_step, args = flagship(device=dev)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    for _ in range(3):
        frame_step(*args)
    torch.cuda.synchronize()
    reset_launches()
    times = []
    for _ in range(steps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        image = frame_step(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    counts = read_launches()
    check(tuple(image.shape) == (1, 512, 512, 3) and bool(torch.isfinite(image).all()),
          f"flagship image {tuple(image.shape)} not finite or of the wrong shape")
    # the step takes a SECC map as input: every kernel but the raster
    check(all(v > 0 for k, v in counts.items() if k != "secc_raster"),
          f"flagship: a kernel was not launched: {counts}")
    p50 = statistics.median(times)
    print(f"flagship[fast, random keypoints]: p50 {p50:.2f} ms/step ({1e3 / p50:.2f} fps) over "
          f"{steps} steps, step ms {[round(x, 2) for x in times]}, set-up {setup:.2f} s, "
          f"launches per step {({k: v // steps for k, v in counts.items()})}")


def compare(tag: str, gpu: torch.Tensor, cpu: torch.Tensor) -> None:
    """Scale-normalised GPU vs CPU check: max 1e-3 and mean 1e-4 (fp32
    through ~100 layers of random weights, convs and sums in another order)."""
    scale = max(float(cpu.abs().max()), 1e-6)
    err, merr = max_err(gpu.cpu(), cpu) / scale, mean_err(gpu.cpu(), cpu) / scale
    print(f"reference[{tag}]: small config GPU vs CPU max_err/scale {err:.3e} "
          f"mean {merr:.3e} (tol 1e-3 / 1e-4)")
    check(err <= 1e-3 and merr <= 1e-4, f"GPU {tag} disagrees with the CPU reference")


def phase_reference(dev: torch.device) -> None:
    """Small configurations on the GPU (kernels) and on the CPU (plain
    versions) from the same seed must agree: the frames of the torso
    (``torso_model_scale=tiny``) and head-only pipelines, and, since random
    SR weights saturate many frame pixels at +-1, the unclamped raw render,
    depth and weight images of one frame step; for the torso model that
    step has random keypoints, and its warped torso image and occlusion
    are compared too."""
    from real3dportrait_tpu_torch.geometry import camera

    small = dict(final_resolution=64, neural_rendering_resolution=16, secc_resolution=48,
                 sr_channel0=16, sr_channel1=16, torso_model_scale="tiny")
    src, exp, bg = slice_inputs(64, 2)
    rng = np.random.RandomState(1)
    secc = torch.from_numpy(rng.uniform(-1, 1, (1, 64, 64, 9)).astype(np.float32))
    img = torch.from_numpy(src[None].astype(np.float32) / 127.5 - 1.0)
    kps = [torch.from_numpy(rng.uniform(-0.8, 0.8, (1, 68, 3)).astype(np.float32))
           for _ in range(2)]
    euler = torch.tensor([[0.05, 0.2, 0.0]])
    _, c2w, intr = camera.convert_eg3d_convention(euler, torch.zeros((1, 3)))
    cam = camera.pack_camera(c2w, intr[0])
    for use_torso in (True, False):
        outs = []
        for d in (dev, torch.device("cpu")):
            pipe = make_pipeline("fast", d, use_torso=use_torso, n_vertices=2000, **small)
            frames = pipe.synthesize(src, exp, pipe.fit_source(None), bg_img=bg)
            with torch.no_grad():
                m = pipe.model
                cano = m.cal_cano_plane(img.to(d))
                if use_torso:
                    cond = pipe.mock_cond(img.to(d))
                    cond.update(kp_src=kps[0].to(d), kp_drv=kps[1].to(d))
                    cond.update(torso_appearance=m.cal_torso_appearance(cond),
                                bg_feat=m.cal_bg_feat(cond))
                    step = m.synthesis(None, cam.to(d), cond, secc=secc.to(d),
                                       cano_planes=cano)
                    step.update({k: step["torso_ret"][k]
                                 for k in ("deformed_torso_img", "occlusion_2")})
                else:
                    step = m.synthesis(None, cam.to(d), secc=secc.to(d), cano_planes=cano)
            keys = ["image_raw", "image_depth", "weights_img"]
            if use_torso:
                keys += ["image", "deformed_torso_img", "occlusion_2"]
            outs.append({"frames": frames, **{k: step[k] for k in keys}})
        for k, gpu in outs[0].items():
            compare(f"{'torso' if use_torso else 'head-only'} {k}", gpu, outs[1][k])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    check(torch.cuda.device_count() == 1,
          f"chip_smoke uses one card; {torch.cuda.device_count()} are visible "
          f"(CUDA_VISIBLE_DEVICES={os.environ['CUDA_VISIBLE_DEVICES']})")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_toolchain()
    phase_build()
    torch.cuda.synchronize()
    rows = phase_kernels(dev)
    torch.cuda.synchronize()
    launches = phase_slice(dev)
    torch.cuda.synchronize()
    phase_flagship(dev)
    torch.cuda.synchronize()
    phase_reference(dev)
    torch.cuda.synchronize()
    kernels_json = [dict(name=k, route="cuda", source=SOURCES[k], replaces=REPLACES[k],
                         launches=launches[k], **v) for k, v in rows.items()]
    print(json.dumps({"kernels": kernels_json}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

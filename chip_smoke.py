#!/usr/bin/env python3
"""Drive the PyTorch port's audio-driven ``run``, its default model and the
released geometry once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

1. toolchain: ``nvidia-smi`` name and power limit, torch and CUDA versions,
   ``nvcc --version``; exits non-zero when no CUDA device is visible;
2. build every kernel of ``real3dportrait_tpu_torch/csrc`` with nvcc for
   sm_90a (one nvcc per source, in parallel), or reuse the library built
   from identical sources (registers and spills from ptxas are printed
   either way);
3. each kernel (K1, K1-trigrid, K2-K7b; K6a/K6b in fp32 and bf16) against
   its plain PyTorch version at the main path's shapes, TF32 off, with the
   tolerance stated beside it; the median CUDA-event time of both, of one
   PyTorch call that computes the same function where there is one, and
   the bound: the larger of the bytes over the HBM rate and the operations
   over the peak rate of their type (H100 SXM data sheet);
4. the main path: ``Real3DPortraitPipeline().run`` with the JAX defaults
   (periodic blink, source preparation) from a 4 s seeded 16 kHz wav
   through the audio front end and the audio-to-motion flow-VAE to 100
   frames of 512^2 and a written video, with the launch counters from 0
   (the counts the kernels line reports); then its stage times,
   ``synthesize`` with an explicit seeded segmap, and ``hubert_large``
   (seeded weights) on the same wav;
5. the slices: ``Real3DPortraitPipeline()``'s default model,
   ``configs/secc_img2plane_torso.yaml`` (depth-3 tri-grids through
   K1-trigrid, the composite backbone with GroupNorms, bf16 SR blocks
   through bf16 K6a/K6b; the torso model, seeded mock weights) synthesises
   8 frames of 512^2 from a seeded source image, 8 expression frames and a
   background image at the ``fast`` preset (the main path, whose launch
   counts the kernels line reports) and at the config's 48+48; then
   ``configs/real3d_orig.yaml`` (tri-planes through K1, fp32) with the
   torso at ``fast`` and ``reference`` (48+48) and the head only at
   ``fast``. Each run checks which
   kernels launched and which must not have (these drive the torso
   without source preparation or blinks, as before the ``run`` path);
6. the flagship frame step (``real3dportrait_tpu_torch.flagship``, the
   released geometry) with random keypoints, so that the torso warps
   interpolate;
7. small configurations of both models, the full-width audio-to-motion
   model, a small HuBERT and a tiny-config ``run`` on both the GPU and the
   CPU (plain versions), whose outputs must agree.

The last lines are the kernels JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

# one card: the smoke drives device 0 and reports the cards it can see
os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from real3dportrait_tpu_torch.kernels import card_line, cuda_ms  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
DEFAULT_CONFIG = "secc_img2plane_torso.yaml"
RELEASED_CONFIG = "real3d_orig.yaml"
# H100 SXM data sheet: HBM bytes/s and dense peak operations/s by type
HBM_RATE = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
REPLACES = {
    "triplane_decode": "real3dportrait_tpu/rendering/renderer.py:113",
    "trigrid_decode": "real3dportrait_tpu/rendering/renderer.py:81",
    "importance_sample": "real3dportrait_tpu/rendering/renderer.py:300",
    "merge_composite": "real3dportrait_tpu/rendering/renderer.py:367",
    "secc_raster": "real3dportrait_tpu/geometry/rasterizer.py:248",
    "torso_deform_input": "real3dportrait_tpu/models/torso.py:378",
    "torso_warp_volume": "real3dportrait_tpu/models/torso.py:500",
    "upfirdn2d": "real3dportrait_tpu/ops/upfirdn2d.py:59",
    "bias_act": "real3dportrait_tpu/ops/bias_act.py:37",
    "conv3d": "real3dportrait_tpu/ops/conv3d.py:21",
    "mfe_tail": "real3dportrait_tpu/models/torso.py:429",
}
SOURCES = {
    "triplane_decode": "real3dportrait_tpu_torch/csrc/triplane_decode.cu",
    "trigrid_decode": "real3dportrait_tpu_torch/csrc/triplane_decode.cu",
    "importance_sample": "real3dportrait_tpu_torch/csrc/render_march.cu",
    "merge_composite": "real3dportrait_tpu_torch/csrc/render_march.cu",
    "secc_raster": "real3dportrait_tpu_torch/csrc/secc_raster.cu",
    "torso_deform_input": "real3dportrait_tpu_torch/csrc/torso_warp.cu",
    "torso_warp_volume": "real3dportrait_tpu_torch/csrc/torso_warp.cu",
    "upfirdn2d": "real3dportrait_tpu_torch/csrc/stylegan_epilogue.cu",
    "bias_act": "real3dportrait_tpu_torch/csrc/stylegan_epilogue.cu",
    "conv3d": "real3dportrait_tpu_torch/csrc/conv3d.cu",
    "mfe_tail": "real3dportrait_tpu_torch/csrc/conv3d.cu",
}


def wrappers() -> dict:
    """The eleven kernel wrappers, by kernel name; each counts its launches
    (K6a and K6b also their bf16 launches apart, ``launches_bf16``)."""
    from real3dportrait_tpu_torch.geometry.rasterizer import secc_raster
    from real3dportrait_tpu_torch.models.decoder import trigrid_decode, triplane_decode
    from real3dportrait_tpu_torch.models.torso import (
        mfe_tail, torso_deform_input, torso_warp_volume)
    from real3dportrait_tpu_torch.ops.bias_act import bias_act
    from real3dportrait_tpu_torch.ops.conv3d import conv3d
    from real3dportrait_tpu_torch.ops.upfirdn2d import upfirdn2d
    from real3dportrait_tpu_torch.rendering.renderer import importance_sample, merge_composite

    return {"triplane_decode": triplane_decode, "trigrid_decode": trigrid_decode,
            "importance_sample": importance_sample, "merge_composite": merge_composite,
            "secc_raster": secc_raster, "torso_deform_input": torso_deform_input,
            "torso_warp_volume": torso_warp_volume, "upfirdn2d": upfirdn2d,
            "bias_act": bias_act, "conv3d": conv3d, "mfe_tail": mfe_tail}


BF16_COUNTED = ("upfirdn2d", "bias_act")


def reset_launches() -> None:
    for name, w in wrappers().items():
        w.launches = 0
        if name in BF16_COUNTED:
            w.launches_bf16 = 0


def read_launches() -> dict:
    """Launches by kernel name, and the bf16 ones as ``"<name> bf16"``."""
    counts = {k: w.launches for k, w in wrappers().items()}
    counts.update({f"{k} bf16": wrappers()[k].launches_bf16 for k in BF16_COUNTED})
    return counts


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in units of the last place of bf16 ``want``."""
    want = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
    return float(((got.float() - want).abs() / ulp).max())


def bound(n_bytes: float, ops: float, dtype: torch.dtype) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / HBM_RATE, ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


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
    """Each kernel vs its plain version at the main path's shapes."""
    import torch.nn.functional as F

    from real3dportrait_tpu_torch.geometry import bfm
    from real3dportrait_tpu_torch.geometry.rasterizer import (
        project_to_screen, secc_raster, secc_raster_plain)
    from real3dportrait_tpu_torch.models.decoder import (
        OSGDecoder, trigrid_decode, trigrid_decode_plain, triplane_decode,
        triplane_decode_plain)
    from real3dportrait_tpu_torch.rendering.renderer import (
        importance_sample, importance_sample_plain, importance_u, merge_composite,
        merge_composite_plain)
    from real3dportrait_tpu_torch.weights import mock_init_

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    f32, bf16 = torch.float32, torch.bfloat16

    def record(name, tag, outs, tol, ms, plain_ms, cost, library=None, ulps=None, extra=""):
        """``outs``: (kernel output, plain output) pairs; ``cost``: (bytes,
        operations, dtype) of the call; ``library``: the ms of one PyTorch
        call computing the same function, or None; ``ulps``: in bf16, the
        largest distance allowed in bf16 ulps of the plain output (then
        ``tol`` is not used)."""
        err = max(max_err(k, p) for k, p in outs)
        merr = max(mean_err(k, p) for k, p in outs)
        bound_ms, bound_by = bound(*cost)
        if ulps is None:
            check(err <= tol, f"{name}[{tag}] disagrees with its plain version: {err} > {tol}")
            tol_text = f"tol {tol:g}"
        else:
            u = max(bf16_ulps(k, p) for k, p in outs)
            equal = all(torch.equal(k, p) for k, p in outs)
            check(u <= ulps, f"{name}[{tag}] is {u} bf16 ulps from its plain version")
            tol_text = f"{u:g} bf16 ulps, {'bit-equal' if equal else 'not bit-equal'}, " \
                       f"tol {ulps} ulps"
        lib = "null" if library is None else f"{library:.4f} ms"
        print(f"{name}[{tag}]: max_abs_err {err:.3e} mean {merr:.3e} ({tol_text}) {extra}"
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms library {lib} "
              f"bound {bound_ms:.4f} ms ({bound_by})")
        # the JSON line keeps each kernel's first shape: the main path's
        # largest call, named with its working type
        rows.setdefault(name, dict(shape=tag, dtype=str(cost[2]).removeprefix("torch."),
                                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by,
                                   library_ms=library))

    # K1 and K1-trigrid: the planes of one frame, [1,3,256,256,32] and
    # [1,3,3,256,256,32]; the fast preset's coarse (16 x 128^2) and fine
    # (32 x 128^2) passes and the 48-sample passes. fp32 sums in another
    # order: tolerance 1e-4 absolute on rgb in [-0.001, 1.001] and sigma
    # O(1). Operations: 2 per corner channel (FMA) and the MLP's
    # 2 * (32*64 + 64*33) plus 96 transcendentals, per point.
    dec = mock_init_(OSGDecoder(32, 64, 32), torch.Generator().manual_seed(1)).to(dev)
    mlp_ops = 2 * (32 * 64 + 64 * 33) + 96
    for name, shape, corners, fn, plain in (
            ("trigrid_decode", (1, 3, 3, 256, 256, 32), 8, trigrid_decode,
             trigrid_decode_plain),
            ("triplane_decode", (1, 3, 256, 256, 32), 4, triplane_decode,
             triplane_decode_plain)):
        planes = torch.randn(shape, device=dev, generator=gen)
        counts = (524288, 262144, 786432) if name == "trigrid_decode" else (262144, 786432)
        for n in counts:
            coords = torch.rand((1, n, 3), device=dev, generator=gen) - 0.5
            with torch.no_grad():
                k_rgb, k_sig = fn(planes, coords, 1.0, dec)
                p_rgb, p_sig = plain(planes, coords, 1.0, dec)
                ms = cuda_ms(lambda: fn(planes, coords, 1.0, dec))
                pms = cuda_ms(lambda: plain(planes, coords, 1.0, dec))
            cost = (nbytes(planes, coords, k_rgb, k_sig),
                    n * (3 * corners * 32 * 2 + mlp_ops), f32)
            record(name, f"{n} pts", [(k_rgb, p_rgb), (k_sig, p_sig)], 1e-4, ms, pms, cost)
        del planes

    # K2/K3: 16,384 rays (128^2) at 16+32 and 48+48. Depths O(2-3); sums in
    # another order (cdf, transmittance): tolerance 1e-4 absolute on depths,
    # composited rgb in [-1,1] and weights. Operations per ray: K2 ~16 per
    # coarse sample (march, smoothing, pdf, cdf) and per fine sample a
    # binary search and an interpolation; K3 2 per colour channel and ~20
    # per merged sample.
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
               cuda_ms(lambda: importance_sample_plain(depths, sigma, u)),
               (nbytes(depths, sigma, u, fine_k),
                r * (16 * s_c + s_f * (2 * math.ceil(math.log2(s_c)) + 10)), f32))
        c1 = torch.rand((1, r, s_c, 32), device=dev, generator=gen)
        c2 = torch.rand((1, r, s_f, 32), device=dev, generator=gen)
        s2 = 3 * torch.randn((1, r, s_f, 1), device=dev, generator=gen)
        args = (depths, c1, sigma, fine_p, c2, s2)
        outs = list(zip(merge_composite(*args), merge_composite_plain(*args)))
        record("merge_composite", f"{s_c}+{s_f}", outs, 1e-4,
               cuda_ms(lambda: merge_composite(*args)),
               cuda_ms(lambda: merge_composite_plain(*args)),
               (nbytes(*args, *(k for k, _ in outs)), r * (s_c + s_f) * (2 * 32 + 20), f32))

    # K4: 16 frames of the 35,709-vertex synthetic mesh at 192^2, zero pose.
    # The kernel rounds every operation as the plain version does and breaks
    # depth ties by face id: expected bit-equal; tolerance 0 differing mask
    # pixels and 1e-6 on the NCC. Operations: ~25 per pixel of each face's
    # clipped bounding box (three edge functions, depth) and ~20 per output
    # pixel (the resolve), counted from this run's projected faces.
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
    fuv = uv[:, faces.long()]                                      # [T,F,3,2]
    lo = torch.floor(fuv.min(dim=2).values).clamp(0, 191)
    hi = torch.floor(fuv.max(dim=2).values).clamp(0, 191)
    box_px = float((hi - lo + 1).clamp_min(0).prod(dim=-1).sum())
    record("secc_raster", "16x192^2", [(ki, pi)], 1e-6,
           cuda_ms(lambda: secc_raster(uv, z, faces, attr, 192)),
           cuda_ms(lambda: secc_raster_plain(uv, z, faces, attr, 192), reps=5),
           (nbytes(uv, z, faces, attr, km, ki), 25 * box_px + 20 * km.numel(), f32),
           extra=f"coverage {float(km.mean()):.3f} ")

    # K5a: the compressed volume of one 512^2 frame [1,16,64,64,4] and 4 of
    # the 68 keypoints, uniform in [-0.8,0.8]; then offsets up to 3.2 that
    # push samples outside the volume (zero padding). The plain version's
    # grid coordinates are i * (1 / (n-1)) (torch's CUDA division by a
    # scalar), the kernel's i / (n-1): one rounding of a coordinate moves a
    # sample by up to ~4e-6 voxel at n = 64, and neighbouring voxels of the
    # N(0,1) volume differ by up to ~6, so the two differ by up to ~3e-5
    # (each is ~2-4e-5 off a float64 evaluation): tolerance 1e-4 absolute.
    # Operations per voxel: 8 gaussians of ~10 and, per candidate, 8 corners
    # of 4 channels (2 each) and ~20 for the weights.
    # K5b: the appearance volume [1,16,64,64,32], deformation uniform in
    # [-1.2,1.2] (border clamp); the same coordinates reach both versions:
    # 1e-5 absolute. Operations per voxel: 8 corners of 32 channels, 2 each,
    # and ~20 for the weights. F.grid_sample (5-D, border) computes the
    # same function, on the volume's NCDHW view.
    from real3dportrait_tpu_torch.models import torso

    fs = torch.randn((1, 16, 64, 64, 4), device=dev, generator=gen)
    for tag, reach in (("kp 0.8", 0.8), ("kp 1.6, outside", 1.6)):
        kp_s = reach * (2 * torch.rand((1, 4, 3), device=dev, generator=gen) - 1)
        kp_d = reach * (2 * torch.rand((1, 4, 3), device=dev, generator=gen) - 1)
        got = torso.torso_deform_input(fs, kp_s, kp_d)
        record("torso_deform_input", f"[1,16,64,64,4] {tag}",
               [(got, torso.torso_deform_input_plain(fs, kp_s, kp_d))], 1e-4,
               cuda_ms(lambda: torso.torso_deform_input(fs, kp_s, kp_d)),
               cuda_ms(lambda: torso.torso_deform_input_plain(fs, kp_s, kp_d)),
               (nbytes(fs, kp_s, kp_d, got), 65536 * (80 + 5 * (8 * 4 * 2 + 20)), f32))
    vol = torch.randn((1, 16, 64, 64, 32), device=dev, generator=gen)
    grid = 2.4 * torch.rand((1, 16, 64, 64, 3), device=dev, generator=gen) - 1.2
    got = torso.torso_warp_volume(vol, grid)
    plain = torso.torso_warp_volume_plain(vol, grid)

    def k5b_library():
        return F.grid_sample(vol.permute(0, 4, 1, 2, 3), grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    check(max_err(k5b_library().reshape(plain.shape), plain) <= 1e-5,
          "torso_warp_volume: F.grid_sample computes another function")
    record("torso_warp_volume", "[1,16,64,64,32]", [(got, plain)], 1e-5,
           cuda_ms(lambda: torso.torso_warp_volume(vol, grid)),
           cuda_ms(lambda: torso.torso_warp_volume_plain(vol, grid)),
           (nbytes(vol, grid, got), 65536 * (8 * 32 * 2 + 20), f32),
           library=cuda_ms(k5b_library))
    del fs, vol, grid, got, plain

    # K6a: the FIR after block1's and block0's up-convolutions (4x4 taps,
    # gain 4) in bf16, the blocks' working type on the default model, then
    # in fp32 (the released geometry), the skip image's 2x upsample at both
    # blocks (fp32 on both models), and a crop (negative padding) with a
    # downsample. bf16: the taps ({1,3,9}/16) are exact, the kernel sums in
    # fp32 and rounds once, the plain version's depthwise bf16 convolution
    # sums in another order: within 2 bf16 ulps of its output. fp32: 16
    # taps summed in another order, 1e-5 absolute on N(0,1) inputs.
    # Operations: 2 per tap that lands on the input (up 2: a quarter).
    # Library: one grouped F.conv2d (the FIR) or F.conv_transpose2d
    # (stride-2 upsample), checked to give the plain version's output.
    from real3dportrait_tpu_torch.ops import bias_act as ba
    from real3dportrait_tpu_torch.ops import upfirdn2d as ufd

    f = ufd.setup_filter([1, 3, 3, 1], device=dev)
    cases = (("block1 FIR [1,128,515^2] bf16", (1, 128, 515, 515), bf16, dict(gain=4)),
             ("block0 FIR [1,256,259^2] bf16", (1, 256, 259, 259), bf16, dict(gain=4)),
             ("block1 FIR [1,128,515^2]", (1, 128, 515, 515), f32, dict(gain=4)),
             ("block0 FIR [1,256,259^2]", (1, 256, 259, 259), f32, dict(gain=4)),
             ("skip up2 [1,3,128^2]", (1, 3, 128, 128), f32,
              dict(up=2, padding=(2, 1, 2, 1), gain=4)),
             ("skip up2 [1,3,256^2]", (1, 3, 256, 256), f32,
              dict(up=2, padding=(2, 1, 2, 1), gain=4)),
             ("crop up2 down2 [1,8,99^2]", (1, 8, 99, 99), f32,
              dict(up=2, down=2, padding=(-3, 1, 2, -2))))
    for tag, shape, dtype, kw in cases:
        x = torch.randn(shape, device=dev, generator=gen).to(dtype)
        got = ufd.upfirdn2d(x, f, **kw)
        want = ufd.upfirdn2d_plain(x, f, **kw)
        c = shape[1]
        taps = 16 // (kw.get("up", 1) ** 2)
        library = None
        if "crop" not in tag:
            w4 = (f * kw["gain"]).to(dtype)[None, None].expand(c, 1, 4, 4).contiguous()
            if kw.get("up", 1) == 2:
                def lib(x=x, w4=w4, c=c):
                    return F.conv_transpose2d(x, w4, stride=2, padding=1, groups=c)
            else:
                w4 = torch.flip(w4, (2, 3))

                def lib(x=x, w4=w4, c=c):
                    return F.conv2d(x, w4, groups=c)
            check(max_err(lib(), want) <= (1e-5 if dtype == f32 else
                                           0.02 * float(want.abs().max())),
                  f"upfirdn2d[{tag}]: the library call computes another function")
            library = cuda_ms(lib)
        record("upfirdn2d", tag, [(got, want)], 1e-5,
               cuda_ms(lambda: ufd.upfirdn2d(x, f, **kw)),
               cuda_ms(lambda: ufd.upfirdn2d_plain(x, f, **kw)),
               (nbytes(x, got), 2 * taps * got.numel(), dtype), library=library,
               ulps=2 if dtype == bf16 else None)
        del x, got, want

    # K6b: block1's conv epilogue (demodulation, noise, bias, lrelu, gain
    # sqrt 2, clamp 256) at [1,128,512^2] and block0's at [1,256,256^2] in
    # bf16, where every step rounds to bf16 in the plain version's order:
    # expected bit-equal, checked within 2 bf16 ulps; then block1's fp32
    # epilogue of the released geometry (clamp 4 so that it acts) and
    # toRGB's [1,3,512^2] (bias only), rounded in the plain version's
    # order: 1e-6 absolute. Operations: one per term (scale, noise, bias,
    # activation, gain) and two for the clamp, per element. No single
    # PyTorch call computes this epilogue.
    for tag, shape, dtype, clamp in (("[1,128,512^2] lrelu demod noise clamp bf16",
                                      (1, 128, 512, 512), bf16, 256.0),
                                     ("[1,256,256^2] lrelu demod noise clamp bf16",
                                      (1, 256, 256, 256), bf16, 256.0),
                                     ("[1,128,512^2] lrelu demod noise clamp",
                                      (1, 128, 512, 512), f32, 4.0)):
        b, c, h, w = shape
        x = (4 * torch.randn(shape, device=dev, generator=gen)).to(dtype)
        kw = dict(act="lrelu", gain=2 ** 0.5, clamp=clamp, axis=1,
                  scale=torch.rand((b, c), device=dev, generator=gen) + 0.5,
                  noise=0.3 * torch.randn((h, w), device=dev, generator=gen))
        bias = torch.randn((c,), device=dev, generator=gen)
        got = ba.bias_act(x, bias, **kw)
        record("bias_act", tag, [(got, ba.bias_act_plain(x, bias, **kw))], 1e-6,
               cuda_ms(lambda: ba.bias_act(x, bias, **kw)),
               cuda_ms(lambda: ba.bias_act_plain(x, bias, **kw)),
               (nbytes(x, got, bias, kw["scale"], kw["noise"]), 7 * x.numel(), dtype),
               ulps=2 if dtype == bf16 else None)
    x, bias = x[:, :3].contiguous(), bias[:3].contiguous()
    got = ba.bias_act(x, bias, axis=1)
    record("bias_act", "[1,3,512^2] linear",
           [(got, ba.bias_act_plain(x, bias, axis=1))], 1e-6,
           cuda_ms(lambda: ba.bias_act(x, bias, axis=1)),
           cuda_ms(lambda: ba.bias_act_plain(x, bias, axis=1)),
           (nbytes(x, got, bias), x.numel(), f32))
    del x, got
    kernels_k7(dev, gen, record)
    return rows


def kernels_k7(dev: torch.device, gen: torch.Generator, record) -> None:
    """K7a at the standard torso's shapes: the 7^3 tgt_head_fuser
    [1,89,16,64,64] -> 32, the U-Net's first 3^3 conv (down_0,
    [1,25,16,64,64] -> 64) and its deepest (down_4, [1,512,16,4,4] -> 1024,
    57 MB of weights); K7b at the frame's [1,32,16,64,64] with 4 keypoints
    uniform in [-0.8, 0.8]. Inputs N(0,1), weights N(0, 1/fan_in), so every
    output is O(1). K7a sums up to 89 * 343 = 30,527 products in another
    order than cuDNN: 3e-4 absolute. K7b: mask logits of 32 * 343 products
    and occlusion sums of 512 * 49, then softmax and sigmoid: 1e-4 absolute
    on the deformation and both maps. Operations: 2 per product, counting
    only the taps inside the volume (``conv3d_ops``), none of the padding's. The
    library call of K7a is cuDNN's ``F.conv3d`` (TF32 off), which is also
    the plain version; no single PyTorch call computes K7b, so cuDNN's
    ``mask_conv`` alone is printed beside it."""
    import torch.nn.functional as F

    from real3dportrait_tpu_torch.models import torso
    from real3dportrait_tpu_torch.ops import conv3d as c3d

    f32 = torch.float32
    tiles, sms = c3d.kernel_tiles(), c3d.sm_count(dev)
    for tag, (ci, co, k, dhw) in (("fuser 7^3 [1,89,16,64,64]->32", (89, 32, 7, (16, 64, 64))),
                                  ("down_0 3^3 [1,25,16,64,64]->64", (25, 64, 3, (16, 64, 64))),
                                  ("down_4 3^3 [1,512,16,4,4]->1024", (512, 1024, 3, (16, 4, 4)))):
        x = torch.randn((1, ci, *dhw), device=dev, generator=gen)
        w = torch.randn((co, ci, k, k, k), device=dev, generator=gen) / (ci * k ** 3) ** 0.5
        b = torch.randn((co,), device=dev, generator=gen)
        got = c3d.conv3d(x, w, b)
        record("conv3d", tag, [(got, c3d.conv3d_plain(x, w, b))], 3e-4,
               cuda_ms(lambda: c3d.conv3d(x, w, b)), cuda_ms(lambda: c3d.conv3d_plain(x, w, b)),
               (nbytes(x, w, b, got), c3d.conv3d_ops(ci, co, *dhw, k), f32),
               library=cuda_ms(lambda: F.conv3d(x, w, b, padding=k // 2)),
               extra=f"plan {c3d.conv3d_plan(1, ci, co, *dhw, k, tiles, sms)} ")
        del x, w, b, got
    c, d, h, w_ = 32, 16, 64, 64
    x = torch.randn((1, c, d, h, w_), device=dev, generator=gen)
    mask_w = torch.randn((5, c, 7, 7, 7), device=dev, generator=gen) / (c * 343) ** 0.5
    mask_b = torch.randn((5,), device=dev, generator=gen)
    occ_w = torch.randn((2, c * d, 7, 7), device=dev, generator=gen) / (c * d * 49) ** 0.5
    occ_b = torch.randn((2,), device=dev, generator=gen)
    kp_s, kp_d = (1.6 * torch.rand((1, 4, 3), device=dev, generator=gen) - 0.8
                  for _ in range(2))
    args = (x, mask_w, mask_b, occ_w, occ_b, kp_s, kp_d)
    got = torso.mfe_tail(*args)
    mask_ms = cuda_ms(lambda: F.conv3d(x, mask_w, mask_b, padding=3))
    # the 7^3 mask conv and both 7^2 heads, a conv of depth 1 over C*D channels
    ops = c3d.conv3d_ops(c, 5, d, h, w_, 7) + c3d.conv3d_ops(c * d, 2, 1, h, w_, 7)
    record("mfe_tail", "[1,32,16,64,64] K+1=5", list(zip(got, torso.mfe_tail_plain(*args))),
           1e-4, cuda_ms(lambda: torso.mfe_tail(*args)),
           cuda_ms(lambda: torso.mfe_tail_plain(*args)), (nbytes(*args, *got), ops, f32),
           extra=f"cuDNN mask_conv 7^3 alone {mask_ms:.4f} ms ")


def make_pipeline(config: str, preset: str, dev, use_torso: bool = True,
                  n_vertices: int = 35709, **overrides):
    """The pipeline of ``configs/<config>`` (torso model or head only) on the
    synthetic morphable model at the BFM09 mesh's scale (35,709 vertices,
    ~70k faces), seeded mock weights."""
    from real3dportrait_tpu_torch.config import load_config
    from real3dportrait_tpu_torch.geometry.bfm import synthetic_bfm
    from real3dportrait_tpu_torch.inference.pipeline import Real3DPortraitPipeline

    cfg = load_config(os.path.join(ROOT, "configs", config),
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


def run_slice(name: str, pipe, src, exp, bg, expect: set, forbid: set) -> dict:
    """Warm up over the whole sequence (cuDNN plans, allocator, first
    launches), then synthesise it again with the launch counters from 0;
    check the frames, that every kernel in ``expect`` launched and that
    none in ``forbid`` did."""
    coeffs = pipe.fit_source(None)
    mock = dict(blink_mode="none", prepare_source_images=False)
    pipe.synthesize(src, exp, coeffs, bg_img=bg, **mock)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tm: dict = {}
    reset_launches()
    t0 = time.perf_counter()
    frames = pipe.synthesize(src, exp, coeffs, bg_img=bg, timings=tm, **mock)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    res = pipe.res
    check(tuple(frames.shape) == (len(exp), res, res, 3), f"frames shape {tuple(frames.shape)}")
    check(frames.is_cuda, "frames must stay on the GPU")
    check(bool(torch.isfinite(frames).all()), "non-finite frames")
    check(all(counts[k] > 0 for k in expect), f"{name}: a kernel was not launched: {counts}")
    check(all(counts[k] == 0 for k in forbid), f"{name}: a kernel of another path ran: {counts}")
    p50 = statistics.median(tm["frame_ms"])
    caches = "".join(f", {k[:-3]} {tm[k]:.2f} ms" for k in ("cano_ms", "appearance_ms", "bg_ms")
                     if k in tm)
    print(f"slice[{name}]: frames {tuple(frames.shape)} p50 {p50:.2f} ms/frame "
          f"({1e3 / p50:.2f} fps), frame ms {[round(x, 2) for x in tm['frame_ms']]}"
          f"{caches}, wall {wall:.2f} s, launches {counts}, "
          f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts


def phase_slice(dev: torch.device) -> dict:
    """The default model's torso pipeline at ``fast`` (with a background
    image) and at the config's 48+48; then the released geometry's torso
    pipeline at ``fast`` (with the background image: the path whose count
    the line reports for K1, which the default model does not run) and at
    ``reference`` (48+48: K1 on 786k points per fine pass), and its
    head-only pipeline at ``fast``. Each drives the torso without source
    preparation or blinks."""
    src, exp, bg = slice_inputs(512, 8)
    every = set(read_launches())
    trigrid = every - {"triplane_decode"}
    triplane = every - {"trigrid_decode", "upfirdn2d bf16", "bias_act bf16"}
    torso = {"torso_deform_input", "torso_warp_volume", "conv3d", "mfe_tail"}
    launches = {}
    for name, config, preset, use_torso, bg_img, expect in (
            ("default torso fast", DEFAULT_CONFIG, "fast", True, bg, trigrid),
            ("default torso 48+48", DEFAULT_CONFIG, "config", True, None, trigrid),
            ("released torso fast", RELEASED_CONFIG, "fast", True, bg, triplane),
            ("released torso reference", RELEASED_CONFIG, "reference", True, None, triplane),
            ("released head-only fast", RELEASED_CONFIG, "fast", False, None,
             triplane - torso)):
        pipe = make_pipeline(config, preset, dev, use_torso=use_torso)
        counts = run_slice(name, pipe, src, exp, bg_img, expect, every - expect)
        # K1's launches from the released torso path at fast (the main path,
        # run, has the default model's tri-grids)
        if preset == "fast" and use_torso:
            launches[name] = counts
        del pipe
        torch.cuda.empty_cache()
    return launches


def seeded_wav(seconds: float, seed: int = 0) -> np.ndarray:
    """A 120-220 Hz chirp plus noise at 16 kHz, float32 in [-1, 1]."""
    rng = np.random.RandomState(seed)
    n = int(16000 * seconds)
    tt = np.arange(n) / 16000.0
    f = 120.0 + 100.0 * tt / seconds
    wav = 0.5 * np.sin(2 * np.pi * np.cumsum(f) / 16000.0) + 0.05 * rng.randn(n)
    return np.clip(wav, -1, 1).astype(np.float32)


def portrait_segmap(res: int) -> np.ndarray:
    """A [res,res] class map shaped like a portrait: face (3) and hair (1)
    blobs, a neck band (2), the torso (4) below, a patch of "other" (5)."""
    yy, xx = np.mgrid[:res, :res] / res
    seg = np.zeros((res, res), np.int64)
    seg[(yy - 0.4) ** 2 + (xx - 0.5) ** 2 < 0.06] = 3
    seg[((yy - 0.25) ** 2 + (xx - 0.5) ** 2 < 0.04) & (yy < 0.25)] = 1
    seg[(yy > 0.62) & (yy < 0.72) & (abs(xx - 0.5) < 0.1)] = 2
    seg[yy >= 0.72] = 4
    seg[(yy > 0.3) & (yy < 0.35) & (xx < 0.1)] = 5
    return seg


def phase_run(dev: torch.device, out_dir: str) -> dict:
    """The main path: ``Real3DPortraitPipeline()`` (the default model,
    seeded mock weights, the 35,709-vertex synthetic mesh) runs
    ``run(src, wav=<4 s>, out_path=...)`` with the JAX defaults after a
    warm-up on 0.64 s, with the launch counters from 0; it must give 100
    finite frames of 512^2 on the GPU through every default-path kernel and
    a non-empty video (or raw) file. Then the same call with stage timings
    (per-frame synchronisation), ``synthesize`` with a seeded portrait
    segmap (the head/torso split), and ``hubert_large`` on the wav."""
    from real3dportrait_tpu_torch.audio.hubert import hubert_large, make_hubert_extractor
    from real3dportrait_tpu_torch.weights import mock_init_

    pipe = make_pipeline(DEFAULT_CONFIG, "fast", dev)
    res = pipe.res
    rng = np.random.RandomState(0)
    src = rng.randint(0, 256, (res, res, 3)).astype(np.uint8)
    wav = seeded_wav(4.0)
    path = os.path.join(out_dir, "run.mp4")
    pipe.run(src, wav=seeded_wav(0.64, seed=1), out_path=os.path.join(out_dir, "warm.mp4"))
    torch.cuda.synchronize()
    every = set(read_launches())
    expect = every - {"triplane_decode"}
    reset_launches()
    t0 = time.perf_counter()
    frames = pipe.run(src, wav=wav, out_path=path)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    check(tuple(frames.shape) == (100, res, res, 3), f"run frames {tuple(frames.shape)}")
    check(frames.is_cuda and bool(torch.isfinite(frames).all()),
          "run frames must be finite and on the GPU")
    check(all(counts[k] > 0 for k in expect), f"run: a kernel was not launched: {counts}")
    check(counts["triplane_decode"] == 0, f"run: a kernel of another path ran: {counts}")
    written = {f: os.path.getsize(os.path.join(out_dir, f)) for f in os.listdir(out_dir)
               if f.startswith("run.mp4")}
    check(any(written.get(f, 0) > 0 for f in ("run.mp4", "run.mp4.raw")),
          f"run wrote no video: {written}")
    print(f"run[default, 4.0 s wav, JAX defaults]: frames {tuple(frames.shape)}, wall "
          f"{wall:.2f} s ({1e3 * wall / len(frames):.2f} ms/frame, host features, a2m, "
          f"source preparation, caches and video writing included), files {written}, "
          f"launches {counts}")
    del frames
    tm: dict = {}
    frames = pipe.run(src, wav=wav, out_path=path, timings=tm)
    torch.cuda.synchronize()
    p50 = statistics.median(tm["frame_ms"])
    stages = ", ".join(f"{k[:-3]} {tm[k]:.2f} ms" for k in (
        "features_ms", "a2m_ms", "prep_ms", "cano_ms", "appearance_ms", "bg_ms"))
    blinks = sorted(tm["frame_ms"][62:67])
    print(f"run stages (synchronised): {stages}; frame p50 {p50:.2f} ms ({1e3 / p50:.2f} fps), "
          f"blink frames 62-66 p50 {blinks[2]:.2f} ms, frame ms "
          f"{[round(x, 2) for x in tm['frame_ms'][:8]]}...")
    del frames

    seg = portrait_segmap(res)
    exp = pipe.audio_to_motion(*pipe.audio_to_features(wav[:16000]), temperature=0.2,
                               generator=torch.Generator().manual_seed(1))
    tm = {}
    frames = pipe.synthesize(src, exp, pipe.fit_source(None), segmap=seg, timings=tm)
    torch.cuda.synchronize()
    check(tuple(frames.shape) == (24, res, res, 3) and bool(torch.isfinite(frames).all()),
          f"synthesize with a segmap: frames {tuple(frames.shape)}")
    print(f"run synthesize[explicit portrait segmap, 24 frames]: prep {tm['prep_ms']:.2f} ms, "
          f"appearance {tm['appearance_ms']:.2f} ms, frame p50 "
          f"{statistics.median(tm['frame_ms']):.2f} ms")
    del frames, pipe
    torch.cuda.empty_cache()

    hub = mock_init_(hubert_large(), torch.Generator().manual_seed(2)).to(dev).eval()
    extract = make_hubert_extractor(hub)
    feats = extract(wav)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        feats = extract(wav)
    torch.cuda.synchronize()
    check(feats.shape == (199, 1024) and bool(np.isfinite(feats).all()),
          f"hubert_large features {feats.shape}")
    print(f"run hubert_large[24 x 1024, seeded weights, 4.0 s wav]: features {feats.shape}, "
          f"{(time.perf_counter() - t0) * 1e3 / 3:.2f} ms per call (host normalisation and "
          f"copies included)")
    del hub
    torch.cuda.empty_cache()
    return counts


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
    # the step takes a SECC map as input: every tri-plane, fp32 kernel but
    # the raster
    other = {"secc_raster", "trigrid_decode", "upfirdn2d bf16", "bias_act bf16"}
    check(all(v > 0 for k, v in counts.items() if k not in other),
          f"flagship: a kernel was not launched: {counts}")
    p50 = statistics.median(times)
    print(f"flagship[fast, random keypoints]: p50 {p50:.2f} ms/step ({1e3 / p50:.2f} fps) over "
          f"{steps} steps, step ms {[round(x, 2) for x in times]}, set-up {setup:.2f} s, "
          f"launches per step {({k: v // steps for k, v in counts.items()})}")


def compare(tag: str, gpu: torch.Tensor, cpu: torch.Tensor, tol: tuple = (1e-3, 1e-4)) -> None:
    """Scale-normalised GPU vs CPU check, max and mean: fp32 through ~100
    layers of random weights, convs and sums in another order, 1e-3 / 1e-4;
    through bf16 SR blocks (cuDNN's bf16 convolutions round their fp32 sums
    once, at other points than the CPU's), 3e-2 / 3e-3."""
    scale = max(float(cpu.abs().max()), 1e-6)
    err, merr = max_err(gpu.cpu(), cpu) / scale, mean_err(gpu.cpu(), cpu) / scale
    print(f"reference[{tag}]: GPU vs CPU max_err/scale {err:.3e} "
          f"mean {merr:.3e} (tol {tol[0]:g} / {tol[1]:g})")
    check(err <= tol[0] and merr <= tol[1], f"GPU {tag} disagrees with the CPU reference")


def phase_reference(dev: torch.device) -> None:
    """Small configurations on the GPU (kernels) and on the CPU (plain
    versions) from the same seed must agree: the frames of the default
    model's torso pipeline and of the released geometry's torso
    (``torso_model_scale=tiny``) and head-only pipelines, and, since random
    SR weights saturate many frame pixels at +-1, the unclamped raw render,
    depth and weight images of one frame step; for the torso models that
    step has random keypoints, and its warped torso image and occlusion are
    compared too. Then the audio path: the full-width audio-to-motion
    model, a small HuBERT and the tiny-config ``run``. The default model's
    frames and SR image pass through two bf16 blocks (3e-2 / 3e-3);
    everything before its SR head is fp32."""
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
    bf16_tol = (3e-2, 3e-3)
    for label, config, use_torso in (("default torso", DEFAULT_CONFIG, True),
                                     ("released torso", RELEASED_CONFIG, True),
                                     ("released head-only", RELEASED_CONFIG, False)):
        outs = []
        for d in (dev, torch.device("cpu")):
            pipe = make_pipeline(config, "fast", d, use_torso=use_torso, n_vertices=2000,
                                 **small)
            frames = pipe.synthesize(src, exp, pipe.fit_source(None), bg_img=bg,
                                     blink_mode="none", prepare_source_images=False)
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
        bf16 = config == DEFAULT_CONFIG
        for k, gpu in outs[0].items():
            tol = bf16_tol if bf16 and k in ("frames", "image") else (1e-3, 1e-4)
            compare(f"{label} {k}", gpu, outs[1][k], tol)

    # the audio path: the full-width audio-to-motion model on 1 s of the
    # mel tiled to 1024 channels, with the same prior noise (drawn on the
    # CPU); a 2-layer 256-wide HuBERT; the tiny-config run from 0.32 s of
    # wav (its frames through the default model's bf16 SR blocks)
    from real3dportrait_tpu_torch.audio.hubert import HubertEncoder, make_hubert_extractor
    from real3dportrait_tpu_torch.weights import mock_init_

    wav = seeded_wav(1.0, seed=3)
    outs = []
    for d in (dev, torch.device("cpu")):
        pipe = make_pipeline(DEFAULT_CONFIG, "fast", d, n_vertices=2000, **small)
        feats, f0 = pipe.audio_to_features(wav)
        exp = pipe.audio_to_motion(feats, f0, temperature=0.5,
                                   generator=torch.Generator().manual_seed(4))
        hub = mock_init_(HubertEncoder(hidden=256, layers=2, heads=4, ffn=512),
                         torch.Generator().manual_seed(5)).to(d).eval()
        hid = torch.from_numpy(make_hubert_extractor(hub)(wav))
        frames = pipe.run(src, wav=wav[:5120])
        outs.append({"audio-to-motion (full width)": exp, "HuBERT 2x256": hid,
                     "run frames": frames})
    for k, gpu in outs[0].items():
        compare(f"default {k}", gpu, outs[1][k], bf16_tol if k == "run frames" else (1e-3, 1e-4))


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

    t0 = time.perf_counter()
    phase_toolchain()
    phase_build()
    torch.cuda.synchronize()
    rows = phase_kernels(dev)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as out_dir:
        run_counts = phase_run(dev, out_dir)
    torch.cuda.synchronize()
    slice_counts = phase_slice(dev)
    torch.cuda.synchronize()
    phase_flagship(dev)
    torch.cuda.synchronize()
    phase_reference(dev)
    torch.cuda.synchronize()
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    check(set(rows) == set(REPLACES), f"kernels measured: {sorted(rows)}")
    # each kernel's launches on the main path (run); K1, which the default
    # model does not run, from the released torso slice at fast
    launches = {}
    for k in REPLACES:
        path, counts = "run", run_counts
        if counts[k] == 0:
            path, counts = "released torso fast", slice_counts["released torso fast"]
        launches[k] = dict(launches=counts[k], path=path)
        if k in BF16_COUNTED:
            launches[k]["launches_bf16"] = counts[f"{k} bf16"]
    check(all(v["launches"] > 0 for v in launches.values()), f"kernels launched: {launches}")
    kernels_json = [dict(name=k, route="cuda", source=SOURCES[k], replaces=REPLACES[k],
                         **launches[k], **rows[k]) for k in REPLACES]
    print(json.dumps({"kernels": kernels_json}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

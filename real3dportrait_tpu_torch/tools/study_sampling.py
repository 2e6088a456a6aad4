"""Quadrature accuracy of two-pass volume-render sampling schemes (port of
``tools/study_sampling.py``).

An analytic head-like radiance field (thin ellipsoid density shells and a
faint ambient density) stands in for the decoded tri-planes, so the scores
measure the sampling scheme and not a model. The ground truth is a
1024-sample stratified quadrature through the plain ray marcher; each
scheme is scored two ways:

* PSNR against that ground truth (absolute quadrature accuracy);
* PSNR against the reference scheme's own render (48 coarse + 48 fine,
  merged march): what a user of the reference algorithm would see change.

Each scheme runs through the port's own render machinery:

* merged: midpoint coarse depths, kernel K2 (``importance_sample``: the
  coarse march, the smoothing and the inverse CDF) for the fine depths,
  kernel K3 (``merge_composite``) for the merged march, then the depth clip
  to the batch's depth range, as ``render_rays`` does;
* fine-only: K2 for the fine depths, then ``march_rays`` on them alone;
* lowres/k: ``march_rays`` on every k-th ray of the grid, the weights
  upsampled bilinearly (``ops/resize.py:resize_linear``), then the
  weights-in resampler ``sample_importance`` and ``march_rays``;
* the ground truth (1024 samples, above K2's and K3's 128) through
  ``march_rays`` in four chunks of rays, as the JAX tool chunks it
  (``march_rays`` clips the depth to its own call's range).

Usage::

    python -m real3dportrait_tpu_torch.tools.study_sampling [--device cpu]

``STUDY_RES`` sets the square ray grid (default 128). ``--device`` is
``cuda`` by default and raises without a card. The output is the JAX
tool's: two header lines and one table row a scheme, in its formats.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from real3dportrait_tpu_torch import entry_device
from real3dportrait_tpu_torch.geometry.camera import (
    fov_to_intrinsics, lookat_pose, pack_camera, unpack_camera)
from real3dportrait_tpu_torch.ops.resize import resize_linear
from real3dportrait_tpu_torch.rendering import math_utils
from real3dportrait_tpu_torch.rendering import renderer as rr
from real3dportrait_tpu_torch.rendering.ray_marcher import march_rays
from real3dportrait_tpu_torch.rendering.ray_sampler import sample_rays

GT_SAMPLES = 1024
GT_CHUNKS = 4
SCHEMES = (
    ("reference 48+48 merged", dict(n_coarse=48, n_fine=48, mode="merged")),
    ("48+48 fine-only march", dict(n_coarse=48, n_fine=48, mode="fine_only")),
    ("48+64 fine-only march", dict(n_coarse=48, n_fine=64, mode="fine_only")),
    ("36+36 merged", dict(n_coarse=36, n_fine=36, mode="merged")),
    ("32+48 merged", dict(n_coarse=32, n_fine=48, mode="merged")),
    ("48+32 merged", dict(n_coarse=48, n_fine=32, mode="merged")),
    ("24+48 merged", dict(n_coarse=24, n_fine=48, mode="merged")),
    ("32+32 merged", dict(n_coarse=32, n_fine=32, mode="merged")),
    ("24+32 merged", dict(n_coarse=24, n_fine=32, mode="merged")),
    ("16+48 merged", dict(n_coarse=16, n_fine=48, mode="merged")),
    ("16+32 merged", dict(n_coarse=16, n_fine=32, mode="merged")),
    ("lowres/2 coarse 48 + 64 fine-only",
     dict(n_coarse=48, n_fine=64, mode="fine_only", coarse_downsample=2)),
    ("lowres/2 coarse 48 + 48 fine-only",
     dict(n_coarse=48, n_fine=48, mode="fine_only", coarse_downsample=2)),
    ("lowres/4 coarse 48 + 64 fine-only",
     dict(n_coarse=48, n_fine=64, mode="fine_only", coarse_downsample=4)),
)


def analytic_field(coords: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """coords [B,M,3] in the unit box -> (rgb [B,M,3] in [0,1], sigma
    [B,M,1]): a thin face shell, a thicker offset hair shell, a small sharp
    nose blob and a faint ambient density. Thin shells are the hard case
    for a quadrature: a shell missed between samples leaves the pixel
    background."""
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]

    def shell(cx, cy, cz, rx, ry, rz, width, amp):
        r = torch.sqrt(((x - cx) / rx) ** 2 + ((y - cy) / ry) ** 2 + ((z - cz) / rz) ** 2)
        return amp * torch.exp(-((r - 1.0) ** 2) / (2 * width ** 2))

    sigma = (shell(0.0, 0.03, 0.05, 0.24, 0.30, 0.26, 0.04, 90.0)      # face
             + shell(0.0, 0.12, -0.06, 0.27, 0.30, 0.28, 0.10, 25.0)   # hair
             + shell(0.0, -0.02, 0.30, 0.05, 0.05, 0.05, 0.08, 60.0)   # nose blob
             + 0.05)                                                   # ambient
    rgb = 0.5 + 0.5 * torch.stack([torch.sin(7.0 * x + 3.0 * y),
                                   torch.sin(5.0 * y - 2.0 * z + 1.0),
                                   torch.sin(6.0 * z + 4.0 * x + 2.0)], dim=-1)
    return rgb, sigma[..., None]


def eval_field(origins: torch.Tensor, dirs: torch.Tensor, depths: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """depths [B,M,S,1] -> (colours [B,M,S,3], raw densities [B,M,S,1]).

    The marcher applies softplus(sigma - 1), as to the decoder's output, so
    the analytic density goes in through its inverse: log(expm1(s)) + 1,
    and s + 1 above 20 (expm1 overflows past ~88). Both branches are
    computed at min(s, 20), so the branch not taken holds no inf."""
    b, m, s, _ = depths.shape
    coords = origins[:, :, None, :] + depths * dirs[:, :, None, :]
    rgb, sigma = analytic_field(coords.reshape(b, m * s, 3))
    sig = torch.clamp_min(sigma, 1e-6)
    sigma_pre = torch.where(sig > 20.0, sig,
                            torch.log(torch.expm1(torch.clamp_max(sig, 20.0)))) + 1.0
    return rgb.reshape(b, m, s, 3), sigma_pre.reshape(b, m, s, 1)


def render_two_pass(origins, dirs, ray_start, ray_end, n_coarse: int, n_fine: int,
                    mode: str = "merged", coarse_downsample: int = 1, res: int = 128
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One scheme over the analytic field -> (rgb [B,M,3] in [-1,1],
    depth [B,M,1]).

    ``mode``: "merged" (the reference: the march over the union of coarse
    and fine samples) or "fine_only" (the march over the fine samples
    alone). ``coarse_downsample`` k > 1 runs the proposal pass on every
    k-th ray of the row-major res x res grid and upsamples its weights
    bilinearly to the full grid before the fine depths are drawn."""
    b, m, _ = origins.shape
    ds = coarse_downsample
    if ds > 1:
        def grid(t):
            return t.reshape(b, res, res, -1)[:, ::ds, ::ds].reshape(b, -1, t.shape[-1])

        o_lo, d_lo, rs_lo, re_lo = map(grid, (origins, dirs, ray_start, ray_end))
        depths_lo = rr._stratified_depths(rs_lo, re_lo, n_coarse)
        c_lo, s_lo = eval_field(o_lo, d_lo, depths_lo)
        _, _, w_lo = march_rays(c_lo, s_lo, depths_lo)
        r_lo = res // ds
        w_up = resize_linear(w_lo.reshape(b, r_lo, r_lo, n_coarse - 1), res, res)
        weights = w_up.reshape(b, m, n_coarse - 1, 1)
        depths_coarse = rr._stratified_depths(ray_start, ray_end, n_coarse)
        fine = rr.sample_importance(depths_coarse, weights, n_fine)
        colors_f, dens_f = eval_field(origins, dirs, fine)
        rgb, depth, _ = march_rays(colors_f, dens_f, fine)
        return rgb, depth

    depths_coarse = rr._stratified_depths(ray_start, ray_end, n_coarse)
    colors_c, dens_c = eval_field(origins, dirs, depths_coarse)
    fine = rr.importance_sample(depths_coarse, dens_c, rr.importance_u(b * m, n_fine,
                                                                       origins.device))
    colors_f, dens_f = eval_field(origins, dirs, fine)
    if mode == "fine_only":
        rgb, depth, _ = march_rays(colors_f, dens_f, fine)
        return rgb, depth
    rgb, depth, _ = rr.merge_composite(depths_coarse, colors_c, dens_c, fine, colors_f, dens_f)
    # the clip to the batch's merged depth range that K3 leaves to its caller
    lo = torch.minimum(depths_coarse.min(), fine.min())
    hi = torch.maximum(depths_coarse.max(), fine.max())
    return rgb, torch.clamp(torch.nan_to_num(depth, nan=float("inf")), lo, hi)


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    """PSNR of images in [-1, 1] (peak 2), the MSE floored at 1e-12."""
    mse = float(torch.mean((a - b) ** 2))
    return 10.0 * np.log10(4.0 / max(mse, 1e-12))


def study_rays(res: int, device: torch.device):
    """The frontal camera's res x res rays and box limits; a ray that
    misses the box takes [min, max] of the valid rays' *starts*, as the
    JAX tool sets them -> (origins, dirs, ray_start, ray_end)."""
    zero = torch.zeros((1,), device=device)
    cam = pack_camera(lookat_pose(zero, zero, torch.zeros((1, 3), device=device)),
                      fov_to_intrinsics(device=device))
    origins, dirs = sample_rays(*unpack_camera(cam), res)
    ray_start, ray_end, is_valid = math_utils.get_ray_limits_box(origins, dirs, 1.0)
    valid = is_valid[..., None]
    smin = torch.where(valid, ray_start, torch.full_like(ray_start, 1e10)).min()
    smax = torch.where(valid, ray_start, torch.full_like(ray_start, -1e10)).max()
    return (origins, dirs, torch.where(valid, ray_start, smin),
            torch.where(valid, ray_end, smax))


def ground_truth(origins, dirs, ray_start, ray_end) -> tuple[torch.Tensor, torch.Tensor]:
    """The 1024-sample midpoint quadrature in GT_CHUNKS chunks of rays ->
    (rgb [B,M,3], depth [B,M,1])."""
    step = origins.shape[1] // GT_CHUNKS
    rgbs, depths = [], []
    for i in range(GT_CHUNKS):
        sl = slice(i * step, (i + 1) * step)
        dpt = rr._stratified_depths(ray_start[:, sl], ray_end[:, sl], GT_SAMPLES)
        c, s = eval_field(origins[:, sl], dirs[:, sl], dpt)
        rgb, dep, _ = march_rays(c, s, dpt)
        rgbs.append(rgb)
        depths.append(dep)
    return torch.cat(rgbs, 1), torch.cat(depths, 1)


def study(res: int, device: torch.device | str = "cuda", keep: bool = False,
          log=print) -> list[dict]:
    """Every scheme of ``SCHEMES`` at res^2 -> one dict a scheme, in order:
    ``name``, ``rows`` (proposal rows a full-resolution ray plus fine
    samples), ``psnr_gt``, ``psnr_ref`` (inf for the reference), ``depth_mae``
    against the ground truth; with ``keep`` also its ``rgb`` and ``depth``.
    ``log`` receives the JAX tool's lines (the ground-truth line, the
    table's header, a row a scheme)."""
    dev = entry_device(device)
    rays = study_rays(res, dev)
    with torch.no_grad():
        gt_rgb, gt_depth = ground_truth(*rays)
        log(f"GT: {GT_SAMPLES}-sample render at {res}^2 done")
        log(f"{'scheme':40s} {'rows/ray':>8s} {'PSNR->GT':>9s} {'PSNR->ref':>9s} "
            f"{'depth MAE':>9s}")
        out, ref_rgb = [], None
        for name, kw in SCHEMES:
            rgb, depth = render_two_pass(*rays, res=res, **kw)
            ds = kw.get("coarse_downsample", 1)
            row = dict(name=name, rows=kw["n_coarse"] / (ds * ds) + kw["n_fine"],
                       psnr_gt=psnr(rgb, gt_rgb),
                       psnr_ref=psnr(rgb, ref_rgb) if ref_rgb is not None else float("inf"),
                       depth_mae=float(torch.mean(torch.abs(depth - gt_depth))))
            if ref_rgb is None:
                ref_rgb = rgb
            if keep:
                row.update(rgb=rgb, depth=depth)
            log(f"{name:40s} {row['rows']:8.1f} {row['psnr_gt']:9.2f} "
                f"{row['psnr_ref']:9.2f} {row['depth_mae']:9.4f}")
            out.append(row)
    return out


def main(argv=None) -> int:
    import argparse

    from real3dportrait_tpu_torch.utils.precision import set_fp32_policy

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    set_fp32_policy()
    study(int(os.environ.get("STUDY_RES", "128")), args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

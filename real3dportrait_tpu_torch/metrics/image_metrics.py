"""Per-image quality metrics (port of
``real3dportrait_tpu/metrics/image_metrics.py``): PSNR, SSIM and the
perceptual distance of validation logging and the parity tool. Images are
NHWC tensors, computed on their own device; value ranges are declared per
call through ``data_range``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from real3dportrait_tpu_torch.ops.resize import resize_linear


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 2.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB (default range 2.0 for [-1,1] images) [B]."""
    mse = (pred - target).square().mean(dim=(-3, -2, -1))
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 2.0,
         kernel_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Structural similarity (gaussian window, per image) [B]: JAX's
    depthwise ``VALID`` filter, ``F.conv2d(groups=C)`` with no padding."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    c = pred.shape[-1]
    kern = _gaussian_kernel(kernel_size, sigma, pred.device).to(pred.dtype)
    kern = kern.expand(c, 1, kernel_size, kernel_size)

    def filt(x):
        return F.conv2d(x, kern, groups=c)

    p, t = pred.permute(0, 3, 1, 2), target.permute(0, 3, 1, 2)
    mu_p, mu_t = filt(p), filt(t)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    sigma_p = filt(p * p) - mu_pp
    sigma_t = filt(t * t) - mu_tt
    sigma_pt = filt(p * t) - mu_pt
    ssim_map = ((2 * mu_pt + c1) * (2 * sigma_pt + c2)) / (
        (mu_pp + mu_tt + c1) * (sigma_p + sigma_t + c2))
    return ssim_map.mean(dim=(-3, -2, -1))


def lpips_surrogate(pred: torch.Tensor, target: torch.Tensor, levels: int = 4) -> torch.Tensor:
    """Multi-scale structural distance, a pretrained-free LPIPS stand-in:
    (1 - SSIM) / 2 averaged over a dyadic pyramid, halved by
    :func:`resize_linear` (antialiased, as ``jax.image.resize`` shrinks)
    while both sides are at least 12 pixels."""
    total = torch.zeros(pred.shape[0], device=pred.device, dtype=pred.dtype)
    n = 0
    for _ in range(levels):
        if min(pred.shape[1], pred.shape[2]) < 12:
            break
        total = total + (1.0 - ssim(pred, target)) / 2.0
        n += 1
        h, w = pred.shape[1] // 2, pred.shape[2] // 2
        pred, target = resize_linear(pred, h, w), resize_linear(target, h, w)
    return total / max(n, 1)


def lpips(pred: torch.Tensor, target: torch.Tensor, cfg=None, device=None) -> torch.Tensor:
    """Real LPIPS(net='vgg') where ``cfg['lpips_vgg_ckpt']`` names a
    ``convert_lpips_vgg`` tree, else the pyramid surrogate, as
    :func:`lpips_kind` says. [B,H,W,3] in [-1,1] -> [B]; the weights go to
    ``device`` (``pred``'s by default)."""
    from real3dportrait_tpu_torch.models.perceptual import make_lpips_fn

    fn = make_lpips_fn(cfg or {}, pred.device if device is None else device)
    if fn is not None:
        return fn(pred, target)
    return lpips_surrogate(pred, target)


def lpips_kind(cfg=None, device="cpu") -> str:
    """"lpips_vgg" where real weights are wired, else "surrogate"; callers
    record it next to any LPIPS number they report."""
    from real3dportrait_tpu_torch.models.perceptual import make_lpips_fn

    return "lpips_vgg" if make_lpips_fn(cfg or {}, device) is not None else "surrogate"

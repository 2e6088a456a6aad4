"""PyTorch port of ``real3dportrait_tpu.metrics``: image metrics (PSNR,
SSIM, LPIPS) and the GAN metric suite (FID, KID, IS, precision-recall,
PPL) with its Inception and random-projection extractors."""

from real3dportrait_tpu_torch.metrics.gan_metrics import (
    calc_metric,
    frechet_distance,
    inception_score,
    kernel_distance,
    list_metrics,
    register_metric,
)
from real3dportrait_tpu_torch.metrics.image_metrics import (
    lpips, lpips_kind, lpips_surrogate, psnr, ssim,
)

__all__ = [
    "psnr",
    "ssim",
    "lpips_surrogate",
    "lpips",
    "lpips_kind",
    "calc_metric",
    "frechet_distance",
    "kernel_distance",
    "inception_score",
    "register_metric",
    "list_metrics",
]

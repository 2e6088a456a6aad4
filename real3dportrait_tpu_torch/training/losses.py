"""Loss library (port of ``real3dportrait_tpu/training/losses.py``): the
reference's loss-dict x weight-dict pattern as plain functions of tensors.
Images are NHWC, as in the JAX package."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from real3dportrait_tpu_torch.ops.resize import resize_linear

# --- reconstruction ---------------------------------------------------------


def masked_mse(pred, target, mask=None):
    """Mean squared error over masked elements; ``mask`` broadcasts."""
    err = (pred - target).square()
    if mask is None:
        return err.mean()
    mask = torch.broadcast_to(mask, err.shape)
    return (err * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def masked_l1(pred, target, mask=None, clamp_quantile: float | None = None):
    """L1 with optional per-image error clamping at a quantile, so that
    outliers (hair wisps) do not dominate."""
    err = (pred - target).abs()
    if clamp_quantile is not None:
        q = torch.quantile(err.reshape(err.shape[0], -1), clamp_quantile, dim=1)
        err = torch.minimum(err, q.reshape((-1,) + (1,) * (err.dim() - 1)))
    if mask is None:
        return err.mean()
    mask = torch.broadcast_to(mask, err.shape)
    return (err * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def temporal_laplacian(x, mask=None):
    """Second-difference smoothness along T: x [B,T,C]; penalises
    |x[t-1] - 2 x[t] + x[t+1]|^2 (the audio-to-motion task's)."""
    err = (x[:, :-2] - 2 * x[:, 1:-1] + x[:, 2:]).square()
    if mask is None:
        return err.mean()
    m = torch.broadcast_to(mask[:, 1:-1, None], err.shape)
    return (err * m).sum() / torch.clamp(m.sum(), min=1.0)


# mediapipe-468 landmark index sets of the reference's weighting: topology
# facts of the mediapipe face mesh
_MP468_UNMATCHED = (93, 127, 132, 234, 323, 356, 361, 454)
_MP468_UPPER_EYE = (161, 160, 159, 158, 157, 388, 387, 386, 385, 384)
_MP468_EYE = (33, 246, 161, 160, 159, 158, 157, 173, 133, 155, 154, 153,
              145, 144, 163, 7, 263, 466, 388, 387, 386, 385, 384, 398,
              362, 382, 381, 380, 374, 373, 390, 249)
_MP468_INNER_LIP = (78, 191, 80, 81, 82, 13, 312, 311, 310, 415, 308, 324,
                    318, 402, 317, 14, 87, 178, 88, 95)
_MP468_OUTER_LIP = (61, 185, 40, 39, 37, 0, 267, 269, 270, 409, 291, 375,
                    321, 405, 314, 17, 84, 181, 91, 146)


def weighted_lm3d_mse(pred_lm, gt_lm, mask=None, eye_weight=3.0, lip_weight=5.0,
                      n_landmarks=68):
    """Landmark MSE with eye and mouth up-weighting; [B,T,N,3]."""
    weights = torch.ones((n_landmarks,), device=pred_lm.device)
    if n_landmarks == 68:
        weights[17:48], weights[48:68] = eye_weight, lip_weight
    elif n_landmarks == 468:
        for idx, val in ((_MP468_EYE, eye_weight), (_MP468_UPPER_EYE, 20.0),
                         (_MP468_INNER_LIP, lip_weight), (_MP468_OUTER_LIP, lip_weight),
                         (_MP468_UNMATCHED, 0.0)):
            weights[list(idx)] = val
    err = (pred_lm - gt_lm).square() * weights[None, None, :, None]
    if mask is None:
        return err.mean()
    m = torch.broadcast_to(mask[:, :, None, None], err.shape)
    return (err * m).sum() / torch.clamp(m.sum(), min=1.0)


def kl_annealing_weight(step: int, lambda_kl: float, t1: int, t2: int) -> float:
    """Cyclic KL annealing: ramp 0 -> 1 over t1 steps, hold for t2, repeat."""
    phase = np.float32(step) % np.float32(t1 + t2)
    return float(np.float32(lambda_kl) * np.clip(phase / np.float32(t1), 0.0, 1.0))


# --- GAN --------------------------------------------------------------------


def g_nonsaturating_loss(fake_logits):
    return F.softplus(-fake_logits).mean()


def d_logistic_loss(real_logits, fake_logits):
    return F.softplus(fake_logits).mean() + F.softplus(-real_logits).mean()


def r1_penalty(disc_fn, image, image_raw, camera):
    """R1 gradient penalty with respect to both real images: the gradients
    come from ``torch.autograd.grad(..., create_graph=True)``, so the
    penalty is differentiable in the discriminator's parameters (the
    double backward through kernels K6a and K6b on the card)."""
    image = image.detach().requires_grad_(True)
    image_raw = image_raw.detach().requires_grad_(True)
    score = disc_fn(image, image_raw, camera).sum()
    g_img, g_raw = torch.autograd.grad(score, (image, image_raw), create_graph=True)
    pen = g_img.square().sum(dim=(1, 2, 3)) + g_raw.square().sum(dim=(1, 2, 3))
    return pen.mean()


def density_regularization(sample_fn, draws, device, box_warp: float = 1.0,
                           n_points: int = 1000, p_dist: float = 0.004):
    """EG3D density TV regularisation: sigma at random points should match
    sigma at slightly perturbed points. ``sample_fn(coords) -> {'sigma'}``;
    the points and the perturbation come from ``draws``."""
    pts = draws.uniform((1, n_points, 3), device, -0.5, 0.5) * box_warp
    perturbed = pts + draws.normal(tuple(pts.shape), device) * p_dist
    sigma = sample_fn(pts)["sigma"]
    sigma_p = sample_fn(perturbed)["sigma"]
    return (sigma - sigma_p).abs().mean()


# --- rendering-weights regularisers ----------------------------------------


def weights_entropy_loss(weights_img):
    """Push the NeRF alpha image towards binary values."""
    a = torch.clamp(weights_img, 1e-5, 1 - 1e-5)
    return (-a * torch.log2(a) - (1 - a) * torch.log2(1 - a)).mean()


def weights_mask_match_loss(weights_img, head_mask):
    """L1 between the alpha image and the head segmentation."""
    return (weights_img - head_mask).abs().mean()


# --- lip-rect crops ----------------------------------------------------------


def lip_rect_centers(lm2d_px: torch.Tensor) -> torch.Tensor:
    """Mouth-rect centres from posed landmarks in pixels: the bbox centre of
    the outer-lip ring (landmarks 48:60). [B,68,2] (x,y) -> [B,2] (y,x)
    int32."""
    lips = lm2d_px[:, 48:60, :]
    cxy = (lips.amin(dim=1) + lips.amax(dim=1)) * 0.5
    return torch.stack([cxy[:, 1], cxy[:, 0]], dim=-1).to(torch.int32)


def crop_fixed_rect(img: torch.Tensor, centers: torch.Tensor, size: int) -> torch.Tensor:
    """[B,H,W,C] and centres [B,2] (y,x) -> [B,size,size,C] crops of a fixed
    size, each clamped inside the image. The offsets are gathered on the
    device (no host read of ``centers``)."""
    b, h, w, c = img.shape
    centers = centers.to(img.device).long()
    y = torch.clamp(centers[:, 0] - size // 2, 0, h - size)
    x = torch.clamp(centers[:, 1] - size // 2, 0, w - size)
    ar = torch.arange(size, device=img.device)
    rows = (y[:, None] + ar)[:, :, None].expand(b, size, size)
    cols = (x[:, None] + ar)[:, None, :].expand(b, size, size)
    bi = torch.arange(b, device=img.device)[:, None, None].expand(b, size, size)
    return img[bi, rows, cols]


def lip_crop_losses(pred, target, centers, size: int, perceptual_fn=None):
    """Mouth-crop L1 and perceptual pair."""
    lip_pred = crop_fixed_rect(pred, centers, size)
    lip_tgt = crop_fixed_rect(target, centers, size)
    mae = (lip_pred - lip_tgt).abs().mean()
    if perceptual_fn is None:
        perceptual_fn = laplacian_pyramid_loss
    return mae, perceptual_fn(lip_pred, lip_tgt)


# --- perceptual --------------------------------------------------------------


def laplacian_pyramid_loss(pred, target, levels: int = 3):
    """Multi-scale L1 (Laplacian pyramid) perceptual surrogate, the
    criterion ``models/perceptual.make_perceptual_fn`` picks without VGG19
    weights."""
    loss = 0.0
    for _ in range(levels):
        loss = loss + (pred - target).abs().mean()
        if min(pred.shape[1], pred.shape[2]) <= 8:
            break
        h, w = pred.shape[1] // 2, pred.shape[2] // 2
        pd, td = resize_linear(pred, h, w), resize_linear(target, h, w)
        up_p = resize_linear(pd, pred.shape[1], pred.shape[2])
        up_t = resize_linear(td, target.shape[1], target.shape[2])
        loss = loss + ((pred - up_p) - (target - up_t)).abs().mean()
        pred, target = pd, td
    return loss / levels


def weighted_loss_sum(losses: dict, weights: dict):
    """total = sum(losses[k] * weights[k]) over the keys with a non-zero
    weight."""
    total = 0.0
    for k, v in losses.items():
        w = weights.get(k, None)
        if w is None or w == 0:
            continue
        total = total + v * w
    return total

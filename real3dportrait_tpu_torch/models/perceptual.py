"""Perceptual criteria (port of ``real3dportrait_tpu/models/perceptual.py``):
the five-tap VGG19 L1 (relu1_1 .. relu5_1, layer weights 1/32 .. 1) with
frozen, loadable weights, and :func:`make_perceptual_fn`, which picks it
when ``cfg['vgg19_ckpt']`` holds converted weights and the Laplacian-pyramid
surrogate (``training/losses.laplacian_pyramid_loss``) otherwise. The
weights are data, never parameters: they enter no optimiser or checkpoint.
The dual VGG19 + VGGFace criterion (``lpips_mode: vgg19_v2`` with a
``vggface_ckpt``) is not ported.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from real3dportrait_tpu_torch.training.losses import laplacian_pyramid_loss

# torchvision vgg19 ``features`` indices of the convs up to conv5_1, widths,
# and whether the relu after it is a tap
VGG19_CONVS = ((0, 64, True), (2, 64, False), (5, 128, True), (7, 128, False),
               (10, 256, True), (12, 256, False), (14, 256, False), (16, 256, False),
               (19, 512, True), (21, 512, False), (23, 512, False), (25, 512, False),
               (28, 512, True))
VGG19_POOL_BEFORE = (5, 10, 19, 28)
LAYER_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def vgg19_weights(tree: dict, device) -> dict:
    """The JAX package's VGG19 tree (``conv<idx>``: HWIO ``kernel``,
    ``bias``) -> {idx: (OIHW weight, bias)} fp32 tensors on ``device``."""
    out = {}
    for idx, _, _ in VGG19_CONVS:
        p = tree[f"conv{idx}"]
        w = torch.as_tensor(np.asarray(p["kernel"], np.float32)).permute(3, 2, 0, 1)
        out[idx] = (w.contiguous().to(device),
                    torch.as_tensor(np.asarray(p["bias"], np.float32)).to(device))
    return out


def vgg19_features(weights: dict, x: torch.Tensor) -> list[torch.Tensor]:
    """x [B,H,W,3] in [-1,1] -> the five tap activations (NCHW)."""
    mean = torch.tensor(_MEAN, device=x.device)
    std = torch.tensor(_STD, device=x.device)
    x = (((x + 1.0) * 0.5 - mean) / std).permute(0, 3, 1, 2)
    taps = []
    for idx, _, tap in VGG19_CONVS:
        if idx in VGG19_POOL_BEFORE:
            x = F.max_pool2d(x, 2, 2)
        w, b = weights[idx]
        x = F.relu(F.conv2d(x, w, b, padding=1))
        if tap:
            taps.append(x)
    return taps


def vgg19_perceptual(weights: dict, pred: torch.Tensor, target: torch.Tensor,
                     max_size: int = 1024) -> torch.Tensor:
    """Weighted five-tap L1 feature distance; the target's features take no
    gradient."""
    from real3dportrait_tpu_torch.training.losses import _resize

    while pred.shape[1] > max_size:
        h, w = pred.shape[1] // 2, pred.shape[2] // 2
        pred, target = _resize(pred, h, w), _resize(target, h, w)
    f_pred = vgg19_features(weights, pred)
    f_tgt = vgg19_features(weights, target.detach())
    loss = 0.0
    for w_i, fp, ft in zip(LAYER_WEIGHTS, f_pred, f_tgt):
        loss = loss + w_i * (fp - ft).abs().mean()
    return loss


def load_vgg19_tree(path: str) -> dict | None:
    """The converted VGG19 tree (``tools/convert_torch_ckpt.convert_vgg19``,
    msgpack), or None where ``path`` is empty or missing."""
    if not path or not os.path.exists(path):
        return None
    from real3dportrait_tpu_torch.utils.msgpack_ckpt import load_checkpoint

    tree = load_checkpoint(path)
    for idx, out_ch, _ in VGG19_CONVS:
        k = tree.get(f"conv{idx}", {}).get("kernel")
        if k is None or k.shape[-1] != out_ch:
            raise ValueError(f"bad VGG19 weight tree at conv{idx} in {path}")
    return tree


def make_perceptual_fn(cfg, device="cpu") -> tuple:
    """``(fn(pred, target) -> scalar, kind)``: ``"vgg19"`` when
    ``cfg['vgg19_ckpt']`` holds converted weights, else ``"pyramid"``.
    Raises where the JAX package would pick the dual VGG19 + VGGFace
    criterion, which is not ported."""
    tree = load_vgg19_tree(str(cfg.get("vgg19_ckpt", "") or ""))
    if tree is None:
        return (lambda p, t: laplacian_pyramid_loss(p, t)), "pyramid"
    face = str(cfg.get("vggface_ckpt", "") or "")
    if str(cfg.get("lpips_mode", "vgg19_v2")) == "vgg19_v2" and face and os.path.exists(face):
        raise NotImplementedError("make_perceptual_fn: the vgg19_v2 criterion (VGG19 + "
                                  "VGGFace) is not ported")
    weights = vgg19_weights(tree, device)
    return (lambda p, t: vgg19_perceptual(weights, p, t)), "vgg19"

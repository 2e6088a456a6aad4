"""Perceptual criteria (port of ``real3dportrait_tpu/models/perceptual.py``),
with frozen, loadable weights that enter no optimiser or checkpoint:

* ``"vgg19"``: the five-tap VGG19 L1 (relu1_1 .. relu5_1, layer weights
  1/32 .. 1);
* ``"vgg19_v2"``, the released configs' ``lpips_mode``: the dual
  VGG19 + VGGFace :func:`perceptual_v2`;
* ``"pyramid"``: the Laplacian-pyramid surrogate
  (``training/losses.laplacian_pyramid_loss``) where no weights are given;

and the LPIPS(net='vgg') evaluation metric, :func:`lpips_vgg` on a
``convert_lpips_vgg`` tree (:func:`make_lpips_fn`).

:func:`make_perceptual_fn` picks one from the config as the JAX package
does. The convs are cuDNN's (``F.conv2d``); JAX computes them outside any
kernel. The weight trees are the JAX package's (``conv<idx>``: HWIO
``kernel``, ``bias``); :func:`init_vgg19_params` and
:func:`init_vggface_params` draw the same seeded trees as its twins.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from real3dportrait_tpu_torch.ops.resize import resize_linear
from real3dportrait_tpu_torch.training.losses import laplacian_pyramid_loss

# torchvision vgg19 ``features`` indices of the convs up to conv5_1, widths,
# and whether the relu after it is a tap
VGG19_CONVS = ((0, 64, True), (2, 64, False), (5, 128, True), (7, 128, False),
               (10, 256, True), (12, 256, False), (14, 256, False), (16, 256, False),
               (19, 512, True), (21, 512, False), (23, 512, False), (25, 512, False),
               (28, 512, True))
VGG19_POOL_BEFORE = (5, 10, 19, 28)
# torchvision vgg16 ``features`` convs up to conv5_1 of VGGFace, taps at
# relu_1_1 .. relu_5_1
VGGFACE_CONVS = ((0, 64, True), (2, 64, False), (5, 128, True), (7, 128, False),
                 (10, 256, True), (12, 256, False), (14, 256, False), (17, 512, True),
                 (19, 512, False), (21, 512, False), (24, 512, True))
VGGFACE_POOL_BEFORE = (5, 10, 17, 24)
LAYER_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)
# VGGFace's input: x in [0,1] -> x * 255 - mean, std 1
_VGGFACE_MEAN = (129.186279296875, 104.76238250732422, 93.59396362304688)


def _he_tree(convs: tuple, rng: np.random.RandomState) -> dict:
    params, in_ch = {}, 3
    for idx, out_ch, _ in convs:
        fan_in = 3 * 3 * in_ch
        params[f"conv{idx}"] = {
            "kernel": (rng.randn(3, 3, in_ch, out_ch) * np.sqrt(2.0 / fan_in)).astype(
                np.float32),
            "bias": np.zeros((out_ch,), np.float32)}
        in_ch = out_ch
    return params


def init_vgg19_params(rng: np.random.RandomState | None = None) -> dict:
    """He-initialised VGG19 feature tree (HWIO kernels), for tests and runs
    without pretrained weights."""
    return _he_tree(VGG19_CONVS, rng or np.random.RandomState(0))


def init_vggface_params(rng: np.random.RandomState | None = None) -> dict:
    """He-initialised VGGFace feature tree (HWIO kernels)."""
    return _he_tree(VGGFACE_CONVS, rng or np.random.RandomState(1))


def conv_weights(tree: dict, device, convs: tuple = VGG19_CONVS) -> dict:
    """A JAX package tree (``conv<idx>``: HWIO ``kernel``, ``bias``) ->
    {idx: (OIHW weight, bias)} fp32 tensors on ``device``."""
    out = {}
    for idx, _, _ in convs:
        p = tree[f"conv{idx}"]
        w = torch.as_tensor(np.asarray(p["kernel"], np.float32)).permute(3, 2, 0, 1)
        out[idx] = (w.contiguous().to(device),
                    torch.as_tensor(np.asarray(p["bias"], np.float32)).to(device))
    return out


def _conv_stack(weights: dict, x: torch.Tensor, convs: tuple, pool_before: tuple) -> list:
    """NCHW ``x`` through 3x3 SAME convs + relu (2x2 max pools before the
    ``pool_before`` indices) -> the tap activations."""
    taps = []
    for idx, _, tap in convs:
        if idx in pool_before:
            x = F.max_pool2d(x, 2, 2)
        w, b = weights[idx]
        x = F.relu(F.conv2d(x, w, b, padding=1))
        if tap:
            taps.append(x)
    return taps


def _vgg19_features01(weights: dict, x01: torch.Tensor) -> list[torch.Tensor]:
    """x01 [B,H,W,3] in [0,1] -> the five VGG19 taps (NCHW)."""
    mean = torch.tensor(_MEAN, device=x01.device)
    std = torch.tensor(_STD, device=x01.device)
    x = ((x01 - mean) / std).permute(0, 3, 1, 2)
    return _conv_stack(weights, x, VGG19_CONVS, VGG19_POOL_BEFORE)


def vgg19_features(weights: dict, x: torch.Tensor) -> list[torch.Tensor]:
    """x [B,H,W,3] in [-1,1] -> the five VGG19 taps (NCHW)."""
    return _vgg19_features01(weights, (x + 1.0) * 0.5)


def vggface_features(weights: dict, x01: torch.Tensor) -> list[torch.Tensor]:
    """x01 [B,H,W,3] in [0,1] -> the five VGGFace taps (NCHW)."""
    x = (x01 * 255.0 - torch.tensor(_VGGFACE_MEAN, device=x01.device)).permute(0, 3, 1, 2)
    return _conv_stack(weights, x, VGGFACE_CONVS, VGGFACE_POOL_BEFORE)


def vgg19_perceptual(weights: dict, pred: torch.Tensor, target: torch.Tensor,
                     max_size: int = 1024) -> torch.Tensor:
    """Weighted five-tap L1 feature distance; the target's features take no
    gradient."""
    while pred.shape[1] > max_size:
        h, w = pred.shape[1] // 2, pred.shape[2] // 2
        pred, target = resize_linear(pred, h, w), resize_linear(target, h, w)
    f_pred = vgg19_features(weights, pred)
    f_tgt = vgg19_features(weights, target.detach())
    loss = 0.0
    for w_i, fp, ft in zip(LAYER_WEIGHTS, f_pred, f_tgt):
        loss = loss + w_i * (fp - ft).abs().mean()
    return loss


def _halve(x: torch.Tensor) -> torch.Tensor:
    """NHWC bilinear halving without antialias (``F.interpolate``'s
    ``scale_factor=0.5`` default)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(x.shape[1] // 2, x.shape[2] // 2),
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


def _nan_to_zero(v: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(v), torch.zeros_like(v), v)


def perceptual_v2(vgg19_w: dict, vggface_w: dict, pred: torch.Tensor, target: torch.Tensor,
                  n_scale: int = 3) -> torch.Tensor:
    """The released criterion (``lpips_mode: vgg19_v2``): [B,H,W,3] images
    in [-1,1] taken to [0,1] and resized to 512^2 (antialiased); L1 over the
    five taps of VGGFace (its term / 255) and of VGG19, then ``n_scale``
    halvings without antialias where the VGG19 relu5_1 tap alone is
    compared (weight 1). Each term's NaN counts as zero; the target's
    features take no gradient."""
    pred01 = (pred + 1.0) * 0.5
    tgt01 = ((target + 1.0) * 0.5).detach()
    if pred01.shape[1] != 512:
        pred01, tgt01 = resize_linear(pred01, 512, 512), resize_linear(tgt01, 512, 512)
    loss = 0.0
    f_pred, f_tgt = vggface_features(vggface_w, pred01), vggface_features(vggface_w, tgt01)
    for w_i, fp, ft in zip(LAYER_WEIGHTS, f_pred, f_tgt):
        loss = loss + _nan_to_zero(w_i * (fp - ft).abs().mean() / 255.0)
    g_pred, g_tgt = _vgg19_features01(vgg19_w, pred01), _vgg19_features01(vgg19_w, tgt01)
    for w_i, fp, ft in zip(LAYER_WEIGHTS, g_pred, g_tgt):
        loss = loss + _nan_to_zero(w_i * (fp - ft).abs().mean())
    x, y = pred01, tgt01
    for _ in range(n_scale):
        x, y = _halve(x), _halve(y)
        fp = _vgg19_features01(vgg19_w, x)[-1]
        ft = _vgg19_features01(vgg19_w, y)[-1]
        loss = loss + _nan_to_zero((fp - ft).abs().mean())
    return loss


def load_tree(path: str, convs: tuple = VGG19_CONVS) -> dict | None:
    """A converted feature tree (msgpack; the port's
    ``tools/convert_torch_ckpt.py:save_vgg19``),
    or None where ``path`` is empty or missing; raises where a conv of
    ``convs`` is absent or of another width."""
    if not path or not os.path.exists(path):
        return None
    from real3dportrait_tpu_torch.utils.msgpack_ckpt import load_checkpoint

    tree = load_checkpoint(path)
    for idx, out_ch, _ in convs:
        k = tree.get(f"conv{idx}", {}).get("kernel")
        if k is None or k.shape[-1] != out_ch:
            raise ValueError(f"bad weight tree at conv{idx} in {path}")
    return tree


def load_vgg19_params(path: str) -> dict | None:
    """The JAX package's name for :func:`load_tree` on a VGG19 tree."""
    return load_tree(path, VGG19_CONVS)


def make_perceptual_fn(cfg, device="cpu") -> tuple:
    """``(fn(pred, target) -> scalar, kind)``: ``"vgg19_v2"`` where
    ``lpips_mode`` is ``vgg19_v2`` (the default) and both
    ``cfg['vgg19_ckpt']`` and ``cfg['vggface_ckpt']`` hold trees;
    ``"vgg19"`` where only the VGG19 tree is there or the mode is another;
    ``"pyramid"`` without VGG19 weights."""
    tree = load_tree(str(cfg.get("vgg19_ckpt", "") or ""))
    if tree is None:
        return (lambda p, t: laplacian_pyramid_loss(p, t)), "pyramid"
    weights = conv_weights(tree, device)
    if str(cfg.get("lpips_mode", "vgg19_v2")) == "vgg19_v2":
        face = load_tree(str(cfg.get("vggface_ckpt", "") or ""), VGGFACE_CONVS)
        if face is not None:
            face_w = conv_weights(face, device, VGGFACE_CONVS)
            return (lambda p, t: perceptual_v2(weights, face_w, p, t)), "vgg19_v2"
    return (lambda p, t: vgg19_perceptual(weights, p, t)), "vgg19"


# ---------------------------------------------------------------------------
# lpips-package LPIPS(net='vgg'), the standard evaluation metric
# ---------------------------------------------------------------------------
# lpips/lpips.py, LPIPS(net='vgg', lpips=True): the scaling layer, then
# torchvision vgg16 features tapped at relu1_2/2_2/3_3/4_3/5_3, each tap
# unit-normalised over its channels, squared differences, the learned 1x1
# "lin" weights (C -> 1, no bias), the spatial mean, the sum over taps.

LPIPS_VGG16_CONVS = (
    (0, 64, False),
    (2, 64, True),     # relu1_2 (tap 0)
    (5, 128, False),
    (7, 128, True),    # relu2_2
    (10, 256, False),
    (12, 256, False),
    (14, 256, True),   # relu3_3
    (17, 512, False),
    (19, 512, False),
    (21, 512, True),   # relu4_3
    (24, 512, False),
    (26, 512, False),
    (28, 512, True),   # relu5_3
)
LPIPS_POOL_BEFORE = (5, 10, 17, 24)
# the lpips ScalingLayer's shift and scale buffers
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)


def init_lpips_params(rng: np.random.RandomState | None = None) -> dict:
    """Seeded LPIPS-vgg tree (``conv<i>``: HWIO ``kernel``, ``bias``;
    ``lin<k>``: ``kernel`` [C,1]), the JAX package's arrays from the same
    ``RandomState`` (2 by default)."""
    rng = rng or np.random.RandomState(2)
    params = {}
    in_ch = 3
    lin_ch = []
    for idx, out_ch, tap in LPIPS_VGG16_CONVS:
        fan_in = 3 * 3 * in_ch
        params[f"conv{idx}"] = {
            "kernel": (rng.randn(3, 3, in_ch, out_ch) *
                       np.sqrt(2.0 / fan_in)).astype(np.float32),
            "bias": np.zeros((out_ch,), np.float32),
        }
        if tap:
            lin_ch.append(out_ch)
        in_ch = out_ch
    for k, c in enumerate(lin_ch):
        params[f"lin{k}"] = {
            "kernel": np.abs(rng.randn(c, 1)).astype(np.float32) * 0.1,
        }
    return params


def lpips_vgg(weights: tuple, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """LPIPS distance per batch element: x, y [B,H,W,3] in [-1,1] -> [B].
    ``weights``: ``weights.lpips_weights_from_jax(tree, device)``."""
    convs, lins = weights

    def feats(img):
        shift = torch.tensor(LPIPS_SHIFT, device=img.device)
        scale = torch.tensor(LPIPS_SCALE, device=img.device)
        z = ((img - shift) / scale).permute(0, 3, 1, 2)
        return _conv_stack(convs, z, LPIPS_VGG16_CONVS, LPIPS_POOL_BEFORE)

    total = 0.0
    for w, a, b in zip(lins, feats(x), feats(y)):
        a = a / torch.sqrt(a.square().sum(dim=1, keepdim=True) + 1e-10)
        b = b / torch.sqrt(b.square().sum(dim=1, keepdim=True) + 1e-10)
        d = torch.einsum("bchw,c->bhw", (a - b).square(), w)
        total = total + d.mean(dim=(1, 2))
    return total


def load_msgpack_params(path: str) -> dict | None:
    """JAX's name: any converted perceptual tree, unchecked (``load_tree``
    with no conv to check)."""
    return load_tree(path, ())


def make_lpips_fn(cfg, device="cpu"):
    """LPIPS(net='vgg') from ``cfg['lpips_vgg_ckpt']`` (a
    ``convert_lpips_vgg`` msgpack tree, its convs checked) with its weights
    on ``device``; None where the file is absent, and the callers fall back
    to the surrogate and say so."""
    tree = load_tree(str(cfg.get("lpips_vgg_ckpt", "") or ""), LPIPS_VGG16_CONVS)
    if tree is None:
        return None
    from real3dportrait_tpu_torch.weights import lpips_weights_from_jax

    weights = lpips_weights_from_jax(tree, device)
    return lambda x, y: lpips_vgg(weights, x, y)

"""State dicts in the released torch layout, made from the port's modules.

The released checkpoints (``240210_real3dportrait_orig``) and the
reference code are not in the repository, so the checkpoint converters
(``tools/convert_torch_ckpt.py`` and the port's
``real3dportrait_tpu_torch/tools/convert_torch_ckpt.py``) are fed state
dicts that this module writes in the reference's layout: it starts from a
port module's Flax-layout tree (``weights.jax_variables_from_torch``) and
inverts the converters' renames and leaf transforms (HWIO -> OIHW,
``[in,out]`` -> ``[out,in]``, HWC ``const`` -> CHW, ``noise_const`` and
``w_avg`` back to buffers, each family's regex renames), then unfolds the
norms the converters fold, with seeded statistics:

* BatchNorm: ``weight``, ``bias``, ``running_mean``, ``running_var``
  (and ``num_batches_tracked``), into a per-channel affine or into the
  preceding conv;
* weight norm: ``weight_g`` / ``weight_v``, and HuBERT's
  ``parametrizations.weight.original0`` / ``original1``;
* spectral norm: ``weight_orig``, ``weight_u``, ``weight_v``.

A converted leaf that is copied or transposed is bit-equal to the module's.
A folded one is not: :class:`RefLayout` carries, by the port's parameter
name, an elementwise bound on ``|folded - module|``: the exact error of the
stored fp32 operands (reckoned in float64) plus the forward-error bound
``gamma_k * sum|terms|`` of the converter's fp32 operations, ``gamma_k =
k u / (1 - k u)`` with ``u = 2^-24`` and ``k`` the roundings on the
longest chain (a sum of ``n`` terms counts ``n``, whatever its order).

This file imports numpy, torch and the port only, so that ``chip_smoke.py``
uses it on a host with no JAX.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from real3dportrait_tpu_torch.models.img2plane_composite import ChannelAffine
from real3dportrait_tpu_torch.weights import jax_variables_from_torch

U32 = 2.0 ** -24
# the float64 reckoning of a fold's exact value: far below one fp32 rounding
U64_SLACK = 2.0 ** -40


def gamma(k: int) -> float:
    """The forward-error factor of ``k`` fp32 roundings."""
    return k * U32 / (1 - k * U32)


@dataclasses.dataclass
class RefLayout:
    """``state_dict``: released-layout names -> CPU tensors (fp32, int64
    for ``num_batches_tracked``). ``bounds``: the port's parameter name ->
    float64 elementwise bound on the converted value's error, for every
    leaf the converter folds; every other leaf converts bit-equal."""

    state_dict: dict
    bounds: dict

    def save(self, path: str, step: int) -> None:
        """A reference ``model_ckpt_steps_<step>.ckpt``: the model under
        ``model.`` in ``state_dict``, with ``global_step``."""
        torch.save({"state_dict": {f"model.{k}": v for k, v in self.state_dict.items()},
                    "global_step": step}, path)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def port_key(coll: str, path: tuple) -> str:
    """The port's ``state_dict`` name of a Flax leaf."""
    if coll == "noise_const":
        return ".".join(path[:-1] + ("noise_const",))
    leaf = path[-1]
    if coll == "params" and leaf in ("kernel", "scale", "embedding"):
        leaf = "weight"
    return ".".join(path[:-1] + (leaf,))


def _sub(name: str, renames) -> str:
    for pat, repl in renames:
        name = re.sub(pat, repl, name)
    return name


def _f64(a) -> np.ndarray:
    return np.asarray(a, np.float64)


class _Writer:
    """Collects the released-layout tensors and the folded leaves' bounds."""

    def __init__(self, seed: int):
        self.rng = np.random.RandomState(seed)
        self.sd: dict[str, np.ndarray] = {}
        self.bounds: dict[str, np.ndarray] = {}

    def put(self, name: str, arr) -> None:
        if name in self.sd:
            raise ValueError(f"duplicate released name {name}")
        # np.array (not ascontiguousarray) keeps 0-d leaves 0-d
        self.sd[name] = np.array(arr, order="C")

    def bound(self, key: str, exact, target, rounding) -> None:
        """``|exact - target|`` (the stored operands' own error) plus the
        converter's rounding bound and the float64 reckoning's slack."""
        exact = _f64(exact)
        self.bounds[key] = (np.abs(exact - _f64(target)) + rounding
                            + U64_SLACK * np.abs(exact))

    def _stats(self, c: int):
        mean = (self.rng.randn(c) * 0.1).astype(np.float32)
        var = self.rng.uniform(0.5, 2.0, c).astype(np.float32)
        return mean, var

    def bn_affine(self, torch_prefix: str, key_prefix: str, scale, bias, eps: float = 1e-5,
                  names=("scale", "bias")) -> None:
        """An eval BatchNorm whose ``fold_batchnorm_to_affine`` (or
        ``convert_inception``) gives ``scale`` and ``bias``."""
        s, b = _f64(scale), _f64(bias)
        mean, var = self._stats(s.shape[0])
        std = np.sqrt(_f64(var) + _f64(np.float32(eps)))
        gamma_ = (s * std).astype(np.float32)
        beta = (b + _f64(mean) * s).astype(np.float32)
        for leaf, arr in (("weight", gamma_), ("bias", beta), ("running_mean", mean),
                          ("running_var", var)):
            self.put(f"{torch_prefix}.{leaf}", arr)
        self.put(f"{torch_prefix}.num_batches_tracked", np.asarray(1000, np.int64))
        s_x = _f64(gamma_) / std
        b_x = _f64(beta) - _f64(mean) * s_x
        # scale: eps add, sqrt, divide; bias: those, the product, the difference
        self.bound(f"{key_prefix}.{_port_leaf(names[0])}", s_x, s, gamma(3) * np.abs(s_x))
        self.bound(f"{key_prefix}.{names[1]}", b_x, b,
                   gamma(5) * (np.abs(_f64(beta)) + np.abs(_f64(mean) * s_x)))

    def bn_conv(self, conv: str, bn: str, key_prefix: str, weight, bias,
                conv_bias: bool, eps: float = 1e-5) -> None:
        """A conv (torch layout ``weight`` [O,...]) followed by an eval
        BatchNorm, whose ``fold_batchnorm_into_conv`` gives ``weight`` and
        ``bias``."""
        w, b = _f64(weight), _f64(bias)
        c = w.shape[0]
        mean, var = self._stats(c)
        g = self.rng.uniform(0.5, 1.5, c).astype(np.float32)
        std = np.sqrt(_f64(var) + _f64(np.float32(eps)))
        s = _f64(g) / std
        shape = (-1,) + (1,) * (w.ndim - 1)
        w_raw = (w / s.reshape(shape)).astype(np.float32)
        cb = (self.rng.randn(c) * 0.1).astype(np.float32) if conv_bias else np.zeros(c, np.float32)
        beta = (b + (_f64(mean) - _f64(cb)) * s).astype(np.float32)
        self.put(f"{conv}.weight", w_raw)
        if conv_bias:
            self.put(f"{conv}.bias", cb)
        for leaf, arr in (("weight", g), ("bias", beta), ("running_mean", mean),
                          ("running_var", var)):
            self.put(f"{bn}.{leaf}", arr)
        self.put(f"{bn}.num_batches_tracked", np.asarray(1000, np.int64))
        w_x = _f64(w_raw) * s.reshape(shape)
        b_x = _f64(beta) - _f64(mean) * s + _f64(cb) * s
        # scale as above, then the product; bias: two products, two sums
        self.bound(f"{key_prefix}.weight", w_x, w, gamma(4) * np.abs(w_x))
        self.bound(f"{key_prefix}.bias", b_x, b, gamma(6) * (
            np.abs(_f64(beta)) + np.abs(_f64(mean) * s) + np.abs(_f64(cb) * s)))

    def weight_norm(self, torch_prefix: str, key: str, weight, axes: tuple,
                    names=("weight_g", "weight_v")) -> None:
        """``w = g * v / ||v||`` (the norm over ``axes``), as
        ``fold_weight_norm`` (``axes`` all but 0) and ``convert_hubert``
        (``axes`` (0, 1)) fold it."""
        w = _f64(weight)
        keep = tuple(1 if i in axes else n for i, n in enumerate(w.shape))
        c = self.rng.uniform(0.5, 2.0, keep)
        v = (w * c).astype(np.float32)
        norm = np.sqrt(np.sum(np.square(_f64(v)), axis=axes, keepdims=True))
        g = (norm / c).astype(np.float32)
        self.put(f"{torch_prefix}.{names[0]}", g)
        self.put(f"{torch_prefix}.{names[1]}", v)
        x = _f64(g) * _f64(v) / norm
        m = int(np.prod([w.shape[i] for i in axes]))
        # the squares and their sum of m (m roundings, halved by the sqrt),
        # the sqrt, the product, the quotient
        self.bound(key, x, w, gamma(-(-m // 2) + 4) * np.abs(x))

    def spectral_norm(self, torch_prefix: str, key: str, weight) -> None:
        """``w = weight_orig / (u^T W v)`` with stored ``u`` (unit) and
        ``v`` (``W^T u / |W^T u|^2``, so that ``u^T W v`` is 1 before the
        seeded ``sigma``), as ``fold_spectral_norm`` folds it."""
        w = _f64(weight)
        wm = w.reshape(w.shape[0], -1)
        u = self.rng.randn(w.shape[0])
        u = (u / np.linalg.norm(u)).astype(np.float32)
        t = wm.T @ _f64(u)
        v = (t / (t @ t)).astype(np.float32)
        sigma = np.float32(self.rng.uniform(0.5, 2.0))
        orig = (w * _f64(sigma)).astype(np.float32)
        self.put(f"{torch_prefix}.weight_orig", orig)
        self.put(f"{torch_prefix}.weight_u", u)
        self.put(f"{torch_prefix}.weight_v", v)
        om = _f64(orig).reshape(w.shape[0], -1)
        sig_x = _f64(u) @ (om @ _f64(v))
        x = _f64(orig) / sig_x
        terms = np.abs(_f64(u)) @ (np.abs(om) @ np.abs(_f64(v)))
        n, o = wm.shape[1], wm.shape[0]
        # sigma: a matvec of n terms a row and a dot of o; its cast to fp32;
        # the quotient
        self.bound(key, x, w, gamma(n + o + 2) * (terms / abs(sig_x)) * np.abs(x))


def _port_leaf(name: str) -> str:
    return "weight" if name == "scale" else name


# -- leaf layouts: Flax-layout arrays back to torch's ----------------------------------


def _stylegan_leaf(coll: str, path: tuple, arr: np.ndarray):
    """The inverse of ``convert_leaf``."""
    if coll == "noise_const":
        return path[:-1] + ("noise_const",), arr
    leaf = path[-1]
    if coll == "params" and leaf == "const" and arr.ndim == 3:
        return path, arr.transpose(2, 0, 1)
    if coll == "params" and leaf == "weight":
        if arr.ndim == 4:
            return path, arr.transpose(3, 2, 0, 1)
        if arr.ndim == 2:
            return path, arr.T
    return path, arr


def _builtin_leaf(coll: str, path: tuple, arr: np.ndarray):
    """The inverse of ``_segformer_leaf`` / ``_torso_leaf``: Flax-builtin
    ``kernel`` -> torch ``weight``; a LayerNorm's ``scale`` -> ``weight``."""
    leaf = path[-1]
    if leaf == "kernel":
        perm = {5: (4, 3, 0, 1, 2), 4: (3, 2, 0, 1), 2: (1, 0)}[arr.ndim]
        return path[:-1] + ("weight",), arr.transpose(perm)
    if leaf == "scale":
        return path[:-1] + ("weight",), arr
    return _stylegan_leaf(coll, path, arr)


def _vae_leaf(coll: str, path: tuple, arr: np.ndarray):
    """The inverse of ``_vae_leaf``."""
    leaf = path[-1]
    if leaf == "embedding":
        return path[:-1] + ("weight",), arr
    if leaf == "kernel" and arr.ndim == 3:
        perm = (1, 2, 0) if "ConvTranspose" in path[-2] else (2, 1, 0)
        return path[:-1] + ("weight",), arr.transpose(perm)
    if leaf == "kernel" and arr.ndim == 2:
        return path[:-1] + ("weight",), arr.T
    return _stylegan_leaf(coll, path, arr)


def _syncnet_leaf(coll: str, path: tuple, arr: np.ndarray):
    if path[-1] == "kernel" and arr.ndim == 3:
        return path[:-1] + ("weight",), arr.transpose(2, 1, 0)
    return _stylegan_leaf(coll, path, arr)


# -- the converters' renames, inverted ---------------------------------------------

_SEGFORMER = [
    (r"\bblock(\d)_(\d+)\.", r"block\1.\2."),
    (r"\bpatch_embed(\d)\.Conv_0\.", r"patch_embed\1.proj."),
    (r"\bpatch_embed(\d)\.LayerNorm_0\.", r"patch_embed\1.norm."),
    (r"\battn\.sr_norm\.", r"attn.norm."),
    (r"\bmlp\.Dense_0\.", r"mlp.fc1."),
    (r"\bmlp\.Dense_1\.", r"mlp.fc2."),
    (r"\bmlp\.DWConv_0\.Conv_0\.", r"mlp.dwconv.dwconv."),
    (r"\blinear_c(\d)\.", r"linear_c\1.proj."),
    (r"\bto_plane_cnn\.conv0\.", r"to_plane_cnn.0."),
    (r"\bto_plane_cnn\.conv1\.", r"to_plane_cnn.2."),
    (r"\bto_plane_cnn\.conv2\.", r"to_plane_cnn.4."),
    (r"\bto_plane_cnn\.to_plane\.", r"to_plane_cnn.7."),
    (r"\blinear_fuse\.", r"linear_fuse.conv."),
]

_COMPOSITE = [
    (r"\bencoder\.layer(\d)_(\d+)\.", r"encoder.layer\1.\2."),
    (r"\bdownsample_conv\.", r"downsample.0."),
    (r"\bdownsample_norm\.", r"downsample.1."),
    (r"\bdecoder\.aspp_conv([0-3])\.", r"decoder.0.convs.\1.0."),
    (r"\bdecoder\.aspp_pool_conv\.", r"decoder.0.convs.4.1."),
    (r"\bdecoder\.aspp_project\.", r"decoder.0.project.0."),
    (r"\bdecoder\.out_conv\.", r"decoder.1."),
    (r"\bhigh_reso_encoder\.conv([0-3])\.",
     lambda m: f"high_reso_encoder.conv_layers.{2 * int(m.group(1))}."),
    (r"\bpatch_embed\.Conv_0\.", r"patch_embed.proj."),
    (r"\bpatch_embed\.LayerNorm_0\.", r"patch_embed.norm."),
    (r"\battn\.sr_norm\.", r"attn.norm."),
    (r"\bmlp\.Dense_0\.", r"mlp.fc1."),
    (r"\bmlp\.Dense_1\.", r"mlp.fc2."),
    (r"\bmlp\.DWConv_0\.Conv_0\.", r"mlp.dwconv.dwconv."),
]

_TORSO = [
    (r"\btgt_head_in_conv\.conv\.", r"tgt_head_encoder.0.layers.0."),
    (r"\btgt_head_in_conv\.norm\.", r"tgt_head_encoder.0.layers.1."),
    (r"\btgt_head_res_(\d+)\.block(\d)\.norm\.",
     lambda m: f"tgt_head_encoder.{int(m.group(1)) + 1}.layers.{m.group(2)}.layers.0."),
    (r"\btgt_head_res_(\d+)\.block(\d)\.conv\.",
     lambda m: f"tgt_head_encoder.{int(m.group(1)) + 1}.layers.{m.group(2)}.layers.2."),
    (r"\bin_conv\.conv\.", r"in_conv.layers.0."),
    (r"\bin_conv\.norm\.", r"in_conv.layers.1."),
    (r"\bdown_(\d+)\.conv\.", r"down.\1.layers.0.layers.0."),
    (r"\bdown_(\d+)\.norm\.", r"down.\1.layers.0.layers.1."),
    (r"\bup_(\d+)\.conv\.", r"up.\1.layers.1.layers.0."),
    (r"\bup_(\d+)\.norm\.", r"up.\1.layers.1.layers.1."),
    (r"\bres_(\d+)\.block(\d)\.norm\.", r"res.\1.layers.\2.layers.0."),
    (r"\bres_(\d+)\.block(\d)\.conv\.", r"res.\1.layers.\2.layers.2."),
    (r"\bocc2_pred_conv([0-2])\.",
     lambda m: f"occlusion_2_predictor.{2 * int(m.group(1))}."),
]

_SR_WARP = _TORSO + [
    (r"\btorso_encoder\.", r"torso_encoder.0."),
    (r"\bbg_enc_conv([0-2])\.", lambda m: f"bg_encoder.{2 * int(m.group(1))}."),
    (r"\bfuse_ht_conv([0-1])\.", lambda m: f"fuse_head_torso_convs.{2 * int(m.group(1))}."),
    (r"\bfuse_fb_conv([0-2])\.", lambda m: f"fuse_fg_bg_convs.{2 * int(m.group(1))}."),
]

_VAE = [
    (r"\bin_(\d+)\.", r"in_layers.\1."),
    (r"\bres_skip_(\d+)\.", r"res_skip_layers.\1."),
    (r"\bg_pre_net\.", r"g_pre_net.0."),
    (r"\bencoder\.Conv_0\.", r"encoder.pre_net.0."),
    (r"\bdecoder\.ConvTranspose_0\.", r"decoder.pre_net.0."),
    (r"\bflow_(\d+)\.", lambda m: f"flows.{2 * int(m.group(1))}."),
    (r"\b(mel_encoder|pitch_encoder)_conv0\.", r"\1.0."),
    (r"\b(mel_encoder|pitch_encoder)_conv1\.", r"\1.3."),
]

_SYNCNET = [
    (r"\b(hubert_encoder|mouth_encoder)\.layer_(\d+)\.Conv_0\.", r"\1.\2.conv_block.0."),
    (r"\b(hubert_encoder|mouth_encoder)\.layer_(\d+)\.norm\.", r"\1.\2.conv_block.1."),
]

_OSG = [(r"^net0\.", "net.0."), (r"^net1\.", "net.2.")]

# the reference's weight-normed convs (`flow_base.py:46-63`: WN's in, skip
# and cond layers) and spectral-normed ones (the facev2v warp generator's,
# `facev2v_warp/network.py:250`)
_VAE_WN = r"\.(in_layers\.\d+|res_skip_layers\.\d+|cond_layer)\.weight$"
_TORSO_SN = r"(^|\.)deform_based_generator\..*\.weight$"


def _affine_names(module: torch.nn.Module, scope: str = "") -> set:
    """The dotted names (relative to ``scope``) of ``module``'s folded
    BatchNorm affines."""
    pre = scope + "." if scope else ""
    return {n[len(pre):] for n, m in module.named_modules()
            if isinstance(m, ChannelAffine) and n.startswith(pre)}


def _emit(w: _Writer, tree: dict, *, leaf_fn, renames=(), affines=(), bn_convs=None,
          wn=None, sn=None, key_scope: str = "", torch_scope: str = "") -> None:
    """Write ``tree`` (a Flax-layout variables dict) in the torch layout:
    each leaf through ``leaf_fn`` and ``renames``; the ``scale`` / ``bias``
    of each name in ``affines`` as an eval BatchNorm; each conv of
    ``bn_convs`` ({Flax name: (torch BN name, conv has a bias)}) with its
    BatchNorm unfolded; weights whose torch name matches ``wn`` / ``sn``
    weight-normed / spectral-normed."""
    bn_convs = bn_convs or {}
    kp = key_scope + "." if key_scope else ""
    tp = torch_scope + "." if torch_scope else ""
    grouped: dict[str, dict] = {}
    for coll, t in tree.items():
        for path, arr in _leaves(t):
            owner = ".".join(path[:-1])
            if coll == "params" and (owner in affines or owner in bn_convs):
                grouped.setdefault(owner, {})[path[-1]] = arr
                continue
            parts, tarr = leaf_fn(coll, path, arr)
            name = _sub(".".join(parts), renames)
            key = kp + port_key(coll, path)
            if wn and re.search(wn, name):
                w.weight_norm(tp + name[: -len(".weight")], key, tarr,
                              tuple(range(1, tarr.ndim)))
            elif sn and re.search(sn, name) and tarr.any():
                w.spectral_norm(tp + name[: -len(".weight")], key, tarr)
            else:
                w.put(tp + name, tarr)
    for owner, leaves in grouped.items():
        torch_owner = tp + _sub(owner + ".", renames)[:-1]
        if owner in affines:
            w.bn_affine(torch_owner, kp + owner, leaves["scale"], leaves["bias"])
        else:
            bn, conv_bias = bn_convs[owner]
            parts, tarr = leaf_fn("params", tuple(owner.split(".")) + ("kernel",),
                                  leaves["kernel"])
            w.bn_conv(tp + _sub(".".join(parts), renames)[: -len(".weight")], tp + bn,
                      kp + owner, tarr, leaves["bias"], conv_bias)


def _scoped(tree: dict, scope: str) -> dict:
    return {coll: t[scope] for coll, t in tree.items() if scope in t}


def _done(w: _Writer) -> RefLayout:
    # one tensor an array: an aliased submodule's tensors are saved once
    tensors: dict = {}
    return RefLayout({k: tensors.setdefault(id(v), torch.from_numpy(v))
                      for k, v in w.sd.items()}, w.bounds)


# -- the families ------------------------------------------------------------------


def _stylegan_or_builtin(coll, path, arr):
    # the SegFormer's eq-lr prenet keeps the StyleGAN layout
    return (_stylegan_leaf if path[0] == "prenet" else _builtin_leaf)(coll, path, arr)


def _segformer(w, tree, module, scope):
    _emit(w, _scoped(tree, scope), leaf_fn=_stylegan_or_builtin, renames=_SEGFORMER,
          bn_convs={"fuse_head.linear_fuse": ("fuse_head.linear_fuse.bn", False)},
          key_scope=scope, torch_scope=scope)


def _composite(w, tree, module, scope):
    _emit(w, _scoped(tree, scope), leaf_fn=_builtin_leaf, renames=_COMPOSITE,
          affines=_affine_names(module, scope), key_scope=scope, torch_scope=scope)


def _sr_leaf(coll, path, arr):
    if path[0] in ("block0", "block1", "head_torso_block"):
        return _stylegan_leaf(coll, path, arr)
    return _builtin_leaf(coll, path, arr)


def secc2video(model: torch.nn.Module, seed: int = 0,
               backbone_mode: str = "composite") -> RefLayout:
    """``OSAvatarSECCImg2PlaneTorso`` / ``OSAvatarSECCImg2Plane`` (built
    with ``head_norm_mode="folded_bn"``) -> the reference
    ``OSAvatarSECC_Img2plane_Torso`` state dict: the canonical backbone also
    under its alias ``cano_img2plane_backbone`` (the same tensors, as torch
    saves an aliased submodule), the task's ``lambda_pertube_*`` scalars.
    ``backbone_mode`` is the canonical backbone's family."""
    tree = jax_variables_from_torch(model)
    w = _Writer(seed)
    (_composite if backbone_mode == "composite" else _segformer)(
        w, tree, model, "img2plane_backbone")
    _segformer(w, tree, model, "secc_img2plane_backbone")
    _emit(w, _scoped(tree, "decoder"), leaf_fn=_stylegan_leaf, renames=_OSG,
          key_scope="decoder", torch_scope="decoder")
    sr = "superresolution"
    if hasattr(model.superresolution, "torso_model"):
        _emit(w, _scoped(tree, sr), leaf_fn=_sr_leaf, renames=_SR_WARP,
              affines=_affine_names(model, sr), sn=_TORSO_SN, key_scope=sr, torch_scope=sr)
    else:
        _emit(w, _scoped(tree, sr), leaf_fn=_stylegan_leaf, key_scope=sr, torch_scope=sr)
    for k in [k for k in w.sd if k.startswith("img2plane_backbone.")]:
        w.sd["cano_" + k] = w.sd[k]
    for name in ("lambda_pertube_secc", "lambda_pertube_blink_secc"):
        w.put(name, np.asarray([w.rng.uniform(0.0, 0.1)], np.float32))
    return _done(w)


def audio2secc(model: torch.nn.Module, seed: int = 0) -> RefLayout:
    """``PitchContourVAEModel(norm_mode="folded_bn")`` -> the reference
    audio2secc state dict: weight-normed WN layers, the cond encoders'
    first convs with their BatchNorms."""
    w = _Writer(seed)
    _emit(w, jax_variables_from_torch(model), leaf_fn=_vae_leaf, renames=_VAE, wn=_VAE_WN,
          bn_convs={"mel_encoder_conv0": ("mel_encoder.1", True),
                    "pitch_encoder_conv0": ("pitch_encoder.1", True)})
    return _done(w)


def stylegan(model: torch.nn.Module, seed: int = 0) -> RefLayout:
    """A StyleGAN2 ``Generator``, ``MappingNetwork`` or
    ``SuperresolutionHybrid8XDC`` (the SR 8XDC head); each synthesis block also gets the
    ``resample_filter`` buffer the reference registers (skipped by the
    converters)."""
    w = _Writer(seed)
    _emit(w, jax_variables_from_torch(model), leaf_fn=_stylegan_leaf)
    _resample_filters(w)
    return _done(w)


def _resample_filters(w: _Writer) -> None:
    blocks = sorted({k.rsplit(".", 2)[0] for k in w.sd if re.search(r"\.conv1\.weight$", k)})
    f = np.outer([1, 3, 3, 1], [1, 3, 3, 1]).astype(np.float32) / 64
    for b in blocks:
        w.put(f"{b}.resample_filter", f)


def discriminator(model: torch.nn.Module, seed: int = 0) -> RefLayout:
    """A StyleGAN2 ``Discriminator``: the epilogue's ``b4.fc`` weight back
    to torch's CHW flattening."""
    w = _Writer(seed)

    def leaf(coll, path, arr):
        if path[-2:] == ("fc", "weight") and path[-3].startswith("b") and arr.ndim == 2:
            out = arr.shape[1]
            c = arr.shape[0] // 16
            return path, arr.T.reshape(out, 4, 4, c).transpose(0, 3, 1, 2).reshape(out, -1)
        return _stylegan_leaf(coll, path, arr)

    _emit(w, jax_variables_from_torch(model), leaf_fn=leaf)
    _resample_filters(w)
    return _done(w)


def syncnet(model: torch.nn.Module, seed: int = 0) -> RefLayout:
    """``LandmarkHubertSyncNet(norm_mode="affine")`` -> the reference
    SyncNet: each tower layer's Conv1d and BatchNorm, and the CLIP-style
    ``logit_scale`` the converter drops."""
    w = _Writer(seed)
    _emit(w, jax_variables_from_torch(model), leaf_fn=_syncnet_leaf, renames=_SYNCNET,
          affines=_affine_names(model))
    w.put("logit_scale", np.asarray(np.log(1 / 0.07), np.float32))
    return _done(w)


def inception(model: torch.nn.Module, seed: int = 0) -> RefLayout:
    """``InceptionV3Features`` -> torchvision's ``inception_v3`` layout
    (``<block>.<branch>.conv.weight`` + ``.bn.*``, eps 1e-3), with an ``fc``
    head the converter drops."""
    tree = jax_variables_from_torch(model)["params"]
    w = _Writer(seed)
    for path, arr in _leaves(tree):
        base = ".".join(path[:-2] if path[-2:] == ("conv", "kernel") else path[:-1])
        if path[-1] == "kernel":
            w.put(f"{base}.conv.weight", arr.transpose(3, 2, 0, 1))
        elif path[-1] == "bn_scale":
            node = tree
            for p in path[:-1]:
                node = node[p]
            w.bn_affine(f"{base}.bn", base, node["bn_scale"], node["bn_bias"], eps=1e-3,
                        names=("bn_scale", "bn_bias"))
    w.put("fc.weight", (w.rng.randn(10, 2048) * 0.01).astype(np.float32))
    w.put("fc.bias", np.zeros(10, np.float32))
    return _done(w)


def hubert(model: torch.nn.Module, seed: int = 0, parametrizations: bool = False) -> RefLayout:
    """The port's ``HubertEncoder`` (heads = hidden // 64, the converter's
    rule) -> HF ``HubertModel``'s state dict, its positional conv weight-normed
    over dims (0, 1) in the classic (``weight_g`` / ``weight_v``) or the
    ``parametrizations`` layout."""
    t = jax_variables_from_torch(model)["params"]
    w = _Writer(seed)
    fe = t["feature_extractor"]
    i = 0
    while f"conv_{i}" in fe:
        pre = f"feature_extractor.conv_layers.{i}"
        w.put(f"{pre}.conv.weight", fe[f"conv_{i}"]["kernel"].transpose(2, 1, 0))
        norm = fe.get("gn_0") if i == 0 and "gn_0" in fe else fe.get(f"ln_{i}")
        if norm is not None:
            w.put(f"{pre}.layer_norm.weight", norm["scale"])
            w.put(f"{pre}.layer_norm.bias", norm["bias"])
        i += 1
    if "feat_ln" in t:
        w.put("feature_projection.layer_norm.weight", t["feat_ln"]["scale"])
        w.put("feature_projection.layer_norm.bias", t["feat_ln"]["bias"])
    w.put("feature_projection.projection.weight", t["feat_proj"]["kernel"].T)
    w.put("feature_projection.projection.bias", t["feat_proj"]["bias"])
    names = (("parametrizations.weight.original0", "parametrizations.weight.original1")
             if parametrizations else ("weight_g", "weight_v"))
    w.weight_norm("encoder.pos_conv_embed.conv", "pos_conv.conv.weight",
                  t["pos_conv"]["conv"]["kernel"].transpose(2, 1, 0), (0, 1), names)
    w.put("encoder.pos_conv_embed.conv.bias", t["pos_conv"]["conv"]["bias"])
    w.put("encoder.layer_norm.weight", t["encoder_ln"]["scale"])
    w.put("encoder.layer_norm.bias", t["encoder_ln"]["bias"])
    li = 0
    while f"layer_{li}" in t:
        lt, pre = t[f"layer_{li}"], f"encoder.layers.{li}"
        att = lt["attention"]
        for fname, tname in (("query", "q_proj"), ("key", "k_proj"), ("value", "v_proj")):
            k = att[fname]["kernel"]
            w.put(f"{pre}.attention.{tname}.weight", k.reshape(k.shape[0], -1).T)
            w.put(f"{pre}.attention.{tname}.bias", att[fname]["bias"].reshape(-1))
        k = att["out"]["kernel"]
        w.put(f"{pre}.attention.out_proj.weight", k.reshape(-1, k.shape[-1]).T)
        w.put(f"{pre}.attention.out_proj.bias", att["out"]["bias"])
        for fname, tname in (("ln_attn", "layer_norm"), ("ln_ffn", "final_layer_norm")):
            w.put(f"{pre}.{tname}.weight", lt[fname]["scale"])
            w.put(f"{pre}.{tname}.bias", lt[fname]["bias"])
        for fname, tname in (("ffn_in", "intermediate_dense"), ("ffn_out", "output_dense")):
            w.put(f"{pre}.feed_forward.{tname}.weight", lt[fname]["kernel"].T)
            w.put(f"{pre}.feed_forward.{tname}.bias", lt[fname]["bias"])
        li += 1
    w.put("masked_spec_embed", (w.rng.uniform(size=t["feat_proj"]["bias"].shape[0]))
          .astype(np.float32))
    return _done(w)


def vgg19(tree: dict) -> dict:
    """A VGG19 perceptual tree (``conv<i>``: HWIO ``kernel``, ``bias``) ->
    torchvision ``vgg19().features`` under ``features.``."""
    return {f"features.{k[4:]}.{leaf}": torch.from_numpy(np.ascontiguousarray(
        v["kernel"].transpose(3, 2, 0, 1) if leaf == "weight" else v["bias"]))
        for k, v in tree.items() for leaf in ("weight", "bias")}


_VGGFACE_DAG = {0: "conv1_1", 2: "conv1_2", 5: "conv2_1", 7: "conv2_2", 10: "conv3_1",
                12: "conv3_2", 14: "conv3_3", 17: "conv4_1", 19: "conv4_2", 21: "conv4_3",
                24: "conv5_1", 26: "conv5_2", 28: "conv5_3"}


def vggface(tree: dict) -> dict:
    """A VGGFace tree -> the vgg_face_dag layout (``conv1_1.weight`` ...)."""
    out = {}
    for k, v in tree.items():
        name = _VGGFACE_DAG[int(k[4:])]
        out[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
            v["kernel"].transpose(3, 2, 0, 1)))
        out[f"{name}.bias"] = torch.from_numpy(np.ascontiguousarray(v["bias"]))
    return out


def lpips_vgg(tree: dict) -> dict:
    """An LPIPS(vgg) tree -> the lpips package's ``net.slice<s>.<i>.*`` and
    ``lin<k>.model.1.weight`` [1,C,1,1]."""
    bounds = (4, 9, 16, 23, 30)  # torchvision vgg16 feature index ranges of the slices
    out = {}
    for k, v in tree.items():
        if k.startswith("lin"):
            kern = np.asarray(v["kernel"])
            out[f"{k}.model.1.weight"] = torch.from_numpy(np.ascontiguousarray(
                kern.reshape(1, -1, 1, 1)))
            continue
        idx = int(k[4:])
        s = 1 + sum(idx >= b for b in bounds)
        out[f"net.slice{s}.{idx}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(v["kernel"]).transpose(3, 2, 0, 1)))
        out[f"net.slice{s}.{idx}.bias"] = torch.from_numpy(np.ascontiguousarray(v["bias"]))
    return out


def check_converted(module: torch.nn.Module, ref: RefLayout, loaded: dict) -> dict:
    """``loaded`` (the port's parameter name -> tensor, e.g. the state dict
    of a module that loaded the converted checkpoint) against ``module``'s
    own: bit-equal where ``ref`` has no bound, within it where it has one.
    Returns {"equal": n, "folded": n, "worst": largest error / bound};
    raises naming the first leaf outside."""
    want = module.state_dict()
    if sorted(loaded) != sorted(want):
        raise AssertionError(f"names differ: {sorted(set(loaded) ^ set(want))[:5]}")
    worst, n_eq = 0.0, 0
    for k, v in want.items():
        got = loaded[k].detach().cpu()
        v = v.detach().cpu()
        if k not in ref.bounds:
            if not torch.equal(got, v):
                raise AssertionError(f"{k}: not bit-equal (max err "
                                     f"{(got.double() - v.double()).abs().max().item():.3e})")
            n_eq += 1
            continue
        err = np.abs(got.double().numpy() - v.double().numpy())
        b = np.broadcast_to(ref.bounds[k], err.shape)
        if not (err <= b).all():
            i = np.unravel_index(np.argmax(err - b), err.shape)
            raise AssertionError(f"{k}: folded error {err[i]:.3e} over its bound {b[i]:.3e}")
        worst = max(worst, float(np.max(np.where(b > 0, err / np.where(b > 0, b, 1), 0))))
    return {"equal": n_eq, "folded": len(ref.bounds), "worst": worst}

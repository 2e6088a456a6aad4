"""Torch -> JAX-layout checkpoint converter for the released reference
weights, with no JAX or Flax (port of ``tools/convert_torch_ckpt.py``).

Maps the reference's torch ``state_dict`` layouts (dotted module names, OIHW
convs, ``[out,in]`` dense weights, registered buffers — see
``modules/eg3ds/models/networks_stylegan2.py:37-813`` and
``utils/commons/ckpt_utils.py:29`` in the reference) onto the JAX package's
Flax variable trees (nested dicts, HWIO convs, ``[in,out]`` dense weights,
separate ``ema``/``noise_const`` collections), the trees that both packages'
checkpoints hold: the port reads them through ``utils/msgpack_ckpt.py`` and
``weights.load_jax_variables``, the JAX package through flax.

Design: the Flax modules reuse the reference's submodule names (``conv0``,
``affine``, ``b{res}``, ``fc{i}``, ``torgb`` ...), so conversion is a
generic dotted-name walk with

* shape-directed leaf transforms (2-D dense -> transpose, 4-D conv
  OIHW -> HWIO, ``const`` CHW -> HWC),
* buffer routing (``noise_const`` -> the ``noise_const`` collection,
  ``w_avg`` -> ``ema``; ``resample_filter`` buffers are recomputed, skipped),
* optional per-family regex renames where the trees genuinely differ,
* norm folds (BatchNorm, weight norm, spectral norm) in the torch tensors'
  own dtype, as numpy computes them.

``verify_tree`` checks a converted tree leaf-by-leaf against a template
(``weights.jax_variables_from_torch`` of a port module) so mismatches
surface as named diffs, not load-time errors. Every function gives the JAX
converter's tree, leaf dtypes included, and :func:`main` writes its bytes
(``utils/msgpack_ckpt.msgpack_serialize`` is flax's writer, byte for byte).

Usage::

    python -m real3dportrait_tpu_torch.tools.convert_torch_ckpt \\
        --audio2secc checkpoints/240210_real3dportrait_orig/audio2secc_vae \\
        --secc2video checkpoints/240210_real3dportrait_orig/secc2plane_torso \\
        --out checkpoints/converted
"""

from __future__ import annotations

import re
from typing import Callable, Iterable, Mapping

import numpy as np

# ---------------------------------------------------------------------------
# Leaf transforms
# ---------------------------------------------------------------------------

# buffers that are deterministic functions of hyperparameters — recomputed by
# the modules, never loaded
_SKIP_LEAVES = ("resample_filter", "ones_ws", "plane_axes")


def _to_np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    try:  # a torch tensor
        return t.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(t)


def convert_leaf(parts: tuple[str, ...], arr: np.ndarray):
    """One state_dict entry -> (collection, path, array) or None to skip.

    Default rules cover every StyleGAN2-family module; families with
    different conventions pre-rename names before calling this.
    """
    leaf = parts[-1]
    if leaf in _SKIP_LEAVES or leaf.startswith("_"):
        return None
    if leaf == "noise_const":  # torch buffer [res,res] -> noise_const/.../noise
        return ("noise_const", parts[:-1] + ("noise",), arr)
    if leaf == "w_avg":  # MappingNetwork EMA buffer
        return ("ema", parts, arr)
    if leaf == "const" and arr.ndim == 3:  # [C,H,W] -> [H,W,C]
        return ("params", parts, np.ascontiguousarray(arr.transpose(1, 2, 0)))
    if leaf == "weight":
        if arr.ndim == 4:  # conv OIHW -> HWIO
            arr = np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
        elif arr.ndim == 2:  # dense [out,in] -> [in,out]
            arr = np.ascontiguousarray(arr.T)
        return ("params", parts, arr)
    # bias, noise_strength, scalars, 1-D embeddings, norm scales ...
    return ("params", parts, arr)


# ---------------------------------------------------------------------------
# Tree plumbing
# ---------------------------------------------------------------------------


def _set_path(tree: dict, path: tuple[str, ...], value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    if path[-1] in node:
        raise ValueError(f"duplicate path {path}")
    node[path[-1]] = value


def convert_state_dict(
    sd: Mapping[str, "np.ndarray"],
    renames: Iterable[tuple[str, str]] = (),
    skip: Iterable[str] = (),
    leaf_fn: Callable = convert_leaf,
) -> dict:
    """Torch flat state_dict -> nested Flax-layout variables dict.

    ``renames`` are ``(regex, replacement)`` pairs applied (in order, all of
    them) to each dotted torch name before the generic walk. ``skip`` are
    regexes; a name matching any is dropped.
    """
    skip_res = [re.compile(s) for s in skip]
    out: dict[str, dict] = {}
    for name, tensor in sd.items():
        if any(s.search(name) for s in skip_res):
            continue
        for pat, repl in renames:
            name = re.sub(pat, repl, name)
        entry = leaf_fn(tuple(name.split(".")), _to_np(tensor))
        if entry is None:
            continue
        collection, path, arr = entry
        _set_path(out.setdefault(collection, {}), path, np.asarray(arr))
    return out


def tree_leaves_with_paths(tree, prefix=()):
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from tree_leaves_with_paths(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def verify_tree(converted: Mapping, template: Mapping) -> list[str]:
    """Compare converted vs template; return problems."""
    conv = {p: np.shape(v) for p, v in tree_leaves_with_paths(converted)}
    temp = {p: np.shape(v) for p, v in tree_leaves_with_paths(template)}
    problems = []
    for p, s in temp.items():
        if p not in conv:
            problems.append(f"missing   {'.'.join(p)} {s}")
        elif conv[p] != s:
            problems.append(f"shape     {'.'.join(p)}: ckpt {conv[p]} != model {s}")
    for p, s in conv.items():
        if p not in temp:
            problems.append(f"extra     {'.'.join(p)} {s}")
    return problems


def fit_to_template(converted: Mapping, template: Mapping, strict: bool = True):
    """Return ``converted`` cast onto ``template``'s dtypes, as numpy arrays.

    ``template`` is a tree of numpy arrays (``weights.jax_variables_from_torch``
    of a port module, or the JAX package's init tree). With ``strict=False``,
    missing leaves keep the template's value and shape-mismatched leaves are
    skipped (the reference's lenient ``load_ckpt(strict=False)`` semantics,
    ``utils/commons/ckpt_utils.py:54``); ``extra`` leaves never fail a
    lenient fit.
    """
    problems = verify_tree(converted, template)
    hard = [p for p in problems if not p.startswith("extra")]
    if strict and problems:
        raise ValueError("converted tree does not match template:\n  "
                         + "\n  ".join(problems))

    def merge(conv_node, temp_node):
        if not isinstance(temp_node, Mapping):
            if conv_node is None:
                return temp_node
            arr = np.asarray(conv_node)
            if np.shape(arr) != np.shape(temp_node):
                return temp_node
            return np.asarray(arr, dtype=np.asarray(temp_node).dtype)
        out = {}
        for k, tv in temp_node.items():
            cv = conv_node.get(k) if isinstance(conv_node, Mapping) else None
            out[k] = merge(cv, tv)
        return out

    if not strict and hard:
        print(f"| fit_to_template: {len(hard)} leaves kept from init:")
        for p in hard[:20]:
            print(f"|   {p}")
    return merge(converted, template)


# ---------------------------------------------------------------------------
# Checkpoint-file level
# ---------------------------------------------------------------------------


def load_torch_state_dict(ckpt_path: str, model_name: str = "model") -> dict:
    """Load a reference ``model_ckpt_steps_*.ckpt`` and extract one module's
    flat state_dict (mirrors ``utils/commons/ckpt_utils.py:29-52``)."""
    import torch

    # torch >= 2.6 loads with weights_only=True by default, which refuses
    # the pickled objects a training checkpoint holds besides its tensors
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    if any("." in k for k in sd):
        prefix = model_name + "."
        return {k[len(prefix):]: _to_np(v) for k, v in sd.items()
                if k.startswith(prefix)}
    node = sd
    for part in model_name.split("."):
        node = node[part]
    return {k: _to_np(v) for k, v in node.items()}


# ---------------------------------------------------------------------------
# Norm folds
# ---------------------------------------------------------------------------


def convert_flattened_fc_weight(arr: np.ndarray, spatial: int) -> np.ndarray:
    """Dense weight consuming a flattened conv map: torch flattens CHW, the
    NHWC modules flatten HWC — permute the input dim accordingly.

    ``arr`` is the torch ``[out, C*spatial*spatial]`` weight; returns the
    Flax-layout ``[spatial*spatial*C, out]`` weight.
    """
    out, flat = arr.shape
    c = flat // (spatial * spatial)
    assert c * spatial * spatial == flat, (arr.shape, spatial)
    arr = arr.reshape(out, c, spatial, spatial).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(arr.reshape(out, flat).T)


def fold_batchnorm_into_conv(sd: dict, conv_prefix: str, bn_prefix: str,
                             eps: float = 1e-5) -> None:
    """Fold inference-mode BatchNorm stats into the preceding conv, in place.

    ``conv(x); bn(y) = (y - mean)/sqrt(var+eps)*gamma + beta``  becomes a conv
    with ``W' = W * gamma/sqrt(var+eps)`` (per out-channel) and
    ``b' = beta - mean*gamma/sqrt(var+eps)``. Used for the SegFormer fuse
    head, whose (Sync)BatchNorm is replaced with a folded affine at
    conversion (`modules/real3d/segformer.py:482-497`).
    """
    w = _to_np(sd.pop(f"{conv_prefix}.weight"))  # OIHW
    gamma = _to_np(sd.pop(f"{bn_prefix}.weight"))
    beta = _to_np(sd.pop(f"{bn_prefix}.bias"))
    mean = _to_np(sd.pop(f"{bn_prefix}.running_mean"))
    var = _to_np(sd.pop(f"{bn_prefix}.running_var"))
    sd.pop(f"{bn_prefix}.num_batches_tracked", None)
    scale = gamma / np.sqrt(var + eps)
    sd[f"{conv_prefix}.weight"] = w * scale.reshape((-1,) + (1,) * (w.ndim - 1))
    bias = beta - mean * scale
    if f"{conv_prefix}.bias" in sd:
        bias = bias + _to_np(sd.pop(f"{conv_prefix}.bias")) * scale
    sd[f"{conv_prefix}.bias"] = bias


def fold_weight_norm(sd: dict) -> None:
    """Fold torch ``weight_norm`` reparameterizations in place:
    ``w = g * v / ||v||`` with the norm over all dims except 0 (torch's
    default dim=0). The reference's WN stacks weight-norm every conv
    (`modules/audio2motion/flow_base.py:46-63`); the models here use plain
    convs, so conversion bakes the norm in."""
    for k in [k for k in sd if k.endswith(".weight_v")]:
        base = k[: -len(".weight_v")]
        v = _to_np(sd.pop(k))
        g = _to_np(sd.pop(base + ".weight_g"))
        norm = np.sqrt(np.sum(np.square(v), axis=tuple(range(1, v.ndim)),
                              keepdims=True))
        sd[base + ".weight"] = g * v / np.maximum(norm, 1e-12)


def fold_spectral_norm(sd: dict) -> None:
    """Fold torch ``spectral_norm`` in place (eval semantics: stored u/v,
    ``w = weight_orig / (u^T W v)``). The reference facev2v Generator wraps
    every conv in spectral norm (`facev2v_warp/network.py:250`,
    ``use_weight_norm=True`` -> ``layers.py:13`` aliases it to spectral)."""
    for k in [k for k in sd if k.endswith(".weight_orig")]:
        base = k[: -len(".weight_orig")]
        w = _to_np(sd.pop(k))
        u = _to_np(sd.pop(base + ".weight_u"))
        v = _to_np(sd.pop(base + ".weight_v"))
        sigma = float(u @ (w.reshape(w.shape[0], -1) @ v))
        sd[base + ".weight"] = w / sigma


def fold_batchnorm_to_affine(sd: dict, eps: float = 1e-5) -> None:
    """Replace every eval-mode BatchNorm in ``sd`` with a per-channel affine
    (``X.scale``/``X.bias``), the exact eval-time form — consumed by
    ``ChannelAffine`` (norm_mode='affine')."""
    for k in [k for k in sd if k.endswith(".running_mean")]:
        base = k[: -len(".running_mean")]
        mean = _to_np(sd.pop(k))
        var = _to_np(sd.pop(base + ".running_var"))
        gamma = _to_np(sd.pop(base + ".weight", np.ones_like(mean)))
        beta = _to_np(sd.pop(base + ".bias", np.zeros_like(mean)))
        sd.pop(base + ".num_batches_tracked", None)
        scale = gamma / np.sqrt(var + eps)
        sd[base + ".scale"] = scale
        sd[base + ".bias"] = beta - mean * scale


# ---------------------------------------------------------------------------
# Family converters.  Each takes a flat torch state_dict for that module and
# returns a Flax-layout variables dict {"params": ..., "ema": ..., ...}.
# ---------------------------------------------------------------------------


def _merge_collections(dst: dict, src: Mapping, scope: str) -> None:
    for coll, tree in src.items():
        dst.setdefault(coll, {})[scope] = tree


def convert_secc2video(sd: Mapping, backbone_mode: str = "composite") -> dict:
    """Reference ``OSAvatarSECC_Img2plane_Torso`` (or the head-only SECC
    model) state_dict -> the ``OSAvatarSECCImg2PlaneTorso`` variables.

    Submodule routing (reference attribute names, `img2plane_baseline.py:95`,
    `secc_img2plane.py:29-33`, `secc_img2plane_torso.py`): the canonical
    backbone may appear under ``img2plane_backbone`` or its alias
    ``cano_img2plane_backbone``; ``lambda_pertube_*`` scalars belong to the
    task's adaptive-lambda state, returned under a ``task_extra`` key.
    Build the model with ``head_norm_mode="folded_bn"`` (and the
    shipped-config kwargs, see ``flagship_model_kwargs``).
    """
    sd = {k: _to_np(v) for k, v in sd.items()}
    groups: dict[str, dict] = {}
    extras: dict[str, np.ndarray] = {}
    for k, v in sd.items():
        head, _, rest = k.partition(".")
        if head.startswith("lambda_pertube"):
            extras[head] = np.asarray(v).reshape(())
            continue
        groups.setdefault(head, {})[rest] = v

    out: dict[str, dict] = {}
    for alias in ("img2plane_backbone", "cano_img2plane_backbone"):
        if alias in groups:
            if backbone_mode == "composite":
                conv = convert_composite_backbone(groups[alias])
            else:
                conv = convert_segformer_backbone(groups[alias])
            _merge_collections(out, conv, "img2plane_backbone")
            break
    if "secc_img2plane_backbone" in groups:
        _merge_collections(out, convert_segformer_backbone(
            groups["secc_img2plane_backbone"]), "secc_img2plane_backbone")
    if "decoder" in groups:
        _merge_collections(out, convert_osg_decoder(groups["decoder"]),
                           "decoder")
    if "superresolution" in groups:
        sr = groups["superresolution"]
        if any(k.startswith("torso_model.") for k in sr):
            conv = convert_sr_with_ref(sr)
        else:  # head-only model: plain SuperresolutionHybrid8XDC
            conv = convert_superresolution(sr)
        _merge_collections(out, conv, "superresolution")
    handled = {"img2plane_backbone", "cano_img2plane_backbone",
               "secc_img2plane_backbone", "decoder", "superresolution",
               "renderer", "ray_sampler"}
    leftovers = sorted(set(groups) - handled)
    if leftovers:
        print(f"| convert_secc2video: unconverted submodules: {leftovers}")
    if extras:
        out["task_extra"] = extras
    return out


def flagship_model_kwargs() -> dict:
    """Constructor kwargs for ``OSAvatarSECCImg2PlaneTorso`` matching the
    released checkpoints' config (`egs/os_avatar/real3d_orig/
    secc_img2plane_torso_orig.yaml` resolved chain)."""
    return dict(
        triplane_hid_dim=32, triplane_depth=1, triplane_feature_type="triplane",
        neural_rendering_resolution=128, final_resolution=512,
        backbone_mode="composite", backbone_scale="standard",
        secc_segformer_scale="b0", pncc_cond_mode="cano_src_tgt",
        plane_fusion_mode="add", head_norm_mode="folded_bn",
        sr_num_fp16_res=0, sr_channel0=256, sr_channel1=128,
        num_samples_coarse=48, num_samples_fine=48,
        torso_kp_num=4, torso_scale="standard", fuse_mode="v2",
        head_threshold=0.9, torso_version="v2",
    )


_COMPOSITE_RENAMES = [
    # dilated ResNet34 (`deeplabv3/encoders/resnet.py`): ModuleList layers
    (r"\bencoder\.layer(\d)\.(\d+)\.", r"encoder.layer\1_\2."),
    (r"\bdownsample\.0\.", r"downsample_conv."),
    (r"\bdownsample\.1\.", r"downsample_norm."),
    # ASPP decoder (`deeplabv3/decoders/my_decoder.py:128`): Sequential maze
    (r"\bdecoder\.0\.convs\.([0-3])\.0\.", r"decoder.aspp_conv\1."),
    (r"\bdecoder\.0\.convs\.4\.1\.", r"decoder.aspp_pool_conv."),
    (r"\bdecoder\.0\.project\.0\.", r"decoder.aspp_project."),
    (r"\bdecoder\.1\.", r"decoder.out_conv."),
    # high-res CNN (`simple_encoders/high_resolution_encoder.py`)
    (r"\bconv_layers\.0\.", r"conv0."),
    (r"\bconv_layers\.2\.", r"conv1."),
    (r"\bconv_layers\.4\.", r"conv2."),
    (r"\bconv_layers\.6\.", r"conv3."),
    # ViT internals shared with the MiT rename table
    (r"\bpatch_embed\.proj\.", r"patch_embed.Conv_0."),
    (r"\bpatch_embed\.norm\.", r"patch_embed.LayerNorm_0."),
    (r"\battn\.norm\.", r"attn.sr_norm."),
    (r"\bmlp\.fc1\.", r"mlp.Dense_0."),
    (r"\bmlp\.fc2\.", r"mlp.Dense_1."),
    (r"\bmlp\.dwconv\.dwconv\.", r"mlp.DWConv_0.Conv_0."),
]


def convert_composite_backbone(sd: Mapping, prefix: str = "") -> dict:
    """Reference ``Img2PlaneModel`` (`modules/img2plane/img2plane_model.py:12`,
    the composite backbone the released checkpoints use) ->
    ``CompositeImg2PlaneBackbone(norm_mode="affine")``."""
    sd = {k[len(prefix):]: _to_np(v) for k, v in sd.items()
          if k.startswith(prefix)}
    fold_batchnorm_to_affine(sd)  # ResNet34 BatchNorms
    return convert_state_dict(
        sd, renames=_COMPOSITE_RENAMES, skip=[r"num_batches_tracked"],
        leaf_fn=_segformer_leaf,
    )


_SEGFORMER_RENAMES = [
    # MiT encoder: torch ModuleList block1.0 -> block1_0; submodule names
    (r"\bblock(\d)\.(\d+)\.", r"block\1_\2."),
    (r"\bpatch_embed(\d)\.proj\.", r"patch_embed\1.Conv_0."),
    (r"\bpatch_embed(\d)\.norm\.", r"patch_embed\1.LayerNorm_0."),
    (r"\battn\.norm\.", r"attn.sr_norm."),
    (r"\bmlp\.fc1\.", r"mlp.Dense_0."),
    (r"\bmlp\.fc2\.", r"mlp.Dense_1."),
    (r"\bmlp\.dwconv\.dwconv\.", r"mlp.DWConv_0.Conv_0."),
    # head: HeadMLP wraps a single Linear called proj
    (r"\blinear_c(\d)\.proj\.", r"linear_c\1."),
    # to_plane_cnn Sequential indices (1,3,5 = LeakyReLU, 6 = Upsampling)
    (r"\bto_plane_cnn\.0\.", r"to_plane_cnn.conv0."),
    (r"\bto_plane_cnn\.2\.", r"to_plane_cnn.conv1."),
    (r"\bto_plane_cnn\.4\.", r"to_plane_cnn.conv2."),
    (r"\bto_plane_cnn\.7\.", r"to_plane_cnn.to_plane."),
    (r"\blinear_fuse\.conv\.", r"linear_fuse."),
]


def _segformer_leaf(parts: tuple[str, ...], arr: np.ndarray):
    """Leaf rule for Flax-builtin modules (Dense/Conv -> 'kernel',
    LayerNorm -> 'scale'), except the eq-lr ``prenet`` which is a
    StyleGAN2 Conv2dLayer and keeps 'weight'."""
    leaf = parts[-1]
    if parts[0] == "prenet":
        return convert_leaf(parts, arr)
    if leaf == "weight":
        if arr.ndim == 4:  # conv OIHW -> HWIO (also depthwise [C,1,kh,kw])
            return ("params", parts[:-1] + ("kernel",),
                    np.ascontiguousarray(arr.transpose(2, 3, 1, 0)))
        if arr.ndim == 2:  # Linear [out,in] -> [in,out]
            return ("params", parts[:-1] + ("kernel",),
                    np.ascontiguousarray(arr.T))
        if arr.ndim == 1:  # LayerNorm
            return ("params", parts[:-1] + ("scale",), arr)
    return convert_leaf(parts, arr)


def convert_segformer_backbone(sd: Mapping, prefix: str = "") -> dict:
    """Reference ``SegFormerImg2PlaneBackbone`` / ``SegFormerSECC2PlaneBackbone``
    (`modules/real3d/segformer.py:554,673`) -> the SegFormer backbones
    (``head_norm_mode="folded_bn"``). ``prefix`` strips a leading module path.
    """
    sd = {k[len(prefix):]: _to_np(v) for k, v in sd.items()
          if k.startswith(prefix)}
    fold_batchnorm_into_conv(sd, "fuse_head.linear_fuse.conv",
                             "fuse_head.linear_fuse.bn")
    return convert_state_dict(
        sd, renames=_SEGFORMER_RENAMES, skip=[r"num_batches_tracked"],
        leaf_fn=_segformer_leaf,
    )


def convert_osg_decoder(sd: Mapping) -> dict:
    """Reference ``OSGDecoder`` (`modules/eg3ds/models/triplane.py:166`):
    ``net.0`` (FullyConnectedLayer) -> ``net0``, ``net.2`` -> ``net1``."""
    return convert_state_dict(
        sd, renames=[(r"^net\.0\.", "net0."), (r"^net\.2\.", "net1.")]
    )


# torch `_ConvBlock.layers` Sequential: CNA = (0:conv, 1:norm, 2:act),
# NAC = (0:norm, 1:act, 2:conv). Down/Up blocks nest one ConvBlock at
# layers.0 / layers.1 respectively (`facev2v_warp/layers.py:58-95`).
_TORSO_RENAMES = [
    # v2 head conditioning (`network2.py:191-195`): Sequential(ConvBlock,
    # ResBlock x3) — index 0 is the in-conv, 1..3 shift down by one
    (r"\btgt_head_encoder\.0\.layers\.0\.", r"tgt_head_in_conv.conv."),
    (r"\btgt_head_encoder\.0\.layers\.1\.", r"tgt_head_in_conv.norm."),
    (r"\btgt_head_encoder\.(\d+)\.layers\.(\d)\.layers\.0\.",
     lambda m: f"tgt_head_res_{int(m.group(1)) - 1}.block{m.group(2)}.norm."),
    (r"\btgt_head_encoder\.(\d+)\.layers\.(\d)\.layers\.2\.",
     lambda m: f"tgt_head_res_{int(m.group(1)) - 1}.block{m.group(2)}.conv."),
    (r"\bin_conv\.layers\.0\.", r"in_conv.conv."),
    (r"\bin_conv\.layers\.1\.", r"in_conv.norm."),
    (r"\bdown\.(\d+)\.layers\.0\.layers\.0\.", r"down_\1.conv."),
    (r"\bdown\.(\d+)\.layers\.0\.layers\.1\.", r"down_\1.norm."),
    (r"\bup\.(\d+)\.layers\.1\.layers\.0\.", r"up_\1.conv."),
    (r"\bup\.(\d+)\.layers\.1\.layers\.1\.", r"up_\1.norm."),
    (r"\bres\.(\d+)\.layers\.(\d)\.layers\.0\.", r"res_\1.block\2.norm."),
    (r"\bres\.(\d+)\.layers\.(\d)\.layers\.2\.", r"res_\1.block\2.conv."),
    (r"\bocclusion_2_predictor\.0\.", r"occ2_pred_conv0."),
    (r"\bocclusion_2_predictor\.2\.", r"occ2_pred_conv1."),
    (r"\bocclusion_2_predictor\.4\.", r"occ2_pred_conv2."),
]


def _torso_leaf(parts: tuple[str, ...], arr: np.ndarray):
    leaf = parts[-1]
    if leaf == "weight":
        if arr.ndim == 5:  # Conv3d [out,in,kd,kh,kw] -> [kd,kh,kw,in,out]
            return ("params", parts[:-1] + ("kernel",),
                    np.ascontiguousarray(arr.transpose(2, 3, 4, 1, 0)))
        if arr.ndim == 4:  # Conv2d OIHW -> HWIO
            return ("params", parts[:-1] + ("kernel",),
                    np.ascontiguousarray(arr.transpose(2, 3, 1, 0)))
        if arr.ndim == 2:
            return ("params", parts[:-1] + ("kernel",),
                    np.ascontiguousarray(arr.T))
    return convert_leaf(parts, arr)


def convert_facev2v_torso(sd: Mapping) -> dict:
    """Reference ``WarpBasedTorsoModelMediaPipe``
    (`modules/real3d/facev2v_warp/model.py:198`) or any of its submodules ->
    the ``WarpBasedTorsoModel(norm_mode="affine")`` tree."""
    sd = {k: _to_np(v) for k, v in sd.items()}
    fold_spectral_norm(sd)
    fold_batchnorm_to_affine(sd)
    return convert_state_dict(sd, renames=_TORSO_RENAMES, leaf_fn=_torso_leaf)


# StyleGAN2-family submodules inside the SR-warp head keep eq-lr 'weight'
# params; everything else (torso nets, plain conv encoders) is Flax-builtin.
_SR_WARP_STYLEGAN_PREFIXES = ("block0", "block1", "head_torso_block")

_SR_WARP_RENAMES = _TORSO_RENAMES + [
    (r"\btorso_encoder\.0\.", r"torso_encoder."),
    (r"\bbg_encoder\.0\.", r"bg_enc_conv0."),
    (r"\bbg_encoder\.2\.", r"bg_enc_conv1."),
    (r"\bbg_encoder\.4\.", r"bg_enc_conv2."),
    (r"\bfuse_head_torso_convs\.0\.", r"fuse_ht_conv0."),
    (r"\bfuse_head_torso_convs\.2\.", r"fuse_ht_conv1."),
    (r"\bfuse_fg_bg_convs\.0\.", r"fuse_fb_conv0."),
    (r"\bfuse_fg_bg_convs\.2\.", r"fuse_fb_conv1."),
    (r"\bfuse_fg_bg_convs\.4\.", r"fuse_fb_conv2."),
]


def _sr_warp_leaf(parts: tuple[str, ...], arr: np.ndarray):
    if parts[0] in _SR_WARP_STYLEGAN_PREFIXES:
        return convert_leaf(parts, arr)
    return _torso_leaf(parts, arr)


def convert_sr_with_ref(sd: Mapping) -> dict:
    """Reference ``SuperresolutionHybrid8XDC_Warp``
    (`modules/real3d/super_resolution/sr_with_ref.py:16`) ->
    ``SuperresolutionHybrid8XDCWarp(torso_norm_mode="affine")``."""
    sd = {k: _to_np(v) for k, v in sd.items()}
    fold_spectral_norm(sd)
    fold_batchnorm_to_affine(sd)
    return convert_state_dict(
        sd, renames=_SR_WARP_RENAMES, leaf_fn=_sr_warp_leaf,
        # v3-only alpha predictor has no counterpart in fuse_mode v1/v2
        skip=[r"head_torso_alpha_predictor"],
    )


def convert_superresolution(sd: Mapping) -> dict:
    """Reference ``SuperresolutionHybrid8XDC`` (`superresolution.py:331`)."""
    return convert_state_dict(sd)


# ---------------------------------------------------------------------------
# audio2secc
# ---------------------------------------------------------------------------


def convert_audio2secc(sd: Mapping) -> dict:
    """Reference audio2secc (``PitchContourVAEModel``/``VAEModel``) ->
    ``PitchContourVAEModel(norm_mode="folded_bn")`` variables."""
    return convert_pitch_contour_vae(sd)


_VAE_RENAMES = [
    # WN internals (`flow_base.py:35-63`)
    (r"\bin_layers\.(\d+)\.", r"in_\1."),
    (r"\bres_skip_layers\.(\d+)\.", r"res_skip_\1."),
    # FVAE plumbing (`vae.py:99-188`): single-conv Sequentials
    (r"\bg_pre_net\.0\.", r"g_pre_net."),
    (r"\bencoder\.pre_net\.0\.", r"encoder.Conv_0."),
    (r"\bdecoder\.pre_net\.0\.", r"decoder.ConvTranspose_0."),
    # coupling flows interleave Flip (paramless): flows.0,2,4,6 -> flow_0..3
    (r"\bflows\.(\d+)\.", lambda m: f"flow_{int(m.group(1)) // 2}."),
    # cond encoders: Sequential(conv, BN, GELU, conv) after BN folding
    (r"\b(mel_encoder|pitch_encoder)\.0\.", r"\1_conv0."),
    (r"\b(mel_encoder|pitch_encoder)\.3\.", r"\1_conv1."),
]

# modules whose [out,in,k] / [in,out,k] conv1d weights go to Flax 'kernel'
_EMBED_MODULES = ("pitch_embed", "blink_embed")


def _vae_leaf(parts: tuple[str, ...], arr: np.ndarray):
    leaf = parts[-1]
    if leaf == "weight":
        if len(parts) >= 2 and parts[-2] in _EMBED_MODULES:
            return ("params", parts[:-1] + ("embedding",), arr)  # [N,fd]
        if arr.ndim == 3:
            if "ConvTranspose" in parts[-2]:  # torch [in,out,k] -> [k,in,out]
                arr = np.ascontiguousarray(arr.transpose(2, 0, 1))
            else:  # torch Conv1d [out,in,k] -> [k,in,out]
                arr = np.ascontiguousarray(arr.transpose(2, 1, 0))
            return ("params", parts[:-1] + ("kernel",), arr)
        if arr.ndim == 2:  # Linear [out,in] -> [in,out]
            return ("params", parts[:-1] + ("kernel",),
                    np.ascontiguousarray(arr.T))
    return convert_leaf(parts, arr)


def convert_pitch_contour_vae(sd: Mapping) -> dict:
    """Reference ``PitchContourVAEModel`` / ``VAEModel``
    (`modules/audio2motion/vae.py:272,340`) ->
    ``PitchContourVAEModel(norm_mode="folded_bn")``."""
    sd = {k: _to_np(v) for k, v in sd.items()}
    fold_weight_norm(sd)
    for enc in ("mel_encoder", "pitch_encoder"):
        if f"{enc}.1.running_mean" in sd:
            fold_batchnorm_into_conv(sd, f"{enc}.0", f"{enc}.1")
    return convert_state_dict(
        sd, renames=_VAE_RENAMES, skip=[r"num_batches_tracked"],
        leaf_fn=_vae_leaf,
    )


# ---------------------------------------------------------------------------
# The StyleGAN2 family
# ---------------------------------------------------------------------------


def convert_stylegan2_generator(sd: Mapping) -> dict:
    """Reference ``Generator`` (`networks_stylegan2.py:541`)."""
    return convert_state_dict(sd)


def convert_stylegan2_discriminator(sd: Mapping) -> dict:
    """Reference ``Discriminator`` (`networks_stylegan2.py:754`).

    The epilogue ``b4.fc`` consumes the flattened 4x4 conv map, so its weight
    needs the CHW->HWC input permutation on top of the generic transpose.
    """

    def leaf(parts, arr):
        if parts[-2:] == ("fc", "weight") and parts[-3].startswith("b") \
                and arr.ndim == 2:
            return ("params", parts, convert_flattened_fc_weight(arr, 4))
        return convert_leaf(parts, arr)

    return convert_state_dict(sd, leaf_fn=leaf)


def convert_mapping_network(sd: Mapping) -> dict:
    return convert_state_dict(sd)


# ---------------------------------------------------------------------------
# Perceptual, metric and audio networks
# ---------------------------------------------------------------------------


def convert_vgg19(sd: Mapping) -> dict:
    """torchvision ``vgg19().features`` state_dict -> the VGG19 perceptual
    weight tree of :mod:`real3dportrait_tpu_torch.models.perceptual` (keys
    ``'<i>.weight'`` OIHW -> ``conv<i>/kernel`` HWIO). Reference criterion:
    `tasks/os_avatar/loss_utils/vgg19_loss.py:9`."""
    from real3dportrait_tpu_torch.models.perceptual import VGG19_CONVS

    sd = {k.removeprefix("features."): v for k, v in sd.items()}
    tree = {}
    for idx, out_ch, _ in VGG19_CONVS:
        w = _to_np(sd[f"{idx}.weight"])
        assert w.shape[0] == out_ch, (idx, w.shape)
        tree[f"conv{idx}"] = {
            "kernel": np.transpose(w, (2, 3, 1, 0)),  # OIHW -> HWIO
            "bias": _to_np(sd[f"{idx}.bias"]),
        }
    return tree


def save_vgg19(tree: dict, path: str) -> None:
    """Persist a :func:`convert_vgg19` tree as msgpack for
    ``cfg['vgg19_ckpt']`` (``models/perceptual.load_tree``)."""
    from real3dportrait_tpu_torch.utils.msgpack_ckpt import msgpack_serialize

    with open(path, "wb") as f:
        f.write(msgpack_serialize(tree))


_SYNCNET_RENAMES = [
    # torch tower Sequential index i, Conv1d block = Sequential(conv, bn)
    # (`modules/syncnet/models.py:8-14`)
    (r"\b(hubert_encoder|mouth_encoder)\.(\d+)\.conv_block\.0\.",
     r"\1.layer_\2.Conv_0."),
    (r"\b(hubert_encoder|mouth_encoder)\.(\d+)\.conv_block\.1\.",
     r"\1.layer_\2.norm."),
]


def _syncnet_leaf(parts: tuple[str, ...], arr: np.ndarray):
    leaf = parts[-1]
    if leaf == "weight" and arr.ndim == 3:  # Conv1d [out,in,k] -> [k,in,out]
        return ("params", parts[:-1] + ("kernel",),
                np.ascontiguousarray(arr.transpose(2, 1, 0)))
    return convert_leaf(parts, arr)


def convert_syncnet(sd: Mapping) -> dict:
    """Reference ``LandmarkHubertSyncNet`` (`modules/syncnet/models.py:58`) ->
    the ``LandmarkHubertSyncNet(norm_mode="affine")`` tree. The shipped
    lineage uses lm_dim=1404 (468 mediapipe landmarks x 3,
    `egs/os_avatar/audio_lm3d_syncnet.yaml:19`)."""
    sd = {k: _to_np(v) for k, v in sd.items()
          if not k.startswith(("logit_scale", "clip_loss"))}
    fold_batchnorm_to_affine(sd)
    return convert_state_dict(sd, renames=_SYNCNET_RENAMES,
                              leaf_fn=_syncnet_leaf)


def convert_vggface(sd: Mapping) -> dict:
    """VGGFace weights -> the VGGFace branch tree of ``perceptual_v2``.

    Accepts either the vgg_face_dag layout (``conv1_1.weight`` ...,
    `facev2v_warp/losses.py:76-96` remaps it) or an already-remapped
    torchvision-style ``features.<i>.weight`` layout."""
    from real3dportrait_tpu_torch.models.perceptual import VGGFACE_CONVS

    sd = {k.removeprefix("features."): _to_np(v) for k, v in sd.items()}
    if "conv1_1.weight" in sd:  # vgg_face_dag naming -> feature indices
        dag_map = {0: "conv1_1", 2: "conv1_2", 5: "conv2_1", 7: "conv2_2",
                   10: "conv3_1", 12: "conv3_2", 14: "conv3_3",
                   17: "conv4_1", 19: "conv4_2", 21: "conv4_3",
                   24: "conv5_1", 26: "conv5_2", 28: "conv5_3"}
        sd = {f"{i}.{leaf}": sd[f"{name}.{leaf}"]
              for i, name in dag_map.items() for leaf in ("weight", "bias")
              if f"{name}.{leaf}" in sd}
    tree = {}
    for idx, out_ch, _ in VGGFACE_CONVS:
        w = sd[f"{idx}.weight"]
        assert w.shape[0] == out_ch, (idx, w.shape)
        tree[f"conv{idx}"] = {
            "kernel": np.transpose(w, (2, 3, 1, 0)),
            "bias": sd[f"{idx}.bias"],
        }
    return tree


def convert_lpips_vgg(sd: Mapping) -> dict:
    """``lpips.LPIPS(net='vgg', lpips=True)`` state_dict -> the
    :func:`real3dportrait_tpu_torch.models.perceptual.lpips_vgg` tree.

    Expected keys: ``net.slice{1..5}.<i>.weight`` (torchvision vgg16 feature
    indices preserved inside slices) and ``lin{k}.model.1.weight``
    ([1,C,1,1] non-negative 1x1 convs). The scaling-layer shift/scale are
    fixed constants baked into ``lpips_vgg``."""
    from real3dportrait_tpu_torch.models.perceptual import LPIPS_VGG16_CONVS

    flat = {}
    for k, v in sd.items():
        m = re.match(r"net\.slice\d+\.(\d+)\.(weight|bias)$", k)
        if m:
            flat[f"{m.group(1)}.{m.group(2)}"] = _to_np(v)
    tree = {}
    for idx, out_ch, _ in LPIPS_VGG16_CONVS:
        w = flat[f"{idx}.weight"]
        assert w.shape[0] == out_ch, (idx, w.shape)
        tree[f"conv{idx}"] = {
            "kernel": np.transpose(w, (2, 3, 1, 0)),
            "bias": flat[f"{idx}.bias"],
        }
    for k in range(5):
        w = _to_np(sd[f"lin{k}.model.1.weight"])  # [1,C,1,1]
        tree[f"lin{k}"] = {"kernel": w.reshape(w.shape[1], 1)}
    return tree


def convert_hubert(sd: Mapping) -> dict:
    """HF ``HubertModel`` state dict -> the ``HubertEncoder`` tree
    (``real3dportrait_tpu_torch/audio/hubert.py``; replaces the host-torch
    call of `data_gen/utils/process_audio/extract_hubert.py:19`).

    Handles both feat_extract_norm families and both torch weight-norm
    layouts of the positional conv (classic ``weight_g``/``weight_v`` and
    parametrizations ``original0``/``original1``).
    """
    sd = {k: _to_np(v) for k, v in sd.items()}
    sd = {k.removeprefix("hubert.").removeprefix("model."): v
          for k, v in sd.items()}
    p: dict = {}

    def put(path, arr):
        _set_path(p, path, np.asarray(arr))

    # --- conv feature extractor -------------------------------------------
    i = 0
    while f"feature_extractor.conv_layers.{i}.conv.weight" in sd:
        w = sd[f"feature_extractor.conv_layers.{i}.conv.weight"]  # [O,I,K]
        put(("feature_extractor", f"conv_{i}", "kernel"),
            w.transpose(2, 1, 0))
        ln_w = sd.get(f"feature_extractor.conv_layers.{i}.layer_norm.weight")
        if ln_w is not None:
            ln_b = sd[f"feature_extractor.conv_layers.{i}.layer_norm.bias"]
            # group mode only has it on conv 0 and it is a GroupNorm
            is_group = (i == 0 and
                        "feature_extractor.conv_layers.1.layer_norm.weight"
                        not in sd)
            name = "gn_0" if is_group else f"ln_{i}"
            put(("feature_extractor", name, "scale"), ln_w)
            put(("feature_extractor", name, "bias"), ln_b)
        i += 1

    # --- feature projection ------------------------------------------------
    if "feature_projection.layer_norm.weight" in sd:
        put(("feat_ln", "scale"), sd["feature_projection.layer_norm.weight"])
        put(("feat_ln", "bias"), sd["feature_projection.layer_norm.bias"])
    put(("feat_proj", "kernel"), sd["feature_projection.projection.weight"].T)
    put(("feat_proj", "bias"), sd["feature_projection.projection.bias"])

    # --- positional conv embedding (weight-norm folded, dim=2) -------------
    if "encoder.pos_conv_embed.conv.weight_g" in sd:
        g = sd["encoder.pos_conv_embed.conv.weight_g"]
        v = sd["encoder.pos_conv_embed.conv.weight_v"]
    else:
        g = sd["encoder.pos_conv_embed.conv.parametrizations.weight.original0"]
        v = sd["encoder.pos_conv_embed.conv.parametrizations.weight.original1"]
    norm = np.sqrt(np.sum(np.square(v), axis=(0, 1), keepdims=True))
    w = g * v / np.maximum(norm, 1e-12)  # [O, I/g, K]
    put(("pos_conv", "conv", "kernel"), w.transpose(2, 1, 0))
    put(("pos_conv", "conv", "bias"), sd["encoder.pos_conv_embed.conv.bias"])

    # --- encoder ------------------------------------------------------------
    put(("encoder_ln", "scale"), sd["encoder.layer_norm.weight"])
    put(("encoder_ln", "bias"), sd["encoder.layer_norm.bias"])
    li = 0
    while f"encoder.layers.{li}.attention.q_proj.weight" in sd:
        pre = f"encoder.layers.{li}"
        hidden = sd[f"{pre}.attention.q_proj.weight"].shape[0]
        # infer head count from the model width (HF convention 64-d heads)
        heads = max(1, hidden // 64)
        hd = hidden // heads
        for tname, fname in (("q_proj", "query"), ("k_proj", "key"),
                             ("v_proj", "value")):
            w = sd[f"{pre}.attention.{tname}.weight"]  # [H, H]
            b = sd[f"{pre}.attention.{tname}.bias"]
            put((f"layer_{li}", "attention", fname, "kernel"),
                w.T.reshape(hidden, heads, hd))
            put((f"layer_{li}", "attention", fname, "bias"),
                b.reshape(heads, hd))
        wo = sd[f"{pre}.attention.out_proj.weight"]  # [H, H]
        put((f"layer_{li}", "attention", "out", "kernel"),
            wo.T.reshape(heads, hd, hidden))
        put((f"layer_{li}", "attention", "out", "bias"),
            sd[f"{pre}.attention.out_proj.bias"])
        put((f"layer_{li}", "ln_attn", "scale"), sd[f"{pre}.layer_norm.weight"])
        put((f"layer_{li}", "ln_attn", "bias"), sd[f"{pre}.layer_norm.bias"])
        put((f"layer_{li}", "ln_ffn", "scale"),
            sd[f"{pre}.final_layer_norm.weight"])
        put((f"layer_{li}", "ln_ffn", "bias"),
            sd[f"{pre}.final_layer_norm.bias"])
        put((f"layer_{li}", "ffn_in", "kernel"),
            sd[f"{pre}.feed_forward.intermediate_dense.weight"].T)
        put((f"layer_{li}", "ffn_in", "bias"),
            sd[f"{pre}.feed_forward.intermediate_dense.bias"])
        put((f"layer_{li}", "ffn_out", "kernel"),
            sd[f"{pre}.feed_forward.output_dense.weight"].T)
        put((f"layer_{li}", "ffn_out", "bias"),
            sd[f"{pre}.feed_forward.output_dense.bias"])
        li += 1
    return {"params": p}


def convert_inception(sd: Mapping) -> dict:
    """torchvision/pytorch-fid ``inception_v3`` state dict -> the
    ``InceptionV3Features`` tree (BN eps=1e-3 folded to per-channel affine).

    Key layout: ``<block>.<branch>.conv.weight`` + ``.bn.{weight,bias,
    running_mean,running_var}`` (torchvision naming, which pytorch-fid
    reuses). AuxLogits/fc are ignored (FID uses pool3 features only).
    """
    sd = {k: _to_np(v) for k, v in sd.items()
          if not k.startswith(("AuxLogits", "fc."))}
    p: dict = {}
    bases = sorted({k[: -len(".conv.weight")] for k in sd
                    if k.endswith(".conv.weight")})
    for base in bases:
        w = sd[f"{base}.conv.weight"]  # [O,I,kh,kw]
        gamma = sd[f"{base}.bn.weight"]
        beta = sd[f"{base}.bn.bias"]
        mean = sd[f"{base}.bn.running_mean"]
        var = sd[f"{base}.bn.running_var"]
        scale = gamma / np.sqrt(var + 1e-3)  # torchvision BasicConv2d eps
        path = tuple(base.split("."))
        _set_path(p, path + ("conv", "kernel"),
                  np.ascontiguousarray(w.transpose(2, 3, 1, 0)))
        _set_path(p, path + ("bn_scale",), scale)
        _set_path(p, path + ("bn_bias",), beta - mean * scale)
    return {"params": p}


# ---------------------------------------------------------------------------
# CLI: torch .ckpt files -> msgpack checkpoints that both packages read
# ---------------------------------------------------------------------------


def _save_native_ckpt(out_dir: str, payload: dict, step: int) -> str:
    import os

    from real3dportrait_tpu_torch.utils.msgpack_ckpt import msgpack_serialize

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"model_ckpt_steps_{step}.ckpt")
    with open(path, "wb") as f:
        f.write(msgpack_serialize(payload))
    return path


def _ckpt_step(ckpt_path: str, ckpt: dict) -> int:
    m = re.search(r"steps_(\d+)\.ckpt", ckpt_path)
    if m:
        return int(m.group(1))
    return int(ckpt.get("global_step", 0))


def main(argv=None) -> None:
    """Convert released reference checkpoints for both packages.

    Example::

        python -m real3dportrait_tpu_torch.tools.convert_torch_ckpt \\
            --audio2secc checkpoints/240210_real3dportrait_orig/audio2secc_vae \\
            --secc2video checkpoints/240210_real3dportrait_orig/secc2plane_torso \\
            --out checkpoints/converted

    Then run inference with ``configs/real3d_orig.yaml`` pointing the
    pipeline at ``<out>/audio2secc`` / ``<out>/secc2video``.
    """
    import argparse
    import glob
    import os

    import torch

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--audio2secc", default="", help="torch ckpt file or dir")
    p.add_argument("--secc2video", default="", help="torch ckpt file or dir")
    p.add_argument("--backbone_mode", default="composite",
                   choices=["composite", "segformer"])
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    def resolve(path):
        if os.path.isdir(path):
            cands = sorted(glob.glob(os.path.join(path, "model_ckpt_steps_*.ckpt")))
            if not cands:
                raise FileNotFoundError(f"no model_ckpt_steps_*.ckpt in {path}")
            path = cands[-1]
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        return path, ckpt

    if args.audio2secc:
        path, ckpt = resolve(args.audio2secc)
        sd = load_torch_state_dict(path, "model")
        conv = convert_audio2secc(sd)
        step = _ckpt_step(path, ckpt)
        payload = {"step": step,
                   "params": {"model": conv["params"]},
                   "variables": {k: v for k, v in conv.items() if k != "params"}}
        out = _save_native_ckpt(os.path.join(args.out, "audio2secc"), payload, step)
        print(f"| audio2secc: {path} -> {out} ({len(sd)} tensors)")

    if args.secc2video:
        path, ckpt = resolve(args.secc2video)
        sd = load_torch_state_dict(path, "model")
        conv = convert_secc2video(sd, backbone_mode=args.backbone_mode)
        extras = conv.pop("task_extra", {})
        step = _ckpt_step(path, ckpt)
        payload = {"step": step,
                   "params": {"gen": conv["params"]},
                   "variables": {k: v for k, v in conv.items() if k != "params"},
                   "task_extra": extras}
        out = _save_native_ckpt(os.path.join(args.out, "secc2video"), payload, step)
        print(f"| secc2video: {path} -> {out} ({len(sd)} tensors)")


if __name__ == "__main__":
    main()

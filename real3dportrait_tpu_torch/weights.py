"""Weights across the two packages, and seeded mock weights.

The port names its parameters after the JAX package's Flax tree (which
reuses the reference torch names), so converting is a walk over the tree
with shape-directed transforms, the reverse of the port's
``tools/convert_torch_ckpt.py:convert_leaf``:

* Flax ``kernel`` / StyleGAN ``weight`` of rank 4: HWIO -> OIHW;
* of rank 5 (``Conv3D`` and 3D ``nn.Conv``): ``[kd,kh,kw,ci,co]`` ->
  ``[co,ci,kd,kh,kw]``;
* of rank 3 (1-D ``nn.Conv``, grouped or not, and ``nn.ConvTranspose``,
  whose port keeps a Conv1d's layout): ``[k,ci,co]`` -> ``[co,ci,k]``;
* of rank 2: ``[in, out]`` -> ``[out, in]``;
* ``MultiHeadDotProductAttention``'s projections: query/key/value kernels
  ``[in,heads,hd]`` -> ``[heads*hd,in]`` and biases ``[heads,hd]`` ->
  ``[heads*hd]``, the output kernel ``[heads,hd,out]`` -> ``[out,heads*hd]``;
* Flax ``scale`` -> ``weight`` (LayerNorm, GroupNorm and the folded
  per-channel BatchNorm affines, whose values carry over as they are);
* ``nn.Embed``'s ``embedding`` -> ``weight``;
* bare parameters (``mouth_amp_embed``) as they are;
* a const-input StyleGAN block's ``const`` ``[res,res,C]`` -> ``[C,res,res]``;
* the ``noise_const`` collection's ``.../noise`` -> buffer ``noise_const``;
* the ``ema`` collection's ``.../w_avg`` (a mapping network's w average)
  -> buffer ``w_avg``.

:func:`jax_variables_from_torch` is the reverse walk, over the port's
modules: it gives the Flax tree a checkpoint of the JAX package holds.
Leaves of the JAX package's checkpoints may also be ``torch`` tensors
(``utils/msgpack_ckpt.py`` reads bf16 leaves as such).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn

from real3dportrait_tpu_torch.models.audio2motion import PitchContourVAEModel
from real3dportrait_tpu_torch.models.img2plane import SameBlock3d
from real3dportrait_tpu_torch.models.img2plane_composite import ChannelAffine
from real3dportrait_tpu_torch.models.stylegan2 import (
    Conv2dLayer,
    FullyConnectedLayer,
    SynthesisBlock,
    SynthesisLayer,
    ToRGBLayer,
)


def _leaves(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


_ATTENTION = ("query", "key", "value", "out")


def torch_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax variables (``{"params": ..., "noise_const": ...}`` as nested
    dicts of arrays, or a bare params tree) -> the port's ``state_dict``.
    A leaf that has only a ``shape`` (``jax.eval_shape``'s structs) gives a
    meta tensor of the converted shape: names and shapes, no weights."""
    if "params" not in variables:
        variables = {"params": variables}
    out: dict[str, torch.Tensor] = {}
    for coll, tree in variables.items():
        for path, arr in _leaves(tree):
            has_data = hasattr(arr, "__array__")
            if torch.is_tensor(arr):
                a = arr.detach().float().numpy()
            elif has_data:
                a = np.asarray(arr, dtype=np.float32)
            else:
                a = np.broadcast_to(np.float32(0), tuple(arr.shape))
            leaf = path[-1]
            if coll == "noise_const":
                leaf = "noise_const"
            elif coll == "ema":
                if leaf != "w_avg":
                    raise ValueError(f"unexpected ema variable {'.'.join(path)!r}")
            elif coll != "params":
                raise ValueError(f"unexpected variable collection {coll!r}")
            elif len(path) >= 3 and path[-3] == "attention" and path[-2] in _ATTENTION:
                if path[-2] == "out":                  # [heads,hd,out]
                    a = a.reshape(-1, a.shape[-1]).T if leaf == "kernel" else a
                elif leaf == "kernel":                 # [in,heads,hd]
                    a = a.reshape(a.shape[0], -1).T
                else:                                  # bias [heads,hd]
                    a = a.reshape(-1)
                leaf = "weight" if leaf == "kernel" else leaf
            elif leaf in ("kernel", "weight"):
                if a.ndim == 5:
                    a = a.transpose(4, 3, 0, 1, 2)
                elif a.ndim == 4:
                    a = a.transpose(3, 2, 0, 1)
                elif a.ndim == 3:
                    a = a.transpose(2, 1, 0)
                elif a.ndim == 2:
                    a = a.T
                leaf = "weight"
            elif leaf in ("scale", "embedding"):
                leaf = "weight"
            elif leaf == "const" and a.ndim == 3:    # [res,res,C]
                a = a.transpose(2, 0, 1)
            # np.array (not ascontiguousarray) keeps 0-d leaves 0-d
            out[".".join(path[:-1] + (leaf,))] = (
                torch.from_numpy(np.array(a, order="C")) if has_data
                else torch.empty(a.shape, device="meta"))
    return out


_NORMS = (nn.LayerNorm, nn.GroupNorm, ChannelAffine)
_STYLED = (FullyConnectedLayer, Conv2dLayer, SynthesisLayer, ToRGBLayer)
# the port's weight layouts -> Flax's, by rank (the reverse of the transposes above)
_TO_FLAX = {5: (2, 3, 4, 1, 0), 4: (2, 3, 1, 0), 3: (2, 1, 0), 2: (1, 0)}


def _set(tree: dict, path: list, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def jax_variables_from_torch(model: nn.Module,
                             state: Mapping[str, torch.Tensor] | None = None
                             ) -> dict[str, dict]:
    """The port's ``model`` -> the Flax variables of the JAX package's twin
    (``{"params": ..., "noise_const": ..., "ema": ...}``, the latter two only
    where the model has noise or w-average buffers) as nested dicts of
    numpy arrays: the reverse
    of :func:`torch_state_dict_from_jax`. The leaf names come from the
    module each parameter belongs to: norms and affines ``scale``,
    embeddings ``embedding``, the StyleGAN layers ``weight``, attention
    projections ``kernel`` in Flax's per-head shapes, every other weight
    ``kernel``. ``state`` (tensors by parameter name, e.g. an optimiser's
    moments) replaces ``model.state_dict()`` as the values laid out."""
    modules = dict(model.named_modules())
    out: dict[str, dict] = {"params": {}}
    for name, t in (model.state_dict() if state is None else state).items():
        *prefix, leaf = name.split(".")
        a = t.detach().float().cpu().numpy()
        if leaf == "noise_const":
            _set(out.setdefault("noise_const", {}), prefix + ["noise"], np.array(a, order="C"))
            continue
        if leaf == "w_avg":
            _set(out.setdefault("ema", {}), prefix + ["w_avg"], np.array(a, order="C"))
            continue
        mod = modules[".".join(prefix)]
        parent = modules.get(".".join(prefix[:-1]))
        if len(prefix) >= 2 and prefix[-2] == "attention" and prefix[-1] in _ATTENTION:
            heads = parent.heads
            if prefix[-1] == "out":
                a = a.T.reshape(heads, -1, a.shape[0]) if leaf == "weight" else a
            elif leaf == "weight":
                a = a.T.reshape(a.shape[1], heads, -1)
            else:
                a = a.reshape(heads, -1)
            leaf = "kernel" if leaf == "weight" else leaf
        elif leaf == "weight" and isinstance(mod, _NORMS):
            leaf = "scale"
        elif leaf == "weight" and isinstance(mod, nn.Embedding):
            leaf = "embedding"
        elif leaf == "const" and isinstance(mod, SynthesisBlock):
            a = a.transpose(1, 2, 0)
        elif leaf == "weight":
            if a.ndim >= 2:
                a = a.transpose(_TO_FLAX[a.ndim])
            leaf = "weight" if isinstance(mod, _STYLED) else "kernel"
        # np.array (not ascontiguousarray) keeps 0-d leaves 0-d
        _set(out["params"], prefix + [leaf], np.array(a, order="C"))
    return out


def tensors_by_name(module: nn.Module, tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A Flax parameter tree of ``module`` (its parameters, or an
    optimiser's moments of them) -> tensors by parameter name, each on its
    parameter's device and dtype; raises where the names differ."""
    params = dict(module.named_parameters())
    state = torch_state_dict_from_jax({"params": tree})
    if set(state) != set(params):
        raise KeyError(f"tree names differ from the parameters': "
                       f"{sorted(set(state) ^ set(params))[:5]}")
    return {n: v.to(params[n].device, params[n].dtype).contiguous() for n, v in state.items()}


def load_jax_variables(module: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Load Flax ``variables`` (``{"params": ..., <collection>: ...}``) into
    the port's ``module`` through :func:`torch_state_dict_from_jax`,
    strictly: a missing, unexpected or mis-shaped key raises and names it.
    A collection that ``variables`` lacks (``noise_const``, ``ema``) keeps
    the module's own values, as the JAX package keeps its init there."""
    state = torch_state_dict_from_jax(variables)
    state.update(_buffers_missing_from(variables, module))
    module.load_state_dict(state, strict=True)
    return module


_BUFFER_COLLECTIONS = {"noise_const": "noise_const", "ema": "w_avg"}


def _buffers_missing_from(variables: Mapping[str, Any], module: nn.Module
                         ) -> dict[str, torch.Tensor]:
    """``module``'s own buffers of the variable collections ``variables``
    lacks (noise constants, w averages), to complete a strict load."""
    leaves = tuple(leaf for coll, leaf in _BUFFER_COLLECTIONS.items() if coll not in variables)
    return {k: v for k, v in module.state_dict().items() if k.rsplit(".", 1)[-1] in leaves}


def mock_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every parameter of ``model`` from ``generator`` in place, with
    the JAX package's initialisers: StyleGAN layers N(0,1) weights with their
    bias inits and N(0,1) noise buffers; other convs and dense layers
    lecun-normal weights and zero biases (all zeros where the JAX layer is
    zero-initialised, ``zero_init``); embeddings N(0, 1/features); norms
    and affines ones and zeros; the residual scale of ``SameBlock3d`` 0.01;
    the amplitude embeddings of the audio-to-motion model and the constant
    of a first StyleGAN block N(0,1)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, _STYLED) or (isinstance(mod, SynthesisBlock)
                                            and mod.in_channels == 0):
                mod.reset_parameters(generator)
            elif isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.Linear)):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(generator=generator).mul_(fan_in ** -0.5)
                if getattr(mod, "zero_init", False):
                    mod.weight.zero_()
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(generator=generator).mul_(mod.weight.shape[1] ** -0.5)
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm, ChannelAffine)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, SameBlock3d):
                mod.alpha.fill_(0.01)
            elif isinstance(mod, PitchContourVAEModel):
                for p in (mod.mouth_amp_embed, mod.eye_amp_embed):
                    if p is not None:
                        p.normal_(generator=generator)
    return model


# --- the evaluation metrics' networks ---------------------------------------------


def inception_from_jax(variables: Mapping[str, Any]) -> nn.Module:
    """A ``convert_inception`` tree (``{"params": ...}``, or JAX's Flax
    variables of ``InceptionV3Features``) -> the port's network holding it,
    loaded strictly, in eval mode on the CPU."""
    from real3dportrait_tpu_torch.metrics.inception import InceptionV3Features

    return load_jax_variables(InceptionV3Features(), variables).eval()


def lpips_weights_from_jax(tree: Mapping[str, Any], device) -> tuple:
    """A ``convert_lpips_vgg`` tree (``conv<i>``: HWIO ``kernel``, ``bias``;
    ``lin<k>``: ``kernel`` [C,1]) -> ``models/perceptual.lpips_vgg``'s
    weights on ``device``: ({idx: (OIHW weight, bias)}, [lin_k [C]])."""
    from real3dportrait_tpu_torch.models.perceptual import LPIPS_VGG16_CONVS, conv_weights

    n_taps = sum(tap for _, _, tap in LPIPS_VGG16_CONVS)
    lins = [torch.as_tensor(np.asarray(tree[f"lin{k}"]["kernel"], np.float32)).reshape(-1)
            .to(device) for k in range(n_taps)]
    return conv_weights(tree, device, LPIPS_VGG16_CONVS), lins


def random_projection_from_jax(w1, w2, w_out) -> tuple:
    """The JAX random-projection extractor's arrays (HWIO ``w1`` [5,5,3,32],
    ``w2`` [3,3,32,64], ``w_out`` [128,D]) as fp32 CPU tensors in the same
    layout, for ``metrics/gan_metrics.make_random_projection_extractor(
    weights=...)``."""
    return tuple(torch.as_tensor(np.asarray(w, np.float32)) for w in (w1, w2, w_out))

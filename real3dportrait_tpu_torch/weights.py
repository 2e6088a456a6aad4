"""Weights across the two packages, and seeded mock weights.

The port names its parameters after the JAX package's Flax tree (which
reuses the reference torch names), so converting is a walk over the tree
with shape-directed transforms, the reverse of
``tools/convert_torch_ckpt.py:convert_leaf``:

* Flax ``kernel`` / StyleGAN ``weight`` of rank 4: HWIO -> OIHW;
* of rank 5 (``Conv3D`` and 3D ``nn.Conv``): ``[kd,kh,kw,ci,co]`` ->
  ``[co,ci,kd,kh,kw]``;
* of rank 2: ``[in, out]`` -> ``[out, in]``;
* Flax ``scale`` -> ``weight`` (LayerNorm, GroupNorm and the folded
  per-channel BatchNorm affines, whose values carry over as they are);
* the ``noise_const`` collection's ``.../noise`` -> buffer ``noise_const``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn

from real3dportrait_tpu_torch.models.img2plane_composite import ChannelAffine
from real3dportrait_tpu_torch.models.stylegan2 import (
    Conv2dLayer,
    FullyConnectedLayer,
    SynthesisLayer,
    ToRGBLayer,
)


def _leaves(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def torch_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax variables (``{"params": ..., "noise_const": ...}`` as nested
    dicts of arrays, or a bare params tree) -> the port's ``state_dict``."""
    if "params" not in variables:
        variables = {"params": variables}
    out: dict[str, torch.Tensor] = {}
    for coll, tree in variables.items():
        for path, arr in _leaves(tree):
            a = np.asarray(arr, dtype=np.float32)
            if coll == "noise_const":
                out[".".join(path[:-1] + ("noise_const",))] = torch.from_numpy(a.copy())
                continue
            if coll != "params":
                raise ValueError(f"unexpected variable collection {coll!r}")
            leaf = path[-1]
            if leaf in ("kernel", "weight"):
                if a.ndim == 5:
                    a = a.transpose(4, 3, 0, 1, 2)
                elif a.ndim == 4:
                    a = a.transpose(3, 2, 0, 1)
                elif a.ndim == 2:
                    a = a.T
                leaf = "weight"
            elif leaf == "scale":
                leaf = "weight"
            # np.array (not ascontiguousarray) keeps 0-d leaves 0-d
            out[".".join(path[:-1] + (leaf,))] = torch.from_numpy(np.array(a, order="C"))
    return out


def mock_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every parameter of ``model`` from ``generator`` in place, with
    the JAX package's initialisers: StyleGAN layers N(0,1) weights with their
    bias inits and N(0,1) noise buffers; other convs and dense layers
    lecun-normal weights and zero biases; norms and affines ones and zeros."""
    styled = (FullyConnectedLayer, Conv2dLayer, SynthesisLayer, ToRGBLayer)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, styled):
                mod.reset_parameters(generator)
            elif isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.Linear)):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(generator=generator).mul_(fan_in ** -0.5)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm, ChannelAffine)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
    return model

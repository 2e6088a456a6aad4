"""Shared helpers of the training parity tests (tests/test_torch_train_*.py):
the tiny GAN config, the JAX task and a seeded JAX train state made without
the init's compile, the port's task and state carrying the same weights,
and the record of the JAX step's random draws (which the port replays
through ``utils/draws.ReplayDraws``)."""

from __future__ import annotations

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from real3dportrait_tpu.config import load_config as jax_load_config
from real3dportrait_tpu.training.tasks.base_task import resolve_task as jax_resolve_task
from real3dportrait_tpu.training.train_state import TrainState as JaxTrainState
from real3dportrait_tpu_torch.config import load_config
from real3dportrait_tpu_torch.training.tasks.base_task import resolve_task
from tests._torch_parity import random_like

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "secc_img2plane.yaml")
TORSO_CONFIG = os.path.join(ROOT, "configs", "secc_img2plane_torso.yaml")

# tests/test_training.py's tiny GAN, copied
TINY_GAN = {
    "batch_size": 2,
    "final_resolution": 32,
    "neural_rendering_resolution": 8,
    "triplane_hid_dim": 8,
    "triplane_depth": 2,
    "num_samples_coarse": 6,
    "num_samples_fine": 6,
    "sr_channel0": 16,
    "sr_channel1": 8,
    "base_channel": 256,
    "max_channel": 32,
    "num_fp16_layers_in_discriminator": 0,
    "num_fp16_layers_in_super_resolution": 0,
    "group_size_for_mini_batch_std": 2,
    "reg_interval_g": 2,
    "reg_interval_d": 2,
    "reg_interval_g_cond": 2,
    "update_src2src_interval": 2,
    "target_pertube_secc_loss": 1e-6,
    "target_pertube_blink_secc_loss": 1e-6,
    "start_adv_iters": 0,
    "stop_update_i2p_iters": 100,
    "group_warmup_iters": 0,
    "start_update_sr_iters": 0,
    "mesh_shape": {"data": -1},
}


def tasks(overrides: dict | None = None, config: str = CONFIG):
    """(JAX task, port task on the CPU) of the tiny config (of ``config``,
    the flagship's by default)."""
    over = {**TINY_GAN, **(overrides or {})}
    jtask = jax_resolve_task(jax_load_config(config, overrides=over))
    ptask = resolve_task(load_config(config, over), torch.device("cpu"))
    return jtask, ptask


def jax_state(jtask, batch: dict, seed: int = 0, lambdas=(0.1, 0.2)) -> JaxTrainState:
    """A JAX train state with seeded leaves on the inits' trees (no init
    compile; ``random_like`` scales them so activations stay O(1))."""
    res = jtask.gen.neural_rendering_resolution
    gshape = jax.eval_shape(lambda: jtask.gen.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        batch["src_img"], batch["camera"], secc=batch["secc_cond"],
        **jtask._gen_apply_kwargs(batch)))
    dshape = jax.eval_shape(lambda: jtask.disc.init(
        jax.random.PRNGKey(2), batch["tgt_img"], batch["tgt_img"][:, :res, :res],
        batch["camera"]))
    gv, dv = random_like(gshape, seed), random_like(dshape, seed + 1)
    params = {"gen": gv["params"], "disc": dv["params"],
              "gen_ema": jax.tree_util.tree_map(lambda x: np.array(x) * 0.5, gv["params"])}
    params = jax.tree_util.tree_map(jnp.asarray, params)
    return JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        variables={k: jax.tree_util.tree_map(jnp.asarray, v)
                   for k, v in gv.items() if k != "params"},
        opt_states={"gen": jtask.opt_g.init(params["gen"]),
                    "disc": jtask.opt_d.init(params["disc"])},
        extra={"lambda_pertube_secc": jnp.asarray(lambdas[0], jnp.float32),
               "lambda_pertube_blink_secc": jnp.asarray(lambdas[1], jnp.float32)})


def port_state(ptask, jstate: JaxTrainState):
    """The port's state carrying ``jstate`` (through the checkpoint tree)."""
    from flax import serialization

    state = ptask.build(0)
    state.load_state_dict(jax.tree_util.tree_map(
        np.asarray, serialization.to_state_dict(jstate)))
    return state


def record_draws():
    """Wrap ``jax.random.uniform`` / ``normal`` / ``randint`` / ``bernoulli``
    so that a run records every draw it makes (through ordered debug
    callbacks, so jitted calls record them at execution, in order; draws
    only traced, as flax's initialisers in ``apply``, record nothing).
    ``randint`` records its integers (kind ``integers``); ``bernoulli``
    records the uniform draw it compares with ``p`` (JAX draws ``uniform(key,
    shape) < p``), which the port draws as a uniform. Returns (records,
    restore)."""
    records: list = []
    names = ("uniform", "normal", "randint", "bernoulli")
    real = {k: getattr(jax.random, k) for k in names}

    def keep(kind, r):
        jax.debug.callback(lambda v: records.append((kind, np.asarray(v))), r, ordered=True)

    def wrap(kind):
        def fn(*args, **kwargs):
            r = real[kind](*args, **kwargs)
            keep("integers" if kind == "randint" else kind, r)
            return r
        return fn

    def bernoulli(key, p=0.5, shape=None):
        keep("uniform", real["uniform"](key, jnp.shape(p) if shape is None else shape))
        return real["bernoulli"](key, p, shape)

    for k in names[:3]:
        setattr(jax.random, k, wrap(k))
    jax.random.bernoulli = bernoulli

    def restore():
        for k in names:
            setattr(jax.random, k, real[k])

    return records, restore


def tree_of(module, named: dict) -> dict:
    """Tensors by parameter name -> the Flax parameter tree."""
    from real3dportrait_tpu_torch.weights import jax_variables_from_torch

    return jax_variables_from_torch(module, named)["params"]


def reorder_bound(n_terms: int, magnitude: float) -> float:
    """The largest difference of two fp32 sums of the same ``n_terms``
    terms taken in two tree (pairwise or blocked) orders: each lies within
    ``ceil(log2 n) * 2^-24 * sum|terms|`` of the exact sum, so the two lie
    within twice that of each other. ``magnitude`` is sum|terms|."""
    return 2 * math.ceil(math.log2(max(n_terms, 2))) * 2.0 ** -24 * magnitude


class NoiseStrengthTerms:
    """The terms of every ``noise_strength`` gradient of a port run on the
    CPU. The gradient of a StyleGAN2 layer's noise strength is one scalar
    sum over batch, channels and pixels of ``dz * n``, ``dz`` the gradient
    at the noise add and ``n`` the unit noise (``noise_const`` or the
    layer's draw); its terms cancel (their magnitudes may sum to a hundred
    times the result), so the result's last bits depend on the order of the
    sum. Inside the context, each ``SynthesisLayer``'s noise (``n`` times
    the strength, which must not be 0) reaches the plain epilogue broadcast
    to ``x``'s shape, with a hook that keeps ``dz`` (the same values and
    the same sum as the broadcast add). ``bounds(root, prefix)`` then gives
    {leaf path: ``reorder_bound(terms, sum|dz * n|)``} for the layers under
    the module ``root``, with the paths of
    ``jax.tree_util.tree_leaves_with_path`` under ``prefix``."""

    def __enter__(self):
        from real3dportrait_tpu_torch.models import stylegan2 as sg
        from real3dportrait_tpu_torch.ops import bias_act as ba

        self.seen: list = []       # (layer, dz, unit noise)
        self._sg, self._ba = sg, ba
        self._fwd, self._plain = sg.SynthesisLayer.forward, ba.bias_act_plain
        current: list = []
        seen, fwd, plain = self.seen, self._fwd, self._plain

        def layer_forward(layer, *args, **kwargs):
            # the strength as this call uses it (a step moves it after)
            current.append((layer, abs(float(layer.noise_strength)) if layer.use_noise else 0))
            try:
                return fwd(layer, *args, **kwargs)
            finally:
                current.pop()

        def plain_with_hook(x, b=None, act="linear", gain=None, clamp=None, axis=-1,
                            scale=None, noise=None):
            if noise is not None and current and noise.requires_grad:
                (layer, strength), kept = current[-1], noise.detach().double()
                assert strength > 0, "a noise strength of 0 hides the noise"
                unit = (kept[:, None] if kept.dim() == 3 else kept) / strength
                noise = (noise[:, None] if noise.dim() == 3 else noise).expand(x.shape)
                noise.register_hook(lambda g: seen.append((layer, g.detach().double(), unit)))
            return plain(x, b, act, gain, clamp, axis, scale, noise)

        sg.SynthesisLayer.forward = layer_forward
        ba.bias_act_plain = plain_with_hook
        return self

    def __exit__(self, *exc):
        self._sg.SynthesisLayer.forward = self._fwd
        self._ba.bias_act_plain = self._plain

    def bounds(self, root, prefix: tuple = ()) -> dict:
        names = {id(m): n for n, m in root.named_modules()}
        out: dict = {}
        for layer, dz, unit in self.seen:
            if id(layer) not in names:
                continue
            key = tuple(prefix) + tuple(names[id(layer)].split(".")) + ("noise_strength",)
            n, mag = out.get(key, (0, 0.0))
            out[key] = (n + dz.numel(), mag + float((dz * unit).abs().sum()))
        return {k: reorder_bound(n, mag) for k, (n, mag) in out.items()}


def agree_trees(got, want, max_rel: float, mean_rel: float, what: str,
                floor: float = 1e-3, near_zero: float | None = None,
                sum_bounds: dict | None = None) -> None:
    """Leaf by leaf, relative to the leaf's largest magnitude, floored at
    ``floor`` of the tree's (a leaf whose gradient is small against the
    tree's, as an attention query bias or a bias whose terms cancel, is
    held to that absolute floor). With ``near_zero``, a leaf whose largest
    magnitude is at most that share of the tree's (a gradient that is
    exactly 0, as a bias before a GroupNorm of one channel a group, of
    which both frameworks compute fp32 noise) is held to a tenth of it,
    absolutely. ``sum_bounds`` {path as a tuple of keys: bound}: a scalar
    leaf that is one fp32 sum of many terms (``NoiseStrengthTerms``) is
    held to its reordering bound, absolutely, and to nothing else."""
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert set(flat_w) == set(flat_g), f"{what}: trees differ"
    top = max(float(np.abs(np.asarray(w)).max()) for w in flat_w.values())
    for path, w in flat_w.items():
        g, w = np.asarray(flat_g[path], np.float64), np.asarray(w, np.float64)
        name = f"{what} {jax.tree_util.keystr(path)}"
        assert np.isfinite(g).all(), f"{name}: non-finite"
        key = tuple(getattr(p, "key", p) for p in path)
        if sum_bounds and key in sum_bounds:
            err = float(np.abs(g - w).max())
            assert err <= sum_bounds[key], \
                f"{name}: sum err {err:.3e} over its reordering bound {sum_bounds[key]:.3e}"
            continue
        if near_zero is not None and np.abs(w).max() <= near_zero * top:
            err = np.abs(g - w).max()
            assert err <= 0.1 * near_zero * top, f"{name}: ~0 gradient, err {err:.3e}"
            continue
        scale = max(float(np.abs(w).max()), floor * top)
        err = np.abs(g - w)
        assert err.max() / scale <= max_rel, f"{name}: max err {err.max():.3e} / {scale:.3e}"
        assert err.mean() / scale <= mean_rel, f"{name}: mean err {err.mean():.3e} / {scale:.3e}"

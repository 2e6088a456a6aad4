"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs are made with seeded numpy and handed to both packages; weights are
initialised in JAX and carried over with ``torch_state_dict_from_jax``.
"""

from __future__ import annotations

import numpy as np
import torch

from real3dportrait_tpu_torch.weights import torch_state_dict_from_jax

torch.set_num_threads(1)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def agree(got, want, max_rel: float, mean_rel: float, what: str = "") -> None:
    """Scale-normalised comparison: ``max|got - want| / scale <= max_rel``
    and ``mean|got - want| / scale <= mean_rel`` with ``scale = max|want|``
    (at least 1e-6). The mean bound catches a broad small regression that a
    max bound alone lets through."""
    got, want = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    assert np.isfinite(got).all(), f"{what}: non-finite values"
    scale = max(float(np.abs(want).max()), 1e-6)
    err = np.abs(got - want)
    assert err.max() / scale <= max_rel, (
        f"{what}: max err {err.max():.3e} / scale {scale:.3e} > {max_rel}")
    assert err.mean() / scale <= mean_rel, (
        f"{what}: mean err {err.mean():.3e} / scale {scale:.3e} > {mean_rel}")


def load_from_jax(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Load Flax ``variables`` into ``module`` with strict name matching."""
    module.load_state_dict(torch_state_dict_from_jax(_plain(variables)), strict=True)
    return module.eval()


def random_like(shapes, seed: int = 0):
    """Seeded numpy leaves for a tree of shapes (``jax.eval_shape`` of a
    Flax ``init``), scaled by leaf name so activations stay O(1): Flax
    kernels 1/sqrt(fan_in), StyleGAN weights and noise N(0,1) (their gains
    apply at run time), norm scales 1 + noise, biases and the rest small."""
    rng = np.random.RandomState(seed)

    def go(tree, name=""):
        if hasattr(tree, "items"):
            return {k: go(v, k) for k, v in tree.items()}
        shape = tuple(tree.shape)
        n = np.asarray(rng.randn(*shape), np.float32)
        if name == "kernel":
            return n / np.sqrt(max(int(np.prod(shape[:-1])), 1))
        if name in ("weight", "noise"):
            return n
        if name == "scale":
            return 1.0 + 0.1 * n
        return 0.1 * n

    return go(shapes)


def jax_run(module, *args, seed: int = 0, method=None, **kw):
    """Seeded variables on a Flax ``module``'s init tree (no init compile)
    and its jitted apply: (variables, outputs). ``method`` (a function of
    the bound module and ``args``) replaces ``__call__`` for the apply; the
    init always runs ``__call__``, with ``init_args`` from ``kw`` if given."""
    import jax
    import jax.numpy as jnp

    args = jax.tree.map(jnp.asarray, args)
    init_args = jax.tree.map(jnp.asarray, kw.pop("init_args", args))
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, *init_args, **kw))
    variables = random_like(shapes, seed=seed)
    if method is None:
        out = jax.jit(lambda v, *a: module.apply(v, *a, **kw))(variables, *args)
    else:
        out = jax.jit(lambda v, *a: module.apply(v, *a, method=method))(variables, *args)
    return variables, out


def _plain(tree):
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def t(x) -> torch.Tensor:
    """numpy -> float32 torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))

"""The port's dual discriminator against the JAX package's at tiny widths
with carried weights: logits, the gradients with respect to both images,
R1 and its parameter gradients (a double backward in the port), and a
bf16-block case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real3dportrait_tpu.models.dual_discriminator import DualDiscriminator as JaxDisc
from real3dportrait_tpu.training import losses as JL
from real3dportrait_tpu_torch.models.dual_discriminator import DualDiscriminator
from real3dportrait_tpu_torch.training import losses as L
from real3dportrait_tpu_torch.weights import jax_variables_from_torch
from tests._torch_parity import agree, load_from_jax, random_like, t

torch.set_num_threads(1)

KW = dict(img_resolution=32, channel_base=256, channel_max=32, mbstd_group_size=2)


def _inputs(seed=0, b=4):
    rng = np.random.RandomState(seed)
    img = rng.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32)
    raw = rng.uniform(-1, 1, (b, 8, 8, 3)).astype(np.float32)
    cam = rng.randn(b, 25).astype(np.float32)
    return img, raw, cam


def _pair(num_fp16_res):
    img, raw, cam = _inputs()
    jd = JaxDisc(num_fp16_res=num_fp16_res, **KW)
    shapes = jax.eval_shape(lambda: jd.init(jax.random.PRNGKey(0), img, raw, cam))
    variables = random_like(shapes, seed=3)
    pd = load_from_jax(DualDiscriminator(num_fp16_res=num_fp16_res, **KW), variables)
    return jd, variables, pd


@pytest.fixture(scope="module")
def fp32_pair():
    return _pair(0)


def test_state_dict_names_match_jax_tree(fp32_pair):
    jd, variables, pd = fp32_pair
    back = jax_variables_from_torch(pd)["params"]
    flat_j = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_leaves_with_path(variables["params"])}
    flat_p = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(back)}
    assert set(flat_j) == set(flat_p)
    for k, v in flat_j.items():
        np.testing.assert_array_equal(flat_p[k], np.asarray(v), err_msg=k)


def test_logits_and_image_grads_match_jax(fp32_pair):
    """Logits at 1e-5 of their largest magnitude; the gradients of their
    sum with respect to both images at 1e-4 max / 1e-5 mean."""
    jd, variables, pd = fp32_pair
    img, raw, cam = _inputs()

    def score(i, r):
        return jnp.sum(jd.apply(variables, i, r, cam))

    want = jd.apply(variables, img, raw, cam)
    g_img, g_raw = jax.jit(jax.grad(score, argnums=(0, 1)))(img, raw)
    ti, tr = t(img).requires_grad_(True), t(raw).requires_grad_(True)
    got = pd(ti, tr, t(cam))
    agree(got, want, 1e-5, 1e-6, "logits")
    gi, gr = torch.autograd.grad(got.sum(), (ti, tr))
    agree(gi, g_img, 1e-4, 1e-5, "d image")
    agree(gr, g_raw, 1e-4, 1e-5, "d image_raw")


def test_r1_and_its_parameter_grads_match_jax(fp32_pair):
    """R1 (both images) and its gradients with respect to every parameter,
    through ``torch.autograd.grad(create_graph=True)``, against
    ``jax.value_and_grad``: 1e-4 max / 1e-5 mean of each leaf's largest
    magnitude, floored at 1e-2 of the tree's (the convolutions' biases
    reach R1 only through the minibatch-std layer, 1e-4 of the weights'
    gradients, and are held to that floor; the weights agree to ~1e-6)."""
    jd, variables, pd = fp32_pair
    img, raw, cam = _inputs(seed=1)

    def r1(p):
        return JL.r1_penalty(lambda i, r, c: jd.apply({"params": p}, i, r, c), img, raw, cam)

    val, grads = jax.jit(jax.value_and_grad(r1))(variables["params"])
    pen = L.r1_penalty(pd, t(img), t(raw), t(cam))
    np.testing.assert_allclose(float(pen), float(val), rtol=1e-4)
    names, params = zip(*pd.named_parameters())
    gs = torch.autograd.grad(pen, params, allow_unused=True)   # R1 has no use for a last bias
    gs = [torch.zeros_like(p) if g is None else g for p, g in zip(params, gs)]
    got = jax_variables_from_torch(pd, dict(zip(names, gs)))
    flat_w = dict(jax.tree_util.tree_leaves_with_path(grads))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got["params"]))
    top = max(float(np.abs(np.asarray(w)).max()) for w in flat_w.values())
    for path, w in flat_w.items():
        w = np.asarray(w, np.float64)
        scale = max(float(np.abs(w).max()), 1e-2 * top)
        err = np.abs(np.asarray(flat_g[path], np.float64) - w)
        name = jax.tree_util.keystr(path)
        assert err.max() / scale <= 1e-4, f"{name}: max {err.max() / scale:.3e}"
        assert err.mean() / scale <= 1e-5, f"{name}: mean {err.mean() / scale:.3e}"


def test_bf16_blocks_match_jax():
    """Every block in bf16 (``num_fp16_res`` 4 at 32^2), as the JAX package
    runs its fp16 resolutions: logits within 5e-2 of their largest
    magnitude at most and 1e-2 on average (convolutions and epilogues
    rounding to bf16 at other points in the two frameworks, through six
    bf16 layers to logits ~1e-4)."""
    jd, variables, pd = _pair(4)
    assert pd.b32.dtype == torch.bfloat16 and pd.b8.dtype == torch.bfloat16
    img, raw, cam = _inputs(seed=2)
    want = jd.apply(variables, img, raw, cam)
    with torch.no_grad():
        got = pd(t(img), t(raw), t(cam))
    agree(got, want, 5e-2, 1e-2, "bf16 logits")

"""Parity of the port's whole StyleGAN2 models with the JAX package's:
the epilogue with a noise plane per sample (``bias_act_plain`` with
[B,H,W] noise and its gradient), ``Generator`` (mapping plus synthesis, in
the "const" and "random" noise modes, fp32 and bf16 blocks, JAX's draws
replayed, its gradients with the noise strengths) and the conditional
``Discriminator`` (fp32 and bf16 blocks, with and without a condition)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real3dportrait_tpu.models import stylegan2 as jsg
from real3dportrait_tpu.ops.bias_act import bias_act as jax_bias_act
from real3dportrait_tpu_torch.models import stylegan2 as sg
from real3dportrait_tpu_torch.ops import bias_act as ba
from real3dportrait_tpu_torch.utils.draws import ReplayDraws, seeded_draws
from real3dportrait_tpu_torch.weights import jax_variables_from_torch, tensors_by_name
from tests._torch_parity import agree, load_from_jax, random_like, t, to_np
from tests._torch_train_parity import NoiseStrengthTerms, agree_trees, record_draws

torch.set_num_threads(1)

GEN = dict(z_dim=16, c_dim=25, w_dim=16, img_resolution=32, img_channels=3,
           mapping_layers=2, channel_base=256, channel_max=32)


def _cameras(b: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randn(b, 25).astype(np.float32)


@pytest.mark.parametrize("act,clamp", [("lrelu", 256.0), ("lrelu", 0.5), ("linear", None)])
def test_bias_act_per_sample_noise_matches_jax(act, clamp):
    # the SynthesisLayer epilogue with JAX's [B,H,W,1] noise: JAX adds the
    # noise to the demodulated conv, then bias_act; the port takes [B,H,W]
    # in bias_act_plain (the kernel's yardstick). Forward and dx at 1e-6 /
    # 1e-7 of scale (fp32, the same operations in the same order); the sums
    # db and dnoise (over channels only) at 1e-5 / 1e-6 (fp32 sums of up to
    # 40 terms in another order)
    rng = np.random.RandomState(0)
    x, d = rng.randn(2, 3, 5, 4).astype(np.float32), rng.rand(2, 3).astype(np.float32) + 0.5
    b, noise = 0.3 * rng.randn(3).astype(np.float32), rng.randn(2, 5, 4).astype(np.float32)
    dy = rng.randn(2, 3, 5, 4).astype(np.float32)

    def jfn(x, b, noise):
        xh = jnp.transpose(x, (0, 2, 3, 1)) * d[:, None, None, :] + noise[..., None]
        y = jax_bias_act(xh, b, act=act, clamp=clamp)
        return jnp.transpose(y, (0, 3, 1, 2))

    want, vjp = jax.vjp(jfn, x, b, noise)
    wdx, wdb, wdn = vjp(jnp.asarray(dy))
    leaves = [t(v).requires_grad_(True) for v in (x, b, noise)]
    got = ba.bias_act_plain(leaves[0], leaves[1], act=act, clamp=clamp, axis=1, scale=t(d),
                            noise=leaves[2])
    agree(got, want, 1e-6, 1e-7, "forward")
    gdx, gdb, gdn = torch.autograd.grad(got, leaves, t(dy))
    agree(gdx, wdx, 1e-6, 1e-7, "dx")
    for g, w, name in ((gdb, wdb, "db"), (gdn, wdn, "dnoise")):
        agree(g, w, 1e-5, 1e-6, name)
    # the plain gradient (K6b's yardstick) returns dnoise in the noise's shape
    pdx, pdb, _, pdn = ba.bias_act_grad_plain(t(dy), got.detach(), t(x), act, None, clamp, 1,
                                              t(d), need_noise=True, noise_per_sample=True)
    assert pdn.shape == (2, 5, 4)
    for g, w, name in ((pdn, wdn, "plain dnoise"), (pdb, wdb, "plain db")):
        agree(g, w, 1e-5, 1e-6, name)
    # and the shared plane's form is unchanged: [H,W], summed over batch too
    shared = ba.bias_act_grad_plain(t(dy), got.detach(), t(x), act, None, clamp, 1, t(d),
                                    need_noise=True)[3]
    agree(shared, pdn.sum(0), 1e-5, 1e-6, "shared dnoise")


def test_bias_act_grad_plain_per_sample_matches_autograd():
    # the [B,H,W] noise's gradient and the others against autograd through
    # the plain forward in float64, at 1e-6 / 1e-7 of scale (the plain
    # gradient computes in fp32)
    rng = np.random.RandomState(1)
    f64 = torch.float64
    x = torch.from_numpy(rng.randn(3, 4, 6, 5)).requires_grad_(True)
    b = torch.from_numpy(0.3 * rng.randn(4)).requires_grad_(True)
    scale = torch.from_numpy(rng.rand(3, 4) + 0.5).requires_grad_(True)
    noise = torch.from_numpy(rng.randn(3, 6, 5)).requires_grad_(True)
    y = ba.bias_act_plain(x, b, act="lrelu", clamp=1.5, axis=1, scale=scale, noise=noise)
    dy = torch.from_numpy(rng.randn(*y.shape)).to(f64)
    want = torch.autograd.grad(y, (x, b, scale, noise), dy)
    got = ba.bias_act_grad_plain(dy, y.detach(), x.detach(), "lrelu", None, 1.5, 1,
                                 scale.detach(), need_noise=True, noise_per_sample=True)
    for g, w, name in zip(got, want, ("dx", "db", "dscale", "dnoise")):
        agree(g, w, 1e-6, 1e-7, name)


def _generator(num_fp16_res=0, c_dim=25):
    kw = {**GEN, "c_dim": c_dim, "num_fp16_res": num_fp16_res}
    module = jsg.Generator(**kw)
    z = np.random.RandomState(3).randn(2, 16).astype(np.float32)
    c = _cameras(2) if c_dim else None
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, z, c))
    variables = random_like(shapes, seed=4)
    return module, variables, z, c, load_from_jax(sg.Generator(**kw), variables)


@pytest.mark.parametrize("fp16,mode,c_dim", [(0, "const", 25), (0, "none", 0),
                                             (2, "const", 25)])
def test_generator_matches_jax(fp16, mode, c_dim):
    # z (and the camera) -> mapping -> synthesis, 4^2 -> 32^2: fp32 at 1e-4 /
    # 1e-5 of scale; bf16 blocks (the two highest resolutions) at 3e-2 max
    # and 3e-3 mean-abs of scale (bf16 keeps 8 bits: a few ulps through
    # two blocks). The truncation at psi 0.7 too; the weights both ways
    module, variables, z, c, port = _generator(fp16, c_dim)
    want = jax.jit(lambda v: module.apply(v, z, c, noise_mode=mode, truncation_psi=0.7))(
        variables)
    with torch.no_grad():
        got = port(t(z), None if c is None else t(c), noise_mode=mode, truncation_psi=0.7)
    assert got.shape == (2, 32, 32, 3) and got.dtype == torch.float32
    tol = (3e-2, 3e-3) if fp16 else (1e-4, 1e-5)
    agree(got, want, *tol, f"generator fp16 {fp16} {mode}")
    back = jax_variables_from_torch(port)
    assert set(back) == {"params", "noise_const", "ema"}
    for k in back:
        jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, b),
                               back[k], jax.tree_util.tree_map(np.asarray, variables[k]))


def test_generator_random_noise_replays_jax():
    # noise_mode "random": one [B,res,res,1] normal draw per layer and call,
    # in the synthesis order; JAX's draws replayed give JAX's image (1e-4 /
    # 1e-5 of scale) and, for a seeded loss, JAX's gradients of every
    # parameter (1e-4 / 1e-5 of each leaf, floored at 1e-2 of the tree's
    # largest), the noise strengths at the fp32 reordering bound of their
    # sums (tests/_torch_train_parity.py:NoiseStrengthTerms)
    module, variables, z, c, port = _generator()
    r = np.random.RandomState(5).randn(2, 32, 32, 3).astype(np.float32)

    def loss(params):
        img = module.apply({**variables, "params": params}, z, c, noise_mode="random",
                           rngs={"noise": jax.random.PRNGKey(7)})
        return jnp.sum(img * r), img

    records, restore = record_draws()
    try:
        (wl, want), wgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["params"])
        jax.effects_barrier()
    finally:
        restore()
    n_layers = 1 + 2 * 3          # b4.conv1, then conv0 and conv1 of b8, b16, b32
    assert [k for k, _ in records] == ["normal"] * n_layers
    assert [v.shape for _, v in records][-1] == (2, 32, 32, 1)
    draws = ReplayDraws(records)
    with NoiseStrengthTerms() as terms:
        got = port(t(z), t(c), noise_mode="random", draws=draws)
        (got * t(r)).sum().backward()
    assert not draws.records
    agree(got, want, 1e-4, 1e-5, "random-noise image")
    gtree = {n: p.grad for n, p in port.named_parameters()}
    bounds = terms.bounds(port)
    assert len(bounds) == n_layers
    agree_trees(jax_variables_from_torch(port, gtree)["params"], wgrad, 1e-4, 1e-5, "grad",
                floor=1e-2, sum_bounds=bounds)
    # the draws' noise moved the image: not the "none" image
    with torch.no_grad():
        quiet = port(t(z), t(c), noise_mode="none")
    assert float((got - quiet).abs().max()) > 1e-3
    # a generator's own draws: a seed gives the same image twice
    a = port(t(z), t(c), draws=seeded_draws(3, "cpu"))
    b = port(t(z), t(c), draws=seeded_draws(3, "cpu"))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="needs draws"):
        port(t(z), t(c))
    # the gradients the bridge reads back as a tree are the parameters'
    assert set(tensors_by_name(port, wgrad)) == set(dict(port.named_parameters()))


def _discriminator(num_fp16_res, c_dim, res=32):
    kw = dict(c_dim=c_dim, img_resolution=res, img_channels=3, channel_base=256,
              channel_max=32, num_fp16_res=num_fp16_res, mbstd_group_size=2,
              mapping_layers=2)
    module = jsg.Discriminator(**kw)
    img = np.random.RandomState(6).uniform(-1, 1, (4, res, res, 3)).astype(np.float32)
    c = _cameras(4, 1) if c_dim else None
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), img, c))
    variables = random_like(shapes, seed=8)
    return module, variables, img, c, load_from_jax(sg.Discriminator(**kw), variables)


@pytest.mark.parametrize("fp16,c_dim", [(0, 25), (0, 0), (2, 25)])
def test_discriminator_matches_jax(fp16, c_dim):
    # 32^2 -> 4^2 resnet blocks, the camera mapped to cmap, the epilogue:
    # logits at 1e-4 / 1e-5 of scale in fp32, bf16 blocks (32^2 and 16^2) at
    # 3e-2 max and 3e-3 mean-abs; the fp32 case's input gradient (R1's) at
    # 1e-4 / 1e-5
    module, variables, img, c, port = _discriminator(fp16, c_dim)
    want, vjp = jax.vjp(lambda x: module.apply(variables, x, c), jnp.asarray(img))
    x = t(img).requires_grad_(True)
    got = port(x, None if c is None else t(c))
    assert got.shape == (4, 1)
    tol = (3e-2, 3e-3) if fp16 else (1e-4, 1e-5)
    agree(got, want, *tol, f"discriminator fp16 {fp16} c {c_dim}")
    if not fp16:
        (gx,) = torch.autograd.grad(got.sum(), x, create_graph=True)
        agree(gx, vjp(jnp.ones_like(want))[0], 1e-4, 1e-5, "input gradient")
        # R1's double backward reaches the convolutions' weights
        gx.square().sum().backward()
        assert all(p.grad is not None and torch.isfinite(p.grad).all() and p.grad.abs().max() > 0
                   for n, p in port.named_parameters() if n.endswith("conv0.weight"))
    back = jax_variables_from_torch(port)
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, b),
                           back["params"], jax.tree_util.tree_map(np.asarray,
                                                                  variables["params"]))
    assert to_np(got).dtype == np.float32

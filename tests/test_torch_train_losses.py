"""The port's training losses, perceptual criteria, schedules and
optimiser against the JAX package's on the same seeded arrays: each loss at
1e-6 relative (the VGG19 criterion's convolutions at 1e-5), the schedules
and the Adam / MultiSteps updates at 1e-6."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from real3dportrait_tpu.models import perceptual as JP
from real3dportrait_tpu.training import losses as JL
from real3dportrait_tpu.training import schedulers as JS
from real3dportrait_tpu_torch.models import perceptual as P
from real3dportrait_tpu_torch.training import losses as L
from real3dportrait_tpu_torch.training import schedulers as S
from real3dportrait_tpu_torch.utils.draws import ReplayDraws
from tests._torch_parity import t
from tests._torch_train_parity import record_draws

torch.set_num_threads(1)


def close(got, want, rtol=1e-6, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    np.testing.assert_allclose(got, np.asarray(want, np.float64), rtol=rtol, atol=1e-7,
                               err_msg=what)


def _images(seed=0, b=2, h=24):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (b, h, h, 3)).astype(np.float32),
            rng.uniform(-1, 1, (b, h, h, 3)).astype(np.float32),
            (rng.rand(b, h, h, 1) > 0.5).astype(np.float32))


def test_reconstruction_losses():
    p, q, m = _images()
    close(L.masked_l1(t(p), t(q)), JL.masked_l1(p, q), what="l1")
    close(L.masked_l1(t(p), t(q), t(m)), JL.masked_l1(p, q, m), what="l1 mask")
    close(L.masked_l1(t(p), t(q), clamp_quantile=0.95),
          JL.masked_l1(p, q, clamp_quantile=0.95), what="l1 quantile")
    close(L.masked_mse(t(p), t(q), t(m)), JL.masked_mse(p, q, m), what="mse mask")
    close(L.masked_mse(t(p), t(q)), JL.masked_mse(p, q), what="mse")


@pytest.mark.parametrize("n", [68, 468])
def test_motion_losses(n):
    rng = np.random.RandomState(8)
    x = rng.randn(2, 9, 5).astype(np.float32)
    mask = (rng.rand(2, 9) > 0.3).astype(np.float32)
    close(L.temporal_laplacian(t(x)), JL.temporal_laplacian(x), what="laplacian")
    close(L.temporal_laplacian(t(x), t(mask)), JL.temporal_laplacian(x, mask),
          what="laplacian mask")
    a, b = rng.randn(2, 3, n, 3).astype(np.float32), rng.randn(2, 3, n, 3).astype(np.float32)
    m3 = (rng.rand(2, 3) > 0.3).astype(np.float32)
    close(L.weighted_lm3d_mse(t(a), t(b), n_landmarks=n),
          JL.weighted_lm3d_mse(a, b, n_landmarks=n), what="lm3d")
    close(L.weighted_lm3d_mse(t(a), t(b), t(m3), n_landmarks=n),
          JL.weighted_lm3d_mse(a, b, m3, n_landmarks=n), what="lm3d mask")
    for step in (0, 3, 10, 17, 25):
        close(L.kl_annealing_weight(step, 0.5, 10, 10), JL.kl_annealing_weight(step, 0.5, 10, 10),
              what=f"kl at {step}")


def test_quantile_clamped_l1_gradient():
    p, q, _ = _images(1)
    want = jax.grad(lambda a: JL.masked_l1(a, q, clamp_quantile=0.95))(p)
    tp = t(p).requires_grad_(True)
    got = torch.autograd.grad(L.masked_l1(tp, t(q), clamp_quantile=0.95), tp)[0]
    close(got, want, what="d l1 quantile")


def test_gan_losses_and_weights_regularisers():
    rng = np.random.RandomState(2)
    real, fake = rng.randn(4, 1).astype(np.float32), rng.randn(4, 1).astype(np.float32)
    close(L.g_nonsaturating_loss(t(fake)), JL.g_nonsaturating_loss(fake), what="g")
    close(L.d_logistic_loss(t(real), t(fake)), JL.d_logistic_loss(real, fake), what="d")
    w = rng.rand(2, 8, 8, 1).astype(np.float32)
    w[0, 0, 0, 0], w[0, 0, 1, 0] = 0.0, 1.0                    # the clamp's ends
    mask = (rng.rand(2, 8, 8, 1) > 0.5).astype(np.float32)
    close(L.weights_entropy_loss(t(w)), JL.weights_entropy_loss(w), what="entropy")
    close(L.weights_mask_match_loss(t(w), t(mask)), JL.weights_mask_match_loss(w, mask),
          what="mask match")
    losses = {"a": 1.5, "b": 2.0, "c": 3.0}
    close(L.weighted_loss_sum(losses, {"a": 0.5, "c": 0.0}),
          JL.weighted_loss_sum(losses, {"a": 0.5, "c": 0.0}), what="sum")


def test_r1_penalty_matches_jax():
    """R1 with respect to both images of a small differentiable critic."""
    rng = np.random.RandomState(3)
    img, raw = rng.randn(3, 8, 8, 3).astype(np.float32), rng.randn(3, 4, 4, 3).astype(np.float32)
    cam = rng.randn(3, 25).astype(np.float32)
    w = rng.randn(8, 8, 3).astype(np.float32)

    def jcritic(i, r, c):
        return (jnp.sum(jnp.tanh(i * w), axis=(1, 2, 3)) * c[:, 0]
                + jnp.sum(r ** 3, axis=(1, 2, 3)))[:, None]

    def tcritic(i, r, c):
        return ((torch.tanh(i * t(w))).sum((1, 2, 3)) * c[:, 0] + (r ** 3).sum((1, 2, 3)))[:, None]

    close(L.r1_penalty(tcritic, t(img), t(raw), t(cam)),
          JL.r1_penalty(jcritic, img, raw, cam), what="r1")


def test_density_regularization_with_jax_draws():
    """The JAX function's own points and perturbation, replayed in the
    port's draws."""
    records, restore = record_draws()
    try:
        want = JL.density_regularization(
            lambda pts: {"sigma": jnp.sin(3 * pts).sum(-1, keepdims=True)},
            jax.random.PRNGKey(4), box_warp=1.0, n_points=50, p_dist=0.004)
        jax.effects_barrier()
    finally:
        restore()
    draws = ReplayDraws(records)
    got = L.density_regularization(
        lambda pts: {"sigma": torch.sin(3 * pts).sum(-1, keepdim=True)}, draws, "cpu",
        box_warp=1.0, n_points=50, p_dist=0.004)
    assert not draws.records
    close(got, want, rtol=1e-5, what="density")


def test_lip_crops_and_pyramid():
    p, q, _ = _images(5, h=40)
    rng = np.random.RandomState(5)
    lm = (rng.rand(2, 68, 2) * 40).astype(np.float32)
    close(L.lip_rect_centers(t(lm)), JL.lip_rect_centers(lm), what="centers")
    centers = np.array([[3, 38], [20, 21]], np.int32)       # one clamped at each side
    close(L.crop_fixed_rect(t(p), torch.from_numpy(centers), 8),
          JL.crop_fixed_rect(p, centers, 8), what="crop")
    got = L.lip_crop_losses(t(p), t(q), torch.from_numpy(centers), 8)
    want = JL.lip_crop_losses(p, q, centers, 8)
    close(got[0], want[0], what="lip mae")
    close(got[1], want[1], what="lip pyramid")
    close(L.laplacian_pyramid_loss(t(p), t(q)), JL.laplacian_pyramid_loss(p, q), what="pyr")
    tp = t(p).requires_grad_(True)
    close(torch.autograd.grad(L.laplacian_pyramid_loss(tp, t(q)), tp)[0],
          jax.grad(lambda a: JL.laplacian_pyramid_loss(a, q))(p), rtol=1e-5, what="d pyr")


def test_vgg19_perceptual_on_mock_weights(tmp_path):
    """The VGG19 path on He-initialised mock weights, through a converted
    tree on disk, as ``make_perceptual_fn`` reads it; without weights the
    pyramid surrogate."""
    from flax import serialization

    tree = JP.init_vgg19_params(np.random.RandomState(0))
    path = os.path.join(tmp_path, "vgg19.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.msgpack_serialize(tree))
    cfg = {"vgg19_ckpt": path, "lpips_mode": "vgg19"}
    fn, kind = P.make_perceptual_fn(cfg)
    jfn, jkind = JP.make_perceptual_fn(cfg)
    assert (kind, jkind) == ("vgg19", "vgg19")
    p, q, _ = _images(6, h=32)
    close(fn(t(p), t(q)), jfn(p, q), rtol=1e-5, what="vgg19")
    fn, kind = P.make_perceptual_fn({})
    assert kind == "pyramid"
    close(fn(t(p), t(q)), JL.laplacian_pyramid_loss(p, q), what="pyramid")


@pytest.mark.parametrize("kind", ["gan", "exponential", "cosine", "rsqrt"])
def test_schedules_match_jax(kind):
    make = {"gan": lambda m: m.gan_lr_schedule(2e-4, 0.95, 10, 5),
            "exponential": lambda m: m.exponential_schedule(1e-3, 0.9, 7, 3),
            "cosine": lambda m: m.cosine_schedule(1e-3, 50, 5, 1e-5),
            "rsqrt": lambda m: m.rsqrt_schedule(1e-3, 8, 64)}[kind]
    mine, theirs = make(S), make(JS)
    for step in (0, 1, 4, 9, 10, 23, 49, 60, 1000):
        close(mine(step), theirs(step), what=f"{kind} at {step}")


@pytest.mark.parametrize("every_k,b1", [(1, 0.0), (1, 0.9), (3, 0.0)])
def test_adam_matches_optax(every_k, b1):
    """The updates of five steps from the same gradients, and the state as a
    checkpoint holds it."""
    from flax import serialization

    rng = np.random.RandomState(7)
    params = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    sched = JS.gan_lr_schedule(1e-3, 0.5, 2)
    opt = optax.adam(sched, b1=b1, b2=0.99)
    if every_k > 1:
        opt = optax.MultiSteps(opt, every_k_schedule=every_k)
    state = opt.init(params)
    mine = S.Adam({k: t(v) for k, v in params.items()}, S.gan_lr_schedule(1e-3, 0.5, 2),
                  b1=b1, b2=0.99, every_k=every_k)
    for _ in range(5):
        g = {k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
        upd, state = opt.update(g, state, params)
        got = mine.updates({k: t(v) for k, v in g.items()})
        for k in params:
            close(got[k], upd[k], what=f"update {k}")
    want = jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(state))
    have = mine.state_dict(lambda named: {k: v.numpy() for k, v in named.items()})
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_h = dict(jax.tree_util.tree_leaves_with_path(have))
    assert set(flat_w) == set(flat_h)
    for path, v in flat_w.items():
        close(flat_h[path], v, what=jax.tree_util.keystr(path))

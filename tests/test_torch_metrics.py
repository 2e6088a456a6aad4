"""The port's evaluation metrics (``real3dportrait_tpu_torch/metrics``, the
LPIPS additions of ``models/perceptual.py``) against the JAX package's on
the CPU: PSNR, SSIM, the LPIPS surrogate and LPIPS(vgg) on seeded images;
the Inception network on a Flax-initialised tree; the random-projection
extractor on JAX's weights; the numpy statistics; ``calc_metric``'s
payloads; PPL with JAX's draws replayed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real3dportrait_tpu.metrics import gan_metrics as jgan
from real3dportrait_tpu.metrics import image_metrics as jimg
from real3dportrait_tpu.metrics import inception as jinc
from real3dportrait_tpu.models import perceptual as jperc
from real3dportrait_tpu_torch.metrics import gan_metrics, image_metrics, inception
from real3dportrait_tpu_torch.models import perceptual
from real3dportrait_tpu_torch.utils.draws import ReplayDraws
from real3dportrait_tpu_torch.weights import (
    inception_from_jax,
    lpips_weights_from_jax,
    random_projection_from_jax,
)
from tests._torch_parity import agree
from tests._torch_train_parity import record_draws

torch.set_num_threads(1)


def _pair(b: int, res: int, seed: int, noise: float = 0.3):
    """Seeded [b,res,res,3] images in [-1,1] and a noisy copy."""
    rng = np.random.RandomState(seed)
    x = np.tanh(rng.randn(b, res, res, 3)).astype(np.float32)
    y = np.clip(x + noise * rng.randn(*x.shape), -1, 1).astype(np.float32)
    return x, y


def test_psnr_and_ssim_match_jax():
    x, y = _pair(3, 32, 0)
    got = image_metrics.psnr(torch.from_numpy(x), torch.from_numpy(y))
    want = np.asarray(jimg.psnr(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # identical images: the 1e-12 floor, 10 log10(4 / 1e-12) dB, in both
    same = image_metrics.psnr(torch.from_numpy(x), torch.from_numpy(x))
    np.testing.assert_allclose(same.numpy(), np.asarray(jimg.psnr(jnp.asarray(x),
                                                                  jnp.asarray(x))), atol=1e-4)
    agree(image_metrics.ssim(torch.from_numpy(x), torch.from_numpy(y)),
          jimg.ssim(jnp.asarray(x), jnp.asarray(y)), 1e-5, 1e-5, "ssim")
    agree(image_metrics.ssim(torch.from_numpy(x), torch.from_numpy(y), data_range=1.0,
                             kernel_size=7, sigma=1.0),
          jimg.ssim(jnp.asarray(x), jnp.asarray(y), data_range=1.0, kernel_size=7, sigma=1.0),
          1e-5, 1e-5, "ssim k7")


@pytest.mark.parametrize("res,levels", [(64, 3), (40, 4)])
def test_lpips_surrogate_matches_jax(res, levels):
    # the pyramid halves through resize_linear (antialiased when shrinking,
    # as jax.image.resize); 40^2 stops at 10^2 < 12 after two levels
    x, y = _pair(2, res, 1)
    got = image_metrics.lpips_surrogate(torch.from_numpy(x), torch.from_numpy(y), levels)
    want = jimg.lpips_surrogate(jnp.asarray(x), jnp.asarray(y), levels)
    agree(got, want, 1e-5, 1e-5, f"lpips surrogate {res}")


def test_init_lpips_params_equal_to_jax():
    got, want = perceptual.init_lpips_params(), jperc.init_lpips_params()
    assert set(got) == set(want)
    for k, v in want.items():
        assert set(got[k]) == set(v)
        for leaf, arr in v.items():
            np.testing.assert_array_equal(got[k][leaf], arr, err_msg=f"{k}/{leaf}")
    assert perceptual.LPIPS_VGG16_CONVS == jperc.LPIPS_VGG16_CONVS
    assert perceptual.LPIPS_POOL_BEFORE == jperc.LPIPS_POOL_BEFORE


def test_lpips_vgg_matches_jax_and_loads_from_cfg(tmp_path):
    tree = jperc.init_lpips_params()
    x, y = _pair(2, 64, 2)
    want = jperc.lpips_vgg(tree, jnp.asarray(x), jnp.asarray(y))
    got = perceptual.lpips_vgg(lpips_weights_from_jax(tree, "cpu"), torch.from_numpy(x),
                               torch.from_numpy(y))
    agree(got, want, 1e-5, 1e-5, "lpips_vgg")
    # the metric from the config: a msgpack tree selects lpips_vgg, a
    # missing one the surrogate, and the kind says which
    from real3dportrait_tpu_torch.utils.msgpack_ckpt import msgpack_serialize

    path = tmp_path / "lpips_vgg.msgpack"
    path.write_bytes(msgpack_serialize(tree))
    cfg = {"lpips_vgg_ckpt": str(path)}
    assert image_metrics.lpips_kind(cfg) == jimg.lpips_kind(cfg) == "lpips_vgg"
    agree(image_metrics.lpips(torch.from_numpy(x), torch.from_numpy(y), cfg),
          jimg.lpips(jnp.asarray(x), jnp.asarray(y), cfg), 1e-5, 1e-5, "lpips from cfg")
    missing = {"lpips_vgg_ckpt": str(tmp_path / "absent.msgpack")}
    assert image_metrics.lpips_kind(missing) == jimg.lpips_kind(missing) == "surrogate"
    agree(image_metrics.lpips(torch.from_numpy(x), torch.from_numpy(y), missing),
          jimg.lpips_surrogate(jnp.asarray(x), jnp.asarray(y)), 1e-5, 1e-5,
          "lpips without weights")
    # a tree that lacks one of the net's convs is refused when it is read
    bad = tmp_path / "lpips_bad.msgpack"
    bad.write_bytes(msgpack_serialize({k: v for k, v in tree.items() if k != "conv28"}))
    with pytest.raises(ValueError, match="conv28"):
        perceptual.make_lpips_fn({"lpips_vgg_ckpt": str(bad)})


@pytest.fixture(scope="module")
def inception_tree():
    """JAX's Flax-initialised InceptionV3 tree with seeded BN affines."""
    x = jnp.zeros((1, 107, 107, 3))
    variables = jax.jit(jinc.InceptionV3Features().init)(jax.random.PRNGKey(0), x)
    rng = np.random.RandomState(3)

    def seed_bn(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = seed_bn(v)
            elif k == "bn_scale":
                out[k] = (1.0 + 0.1 * rng.randn(*v.shape)).astype(np.float32)
            elif k == "bn_bias":
                out[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return {"params": seed_bn(jax.tree_util.tree_map(np.asarray, variables["params"]))}


def test_inception_features_match_jax(inception_tree):
    # 2 x 107^2, the net's smallest comfortable input (2^2 after Mixed_7a):
    # 94 cuDNN / XLA convs in fp32, 1e-4 of the features' scale
    model = inception_from_jax(inception_tree)
    assert len(list(model.parameters())) == len(jax.tree_util.tree_leaves(inception_tree))
    x = np.tanh(np.random.RandomState(4).randn(2, 107, 107, 3)).astype(np.float32)
    want = jax.jit(jinc.InceptionV3Features().apply)(inception_tree, jnp.asarray(x))
    got = model(torch.from_numpy(x)).detach()
    assert got.shape == (2, 2048)
    agree(got, want, 1e-4, 1e-5, "inception pool features")


def test_inception_resize_and_loader(inception_tree, tmp_path):
    # inception_pool_features' resize to 299^2 (bilinear, no antialias) on a
    # 2 x 64^2 batch and a shrinking 2 x 320^2 one against jax.image.resize
    for res in (64, 320):
        x = np.tanh(np.random.RandomState(res).randn(2, res, res, 3)).astype(np.float32)
        want = jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), "bilinear", antialias=False)
        agree(inception.resize_299(torch.from_numpy(x)), want, 1e-6, 1e-7, f"resize {res}")
    # the loader: a msgpack tree in, the network out; a missing file is None
    from real3dportrait_tpu_torch.utils.msgpack_ckpt import msgpack_serialize

    path = tmp_path / "inception.msgpack"
    path.write_bytes(msgpack_serialize(inception_tree))
    model = inception.load_inception_params(str(path))
    ref = inception_from_jax(inception_tree)
    for (n, p), (_, q) in zip(model.named_parameters(), ref.named_parameters()):
        assert torch.equal(p, q), n
    assert inception.load_inception_params(str(tmp_path / "absent")) is None
    assert jinc.load_inception_params(str(tmp_path / "absent")) is None
    assert gan_metrics.make_inception_extractor(str(tmp_path / "absent"), device="cpu") is None
    extract, kind = gan_metrics.resolve_extractor({"inception_ckpt": str(path)}, device="cpu")
    assert kind == "inception_v3"
    x = np.tanh(np.random.RandomState(5).randn(3, 107, 107, 3)).astype(np.float32)
    feats = extract(x)
    assert feats.shape == (3, 2048) and feats.dtype == np.float32
    want = jax.jit(jinc.inception_pool_features)(inception_tree, jnp.asarray(x))
    agree(feats, want, 1e-4, 1e-5, "inception extractor")
    assert gan_metrics.resolve_extractor({}, device="cpu")[1] == "random_projection"


def _jax_projection_weights(feature_dim: int = 512, seed: int = 0):
    """The arrays that JAX's make_random_projection_extractor draws."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    return (np.asarray(jax.random.normal(k1, (5, 5, 3, 32)) / np.sqrt(75)),
            np.asarray(jax.random.normal(k2, (3, 3, 32, 64)) / np.sqrt(288)),
            np.asarray(jax.random.normal(k3, (64 * 2, feature_dim)) / np.sqrt(128)))


@pytest.mark.parametrize("res", [64, 65])
def test_random_projection_extractor_matches_jax(res):
    # JAX's SAME stride-4 padding: 64^2 pads (0, 1), 65^2 (1, 2) at k 5
    x = np.tanh(np.random.RandomState(res).randn(5, res, res, 3)).astype(np.float32)
    mine = gan_metrics.make_random_projection_extractor(
        weights=random_projection_from_jax(*_jax_projection_weights()), batch=2,
        device="cpu")
    agree(mine(x), jgan.make_random_projection_extractor(batch=2)(x), 1e-5, 1e-6,
          f"random projection {res}")
    # the port's own draw: deterministic, of the documented shape
    own = gan_metrics.make_random_projection_extractor(feature_dim=16, device="cpu")
    np.testing.assert_array_equal(own(x[:2]), own(x[:2]))
    assert own(x[:2]).shape == (2, 16)


@pytest.fixture(scope="module")
def feats():
    rng = np.random.RandomState(6)
    a = rng.randn(60, 24).astype(np.float32)
    b = (rng.randn(50, 24) * 1.2 + 0.3).astype(np.float32)
    return a, b


def test_statistics_match_jax(feats):
    a, b = feats
    for got, want in ((gan_metrics.frechet_distance(a, b), jgan.frechet_distance(a, b)),
                      (gan_metrics.kernel_distance(a, b, max_subset_size=40, num_subsets=3),
                       jgan.kernel_distance(a, b, max_subset_size=40, num_subsets=3))):
        np.testing.assert_allclose(got, want, rtol=1e-9)
    probs = np.random.RandomState(7).dirichlet(np.ones(10), 40)
    np.testing.assert_allclose(gan_metrics.inception_score(probs, 4),
                               jgan.inception_score(probs, 4), rtol=1e-9)


@pytest.mark.parametrize("block_bytes", [1 << 28, 24 * 4 * 50 * 3, 1])
def test_precision_recall_blocked_matches_jax(feats, block_bytes):
    # whole (one block), three rows a block, one row a block
    a, b = feats
    got = gan_metrics.precision_recall(a, b, nhood_size=3, block_bytes=block_bytes)
    np.testing.assert_allclose(got, jgan.precision_recall(a, b, nhood_size=3), rtol=1e-9)


def test_calc_metric_payloads_match_jax(feats):
    a, b = feats
    imgs_a = np.tanh(np.random.RandomState(8).randn(12, 32, 32, 3)).astype(np.float32)
    imgs_b = np.tanh(np.random.RandomState(9).randn(12, 32, 32, 3) * 1.5).astype(np.float32)
    mine = gan_metrics.make_random_projection_extractor(
        feature_dim=8, weights=random_projection_from_jax(*_jax_projection_weights(8)),
        device="cpu")
    theirs = jgan.make_random_projection_extractor(feature_dim=8)
    assert gan_metrics.list_metrics() == jgan.list_metrics()
    for name, kw in (("fid", {}), ("kid", {"max_subset_size": 10, "num_subsets": 2}),
                     ("pr50k", {"nhood_size": 2})):
        got = gan_metrics.calc_metric(name, real_images=imgs_a, fake_images=imgs_b,
                                      extractor=mine, **kw)
        want = jgan.calc_metric(name, real_images=imgs_a, fake_images=imgs_b,
                                extractor=theirs, **kw)
        assert list(got) == list(want) and got["extractor"] == "custom", (got, want)
        assert got["comparable_to_published"] is want["comparable_to_published"] is True
        g, w = got["results"][name], want["results"][name]
        if isinstance(w, dict):
            assert g == w, name
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=name)
    # no extractor: the random projection, stamped so
    got = gan_metrics.calc_metric("fid", real_images=imgs_a, fake_images=imgs_b, device="cpu")
    want = jgan.calc_metric("fid", real_images=imgs_a, fake_images=imgs_b)
    assert {k: v for k, v in got.items() if k != "results"} == \
        {k: v for k, v in want.items() if k != "results"}
    assert got["extractor"] == "random_projection" and not got["comparable_to_published"]
    with pytest.raises(KeyError):
        gan_metrics.calc_metric("nope")


def test_ppl_with_jax_draws_replayed():
    # a fixed linear-tanh "generator" z -> 24^2 images in both packages; an
    # epsilon of 0.05 (the default 1e-4 leaves differences below fp32's
    # resolution of 1 - SSIM in either package)
    rng = np.random.RandomState(10)
    w = (rng.randn(8, 24 * 24 * 3) / np.sqrt(8)).astype(np.float32)

    def jax_synth(z):
        return jnp.tanh(z @ jnp.asarray(w)).reshape(-1, 24, 24, 3)

    def port_synth(z):
        return torch.tanh(z @ torch.from_numpy(w)).reshape(-1, 24, 24, 3)

    records, restore = record_draws()
    try:
        want = jgan.calc_metric("ppl", synth_fn=jax_synth, z_dim=8, n_samples=6,
                                epsilon=0.05, seed=3)
        jax.effects_barrier()
    finally:
        restore()
    assert [k for k, _ in records] == ["normal", "normal", "uniform"]
    got = gan_metrics.calc_metric("ppl", synth_fn=port_synth, z_dim=8, n_samples=6,
                                  epsilon=0.05, draws=ReplayDraws(records), device="cpu")
    assert list(got) == list(want) == ["results", "metric"]
    np.testing.assert_allclose(got["results"]["ppl"], want["results"]["ppl"], rtol=1e-5)
    # the port's own seeded draws: deterministic
    a = gan_metrics.perceptual_path_length(port_synth, 8, n_samples=4, epsilon=0.05,
                                           device="cpu")
    assert a == gan_metrics.perceptual_path_length(port_synth, 8, n_samples=4, epsilon=0.05,
                                                   device="cpu")

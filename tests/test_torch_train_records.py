"""Records-driven training of the port against the JAX package at tiny
widths: the record batches of both SECC tasks (``prepare_batch_from_records``
from one store and seed), a train step on them, the validation images and
the OOD probe on carried weights, the trainer's PNG dump, the ``vgg19_v2``
criterion, and the SECC renderer's antialiased shrink."""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real3dportrait_tpu.geometry import bfm as jbfm
from real3dportrait_tpu.geometry.secc_renderer import SECCRenderer as JaxSECCRenderer
from real3dportrait_tpu.models import perceptual as JP
from real3dportrait_tpu.training.train_state import TrainState as JaxTrainState
from real3dportrait_tpu.training.trainer import Trainer as JaxTrainer
from real3dportrait_tpu_torch.data.binarizer import binarize, make_synthetic_records
from real3dportrait_tpu_torch.geometry import bfm
from real3dportrait_tpu_torch.geometry.secc_renderer import SECCRenderer
from real3dportrait_tpu_torch.models import perceptual as P
from real3dportrait_tpu_torch.training.trainer import Trainer
from real3dportrait_tpu_torch.utils.draws import ReplayDraws, seeded_draws
from real3dportrait_tpu_torch.weights import torch_state_dict_from_jax
from tests._torch_parity import agree, random_like, t, to_np
from tests._torch_train_parity import TORSO_CONFIG, record_draws, tasks

torch.set_num_threads(1)

RES = 32  # TINY_GAN's final_resolution; the store's images are 48^2 (shrunk)
SECC_RES = 64  # the record path rasterizes at 64^2 and shrinks to 32^2
FRAMES = 24


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A store of 2 videos with every image key, as train and val splits."""
    out = str(tmp_path_factory.mktemp("records"))
    recs = make_synthetic_records(2, FRAMES, seed=1)
    rng = np.random.RandomState(2)
    for r in recs:
        for k in ("head_imgs", "com_imgs", "torso_imgs"):
            r[k] = rng.randint(0, 256, (FRAMES, 48, 48, 3), dtype=np.uint8)
        r["segmaps"] = rng.randint(-1, 7, (FRAMES, 48, 48)).astype(np.int8)
        r["bg_img"] = rng.randint(0, 256, (48, 48, 3), dtype=np.uint8)
    for split in ("train", "val"):
        binarize(recs, os.path.join(out, split))
    return out


def _tasks(store, torso: bool, **extra):
    over = {"binary_data_dir": store, "secc_resolution": SECC_RES, "seed": 3, **extra}
    if torso:
        over["torso_model_scale"] = "tiny"
        return tasks(over, TORSO_CONFIG)
    return tasks(over)


def assert_secc_agree(got, want, what):
    """The raster's known difference (tests/test_torch_raster.py
    ``test_plain_zbuffer_matches_jax_secc_renderer``): pixels that are
    background in one map and not the other at most 0.5%, the NCC within
    1e-4 where both cover. A map resized from the raster carries it through
    the filter, so here a pixel agrees where it is background in both or
    within 1e-4, and at most 0.5% of pixels may not."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, what
    bg_g, bg_w = (got <= -1.0).all(-1), (want <= -1.0).all(-1)
    ok = (bg_g & bg_w) | (np.abs(got - want).max(-1) <= 1e-4)
    assert (~ok).mean() <= 0.005, f"{what}: {(~ok).mean():.4f} of pixels differ"
    assert 0.05 < (~bg_w).mean(), f"{what}: the face should cover part of the frame"


SECC_KEYS = ("secc_cond", "secc_cond_src", "pertube_secc_1", "pertube_secc_2",
             "blink_secc_1", "blink_secc_2", "blink_secc_3")


@pytest.mark.parametrize("torso,mode", [(False, "randn"), (False, "laplacian"),
                                        (True, "randn")])
def test_record_batches_match_jax(store, torso, mode):
    # two batches from each task's own dataset and RandomState: SECC maps by
    # the raster's bound, integer lip centres and segmaps equal, the rest
    # within 1e-5
    jtask, ptask = _tasks(store, torso, secc_pertube_mode=mode)
    jit, pit = jtask.train_data(), ptask.train_data()
    for i in range(2):
        want = jax.tree_util.tree_map(np.asarray, next(jit))
        got = next(pit)
        assert set(got) == set(want), f"keys {sorted(set(got) ^ set(want))}"
        for k, w in want.items():
            g = to_np(got[k])
            assert g.shape == w.shape, f"{k}: {g.shape} != {w.shape}"
            if k in SECC_KEYS:
                assert_secc_agree(g, w, f"batch {i} {k}")
            elif w.dtype.kind == "i" or k in ("segmap", "head_mask"):
                np.testing.assert_array_equal(g, w, err_msg=f"batch {i} {k}")
            else:
                agree(g, w, 1e-5, 1e-6, f"batch {i} {k}")
        assert ("pertube_secc_2" in got) == (mode == "laplacian")
    if torso:
        assert {"ref_torso_img", "bg_img", "segmap", "kp_src", "kp_drv"} <= set(got)
        assert got["segmap"].shape == (2, RES, RES, 6)


def test_records_train_step_is_finite(store):
    # one training step of each task on a record batch; the step's kernels'
    # plain versions on the CPU
    for torso in (False, True):
        _, ptask = _tasks(store, torso)
        state = ptask.build(0)
        batch = ptask.to_device(next(ptask.train_data()))
        metrics = ptask.train_step(state, batch, seeded_draws(0, "cpu"))
        assert state.step == 1
        bad = {k: float(v) for k, v in metrics.items() if not torch.isfinite(v).all()}
        assert not bad, bad
        assert "g/pertube_blink_secc" in metrics


def ema_states(jtask, ptask, jbatch):
    """A JAX state and the port's carrying the same seeded generator as
    their EMA generator, the one the validation renders read (the leaves of
    ``jax_state``'s generator; no discriminator or optimiser state, which
    the renders never read)."""
    gshape = jax.eval_shape(lambda: jtask.gen.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jbatch["src_img"], jbatch["camera"], secc=jbatch["secc_cond"]))
    gv = random_like(gshape, 0)
    pstate = ptask.build(0)
    pstate.gen_ema.load_state_dict(torch_state_dict_from_jax(gv), strict=True)
    gv = jax.tree_util.tree_map(jnp.asarray, gv)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params={"gen": gv["params"], "gen_ema": gv["params"]},
        variables={k: v for k, v in gv.items() if k != "params"}, opt_states={}, extra={})
    return jstate, pstate


@pytest.fixture(scope="module")
def val_setup(store):
    """The JAX task's validation images of a record batch on seeded weights,
    with the draws they made, and the port's task and state carrying the
    same weights. A batch of one, so that the batch's renders and the OOD
    probe's share one compile of the JAX generator."""
    jtask, ptask = _tasks(store, False, batch_size=1)
    batch = {k: to_np(v) for k, v in next(ptask.val_data()).items()}
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jstate, pstate = ema_states(jtask, ptask, jbatch)
    # jitted (eager flax takes minutes here) over the arrays the flagship's
    # forward reads, so that the batch and the probe share one compile
    gen_forward = jtask._gen_forward
    fwd = jax.jit(lambda params, variables, img, camera, secc, rng: gen_forward(
        params, jstate.replace(variables=variables),
        {"src_img": img, "camera": camera, "secc_cond": secc}, rng))
    jtask._gen_forward = lambda params, state, b, rng: fwd(
        params, state.variables, b["src_img"], b["camera"], b["secc_cond"], rng)
    records, restore = record_draws()
    try:
        images = jtask.val_images(jstate, jbatch, jax.random.PRNGKey(0))
        jax.effects_barrier()
    finally:
        restore()
    return jtask, ptask, batch, jstate, pstate, images, list(records)


def test_val_images_match_jax(val_setup):
    # the same names and sizes; uint8 panels within 2 levels but for a few
    # pixels, the depth colour maps (a min-max normalised depth through a
    # colour table) within a few levels on average
    _, ptask, batch, _, pstate, want, records = val_setup
    draws = ReplayDraws(records)
    got = ptask.val_images(pstate, ptask.to_device(batch), draws)
    assert not draws.records, "the port drew less than the JAX task"
    assert list(got) == list(want)
    for name, w in want.items():
        g = np.asarray(got[name]).astype(np.int32)
        w = np.asarray(w).astype(np.int32)
        assert g.shape == w.shape and got[name].dtype == np.uint8, name
        diff = np.abs(g - w)
        if name.startswith("depth"):
            assert diff.mean() <= 2.0, f"{name}: mean {diff.mean():.3f}"
        else:
            assert (diff > 2).mean() <= 0.001 and diff.mean() <= 0.05, (
                f"{name}: {(diff > 2).mean():.4f} beyond 2 levels, mean {diff.mean():.4f}")


def test_ood_probe_matches_jax(val_setup):
    jtask, ptask, *_ = val_setup
    got, want = ptask.ood_probe_batch(), jtask.ood_probe_batch()
    assert set(got) == set(want)
    for k in ("src_img", "tgt_img", "secc_cond"):
        assert_secc_agree(got[k], want[k], f"ood {k}")
    for k in ("camera", "camera_src"):
        agree(got[k], want[k], 1e-5, 1e-6, f"ood {k}")
    assert ptask.ood_probe_batch() is got, "the probe is made once"


def test_ood_probe_from_an_image_matches_jax(store, tmp_path):
    # cfg['ood_image']: the image's segmented head crop is the probe image
    # (equal to JAX's); with cfg['ood_landmarks'] the coefficients are
    # fitted to them on the task's device, so the maps move
    import cv2

    path = str(tmp_path / "ood.png")
    cv2.imwrite(path, np.random.RandomState(5).randint(0, 256, (40, 40, 3), dtype=np.uint8))
    jtask, ptask = _tasks(store, False, ood_image=path)
    got, want = ptask.ood_probe_batch(), jtask.ood_probe_batch()
    assert set(got) == set(want)
    agree(got["src_img"], want["src_img"], 1e-6, 1e-7, "ood image")
    assert_secc_agree(got["secc_cond"], want["secc_cond"], "ood secc from an image")
    lm = str(tmp_path / "lm.npy")
    np.save(lm, 0.5 + 0.1 * np.random.RandomState(6).randn(68, 2).astype(np.float32))
    _, fitted = _tasks(store, False, ood_image=path, ood_landmarks=lm)
    probe = fitted.ood_probe_batch()
    assert probe["secc_cond"].shape == got["secc_cond"].shape
    assert torch.isfinite(probe["secc_cond"]).all()
    assert not torch.equal(probe["secc_cond"], got["secc_cond"]), "the fit moved nothing"


def test_torso_ood_probe_has_torso_inputs(store):
    jtask, ptask = _tasks(store, True)
    got, want = ptask.ood_probe_batch(), jtask.ood_probe_batch()
    assert set(got) == set(want)
    for k in ("segmap", "kp_src", "kp_drv"):
        np.testing.assert_array_equal(to_np(got[k]), np.asarray(want[k]), err_msg=k)


def test_dump_val_images_names_match_jax(val_setup, tmp_path):
    # the port's trainer writes what the JAX trainer writes, under the same
    # paths; the JAX side dumps its own task's images
    jtask, ptask, batch, jstate, pstate, images, _ = val_setup

    class JaxImages:
        def val_data(self):
            yield batch

        def val_images(self, state, b, rng):
            return images

    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_paths = JaxTrainer.dump_val_images(
        SimpleNamespace(task=JaxImages(), cfg={}, work_dir=jdir), jstate, 7)
    trainer = SimpleNamespace(task=ptask, cfg={}, work_dir=pdir)
    paths = Trainer.dump_val_images(trainer, pstate, 7)
    rel = sorted(os.path.relpath(p, pdir) for p in paths)
    assert rel == sorted(os.path.relpath(p, jdir) for p in jax_paths)
    assert rel[0].startswith(os.path.join("val_images", "iter7", "")) and len(rel) == 3
    assert all(os.path.getsize(p) > 0 for p in paths)
    trainer.cfg["save_val_images"] = False
    assert Trainer.dump_val_images(trainer, pstate, 8) == []


def test_perceptual_v2_matches_jax(tmp_path):
    # seeded VGG19 and VGGFace trees written as msgpack: the config picks
    # vgg19_v2 in both packages; the criterion (512^2 antialiased resize,
    # three halvings without) agrees within 1e-4 of scale
    from flax import serialization

    v19 = JP.init_vgg19_params(np.random.RandomState(0))
    face = JP.init_vggface_params(np.random.RandomState(1))
    for a, b in ((v19, P.init_vgg19_params(np.random.RandomState(0))),
                 (face, P.init_vggface_params(np.random.RandomState(1)))):
        assert all(np.array_equal(a[k]["kernel"], b[k]["kernel"]) for k in a)
    cfg = {}
    for name, tree in (("vgg19_ckpt", v19), ("vggface_ckpt", face)):
        path = str(tmp_path / f"{name}.msgpack")
        with open(path, "wb") as f:
            f.write(serialization.msgpack_serialize(tree))
        cfg[name] = path
    fn, kind = P.make_perceptual_fn(cfg)
    jfn, jkind = JP.make_perceptual_fn(cfg)
    assert kind == jkind == "vgg19_v2"
    pred, tgt = np.random.RandomState(2).uniform(-1, 1, (2, 1, 24, 24, 3)).astype(np.float32)
    with torch.no_grad():
        val = fn(t(pred), t(tgt))
    agree(val, jax.jit(jfn)(jnp.asarray(pred), jnp.asarray(tgt)), 1e-4, 1e-4, "perceptual_v2")
    assert P.make_perceptual_fn({**cfg, "lpips_mode": "vgg19"})[1] == "vgg19"
    assert P.make_perceptual_fn({"vgg19_ckpt": cfg["vgg19_ckpt"]})[1] == "vgg19"


def _shrink_bound(rast, jax_rast, size):
    """The raster's difference at full size taken through the (positive,
    normalised) antialiased filter: |resize(a) - resize(b)| <=
    resize(|a - b|)."""
    diff = np.abs(to_np(rast) - np.asarray(jax_rast))
    return np.asarray(jax.image.resize(jnp.asarray(diff), (diff.shape[0], size, size,
                                                            diff.shape[-1]), "bilinear"))


def _coeffs(n, seed):
    rng = np.random.RandomState(seed)
    zero = np.zeros((n, 3), np.float32)
    return ((rng.randn(n, 80) * 0.5).astype(np.float32),
            (rng.randn(n, 64) * 0.5).astype(np.float32), zero, zero)


def test_secc_renderer_shrink_matches_jax():
    # rasterized at 64^2 and shrunk to 32^2, as the record path shrinks:
    # JAX's resize antialiases there, so the port's must (plain bilinear
    # differs from it by up to ~0.5 on these maps)
    coeffs = _coeffs(3, 4)
    out = {}
    for size in (64, 32):
        jm, js = JaxSECCRenderer(jbfm.synthetic_bfm(512), rasterize_size=64,
                                 output_resolution=size).render(*map(jnp.asarray, coeffs))
        tm, ts = SECCRenderer(bfm.synthetic_bfm(512), rasterize_size=64, output_resolution=size,
                              device="cpu").render(*map(t, coeffs))
        out[size] = (jm, js, tm, ts)
    jm, js, tm, ts = out[64]
    bound_s, bound_m = _shrink_bound(ts, js, 32), _shrink_bound(tm, jm, 32)
    jm, js, tm, ts = out[32]
    assert ts.shape == (3, 32, 32, 3) and tm.shape == (3, 32, 32, 1)
    assert np.all(np.abs(to_np(ts) - np.asarray(js)) <= bound_s + 1e-5)
    assert np.all(np.abs(to_np(tm) - np.asarray(jm)) <= bound_m + 1e-5)


def test_pipeline_secc_renderer_shrinks_as_jax():
    # the inference pipeline at a final resolution below its raster's
    from real3dportrait_tpu_torch.config import load_config
    from real3dportrait_tpu_torch.inference.pipeline import Real3DPortraitPipeline

    cfg = load_config(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "configs", "secc_img2plane_torso.yaml"), dict(
            final_resolution=32, neural_rendering_resolution=16, secc_resolution=64,
            sr_channel0=16, sr_channel1=8, torso_model_scale="tiny"))
    pipe = Real3DPortraitPipeline(cfg, use_torso=False, device="cpu",
                                  assets=bfm.synthetic_bfm(512))
    coeffs = _coeffs(2, 5)
    _, got = pipe.secc_renderer.render(*map(t, coeffs))
    renders = {size: JaxSECCRenderer(jbfm.synthetic_bfm(512), rasterize_size=64,
                                     output_resolution=size).render(*map(jnp.asarray, coeffs))
               for size in (64, 32)}
    _, full = SECCRenderer(bfm.synthetic_bfm(512), rasterize_size=64, device="cpu").render(
        *map(t, coeffs))
    bound = _shrink_bound(full, renders[64][1], 32)
    assert got.shape == (2, 32, 32, 3)
    assert np.all(np.abs(to_np(got) - np.asarray(renders[32][1])) <= bound + 1e-5)

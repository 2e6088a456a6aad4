"""Parity of the port's SyncNet (``models/syncnet.py``) and its training task
(``training/tasks/syncnet_task.py``) with the JAX package: the model in both
norm modes on carried weights, the two losses, one Adam step (and two with
gradient accumulation) against ``optax``, and a checkpoint of the port that
the JAX package's ``partial_load`` restores."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from real3dportrait_tpu.config import load_config as jax_load_config
from real3dportrait_tpu.models import syncnet as jsync
from real3dportrait_tpu.training import checkpoint as jckpt
from real3dportrait_tpu.training.tasks.base_task import resolve_task as jax_resolve_task
from real3dportrait_tpu_torch.config import load_config
from real3dportrait_tpu_torch.models import syncnet as sync
from real3dportrait_tpu_torch.training import checkpoint as ckpt
from real3dportrait_tpu_torch.training.schedulers import Adam
from real3dportrait_tpu_torch.training.tasks.base_task import resolve_task
from tests._torch_parity import agree, jax_run, load_from_jax, t, to_np
from tests._torch_train_parity import agree_trees

CONFIG = "configs/audio_lm3d_syncnet.yaml"
SMALL = {"syncnet_base_hid_size": 16, "syncnet_out_hid_size": 32, "batch_size": 6,
         "syncnet_num_layers_per_block": 2,
         "syncnet_keypoint_mode": "lip"}


def clips(b: int, lm_dim: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, 10, 1024).astype(np.float32), rng.randn(b, 5, lm_dim).astype(
        np.float32), (rng.rand(b) > 0.5).astype(np.float32))


@pytest.mark.parametrize("norm_mode", ["gn", "affine"])
@pytest.mark.parametrize("lm_dim,layers", [(60, 3), (1404, 2)])
def test_syncnet_matches_jax(norm_mode, lm_dim, layers):
    kw = dict(lm_dim=lm_dim, num_layers_per_block=layers, base_hid_size=16, out_dim=32,
              norm_mode=norm_mode)
    hub, mouth, _ = clips(3, lm_dim)
    variables, (ja, jm) = jax_run(jsync.LandmarkHubertSyncNet(**kw), hub, mouth)
    model = load_from_jax(sync.LandmarkHubertSyncNet(**kw), variables)
    with torch.no_grad():
        pa, pm = model(t(hub), t(mouth))
    agree(pa, ja, 1e-5, 1e-6, f"audio embedding {norm_mode}")
    agree(pm, jm, 1e-5, 1e-6, f"mouth embedding {norm_mode}")
    assert np.allclose(np.linalg.norm(to_np(pa), axis=-1), 1.0, atol=1e-5)


def test_sync_and_clip_losses_match_jax():
    rng = np.random.RandomState(1)
    a, m = rng.randn(2, 8, 32).astype(np.float32)
    a, m = a / np.linalg.norm(a, axis=-1, keepdims=True), m / np.linalg.norm(m, axis=-1,
                                                                              keepdims=True)
    label = (rng.rand(8) > 0.5).astype(np.float32)
    for lab in (label, 1.0, 0.0):
        got, want = sync.cal_sync_loss(t(a), t(m), lab), jsync.cal_sync_loss(a, m, lab)
        for g, w, what in zip(got, want, ("loss", "similarity")):
            agree(g, w, 1e-6, 1e-7, f"cal_sync_loss {what}")
    for scale in (1.0, 7.5):
        got, want = sync.clip_loss(t(a), t(m), scale), jsync.clip_loss(a, m, scale)
        assert set(got) == set(want)
        for k in want:
            agree(got[k], want[k], 1e-6, 1e-6, f"clip_loss {k}")


def _tasks(overrides: dict):
    over = {**SMALL, **overrides}
    return (jax_resolve_task(jax_load_config(CONFIG, overrides=over)),
            resolve_task(load_config(CONFIG, over), torch.device("cpu")))


@pytest.mark.parametrize("accumulate", [1, 2])
def test_syncnet_task_steps_match_optax(accumulate):
    # steps of the port's task against the JAX task's jitted step, from the
    # JAX task's initial weights and optimiser state, with weights, moments
    # and batches in float64 on both sides: in fp32 Adam divides each
    # gradient element by its own magnitude, so an element whose gradient is
    # rounding noise in both frameworks (a conv bias before a GroupNorm,
    # whose gradient cancels) takes updates that differ by a share of lr.
    # One update (``accumulate`` micro-steps): the port keeps optax's fp32
    # bias correction, which optax computes in float64 here (a 7e-6
    # relative difference of an update), and a second update would carry it
    # into the gradients. The checkpoint trees are fp32, hence 1e-6 there.
    jtask, ptask = _tasks({"accumulate_grad_batches": accumulate})
    assert ptask.lm_dim == jtask.lm_dim == 60
    with jax.enable_x64(True):
        jstate = jax.jit(jtask.build)(jax.random.PRNGKey(0))
        jstate = jstate.replace(params=jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float64), jstate.params))
        jstate = jstate.replace(opt_states={"syncnet": jax.jit(jtask.optimizer.init)(
            jstate.params["syncnet"])})
        pstate = ptask.build(0)
        pstate.model.double()
        pstate.opt = Adam(dict(pstate.model.named_parameters()), ptask.schedule,
                          every_k=accumulate)
        pstate.load_state_dict(jax.tree_util.tree_map(np.asarray,
                                                      serialization.to_state_dict(jstate)))
        jstep = jax.jit(jtask.train_step)
        for i in range(accumulate):
            hub, mouth, label = clips(6, 60, seed=10 + i)
            batch = {"hubert_clip": hub, "mouth_clip": mouth, "label": label}
            jstate, jm = jstep(jstate, jax.tree_util.tree_map(
                lambda x: jnp.asarray(x, jnp.float64), batch), None)
            pm = ptask.train_step(pstate, {k: torch.from_numpy(v).double()
                                           for k, v in batch.items()})
            for k in ("total_loss", "sync_bce", "cos_sim"):
                agree(pm[k], jm[k], 1e-9, 1e-9, f"step {i} {k}")
        want = jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(jstate))
    got = pstate.state_dict()
    assert int(got["step"]) == int(want["step"]) == accumulate
    gopt, wopt = got["opt_states"]["syncnet"], want["opt_states"]["syncnet"]
    if accumulate > 1:
        assert int(gopt["mini_step"]) == 0 and int(gopt["gradient_step"]) == 1
        gopt, wopt = gopt["inner_opt_state"], wopt["inner_opt_state"]
    assert int(gopt["0"]["count"]) == int(gopt["1"]["count"]) == 1
    for m in ("mu", "nu"):
        agree_trees(gopt["0"][m], wopt["0"][m], 1e-6, 1e-7, f"adam {m}")
    # parameters within 1e-5 of the tree's scale
    leaves = jax.tree_util.tree_leaves_with_path(want["params"])
    top = max(float(np.abs(w).max()) for _, w in leaves)
    for path, w in leaves:
        g = got["params"]
        for key in path:
            g = g[key.key]
        err = np.abs(g - w).max()
        assert err <= 1e-5 * top, f"{jax.tree_util.keystr(path)}: {err:.3e} / {top:.3e}"


def test_port_checkpoint_restores_in_jax(tmp_path):
    # the port writes its task's checkpoint; JAX's partial_load merges every
    # leaf into the JAX task's state, and the audio-to-motion stage's
    # prefix map finds the SyncNet's weights
    jtask, ptask = _tasks({"accumulate_grad_batches": 2})
    pstate = ptask.build(3)
    hub, mouth, label = clips(6, 60, seed=4)
    ptask.train_step(pstate, ptask.to_device({"hubert_clip": hub, "mouth_clip": mouth,
                                              "label": label}))
    ckpt.save_checkpoint(str(tmp_path), pstate.step, pstate.state_dict())
    src, path = jckpt.get_last_checkpoint(str(tmp_path))
    assert path.endswith("model_ckpt_steps_1.ckpt")
    jstate = jax.jit(jtask.build)(jax.random.PRNGKey(0))
    merged, stats = jckpt.partial_load(serialization.to_state_dict(jstate), src)
    assert stats["missing"] == 0 and stats["shape_mismatch"] == 0
    restored = serialization.from_state_dict(jstate, merged)
    want = pstate.state_dict()
    assert int(restored.step) == 1
    flat = dict(jax.tree_util.tree_leaves_with_path(restored.params["syncnet"]))
    ref = dict(jax.tree_util.tree_leaves_with_path(want["params"]["syncnet"]))
    assert set(flat) == set(ref)
    assert all(np.array_equal(np.asarray(flat[k]), ref[k]) for k in ref)
    sv = {"p": jax.jit(jtask.model.init)(jax.random.PRNGKey(1), jnp.zeros((1, 10, 1024)),
                                         jnp.zeros((1, 5, 60)))["params"]}
    merged, stats = jckpt.partial_load(serialization.to_state_dict(sv), src["params"],
                                       prefix_map={"syncnet": "p"})
    assert stats["missing"] == 0 and stats["loaded"] == len(ref)
    # and the port reads its own file back
    fresh = ptask.build(9)
    fresh.load_state_dict(ckpt.load_checkpoint(path))
    assert all(torch.equal(a, b) for a, b in zip(fresh.model.state_dict().values(),
                                                  pstate.model.state_dict().values()))
    assert fresh.opt.mini_step == pstate.opt.mini_step == 1


@pytest.mark.parametrize("kind", ["exponential", "rsqrt", "cosine", "none"])
def test_build_schedule_matches_jax(kind):
    # the config-named schedule in fp32, at the steps of a long run
    from real3dportrait_tpu.training.schedulers import build_schedule as jax_build_schedule
    from real3dportrait_tpu_torch.training.schedulers import build_schedule

    cfg = {"scheduler": kind, "lr": 2e-3, "warmup_updates": 300, "max_updates": 5000,
           "lr_decay_rate": 0.9, "lr_decay_interval": 700, "hidden_size": 192}
    got, want = build_schedule(cfg), jax_build_schedule(cfg)
    for step in (0, 1, 150, 299, 300, 301, 2500, 4999, 7000):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6, abs=1e-12), step

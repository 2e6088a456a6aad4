"""Parity of the port's audio-to-motion training (``models/audio2motion.py``'s
training branch, ``training/tasks/audio2motion_task.py``) with the JAX
package: the FVAE training branch at the JAX posterior draw, the task's
losses and one clipped Adam update (with gradient accumulation) against
``optax``, the frozen SyncNet read from a port ``SyncNetTask`` checkpoint
through ``partial_load(prefix_map=...)``, and the checkpoints both ways."""

import contextlib
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from real3dportrait_tpu.config import load_config as jax_load_config
from real3dportrait_tpu.models import audio2motion as ja2m
from real3dportrait_tpu.training import checkpoint as jckpt
from real3dportrait_tpu.training.tasks.base_task import resolve_task as jax_resolve_task
from real3dportrait_tpu_torch.config import load_config
from real3dportrait_tpu_torch.models import audio2motion as a2m
from real3dportrait_tpu_torch.training import checkpoint as ckpt
from real3dportrait_tpu_torch.training.schedulers import Adam
from real3dportrait_tpu_torch.training.tasks.base_task import resolve_task
from real3dportrait_tpu_torch.utils.draws import ReplayDraws
from tests._torch_parity import agree, load_from_jax, random_like, to_np
from tests._torch_train_parity import agree_trees, record_draws

CONFIG = "configs/audio2motion_vae.yaml"
SYNC_CONFIG = "configs/audio_lm3d_syncnet.yaml"
# short clips, a KL ramp of two steps (so that the KL counts at step 1)
SMALL = {"batch_size": 2, "sample_min_length": 16, "lambda_kl_t1": 2, "lambda_kl_t2": 2,
         "lambda_kl": 0.5}
SYNC_SMALL = {"syncnet_base_hid_size": 16, "syncnet_out_hid_size": 32,
              "syncnet_keypoint_mode": "lm468", "batch_size": 4}


@pytest.fixture
def work(tmp_path):
    """A temporary dir, removed after the test: the checkpoints it holds
    (a full-width audio-to-motion model's is ~176 MB) would otherwise stay
    under pytest's kept temp dirs."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _batch(seed: int, b: int = 2, t50: int = 32, ragged: bool = False) -> dict:
    rng = np.random.RandomState(seed)
    mask = np.ones((b, t50 // 2), np.float32)
    if ragged:
        mask[1, t50 // 2 - 5:] = 0.0
    return {"audio": rng.randn(b, t50, 1024).astype(np.float32),
            "f0": (np.abs(rng.randn(b, t50)) * 200).astype(np.float32),
            "y": (rng.randn(b, t50 // 2, 64) * 0.1).astype(np.float32),
            "y_mask": mask,
            "blink": (rng.rand(b, t50, 1) > 0.8).astype(np.int32),
            "mouth_amp": rng.uniform(0.2, 0.6, (b, 1)).astype(np.float32)}


@pytest.mark.parametrize("ragged", [False, True])
def test_fvae_training_branch_matches_jax(ragged):
    # the model's train=True forward at the JAX posterior draw (recorded,
    # replayed): reconstruction, KL, the flowed latent and the posterior;
    # with a ragged mask the encoder's strided mask and the decoder's full
    # mask both matter. fp32 on both sides: 1e-5 / 1e-6 of scale.
    batch = _batch(0, ragged=ragged)
    model = ja2m.PitchContourVAEModel()
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, jb, train=True))
    variables = random_like(shapes, seed=3)
    records, restore = record_draws()
    try:
        want = jax.jit(lambda v, b: model.apply(v, b, train=True, rngs={
            "noise": jax.random.PRNGKey(7)}))(variables, jb)
        jax.block_until_ready(want)
    finally:
        restore()
    assert [k for k, _ in records] == ["normal"] and records[0][1].shape == (2, 4, 16)
    port = load_from_jax(a2m.PitchContourVAEModel(), variables)
    with torch.no_grad():
        got = port({k: torch.from_numpy(v) for k, v in batch.items()}, train=True,
                   draws=ReplayDraws(records))
    for k in ("pred", "z_p", "m_q", "logs_q"):
        agree(got[k], want[k], 1e-5, 1e-6, f"train branch {k}")
    agree(got["loss_kl"], want["loss_kl"], 1e-5, 1e-5, "loss_kl")


@contextlib.contextmanager
def _x64():
    """JAX in float64 for the block (the global flag, restored after: the
    ``jax.enable_x64`` context leaves the jitted step's default dtypes, its
    random draws among them, in fp32)."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


def _double(tree):
    """Float leaves to float64 (integer leaves, the blink labels, as they are)."""
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.float64) if jnp.issubdtype(jnp.asarray(x).dtype,
                                                                  jnp.floating)
        else jnp.asarray(x), tree)


def _f32_in_f64(tree):
    """Leaves rounded to fp32 and held in float64: what the checkpoint
    tree (fp32) carries to the port (flax initialisers without a dtype
    draw float64 under x64)."""
    return _double(jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree))


def _tasks(over: dict):
    over = {**SMALL, **over}
    return (jax_resolve_task(jax_load_config(CONFIG, overrides=over)),
            resolve_task(load_config(CONFIG, over), torch.device("cpu")))


def _port_double(ptask, pstate, accumulate: int, clip: float):
    """The port's state in float64: the model, the frozen SyncNet and the
    landmark bases (the JAX side runs under x64 with float64 params)."""
    pstate.model.double()
    if pstate.syncnet is not None:
        pstate.syncnet.double()
    ptask.assets = dataclasses.replace(ptask.assets, **{
        f.name: getattr(ptask.assets, f.name).double()
        for f in dataclasses.fields(ptask.assets)
        if torch.is_tensor(getattr(ptask.assets, f.name))
        and getattr(ptask.assets, f.name).is_floating_point()})
    pstate.opt = Adam(dict(pstate.model.named_parameters()), ptask.schedule,
                      every_k=accumulate, clip_norm=clip)


def _steps_agree(jtask, ptask, jstate, pstate, accumulate: int, sync: bool):
    """``accumulate`` micro-steps on both sides (the JAX step jitted, its
    draws replayed into the port's); returns both checkpoint trees."""
    for i in range(accumulate):
        batch = _batch(20 + i, ragged=i == 1)
        records, restore = record_draws()
        try:
            # traced afresh each micro-step: the trace holds the recorder's list
            jstep = jax.jit(lambda s, b, r: jtask.train_step(s, b, r))
            jstate, jm = jstep(jstate, _double(batch), jax.random.PRNGKey(11 + i))
            jax.block_until_ready(jm)
        finally:
            restore()
        kinds = [k for k, _ in records]
        assert kinds == ["normal", "integers"] if sync else kinds == ["normal"], kinds
        pm = ptask.train_step(pstate, {k: torch.from_numpy(v).double()
                                       if v.dtype == np.float32 else torch.from_numpy(v)
                                       for k, v in batch.items()}, ReplayDraws(records))
        keys = ["mse_exp", "lap_exp", "l2_reg_exp", "kl", "mse_lm3d"] + (
            ["sync"] if sync else []) + ["total_loss", "grad_norm"]
        assert set(keys) <= set(pm)
        for k in keys:
            agree(pm[k], jm[k], 1e-9, 1e-9, f"micro-step {i} {k}")
    return (pstate.state_dict(),
            jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(jstate)))


def _check_update(got: dict, want: dict, accumulate: int) -> None:
    assert int(got["step"]) == int(want["step"]) == accumulate
    gopt, wopt = got["opt_states"]["model"], want["opt_states"]["model"]
    if accumulate > 1:
        assert int(gopt["mini_step"]) == 0 and int(gopt["gradient_step"]) == 1
        gopt, wopt = gopt["inner_opt_state"], wopt["inner_opt_state"]
    # the clip's empty state, then adam's and the schedule's
    assert gopt["0"] == {} == dict(wopt["0"])
    gopt, wopt = gopt["1"], wopt["1"]
    assert int(gopt["0"]["count"]) == int(gopt["1"]["count"]) == 1
    for m in ("mu", "nu"):
        agree_trees(gopt["0"][m], wopt["0"][m], 1e-6, 1e-7, f"adam {m}")
    leaves = jax.tree_util.tree_leaves_with_path(want["params"]["model"])
    top = max(float(np.abs(w).max()) for _, w in leaves)
    for path, w in leaves:
        g = got["params"]["model"]
        for key in path:
            g = g[key.key]
        err = np.abs(g - w).max()
        assert err <= 1e-5 * top, f"{jax.tree_util.keystr(path)}: {err:.3e} / {top:.3e}"


@pytest.mark.parametrize("accumulate", [1, 2])
def test_a2m_train_step_clipped_matches_optax(accumulate):
    # the task's losses and one update (``accumulate`` micro-steps) against
    # the JAX task's jitted step, from the JAX task's weights, in float64 on
    # both sides (in fp32 Adam's first update is the sign of each gradient
    # element, so elements whose gradient is rounding noise would differ
    # by 2 lr). The clip norm is tiny, so the clip scales every update: the
    # moments (1e-6 / 1e-7 of each leaf's scale) show it, and the updates
    # (1e-5 of the tree's scale) too, where the clipped elements come near
    # Adam's eps. Losses and the unclipped gradient norm agree to 1e-9.
    clip = 1e-3
    jtask, ptask = _tasks({"accumulate_grad_batches": accumulate, "clip_grad_norm": clip})
    with _x64():
        jstate = jax.jit(jtask.build)(jax.random.PRNGKey(0))
        jstate = jstate.replace(params=_f32_in_f64(jstate.params))
        jstate = jstate.replace(opt_states={"model": jax.jit(jtask.optimizer.init)(
            jstate.params["model"])})
        pstate = ptask.build(0)
        _port_double(ptask, pstate, accumulate, clip)
        pstate.load_state_dict(jax.tree_util.tree_map(np.asarray,
                                                      serialization.to_state_dict(jstate)))
        got, want = _steps_agree(jtask, ptask, jstate, pstate, accumulate, sync=False)
    _check_update(got, want, accumulate)


def _syncnet_ckpt(root) -> str:
    """A port ``SyncNetTask`` (lm468, small widths) after one step, saved
    in its work dir."""
    task = resolve_task(load_config(SYNC_CONFIG, SYNC_SMALL), torch.device("cpu"))
    state = task.build(5)
    rng = np.random.RandomState(2)
    task.train_step(state, task.to_device(task.synthetic_batch(rng)))
    sync_dir = str(root / "syncnet")
    ckpt.save_checkpoint(sync_dir, state.step, state.state_dict())
    return sync_dir


def test_a2m_step_with_frozen_syncnet(work):
    # the SyncNet a port SyncNetTask wrote, read by both packages' builds
    # through the prefix map (equal weights); one step with the sync loss
    # against JAX's, the SyncNet's params unchanged and left out of the
    # optimiser on both sides
    sync_dir = _syncnet_ckpt(work)
    over = {"syncnet_ckpt_dir": sync_dir, "lambda_sync": 0.3, "syncnet_num_clip_pairs": 384,
            "syncnet_base_hid_size": 16, "syncnet_out_hid_size": 32, "clip_grad_norm": 0.05}
    jtask, ptask = _tasks(over)
    assert jtask.use_syncnet and ptask.use_syncnet
    stored = ckpt.load_checkpoint(ckpt.get_last_checkpoint(sync_dir)[1])["params"]["syncnet"]
    pstate = ptask.build(0)
    flat = dict(jax.tree_util.tree_leaves_with_path(stored))
    mine = dict(jax.tree_util.tree_leaves_with_path(pstate.state_dict()["params"]["syncnet"]))
    assert set(flat) == set(mine) and all(np.array_equal(mine[k], flat[k]) for k in flat)
    with _x64():
        jstate = jax.jit(jtask.build)(jax.random.PRNGKey(0))
        jsync = dict(jax.tree_util.tree_leaves_with_path(jstate.params["syncnet"]))
        assert all(np.array_equal(np.asarray(jsync[k]), flat[k]) for k in flat)
        assert set(jstate.opt_states) == {"model"}
        jstate = jstate.replace(params=_f32_in_f64(jstate.params))
        jstate = jstate.replace(opt_states={"model": jax.jit(jtask.optimizer.init)(
            jstate.params["model"])})
        _port_double(ptask, pstate, 1, 0.05)
        pstate.load_state_dict(jax.tree_util.tree_map(np.asarray,
                                                      serialization.to_state_dict(jstate)))
        before = {k: v.clone() for k, v in pstate.syncnet.state_dict().items()}
        got, want = _steps_agree(jtask, ptask, jstate, pstate, 1, sync=True)
    assert all(torch.equal(before[k], v) for k, v in pstate.syncnet.state_dict().items())
    assert set(got["opt_states"]) == {"model"}
    _check_update(got, want, 1)


def test_a2m_checkpoints_both_ways(work):
    # the port's checkpoint (accumulating, clipped) restores in the JAX
    # trainer's way (partial_load into the JAX task's state: every leaf
    # loaded), and a JAX checkpoint loads strictly into the port's state
    jtask, ptask = _tasks({"accumulate_grad_batches": 2})
    pstate = ptask.build(4)
    ptask.train_step(pstate, ptask.to_device(_batch(1)),
                     ReplayDraws([("normal", np.zeros((2, 4, 16), np.float32))]))
    ckpt.save_checkpoint(str(work), pstate.step, pstate.state_dict())
    src, path = jckpt.get_last_checkpoint(str(work))
    jstate = jax.jit(jtask.build)(jax.random.PRNGKey(0))
    merged, stats = jckpt.partial_load(serialization.to_state_dict(jstate), src)
    assert stats["missing"] == 0 and stats["shape_mismatch"] == 0
    restored = serialization.from_state_dict(jstate, merged)
    assert int(restored.step) == 1 and int(restored.opt_states["model"].mini_step) == 1
    want = pstate.state_dict()["params"]["model"]
    flat = dict(jax.tree_util.tree_leaves_with_path(restored.params["model"]))
    assert all(np.array_equal(np.asarray(flat[k]), v)
               for k, v in jax.tree_util.tree_leaves_with_path(want))
    # JAX -> port
    jtree = jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(jstate))
    jckpt.save_checkpoint(str(work / "jax"), 0, serialization.to_state_dict(jstate))
    fresh = ptask.build(9)
    fresh.load_state_dict(ckpt.load_checkpoint(ckpt.get_last_checkpoint(
        str(work / "jax"))[1]))
    got = fresh.state_dict()["params"]["model"]
    assert all(np.array_equal(to_np(v), np.asarray(dict(
        jax.tree_util.tree_leaves_with_path(jtree["params"]["model"]))[k]))
        for k, v in jax.tree_util.tree_leaves_with_path(got))

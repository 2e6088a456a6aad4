"""Parity of the port's img2plane distillation
(``training/tasks/img2plane_task.py``) with the JAX package at tiny widths:
the frozen teacher's ``prepare_batch``, the student's losses and
gradients, one train step on each side of ``start_adv_iters`` (with the
decoder and SR update gates) from the same state, and the checkpoints
both ways (the teacher kept, as JAX keeps it)."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from real3dportrait_tpu.config import load_config as jax_load_config
from real3dportrait_tpu.training import checkpoint as jckpt
from real3dportrait_tpu.training.tasks.base_task import resolve_task as jax_resolve_task
from real3dportrait_tpu.training.train_state import TrainState as JaxTrainState
from real3dportrait_tpu_torch.config import load_config
from real3dportrait_tpu_torch.training import checkpoint as ckpt
from real3dportrait_tpu_torch.training.tasks.base_task import resolve_task
from real3dportrait_tpu_torch.training.tasks.eg3d_task import grads_of
from real3dportrait_tpu_torch.utils.draws import ReplayDraws
from tests._torch_parity import agree, random_like
from tests._torch_train_parity import agree_trees, record_draws, tree_of

CONFIG = "configs/img2plane.yaml"
# tiny teacher and student: 32^2 teacher planes, 16^2 renders, 64^2 SR,
# depth-2 tri-grids; the adversarial loss and the gates from step 1
TINY = {"batch_size": 2, "z_dim": 16, "w_dim": 16, "teacher_plane_resolution": 32,
        "neural_rendering_resolution": 16, "final_resolution": 64, "base_channel": 256,
        "max_channel": 32, "num_samples_coarse": 6, "num_samples_fine": 6,
        "num_fp16_layers_in_super_resolution": 0, "num_fp16_layers_in_discriminator": 0,
        "group_size_for_mini_batch_std": 2, "reg_interval_d": 2, "triplane_depth": 2,
        "sr_channel0": 16, "sr_channel1": 8, "start_adv_iters": 1}


@pytest.fixture
def work(tmp_path):
    """A temporary dir, removed after the test: the checkpoints it holds
    (a full-width audio-to-motion model's is ~176 MB) would otherwise stay
    under pytest's kept temp dirs."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _tasks():
    return (jax_resolve_task(jax_load_config(CONFIG, overrides=TINY)),
            resolve_task(load_config(CONFIG, TINY), torch.device("cpu")))


def _jax_state(jtask, batch: dict, seed: int = 0) -> JaxTrainState:
    """Seeded leaves on the three inits' trees (no init compile)."""
    b = batch["camera"].shape[0]
    final = jtask.student.final_resolution
    res = jtask.student.neural_rendering_resolution
    img = jnp.zeros((b, final, final, 3))
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    sshape = jax.eval_shape(lambda: jtask.student.init(rngs, img, batch["camera"]))
    tshape = jax.eval_shape(lambda: jtask.teacher.init(
        rngs, jnp.zeros((b, jtask.teacher.z_dim)), batch["camera"]))
    dshape = jax.eval_shape(lambda: jtask.disc.init(
        jax.random.PRNGKey(2), img, jnp.zeros((b, res, res, 3)), batch["camera"]))
    sv, tv, dv = (random_like(s, seed + i) for i, s in enumerate((sshape, tshape, dshape)))
    params = jax.tree_util.tree_map(jnp.asarray, {"student": sv["params"],
                                                  "teacher": tv["params"],
                                                  "disc": dv["params"]})

    def rest(v):
        return {k: jax.tree_util.tree_map(jnp.asarray, x) for k, x in v.items()
                if k != "params"}

    return JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        variables={"student": rest(sv), "teacher": rest(tv)},
        opt_states={"gen": jtask.opt_g.init(params["student"]),
                    "disc": jtask.opt_d.init(params["disc"])}, extra={})


def _tree(state) -> dict:
    return jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(state))


@pytest.fixture(scope="module")
def setup():
    """The JAX task's jitted step at steps 0 and 1 (each from the same
    seeded state, draws recorded), and its prepared batch and student
    gradients at step 1."""
    jtask, ptask = _tasks()
    batch = jtask.synthetic_batch(np.random.RandomState(0))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jstate = _jax_state(jtask, jbatch)
    out = {}
    for step in (0, 1):
        st = jstate.replace(step=jnp.asarray(step, jnp.int32))
        records, restore = record_draws()
        try:
            new, metrics = jax.jit(lambda s, b, r: jtask.train_step(s, b, r))(
                st, jbatch, jax.random.PRNGKey(4 + step))
            jax.effects_barrier()
        finally:
            restore()
        out[step] = dict(before=_tree(st), after=_tree(new), metrics=metrics,
                         draws=list(records))
    st = jstate.replace(step=jnp.asarray(1, jnp.int32))
    records, restore = record_draws()
    try:
        prepared = jax.jit(jtask.prepare_batch)(st, jbatch, jax.random.PRNGKey(9))
        (total, (losses, _)), grads = jax.jit(jax.value_and_grad(jtask._g_loss, has_aux=True))(
            st.params["student"], st.params["disc"], st, prepared, jax.random.PRNGKey(1))
        jax.effects_barrier()
    finally:
        restore()
    out["loss"] = dict(prepared=prepared, total=total, losses=losses, grads=grads,
                       draws=list(records), state=_tree(st))
    return jtask, ptask, batch, out


def test_prepare_batch_matches_jax(setup):
    # the teacher's two views of one latent (JAX's, replayed), const noise,
    # fp32: 1e-4 / 1e-5 of scale
    _, ptask, batch, out = setup
    ref = out["loss"]
    assert [k for k, _ in ref["draws"]] == ["normal"]
    pstate = ptask.build(0)
    pstate.load_state_dict(ref["state"])
    got = ptask.prepare_batch(pstate, ptask.to_device(batch), ReplayDraws(ref["draws"]))
    assert set(got) == set(ref["prepared"])
    for k in ("ref_img", "ref_raw", "mv_img", "mv_raw"):
        assert not got[k].requires_grad
        agree(got[k], ref["prepared"][k], 1e-4, 1e-5, k)


def test_g_loss_and_grads_match_jax(setup):
    # the student's losses at step 1 (the adversarial loss on) from the JAX
    # prepared batch, at 1e-5; its gradients within 1e-4 / 1e-5 of each leaf
    _, ptask, _, out = setup
    ref = out["loss"]
    pstate = ptask.build(0)
    pstate.load_state_dict(ref["state"])
    prepared = {k: torch.from_numpy(np.asarray(v)) for k, v in ref["prepared"].items()}
    total, losses, _ = ptask._g_loss(pstate, prepared)
    assert set(losses) == set(ref["losses"]) and float(losses["adv"]) > 0
    for k, v in ref["losses"].items():
        np.testing.assert_allclose(float(losses[k]), float(v), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(float(total), float(ref["total"]), rtol=1e-5)
    grads = grads_of(total, pstate.student)
    agree_trees(tree_of(pstate.student, grads), ref["grads"], 1e-4, 1e-5, "student grad",
                near_zero=1e-3)


@pytest.mark.parametrize("step", [0, 1])
def test_img2plane_train_step_matches_jax(setup, step):
    # one student and one D update from the same state on each side of
    # start_adv_iters (1): at step 0 no adversarial loss, the decoder and
    # the SR head gated off (unchanged on both sides), R1 on; at step 1 all
    # groups train. Losses at 1e-5; Adam's moments (beta1 = 0: mu is the
    # gradient) within 1e-4 / 1e-5 of each leaf; the parameters within 2 lr
    # (the first Adam update is +-lr by each gradient's sign, which rounding
    # noise may flip) and 1e-6 on average; the teacher untouched
    jtask, ptask, batch, out = setup
    ref = out[step]
    assert [k for k, _ in ref["draws"]] == ["normal"]
    pstate = ptask.build(0)
    pstate.load_state_dict(ref["before"])
    draws = ReplayDraws(ref["draws"])
    pm = ptask.train_step(pstate, ptask.to_device(batch), draws)
    assert not draws.records
    for k in ("total_loss", "g/mse_ref", "g/mse_ref_raw", "g/mse_mv", "g/mse_mv_raw",
              "g/percep", "g/adv", "d/loss", "d/r1"):
        np.testing.assert_allclose(float(pm[k]), float(ref["metrics"][k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert (float(pm["g/adv"]) > 0) == (step >= 1) and (float(pm["d/r1"]) > 0) == (step == 0)
    got, want = pstate.state_dict(), ref["after"]
    # the tolerances of the gradient tests (tests/test_torch_train_step.py,
    # tests/test_torch_train_dstep.py), with a floor of 1e-2 of the tree's
    # largest (a bias whose terms cancel): the student's L1 losses, whose
    # sign flips with the last bits where a residual is ~0, as the flagship
    # step's at step 1, 1e-3 / 1e-4; the discriminator's 1e-4 / 1e-5, R1's
    # 1e-3 / 1e-4 where it is added
    for group in ("gen", "disc"):
        tol = (1e-3, 1e-4) if group == "gen" or step == 0 else (1e-4, 1e-5)
        for m in ("mu", "nu"):
            agree_trees(got["opt_states"][group]["0"][m], want["opt_states"][group]["0"][m],
                        *tol, f"{group} {m}", floor=1e-2, near_zero=1e-3)
    before = ref["before"]["params"]["student"]
    for gated in ("decoder", "superresolution"):
        same = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            lambda a, b: bool(np.array_equal(a, b)), got["params"]["student"][gated],
            before[gated]))
        assert all(same) == (step == 0), gated
        assert all(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            lambda a, b: bool(np.array_equal(a, b)), want["params"]["student"][gated],
            before[gated]))) == (step == 0), gated
    for group, lr in (("student", ptask.sched_g(step)), ("disc", 2e-4)):
        flat_w = dict(jax.tree_util.tree_leaves_with_path(want["params"][group]))
        flat_g = dict(jax.tree_util.tree_leaves_with_path(got["params"][group]))
        errs = [np.abs(np.asarray(flat_g[k], np.float64) - flat_w[k]) for k in flat_w]
        assert max(e.max() for e in errs) <= 2 * lr * 1.001, group
        assert np.mean(np.concatenate([e.ravel() for e in errs])) <= 1e-6, group
    jax.tree_util.tree_map(np.testing.assert_array_equal, got["params"]["teacher"],
                           ref["before"]["params"]["teacher"])


def test_img2plane_checkpoints_both_ways(work):
    # the port's trainer-written checkpoint (a validation save, which
    # leaves out not_save_modules: eg3d_model and criterion_lpips name no
    # key of the state, so the teacher stays) restores in the JAX
    # trainer's way; a JAX state's tree loads strictly into the port's
    from real3dportrait_tpu_torch.training.trainer import Trainer

    jtask, ptask = _tasks()
    cfg = dict(ptask.cfg)
    assert list(cfg["not_save_modules"]) == ["eg3d_model", "criterion_lpips"]
    trainer = Trainer(cfg, ptask, str(work))
    pstate = ptask.build(5)
    pstate.step = 3
    trainer.save(pstate, tuple(cfg["not_save_modules"]))
    src, path = jckpt.get_last_checkpoint(str(work))
    assert path.endswith("model_ckpt_steps_3.ckpt") and "teacher" in src["params"]
    batch = jax.tree_util.tree_map(jnp.asarray, jtask.synthetic_batch(
        np.random.RandomState(0)))
    jstate = _jax_state(jtask, batch)
    merged, stats = jckpt.partial_load(serialization.to_state_dict(jstate), src)
    assert stats["missing"] == 0 and stats["shape_mismatch"] == 0
    restored = serialization.from_state_dict(jstate, merged)
    assert int(restored.step) == 3
    want = pstate.state_dict()
    for group in ("student", "teacher", "disc"):
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               _tree(restored)["params"][group], want["params"][group])
    fresh = ptask.build(6)
    fresh.load_state_dict(_tree(jstate))
    back = fresh.state_dict()
    for group in ("student", "teacher", "disc"):
        jax.tree_util.tree_map(np.testing.assert_array_equal, back["params"][group],
                               _tree(jstate)["params"][group])
    jax.tree_util.tree_map(np.testing.assert_array_equal, back["variables"],
                           _tree(jstate)["variables"])


TINY_RUN = {
    "audio2motion_vae.yaml": "batch_size=2,sample_min_length=16",
    "eg3d.yaml": ",".join(f"{k}={v}" for k, v in TINY.items() if k not in (
        "triplane_depth", "sr_channel0", "sr_channel1", "start_adv_iters")),
    "img2plane.yaml": ",".join(f"{k}={v}" for k, v in TINY.items()),
}


@pytest.mark.parametrize("config", sorted(TINY_RUN))
def test_training_run_cli_cpu(work, config):
    # the entry point: without --device it asks for the card (none here);
    # with --device cpu and tiny hparams it takes 2 steps and writes a
    # checkpoint that JAX's reader loads, and a second run resumes from it
    from real3dportrait_tpu_torch.training import run as trun

    base = ["--config", f"configs/{config}", "--exp_name", "run", "--work_dir_root",
            str(work)]
    hp = TINY_RUN[config] + ",tb_log_interval=1,num_sanity_val_steps=0," \
        "val_check_interval=100000"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trun.make_trainer(base + ["--hparams", hp + ",max_updates=2"])
    state = trun.main(base + ["--hparams", hp + ",max_updates=2", "--device", "cpu"])
    assert state.step == 2
    path = ckpt.get_last_checkpoint(str(work / "run"))[1]
    assert path.endswith("model_ckpt_steps_2.ckpt")
    tree = jckpt.load_checkpoint(path)
    assert int(tree["step"]) == 2 and set(tree["params"]) == set(state.state_dict()["params"])
    state = trun.main(base + ["--hparams", hp + ",max_updates=3", "--device", "cpu"])
    assert state.step == 3
    assert ckpt.get_last_checkpoint(str(work / "run"))[1].endswith("model_ckpt_steps_3.ckpt")

"""The port's SECC-to-plane GAN training step against the JAX package's
``SeccImg2PlaneTask`` at tiny widths, the discriminator's side: its loss
with R1 and their gradients (R1 a double backward in the port), the
optimiser, gates, EMA and lambda tuning fed the same gradients, and the
validation step. The generator's side is tests/test_torch_train_step.py."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests._torch_train_parity import agree_trees, jax_state, port_state, tasks, tree_of

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    jtask, ptask = tasks()
    batch = jtask.synthetic_batch(np.random.RandomState(0))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jstate = jax_state(jtask, jbatch)
    pstate = port_state(ptask, jstate)
    return jtask, ptask, batch, jstate, pstate


def test_discriminator_loss_r1_and_grads_match_jax(setup):
    """The D loss on seeded fake images at step 0 (src2src), R1 (a double
    backward in the port) and their parameter gradients, as ``train_step``
    adds them: losses at 1e-5 relative, gradients within 1e-4 of a leaf's
    largest magnitude at most and 1e-5 on average, floored at 1e-2 of the
    tree's (the last layer's bias sums the real and fake logits' opposite
    gradients: its ~1e-7 is what is left of terms 1e3 times larger)."""
    from real3dportrait_tpu.training import losses as JL

    jtask, ptask, batch, jstate, pstate = setup
    st = jstate.replace(step=jnp.asarray(0, jnp.int32))
    b = jtask._maybe_src2src(st, jax.tree_util.tree_map(jnp.asarray, batch))
    rng = np.random.RandomState(9)
    res = jtask.gen.neural_rendering_resolution
    image = rng.uniform(-1, 1, batch["tgt_img"].shape).astype(np.float32)
    image_raw = rng.uniform(-1, 1, (image.shape[0], res, res, 3)).astype(np.float32)
    d_fn = jax.jit(jax.value_and_grad(jtask._d_loss, has_aux=True))
    (d_val, _), d_grads = d_fn(jstate.params["disc"], image, image_raw, b)
    def r1_value(p):
        tgt = b["tgt_img"]
        raw = jax.image.resize(tgt, (tgt.shape[0], res, res, 3), "linear")
        return JL.r1_penalty(lambda i, r, c: jtask.disc.apply({"params": p}, i, r, c),
                             tgt, raw, b["camera"])

    r1_val, r1_grads = jax.jit(jax.value_and_grad(r1_value))(jstate.params["disc"])
    gp_w = 5.0 / 2.0 * 2            # lambda_gradient_penalty / 2 * reg_interval_d
    want = jax.tree_util.tree_map(lambda g, r: g + gp_w * r, d_grads, r1_grads)

    pstate.step = 0
    pb = ptask._maybe_src2src(0, ptask.to_device(batch))
    d_total, grads, r1 = ptask.d_grads(pstate, torch.from_numpy(image),
                                       torch.from_numpy(image_raw), pb)
    np.testing.assert_allclose(float(d_total), float(d_val), rtol=1e-5)
    np.testing.assert_allclose(float(r1), float(r1_val), rtol=1e-4)
    agree_trees(tree_of(pstate.disc, grads), want, 1e-4, 1e-5, "d grad", floor=1e-2)
    # R1 alone is ~1e-7 on these weights and its gradients are sums whose
    # terms cancel to 1e-4 of their size: 1e-3 at most, 1e-4 on average
    # (tests/test_torch_train_disc.py holds R1 at 1e-4 on a better-scaled
    # discriminator)
    r1_port = ptask.grads(ptask._r1(pstate.disc, pb), pstate.disc)
    agree_trees(tree_of(pstate.disc, r1_port), r1_grads, 1e-3, 1e-4, "r1 grad")


def test_optimiser_gates_ema_and_lambdas_match_jax(setup):
    """Both packages fed the same gradients for two steps: the Adam updates
    (b1 = 0) with the per-group gates, the D update, the EMA and the
    lambda tuning agree at 1e-6."""
    from real3dportrait_tpu_torch.weights import torch_state_dict_from_jax

    jtask, ptask, batch, jstate, _ = setup
    pstate = port_state(ptask, jstate)
    j = jstate
    rng = np.random.RandomState(3)
    for step in (0, 1):
        g_grads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.asarray(rng.randn(*x.shape), np.float32)), j.params["gen"])
        d_grads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.asarray(rng.randn(*x.shape), np.float32)), j.params["disc"])
        losses = {"pertube_secc": jnp.asarray(0.02 * (step + 1)),
                  "pertube_blink_secc": jnp.asarray(0.5)}
        # the JAX train_step's update, gates, EMA and lambda tuning
        st = j.replace(step=jnp.asarray(step, jnp.int32))
        upd, g_opt = jtask.opt_g.update(g_grads, st.opt_states["gen"], st.params["gen"])
        upd = jtask._apply_gates(upd, jtask._grad_gates(st.step))
        gen = optax.apply_updates(st.params["gen"], upd)
        dupd, d_opt = jtask.opt_d.update(d_grads, st.opt_states["disc"], st.params["disc"])
        disc = optax.apply_updates(st.params["disc"], dupd)
        beta = jtask.ema_beta
        ema = jax.tree_util.tree_map(lambda e, p: e * beta + p * (1.0 - beta),
                                     st.params["gen_ema"], gen)
        do_cond = (step + 1) % 2 == 0
        extra = {}
        for key, loss, target, cap in (
                ("lambda_pertube_secc", losses["pertube_secc"], 1e-6, 0.2),
                ("lambda_pertube_blink_secc", losses["pertube_blink_secc"], 1e-6, 2.0)):
            grad = jnp.log10(loss + 1e-15) - np.log10(target + 1e-15)
            extra[key] = jnp.where(do_cond, jnp.clip(st.extra[key] + 0.01 * grad, 0.0, cap),
                                   st.extra[key])
        j = st.replace(step=st.step + 1, params={"gen": gen, "disc": disc, "gen_ema": ema},
                       opt_states={"gen": g_opt, "disc": d_opt}, extra=extra)

        pstate.step = step
        ptask.apply_gen_update(pstate, torch_state_dict_from_jax({"params": g_grads}))
        ptask.apply_disc_update(pstate, torch_state_dict_from_jax({"params": d_grads}))
        ptask.tune_lambdas(pstate, {k: torch.tensor(float(v)) for k, v in losses.items()})
        ptask.update_ema(pstate)
        pstate.step += 1
        for name, mod, want in (("gen", pstate.gen, gen), ("disc", pstate.disc, disc),
                                ("gen_ema", pstate.gen_ema, ema)):
            agree_trees(tree_of(mod, dict(mod.named_parameters())), want, 1e-6, 1e-7,
                         f"step {step} {name}")
        for k, v in extra.items():
            np.testing.assert_allclose(float(pstate.extra[k]), float(v), rtol=1e-6)
    mine = pstate.state_dict()
    from flax import serialization

    theirs = jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(j))
    flat_m = dict(jax.tree_util.tree_leaves_with_path(mine["opt_states"]))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(theirs["opt_states"]))
    assert set(flat_m) == set(flat_t)
    for path, v in flat_t.items():
        np.testing.assert_allclose(np.asarray(flat_m[path]), v, rtol=1e-5, atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))


def test_val_step_matches_jax(setup):
    """The validation step (the deterministic render, no draws): the
    losses and PSNR at 1e-5 relative."""
    jtask, ptask, batch, jstate, pstate = setup
    want = jax.jit(jtask.val_step)(jstate, jax.tree_util.tree_map(jnp.asarray, batch), None)
    got = ptask.val_step(pstate, ptask.to_device(batch))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, err_msg=k)

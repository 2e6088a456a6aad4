"""The port's SECC-to-plane GAN training step against the JAX package's
``SeccImg2PlaneTask`` at tiny widths, the generator's side: the synthetic
batch, and the losses and gradients of steps 0 (density regulariser,
src2src) and 1 (the conditioning regulariser) with the JAX step's own
random draws replayed. The discriminator's side, the optimiser and the
validation step are tests/test_torch_train_dstep.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real3dportrait_tpu_torch.utils.draws import ReplayDraws
from tests._torch_parity import agree
from tests._torch_train_parity import (
    agree_trees,
    jax_state,
    port_state,
    record_draws,
    tasks,
    tree_of,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    jtask, ptask = tasks()
    batch = jtask.synthetic_batch(np.random.RandomState(0))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jstate = jax_state(jtask, jbatch)
    pstate = port_state(ptask, jstate)
    records, restore = record_draws()
    g_fn = jax.jit(jax.value_and_grad(jtask._g_loss, has_aux=True))
    out = {}
    try:
        for step in (0, 1):
            st = jstate.replace(step=jnp.asarray(step, jnp.int32))
            b = jtask._maybe_src2src(st, jbatch)
            records.clear()
            (val, (losses, gout)), grads = g_fn(st.params["gen"], st.params["disc"], st, b,
                                                jax.random.PRNGKey(5 + step))
            jax.effects_barrier()
            out[step] = dict(total=val, losses=losses, grads=grads, draws=list(records),
                             image=gout["image"])
    finally:
        restore()
    return jtask, ptask, batch, pstate, out


def test_synthetic_batch_matches_jax(setup):
    _, ptask, batch, *_ = setup
    mine = ptask.synthetic_batch(np.random.RandomState(0))
    assert set(mine) == set(batch)
    for k, v in batch.items():
        np.testing.assert_allclose(mine[k], v, rtol=0, atol=1e-6, err_msg=k)


# (max, mean) error of a generator gradient relative to its leaf's largest
# magnitude. Step 1 adds the SECC perturbation regulariser, an L1 of plane
# differences that are ~0 (noise of 0.01 on the target channels), whose
# sign flips with the last bits of either framework's sums.
GRAD_TOL = {0: (1e-4, 1e-5), 1: (1e-3, 1e-4)}


@pytest.mark.parametrize("step", [0, 1])
def test_generator_losses_and_grads_match_jax(setup, step):
    """Every loss at 1e-5 relative (the SegFormer backbones, the renderer and
    the SR head in fp32 in two frameworks), every generator gradient
    within ``GRAD_TOL``."""
    _, ptask, batch, pstate, out = setup
    ref = out[step]
    pstate.step = step
    pb = ptask._maybe_src2src(step, ptask.to_device(batch))
    draws = ReplayDraws(ref["draws"])
    total, losses, gout, grads = ptask.g_grads(pstate, pb, draws)
    assert not draws.records, "the port drew less than the JAX step"
    assert set(losses) == set(ref["losses"])
    for k, v in ref["losses"].items():
        np.testing.assert_allclose(float(losses[k]), float(v), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(float(total), float(ref["total"]), rtol=1e-5)
    agree(gout["image"], ref["image"], 1e-5, 1e-6, "image")
    agree_trees(tree_of(pstate.gen, grads), ref["grads"], *GRAD_TOL[step], f"step {step} grad")

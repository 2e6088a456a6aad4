"""The flagship GAN step on tri-planes (``triplane_feature_type: triplane``,
``triplane_depth: 1``, as the released lineage's
``configs/real3d_orig/secc_img2plane_orig.yaml`` trains) against the JAX
package's at the tiny GAN widths: step 0 (src2src, the density regulariser
through the tri-plane sampler, the adversarial term) with the JAX step's own
random draws replayed, every loss and every generator gradient. On the card
this path runs kernel K1 forward and backward (chip_smoke's
``train_triplane`` phase)."""

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
    jtask, ptask = tasks({"triplane_feature_type": "triplane", "triplane_depth": 1})
    batch = jtask.synthetic_batch(np.random.RandomState(0))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jstate = jax_state(jtask, jbatch)
    pstate = port_state(ptask, jstate)
    records, restore = record_draws()
    try:
        b = jtask._maybe_src2src(jstate, jbatch)
        (val, (losses, gout)), grads = jax.jit(jax.value_and_grad(jtask._g_loss, has_aux=True))(
            jstate.params["gen"], jstate.params["disc"], jstate, b, jax.random.PRNGKey(5))
        jax.effects_barrier()
        draws = list(records)
    finally:
        restore()
    return ptask, batch, pstate, dict(total=val, losses=losses, grads=grads, draws=draws,
                                      image=gout["image"], plane=gout["plane"])


def test_triplane_step_losses_and_grads_match_jax(setup):
    """Every loss at 1e-5 relative, the image at 1e-5 of its scale, every
    generator gradient within 1e-4 (max) and 1e-5 (mean) of its leaf's scale,
    as the tri-grid step's tests hold them."""
    ptask, batch, pstate, ref = setup
    assert pstate.gen.triplane_feature_type == "triplane"
    assert tuple(ref["plane"].shape[1:2]) == (3,) and len(ref["plane"].shape) == 5
    pstate.step = 0
    pb = ptask._maybe_src2src(0, ptask.to_device(batch))
    draws = ReplayDraws(ref["draws"])
    total, losses, gout, grads = ptask.g_grads(pstate, pb, draws)
    assert not draws.records, "the port drew less than the JAX step"
    assert set(losses) == set(ref["losses"])
    for k, v in ref["losses"].items():
        np.testing.assert_allclose(float(losses[k]), float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(total), float(ref["total"]), rtol=1e-5)
    agree(gout["image"], ref["image"], 1e-5, 1e-6, "image")
    agree_trees(tree_of(pstate.gen, grads), ref["grads"], 1e-4, 1e-5, "triplane step grad")

"""The port's torso-stage GAN step (``SeccImg2PlaneTorsoTask``, the default
``configs/secc_img2plane_torso.yaml`` and the released lineage's
``configs/real3d_orig/secc_img2plane_torso_orig.yaml``) against the JAX
package's at the tiny GAN widths with the tiny torso preset, batch 1: the
synthetic batch, then
step 0 (src2src, the density regulariser, the adversarial term) with the
JAX step's own random draws replayed: every loss, the occlusion
regularisers among them, and the gradients of the SR head (which owns the
torso model), within 1e-4; and the gated update, which moves the SR head
and leaves the head groups bit-equal."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real3dportrait_tpu_torch.training.tasks.secc_img2plane_torso_task import (
    SeccImg2PlaneTorsoTask,
)
from real3dportrait_tpu_torch.utils.draws import ReplayDraws
from tests._torch_train_parity import (
    ROOT,
    TORSO_CONFIG,
    agree_trees,
    jax_state,
    port_state,
    record_draws,
    tasks,
    tree_of,
)

torch.set_num_threads(1)
HEAD = ("img2plane_backbone", "secc_img2plane_backbone", "decoder")
# the released lineage's torso stage (tri-planes, folded-BN affines, SR fp32)
TORSO_ORIG_CONFIG = os.path.join(ROOT, "configs", "real3d_orig",
                                 "secc_img2plane_torso_orig.yaml")


@pytest.fixture(scope="module", params=[TORSO_CONFIG, TORSO_ORIG_CONFIG],
                ids=["default", "released"])
def setup(request):
    jtask, ptask = tasks({"batch_size": 1, "torso_model_scale": "tiny"}, request.param)
    assert isinstance(ptask, SeccImg2PlaneTorsoTask)
    batch = jtask.synthetic_batch(np.random.RandomState(0))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jstate = jax_state(jtask, jbatch)
    pstate = port_state(ptask, jstate)
    records, restore = record_draws()
    try:
        b = jtask._maybe_src2src(jstate, jbatch)
        (val, (losses, _)), grads = jax.jit(jax.value_and_grad(jtask._g_loss, has_aux=True))(
            jstate.params["gen"], jstate.params["disc"], jstate, b, jax.random.PRNGKey(5))
        jax.effects_barrier()
        draws = list(records)
    finally:
        restore()
    return ptask, batch, pstate, dict(total=val, losses=losses, grads=grads, draws=draws)


def test_torso_synthetic_batch_matches_jax(setup):
    ptask, batch, *_ = setup
    mine = ptask.synthetic_batch(np.random.RandomState(0))
    assert set(mine) == set(batch)
    for k, v in batch.items():
        np.testing.assert_allclose(mine[k], v, rtol=0, atol=1e-6, err_msg=k)


def test_torso_step_losses_and_sr_grads_match_jax(setup):
    ptask, batch, pstate, ref = setup
    pstate.step = 0
    pb = ptask._maybe_src2src(0, ptask.to_device(batch))
    draws = ReplayDraws(ref["draws"])
    total, losses, _, grads = ptask.g_grads(pstate, pb, draws)
    assert not draws.records, "the port drew less than the JAX step"
    assert set(losses) == set(ref["losses"])
    assert {"facev2v/occlusion_reg_l1", "facev2v/occlusion_2_reg_l1",
            "facev2v/occlusion_2_weights_entropy"} <= set(losses)
    for k, v in ref["losses"].items():
        np.testing.assert_allclose(float(losses[k]), float(v), rtol=1e-4, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(total), float(ref["total"]), rtol=1e-4)
    sr = {n: g for n, g in grads.items() if n.startswith("superresolution.")}
    got = tree_of(pstate.gen, {**{n: torch.zeros_like(g) for n, g in grads.items()}, **sr})
    # near_zero: the tiny torso's conv biases before a GroupNorm of one
    # channel a group have a gradient of exactly 0 (fp32 noise in both)
    agree_trees(got["superresolution"], ref["grads"]["superresolution"], 1e-4, 1e-5,
                "superresolution grad", near_zero=1e-4)
    setup[3]["port_grads"] = grads


def test_torso_update_trains_only_the_sr_head(setup):
    """The gates are 0 for the head groups: Adam's moments take their
    gradients, their parameters stay bit-equal; the SR head moves."""
    ptask, _, pstate, ref = setup
    grads = ref.get("port_grads")
    if grads is None:
        pytest.skip("needs the step's gradients (test_torso_step_losses_and_sr_grads_match_jax)")
    before = {n: p.detach().clone() for n, p in pstate.gen.named_parameters()}
    assert ptask._grad_gates(0) == {"img2plane_backbone": 0.0, "secc_img2plane_backbone": 0.0,
                                    "decoder": 0.0, "superresolution": 1.0}
    ptask.apply_gen_update(pstate, grads)
    moved = {g: False for g in HEAD + ("superresolution",)}
    for n, p in pstate.gen.named_parameters():
        group = n.split(".", 1)[0]
        if group in HEAD:
            assert torch.equal(p.detach(), before[n]), n
        moved[group] = moved[group] or not torch.equal(p.detach(), before[n])
    assert moved["superresolution"] and not any(moved[g] for g in HEAD)
    assert any(float(pstate.opt_g.nu[n].abs().max()) > 0 for n in before
               if n.startswith("decoder."))

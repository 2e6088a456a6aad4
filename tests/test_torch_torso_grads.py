"""The torso model's training outputs against the JAX package's
``WarpBasedTorsoModel`` at the tiny preset (v2, the released version): the
three ``facev2v/*`` occlusion regularisers, with and without
``target_torso_mask``, and the gradients of a loss over every output with
respect to every parameter, against ``jax.value_and_grad`` on the same
weights, at 1e-4 of each gradient's scale; then the 0.1 gradient scale on
the motion field, and the detached head conditioning."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real3dportrait_tpu.models import torso as jt
from real3dportrait_tpu_torch.models import torso
from real3dportrait_tpu_torch.weights import torch_state_dict_from_jax
from tests._torch_parity import agree, jax_run, load_from_jax, t

torch.set_num_threads(1)

KW = dict(torso_kp_num=4, scale="tiny", norm_mode="gn", version="v2", inp_mode="rgb_alpha")
LOSSES = ("facev2v/occlusion_reg_l1", "facev2v/occlusion_2_reg_l1",
          "facev2v/occlusion_2_weights_entropy")


def _inputs(masked: bool):
    rng = np.random.RandomState(20)
    cls = rng.randint(0, 6, (1, 8, 8)).repeat(8, 1).repeat(8, 2)
    args = [rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32),
            np.eye(6, dtype=np.float32)[cls],
            rng.uniform(-0.8, 0.8, (1, 68, 3)).astype(np.float32),
            rng.uniform(-0.8, 0.8, (1, 68, 3)).astype(np.float32),
            rng.uniform(-1, 1, (1, 8, 8, 3)).astype(np.float32),
            rng.rand(1, 8, 8, 1).astype(np.float32)]
    mask = (rng.rand(1, 32, 32) > 0.5) if masked else None
    # fixed projections of the image outputs, so that every output reaches the loss
    proj = {k: rng.randn(*s).astype(np.float32) for k, s in (
        ("deformed_torso_img", (1, 32, 32, 3)), ("deformed_torso_hid", (1, 32, 32, 8)),
        ("occlusion_2", (1, 32, 32, 1)))}
    return args, mask, proj


def _loss(out, proj, mean, total):
    terms = [mean(out[k] * p) for k, p in proj.items()]
    terms += [out["losses"][k] for k in LOSSES]
    return total(terms)


@pytest.fixture(scope="module", params=[False, True], ids=["no_mask", "target_torso_mask"])
def case(request):
    masked = request.param
    args, mask, proj = _inputs(masked)
    jm = jt.WarpBasedTorsoModel(**KW)
    variables, _ = jax_run(jm, *args, seed=21)
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(params):
        out = jm.apply({**variables, "params": params}, *map(jnp.asarray, args),
                       target_torso_mask=jmask)
        return _loss(out, {k: jnp.asarray(v) for k, v in proj.items()}, jnp.mean, sum), \
            out["losses"]

    (val, losses), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    tm = load_from_jax(torso.WarpBasedTorsoModel(**KW), variables).train()
    return dict(args=args, mask=mask, proj=proj, val=val, losses=losses, grads=grads, tm=tm)


def _port(tm, case):
    targs = [t(a) for a in case["args"]]
    mask = None if case["mask"] is None else torch.from_numpy(case["mask"])
    tm.zero_grad()
    out = tm(*targs, target_torso_mask=mask)
    loss = _loss(out, {k: t(v) for k, v in case["proj"].items()}, torch.mean, sum)
    loss.backward()
    return loss, out, {n: p.grad.detach().clone() for n, p in tm.named_parameters()}


def test_torso_losses_and_grads_match_jax(case):
    """Every gradient within 1e-4 (max) and 1e-5 (mean) of its largest
    magnitude; a gradient that is ~0 in both frameworks (below 1e-4 of the
    largest of all, as the biases of the convs before a GroupNorm of one
    channel a group, whose gradient is exactly 0) within 1e-5 of the largest
    of all."""
    tm = case["tm"]
    loss, out, grads = _port(tm, case)
    assert set(out["losses"]) == set(LOSSES)
    for k in LOSSES:
        np.testing.assert_allclose(float(out["losses"][k]), float(case["losses"][k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(loss), float(case["val"]), rtol=1e-5)
    want = torch_state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray,
                                                                       case["grads"])})
    assert set(want) == set(grads)
    top = max(float(w.abs().max()) for w in want.values())
    zero = 0
    for n, w in want.items():
        g = grads[n].to(w.dtype)
        err = (g - w).abs()
        if float(w.abs().max()) <= 1e-4 * top:
            zero += 1
            assert float(err.max()) <= 1e-5 * top, f"{n}: {float(err.max()):.3e}"
        else:
            agree(g, w, 1e-4, 1e-5, n)
    assert zero < len(want) // 2, "most gradients are not ~0"


def test_motion_field_gradient_is_scaled(case):
    """The motion field's three outputs carry 0.1 of their gradient back:
    its parameters' gradients are a tenth of those with the scale 1, the
    generator's and the occlusion predictor's are unchanged (the appearance
    extractor feeds both paths); under ``no_grad`` the outputs are the
    motion field's own values, as before the scale (bit for bit)."""
    tm = case["tm"]
    _, _, scaled = _port(tm, case)
    torso.GRAD_SCALE = 1.0
    try:
        _, _, full = _port(tm, case)
    finally:
        torso.GRAD_SCALE = 0.1
    floor = 1e-2 * max(float(g.abs().max()) for g in full.values())
    for n, g in scaled.items():
        if n.startswith("appearance_extractor."):
            continue
        want = full[n] * 0.1 if n.startswith("motion_field_estimator.") else full[n]
        top = max(float(want.abs().max()), floor)
        assert float((g - want).abs().max()) <= 1e-4 * top, n
    with torch.no_grad():
        a = tm(*[t(x) for x in case["args"]])
    torso.GRAD_SCALE = 1.0       # t * 1 + t * 0: the motion field's own values
    try:
        b = tm(*[t(x) for x in case["args"]])
    finally:
        torso.GRAD_SCALE = 0.1
    for k in ("deformed_torso_img", "occlusion", "occlusion_2"):
        assert torch.equal(a[k], b[k].detach()), k


def test_head_conditioning_takes_no_gradient(case):
    """The v2 head render and its weights are data to the torso model."""
    targs = [t(a) for a in case["args"]]
    head, weights = targs[4].requires_grad_(True), targs[5].requires_grad_(True)
    out = case["tm"](*targs[:4], head, weights)
    out["deformed_torso_img"].sum().backward()
    assert head.grad is None and weights.grad is None

"""Parity of the port's EG3D stage with the JAX package: ``MappingNetwork``
with latents (w average, its update, truncation), the const-input
``SynthesisNetwork`` (fp32 and bf16 blocks), ``TriPlaneGenerator``'s
planes and synthesis, the weight bridge both ways, and ``EG3DTask``'s
train step at step 0 (density regulariser and R1) and step 1, with JAX's
draws replayed."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from real3dportrait_tpu.config import load_config as jax_load_config
from real3dportrait_tpu.geometry.camera import (
    fov_to_intrinsics as jax_intrinsics,
    pack_camera as jax_pack,
    sample_uniform_pose as jax_sample_pose,
)
from real3dportrait_tpu.models import eg3d as jeg3d
from real3dportrait_tpu.models import stylegan2 as jsg
from real3dportrait_tpu.training import checkpoint as jckpt
from real3dportrait_tpu.training.tasks.base_task import resolve_task as jax_resolve_task
from real3dportrait_tpu_torch.config import load_config
from real3dportrait_tpu_torch.geometry.camera import sample_uniform_pose
from real3dportrait_tpu_torch.models import eg3d
from real3dportrait_tpu_torch.models import stylegan2 as sg
from real3dportrait_tpu_torch.training import checkpoint as ckpt
from real3dportrait_tpu_torch.training.tasks.base_task import resolve_task
from real3dportrait_tpu_torch.utils.draws import ReplayDraws
from real3dportrait_tpu_torch.weights import jax_variables_from_torch
from tests._torch_parity import agree, load_from_jax, random_like, t, to_np
from tests._torch_train_parity import agree_trees, record_draws

CONFIG = "configs/eg3d.yaml"
# a tiny EG3D: 32^2 planes of 32 channels (K1's width), 16^2 render, 64^2 SR
TINY = {"batch_size": 2, "z_dim": 16, "w_dim": 16, "teacher_plane_resolution": 32,
        "neural_rendering_resolution": 16, "final_resolution": 64, "base_channel": 256,
        "max_channel": 32, "num_samples_coarse": 6, "num_samples_fine": 6,
        "num_fp16_layers_in_super_resolution": 0, "num_fp16_layers_in_discriminator": 0,
        "group_size_for_mini_batch_std": 2, "reg_interval_g": 2, "reg_interval_d": 2}


@pytest.fixture
def work(tmp_path):
    """A temporary dir, removed after the test: the checkpoints it holds
    (a full-width audio-to-motion model's is ~176 MB) would otherwise stay
    under pytest's kept temp dirs."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _cameras(seed: int, b: int) -> np.ndarray:
    return np.asarray(jax_pack(jax_sample_pose(jax.random.PRNGKey(seed), b),
                               jax_intrinsics()))


def test_sample_uniform_pose_matches_jax():
    # the same uniform draws (JAX's, replayed) give the same cameras
    records, restore = record_draws()
    try:
        want = jax.jit(lambda k: jax_sample_pose(k, 5))(jax.random.PRNGKey(3))
        jax.block_until_ready(want)
    finally:
        restore()
    got = sample_uniform_pose(ReplayDraws(records), 5)
    agree(got, want, 1e-6, 1e-7, "sample_uniform_pose")
    gen = torch.Generator().manual_seed(0)
    pose = sample_uniform_pose(gen, 3)
    assert pose.shape == (3, 4, 4) and torch.isfinite(pose).all()


@pytest.mark.parametrize("psi,cutoff,update", [(1.0, None, False), (0.7, None, True),
                                               (0.5, 2, False)])
def test_mapping_network_with_latents_matches_jax(psi, cutoff, update):
    # z and c through the mapping, the w average's update and truncation
    # (whole or cut off); the updated w average against JAX's "ema"
    kw = dict(z_dim=16, c_dim=25, w_dim=24, num_ws=5, num_layers=2)
    rng = np.random.RandomState(1)
    z, c = rng.randn(3, 16).astype(np.float32), _cameras(0, 3)
    module = jsg.MappingNetwork(**kw)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), z, c))
    variables = random_like(shapes, seed=2)
    want, new_vars = jax.jit(lambda v: module.apply(
        v, z, c, truncation_psi=psi, truncation_cutoff=cutoff, update_emas=update,
        mutable=["ema"]))(variables)
    port = load_from_jax(sg.MappingNetwork(25, 24, num_layers=2, z_dim=16, num_ws=5),
                         variables)
    with torch.no_grad():
        got = port(t(c), t(z), truncation_psi=psi, truncation_cutoff=cutoff,
                   update_emas=update)
    agree(got, want, 1e-5, 1e-6, "ws")
    agree(port.w_avg, new_vars["ema"]["w_avg"], 1e-6, 1e-7, "w_avg")
    # the bridge back: the port's tree is the JAX variables
    back = jax_variables_from_torch(port)
    assert set(back) == {"params", "ema"}
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6),
                           back["params"], jax.tree_util.tree_map(np.asarray,
                                                                  variables["params"]))


@pytest.mark.parametrize("res,fp16", [(16, 0), (32, 0), (32, 2)])
def test_synthesis_network_matches_jax(res, fp16):
    # the const-input stack 4^2 -> res in "const" noise mode, carried
    # weights (the constant [res,res,C] -> [C,res,res]); fp32 1e-4 / 1e-5,
    # bf16 blocks 3e-2 / 3e-3 of scale
    kw = dict(w_dim=16, img_resolution=res, img_channels=12, channel_base=256,
              channel_max=32, num_fp16_res=fp16)
    module = jsg.SynthesisNetwork(**kw)
    ws = np.random.RandomState(4).randn(2, module.num_ws, 16).astype(np.float32)
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0)}, ws, noise_mode="const"))
    variables = random_like(shapes, seed=5)
    want = jax.jit(lambda v: module.apply(v, ws, noise_mode="const"))(variables)
    port = load_from_jax(sg.SynthesisNetwork(**kw), variables)
    assert port.num_ws == module.num_ws
    with torch.no_grad():
        got = port(t(ws), noise_mode="const")
    tol = (3e-2, 3e-3) if fp16 else (1e-4, 1e-5)
    agree(got, want, *tol, f"synthesis {res} fp16 {fp16}")
    back = jax_variables_from_torch(port)
    for k in ("params", "noise_const"):
        jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, b),
                               back[k], jax.tree_util.tree_map(np.asarray, variables[k]))


def _generator_kwargs(sr_fp16: int = 0) -> dict:
    return dict(z_dim=16, w_dim=16, plane_resolution=32, triplane_hid_dim=32,
                neural_rendering_resolution=16, final_resolution=64, channel_base=256,
                channel_max=32, mapping_layers=2, sr_num_fp16_res=sr_fp16,
                num_samples_coarse=6, num_samples_fine=6)


@pytest.mark.parametrize("sr_fp16", [0, 4])
def test_triplane_generator_matches_jax(sr_fp16):
    # z + camera -> planes -> the deterministic render -> SR, "const" noise:
    # planes [B,3,32,32,32], raw 16^2, image 64^2, depth; the bf16 SR at
    # 3e-2 / 3e-3 of scale, the rest 1e-4 / 1e-5
    kw = _generator_kwargs(sr_fp16)
    module = jeg3d.TriPlaneGenerator(**kw)
    z = np.random.RandomState(6).randn(2, 16).astype(np.float32)
    cam = _cameras(1, 2)
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, z, cam))
    variables = random_like(shapes, seed=7)
    want = jax.jit(lambda v: module.apply(v, z, cam, noise_mode="const"))(variables)
    port = load_from_jax(eg3d.TriPlaneGenerator(**kw), variables)
    with torch.no_grad():
        got = port(t(z), t(cam), noise_mode="const")
    agree(got["plane"], want["plane"], 1e-4, 1e-5, "planes")
    assert got["plane"].shape == (2, 3, 32, 32, 32)
    agree(got["image_raw"], want["image_raw"], 1e-4, 1e-5, "image_raw")
    agree(got["image_depth"], want["image_depth"], 1e-4, 1e-5, "image_depth")
    tol = (3e-2, 3e-3) if sr_fp16 else (1e-4, 1e-5)
    agree(got["image"], want["image"], *tol, "image")
    # the bridge both ways: the port's variables are the JAX tree
    back = jax_variables_from_torch(port)
    assert set(back) == {"params", "noise_const", "ema"}
    for k in back:
        jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, b),
                               back[k], jax.tree_util.tree_map(np.asarray, variables[k]))
    pts = np.random.RandomState(2).uniform(-0.5, 0.5, (1, 50, 3)).astype(np.float32)
    want_pts = jax.jit(lambda v: module.apply(
        v, want["plane"], jnp.asarray(pts), None,
        method=lambda m, p, c, d: m.sample_points(p, c, d)))(
        variables)
    with torch.no_grad():
        got_pts = port.sample_points(got["plane"], t(pts))
    agree(got_pts["sigma"], want_pts["sigma"], 1e-4, 1e-5, "sample_points sigma")


def _jax_eg3d_state(jtask, batch: dict, seed: int = 0):
    """A JAX EG3D train state with seeded leaves on the inits' trees (no
    init compile), the EMA at half the generator, the optimisers' inits."""
    from real3dportrait_tpu.training.train_state import TrainState as JaxTrainState

    b = batch["camera"].shape[0]
    z = jnp.zeros((b, jtask.gen.z_dim))
    gshape = jax.eval_shape(lambda: jtask.gen.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, z,
        batch["camera"]))
    dshape = jax.eval_shape(lambda: jtask.disc.init(
        jax.random.PRNGKey(2), batch["real_img"], batch["real_raw"], batch["camera"]))
    gv, dv = random_like(gshape, seed), random_like(dshape, seed + 1)
    params = jax.tree_util.tree_map(jnp.asarray, {
        "gen": gv["params"], "disc": dv["params"],
        "gen_ema": jax.tree_util.tree_map(lambda x: np.array(x) * 0.5, gv["params"])})
    return JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        variables={k: jax.tree_util.tree_map(jnp.asarray, v)
                   for k, v in gv.items() if k != "params"},
        opt_states={"gen": jtask.opt_g.init(params["gen"]),
                    "disc": jtask.opt_d.init(params["disc"])}, extra={})


def _eg3d_tasks(over=None):
    over = {**TINY, **(over or {})}
    return (jax_resolve_task(jax_load_config(CONFIG, overrides=over)),
            resolve_task(load_config(CONFIG, over), torch.device("cpu")))


def _tree(state) -> dict:
    return jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(state))


@pytest.fixture(scope="module")
def eg3d_steps():
    """The JAX task's jitted step at steps 0 and 1, each from the same
    seeded state, with its draws recorded."""
    jtask, ptask = _eg3d_tasks()
    batch = jtask.synthetic_batch(np.random.RandomState(0))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jstate = _jax_eg3d_state(jtask, jbatch)
    out = {}
    for step in (0, 1):
        st = jstate.replace(step=jnp.asarray(step, jnp.int32))
        records, restore = record_draws()
        try:
            new, metrics = jax.jit(lambda s, b, r: jtask.train_step(s, b, r))(
                st, jbatch, jax.random.PRNGKey(3 + step))
            jax.effects_barrier()
        finally:
            restore()
        out[step] = dict(before=_tree(st), after=_tree(new), metrics=metrics,
                         draws=list(records))
    return jtask, ptask, batch, out


def test_eg3d_synthetic_batch_shapes():
    # the port's synthetic batch: the JAX task's keys, shapes and images
    # (the cameras come from the port's own generator)
    jtask, ptask = _eg3d_tasks()
    want = jtask.synthetic_batch(np.random.RandomState(0))
    got = ptask.synthetic_batch(np.random.RandomState(0))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    for k in ("real_img", "real_raw"):
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("step", [0, 1])
def test_eg3d_train_step_matches_jax(eg3d_steps, step):
    # one G and one D update from the same state, the JAX step's draws
    # replayed (z, the swap's uniform, at step 0 the regulariser's points):
    # losses at 1e-5; Adam's moments (with beta1 = 0, mu is the gradient:
    # the generator's through the adversarial and density terms, K1's
    # backward among them, the discriminator's with R1's double backward at
    # step 0; a leaf ~0 against the tree, 1e-3 of the tree's largest, held
    # to a tenth of that); the EMA 1e-5 /
    # 1e-6; the parameters, whose first Adam update is +-lr by the sign of
    # each gradient element, within 2 lr (the sign of a gradient that is
    # rounding noise may differ) and within 1e-6 of scale on average. The
    # moments take the gradient tests' tolerances
    # (tests/test_torch_train_dstep.py): 1e-4 / 1e-5 with a floor of 1e-2 of
    # the tree's largest, R1's 1e-3 / 1e-4 where it is added
    jtask, ptask, batch, out = eg3d_steps
    ref = out[step]
    kinds = [k for k, _ in ref["draws"]]
    assert kinds == (["normal", "uniform", "uniform", "normal"] if step == 0
                     else ["normal", "uniform"]), kinds
    pstate = ptask.build(0)
    pstate.load_state_dict(ref["before"])
    assert pstate.step == step
    draws = ReplayDraws(ref["draws"])
    pm = ptask.train_step(pstate, ptask.to_device(batch), draws)
    assert not draws.records
    for k in ("total_loss", "g/adv", "g/density_reg", "d/loss", "d/r1"):
        np.testing.assert_allclose(float(pm[k]), float(ref["metrics"][k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    if step == 0:
        assert float(pm["g/density_reg"]) > 0 and float(pm["d/r1"]) > 0
    else:
        assert float(pm["g/density_reg"]) == 0 and float(pm["d/r1"]) == 0
    got, want = pstate.state_dict(), ref["after"]
    assert int(got["step"]) == step + 1
    for group in ("gen", "disc"):
        g, w = got["opt_states"][group], want["opt_states"][group]
        assert g["1"] == {} == dict(w["1"])    # a constant rate has no count
        tol = (1e-3, 1e-4) if group == "disc" and step == 0 else (1e-4, 1e-5)
        for m in ("mu", "nu"):
            agree_trees(g["0"][m], w["0"][m], *tol, f"{group} {m}", floor=1e-2,
                        near_zero=1e-3)
    agree_trees(got["params"]["gen_ema"], want["params"]["gen_ema"], 1e-5, 1e-6, "gen_ema")
    for group, lr in (("gen", 0.0025), ("disc", 0.002)):
        flat_w = dict(jax.tree_util.tree_leaves_with_path(want["params"][group]))
        flat_g = dict(jax.tree_util.tree_leaves_with_path(got["params"][group]))
        assert set(flat_g) == set(flat_w)
        errs = [np.abs(np.asarray(flat_g[k], np.float64) - flat_w[k]) for k in flat_w]
        assert max(e.max() for e in errs) <= 2 * lr * 1.001, group
        assert np.mean(np.concatenate([e.ravel() for e in errs])) <= 1e-6, group
    for coll in ("noise_const", "ema"):
        jax.tree_util.tree_map(np.testing.assert_array_equal, got["variables"][coll],
                               want["variables"][coll])


def test_eg3d_checkpoints_both_ways(work):
    # the port's checkpoint restores in the JAX trainer's way (partial_load
    # into a JAX state: every leaf loaded, the constants in JAX's layout),
    # and a JAX state's tree loads strictly into the port's state
    jtask, ptask = _eg3d_tasks({"accumulate_grad_batches": 2})
    pstate = ptask.build(3)
    pstate.step = 7
    ckpt.save_checkpoint(str(work), 7, pstate.state_dict())
    src, _ = jckpt.get_last_checkpoint(str(work))
    batch = jax.tree_util.tree_map(jnp.asarray, jtask.synthetic_batch(
        np.random.RandomState(0)))
    jstate = _jax_eg3d_state(jtask, batch)
    target = serialization.to_state_dict(jstate)
    merged, stats = jckpt.partial_load(target, src)
    assert stats["missing"] == 0 and stats["shape_mismatch"] == 0
    restored = serialization.from_state_dict(jstate, merged)
    assert int(restored.step) == 7
    const = np.asarray(restored.params["gen"]["backbone"]["b4"]["const"])
    np.testing.assert_array_equal(const, to_np(pstate.gen.backbone.b4.const).transpose(1, 2, 0))
    np.testing.assert_array_equal(np.asarray(restored.variables["ema"]["mapping"]["w_avg"]),
                                  to_np(pstate.gen.mapping.w_avg))
    fresh = ptask.build(4)
    fresh.load_state_dict(_tree(jstate))
    back = fresh.state_dict()
    want = _tree(jstate)
    for group in ("gen", "disc", "gen_ema"):
        jax.tree_util.tree_map(np.testing.assert_array_equal, back["params"][group],
                               want["params"][group])
    jax.tree_util.tree_map(np.testing.assert_array_equal, back["variables"],
                           want["variables"])

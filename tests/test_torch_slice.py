"""The port's head-only slice end to end: SECC raster -> canonical plane ->
frame step against the JAX package at tiny widths, the weight bridge per
submodule, the port pipeline on CPU, and the port's independence from JAX."""

import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real3dportrait_tpu.config import load_config
from real3dportrait_tpu.geometry import bfm as jbfm
from real3dportrait_tpu.geometry import camera as jcam
from real3dportrait_tpu.geometry.secc_renderer import SECCRenderer as JaxSECCRenderer
from real3dportrait_tpu.models.img2plane import OSAvatarSECCImg2Plane as JaxModel
from real3dportrait_tpu_torch import config as port_config
from real3dportrait_tpu_torch.geometry import bfm
from real3dportrait_tpu_torch.geometry.secc_renderer import SECCRenderer
from real3dportrait_tpu_torch.inference.pipeline import Real3DPortraitPipeline
from real3dportrait_tpu_torch.models.img2plane import OSAvatarSECCImg2Plane
from real3dportrait_tpu_torch.weights import torch_state_dict_from_jax
from tests._torch_parity import agree, load_from_jax, random_like, t

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(triplane_hid_dim=8, triplane_depth=1, triplane_feature_type="triplane",
            neural_rendering_resolution=16, final_resolution=64,
            backbone_mode="composite", backbone_scale="small", composite_vit_dim=32,
            sr_channel0=16, sr_channel1=8, sr_num_fp16_res=0, num_samples_coarse=16,
            num_samples_fine=32, head_norm_mode="folded_bn")


@pytest.fixture(scope="module")
def jax_slice():
    """Tiny JAX head-only model, its (perturbed) variables and one frame's
    inputs and outputs."""
    rng = np.random.RandomState(0)
    img = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    idc = (rng.randn(1, 80) * 0.5).astype(np.float32)
    exp = (rng.randn(2, 64) * 0.5).astype(np.float32)  # source, target
    euler = np.array([[0.05, 0.2, 0.0]], np.float32)
    trans = np.array([[0.0, 0.0, 0.1]], np.float32)

    renderer = JaxSECCRenderer(jbfm.synthetic_bfm(512), rasterize_size=32,
                               output_resolution=64)
    zero = jnp.zeros((1, 3))
    seccs = [renderer.render(jnp.asarray(idc), jnp.asarray(e), zero, zero)[1]
             for e in (np.zeros((1, 64), np.float32), exp[:1], exp[1:])]
    secc = jnp.concatenate(seccs, axis=-1)
    _, conv_c2w, intr = jcam.convert_eg3d_convention(jnp.asarray(euler), jnp.asarray(trans))
    cam = jcam.pack_camera(conv_c2w, intr[0])

    # seeded leaves on the init's tree structure (no init compile), then the
    # two stages jitted as the JAX pipeline runs them
    model = JaxModel(**TINY)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.asarray(img), cam, secc=secc))
    variables = random_like(shapes, seed=2)
    cano = jax.jit(lambda v, i: model.apply(v, i, method=lambda m, x: m.cal_cano_plane(x)))(
        variables, jnp.asarray(img))
    out = jax.jit(lambda v, c, sc, p: model.apply(v, None, c, secc=sc, cano_planes=p))(
        variables, cam, secc, cano)
    return dict(img=img, idc=idc, exp=exp, euler=euler, trans=trans, secc=secc, cam=cam,
                variables=variables, cano=cano, out=out)


def test_tiny_head_only_slice_matches_jax(jax_slice):
    s = jax_slice
    # SECC raster: masks equal here, NCC within 1e-4 (ties, see test_torch_raster)
    renderer = SECCRenderer(bfm.synthetic_bfm(512), rasterize_size=32, output_resolution=64,
                            device="cpu")
    zero = torch.zeros((1, 3))
    seccs = [renderer.render(t(s["idc"]), t(e), zero, zero)[1]
             for e in (np.zeros((1, 64), np.float32), s["exp"][:1], s["exp"][1:])]
    secc = torch.cat(seccs, dim=-1)
    agree(secc, s["secc"], 1e-4, 1e-6, "SECC condition maps")

    from real3dportrait_tpu_torch.geometry import camera

    _, conv_c2w, intr = camera.convert_eg3d_convention(t(s["euler"]), t(s["trans"]))
    cam = camera.pack_camera(conv_c2w, intr[0])
    agree(cam, s["cam"], 1e-6, 1e-7, "camera")

    model = load_from_jax(OSAvatarSECCImg2Plane(**TINY), s["variables"])
    with torch.no_grad():
        cano = model.cal_cano_plane(t(s["img"]))
        out = model.synthesis(None, cam, secc=secc, cano_planes=cano)
    # fp32 through ~60 backbone layers (planes), then the two-pass render
    # and two SR blocks: planes 2e-4 / 2e-5, render outputs and the final
    # image 1e-3 of scale max and 1e-4 mean
    agree(cano, s["cano"], 2e-4, 2e-5, "canonical plane")
    for k in ("image_raw", "image_depth", "image"):
        agree(out[k], s["out"][k], 1e-3, 1e-4, k)
    assert out["image"].shape == (1, 64, 64, 3)


@pytest.mark.parametrize("sub", ["img2plane_backbone", "secc_img2plane_backbone",
                                 "decoder", "superresolution"])
def test_weight_bridge_loads_each_submodule(jax_slice, sub):
    variables = jax_slice["variables"]
    subtree = {coll: tree[sub] for coll, tree in variables.items() if sub in tree}
    model = OSAvatarSECCImg2Plane(**TINY)
    getattr(model, sub).load_state_dict(torch_state_dict_from_jax(subtree), strict=True)
    whole = torch_state_dict_from_jax(variables)
    for k, v in getattr(model, sub).state_dict().items():
        assert torch.equal(v, whole[f"{sub}.{k}"]), k


@pytest.mark.parametrize("name", sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(ROOT, "configs", "*.yaml"))))
def test_port_config_loader_matches_jax(name):
    path = os.path.join(ROOT, "configs", name)
    assert port_config.load_config(path) == load_config(path).to_dict()
    over = {"sampling_preset": "reference", "final_resolution": 64, "new.nested.key": [1, 2]}
    assert port_config.load_config(path, over) == load_config(path, over).to_dict()


def _tiny_cfg():
    return port_config.load_config(os.path.join(ROOT, "configs", "real3d_orig.yaml"), dict(
        final_resolution=64, neural_rendering_resolution=16, secc_resolution=32,
        sr_channel0=16, sr_channel1=8, sampling_preset="fast"))


@pytest.fixture(scope="module")
def tiny_pipeline():
    return Real3DPortraitPipeline(_tiny_cfg(), use_torso=False, mock_weights=True, seed=0,
                                  device="cpu")


def test_pipeline_synthesize_two_frames_on_cpu(tiny_pipeline):
    rng = np.random.RandomState(3)
    src = rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
    exp = t(rng.randn(2, 64) * 0.3)
    timings = {}
    frames = tiny_pipeline.synthesize(src, exp, tiny_pipeline.fit_source(None),
                                      timings=timings)
    assert frames.shape == (2, 64, 64, 3)
    assert torch.isfinite(frames).all() and frames.abs().max() <= 1.0
    assert len(timings["frame_ms"]) == 2 and timings["cano_ms"] > 0
    # the same seed gives the same weights and frames
    again = Real3DPortraitPipeline(_tiny_cfg(), use_torso=False, seed=0, device="cpu")
    assert torch.equal(again.synthesize(src, exp, again.fit_source(None)), frames)
    # pose-driven frames go through the same loop
    pose = (t(rng.uniform(-0.1, 0.1, (1, 3))), t(rng.uniform(-0.1, 0.1, (1, 3))))
    posed = tiny_pipeline.synthesize(src, exp, tiny_pipeline.fit_source(None),
                                     pose_seq=pose)
    assert posed.shape == frames.shape and torch.isfinite(posed).all()


@pytest.mark.parametrize("kwargs", [dict(src_shape=(2, 64, 64, 3)),
                                    dict(src_lm2d=np.zeros((68, 2))),
                                    dict(frame_batch=2)],
                         ids=["multi_identity", "fit_source", "batch"])
def test_pipeline_raises_on_unported_modes(tiny_pipeline, kwargs):
    # the blink edit and source preparation are ported (test_torch_run.py)
    src = np.zeros(kwargs.pop("src_shape", (64, 64, 3)), np.uint8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if "src_lm2d" in kwargs:
            tiny_pipeline.run(src, wav=np.zeros(8000, np.float32), **kwargs)
        else:
            tiny_pipeline.synthesize(src, torch.zeros((1, 64)),
                                     tiny_pipeline.fit_source(None), **kwargs)


def test_port_imports_leave_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import real3dportrait_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'flax', 'optax', 'real3dportrait_tpu'))\n"
        "assert len(mods) >= 23, mods\n"
        "new = {'flagship', 'models.torso', 'models.sr_with_ref', 'ops.grid_sample',\n"
        "       'models.decoder', 'models.img2plane', 'models.img2plane_composite',\n"
        "       'models.stylegan2', 'rendering.renderer', 'weights', 'ops.conv3d',\n"
        "       'models.audio2motion', 'audio.features', 'audio.hubert', 'inference.cli',\n"
        "       'inference.edit_secc', 'inference.infer_utils', 'geometry.face3d_helper',\n"
        "       'preprocess.segment_utils', 'preprocess.pipeline', 'utils.visualization'}\n"
        "assert {p.__name__ + '.' + m for m in new} <= set(mods), mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr

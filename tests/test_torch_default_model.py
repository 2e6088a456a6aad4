"""The JAX pipeline's default model, ``configs/secc_img2plane_torso.yaml``
(tri-grids of depth 3, the composite backbone with GroupNorms, bf16 SR
blocks), in the port: the whole torso model at reduced widths against the
JAX model of the same config, its full-width parameter tree, the pipeline's
defaults, and the tiny flagship against ``__graft_entry__._flagship``."""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real3dportrait_tpu.geometry import camera as jcam
from real3dportrait_tpu.inference.pipeline import Real3DPortraitPipeline as JaxPipeline
from real3dportrait_tpu.models.img2plane import OSAvatarSECCImg2PlaneTorso as JaxTorsoModel
from real3dportrait_tpu_torch import config as port_config
from real3dportrait_tpu_torch.flagship import TINY_MODEL, flagship
from real3dportrait_tpu_torch.geometry import camera
from real3dportrait_tpu_torch.inference import pipeline
from real3dportrait_tpu_torch.inference.pipeline import Real3DPortraitPipeline, build_model
from real3dportrait_tpu_torch.models.img2plane import OSAvatarSECCImg2PlaneTorso
from real3dportrait_tpu_torch.models.img2plane_composite import CompositeImg2PlaneBackbone
from real3dportrait_tpu_torch.weights import torch_state_dict_from_jax
from tests._torch_parity import agree, jax_run, load_from_jax, t

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(final_resolution=64, neural_rendering_resolution=16, secc_resolution=32,
             sr_channel0=16, sr_channel1=8, torso_model_scale="tiny")


def _cfg(**over) -> dict:
    return port_config.load_config(os.path.join(ROOT, "configs", "secc_img2plane_torso.yaml"),
                                   over)


def _jax_model(cfg) -> JaxTorsoModel:
    """The torso model the JAX pipeline builds from ``cfg`` (its
    ``model_kwargs``, read key for key)."""
    return JaxTorsoModel(
        triplane_hid_dim=int(cfg.get("triplane_hid_dim", 32)),
        triplane_depth=int(cfg.get("triplane_depth", 3)),
        triplane_feature_type=cfg.get("triplane_feature_type", "trigrid"),
        neural_rendering_resolution=int(cfg.get("neural_rendering_resolution", 128)),
        final_resolution=int(cfg.get("final_resolution", 512)),
        backbone_mode=cfg.get("img2plane_backbone_mode", "segformer"),
        backbone_scale=cfg.get("img2plane_backbone_scale", "b0"),
        head_norm_mode=cfg.get("head_norm_mode", "gn"),
        plane_fusion_mode=cfg.get("phase1_plane_fusion_mode", "add"),
        secc_segformer_scale=cfg.get("secc_segformer_scale", "b0"),
        pncc_cond_mode=cfg.get("pncc_cond_mode", "cano_src_tgt"),
        sr_num_fp16_res=int(cfg.get("num_fp16_layers_in_super_resolution", 4)),
        num_samples_coarse=int(cfg.get("num_samples_coarse", 48)),
        num_samples_fine=int(cfg.get("num_samples_fine", 48)),
        sr_channel0=int(cfg.get("sr_channel0", 256)),
        sr_channel1=int(cfg.get("sr_channel1", 128)),
        torso_kp_num=int(cfg.get("torso_kp_num", 4)),
        torso_scale=cfg.get("torso_model_scale", "standard"),
        fuse_mode=cfg.get("htbsr_head_weight_fuse_mode", "v2"),
        head_threshold=float(cfg.get("htbsr_head_threshold", 0.9)),
        torso_version=cfg.get("torso_model_version", "v2"),
        torso_inp_mode=cfg.get("torso_inp_mode", "rgb_alpha"))


def _frame_inputs(res: int, seed: int):
    rng = np.random.RandomState(seed)
    img = rng.uniform(-1, 1, (1, res, res, 3)).astype(np.float32)
    secc = rng.uniform(-1, 1, (1, res, res, 9)).astype(np.float32)
    cls = rng.randint(0, 6, (1, res // 8, res // 8)).repeat(8, 1).repeat(8, 2)
    cond = dict(ref_torso_img=img, bg_img=rng.uniform(-1, 1, img.shape).astype(np.float32),
                segmap=np.eye(6, dtype=np.float32)[cls],
                kp_src=rng.uniform(-0.8, 0.8, (1, 68, 3)).astype(np.float32),
                kp_drv=rng.uniform(-0.8, 0.8, (1, 68, 3)).astype(np.float32))
    return img, secc, cond


def test_default_model_small_matches_jax():
    # the default config at 64^2 (16^2 render, SR 16/8, tiny torso) with
    # depth-3 tri-grids, the composite `standard` backbone in GroupNorm
    # mode and bf16 SR blocks; random keypoints. fp32 up to the SR head:
    # render outputs at 1e-3 of scale max, 1e-4 mean (as the tri-plane
    # torso frame); the final image through two bf16 blocks at 3e-2 / 3e-3
    cfg = _cfg(sampling_preset="fast", **SMALL)
    img, secc, cond = _frame_inputs(64, seed=20)
    _, c2w, intr = jcam.convert_eg3d_convention(jnp.asarray([[0.05, 0.2, 0.0]]),
                                                jnp.asarray([[0.0, 0.0, 0.1]]))
    jcamera = jcam.pack_camera(c2w, intr[0])
    jm = _jax_model(dict(cfg, num_samples_coarse=16, num_samples_fine=32))
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    variables, cano = jax_run(jm, img, init_args=(img, jcamera, jcond), secc=secc,
                              method=lambda m, i: m.cal_cano_plane(i), seed=21)
    jcond["torso_appearance"] = jax.jit(lambda v, c: jm.apply(
        v, c, method=lambda m, c_: m.cal_torso_appearance(c_)))(variables, jcond)
    jcond["bg_feat"] = jax.jit(lambda v, c: jm.apply(
        v, c, method=lambda m, c_: m.cal_bg_feat(c_)))(variables, jcond)
    want = jax.jit(lambda v, c, cd, s, p: jm.apply(v, None, c, cd, secc=s, cano_planes=p))(
        variables, jcamera, jcond, secc, cano)

    model = load_from_jax(build_model(cfg), variables)
    assert isinstance(model.img2plane_backbone, CompositeImg2PlaneBackbone)
    assert model.superresolution.block1.dtype == torch.bfloat16
    tcond = {k: t(v) for k, v in cond.items()}
    with torch.no_grad():
        tcano = model.cal_cano_plane(t(img))
        tcond["torso_appearance"] = model.cal_torso_appearance(tcond)
        tcond["bg_feat"] = model.cal_bg_feat(tcond)
        _, c2w_t, intr_t = camera.convert_eg3d_convention(torch.tensor([[0.05, 0.2, 0.0]]),
                                                          torch.tensor([[0.0, 0.0, 0.1]]))
        out = model.synthesis(None, camera.pack_camera(c2w_t, intr_t[0]), tcond,
                              secc=t(secc), cano_planes=tcano)
    assert tcano.shape == (1, 3, 3, 32, 32, 32)
    agree(tcano, cano, 2e-4, 2e-5, "canonical tri-grid")
    assert out["plane"].shape == (1, 3, 3, 32, 32, 32)
    for k in ("image_raw", "image_depth", "weights_img"):
        agree(out[k], want[k], 1e-3, 1e-4, k)
    agree(out["image"], want["image"], 3e-2, 3e-3, "image (bf16 SR blocks)")


def test_default_model_state_dict_matches_jax_tree():
    # full width (512^2, 128^2 render, tri-grids [1,3,3,256,256,32]): the
    # port's parameters and buffers are the converted JAX tree, name for
    # name and shape for shape; neither side allocates weights
    cfg = _cfg()
    with torch.device("meta"):
        model = build_model(cfg)
    res = 512
    img = jax.ShapeDtypeStruct((1, res, res, 3), jnp.float32)
    cond = dict(ref_torso_img=img, bg_img=img,
                segmap=jax.ShapeDtypeStruct((1, res, res, 6), jnp.float32),
                kp_src=jax.ShapeDtypeStruct((1, 68, 3), jnp.float32),
                kp_drv=jax.ShapeDtypeStruct((1, 68, 3), jnp.float32))
    shapes = jax.eval_shape(
        lambda i, c, cd, s: _jax_model(cfg).init(
            {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, i, c, cd,
            secc=s),
        img, jax.ShapeDtypeStruct((1, 25), jnp.float32), cond,
        jax.ShapeDtypeStruct((1, res, res, 9), jnp.float32))
    want = {k: tuple(v.shape) for k, v in torch_state_dict_from_jax(shapes).items()}
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    assert got["secc_img2plane_backbone.to_plane_cnn.to_plane.weight"][0] == 3 * 32 * 3
    assert model.triplane_depth == 3 and model.triplane_feature_type == "trigrid"
    assert model.superresolution.block0.dtype == torch.bfloat16


def test_pipeline_defaults_match_jax():
    # the default config is the JAX pipeline's, and the device is the card
    assert os.path.basename(pipeline.DEFAULT_CONFIG) == "secc_img2plane_torso.yaml"
    assert '"secc_img2plane_torso.yaml"' in inspect.getsource(JaxPipeline.__init__)
    assert pipeline.DEFAULT_CONFIG == os.path.join(ROOT, "configs",
                                                   "secc_img2plane_torso.yaml")
    for entry in (Real3DPortraitPipeline, flagship):
        assert inspect.signature(entry).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Real3DPortraitPipeline()


def test_default_config_pipeline_two_frames_on_cpu():
    pipe = Real3DPortraitPipeline(_cfg(sampling_preset="fast", **SMALL), seed=0,
                                  device="cpu")
    assert isinstance(pipe.model, OSAvatarSECCImg2PlaneTorso)
    rng = np.random.RandomState(22)
    src = rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
    frames = pipe.synthesize(src, t(rng.randn(2, 64) * 0.3), pipe.fit_source(None))
    assert frames.shape == (2, 64, 64, 3)
    assert torch.isfinite(frames).all() and frames.abs().max() <= 1.0
    assert frames.device.type == "cpu"


def test_tiny_flagship_equals_jax_flagship():
    # the port's flagship(tiny=True) step on the JAX tiny flagship's
    # variables and arguments (its real init, its inputs, its per-video
    # caches): 1e-4 of scale max, 1e-5 mean
    import __graft_entry__

    jstep, (variables, cam, secc, cano, cond) = __graft_entry__._flagship(tiny=True)
    want = jax.jit(jstep)(variables, cam, secc, cano, cond)
    step, _ = flagship(tiny=True, device="cpu")
    model = load_from_jax(step.model, jax.tree.map(np.asarray, variables))
    for k, v in TINY_MODEL.items():
        assert getattr(jstep.model, k) == v, k
    tcond = {k: t(v) for k, v in cond.items() if k != "bg_feat"}
    tcond["bg_feat"] = tuple(t(v) for v in cond["bg_feat"])
    got = step(t(cam), t(secc), t(cano), tcond)
    assert model is step.model and cano.shape == (1, 3, 2, 32, 32, 8)
    agree(got, want, 1e-4, 1e-5, "tiny flagship frame")

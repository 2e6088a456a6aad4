"""The port's torso branch against the JAX package at tiny widths: the
keypoint helpers, the plain versions of kernels K5a and K5b, each torso
network, the warp-based torso model with and without its appearance cache,
the SR-with-ref head with and without its background cache, the tiny torso
frame step, the strict weight bridge, the torso pipeline and the flagship
step on the CPU. Weights are seeded numpy leaves on each JAX module's init
tree, loaded with ``torch_state_dict_from_jax`` and strict name matching."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real3dportrait_tpu.geometry import camera as jcam
from real3dportrait_tpu.models import torso as jt
from real3dportrait_tpu.models.img2plane import OSAvatarSECCImg2PlaneTorso as JaxTorsoModel
from real3dportrait_tpu.models.sr_with_ref import SuperresolutionHybrid8XDCWarp as JaxSRWarp
from real3dportrait_tpu.ops import grid_sample as jgs
from real3dportrait_tpu_torch import config as port_config
from real3dportrait_tpu_torch.flagship import flagship
from real3dportrait_tpu_torch.geometry import camera
from real3dportrait_tpu_torch.inference.pipeline import Real3DPortraitPipeline
from real3dportrait_tpu_torch.models import torso
from real3dportrait_tpu_torch.models.img2plane import OSAvatarSECCImg2PlaneTorso
from real3dportrait_tpu_torch.models.sr_with_ref import SuperresolutionHybrid8XDCWarp
from real3dportrait_tpu_torch.ops.grid_sample import grid_sample_3d
from real3dportrait_tpu_torch.weights import torch_state_dict_from_jax
from tests._torch_parity import agree, jax_run, load_from_jax, t

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(triplane_hid_dim=8, triplane_depth=1, triplane_feature_type="triplane",
            neural_rendering_resolution=16, final_resolution=64,
            backbone_mode="composite", backbone_scale="small", composite_vit_dim=32,
            sr_channel0=16, sr_channel1=8, sr_num_fp16_res=0, num_samples_coarse=16,
            num_samples_fine=32, head_norm_mode="folded_bn", torso_scale="tiny")


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _segmap(rng, b, res):
    """One-hot [B,res,res,6] with neck (2), torso (4) and other classes."""
    cls = rng.randint(0, 6, (b, res // 8, res // 8)).repeat(8, 1).repeat(8, 2)
    return np.eye(6, dtype=np.float32)[cls]


def _kps(rng, b, lo=-0.8, hi=0.8):
    return [rng.uniform(lo, hi, (b, 68, 3)).astype(np.float32) for _ in range(2)]


def test_keypoint_helpers_match_jax():
    # exact formulas in fp32: 1e-6 of scale
    rng = np.random.RandomState(0)
    kp_s = rng.uniform(-1.3, 1.3, (2, 4, 3)).astype(np.float32)
    kp_d = rng.uniform(-1.3, 1.3, (2, 4, 3)).astype(np.float32)
    agree(torso.make_coordinate_grid_3d(3, 5, 4), jt.make_coordinate_grid_3d(3, 5, 4),
          1e-7, 1e-8, "grid")
    agree(torso.kp2gaussian_3d(t(kp_s), 3, 5, 4), jt.kp2gaussian_3d(kp_s, 3, 5, 4),
          1e-6, 1e-7, "kp2gaussian_3d")
    agree(torso.create_sparse_motions(t(kp_s), t(kp_d), 3, 5, 4),
          jt.create_sparse_motions(kp_s, kp_d, 3, 5, 4), 1e-6, 1e-7, "sparse motions")
    mask = (rng.rand(2, 9, 7, 1) > 0.8).astype(np.float32) * rng.rand(2, 9, 7, 1)
    agree(torso.dilate_mask(t(mask)), jt.dilate_mask(jnp.asarray(mask)), 0, 0, "dilate")


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_3d_matches_jax(align_corners, padding_mode):
    # trilinear weights in fp32, coordinates reaching outside [-1,1]: 1e-6
    rng = np.random.RandomState(1)
    feats = rng.randn(2, 3, 5, 4, 6).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (2, 50, 3)).astype(np.float32)
    want = jgs.grid_sample_3d(jnp.asarray(feats), jnp.asarray(coords), align_corners,
                              padding_mode)
    agree(grid_sample_3d(t(feats), t(coords), align_corners, padding_mode), want,
          1e-6, 1e-7, "grid_sample_3d")


@pytest.mark.parametrize("k,reach", [(4, 0.8), (9, 1.6)], ids=["k4", "k9_outside"])
def test_k5a_plain_matches_jax(k, reach):
    # heatmaps + K+1 zero-padded warps of the compressed volume, the MFE
    # input layout; keypoint offsets up to 2*reach push samples outside
    # the volume. Exact formulas, fp32: 1e-6 of scale max, 1e-7 mean
    rng = np.random.RandomState(2)
    fs = rng.randn(2, 3, 7, 5, 4).astype(np.float32)
    kp_s = rng.uniform(-reach, reach, (2, k, 3)).astype(np.float32)
    kp_d = rng.uniform(-reach, reach, (2, k, 3)).astype(np.float32)
    b, d, h, w, c = fs.shape

    @jax.jit
    def ref(fs, kp_s, kp_d):
        heat = jt.kp2gaussian_3d(kp_d, d, h, w) - jt.kp2gaussian_3d(kp_s, d, h, w)
        heat = jnp.concatenate([jnp.zeros_like(heat[:, :1]), heat], axis=1)
        deformed = jt.create_deformed_source_image(
            fs, jt.create_sparse_motions(kp_s, kp_d, d, h, w))
        inp = jnp.concatenate([heat[..., None], deformed], axis=-1)
        return jnp.transpose(inp, (0, 2, 3, 4, 1, 5)).reshape(b, d, h, w, -1)

    got = torso.torso_deform_input_plain(t(fs), t(kp_s), t(kp_d))
    assert got.shape == (b, (k + 1) * (1 + c), d, h, w)
    agree(got.permute(0, 2, 3, 4, 1), ref(fs, kp_s, kp_d), 1e-6, 1e-7, "K5a plain")
    assert torch.equal(torso.torso_deform_input(t(fs), t(kp_s), t(kp_d)), got)


def test_k5b_plain_matches_jax():
    # border-padded warp (deformation in [-1.2, 1.2], so the clamp acts)
    # then the C-major depth fold: 1e-6 of scale max, 1e-7 mean
    rng = np.random.RandomState(3)
    fs = rng.randn(2, 3, 6, 5, 8).astype(np.float32)
    deformation = rng.uniform(-1.2, 1.2, (2, 3, 6, 5, 3)).astype(np.float32)
    b, d, h, w, c = fs.shape

    @jax.jit
    def ref(fs, deformation):
        warped = jgs.grid_sample_3d_packed(fs, deformation.reshape(b, -1, 3),
                                           align_corners=True, padding_mode="border")
        warped = warped.reshape(b, d, h, w, c)
        return jnp.transpose(warped, (0, 2, 3, 4, 1)).reshape(b, h, w, c * d)

    got = torso.torso_warp_volume_plain(t(fs), t(deformation))
    agree(got.permute(0, 2, 3, 1), ref(fs, deformation), 1e-6, 1e-7, "K5b plain")
    assert torch.equal(torso.torso_warp_volume(t(fs), t(deformation)), got)


@pytest.mark.parametrize("norm_mode", ["affine", "gn"])
def test_appearance_extractor_matches_jax(norm_mode):
    # conv pyramid + 3D res blocks in fp32: 1e-5 of scale max, 1e-6 mean
    img = np.random.RandomState(4).uniform(-1, 1, (1, 32, 32, 5)).astype(np.float32)
    jm = jt.AppearanceFeatureExtractor(4, 2, down_seq=(8, 16), n_res=1, norm_mode=norm_mode)
    variables, want = jax_run(jm, img, seed=5)
    tm = load_from_jax(torso.AppearanceFeatureExtractor(5, 4, 2, (8, 16), 1, norm_mode),
                       variables)
    with torch.no_grad():
        got = tm(_nchw(t(img)))
    agree(got.permute(0, 2, 3, 4, 1), want, 1e-5, 1e-6, "appearance volume")


@pytest.mark.parametrize("head_cond", [True, False], ids=["v2", "v1"])
def test_motion_field_estimator_matches_jax(head_cond):
    # the port's direct tail (7^3 mask conv, 7^2 occlusion convs) against
    # the JAX default fused tail (the same taps as one depth-folded conv);
    # ~10 conv layers in fp32: 1e-5 of scale max, 1e-6 mean
    rng = np.random.RandomState(6)
    fs = rng.randn(1, 2, 16, 16, 6).astype(np.float32)
    kp_s = rng.uniform(-0.8, 0.8, (1, 4, 3)).astype(np.float32)
    kp_d = (kp_s + rng.uniform(-0.2, 0.2, kp_s.shape)).astype(np.float32)
    head = dict(tgt_head_img=rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32),
                tgt_head_weights=rng.rand(1, 32, 32, 1).astype(np.float32))
    if not head_cond:
        head = {}
    jm = jt.MotionFieldEstimator(down_seq=(8, 16), up_seq=(16, 16, 8),
                                 use_head_cond=head_cond)
    variables, want = jax_run(jm, fs, kp_s, kp_d, seed=7, **head)
    tm = load_from_jax(torso.MotionFieldEstimator(6, 2, down_seq=(8, 16), up_seq=(16, 16, 8),
                                                  use_head_cond=head_cond), variables)
    with torch.no_grad():
        got = tm(t(fs), t(kp_s), t(kp_d), **{k: t(v) for k, v in head.items()})
    for g, w_, what in zip(got, want, ("deformation", "occlusion", "occlusion_2")):
        agree(g, w_, 1e-5, 1e-6, what)


def test_warp_generator_matches_jax():
    # K5b plain + 2D conv stack: 1e-5 of scale max, 1e-6 mean
    rng = np.random.RandomState(8)
    fs = rng.randn(1, 2, 8, 8, 4).astype(np.float32)
    deformation = rng.uniform(-1.1, 1.1, (1, 2, 8, 8, 3)).astype(np.float32)
    jm = jt.WarpGenerator(up_seq=(16, 8), n_res=1)
    variables, want = jax_run(jm, fs, deformation, seed=9)
    tm = load_from_jax(torso.WarpGenerator(4, 2, (16, 8), 1), variables)
    with torch.no_grad():
        got = tm(t(fs), t(deformation))
    agree(got[0], want[0], 1e-5, 1e-6, "torso rgb")
    agree(got[1], want[1], 1e-5, 1e-6, "torso hid")


@pytest.mark.parametrize("version,inp_mode,norm_mode",
                         [("v2", "rgb_alpha", "affine"), ("v1", "rgb", "gn")])
def test_warp_torso_model_matches_jax(version, inp_mode, norm_mode):
    # appearance -> motion field -> generator -> occlusion predictor, about
    # 30 conv layers in fp32: 1e-4 of scale max, 1e-5 mean. The cached
    # appearance volume gives the same outputs as the uncached path.
    rng = np.random.RandomState(10)
    img = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    seg = _segmap(rng, 1, 64)
    kp_s, kp_d = _kps(rng, 1)
    head = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    weights = rng.rand(1, 32, 32, 1).astype(np.float32)
    kw = dict(torso_kp_num=4, scale="tiny", norm_mode=norm_mode, version=version,
              inp_mode=inp_mode)
    jm = jt.WarpBasedTorsoModel(**kw)
    variables, want = jax_run(jm, img, seg, kp_s, kp_d, head, weights, seed=11)
    want_vol = jax.jit(lambda v: jm.apply(v, img, seg, kp_s, kp_d, appearance_only=True))(
        variables)
    tm = load_from_jax(torso.WarpBasedTorsoModel(**kw), variables)
    args = [t(a) for a in (img, seg, kp_s, kp_d, head, weights)]
    with torch.no_grad():
        got = tm(*args)
        vol = tm(*args[:4], appearance_only=True)["appearance_volume"]
        cached = tm(None, *args[1:], appearance_volume=vol)
    agree(vol, want_vol["appearance_volume"], 1e-5, 1e-6, "appearance volume")
    for key in ("deformed_torso_img", "deformed_torso_hid", "occlusion", "occlusion_2",
                "kp_src", "kp_drv"):
        agree(got[key], want[key], 1e-4, 1e-5, key)
        assert torch.equal(cached[key], got[key]), key


@pytest.mark.parametrize("fuse_mode,weight_fuse", [("v2", True), ("v1", True), ("v2", False)],
                         ids=["v2", "v1", "no_weight_fuse"])
def test_sr_with_ref_matches_jax(fuse_mode, weight_fuse):
    # block0 + torso + fusion convs + block1 (16 -> 64), ~45 layers in fp32:
    # 1e-4 of scale max, 1e-5 mean; the cached bg_feat and appearance
    # volume give the same image as the uncached path
    rng = np.random.RandomState(12)
    rgb = rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    x = rng.randn(1, 16, 16, 8).astype(np.float32)
    ws = np.ones((1, 14, 16), np.float32)
    torso_img = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    bg = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    weights = rng.rand(1, 16, 16, 1).astype(np.float32)
    seg = _segmap(rng, 1, 64)
    kp_s, kp_d = _kps(rng, 1)
    jkw = dict(w_dim=16, sr_num_fp16_res=0, input_resolution=16, mid_resolution=32,
               final_resolution=64, block0_channels=16, block1_channels=8, torso_scale="tiny",
               fuse_mode=fuse_mode, weight_fuse=weight_fuse, torso_norm_mode="affine")
    jm = JaxSRWarp(**jkw)
    args = (rgb, x, ws, torso_img, bg, weights, seg, kp_s, kp_d)
    variables, (want, want_torso) = jax_run(jm, *args, seed=13, noise_mode="const")
    want_bg, _ = jax.jit(lambda v: jm.apply(v, *args, bg_only=True))(variables)
    tm = load_from_jax(SuperresolutionHybrid8XDCWarp(8, **jkw), variables)
    targs = [t(a) for a in args]
    with torch.no_grad():
        got, torso_ret = tm(*targs, noise_mode="const")
        bg_feat = tm.encode_bg(targs[4])
        vol = tm.torso_appearance(targs[3], targs[6])
        cached, _ = tm(*targs[:4], None, *targs[5:], noise_mode="const",
                       appearance_volume=vol, bg_feat=bg_feat)
    assert got.shape == (1, 64, 64, 3)
    agree(bg_feat[0], want_bg[0], 1e-6, 1e-7, "bg mid rgb")
    agree(bg_feat[1], want_bg[1], 1e-5, 1e-6, "bg feature")
    agree(got, want, 1e-4, 1e-5, "SR-with-ref image")
    agree(torso_ret["occlusion_2"], want_torso["occlusion_2"], 1e-4, 1e-5, "occlusion_2")
    assert torch.equal(cached, got)


def _frame_inputs(res=64, seed=14):
    rng = np.random.RandomState(seed)
    img = rng.uniform(-1, 1, (1, res, res, 3)).astype(np.float32)
    secc = rng.uniform(-1, 1, (1, res, res, 9)).astype(np.float32)
    euler = np.array([[0.05, 0.2, 0.0]], np.float32)
    trans = np.array([[0.0, 0.0, 0.1]], np.float32)
    kp_s, kp_d = _kps(rng, 1)
    cond = dict(ref_torso_img=img, bg_img=rng.uniform(-1, 1, img.shape).astype(np.float32),
                segmap=_segmap(rng, 1, res), kp_src=kp_s, kp_drv=kp_d)
    return img, secc, euler, trans, cond


@pytest.fixture(scope="module")
def jax_torso_frame():
    """The tiny JAX torso model, its seeded variables, the per-video caches
    and one frame step with random keypoints."""
    img, secc, euler, trans, cond = _frame_inputs()
    _, c2w, intr = jcam.convert_eg3d_convention(jnp.asarray(euler), jnp.asarray(trans))
    cam = jcam.pack_camera(c2w, intr[0])
    model = JaxTorsoModel(**TINY)
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    variables, cano = jax_run(model, img, init_args=(img, cam, jcond), secc=secc,
                              method=lambda m, i: m.cal_cano_plane(i), seed=15)
    jcond["torso_appearance"] = jax.jit(lambda v, c: model.apply(
        v, c, method=lambda m, c_: m.cal_torso_appearance(c_)))(variables, jcond)
    jcond["bg_feat"] = jax.jit(lambda v, c: model.apply(
        v, c, method=lambda m, c_: m.cal_bg_feat(c_)))(variables, jcond)
    out = jax.jit(lambda v, c, cd, s, p: model.apply(v, None, c, cd, secc=s, cano_planes=p))(
        variables, cam, jcond, secc, cano)
    return dict(img=img, secc=secc, euler=euler, trans=trans, cond=cond, jcond=jcond,
                variables=variables, cano=cano, out=out)


def test_tiny_torso_frame_step_matches_jax(jax_torso_frame):
    s = jax_torso_frame
    model = load_from_jax(OSAvatarSECCImg2PlaneTorso(**TINY), s["variables"])
    _, c2w, intr = camera.convert_eg3d_convention(t(s["euler"]), t(s["trans"]))
    cam = camera.pack_camera(c2w, intr[0])
    cond = {k: t(v) for k, v in s["cond"].items()}
    with torch.no_grad():
        cano = model.cal_cano_plane(t(s["img"]))
        cond["torso_appearance"] = model.cal_torso_appearance(cond)
        cond["bg_feat"] = model.cal_bg_feat(cond)
        out = model.synthesis(None, cam, cond, secc=t(s["secc"]), cano_planes=cano)
    # the composite backbone (planes 2e-4 / 2e-5, as in test_torch_slice),
    # then the render, SR-with-ref head and torso: 1e-3 of scale max, 1e-4
    # mean for the frame's outputs
    agree(cano, s["cano"], 2e-4, 2e-5, "canonical plane")
    agree(cond["torso_appearance"], s["jcond"]["torso_appearance"], 1e-5, 1e-6,
          "torso appearance cache")
    agree(cond["bg_feat"][1], s["jcond"]["bg_feat"][1], 1e-5, 1e-6, "bg cache")
    for k in ("image", "image_raw", "image_depth", "weights_img"):
        agree(out[k], s["out"][k], 1e-3, 1e-4, k)
    for k in ("occlusion_2", "deformed_torso_img"):
        agree(out["torso_ret"][k], s["out"]["torso_ret"][k], 1e-3, 1e-4, k)
    assert out["image"].shape == (1, 64, 64, 3)


@pytest.mark.parametrize("sub", ["superresolution", "superresolution.torso_model",
                                 "superresolution.torso_model.motion_field_estimator"])
def test_torso_weight_bridge_is_strict(jax_torso_frame, sub):
    # every JAX leaf has a port parameter of the same shape and vice versa
    tree = jax_torso_frame["variables"]
    for name in sub.split("."):
        tree = {coll: sub_tree[name] for coll, sub_tree in tree.items() if name in sub_tree}
    module = OSAvatarSECCImg2PlaneTorso(**TINY).get_submodule(sub)
    module.load_state_dict(torch_state_dict_from_jax(tree), strict=True)
    assert set(module.state_dict()) == set(torch_state_dict_from_jax(tree))


def _tiny_cfg(**over):
    return port_config.load_config(os.path.join(ROOT, "configs", "real3d_orig.yaml"), dict(
        final_resolution=64, neural_rendering_resolution=16, secc_resolution=32,
        sr_channel0=16, sr_channel1=8, sampling_preset="fast", torso_model_scale="tiny",
        **over))


@pytest.fixture(scope="module")
def torso_pipeline():
    return Real3DPortraitPipeline(_tiny_cfg(), mock_weights=True, seed=0, device="cpu")


def test_pipeline_defaults_to_torso(torso_pipeline):
    assert isinstance(torso_pipeline.model, OSAvatarSECCImg2PlaneTorso)
    sr = torso_pipeline.model.superresolution
    assert sr.fuse_mode == "v2" and sr.torso_version == "v2"
    assert sr.torso_model.inp_mode == "rgb_alpha"


@pytest.mark.parametrize("bg", ["none", "uint8", "float"])
def test_pipeline_torso_synthesize_two_frames(torso_pipeline, bg):
    rng = np.random.RandomState(16)
    src = rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
    exp = t(rng.randn(2, 64) * 0.3)
    bg_u8 = rng.randint(0, 256, (48, 48, 3)).astype(np.uint8)
    bg_img = {"none": None, "uint8": bg_u8,
              "float": bg_u8.astype(np.float32) / 127.5 - 1.0}[bg]
    timings = {}
    frames = torso_pipeline.synthesize(src, exp, torso_pipeline.fit_source(None),
                                       bg_img=bg_img, timings=timings)
    assert frames.shape == (2, 64, 64, 3)
    assert torch.isfinite(frames).all() and frames.abs().max() <= 1.0
    assert len(timings["frame_ms"]) == 2
    assert timings["appearance_ms"] > 0 and timings["bg_ms"] > 0
    if bg == "float":
        # a uint8 background and its [-1,1] float form give the same frames
        again = torso_pipeline.synthesize(src, exp, torso_pipeline.fit_source(None),
                                          bg_img=bg_u8)
        torch.testing.assert_close(again, frames, rtol=0, atol=1e-6)
    if bg == "none":
        other = torso_pipeline.synthesize(src, exp, torso_pipeline.fit_source(None),
                                          bg_img=bg_u8)
        assert not torch.equal(other, frames)


def test_flagship_tiny_runs_on_cpu():
    from real3dportrait_tpu_torch.models.torso import torso_deform_input

    frame_step, args = flagship(tiny=True, device="cpu")
    image = frame_step(*args)
    assert image.shape == (1, 64, 64, 3) and torch.isfinite(image).all()
    kp_s, kp_d = args[-1]["kp_src"], args[-1]["kp_drv"]
    assert float(kp_s.abs().max()) <= 0.8 and not torch.equal(kp_s, kp_d)
    assert isinstance(frame_step.model, OSAvatarSECCImg2PlaneTorso)
    assert torso_deform_input.launches == 0  # CPU tensors take the plain versions
    # the same seed gives the same frame
    again, args2 = flagship(tiny=True, device="cpu")
    assert torch.equal(again(*args2), image)

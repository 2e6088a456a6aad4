"""Parity of the last modules of the port with the JAX package's:
``SuperresolutionHybrid4X`` (with the resize branch below 128^2),
``TemporalAttNet``, the torso stage's ``PatchDiscriminator`` and
``kp2gaussian_2d``, the composite backbone's alpha and camera input modes,
the dual discriminator's camera noise and the renderer's density noise
(JAX's draws replayed), and the audio-to-motion FVAE with two latent
strides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from real3dportrait_tpu.models import audio2motion as ja2m
from real3dportrait_tpu.models.decoder import OSGDecoder as JaxOSGDecoder
from real3dportrait_tpu.models.dual_discriminator import DualDiscriminator as JaxDualDisc
from real3dportrait_tpu.models.img2plane_composite import CompositeImg2PlaneBackbone as JaxComp
from real3dportrait_tpu.models.superresolution import SuperresolutionHybrid4X as JaxSR4X
from real3dportrait_tpu.models.temporal_att import TemporalAttNet as JaxTemporalAttNet
from real3dportrait_tpu.models.torso import PatchDiscriminator as JaxPatchD
from real3dportrait_tpu.models.torso import kp2gaussian_2d as jax_kp2gaussian_2d
from real3dportrait_tpu.rendering.renderer import RenderOptions as JaxRenderOptions
from real3dportrait_tpu.rendering.renderer import render_rays as jax_render_rays
from real3dportrait_tpu_torch.geometry.camera import fov_to_intrinsics, lookat_pose
from real3dportrait_tpu_torch.geometry.camera import pack_camera, unpack_camera
from real3dportrait_tpu_torch.models import audio2motion as a2m
from real3dportrait_tpu_torch.models.decoder import OSGDecoder
from real3dportrait_tpu_torch.models.dual_discriminator import DualDiscriminator
from real3dportrait_tpu_torch.models.img2plane_composite import CompositeImg2PlaneBackbone
from real3dportrait_tpu_torch.models.superresolution import SuperresolutionHybrid4X
from real3dportrait_tpu_torch.models.temporal_att import TemporalAttNet
from real3dportrait_tpu_torch.models.torso import PatchDiscriminator, kp2gaussian_2d
from real3dportrait_tpu_torch.rendering.ray_sampler import sample_rays
from real3dportrait_tpu_torch.rendering.renderer import RenderOptions, render_rays
from real3dportrait_tpu_torch.utils.draws import ReplayDraws
from tests._torch_parity import agree, jax_run, load_from_jax, random_like, t, to_np
from tests._torch_train_parity import record_draws

torch.set_num_threads(1)


@pytest.mark.parametrize("in_res,fp16", [(64, 0), (128, 0), (64, 4)])
def test_superresolution_4x_matches_jax(in_res, fp16):
    # 128^2 -> 256^2 (block widths 128 and 64 are the head's own), the input
    # resized up to 128^2 first where smaller: fp32 at 1e-4 / 1e-5 of scale,
    # bf16 blocks at 3e-2 max and 3e-3 mean-abs of scale
    rng = np.random.RandomState(0)
    rgb = rng.uniform(-1, 1, (1, in_res, in_res, 3)).astype(np.float32)
    x = rng.randn(1, in_res, in_res, 8).astype(np.float32)
    ws = rng.randn(1, 4, 16).astype(np.float32)
    jm = JaxSR4X(w_dim=16, sr_num_fp16_res=fp16)
    variables, want = jax_run(jm, rgb, x, ws, seed=1, noise_mode="const")
    port = load_from_jax(SuperresolutionHybrid4X(8, w_dim=16, sr_num_fp16_res=fp16), variables)
    with torch.no_grad():
        got = port(t(rgb), t(x), t(ws), noise_mode="const")
    assert got.shape == (1, 256, 256, 3)
    agree(got, want, *((3e-2, 3e-3) if fp16 else (1e-4, 1e-5)), f"sr4x {in_res} {fp16}")


@pytest.mark.parametrize("h", [16, 64])
def test_temporal_att_net_matches_jax(h):
    # a window of 5 planes probed at 32^2 (resized up from 16^2, down with
    # antialias from 64^2), three conv / lrelu / pool stages, a weight a
    # frame: the smoothed plane at 1e-5 / 1e-6 of scale
    win = np.random.RandomState(2).randn(2, 5, h, h, 6).astype(np.float32)
    variables, want = jax_run(JaxTemporalAttNet(), win, seed=3)
    port = load_from_jax(TemporalAttNet(6), variables)
    with torch.no_grad():
        got = port(t(win))
    assert got.shape == (2, h, h, 6)
    agree(got, want, 1e-5, 1e-6, f"temporal att {h}")
    with pytest.raises(ValueError, match="window of 5"):
        port(t(win[:, :4]))


def test_kp2gaussian_2d_matches_jax():
    # the same fp32 expression: 1e-6 / 1e-7 of scale
    kp = np.random.RandomState(4).uniform(-1, 1, (2, 4, 2)).astype(np.float32)
    want = jax_kp2gaussian_2d(jnp.asarray(kp), 12, 20)
    got = kp2gaussian_2d(t(kp), 12, 20)
    assert got.shape == (2, 4, 12, 20)
    agree(got, want, 1e-6, 1e-7, "kp2gaussian_2d")


def test_patch_discriminator_matches_jax():
    # image + the keypoints' heatmaps through 4 conv / GroupNorm / lrelu
    # blocks (stride 2 but the last) and the 1-channel head: the logits and
    # every feature map at 1e-4 / 1e-5 of scale; no gradient reaches the
    # keypoints
    rng = np.random.RandomState(5)
    img = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    kp = rng.uniform(-1, 1, (2, 4, 3)).astype(np.float32)
    down = (8, 16, 16, 32)
    variables, (want, wfeats) = jax_run(JaxPatchD(down_seq=down), img, kp, seed=6)
    port = load_from_jax(PatchDiscriminator(down, 4), variables)
    kp_t = t(kp).requires_grad_(True)
    got, feats = port(t(img), kp_t)
    assert got.shape == (2, 4, 4, 1) and len(feats) == 4
    agree(got, want, 1e-4, 1e-5, "patch logits")
    for i, (g, w) in enumerate(zip(feats, wfeats)):
        agree(g, w, 1e-4, 1e-5, f"patch feature {i}")
    got.sum().backward()
    assert kp_t.grad is None


@pytest.mark.parametrize("mode,given_alpha", [("rgb_alpha", False), ("rgb_alpha", True),
                                              ("rgb_camera", False),
                                              ("rgb_alpha_camera", True)])
def test_composite_input_modes_match_jax(mode, given_alpha):
    # the alpha channel (given, or from the image's channel mean) and the
    # camera's three dense channels ahead of the coordinates: the planes at
    # 2e-4 / 2e-5 of scale (the rgb mode's tolerance, tests/test_torch_models.py)
    rng = np.random.RandomState(7)
    img = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    img[:, :16] = -1.0                       # a background the derived alpha masks
    cond = {}
    if given_alpha:
        cond["ref_alphas"] = (rng.rand(1, 64, 64, 1) > 0.5).astype(np.float32)
    if "camera" in mode:
        cond["ref_cameras"] = rng.randn(1, 25).astype(np.float32)
    jm = JaxComp(plane_channels=8, scale="small", vit_dim=32, norm_mode="affine",
                 input_mode=mode)
    variables, want = jax_run(jm, img, cond, seed=8)
    port = load_from_jax(CompositeImg2PlaneBackbone(plane_channels=8, scale="small",
                                                    vit_dim=32, input_mode=mode), variables)
    with torch.no_grad():
        got = port(t(img), {k: t(v) for k, v in cond.items()})
    assert got.shape == (1, 3, 32, 32, 8)
    agree(got, want, 2e-4, 2e-5, f"composite {mode}")


def test_dual_discriminator_camera_noise_replays_jax():
    # disc_c_noise 1: the camera plus normal noise times its batch std,
    # JAX's draw replayed: the logits at 1e-4 / 1e-5 of scale; without
    # draws the port raises; with 0 nothing is drawn
    rng = np.random.RandomState(9)
    img = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    raw = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    cam = rng.randn(2, 25).astype(np.float32)
    kw = dict(img_resolution=32, channel_base=256, channel_max=32, num_fp16_res=0,
              mbstd_group_size=2)
    jm = JaxDualDisc(**kw, disc_c_noise=1.0)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, img, raw, cam))
    variables = random_like(shapes, seed=10)
    records, restore = record_draws()
    try:
        want = jax.jit(lambda v: jm.apply(v, img, raw, cam, rngs={
            "noise": jax.random.PRNGKey(3)}))(variables)
        jax.effects_barrier()
    finally:
        restore()
    assert [(k, v.shape) for k, v in records] == [("normal", (2, 25))]
    port = load_from_jax(DualDiscriminator(**kw, disc_c_noise=1.0), variables)
    draws = ReplayDraws(records)
    with torch.no_grad():
        got = port(t(img), t(raw), t(cam), draws=draws)
        agree(got, want, 1e-4, 1e-5, "noisy-camera logits")
        assert not draws.records
        with pytest.raises(ValueError, match="needs draws"):
            port(t(img), t(raw), t(cam))
        quiet = load_from_jax(DualDiscriminator(**kw), variables)
        wq = jax.jit(lambda v: JaxDualDisc(**kw).apply(v, img, raw, cam))(variables)
        agree(quiet(t(img), t(raw), t(cam), draws=ReplayDraws([])), wq, 1e-4, 1e-5, "quiet")


def test_render_density_noise_replays_jax():
    # density_noise 0.5 on a training render: normal noise on sigma after
    # each pass's decode, JAX's four draws replayed in order (the jittered
    # depths, the coarse noise, K2's u, the fine noise): rgb, depth and
    # weights at 1e-4 / 1e-5 of scale (the deterministic render's tolerance,
    # tests/test_torch_render.py)
    rng = np.random.RandomState(11)
    planes = (rng.randn(1, 3, 16, 16, 32) * 0.5).astype(np.float32)
    c2w = lookat_pose(torch.full((1,), 0.2), torch.zeros(1), torch.tensor([[0.0, 0.0, 0.2]]))
    o, d = sample_rays(*unpack_camera(pack_camera(c2w, fov_to_intrinsics())), 8)
    jdec = JaxOSGDecoder(hidden_dim=64, output_dim=32)
    variables = jdec.init(jax.random.PRNGKey(12), jnp.zeros((1, 3, 4, 32)))
    dec = load_from_jax(OSGDecoder(32, 64, 32), variables)
    opts = dict(depth_resolution=12, depth_resolution_importance=12)
    records, restore = record_draws()
    try:
        want = jax.jit(lambda p, ro, rd: jax_render_rays(
            p, lambda f, _d: jdec.apply(variables, f), ro, rd,
            JaxRenderOptions(**opts, density_noise=0.5), key=jax.random.PRNGKey(13)))(
            jnp.asarray(planes), jnp.asarray(to_np(o)), jnp.asarray(to_np(d)))
        jax.effects_barrier()
    finally:
        restore()
    assert [k for k, _ in records] == ["uniform", "normal", "uniform", "normal"]
    draws = ReplayDraws(records)
    got = render_rays(t(planes), dec, o, d, RenderOptions(**opts, density_noise=0.5), draws)
    assert not draws.records
    for k in ("rgb", "depth", "weights_sum"):
        agree(got[k], want[k], 1e-4, 1e-5, f"noisy render {k}")
    # 0 (every config) draws no noise: the same two draws as before
    records0 = [r for r, (k, _) in zip(records, records) if k == "uniform"]
    draws0 = ReplayDraws(records0)
    render_rays(t(planes), dec, o, d, RenderOptions(**opts), draws0)
    assert not draws0.records


FVAE_KW = dict(in_out_channels=8, hidden_channels=16, latent_size=4, kernel_size=5,
               enc_n_layers=2, dec_n_layers=2, gin_channels=8, glow_hidden=8,
               glow_kernel_size=3, glow_n_blocks=2)


class _JaxFVAEStrides(fnn.Module):
    """The JAX FVAE's two branches built from its own encoder, decoder and
    prior flow for several latent strides, with one condition pre-net a
    stride named ``g_pre_net_<i>`` (``audio2motion.FVAE`` names every one
    ``g_pre_net``, which Flax refuses for more than one)."""

    strides: tuple

    @fnn.compact
    def __call__(self, x, x_mask, g, z=None):
        k = FVAE_KW
        g_sqz = g
        for i, s in enumerate(self.strides):
            g_sqz = fnn.Conv(k["gin_channels"], (s * 2,), strides=(s,), padding=(s // 2,),
                             name=f"g_pre_net_{i}")(g_sqz)
        flow = ja2m.ResidualCouplingBlock(k["latent_size"], k["glow_hidden"],
                                          k["glow_kernel_size"], 1, k["glow_n_blocks"], 4,
                                          k["gin_channels"], name="prior_flow")
        dec = ja2m.FVAEDecoder(k["hidden_channels"], k["in_out_channels"], k["kernel_size"],
                               k["dec_n_layers"], k["gin_channels"], self.strides,
                               name="decoder")
        mask3 = x_mask[..., None]
        z_q, m_q, logs_q, mask_sqz = ja2m.FVAEEncoder(
            k["hidden_channels"], k["latent_size"], k["kernel_size"], k["enc_n_layers"],
            k["gin_channels"], self.strides, name="encoder")(x, mask3, g_sqz,
                                                             self.make_rng("noise"))
        if z is not None:        # the inference branch from a given prior draw
            z_p = flow(z, jnp.ones_like(z[..., :1]), g_sqz, reverse=True)
            return dec(z_p, jnp.ones_like(mask3), g), z_p
        x_recon = dec(z_q, mask3, g)
        z_p = flow(z_q, mask_sqz, g_sqz)
        return x_recon, z_p, m_q, logs_q


def test_fvae_two_strides():
    # latent strides (2, 2): a condition pre-net, an encoder conv and a
    # decoder transposed conv a stride; the training branch at JAX's
    # posterior draw (replayed) and the inference branch from a given prior
    # draw, fp32 at 1e-5 / 1e-6 of scale. The JAX FVAE itself cannot be
    # built with two strides (Flax: g_pre_net's name in use), so the JAX
    # side is its encoder, decoder and flow composed (_JaxFVAEStrides)
    with pytest.raises(Exception, match="g_pre_net"):
        jax.eval_shape(lambda: ja2m.FVAE(**FVAE_KW, strides=(2, 2)).init(
            {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
            jnp.zeros((1, 16, 8)), jnp.ones((1, 16)), jnp.zeros((1, 16, 8))))
    rng = np.random.RandomState(14)
    x = rng.randn(2, 16, 8).astype(np.float32)
    mask = np.ones((2, 16), np.float32)
    mask[1, 11:] = 0.0
    g = rng.randn(2, 16, 8).astype(np.float32)
    jm = _JaxFVAEStrides((2, 2))
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, x, mask, g))
    variables = random_like(shapes, seed=15)
    records, restore = record_draws()
    try:
        want = jax.jit(lambda v: jm.apply(v, x, mask, g, rngs={
            "noise": jax.random.PRNGKey(2)}))(variables)
        jax.effects_barrier()
    finally:
        restore()
    assert [(k, v.shape) for k, v in records] == [("normal", (2, 4, 4))]
    kw = {k: v for k, v in FVAE_KW.items() if k != "hidden_channels"}
    port = load_from_jax(a2m.FVAE(hidden=16, strides=(2, 2), **kw), variables)
    assert port.g_pre_nets == ["g_pre_net_0", "g_pre_net_1"]
    nt = lambda a: t(a).transpose(1, 2)          # noqa: E731  [B,T,C] -> [B,C,T]
    with torch.no_grad():
        recon, loss_kl, z_p, m_q, logs_q = port.forward_train(
            nt(x), t(mask)[:, None], nt(g), ReplayDraws(records))
        for gv, w, name in zip((recon, z_p, m_q, logs_q), want, ("recon", "z_p", "m_q",
                                                                  "logs_q")):
            agree(gv.transpose(1, 2), w, 1e-5, 1e-6, f"train {name}")
        assert torch.isfinite(loss_kl)
        z = rng.randn(2, 4, 4).astype(np.float32)
        w_recon, w_zp = jax.jit(lambda v: jm.apply(v, x, mask, g, z=jnp.asarray(z), rngs={
            "noise": jax.random.PRNGKey(2)}))(variables)
        g_recon, g_zp = port(nt(g), z=nt(z))
        agree(g_recon.transpose(1, 2), w_recon, 1e-5, 1e-6, "infer recon")
        agree(g_zp.transpose(1, 2), w_zp, 1e-5, 1e-6, "infer z_p")

"""Tri-grids in the port against the JAX package: the plain version of kernel
K1-trigrid (tri-grid sampling + OSGDecoder), the two-pass render of rank-6
planes, the backbones' channel split into the render layout, the
``trigrid_v2`` refinement (``Plane2GridModule``) and the composite
canonical backbone in its GroupNorm mode. Weights are seeded numpy leaves
on each JAX module's init tree, loaded with strict name matching."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real3dportrait_tpu.models import img2plane as jimg
from real3dportrait_tpu.models.decoder import OSGDecoder as JaxOSGDecoder
from real3dportrait_tpu.models.img2plane_composite import (
    CompositeImg2PlaneBackbone as JaxComposite,
)
from real3dportrait_tpu.rendering.renderer import (
    RenderOptions as JaxRenderOptions,
    render_rays as jax_render_rays,
    sample_from_trigrids as jax_sample_from_trigrids,
)
from real3dportrait_tpu_torch.geometry.camera import (
    fov_to_intrinsics,
    lookat_pose,
    pack_camera,
    unpack_camera,
)
from real3dportrait_tpu_torch.models import img2plane
from real3dportrait_tpu_torch.models.decoder import (
    OSGDecoder,
    trigrid_decode,
    trigrid_decode_plain,
)
from real3dportrait_tpu_torch.models.img2plane_composite import CompositeImg2PlaneBackbone
from real3dportrait_tpu_torch.rendering.ray_sampler import sample_rays
from real3dportrait_tpu_torch.rendering.renderer import RenderOptions, render_rays
from real3dportrait_tpu_torch.weights import mock_init_
from tests._torch_parity import agree, jax_run, load_from_jax, t, to_np

torch.set_num_threads(1)


def _decoder_pair(c: int, seed: int):
    """A JAX OSGDecoder on C-channel features, its variables and the port's
    decoder loaded with them."""
    jdec = JaxOSGDecoder(hidden_dim=64, output_dim=32)
    variables = jdec.init(jax.random.PRNGKey(seed), jnp.zeros((1, 3, 4, c)))
    return jdec, variables, load_from_jax(OSGDecoder(c, 64, 32), variables)


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("c", [8, 32])
def test_k1_trigrid_plain_matches_jax(d, c):
    # K1-trigrid plain = sample_from_trigrids + OSGDecoder. H != W, and
    # points up to 1.5x the box so that corners fall outside on every axis
    # (zero padding, each corner masked alone). fp32 sums in another order:
    # 1e-5 of scale max, 1e-6 mean
    rng = np.random.RandomState(10 * d + c)
    planes = rng.randn(2, 3, d, 11, 7, c).astype(np.float32)
    coords = rng.uniform(-0.75, 0.75, (2, 400, 3)).astype(np.float32)
    jdec, variables, dec = _decoder_pair(c, seed=d)
    want = jdec.apply(variables, jax_sample_from_trigrids(planes, coords, 1.0))
    rgb, sigma = trigrid_decode_plain(t(planes), t(coords), 1.0, dec)
    agree(rgb, want["rgb"], 1e-5, 1e-6, "K1-trigrid rgb")
    agree(sigma, want["sigma"], 1e-5, 1e-6, "K1-trigrid sigma")
    # the wrapper takes the plain version for CPU tensors, and the decoder
    # dispatches rank-6 planes to it
    rgb_w, sigma_w = trigrid_decode(t(planes), t(coords), 1.0, dec)
    assert torch.equal(rgb_w, rgb) and torch.equal(sigma_w, sigma)
    rgb_d, sigma_d = dec.decode_points(t(planes), t(coords), 1.0)
    assert torch.equal(rgb_d, rgb) and torch.equal(sigma_d, sigma)


@pytest.mark.parametrize("s_coarse,n_fine", [(16, 32), (48, 48)])
def test_render_rays_trigrid_matches_jax(s_coarse, n_fine):
    # the deterministic two-pass render of depth-3 tri-grids on 256 rays
    # (16x16); error compounds through the fine resampling: 1e-4 of scale
    # max, 1e-5 mean
    rng = np.random.RandomState(4)
    planes = (rng.randn(1, 3, 3, 16, 12, 32) * 0.5).astype(np.float32)
    c2w = lookat_pose(torch.full((1,), 0.2), torch.zeros(1), torch.tensor([[0.0, 0.0, 0.2]]))
    c2w, intr = unpack_camera(pack_camera(c2w, fov_to_intrinsics()))
    o, dirs = sample_rays(c2w, intr, 16)
    jdec, variables, dec = _decoder_pair(32, seed=5)
    opts = dict(depth_resolution=s_coarse, depth_resolution_importance=n_fine)
    want = jax.jit(lambda p, ro, rd: jax_render_rays(
        p, lambda f, _d: jdec.apply(variables, f), ro, rd, JaxRenderOptions(**opts),
        key=None))(jnp.asarray(planes), jnp.asarray(to_np(o)), jnp.asarray(to_np(dirs)))
    got = render_rays(t(planes), dec, o, dirs, RenderOptions(**opts))
    for k in ("rgb", "depth", "weights_sum"):
        agree(got[k], want[k], 1e-4, 1e-5, f"render_rays {k}")
    np.testing.assert_array_equal(to_np(got["is_ray_valid"]), np.asarray(want["is_ray_valid"]))


def test_render_layout_splits_channels_c_major():
    # backbone channel c*D + d is depth slice d of feature c: the JAX
    # _to_render_layout on the same array, exactly
    rng = np.random.RandomState(6)
    raw = rng.randn(2, 3, 5, 4, 8 * 3).astype(np.float32)
    jm = jimg.OSAvatarImg2Plane(triplane_hid_dim=8, triplane_depth=3,
                                triplane_feature_type="trigrid")
    want = jm.apply({}, jnp.asarray(raw), method=lambda m, p: m._to_render_layout(p))
    tm = img2plane.OSAvatarImg2Plane(
        triplane_hid_dim=8, triplane_depth=3, triplane_feature_type="trigrid",
        neural_rendering_resolution=16, final_resolution=64, backbone_scale="nano",
        sr_channel0=16, sr_channel1=8, sr_num_fp16_res=0)
    got = tm.to_render_layout(t(raw))
    assert got.shape == (2, 3, 3, 5, 4, 8)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


@pytest.mark.parametrize("depth", [3, 4], ids=["one_block", "two_blocks"])
def test_plane2grid_module_matches_jax(depth):
    # GroupNorm(4) -> relu -> edge-padded 3x3x3 conv, twice, residual scale
    # alpha (seeded, not 0.01, so the branch counts); fp32: 1e-4 of scale
    # max, 1e-5 mean
    rng = np.random.RandomState(7)
    planes = rng.randn(1, 3, depth, 6, 5, 8).astype(np.float32)
    jm = jimg.Plane2GridModule(triplane_depth=depth, channels=8)
    variables, want = jax_run(jm, planes, seed=8)
    tm = load_from_jax(img2plane.Plane2GridModule(depth, 8), variables)
    with torch.no_grad():
        got = tm(t(planes))
    assert got.shape == planes.shape
    agree(got, want, 1e-4, 1e-5, "Plane2GridModule")
    assert float((got - t(planes)).abs().max()) > 1e-3  # the residual branch acts


def test_trigrid_v2_planes_match_jax():
    # the canonical and SECC plane paths of a trigrid_v2 model share one
    # Plane2GridModule after the render-layout split; canonical + SECC
    # planes through nano SegFormers, fp32: 1e-4 of scale max, 1e-5 mean
    kw = dict(triplane_hid_dim=8, triplane_depth=2, triplane_feature_type="trigrid_v2",
              neural_rendering_resolution=16, final_resolution=64, backbone_scale="nano",
              secc_segformer_scale="nano", sr_channel0=16, sr_channel1=8, sr_num_fp16_res=0,
              num_samples_coarse=8, num_samples_fine=8)
    rng = np.random.RandomState(11)
    img = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    secc = rng.uniform(-1, 1, (1, 64, 64, 9)).astype(np.float32)
    cam = np.concatenate([np.eye(4).reshape(1, 16), np.eye(3).reshape(1, 9)], -1)
    variables, want = jax_run(
        jimg.OSAvatarSECCImg2Plane(**kw), img, secc, init_args=(img, cam.astype(np.float32)),
        secc=secc, seed=12,
        method=lambda m, i, s: m.cal_plane_given_cano(m.cal_cano_plane(i), s))
    tm = load_from_jax(img2plane.OSAvatarSECCImg2Plane(**kw), variables)
    with torch.no_grad():
        got = tm.cal_plane_given_cano(tm.cal_cano_plane(t(img)), t(secc))
    assert got.shape == (1, 3, 2, 32, 32, 8)
    agree(got, want, 1e-4, 1e-5, "trigrid_v2 planes")


def test_mock_init_covers_the_tri_grid_refinement():
    # seeded mock weights: SameBlock3d's residual scale starts at 0.01, its
    # GroupNorms at ones and zeros, its convs lecun-normal
    m = mock_init_(img2plane.Plane2GridModule(4, 8), torch.Generator().manual_seed(0))
    for block in (m.block0, m.block1):
        assert torch.equal(block.alpha, torch.full((1,), 0.01))
        assert torch.equal(block.norm1.weight, torch.ones(8))
        assert torch.equal(block.norm2.bias, torch.zeros(8))
        std = float(block.conv1.weight.std())
        assert 0.5 / (8 * 27) ** 0.5 < std < 2.0 / (8 * 27) ** 0.5
        assert torch.equal(block.conv2.bias, torch.zeros(8))


def test_composite_backbone_gn_matches_jax():
    # dilated ResNet34 with GroupNorms (group counts min(32, C//8)) + ASPP +
    # two ViTs (vit_dim 32) + detail CNN, ~60 layers in fp32: 1e-4 of the
    # plane scale max, 1e-5 mean
    img = np.random.RandomState(9).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    jm = JaxComposite(plane_channels=8, scale="small", vit_dim=32, norm_mode="gn")
    variables, want = jax_run(jm, img, seed=10)
    tm = load_from_jax(CompositeImg2PlaneBackbone(plane_channels=8, scale="small",
                                                  vit_dim=32, norm_mode="gn"), variables)
    assert tm.low_reso_encoder.encoder.layer1_0.bn1.num_groups == 8  # 64 channels
    with torch.no_grad():
        got = tm(t(img))
    assert got.shape == (1, 3, 32, 32, 8)
    agree(got, want, 1e-4, 1e-5, "composite planes (gn)")


def test_k1_trigrid_wrapper_rejects_non_cpu_non_cuda_tensors():
    # the plain version runs only for CPU tensors; anything else must
    # launch the kernel or raise, never fall back
    _, _, dec = _decoder_pair(32, seed=0)
    planes = torch.zeros((1, 3, 3, 4, 4, 32), device="meta")
    coords = torch.zeros((1, 5, 3), device="meta")
    with pytest.raises(ValueError):
        trigrid_decode(planes, coords, 1.0, dec)
    with pytest.raises(ValueError):
        dec.decode_points(planes, coords, 1.0)

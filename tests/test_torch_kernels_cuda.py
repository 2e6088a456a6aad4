"""Kernels K1-K7b and K1-trigrid against their plain PyTorch versions on a
CUDA device, at edge-case shapes the slice's chip_smoke run does not reach
(several frames per call, ragged ray counts, more than 32 channels, white
background, ties, posed meshes; tri-grids of depth 1-3 with odd H != W and
points outside the box; warps with samples exactly on and far beyond the
volume's faces, K = 9 keypoints, odd volume sizes; every resampling and
epilogue option, in fp32 and bf16; 3D convolutions of kernel 3 and 7 at odd
sizes, input channels that are no multiple of the staged chunk and split
input channels; the estimator's tail at D = 16 and 2). Every test needs a
card and skips without one. On the card (where JAX, which tests/conftest.py imports, is
not installed):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

from real3dportrait_tpu_torch.geometry import bfm
from real3dportrait_tpu_torch.geometry.rasterizer import (
    project_to_screen,
    secc_raster,
    secc_raster_plain,
)
from real3dportrait_tpu_torch.models import torso
from real3dportrait_tpu_torch.models.decoder import (
    OSGDecoder,
    trigrid_decode,
    trigrid_decode_plain,
    triplane_decode,
    triplane_decode_plain,
)
from real3dportrait_tpu_torch.rendering.renderer import (
    importance_sample,
    importance_sample_plain,
    importance_u,
    merge_composite,
    merge_composite_plain,
)
from real3dportrait_tpu_torch.ops import bias_act as ba
from real3dportrait_tpu_torch.ops import conv3d as c3d
from real3dportrait_tpu_torch.ops import upfirdn2d as ufd
from real3dportrait_tpu_torch.weights import mock_init_

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol, what):
    err = float((got - want).abs().max())
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


def test_k1_several_frames_ragged_points(dev):
    # fp32 sums in another order: 1e-4 absolute (rgb in [0,1], sigma O(1))
    g = torch.Generator(device=dev).manual_seed(0)
    planes = torch.randn((2, 3, 40, 24, 32), device=dev, generator=g)
    coords = 1.2 * (torch.rand((2, 1001, 3), device=dev, generator=g) - 0.5)
    dec = mock_init_(OSGDecoder(32, 64, 32), torch.Generator().manual_seed(1)).to(dev)
    before = triplane_decode.launches
    with torch.no_grad():
        k = triplane_decode(planes, coords, 1.0, dec)
        p = triplane_decode_plain(planes, coords, 1.0, dec)
    torch.cuda.synchronize()
    assert triplane_decode.launches == before + 1
    _close(k[0], p[0], 1e-4, "rgb")
    _close(k[1], p[1], 1e-4, "sigma")
    with pytest.raises(ValueError):
        triplane_decode(planes[..., :16], coords, 1.0, dec)


@pytest.mark.parametrize("b,dhw", [(2, (1, 9, 13)), (1, (2, 7, 5)), (2, (3, 11, 6))],
                         ids=["b2_d1", "d2_odd", "b2_d3"])
def test_k1_trigrid_depths_odd_sizes_points_outside(dev, b, dhw):
    # points up to 1.4x the box: corners outside on every axis, zero
    # padding per corner; fp32 sums in another order: 1e-4 absolute
    g = torch.Generator(device=dev).manual_seed(9)
    planes = torch.randn((b, 3, *dhw, 32), device=dev, generator=g)
    coords = 1.4 * (torch.rand((b, 777, 3), device=dev, generator=g) - 0.5)
    dec = mock_init_(OSGDecoder(32, 64, 32), torch.Generator().manual_seed(1)).to(dev)
    before = trigrid_decode.launches
    with torch.no_grad():
        k = trigrid_decode(planes, coords, 1.0, dec)
        p = trigrid_decode_plain(planes, coords, 1.0, dec)
    torch.cuda.synchronize()
    assert trigrid_decode.launches == before + 1
    _close(k[0], p[0], 1e-4, "rgb")
    _close(k[1], p[1], 1e-4, "sigma")
    with pytest.raises(ValueError):
        trigrid_decode(planes[..., :16].contiguous(), coords, 1.0, dec)
    with pytest.raises(ValueError):
        trigrid_decode(planes.double(), coords, 1.0, dec)


@pytest.mark.parametrize("r,s,n", [(37, 4, 7), (129, 100, 40)])
def test_k2_ragged_rays_and_sample_counts(dev, r, s, n):
    # depths O(2-3), cdf sums in another order: 1e-4 absolute
    g = torch.Generator(device=dev).manual_seed(2)
    start = 2.0 + 0.2 * torch.rand((1, r, 1, 1), device=dev, generator=g)
    depths = start + 0.8 * (torch.arange(s, device=dev) + 0.5)[None, None, :, None] / s
    sigma = 3 * torch.randn((1, r, s, 1), device=dev, generator=g)
    u = importance_u(r, n, dev)
    _close(importance_sample(depths, sigma, u), importance_sample_plain(depths, sigma, u),
           1e-4, "fine depths")


@pytest.mark.parametrize("white_back", [False, True])
def test_k3_ragged_rays_wide_channels_and_ties(dev, white_back):
    # composite sums in another order: 1e-4 absolute
    g = torch.Generator(device=dev).manual_seed(3)
    r, s1, s2, c = 37, 5, 3, 40
    d1 = torch.sort(2 + torch.rand((1, r, s1, 1), device=dev, generator=g), dim=2).values
    d2 = torch.sort(2 + torch.rand((1, r, s2, 1), device=dev, generator=g), dim=2).values
    d2[:, :, :1] = d1[:, :, 1:2]  # a tie in every ray: coarse goes first
    d2 = torch.sort(d2, dim=2).values  # both lists must stay sorted
    c1 = torch.rand((1, r, s1, c), device=dev, generator=g)
    c2 = torch.rand((1, r, s2, c), device=dev, generator=g)
    sg1 = 3 * torch.randn((1, r, s1, 1), device=dev, generator=g)
    sg2 = 3 * torch.randn((1, r, s2, 1), device=dev, generator=g)
    args = (d1, c1, sg1, d2, c2, sg2, white_back)
    for k, p, what in zip(merge_composite(*args), merge_composite_plain(*args),
                          ("rgb", "depth", "weights")):
        _close(k, p, 1e-4, what)


def test_k4_posed_frames_match_plain_bit_for_bit(dev):
    # the kernel rounds as the plain version does and breaks ties by face
    # id: equal masks, NCC within 1e-6
    assets = bfm.synthetic_bfm(2000).to(dev)
    rng = np.random.RandomState(4)
    idc, exp = (torch.from_numpy((rng.randn(3, n) * 0.3).astype(np.float32)).to(dev)
                for n in (80, 64))
    euler = torch.from_numpy(rng.uniform(-0.4, 0.4, (3, 3)).astype(np.float32)).to(dev)
    trans = torch.from_numpy(rng.uniform(-0.3, 0.3, (3, 3)).astype(np.float32)).to(dev)
    uv, z = project_to_screen(bfm.compute_face_vertex(assets, idc, exp, euler, trans),
                              1015.0, 112.0, 64)
    uv, z = uv.contiguous(), z.contiguous()
    attr = ((assets.ncc_code + 1) / 2).contiguous()
    km, ki = secc_raster(uv, z, assets.face_buf, attr, 64)
    pm, pi = secc_raster_plain(uv, z, assets.face_buf, attr, 64)
    assert torch.equal(km, pm) and 0.2 < float(km.mean()) < 0.9
    _close(ki, pi, 1e-6, "NCC")


@pytest.mark.parametrize("b,k,dhw,offset", [(2, 9, (3, 7, 5), 0.3), (1, 4, (5, 9, 11), 0.0),
                                            (2, 4, (4, 6, 6), 3.0)],
                         ids=["b2_k9_odd", "on_faces", "far_outside"])
def test_k5a_edge_cases(dev, b, k, dhw, offset):
    # offset 0: kp_s == kp_d, so every candidate samples the grid points,
    # exactly on the faces at +-1; offset 3: every candidate but the
    # identity samples outside the volume (zero padding). 1e-5 absolute
    g = torch.Generator(device=dev).manual_seed(5)
    d, h, w = dhw
    fs = torch.randn((b, d, h, w, 4), device=dev, generator=g)
    kp_d = 1.6 * torch.rand((b, k, 3), device=dev, generator=g) - 0.8
    kp_s = kp_d + offset * torch.sign(torch.randn((b, k, 3), device=dev, generator=g))
    if offset == 0.3:
        kp_s = 1.6 * torch.rand((b, k, 3), device=dev, generator=g) - 0.8
    before = torso.torso_deform_input.launches
    got = torso.torso_deform_input(fs, kp_s, kp_d)
    want = torso.torso_deform_input_plain(fs, kp_s, kp_d)
    torch.cuda.synchronize()
    assert torso.torso_deform_input.launches == before + 1
    _close(got, want, 1e-5, "K5a")
    if offset == 3.0:
        warped = got.view(b, k + 1, 5, d, h, w)[:, 1:, 1:]
        assert float(warped.abs().max()) == 0.0
    with pytest.raises(ValueError):
        torso.torso_deform_input(fs[..., :3].contiguous(), kp_s, kp_d)


@pytest.mark.parametrize("c,dhw,mode", [(32, (3, 7, 5), "faces"), (4, (5, 9, 11), "far"),
                                        (32, (2, 4, 6), "random")])
def test_k5b_edge_cases(dev, c, dhw, mode):
    # border padding: coordinates exactly at +-1 sample the faces, far
    # beyond them clamp to the faces. 1e-5 absolute
    g = torch.Generator(device=dev).manual_seed(6)
    d, h, w = dhw
    fs = torch.randn((2, d, h, w, c), device=dev, generator=g)
    grid = 2.4 * torch.rand((2, d, h, w, 3), device=dev, generator=g) - 1.2
    if mode == "faces":
        grid = torch.sign(grid)
    elif mode == "far":
        grid = 5.0 * torch.sign(grid)
    got = torso.torso_warp_volume(fs, grid)
    _close(got, torso.torso_warp_volume_plain(fs, grid), 1e-5, "K5b")
    with pytest.raises(ValueError):
        torso.torso_warp_volume(fs[..., :3].contiguous(), grid)


@pytest.mark.parametrize("up,down,padding,hw,fsize", [
    (1, 1, (1, 2, 0, 1), (9, 7), 4), (2, 1, (2, 1, 2, 1), (8, 8), 4),
    (1, 2, (1, 1, 1, 1), (13, 10), 4), (2, 2, (-1, 1, 1, -1), (9, 7), 3),
    (2, 1, (-2, -1, 0, 3), (5, 11), 4), (1, 1, 0, (259, 259), 4)])
def test_k6a_resampling_cases(dev, up, down, padding, hw, fsize):
    # direct index arithmetic vs zero insertion + depthwise conv, with an
    # asymmetric filter and a gain; sums in another order: 1e-5 absolute
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((2, 3, *hw), device=dev, generator=g)
    f = ufd.setup_filter([1, 3, 3, 1] if fsize == 4 else [1, 2, 1], device=dev)
    f = f * (1 + 0.3 * torch.randn(f.shape, device=dev, generator=g))
    before = ufd.upfirdn2d.launches
    got = ufd.upfirdn2d(x, f, up=up, down=down, padding=padding, gain=1.7)
    want = ufd.upfirdn2d_plain(x, f, up=up, down=down, padding=padding, gain=1.7)
    torch.cuda.synchronize()
    assert ufd.upfirdn2d.launches == before + 1
    assert got.shape == want.shape
    _close(got, want, 1e-5, "K6a")


@pytest.mark.parametrize("act", ["linear", "relu", "lrelu"])
@pytest.mark.parametrize("clamp", [None, 0.8])
def test_k6b_epilogue_cases(dev, act, clamp):
    # one fused pass, rounded in the plain version's order: 1e-6 absolute
    g = torch.Generator(device=dev).manual_seed(8)
    x = 2 * torch.randn((2, 5, 7, 9), device=dev, generator=g)
    b = torch.randn((5,), device=dev, generator=g)
    scale = torch.rand((2, 5), device=dev, generator=g) + 0.5
    noise = torch.randn((7, 9), device=dev, generator=g)
    for kw in (dict(), dict(scale=scale), dict(scale=scale, noise=noise)):
        got = ba.bias_act(x, b, act=act, gain=1.3, clamp=clamp, axis=1, **kw)
        want = ba.bias_act_plain(x, b, act=act, gain=1.3, clamp=clamp, axis=1, **kw)
        _close(got, want, 1e-6, f"K6b {act} {sorted(kw)}")
    x2 = torch.randn((3, 5), device=dev, generator=g)
    _close(ba.bias_act(x2, b, act=act, clamp=clamp), ba.bias_act_plain(x2, b, act=act,
                                                                      clamp=clamp),
           1e-6, "K6b [N,C]")


def test_k6b_refuses_other_activations(dev):
    x = torch.randn((1, 2, 3, 3), device=dev)
    with pytest.raises(ValueError):
        ba.bias_act(x, None, act="tanh", axis=1)


def _bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in units of the last place of bf16 ``want``."""
    want = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
    return float(((got.float() - want).abs() / ulp).max())


@pytest.mark.parametrize("up,down,padding,hw", [
    (1, 1, 0, (37, 29)), (2, 1, (2, 1, 2, 1), (9, 13)), (2, 2, (-1, 1, 1, -1), (9, 7)),
    (1, 2, (1, 1, 1, 1), (13, 10))])
def test_k6a_bf16_matches_plain_bf16(dev, up, down, padding, hw):
    # bf16 in and out, the sum in fp32 and rounded once, as the plain
    # version's bf16 depthwise convolution; the two sum in another order:
    # within 2 bf16 ulps of the plain output
    g = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn((2, 5, *hw), device=dev, generator=g).bfloat16()
    f = ufd.setup_filter([1, 3, 3, 1], device=dev)
    before = (ufd.upfirdn2d.launches, ufd.upfirdn2d.launches_bf16)
    got = ufd.upfirdn2d(x, f, up=up, down=down, padding=padding, gain=4)
    want = ufd.upfirdn2d_plain(x, f, up=up, down=down, padding=padding, gain=4)
    torch.cuda.synchronize()
    assert (ufd.upfirdn2d.launches, ufd.upfirdn2d.launches_bf16) == (before[0] + 1,
                                                                      before[1] + 1)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _bf16_ulps(got, want) <= 2


@pytest.mark.parametrize("act", ["linear", "lrelu"])
def test_k6b_bf16_matches_plain_bf16(dev, act):
    # every step rounded to bf16 where the plain version's bf16 ops round,
    # with d, noise and bias cast to bf16 first: bit-equal
    g = torch.Generator(device=dev).manual_seed(11)
    x = (40 * torch.randn((2, 5, 7, 9), device=dev, generator=g)).bfloat16()
    b = torch.randn((5,), device=dev, generator=g)
    scale = torch.rand((2, 5), device=dev, generator=g) + 0.5
    noise = torch.randn((7, 9), device=dev, generator=g)
    before = (ba.bias_act.launches, ba.bias_act.launches_bf16)
    for kw in (dict(), dict(scale=scale, noise=noise)):
        got = ba.bias_act(x, b, act=act, gain=2 ** 0.5, clamp=25.0, axis=1, **kw)
        want = ba.bias_act_plain(x, b, act=act, gain=2 ** 0.5, clamp=25.0, axis=1, **kw)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, want), f"K6b bf16 {act} {sorted(kw)}: {_bf16_ulps(got, want)} ulps"
    assert float(want.abs().max()) == 25.0  # the clamp acts
    assert (ba.bias_act.launches, ba.bias_act.launches_bf16) == (before[0] + 2, before[1] + 2)
    with pytest.raises(ValueError):
        ba.bias_act(x.half(), b, act=act, axis=1)


@pytest.mark.parametrize("k,b,ci,co,dhw", [
    (3, 2, 5, 7, (3, 9, 11)), (3, 1, 37, 70, (16, 4, 4)), (3, 1, 300, 40, (5, 8, 8)),
    (7, 1, 13, 9, (4, 7, 5)), (7, 2, 6, 33, (5, 13, 70)), (3, 1, 24, 16, (2, 66, 67))],
    ids=["k3_odd", "k3_deep_split", "k3_ci300", "k7_odd", "k7_wide", "k3_w67"])
def test_k7a_conv3d_cases(dev, k, b, ci, co, dhw):
    # zero "same" padding on every face; input channels no multiple of the
    # staged chunk (8 for k 3, 4 for k 7), output channels no multiple of
    # 32, widths above one tile (64) and split input channels. fp32 sums of
    # up to 300 * 27 terms in another order than cuDNN's: 1e-4 absolute on
    # outputs O(1)
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((b, ci, *dhw), device=dev, generator=g)
    w = torch.randn((co, ci, k, k, k), device=dev, generator=g) / (ci * k ** 3) ** 0.5
    bias = torch.randn((co,), device=dev, generator=g)
    before = c3d.conv3d.launches
    got = c3d.conv3d(x, w, bias)
    torch.cuda.synchronize()
    assert c3d.conv3d.launches == before + 1
    plan = c3d.conv3d_plan(b, ci, co, *dhw, k, c3d.kernel_tiles(), c3d.sm_count(x.device))
    _close(got, c3d.conv3d_plain(x, w, bias), 1e-4, f"K7a {plan}")
    _close(c3d.conv3d(x, w), c3d.conv3d_plain(x, w), 1e-4, "K7a without bias")
    with pytest.raises(ValueError):
        c3d.conv3d(x, torch.randn((co, ci, 5, 5, 5), device=dev), bias)
    with pytest.raises(ValueError):
        c3d.conv3d(x.double(), w, bias)


def test_k7a_module_uses_the_kernel_and_follows_weight_updates(dev):
    conv = c3d.Conv3D(6, 10, 3).to(dev)
    x = torch.randn((1, 6, 4, 9, 9), device=dev)
    before = c3d.conv3d.launches
    with torch.no_grad():
        first = conv(x)
        conv.weight.mul_(2.0)  # the kernel reads the weight as it is now
        conv.bias.zero_()
        second = conv(x)
    torch.cuda.synchronize()
    assert c3d.conv3d.launches == before + 2
    _close(second, c3d.conv3d_plain(x, conv.weight, conv.bias), 1e-4, "after the update")
    assert float((second - first).abs().max()) > 0.1


@pytest.mark.parametrize("b,c,d,hw", [(1, 32, 16, (64, 64)), (2, 57, 16, (9, 37)),
                                      (2, 4, 2, (16, 16)), (1, 3, 2, (5, 70))],
                         ids=["frame", "v1_odd", "tiny", "tiny_wide"])
def test_k7b_mfe_tail_cases(dev, b, c, d, hw):
    # K+1 = 5 candidates; mask logits sum up to 57 * 343 terms and the
    # occlusion heads 57 * 16 * 49 in another order than cuDNN's; after
    # softmax and sigmoid: 1e-4 absolute on the deformation (O(1)) and
    # the occlusion maps
    g = torch.Generator(device=dev).manual_seed(13)
    h, w = hw
    x = torch.randn((b, c, d, h, w), device=dev, generator=g)
    mask_w = torch.randn((5, c, 7, 7, 7), device=dev, generator=g) / (c * 343) ** 0.5
    mask_b = torch.randn((5,), device=dev, generator=g)
    occ_w = torch.randn((2, c * d, 7, 7), device=dev, generator=g) / (c * d * 49) ** 0.5
    occ_b = torch.randn((2,), device=dev, generator=g)
    kp_s = 1.6 * torch.rand((b, 4, 3), device=dev, generator=g) - 0.8
    kp_d = 1.6 * torch.rand((b, 4, 3), device=dev, generator=g) - 0.8
    args = (x, mask_w, mask_b, occ_w, occ_b, kp_s, kp_d)
    before = torso.mfe_tail.launches
    got = torso.mfe_tail(*args)
    want = torso.mfe_tail_plain(*args)
    torch.cuda.synchronize()
    assert torso.mfe_tail.launches == before + 1
    for k_, p_, what in zip(got, want, ("deformation", "occlusion", "occlusion_2")):
        assert k_.shape == p_.shape, what
        _close(k_, p_, 1e-4, f"K7b {what}")
    with pytest.raises(ValueError):
        torso.mfe_tail(x[:, :, :1].contiguous(), mask_w, mask_b, occ_w, occ_b, kp_s, kp_d)

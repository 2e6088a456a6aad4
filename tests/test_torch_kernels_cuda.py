"""Kernels K1-K6 against their plain PyTorch versions on a CUDA device, at
edge-case shapes the slice's chip_smoke run does not reach (several frames
per call, ragged ray counts, more than 32 channels, white background, ties,
posed meshes; warps with samples exactly on and far beyond the volume's
faces, K = 9 keypoints, odd volume sizes; every resampling and epilogue
option). Every test needs a card and skips without one. On the card
(where JAX, which tests/conftest.py imports, is not installed):

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

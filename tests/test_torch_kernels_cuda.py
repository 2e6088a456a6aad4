"""Kernels K1-K4 against their plain PyTorch versions on a CUDA device, at
edge-case shapes the slice's chip_smoke run does not reach (several frames
per call, ragged ray counts, more than 32 channels, white background, ties,
posed meshes). Every test needs a card and skips without one. On the card
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

"""Kernels K1-K7b and K1-trigrid against their plain PyTorch versions on a
CUDA device, at edge-case shapes the slice's chip_smoke run does not reach
(several frames per call, ragged ray counts, more than 32 channels, white
background, ties and repeated depths in every ray, 128 samples a ray,
colour widths of the 16 B and the scalar path, misaligned colour views,
posed meshes; tri-grids of depth 1-3 with odd H != W and
points outside the box; point counts around the decode tile, points all
outside, features of 1e3 beside 1e-3, decoder weights that change between
calls; warps with samples exactly on and far beyond the
volume's faces, K = 9 keypoints, odd volume sizes, the path's shape, ragged
tiles at B = 2, deformations and keypoints near the identity, C = 4, two
launches bit-equal; every resampling and
epilogue option, in fp32 and bf16, rows no multiple of the vector and
misaligned views, with no launch but the kernel's; 3D convolutions of kernel 3 and 7 at odd
sizes, input channels that are no multiple of the step's 8, output
channels across N tiles, widths across M tiles, split input channels and
inputs of 1e4 next to 1e-4; the estimator's tail at D = 16 and 2, at
B = 2 with ragged tiles, and bit-equal from launch to launch); the training
slice's backward kernels (K1-trigrid's at odd grid sizes, points outside
and either output's gradient alone, its Function's gradients reaching the
decoder's parameters; K3's with ties and white background, the scalar
path's widths and misaligned views, odd and 128 samples, every gradient
alone and each one missing, through its Function; K6a's adjoint at
every resampling with its second derivative; K6b's gradient with every
term, through its Function); the torso stage's
backward kernels (K1's on tri-planes with points outside; K7a's weight
gradient at k 3 and 7 with ragged channels, Co <= 8, a depth under the
kernel's reach and split voxels, and its data gradient through K7a; K5a's
and K5b's trilinear adjoints with samples outside and clamped; K7b's at
D = 16 and 2, W = 256, ragged tiles and channel blocks, either occlusion
gradient missing; each through its Function, and a whole tiny torso model's
gradients against the CPU's). Every test needs a
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
    rasterize_verts,
    rasterize_verts_plain,
)
from real3dportrait_tpu_torch.models import torso
from real3dportrait_tpu_torch.models.decoder import (
    OSGDecoder,
    decode_backward_plain,
    trigrid_decode,
    trigrid_decode_plain,
    triplane_decode,
    triplane_decode_backward,
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
from real3dportrait_tpu_torch.utils.precision import set_fp32_policy
from real3dportrait_tpu_torch.weights import mock_init_

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    set_fp32_policy()
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


def _device_kernels(fn) -> list:
    """Names of the device kernels one call of ``fn`` launches (the
    profiler's CUDA events: kernels, copies, memsets). The CPU activity is
    traced too: with the CUDA activity alone, the profiler sometimes
    records no device event at all (``tests/cuda_profiler_probe.py``)."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.parametrize("kind", ["triplane", "trigrid"])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 127, 129, 2049])
def test_k1_point_counts_around_the_tile(dev, kind, n):
    # a warp decodes 16 points and a CTA 8 warps: counts of a tile and of
    # a CTA's tiles +- 1, B = 2, points up to 1.3x the box; fp32 sums and
    # split-TF32 products in another order: 1e-4 absolute
    g = torch.Generator(device=dev).manual_seed(20 + n)
    shape = (2, 3, 2, 9, 13, 32) if kind == "trigrid" else (2, 3, 9, 13, 32)
    fn, plain = ((trigrid_decode, trigrid_decode_plain) if kind == "trigrid" else
                 (triplane_decode, triplane_decode_plain))
    planes = torch.randn(shape, device=dev, generator=g)
    coords = 1.3 * (torch.rand((2, n, 3), device=dev, generator=g) - 0.5)
    dec = mock_init_(OSGDecoder(32, 64, 32), torch.Generator().manual_seed(1)).to(dev)
    with torch.no_grad():
        k, p = fn(planes, coords, 1.0, dec), plain(planes, coords, 1.0, dec)
    torch.cuda.synchronize()
    assert k[0].shape == p[0].shape and k[1].shape == p[1].shape
    _close(k[0], p[0], 1e-4, f"{kind} rgb")
    _close(k[1], p[1], 1e-4, f"{kind} sigma")


@pytest.mark.parametrize("kind", ["triplane", "trigrid"])
def test_k1_points_all_outside_the_box(dev, kind):
    # every corner of every plane outside: zero features, so every point
    # decodes the decoder's constant; 1e-4 absolute
    g = torch.Generator(device=dev).manual_seed(21)
    shape = (1, 3, 3, 16, 16, 32) if kind == "trigrid" else (1, 3, 16, 16, 32)
    fn, plain = ((trigrid_decode, trigrid_decode_plain) if kind == "trigrid" else
                 (triplane_decode, triplane_decode_plain))
    planes = torch.randn(shape, device=dev, generator=g)
    coords = torch.rand((1, 300, 3), device=dev, generator=g) + 0.6   # beyond +0.5 on each axis
    coords[:, ::2] *= -1                                             # and beyond -0.5
    dec = mock_init_(OSGDecoder(32, 64, 32), torch.Generator().manual_seed(1)).to(dev)
    with torch.no_grad():
        k, p = fn(planes, coords, 1.0, dec), plain(planes, coords, 1.0, dec)
        zero = plain(torch.zeros_like(planes), coords, 1.0, dec)
    _close(k[0], p[0], 1e-4, "rgb")
    _close(k[1], p[1], 1e-4, "sigma")
    _close(k[0], zero[0], 1e-4, "rgb of zero features")


@pytest.mark.parametrize("kind", ["triplane", "trigrid"])
def test_k1_keeps_small_features_beside_large_ones(dev, kind):
    # planes of magnitude 1e3 in their lower rows and 1e-3 in their upper
    # rows; points whose every plane coordinate lies in one half or the
    # other, alternating in each warp's tile. A product whose operands lose
    # their lo terms (one-pass TF32) errs by ~2^-11 of itself, 5e-4 of the
    # output's scale; split TF32 with the tensor cores' truncating sums
    # keeps ~1e-6. Held to a float64 decode, sigma and rgb of each group at
    # 1e-5 of the group's largest |sigma| (>= 1; an fp32 sum of 64 terms of
    # 1e3 errs ~1e-7 of its terms)
    g = torch.Generator(device=dev).manual_seed(22)
    shape = (1, 3, 2, 24, 24, 32) if kind == "trigrid" else (1, 3, 24, 24, 32)
    fn, plain = ((trigrid_decode, trigrid_decode_plain) if kind == "trigrid" else
                 (triplane_decode, triplane_decode_plain))
    rows = torch.arange(24, device=dev).view(24, 1, 1)
    planes = torch.randn(shape, device=dev, generator=g) * torch.where(rows < 12, 1e3, 1e-3)
    u = 0.05 + 0.4 * torch.rand((1, 512, 3), device=dev, generator=g)  # rows >= 12 on each plane
    coords = u.clone()
    coords[:, 1::2] = -u[:, 1::2]                                       # rows < 12: the 1e3 half
    dec = mock_init_(OSGDecoder(32, 64, 32), torch.Generator().manual_seed(3)).to(dev)
    with torch.no_grad():
        for p in (dec.net0.bias, dec.net1.bias):
            p.normal_(generator=torch.Generator(device=dev).manual_seed(4))
        rgb, sigma = fn(planes, coords, 1.0, dec)
        # the float64 reference on the CPU (its decoder's layers take the
        # plain versions there)
        want = [t.to(dev) for t in plain(planes.double().cpu(), coords.double().cpu(), 1.0,
                                          dec.double().cpu())]
    for half, what in ((slice(0, None, 2), "1e-3 features"), (slice(1, None, 2), "1e3 features")):
        s_want = want[1][:, half]
        scale = max(float(s_want.abs().max()), 1.0)
        err = float((sigma[:, half].double() - s_want).abs().max())
        assert err <= 1e-5 * scale, f"{what}: sigma err {err} at scale {scale}"
        _close(rgb[:, half].double(), want[0][:, half], 1e-5 * scale, f"{what} rgb")
    assert float(want[1][:, 1::2].abs().max()) > 1e2  # the large half is large


@pytest.mark.parametrize("kind", ["triplane", "trigrid"])
def test_k1_follows_decoder_updates_and_launches_alone(dev, kind):
    # the packed weights are cached on the decoder and refolded when a
    # parameter changes in place or is loaded; a call whose weights are
    # packed launches the kernel and nothing else
    g = torch.Generator(device=dev).manual_seed(23)
    shape = (1, 3, 3, 16, 20, 32) if kind == "trigrid" else (1, 3, 16, 20, 32)
    fn, plain = ((trigrid_decode, trigrid_decode_plain) if kind == "trigrid" else
                 (triplane_decode, triplane_decode_plain))
    planes = torch.randn(shape, device=dev, generator=g)
    coords = torch.rand((1, 1000, 3), device=dev, generator=g) - 0.5
    dec = mock_init_(OSGDecoder(32, 64, 32), torch.Generator().manual_seed(1)).to(dev)
    other = mock_init_(OSGDecoder(32, 64, 32), torch.Generator().manual_seed(2)).to(dev)
    with torch.no_grad():
        first = fn(planes, coords, 1.0, dec)
        dec.net1.weight.mul_(-1.5)
        dec.net0.bias.add_(0.5)
        second = fn(planes, coords, 1.0, dec)
        _close(second[1], plain(planes, coords, 1.0, dec)[1], 1e-4, "after the in-place update")
        assert float((second[1] - first[1]).abs().max()) > 0.1
        dec.load_state_dict(other.state_dict())
        third = fn(planes, coords, 1.0, dec)
        _close(third[0], plain(planes, coords, 1.0, other)[0], 1e-4, "after load_state_dict")
        _close(third[1], plain(planes, coords, 1.0, other)[1], 1e-4, "after load_state_dict")
        names = _device_kernels(lambda: fn(planes, coords, 1.0, dec))
    assert len(names) == 1 and "plane_decode_kernel" in names[0], names


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


@pytest.mark.parametrize("n", [1, 32, 48, 100])
@pytest.mark.parametrize("s", [4, 5, 16, 31, 32, 33, 48, 127, 128])
def test_k2_sample_counts_and_u_strides(dev, s, n):
    # every group width and slot count (W = 16 to 16 intervals, W = 32 with
    # 2 or 4 slots), ragged ray counts, the deterministic u (one row, ray
    # stride 0, with u = 0 and 1) and a per-ray sorted u (stride n). Depths
    # O(2-3), cdf sums in another order: 1e-4 absolute
    g = torch.Generator(device=dev).manual_seed(100 * s + n)
    r = 61 + s
    start = 2.0 + 0.2 * torch.rand((1, r, 1, 1), device=dev, generator=g)
    depths = start + 0.8 * (torch.arange(s, device=dev) + 0.5)[None, None, :, None] / s
    sigma = 3 * torch.randn((1, r, s, 1), device=dev, generator=g)
    shared = importance_u(r, n, dev)
    assert shared.stride(0) == 0
    per_ray = torch.sort(torch.rand((r, n), device=dev, generator=g), dim=-1).values
    for u in (shared, per_ray):
        got = importance_sample(depths, sigma, u)
        assert torch.isfinite(got).all()
        _close(got, importance_sample_plain(depths, sigma, u), 1e-4, f"fine depths, S {s} n {n}")


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


def _k3_tie_args(dev, g, r, s1, s2, c, white_back=False):
    """Sorted coarse depths from a grid of s1 // 2 values (repeats in every
    ray) and fine depths drawn from the ray's own coarse depths (each ties
    a coarse one)."""
    grid = 2.0 + torch.arange(max(s1 // 2, 2), device=dev, dtype=torch.float32) / 16
    d1 = torch.sort(grid[torch.randint(0, len(grid), (1, r, s1), device=dev, generator=g)],
                    dim=-1).values
    d2 = torch.sort(d1.gather(-1, torch.randint(0, s1, (1, r, s2), device=dev, generator=g)),
                    dim=-1).values
    c1 = torch.rand((1, r, s1, c), device=dev, generator=g)
    c2 = torch.rand((1, r, s2, c), device=dev, generator=g)
    sg1 = 3 * torch.randn((1, r, s1, 1), device=dev, generator=g)
    sg2 = 3 * torch.randn((1, r, s2, 1), device=dev, generator=g)
    return d1[..., None], c1, sg1, d2[..., None], c2, sg2, white_back


@pytest.mark.parametrize("s1,s2,c", [(16, 32, 32), (48, 48, 32), (100, 28, 32), (64, 64, 32),
                                     (64, 64, 40), (16, 32, 8), (16, 32, 128), (7, 9, 4)],
                         ids=["fast", "48+48", "100+28", "128_c32", "128_c40", "c8", "c128",
                              "c4"])
def test_k3_ties_in_every_ray_and_sample_widths(dev, s1, s2, c):
    # every fine depth ties a coarse one and each list repeats depths, so
    # the rank merge's tie rule decides where each density lands; C / 4 a
    # power of two up to 32 takes the 16 B path, C = 40 the scalar one.
    # Sums in another order: 1e-4 absolute
    g = torch.Generator(device=dev).manual_seed(14)
    args = _k3_tie_args(dev, g, 301, s1, s2, c, white_back=s1 == 100)
    for k, p, what in zip(merge_composite(*args), merge_composite_plain(*args),
                          ("rgb", "depth", "weights")):
        assert torch.isfinite(k).all(), what
        _close(k, p, 1e-4, what)


@pytest.mark.parametrize("which", ["colors1", "colors2", "both"])
def test_k3_misaligned_colour_views(dev, which):
    # a contiguous view 4 B past a 16 B boundary takes the scalar path
    g = torch.Generator(device=dev).manual_seed(15)
    d1, c1, sg1, d2, c2, sg2, wb = _k3_tie_args(dev, g, 129, 64, 64, 32)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, device=dev)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 == 4
        return view

    if which in ("colors1", "both"):
        c1 = shifted(c1)
    if which in ("colors2", "both"):
        c2 = shifted(c2)
    args = (d1, c1, sg1, d2, c2, sg2, wb)
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
    verts = bfm.compute_face_vertex(assets, idc, exp, euler, trans)
    attr = ((assets.ncc_code + 1) / 2).contiguous()
    km, ki = rasterize_verts(verts, assets.face_buf, attr, 1015.0, 112.0, 64)
    pm, pi = rasterize_verts_plain(verts, assets.face_buf, attr, 1015.0, 112.0, 64)
    assert torch.equal(km, pm) and 0.2 < float(km.mean()) < 0.9
    _close(ki, pi, 1e-6, "NCC")


def _k4_scene(dev, t: int, seed: int):
    """``t`` posed frames of the 2000-vertex synthetic mesh, every other one
    (the only one at t = 1) pulled towards the camera to z 4.4-6.6, where
    its faces cross znear = 5 and grow to 30-60 px at 512^2, with 16 large
    faces (two vertices 25-60 px from a third in frame 0, at most 150 px
    wide in every frame, which bounds the plain version's patch) added to
    the mesh; its faces and NCC colours in [0, 1]."""
    assets = bfm.synthetic_bfm(2000).to(dev)
    rng = np.random.RandomState(seed)
    idc, exp = (torch.from_numpy((rng.randn(t, n) * 0.3).astype(np.float32)).to(dev)
                for n in (80, 64))
    euler = torch.from_numpy(rng.uniform(-0.4, 0.4, (t, 3)).astype(np.float32)).to(dev)
    trans = torch.from_numpy(rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)).to(dev)
    verts = bfm.compute_face_vertex(assets, idc, exp, euler, trans).clone()
    verts[slice(1, None, 2) if t > 1 else slice(0, 1), :, 2] -= 4.5
    uv = project_to_screen(verts, 1015.0, 112.0, 512)[0]            # [T,N,2]
    big = []
    for a in rng.permutation(assets.n_vertices):
        near = torch.nonzero(((uv[0] - uv[0, a]).norm(dim=-1) - 42.5).abs() < 17.5).flatten()
        if len(near) < 2:
            continue
        face = [int(a), int(near[0]), int(near[-1])]
        corners = uv[:, face]                                      # [T,3,2]
        if float((corners.amax(1) - corners.amin(1)).max()) <= 150:
            big.append(face)
        if len(big) == 16:
            break
    faces = torch.cat([assets.face_buf, torch.tensor(big, dtype=torch.int32, device=dev)])
    return verts.contiguous(), faces.contiguous(), ((assets.ncc_code + 1) / 2).contiguous()


@pytest.mark.parametrize("t", [1, 3, 16])
def test_k4_frames_512_large_faces_and_faces_across_znear(dev, t):
    # bit-equal to the plain version (equal masks, NCC within 1e-6) for
    # posed frames at 512^2, added faces 20-150 px wide, faces cut by znear
    # (5, and 5.5 with zfar 6, which also leaves the unmoved frames empty)
    verts, faces, attr = _k4_scene(dev, t, seed=20 + t)
    z = verts[..., 2][:, faces.long()]                             # [T,F,3]
    for znear, zfar in ((5.0, 15.0), (5.5, 6.0)):
        crossing = ((z.min(-1).values < znear) & (z.max(-1).values > znear)).sum()
        assert int(crossing) > 0
        args = (verts, faces, attr, 1015.0, 112.0, 512, znear, zfar)
        km, ki = rasterize_verts(*args)
        pm, pi = rasterize_verts_plain(*args)
        assert torch.equal(km, pm) and 0.01 < float(km.mean()) < 0.99
        _close(ki, pi, 1e-6, f"NCC, znear {znear}")


def test_k4_two_meshes_in_a_row_and_bit_equal_launches(dev):
    # the wrapper keeps one z-buffer per (size, stream), as many frames as
    # the largest call, and the resolve cleans it: a call on another mesh or
    # on fewer frames is the plain version's too, and a launch repeats bit
    # for bit
    first, second = _k4_scene(dev, 3, seed=30), _k4_scene(dev, 3, seed=31)
    one = tuple(a[:1].contiguous() if i == 0 else a for i, a in enumerate(second))
    for args in (first, second, one, first):
        km, ki = rasterize_verts(*args, 1015.0, 112.0, 192)
        pm, pi = rasterize_verts_plain(*args, 1015.0, 112.0, 192)
        assert torch.equal(km, pm)
        _close(ki, pi, 1e-6, "NCC")
        again = rasterize_verts(*args, 1015.0, 112.0, 192)
        assert torch.equal(again[0], km) and torch.equal(again[1], ki)


def test_k4_names_its_frame_cap(dev):
    # the frames lie on the grid's y axis: more than 65535 a call raise
    # ValueError before any launch
    verts = torch.zeros((65536, 3, 3), device=dev)
    faces = torch.tensor([[0, 1, 2]], dtype=torch.int32, device=dev)
    attr = torch.zeros((3, 3), device=dev)
    launches = rasterize_verts.launches
    with pytest.raises(ValueError, match="65535"):
        rasterize_verts(verts, faces, attr, 1015.0, 112.0, 8)
    assert rasterize_verts.launches == launches


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


@pytest.mark.parametrize("b,dhw,reach,near", [
    (1, (16, 64, 64), 0.8, False), (1, (16, 64, 64), 0.8, True), (2, (2, 5, 70), 0.8, False),
    (2, (2, 7, 5), 0.8, True), (2, (2, 3, 68), 1.6, False)],
    ids=["path", "path_near_identity", "b2_w70", "b2_w5_near_identity", "b2_w68_outside"])
def test_k5a_path_shape_and_ragged(dev, b, dhw, reach, near):
    # the kernel rounds the grid coordinates and gaussians as the plain
    # version does on the card (i * fp32(1 / (n - 1)), where i / (n - 1)
    # moves 27 of 64 coordinates): 1e-5 absolute at the path's 64 voxels a
    # side; near the identity the source keypoints lie within 0.1 of the
    # driving ones. Two launches are bit-equal.
    g = torch.Generator(device=dev).manual_seed(7)
    d, h, w = dhw
    fs = torch.randn((b, d, h, w, 4), device=dev, generator=g)
    kp_d = reach * (2 * torch.rand((b, 4, 3), device=dev, generator=g) - 1)
    kp_s = reach * (2 * torch.rand((b, 4, 3), device=dev, generator=g) - 1)
    if near:
        kp_s = kp_d + 0.1 * (2 * torch.rand((b, 4, 3), device=dev, generator=g) - 1)
    before = torso.torso_deform_input.launches
    got = torso.torso_deform_input(fs, kp_s, kp_d)
    again = torso.torso_deform_input(fs, kp_s, kp_d)
    want = torso.torso_deform_input_plain(fs, kp_s, kp_d)
    torch.cuda.synchronize()
    assert torso.torso_deform_input.launches == before + 2
    _close(got, want, 1e-5, "K5a")
    assert torch.equal(got, again)


@pytest.mark.parametrize("b,c,dhw,near", [
    (1, 32, (16, 64, 64), True), (2, 32, (2, 3, 70), False), (2, 32, (2, 4, 5), True),
    (2, 32, (2, 3, 68), False), (1, 4, (16, 64, 64), True), (2, 4, (2, 5, 70), False),
    (2, 4, (2, 3, 5), True)],
    ids=["path_near_identity", "b2_w70", "b2_w5_near_identity", "b2_w68", "c4_near_identity",
         "c4_b2_w70", "c4_b2_w5_near_identity"])
def test_k5b_path_shape_and_ragged(dev, b, c, dhw, near):
    # C = 32 (8 lanes a voxel, the shared-memory fold, 16 B stores where W
    # is a multiple of 4, else scalar) and C = 4 (a lane a voxel); ragged
    # tiles at W = 5, 68 and 70; near the identity the deformation lies
    # within 0.02 of the grid, else uniform in [-1.2, 1.2]. The same
    # coordinates reach both versions: 1e-5 absolute. Two launches are
    # bit-equal.
    g = torch.Generator(device=dev).manual_seed(8)
    d, h, w = dhw
    fs = torch.randn((b, d, h, w, c), device=dev, generator=g)
    grid = 2.4 * torch.rand((b, d, h, w, 3), device=dev, generator=g) - 1.2
    if near:
        grid = torso.make_coordinate_grid_3d(d, h, w, dev)[None] + 0.02 * (
            2 * torch.rand((b, d, h, w, 3), device=dev, generator=g) - 1)
    before = torso.torso_warp_volume.launches
    got = torso.torso_warp_volume(fs, grid)
    again = torso.torso_warp_volume(fs, grid)
    torch.cuda.synchronize()
    assert torso.torso_warp_volume.launches == before + 2
    _close(got, torso.torso_warp_volume_plain(fs, grid), 1e-5, "K5b")
    assert torch.equal(got, again)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("up,down,padding,hw,separable", [
    (1, 1, 0, (131, 200), True), (1, 1, (-2, 3, 1, -1), (70, 133), True),
    (1, 1, 0, (5, 6), True), (1, 1, (1, 0, 2, 1), (67, 129), False),
    (2, 1, (2, 1, 2, 1), (37, 45), True), (2, 1, (1, 2, 1, 2), (21, 18), True),
    (2, 1, (-1, 0, 2, -3), (9, 14), False), (1, 2, (1, 1, 1, 1), (33, 21), True),
    (2, 2, (-3, 1, 2, -2), (19, 17), True)],
    ids=["tile_ragged", "tile_crop_pad", "tile_narrow", "general_2d", "up2_even_pads",
         "up2_odd_pads", "up2_crop_2d", "down2", "up2_down2_crop"])
def test_k6a_paths(dev, dtype, up, down, padding, hw, separable):
    # the block FIR's staged tile over ragged tiles, crops and planes
    # narrower than a tile; a 4x4 filter of rank > 1 at up 1 (the general
    # path); the polyphase x2 upsample at every padding parity; the general
    # path's up/down. B = 2. fp32: 1e-5
    # absolute (sums in another order); bf16: within 2 ulps of the plain
    # version, which also sums in fp32 and rounds once
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((2, 3, *hw), device=dev, generator=g).to(dtype)
    f = ufd.setup_filter([1, 3, 3, 1], device=dev)
    if not separable:
        f = f * (1 + 0.3 * torch.randn(f.shape, device=dev, generator=g))
    assert ufd.fir_taps(f, 4, dtype).separable == separable
    before = ufd.upfirdn2d.launches
    got = ufd.upfirdn2d(x, f, up=up, down=down, padding=padding, gain=4)
    want = ufd.upfirdn2d_plain(x, f, up=up, down=down, padding=padding, gain=4)
    torch.cuda.synchronize()
    assert ufd.upfirdn2d.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.bfloat16:
        assert _bf16_ulps(got, want) <= 2
    else:
        _close(got, want, 1e-5, "K6a")


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("offset,hw", [(0, (33, 35)), (1, (33, 35)), (1, (64, 64)),
                                       (3, (1, 5)), (0, (64, 64))],
                         ids=["hw_ragged", "misaligned_ragged", "misaligned", "narrow", "aligned"])
def test_k6b_ragged_rows_and_misaligned_views(dev, dtype, offset, hw):
    # HW no multiple of the 16 B vector (33 x 35; 5, narrower than one),
    # x and noise as views at an element offset of a larger buffer (not 16 B
    # aligned), B = 2 x C = 16 rows; every term, then the bias alone. bf16:
    # bit-equal to the plain version; fp32: 1e-6 absolute
    g = torch.Generator(device=dev).manual_seed(24)
    shape = (2, 16, *hw)
    n = int(np.prod(shape))
    x = (4 * torch.randn((n + offset,), device=dev, generator=g)).to(dtype)[offset:]
    x = x.view(shape)
    noise = torch.randn((hw[0] * hw[1] + offset,), device=dev, generator=g)[offset:].view(hw)
    assert (x.data_ptr() % 16 != 0) == (offset != 0)
    b = torch.randn((16,), device=dev, generator=g)
    scale = torch.rand((2, 16), device=dev, generator=g) + 0.5
    before = ba.bias_act.launches
    for kw in (dict(act="lrelu", gain=2 ** 0.5, clamp=5.0, scale=scale, noise=noise), dict()):
        got = ba.bias_act(x, b, axis=1, **kw)
        want = ba.bias_act_plain(x, b, axis=1, **kw)
        assert got.dtype == dtype and got.shape == want.shape
        if dtype == torch.bfloat16:
            assert torch.equal(got, want), f"K6b bf16 {sorted(kw)}: {_bf16_ulps(got, want)} ulps"
        else:
            _close(got, want, 1e-6, f"K6b {sorted(kw)}")
    assert ba.bias_act.launches == before + 2


def test_k6b_bf16_bit_equal_with_fp32_terms_and_no_casts(dev):
    # block-shaped bf16 epilogue at [1,16,33,35] with fp32 d, noise and
    # bias, as the SR blocks pass them: bit-equal to the plain version, and
    # the wrapper launches the kernel alone (no casts of the terms)
    g = torch.Generator(device=dev).manual_seed(25)
    x = (40 * torch.randn((1, 16, 33, 35), device=dev, generator=g)).bfloat16()
    kw = dict(act="lrelu", gain=2 ** 0.5, clamp=25.0, axis=1,
              scale=torch.rand((1, 16), device=dev, generator=g) + 0.5,
              noise=torch.randn((33, 35), device=dev, generator=g))
    b = torch.randn((16,), device=dev, generator=g)
    got = ba.bias_act(x, b, **kw)
    want = ba.bias_act_plain(x, b, **kw)
    assert torch.equal(got, want), f"{_bf16_ulps(got, want)} ulps"
    assert float(want.abs().max()) == 25.0  # the clamp acts
    names = _device_kernels(lambda: ba.bias_act(x, b, **kw))
    assert len(names) == 1 and "bias_act" in names[0], names


@pytest.mark.parametrize("k,b,ci,co,dhw", [
    (3, 2, 5, 7, (3, 9, 11)), (3, 1, 37, 70, (16, 4, 4)), (3, 1, 300, 40, (5, 8, 8)),
    (7, 1, 13, 9, (4, 7, 5)), (7, 2, 6, 33, (5, 13, 70)), (3, 1, 24, 16, (2, 66, 67)),
    (3, 1, 25, 64, (4, 16, 64)), (7, 1, 89, 32, (3, 8, 64)), (3, 1, 16, 20, (3, 6, 70)),
    (3, 1, 40, 70, (3, 5, 70)), (3, 1, 1024, 96, (16, 4, 4)), (3, 2, 25, 40, (4, 8, 12))],
    ids=["k3_odd", "k3_deep_split", "k3_ci300", "k7_odd", "k7_wide", "k3_w67", "k3_ci25",
         "k7_ci89", "k3_co20_w70", "k3_co70_w70", "k3_ci1024_split", "k3_b2"])
def test_k7a_conv3d_cases(dev, k, b, ci, co, dhw):
    # zero "same" padding on every face; input channels no multiple of the
    # step's 8 (25, 89), output channels below one N tile (20 < 32) and
    # across two (33 at k 7, 70 at k 3), widths across an M tile (67, 70 >
    # 64), split input channels (1024 on a 4^2 plane), B = 2. Split-TF32
    # products summed in fp32 over up to 89 * 343 terms in another order
    # than cuDNN's fp32: 1e-4 absolute on outputs O(1)
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


def test_k7a_conv3d_keeps_small_values_beside_large_ones(dev):
    # inputs of magnitude 1e4 next to 1e-4 (random signs and places): a
    # product whose operands lose their lo terms errs by up to 2^-11 of
    # itself, ~1e-4 of the output's scale, where the split keeps ~1e-7.
    # Held to a float64 conv at 1e-5 of the output's largest magnitude, and
    # in the depth slices that see only the 1e-4 inputs at 1e-5 of theirs
    g = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn((1, 24, 8, 12, 64), device=dev, generator=g).sign()
    big = torch.rand((1, 24, 8, 12, 64), device=dev, generator=g) < 0.5
    big[:, :, 5:] = False
    x = x * torch.where(big, 1e4, 1e-4)
    w = torch.randn((40, 24, 3, 3, 3), device=dev, generator=g) / (24 * 27) ** 0.5
    got = c3d.conv3d(x, w)
    want = c3d.conv3d_plain(x.double(), w.double())
    err = (got.double() - want).abs()
    assert float(err.max()) <= 1e-5 * float(want.abs().max())
    small = want[:, :, 6:]
    assert float(err[:, :, 6:].max()) <= 1e-5 * float(small.abs().max())
    assert float(small.abs().max()) < 1e-2  # those slices see no 1e4 input


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
                                      (2, 4, 2, (16, 16)), (1, 3, 2, (5, 70)),
                                      (2, 32, 16, (30, 45)), (2, 5, 2, (13, 35))],
                         ids=["frame", "v1_odd", "tiny", "tiny_wide", "b2_ragged",
                              "tiny_b2_ragged"])
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


def test_k7b_two_launches_are_bit_equal(dev):
    # the channel splits' partial sums are added in split order, with no
    # atomics: the result does not depend on the order in which the CTAs
    # run
    g = torch.Generator(device=dev).manual_seed(16)
    c, d, h, w = 32, 16, 64, 64
    args = (torch.randn((1, c, d, h, w), device=dev, generator=g),
            torch.randn((5, c, 7, 7, 7), device=dev, generator=g) / (c * 343) ** 0.5,
            torch.randn((5,), device=dev, generator=g),
            torch.randn((2, c * d, 7, 7), device=dev, generator=g) / (c * d * 49) ** 0.5,
            torch.randn((2,), device=dev, generator=g),
            1.6 * torch.rand((1, 4, 3), device=dev, generator=g) - 0.8,
            1.6 * torch.rand((1, 4, 3), device=dev, generator=g) - 0.8)
    first = torso.mfe_tail(*args)
    for _ in range(3):
        again = torso.mfe_tail(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))


# -- the training slice's backward kernels and autograd Functions ------------------


def _rel_close(got, want, tol, what):
    scale = max(float(want.float().abs().max()), 1e-30)
    err = float((got.float() - want.float()).abs().max()) / scale
    assert err <= tol, f"{what}: max err / scale {err:.3e} > {tol}"


@pytest.mark.parametrize("b,dhw,n", [(2, (3, 9, 13), 1001), (1, (1, 5, 4), 64),
                                     (3, (2, 7, 5), 37), (1, (3, 16, 16), 2 * 132 * 128 + 9)],
                         ids=["b2_d3_ragged", "d1_one_tile", "b3_part_round",
                              "rounds_and_a_tail"])
def test_k1_trigrid_backward_odd_sizes_points_outside(dev, b, dhw, n):
    # atomics in a run-dependent order: 1e-4 of the largest magnitude
    g = torch.Generator(device=dev).manual_seed(21)
    planes = torch.randn((b, 3, *dhw, 32), device=dev, generator=g)
    coords = 1.4 * (torch.rand((b, n, 3), device=dev, generator=g) - 0.5)
    dec = mock_init_(OSGDecoder(32, 64, 32), torch.Generator().manual_seed(2)).to(dev)
    w0, b0 = dec.net0.folded()
    w1, b1 = dec.net1.folded()
    ws = [t.detach() for t in (w0, b0, w1, b1)]
    drgb = torch.randn((b, n, 32), device=dev, generator=g)
    dsig = torch.randn((b, n, 1), device=dev, generator=g)
    from real3dportrait_tpu_torch.models import decoder as dm

    for grads in ((drgb, dsig), (None, dsig), (drgb, None)):
        k = dm.trigrid_decode_backward(planes, coords, 1.0, *ws, *grads)
        p = dm.decode_backward_plain(planes, coords, 1.0, *ws, *grads)
        torch.cuda.synchronize()
        for x, y, name in zip(k, p, ("planes", "w0", "b0", "w1", "b1")):
            _rel_close(x, y, 1e-4, f"d {name}")


def test_k1_trigrid_function_grads_reach_the_parameters(dev):
    """autograd through the Function: the tri-grids' and every decoder
    parameter's gradient (the equalised-LR gains applied in the backward)
    against autograd through the plain version; the packed copy is rebuilt
    after an in-place update and carries no gradient; coordinates that need
    a gradient raise."""
    from real3dportrait_tpu_torch.models import decoder as dm

    g = torch.Generator(device=dev).manual_seed(22)
    dec = mock_init_(OSGDecoder(32, 64, 32), torch.Generator().manual_seed(3)).to(dev)
    planes = torch.randn((2, 3, 3, 8, 8, 32), device=dev, generator=g).requires_grad_(True)
    coords = torch.rand((2, 500, 3), device=dev, generator=g) - 0.5
    drgb = torch.randn((2, 500, 32), device=dev, generator=g)
    params = [planes] + list(dec.parameters())
    for _ in range(2):
        k = dm.trigrid_decode(planes, coords, 1.0, dec)
        gk = torch.autograd.grad(k, params, (drgb, torch.ones_like(k[1])))
        p = dm.trigrid_decode_plain(planes, coords, 1.0, dec)
        gp = torch.autograd.grad(p, params, (drgb, torch.ones_like(p[1])))
        for a, b_, i in zip(gk, gp, range(len(gk))):
            _rel_close(a, b_, 1e-4, f"grad {i}")
        assert not dec.__dict__["_packed_mlp"][1].requires_grad
        with torch.no_grad():
            dec.net0.weight.add_(0.1)      # the cache is keyed by the version: repacked
    with pytest.raises(ValueError):
        dm.trigrid_decode(planes, coords.clone().requires_grad_(True), 1.0, dec)


def _shifted(t):
    """A contiguous copy of ``t`` 4 B past a 16 B boundary."""
    flat = torch.empty(t.numel() + 1, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize("s1,s2,c,white,shift", [
    (48, 48, 32, False, None), (7, 13, 12, True, None), (64, 64, 32, False, None),
    (16, 32, 30, False, None), (17, 30, 32, True, None), (9, 14, 24, False, None),
    (5, 11, 128, True, None), (48, 48, 32, False, "colours"), (48, 48, 32, True, "grad")],
    ids=["path", "scalar_white", "128_samples", "c_not_4", "odd_s_white", "c4_not_pow2",
         "c128_white", "misaligned_colours", "misaligned_grad"])
def test_k3_backward_ties_white_back(dev, s1, s2, c, white, shift):
    # ties between the lists and repeated depths; the scalar path (C % 4,
    # C / 4 no power of two, a colour or gradient view 4 B past 16 B), odd
    # and 128 samples, C = 128 (one row a warp instruction); every gradient
    # alone and each one missing; fp32 reverse scan: 1e-4 of the largest
    # magnitude
    from real3dportrait_tpu_torch.rendering import renderer as rr

    g = torch.Generator(device=dev).manual_seed(23)
    b, m = 2, 333
    d1 = torch.sort(2 + torch.rand((b, m, s1, 1), device=dev, generator=g), dim=2).values
    d2 = torch.sort(2 + torch.rand((b, m, s2, 1), device=dev, generator=g), dim=2).values
    d2[:, :, 1] = d1[:, :, 2]
    d2 = torch.sort(d2, dim=2).values
    cols = [torch.rand((b, m, s, c), device=dev, generator=g) for s in (s1, s2)]
    sig = [3 * torch.randn((b, m, s, 1), device=dev, generator=g) for s in (s1, s2)]
    grads = (torch.randn((b, m, c), device=dev, generator=g),
             torch.randn((b, m, 1), device=dev, generator=g),
             torch.randn((b, m, s1 + s2 - 1, 1), device=dev, generator=g))
    if shift == "colours":
        cols = [_shifted(x) for x in cols]
    if shift == "grad":
        grads = (_shifted(grads[0]),) + grads[1:]
    args = (d1, cols[0], sig[0], d2, cols[1], sig[1], white)
    sets = [grads] + [tuple(x if i == j else None for j, x in enumerate(grads))
                      for i in range(3)] + [tuple(None if i == j else x
                                                  for j, x in enumerate(grads))
                                            for i in range(3)]
    for gr in sets:
        k = rr.merge_composite_backward(*args, *gr)
        p = rr.merge_composite_backward_plain(*args, *gr)
        torch.cuda.synchronize()
        for x, y, name in zip(k, p, ("c1", "s1", "c2", "s2")):
            assert torch.isfinite(x).all(), name
            _rel_close(x, y, 1e-4, f"d {name}")
    # through the Function: colours and densities only
    leaves = [cols[0].requires_grad_(True), sig[0].requires_grad_(True)]
    out = rr.merge_composite(d1, leaves[0], leaves[1], d2, cols[1], sig[1], white)
    gk = torch.autograd.grad(out, leaves, grads)
    outp = rr.merge_composite_plain(d1, leaves[0], leaves[1], d2, cols[1], sig[1], white)
    gp = torch.autograd.grad(outp, leaves, grads)
    for x, y in zip(gk, gp):
        _rel_close(x, y, 1e-4, "Function")
    with pytest.raises(ValueError):
        rr.merge_composite(d1.requires_grad_(True), *args[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("up,down,pad", [(1, 1, (2, 1, 2, 1)), (2, 1, (2, 1, 2, 1)),
                                         (1, 2, (1, 1, 1, 1)), (2, 2, (-3, 1, 2, -2)),
                                         (1, 1, (2, 2, 2, 2))])
def test_k6a_backward_and_second_derivative(dev, dtype, up, down, pad):
    """K6a's adjoint through K6a at every resampling, odd sizes, crops; the
    Function's gradient and its gradient again against the plain
    version's; fp32 1e-5, bf16 2 ulps of the output (1e-2 relative)."""
    g = torch.Generator(device=dev).manual_seed(24)
    f = ufd.setup_filter([1, 3, 3, 1], device=dev) * (
        1 + 0.1 * torch.rand((4, 4), device=dev, generator=g))
    x = torch.randn((2, 5, 21, 19), device=dev, generator=g).to(dtype)
    y = ufd.upfirdn2d_plain(x, f, up, down, pad, 4)
    dy = torch.randn(tuple(y.shape), device=dev, generator=g).to(dtype)
    before = ufd.upfirdn2d_backward.launches
    k = ufd.upfirdn2d_backward(dy, f, up, down, pad, 4, (21, 19))
    p = ufd.upfirdn2d_backward_plain(dy, f, up, down, pad, 4, (21, 19))
    torch.cuda.synchronize()
    assert ufd.upfirdn2d_backward.launches == before + 1 and k.shape == x.shape
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    _rel_close(k, p, tol, "adjoint")
    outs = []
    for fn in (ufd.upfirdn2d, ufd.upfirdn2d_plain):
        xx = x.clone().requires_grad_(True)
        v = dy.clone().requires_grad_(True)
        gx = torch.autograd.grad(fn(xx, f, up, down, pad, 4), xx, v, create_graph=True)[0]
        w = torch.ones_like(gx)
        outs.append(torch.autograd.grad(gx, v, w)[0])
    _rel_close(outs[0], outs[1], tol, "second derivative")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,clamp,terms", [("lrelu", 1.5, "scale+noise"),
                                             ("relu", None, "none"),
                                             ("linear", 0.7, "noise"),
                                             ("lrelu", None, "flat")])
def test_k6b_grad_every_term(dev, dtype, act, clamp, terms):
    """dx, db, dscale, dnoise of the gradient kernel against the plain
    version (rows not a multiple of the vector, the clamp acting); through
    the Function against autograd of the plain forward."""
    g = torch.Generator(device=dev).manual_seed(25)
    flat = terms == "flat"
    shape = (7, 33) if flat else (2, 3, 13, 11)
    x = (2 * torch.randn(shape, device=dev, generator=g)).to(dtype)
    c = shape[1]
    b = 0.3 * torch.randn((c,), device=dev, generator=g)
    scale = torch.rand((2, c), device=dev, generator=g) + 0.5 if "scale" in terms else None
    noise = 0.3 * torch.randn((13, 11), device=dev, generator=g) if "noise" in terms else None
    axis = -1 if flat else 1
    kw = dict(act=act, clamp=clamp, axis=axis, scale=scale)
    with torch.no_grad():
        y = ba.bias_act(x, b, noise=noise, **kw)
    dy = torch.randn(shape, device=dev, generator=g).to(dtype)
    flags = dict(need_b=True, need_scale=True, need_noise=noise is not None)
    k = ba.bias_act_grad(dy, y, x, **kw, **flags)
    p = ba.bias_act_grad_plain(dy, y, x, **kw, **flags)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for a, b_, name in zip(k, p, ("dx", "db", "dscale", "dnoise")):
        if b_ is not None:
            _rel_close(a, b_, tol, name)
    leaves = [x.clone().requires_grad_(True), b.clone().requires_grad_(True)] + [
        t.clone().requires_grad_(True) for t in (scale, noise) if t is not None]
    extra = dict(zip([n for n, t in (("scale", scale), ("noise", noise)) if t is not None],
                     leaves[2:]))
    outs = [torch.autograd.grad(fn(leaves[0], leaves[1], act=act, clamp=clamp, axis=axis,
                                   **extra), leaves, dy)
            for fn in (ba.bias_act, ba.bias_act_plain)]
    for a, b_ in zip(*outs):
        _rel_close(a, b_, tol if dtype == torch.float32 else 3e-2, "Function")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(5, 3, 8, 8), (3, 2, 13, 11), (2, 17, 4, 4), (3, 4, 1, 1)],
                         ids=["aligned_rows_span_samples", "ragged", "wide", "flat"])
def test_k6b_noise_per_sample(dev, dtype, shape):
    """A [B,H,W] noise plane read by the batch stride: CTAs whose rows span
    several samples (C below the rows a CTA takes), rows that are not whole
    vectors, H = W = 1; the forward against the plain version (fp32 1e-6
    absolute, bf16 within 2 ulps: the same roundings in the same order), the
    gradient's dnoise [B,H,W] summed over the channels (1e-5 of scale: fp32
    sums in another order) and the Function against autograd of the plain
    forward."""
    g = torch.Generator(device=dev).manual_seed(26)
    bsz, c, h, w = shape
    x = (2 * torch.randn(shape, device=dev, generator=g)).to(dtype)
    b = 0.3 * torch.randn((c,), device=dev, generator=g)
    scale = torch.rand((bsz, c), device=dev, generator=g) + 0.5
    noise = torch.randn((bsz, h, w), device=dev, generator=g)
    kw = dict(act="lrelu", gain=2 ** 0.5, clamp=2.5, axis=1, scale=scale)
    before = ba.bias_act.launches
    got = ba.bias_act(x, b, noise=noise, **kw)
    want = ba.bias_act_plain(x, b, noise=noise, **kw)
    torch.cuda.synchronize()
    assert ba.bias_act.launches == before + 1
    if dtype == torch.float32:
        _close(got, want, 1e-6, "forward")
    else:
        assert _bf16_ulps(got, want) <= 2
    shared = ba.bias_act(x, b, noise=noise[0], **kw)       # the [H,W] form is unchanged
    _close(shared.float(), ba.bias_act_plain(x, b, noise=noise[0], **kw).float(), 1e-6,
           "shared plane")
    if h * w == 1:
        return                  # the gradient kernel takes no noise at H = W = 1
    dy = torch.randn(shape, device=dev, generator=g).to(dtype)
    flags = dict(need_b=True, need_scale=True, need_noise=True, noise_per_sample=True)
    k = ba.bias_act_grad(dy, got, x, **kw, **flags)
    p = ba.bias_act_grad_plain(dy, got, x, **kw, **flags)
    torch.cuda.synchronize()
    assert k[3].shape == (bsz, h, w)
    for a, b_, name in zip(k, p, ("dx", "db", "dscale", "dnoise")):
        _rel_close(a, b_, 1e-5 if dtype == torch.float32 else 1e-2, name)
    # through the Function at the layers' clamp (256: no bf16 value ties
    # with the bound, where autograd's clamp passes the gradient and the
    # kernel, as the JAX package's epilogue, zeroes it)
    leaves = [t.clone().requires_grad_(True) for t in (x, b, scale, noise)]
    outs = [torch.autograd.grad(fn(leaves[0], leaves[1], act="lrelu", gain=2 ** 0.5,
                                   clamp=256.0, axis=1, scale=leaves[2], noise=leaves[3]),
                                leaves, dy)
            for fn in (ba.bias_act, ba.bias_act_plain)]
    assert outs[0][3].shape == noise.shape
    for a, b_ in zip(*outs):
        _rel_close(a, b_, 1e-5 if dtype == torch.float32 else 3e-2, "Function")


# -- the torso stage's backward kernels ------------------------------------------


def test_k1_triplane_backward_points_outside(dev):
    _k1_triplane_backward_case(dev, 2, (17, 23), 777)


# a part of a round of 8 tiles (B = 3, 37 points), and several rounds a CTA
# with a ragged last tile
@pytest.mark.parametrize("b,hw,n", [(3, (5, 4), 37), (1, (64, 64), 2 * 132 * 128 + 9)],
                         ids=["b3_part_round", "rounds_and_a_tail"])
def test_k1_triplane_backward_edge_shapes(dev, b, hw, n):
    _k1_triplane_backward_case(dev, b, hw, n)


def _k1_triplane_backward_case(dev, b, hw, n):
    g = torch.Generator(device=dev).manual_seed(30)
    planes = torch.randn((b, 3, *hw, 32), device=dev, generator=g)
    coords = torch.rand((b, n, 3), device=dev, generator=g) * 1.4 - 0.7
    dec = OSGDecoder(32, 64, 32).to(dev)
    with torch.no_grad():
        for p in dec.parameters():
            p.copy_(0.3 * torch.randn(p.shape, device=dev, generator=g))
    ws = [t.detach() for t in (*dec.net0.folded(), *dec.net1.folded())]
    drgb = torch.randn((b, n, 32), device=dev, generator=g)
    dsig = torch.randn((b, n, 1), device=dev, generator=g)
    for grads in ((drgb, dsig), (None, dsig), (drgb, None)):
        with torch.no_grad():
            k = triplane_decode_backward(planes, coords, 1.0, *ws, *grads)
            p = decode_backward_plain(planes, coords, 1.0, *ws, *grads)
        for a, b_, name in zip(k, p, ("dplanes", "dw0", "db0", "dw1", "db1")):
            _rel_close(a, b_, 1e-4, name)
    leaves = [planes.clone().requires_grad_(True)]
    outs = []
    for fn in (triplane_decode, triplane_decode_plain):
        dec.zero_grad()
        rgb, sigma = fn(leaves[0], coords, 1.0, dec)
        gp = torch.autograd.grad((rgb, sigma), leaves + list(dec.parameters()), (drgb, dsig))
        outs.append(gp)
    for a, b_ in zip(*outs):
        _rel_close(a, b_, 1e-4, "K1 Function")


@pytest.mark.parametrize("b,ci,co,dhw,k", [(2, 13, 40, (3, 9, 6), 3), (1, 5, 5, (2, 7, 9), 7),
                                           (2, 37, 6, (4, 5, 4), 7), (1, 70, 70, (16, 4, 4), 3),
                                           (2, 37, 5, (2, 6, 8), 7), (2, 33, 33, (3, 5, 130), 3),
                                           (1, 89, 32, (4, 8, 16), 7), (2, 32, 64, (2, 4, 4), 3)])
def test_k7a_weight_and_data_grad(dev, b, ci, co, dhw, k):
    g = torch.Generator(device=dev).manual_seed(31)
    x = torch.randn((b, ci, *dhw), device=dev, generator=g)
    w = torch.randn((co, ci, k, k, k), device=dev, generator=g) / (ci * k ** 3) ** 0.5
    bias = torch.randn((co,), device=dev, generator=g)
    dy = torch.randn((b, co, *dhw), device=dev, generator=g)
    with torch.no_grad():
        kw, kb = c3d.conv3d_weight_grad(x, dy, k)
        pw, pb = c3d.conv3d_weight_grad_plain(x, dy, k)
        dx = c3d.conv3d_data_grad(dy, w)
    _rel_close(kw, pw, 1e-4, "d weight")
    _rel_close(kb, pb, 1e-5, "d bias")
    _rel_close(dx, torch.nn.grad.conv3d_input(x.shape, w, dy, padding=k // 2), 1e-4, "d x")
    leaves = [t.clone().requires_grad_(True) for t in (x, w, bias)]
    outs = [torch.autograd.grad(fn(*leaves), leaves, dy) for fn in (c3d.conv3d, c3d.conv3d_plain)]
    for a, b_, name in zip(*outs, ("x", "weight", "bias")):
        _rel_close(a, b_, 1e-4, f"Function d {name}")


@pytest.mark.parametrize("dhw,reach", [((16, 64, 64), 0.8), ((3, 7, 9), 1.3)])
def test_k5a_adjoint(dev, dhw, reach):
    g = torch.Generator(device=dev).manual_seed(32)
    b, k = 2, 4
    fs = torch.randn((b, *dhw, 4), device=dev, generator=g)
    kp_s = (torch.rand((b, k, 3), device=dev, generator=g) * 2 - 1) * reach
    kp_d = (torch.rand((b, k, 3), device=dev, generator=g) * 2 - 1) * reach
    dout = torch.randn((b, (k + 1) * 5, *dhw), device=dev, generator=g)
    with torch.no_grad():
        got = torso.torso_deform_input_backward(dout, kp_s, kp_d, tuple(fs.shape))
        want = torso.torso_deform_input_backward_plain(dout, kp_s, kp_d, tuple(fs.shape))
    _rel_close(got, want, 1e-5, "d fs")
    leaf = fs.clone().requires_grad_(True)
    outs = [torch.autograd.grad(fn(leaf, kp_s, kp_d), leaf, dout)[0]
            for fn in (torso.torso_deform_input, torso.torso_deform_input_plain)]
    _rel_close(outs[0], outs[1], 1e-5, "Function d fs")
    with pytest.raises(ValueError):
        torso.torso_deform_input(leaf, kp_s.clone().requires_grad_(True), kp_d)


@pytest.mark.parametrize("c,dhw,spread", [(32, (16, 64, 64), 0.05), (4, (3, 7, 9), 1.3),
                                          (32, (2, 5, 6), 1.3)])
def test_k5b_adjoint(dev, c, dhw, spread):
    g = torch.Generator(device=dev).manual_seed(33)
    fs = torch.randn((2, *dhw, c), device=dev, generator=g)
    base = torso.make_coordinate_grid_3d(*dhw, dev)[None].expand(2, -1, -1, -1, -1)
    deform = (base + spread * torch.randn((2, *dhw, 3), device=dev, generator=g)).contiguous()
    dout = torch.randn((2, c * dhw[0], *dhw[1:]), device=dev, generator=g)
    with torch.no_grad():
        got = torso.torso_warp_volume_backward(fs, deform, dout)
        want = torso.torso_warp_volume_backward_plain(fs, deform, dout)
    _rel_close(got[0], want[0], 1e-5, "d fs")
    _rel_close(got[1], want[1], 1e-5, "d deformation")
    leaves = [fs.clone().requires_grad_(True), deform.clone().requires_grad_(True)]
    outs = [torch.autograd.grad(fn(*leaves), leaves, dout)
            for fn in (torso.torso_warp_volume, torso.torso_warp_volume_plain)]
    for a, b_ in zip(*outs):
        _rel_close(a, b_, 1e-5, "Function")


@pytest.mark.parametrize("b,c,d,hw", [(2, 32, 16, (64, 64)), (2, 5, 2, (9, 13)),
                                     (1, 4, 2, (6, 256)), (1, 37, 2, (7, 70)),
                                     (2, 12, 16, (5, 100))],
                         ids=["standard", "tiny", "w256", "two_channel_blocks",
                              "c_not_8_ragged"])
def test_k7b_backward(dev, b, c, d, hw):
    # the standard and tiny presets' depths, W = 256 (the wrapper's limit),
    # W across the data gradient's 64-column tile, C across its 32-channel
    # block and no multiple of 8, ragged 4-row tiles; through the Function,
    # then the kernels with each occlusion gradient missing; 1e-4 of scale
    g = torch.Generator(device=dev).manual_seed(34)
    h, w = hw
    x = torch.randn((b, c, d, h, w), device=dev, generator=g)
    mw = 0.05 * torch.randn((5, c, 7, 7, 7), device=dev, generator=g)
    mb = 0.1 * torch.randn((5,), device=dev, generator=g)
    ow = 0.05 * torch.randn((2, c * d, 7, 7), device=dev, generator=g)
    ob = 0.1 * torch.randn((2,), device=dev, generator=g)
    kp_s = torch.rand((b, 4, 3), device=dev, generator=g) * 1.6 - 0.8
    kp_d = torch.rand((b, 4, 3), device=dev, generator=g) * 1.6 - 0.8
    leaves = [t.clone().requires_grad_(True) for t in (x, mw, mb, ow, ob)]
    ddef = torch.randn((b, d, h, w, 3), device=dev, generator=g)
    docc = [torch.randn((b, h, w, 1), device=dev, generator=g) for _ in range(2)]
    outs = [torch.autograd.grad(fn(*leaves, kp_s, kp_d), leaves, (ddef, *docc))
            for fn in (torso.mfe_tail, torso.mfe_tail_plain)]
    for a, b_, name in zip(*outs, ("x", "mask_w", "mask_b", "occ_w", "occ_b")):
        _rel_close(a, b_, 1e-4, f"d {name}")
    with torch.no_grad():
        _, occ1, occ2 = torso.mfe_tail_plain(x, mw, mb, ow, ob, kp_s, kp_d)
        mask = torch.softmax(torch.nn.functional.conv3d(x, mw, mb, padding=3), dim=1)
        for gr in ((ddef, None, docc[1]), (ddef, docc[0], None), (ddef, None, None)):
            args = (x, mw, ow, kp_s, kp_d, mask, occ1, occ2, *gr)
            k = torso.mfe_tail_backward(*args)
            p = torso.mfe_tail_backward_plain(*args)
            torch.cuda.synchronize()
            for a, b_, name in zip(k, p, ("x", "mask_w", "mask_b", "occ_w", "occ_b")):
                assert torch.isfinite(a).all(), name
                if name in ("occ_w", "occ_b") and gr[1] is None and gr[2] is None:
                    assert float(a.abs().max()) == 0.0, name
                else:
                    _rel_close(a, b_, 1e-4, f"d {name}")


def test_tiny_torso_model_grads_on_the_card(dev):
    """The whole tiny torso model (every kernel forward and backward, no
    plain version) against the CPU's plain versions: gradients within 1e-3
    of the largest of all (fp32 sums in other orders through ~30 layers)."""
    from real3dportrait_tpu_torch.weights import mock_init_

    models = [mock_init_(torso.WarpBasedTorsoModel(scale="tiny"),
                         torch.Generator().manual_seed(0)) for _ in range(2)]
    g = torch.Generator().manual_seed(35)
    seg = torch.zeros((1, 64, 64, 6))
    seg[..., 4] = 1
    inp = [torch.rand((1, 32, 32, 3), generator=g) * 2 - 1, seg,
           torch.rand((1, 68, 3), generator=g) * 1.6 - 0.8,
           torch.rand((1, 68, 3), generator=g) * 1.6 - 0.8,
           torch.rand((1, 8, 8, 3), generator=g), torch.rand((1, 8, 8, 1), generator=g)]
    grads = []
    for m, d in zip(models, (dev, torch.device("cpu"))):
        m.to(d)
        out = m(*[t.to(d) for t in inp])
        loss = out["deformed_torso_img"].square().mean() + out["occlusion_2"].mean() + sum(
            out["losses"].values())
        loss.backward()
        grads.append({n: p.grad.detach().cpu() for n, p in m.named_parameters()})
    top = max(float(v.abs().max()) for v in grads[1].values())
    for n, v in grads[1].items():
        err = float((grads[0][n] - v).abs().max())
        assert err <= 1e-3 * top, f"{n}: {err} of {top}"

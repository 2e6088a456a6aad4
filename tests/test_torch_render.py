"""Parity of the port's renderer with the JAX package: kernels K1-K3 through
their plain versions (what the wrappers run on CPU tensors), the ray
sampling, and the whole two-pass render."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real3dportrait_tpu.models.decoder import OSGDecoder as JaxOSGDecoder
from real3dportrait_tpu.ops.grid_sample import grid_sample_2d as jax_grid_sample_2d
from real3dportrait_tpu.rendering import math_utils as jmath
from real3dportrait_tpu.rendering.ray_marcher import march_weights as jax_march_weights
from real3dportrait_tpu.rendering.ray_sampler import sample_rays as jax_sample_rays
from real3dportrait_tpu.rendering.renderer import (
    RenderOptions as JaxRenderOptions,
    _march_merged,
    render_rays as jax_render_rays,
    sample_from_planes as jax_sample_from_planes,
    sample_importance as jax_sample_importance,
)
from real3dportrait_tpu_torch.geometry.camera import (
    fov_to_intrinsics,
    lookat_pose,
    pack_camera,
    unpack_camera,
)
from real3dportrait_tpu_torch.models.decoder import (
    OSGDecoder,
    triplane_decode,
    triplane_decode_plain,
)
from real3dportrait_tpu_torch.ops.grid_sample import grid_sample_2d
from real3dportrait_tpu_torch.rendering import math_utils
from real3dportrait_tpu_torch.rendering.ray_sampler import sample_rays
from real3dportrait_tpu_torch.rendering.renderer import (
    RenderOptions,
    importance_sample,
    importance_u,
    merge_composite,
    render_rays,
)
from tests._torch_parity import agree, load_from_jax, t, to_np

torch.set_num_threads(1)


def _decoder_pair(c=32, seed=0):
    jdec = JaxOSGDecoder(hidden_dim=64, output_dim=32)
    feats = jnp.zeros((1, 3, 4, c))
    variables = jdec.init(jax.random.PRNGKey(seed), feats)
    return jdec, variables, load_from_jax(OSGDecoder(c, 64, 32), variables)


def _camera(b, yaw=0.0):
    c2w = lookat_pose(torch.full((b,), yaw), torch.zeros(b), torch.tensor([[0.0, 0.0, 0.2]] * b))
    return pack_camera(c2w, fov_to_intrinsics())


def test_grid_sample_2d_matches_jax():
    # fp32 bilinear weights: the two only differ in rounding of the
    # unnormalised coordinate, ~1e-6 of the feature scale
    rng = np.random.RandomState(0)
    feats = rng.randn(2, 7, 9, 5).astype(np.float32)
    coords = rng.uniform(-1.2, 1.2, (2, 50, 2)).astype(np.float32)
    agree(grid_sample_2d(t(feats), t(coords)), jax_grid_sample_2d(feats, coords),
          1e-5, 1e-6, "grid_sample_2d")


def test_k1_plain_matches_sample_and_decoder():
    # K1 plain = sample_from_planes + OSGDecoder; fp32 matmuls in both, so
    # errors stay at float rounding (1e-5 of scale max, 1e-6 mean)
    rng = np.random.RandomState(1)
    planes = rng.randn(2, 3, 16, 12, 32).astype(np.float32)
    coords = rng.uniform(-0.6, 0.6, (2, 300, 3)).astype(np.float32)
    jdec, variables, dec = _decoder_pair()
    want = jdec.apply(variables, jax_sample_from_planes(planes, coords, 1.0))
    rgb, sigma = triplane_decode_plain(t(planes), t(coords), 1.0, dec)
    agree(rgb, want["rgb"], 1e-5, 1e-6, "K1 rgb")
    agree(sigma, want["sigma"], 1e-5, 1e-6, "K1 sigma")
    # the wrapper takes the plain version for CPU tensors
    rgb_w, sigma_w = triplane_decode(t(planes), t(coords), 1.0, dec)
    assert torch.equal(rgb_w, rgb) and torch.equal(sigma_w, sigma)


def _coarse(rng, r, s):
    start = rng.uniform(1.8, 2.2, (1, r, 1)).astype(np.float32)
    end = start + rng.uniform(0.5, 1.0, (1, r, 1)).astype(np.float32)
    steps = (np.arange(s, dtype=np.float32) + 0.5) / s
    depths = (start[:, :, None, :] + steps[None, None, :, None] * (end - start)[:, :, None, :])
    sigma = (rng.randn(1, r, s, 1) * 3).astype(np.float32)
    return depths.astype(np.float32), sigma


@pytest.mark.parametrize("s_coarse,n_fine", [(16, 32), (48, 48)])
def test_k2_plain_matches_march_and_importance(s_coarse, n_fine):
    # fine depths come from an inverse CDF whose cumsum order differs
    # (torch.cumprod/cumsum vs the JAX log-space matmul): 1e-5 of the depth
    # scale max, 1e-6 mean
    rng = np.random.RandomState(2)
    depths, sigma = _coarse(rng, 200, s_coarse)
    w, _, _ = jax_march_weights(jnp.asarray(sigma), jnp.asarray(depths))
    want = jax_sample_importance(jnp.asarray(depths), w, n_fine, None)
    u = importance_u(200, n_fine, torch.device("cpu"))
    got = importance_sample(t(depths), t(sigma), u)
    agree(got, want, 1e-5, 1e-6, "K2 fine depths")
    assert np.all(np.diff(to_np(got)[..., 0], axis=-1) >= 0), "fine depths must be sorted"


def _merge_inputs(rng, r, s1, s2, c):
    d1, s1d = _coarse(rng, r, s1)
    d2 = np.sort(rng.uniform(1.8, 3.2, (1, r, s2, 1)).astype(np.float32), axis=2)
    c1 = rng.uniform(0, 1, (1, r, s1, c)).astype(np.float32)
    c2 = rng.uniform(0, 1, (1, r, s2, c)).astype(np.float32)
    s2d = (rng.randn(1, r, s2, 1) * 3).astype(np.float32)
    return d1, c1, s1d, d2, c2, s2d


@pytest.mark.parametrize("s1,s2", [(16, 32), (48, 48)])
def test_k3_plain_matches_march_merged(s1, s2):
    # composite sums run in another order (sorted gather vs one-hot
    # permutation einsum): 2e-5 of scale max, 1e-6 mean
    rng = np.random.RandomState(3)
    args = _merge_inputs(rng, 150, s1, s2, 32)
    want_rgb, want_depth, want_w = _march_merged(*map(jnp.asarray, args))
    rgb, depth, weights = merge_composite(*map(t, args))
    # JAX clips the depth to the batch range inside; the port does it after
    lo = min(args[0].min(), args[3].min())
    hi = max(args[0].max(), args[3].max())
    depth = torch.clamp(torch.nan_to_num(depth, nan=float("inf")), lo, hi)
    agree(rgb, want_rgb, 2e-5, 1e-6, "K3 rgb")
    agree(depth, want_depth, 2e-5, 1e-6, "K3 depth")
    agree(weights, want_w, 2e-5, 1e-6, "K3 weights")


def test_k3_plain_tie_order():
    # equal coarse and fine depths: the coarse sample goes first, so the
    # merged densities (1 for coarse, 0 for fine) give the JAX weights
    d1 = np.array([[[[1.0], [2.0], [3.0]]]], np.float32)
    d2 = np.array([[[[2.0], [4.0]]]], np.float32)
    c1 = np.ones((1, 1, 3, 2), np.float32)
    c2 = np.zeros((1, 1, 2, 2), np.float32)
    s1 = np.full((1, 1, 3, 1), 4.0, np.float32)
    s2 = np.zeros((1, 1, 2, 1), np.float32)
    want_rgb, _, want_w = _march_merged(*map(jnp.asarray, (d1, c1, s1, d2, c2, s2)))
    rgb, _, weights = merge_composite(*map(t, (d1, c1, s1, d2, c2, s2)))
    np.testing.assert_allclose(to_np(weights), np.asarray(want_w), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(to_np(rgb), np.asarray(want_rgb), rtol=1e-6, atol=1e-7)
    # the opposite tie order (fine first) gives other weights, so the check
    # above has teeth
    _, _, swapped = merge_composite(*map(t, (d2, c2, s2, d1, c1, s1)))
    assert not torch.allclose(swapped, weights)


def _tie_inputs(rng, r, s1, s2, c):
    """Sorted coarse depths drawn from a grid of s1 // 2 values (each list
    repeats depths) and fine depths drawn from the ray's own coarse depths
    (every fine depth ties a coarse one)."""
    grid = 2.0 + np.arange(max(s1 // 2, 2), dtype=np.float32) / 16
    d1 = np.sort(rng.choice(grid, (1, r, s1)), axis=-1).astype(np.float32)[..., None]
    pick = rng.randint(0, s1, (1, r, s2))
    d2 = np.sort(np.take_along_axis(d1[..., 0], pick, axis=-1), axis=-1)[..., None]
    c1 = rng.uniform(0, 1, (1, r, s1, c)).astype(np.float32)
    c2 = rng.uniform(0, 1, (1, r, s2, c)).astype(np.float32)
    sg1 = (rng.randn(1, r, s1, 1) * 3).astype(np.float32)
    sg2 = (rng.randn(1, r, s2, 1) * 3).astype(np.float32)
    return d1, c1, sg1, d2.astype(np.float32), c2, sg2


@pytest.mark.parametrize("s1,s2", [(16, 32), (48, 48)])
def test_k3_plain_matches_march_merged_with_ties_everywhere(s1, s2):
    # every fine depth ties a coarse one and each list repeats depths: the
    # tie rule (a coarse sample before an equal fine one, in list order)
    # decides which density lands where. The merge is exact in both (a
    # permutation), so only the march's and the composite's sums differ
    # (torch.cumprod against JAX's log-space matmul, a sorted gather
    # against a one-hot einsum): 1e-6 of scale max, 2e-7 mean
    rng = np.random.RandomState(5)
    args = _tie_inputs(rng, 120, s1, s2, 32)
    assert all((np.diff(a[..., 0], axis=-1) == 0).any(axis=-1).all() for a in (args[0], args[3]))
    want_rgb, want_depth, want_w = _march_merged(*map(jnp.asarray, args))
    rgb, depth, weights = merge_composite(*map(t, args))
    lo = min(args[0].min(), args[3].min())
    hi = max(args[0].max(), args[3].max())
    depth = torch.clamp(torch.nan_to_num(depth, nan=float("inf")), lo, hi)
    agree(weights, want_w, 1e-6, 2e-7, "K3 weights, ties")
    agree(depth, want_depth, 1e-6, 2e-7, "K3 depth, ties")
    agree(rgb, want_rgb, 1e-6, 2e-7, "K3 rgb, ties")
    # the other tie order (fine first) changes the weights, so the checks
    # above have teeth
    _, _, swapped = merge_composite(*map(t, args[3:] + args[:3]))
    assert float((swapped - weights).abs().max()) > 1e-2


def _rank_merge(d1: np.ndarray, d2: np.ndarray) -> np.ndarray:
    """K3's merge as csrc/render_march.cu computes it, per ray [S1], [S2] ->
    the merged position of each sample of the concatenation: the running
    maximum of each list as its key, then pos1 = i + #(key2 < key1[i]) and
    pos2 = j + #(key1 <= key2[j]), counted by a binary search of 7 steps."""
    k1, k2 = np.maximum.accumulate(d1), np.maximum.accumulate(d2)

    def count_below(a, x, inclusive):
        lo = 0
        for step in (64, 32, 16, 8, 4, 2, 1):
            k = lo + step
            if k <= len(a) and (a[k - 1] <= x if inclusive else a[k - 1] < x):
                lo = k
        return lo

    pos1 = [i + count_below(k2, k1[i], False) for i in range(len(d1))]
    pos2 = [j + count_below(k1, k2[j], True) for j in range(len(d2))]
    return np.array(pos1 + pos2)


@pytest.mark.parametrize("s1,s2", [(16, 32), (48, 48), (100, 28)])
def test_k3_rank_merge_is_the_stable_merge(s1, s2):
    # the kernel's ranks are a permutation equal to the stable sort of the
    # concatenation (the plain version's order) on sorted lists with ties,
    # and still a permutation when a list is out of order by an ulp
    rng = np.random.RandomState(6)
    d1, _, _, d2, _, _ = _tie_inputs(rng, 40, s1, s2, 1)
    for r in range(d1.shape[1]):
        a, b = d1[0, r, :, 0], d2[0, r, :, 0]
        pos = _rank_merge(a, b)
        order = np.argsort(np.concatenate([a, b]), kind="stable")
        np.testing.assert_array_equal(np.argsort(pos), order)
        b = b.copy()
        k = 1 + r % (s2 - 1)
        b[k] = np.nextafter(b[k - 1], np.float32(0))  # one step down, an ulp
        pos = _rank_merge(a, b)
        assert sorted(pos) == list(range(s1 + s2))


def test_ray_sampling_matches_jax():
    # same fp32 ops in the same order: 1e-6 of scale
    cam = _camera(2, yaw=0.3)
    c2w, intr = unpack_camera(cam)
    o, d = sample_rays(c2w, intr, 8)
    jo, jd = jax_sample_rays(jnp.asarray(to_np(c2w)), jnp.asarray(to_np(intr)), 8)
    agree(o, jo, 1e-6, 1e-7, "origins")
    agree(d, jd, 1e-6, 1e-7, "dirs")
    lo, hi, valid = math_utils.get_ray_limits_box(o, d, 1.0)
    jlo, jhi, jvalid = jmath.get_ray_limits_box(jo, jd, 1.0)
    np.testing.assert_array_equal(to_np(valid), np.asarray(jvalid))
    agree(lo, jlo, 1e-6, 1e-7, "t_min")
    agree(hi, jhi, 1e-6, 1e-7, "t_max")


@pytest.mark.parametrize("s_coarse,n_fine", [(16, 32), (48, 48)])
def test_render_rays_matches_jax(s_coarse, n_fine):
    # whole deterministic two-pass render on 100 rays (10x10) with 32-ch
    # planes; error compounds through the fine resampling: 1e-4 of scale
    # max, 1e-5 mean
    rng = np.random.RandomState(4)
    planes = (rng.randn(1, 3, 16, 16, 32) * 0.5).astype(np.float32)
    cam = _camera(1, yaw=0.2)
    c2w, intr = unpack_camera(cam)
    o, d = sample_rays(c2w, intr, 10)
    jdec, variables, dec = _decoder_pair(seed=5)
    opts = dict(depth_resolution=s_coarse, depth_resolution_importance=n_fine)
    want = jax.jit(lambda p, ro, rd: jax_render_rays(
        p, lambda f, _d: jdec.apply(variables, f), ro, rd, JaxRenderOptions(**opts),
        key=None))(jnp.asarray(planes), jnp.asarray(to_np(o)), jnp.asarray(to_np(d)))
    got = render_rays(t(planes), dec, o, d, RenderOptions(**opts))
    for k in ("rgb", "depth", "weights_sum"):
        agree(got[k], want[k], 1e-4, 1e-5, f"render_rays {k}")
    np.testing.assert_array_equal(to_np(got["is_ray_valid"]), np.asarray(want["is_ray_valid"]))


def test_kernel_wrappers_reject_non_cpu_non_cuda_tensors():
    # a wrapper runs the plain version only for CPU tensors; anything else
    # must launch the kernel or raise, never fall back
    meta = torch.zeros((1, 4, 2, 1), device="meta")
    with pytest.raises(ValueError):
        importance_sample(meta, meta, torch.zeros((4, 3), device="meta"))
    with pytest.raises(ValueError):
        merge_composite(meta, torch.zeros((1, 4, 2, 3), device="meta"), meta,
                        meta, torch.zeros((1, 4, 2, 3), device="meta"), meta)
    _, _, dec = _decoder_pair()
    with pytest.raises(ValueError):
        triplane_decode(torch.zeros((1, 3, 4, 4, 32), device="meta"),
                        torch.zeros((1, 5, 3), device="meta"), 1.0, dec)

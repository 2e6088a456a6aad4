"""Kernels K7a (``ops/conv3d.py``) and K7b (``models/torso.py:mfe_tail``)
on the CPU, where their wrappers run the plain versions: K7a's plain path
against the JAX package's ``conv3d_via_2d`` and its ``Conv3D`` module (the
weights carried across by the bridge), K7b's plain path against the JAX
fused tail (``folded_banded_kernel``, one depth-folded conv), the kernels'
launch plans, and the torso model's 3D convs all going through K7a."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real3dportrait_tpu.models import torso as jt
from real3dportrait_tpu.ops import conv3d as jconv
from real3dportrait_tpu_torch.models import torso
from real3dportrait_tpu_torch.ops import conv3d as c3d
from tests._torch_parity import agree, jax_run, load_from_jax, t

torch.set_num_threads(1)


def _ncdhw(x: np.ndarray) -> torch.Tensor:
    return t(x).permute(0, 4, 1, 2, 3)


@pytest.mark.parametrize("k,b,dhw,ci,co", [(3, 2, (3, 7, 9), 5, 6), (7, 1, (4, 9, 8), 3, 4),
                                           (3, 1, (16, 4, 4), 12, 10)],
                         ids=["k3", "k7", "k3_deep"])
def test_k7a_plain_matches_conv3d_via_2d(k, b, dhw, ci, co):
    # zero "same" padding on every face; the kd taps summed in another
    # order than the JAX decomposition: 1e-5 of scale max, 1e-6 mean
    rng = np.random.RandomState(k)
    x = rng.randn(b, *dhw, ci).astype(np.float32)
    kernel = (rng.randn(k, k, k, ci, co) / np.sqrt(ci * k ** 3)).astype(np.float32)
    bias = rng.randn(co).astype(np.float32)
    want = jconv.conv3d_via_2d(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias))
    weight = t(kernel).permute(4, 3, 0, 1, 2)
    before = c3d.conv3d.launches
    got = c3d.conv3d(_ncdhw(x), weight, t(bias))
    assert c3d.conv3d.launches == before  # CPU tensors take the plain version
    assert torch.equal(got, c3d.conv3d_plain(_ncdhw(x), weight, t(bias)))
    agree(got.permute(0, 2, 3, 4, 1), want, 1e-5, 1e-6, f"K7a k{k}")


@pytest.mark.parametrize("k", [3, 7])
def test_k7a_module_matches_jax_conv3d(k):
    # the port's Conv3D carries the JAX Conv3D's kernel through the bridge
    x = np.random.RandomState(10 + k).randn(1, 4, 6, 5, 3).astype(np.float32)
    variables, want = jax_run(jconv.Conv3D(8, (k, k, k)), x, seed=k)
    module = load_from_jax(c3d.Conv3D(3, 8, k), variables)
    with torch.no_grad():
        got = module(_ncdhw(x))
    agree(got.permute(0, 2, 3, 4, 1), want, 1e-5, 1e-6, f"Conv3D k{k}")
    with pytest.raises(ValueError):
        c3d.Conv3D(3, 8, k, padding=0)


@jax.jit
def _jax_fused_tail(x, mask_k, mask_b, occ_k1, occ_b1, occ_k2, occ_b2, kp_s, kp_d):
    """The JAX motion-field estimator's default ``fused`` tail
    (``models/torso.py`` lines 439-482) on x [B,D,H,W,C]."""
    b, d, h, w, _ = x.shape
    k1 = mask_k.shape[-1]
    x2d = jnp.transpose(x, (0, 2, 3, 4, 1)).reshape(b, h, w, -1)
    kk = jnp.concatenate([jconv.folded_banded_kernel(mask_k, d), occ_k1, occ_k2], axis=-1)
    y = jax.lax.conv_general_dilated(x2d, kk, (1, 1), [(3, 3), (3, 3)],
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"))
    n_m = k1 * d
    mask = jnp.transpose(y[..., :n_m].reshape(b, h, w, k1, d), (0, 4, 1, 2, 3)) + mask_b
    fused = y[..., n_m:] + jnp.concatenate([occ_b1, occ_b2])
    mask = jnp.moveaxis(jax.nn.softmax(mask, axis=-1), -1, 1)[..., None]
    deformation = jnp.sum(jt.create_sparse_motions(kp_s, kp_d, d, h, w) * mask, axis=1)
    return deformation, jax.nn.sigmoid(fused[..., :1]), jax.nn.sigmoid(fused[..., 1:2])


@pytest.mark.parametrize("b,c,d,hw", [(1, 6, 4, (9, 11)), (2, 3, 2, (8, 8))],
                         ids=["d4_odd", "b2_d2"])
def test_k7b_plain_matches_jax_fused_tail(b, c, d, hw):
    # the same taps as one depth-folded conv in JAX: 1e-5 of scale max,
    # 1e-6 mean on the deformation and both occlusion maps
    rng = np.random.RandomState(20 + d)
    h, w = hw
    x = rng.randn(b, d, h, w, c).astype(np.float32)
    mask_k = (rng.randn(7, 7, 7, c, 5) / np.sqrt(c * 343)).astype(np.float32)
    mask_b = (0.1 * rng.randn(5)).astype(np.float32)
    occ = [(rng.randn(7, 7, c * d, 1) / np.sqrt(c * d * 49)).astype(np.float32)
           for _ in range(2)]
    occ_b = (0.1 * rng.randn(2)).astype(np.float32)
    kp_s, kp_d = (rng.uniform(-0.8, 0.8, (b, 4, 3)).astype(np.float32) for _ in range(2))
    want = _jax_fused_tail(x, mask_k, mask_b, occ[0], occ_b[:1], occ[1], occ_b[1:],
                           kp_s, kp_d)
    occ_w = torch.cat([t(o).permute(3, 2, 0, 1) for o in occ])
    args = (_ncdhw(x), t(mask_k).permute(4, 3, 0, 1, 2), t(mask_b), occ_w, t(occ_b),
            t(kp_s), t(kp_d))
    before = torso.mfe_tail.launches
    got = torso.mfe_tail(*args)
    assert torso.mfe_tail.launches == before
    for g, w_, what in zip(got, want, ("deformation", "occlusion", "occlusion_2")):
        agree(g, w_, 1e-5, 1e-6, f"K7b {what}")


# the tiles csrc/conv3d.cu is compiled for (c3d.kernel_tiles() reads them
# from the built library on a card) and an H100 SXM's 132 SMs
TILES = dict(pixel_groups=64, co_block=32, ci_chunk={3: 8, 7: 4}, tail_tile=(8, 32))


@pytest.mark.parametrize("b,ci,co,dhw,k", [
    (1, 89, 32, (16, 64, 64), 7), (1, 25, 64, (16, 64, 64), 3), (1, 512, 1024, (16, 4, 4), 3),
    (1, 1024, 512, (16, 4, 4), 3), (2, 5, 7, (3, 9, 11), 3), (1, 6, 33, (5, 13, 70), 7),
    (1, 37, 70, (16, 4, 4), 3)])
def test_k7_launch_plans_cover_every_voxel_and_channel(b, ci, co, dhw, k):
    d, h, w = dhw
    plan = c3d.conv3d_plan(b, ci, co, d, h, w, k, TILES, 132)
    td, th, g = plan["TD"], plan["TH"], plan["G"]
    assert td * th * g <= TILES["pixel_groups"] and min(td, th, g) >= 1
    assert td <= d and th <= h and (4 * g >= w or g == 16)
    per, n = plan["ci_per_split"], plan["n_split"]
    assert per % TILES["ci_chunk"][k] == 0 and (n - 1) * per < ci <= n * per
    tail = torso.mfe_tail_plan(b, ci, h, w, TILES["tail_tile"], 132)
    assert (tail["n_split"] - 1) * tail["c_per_split"] < ci <= tail["n_split"] * tail[
        "c_per_split"]


@pytest.mark.parametrize("ci,co,dhw,k", [(3, 2, (16, 64, 64), 7), (2, 5, (16, 4, 4), 3),
                                         (1, 1, (1, 5, 2), 7), (2, 3, (3, 9, 11), 3)])
def test_conv3d_ops_count_only_taps_inside_the_volume(ci, co, dhw, k):
    # a conv of ones with ones sums, at each output voxel, the taps that
    # fall inside the volume: twice that, over every voxel and channel pair
    ones = torch.ones((1, ci, *dhw), dtype=torch.float64)
    inside = c3d.conv3d_plain(ones, torch.ones((co, ci, k, k, k), dtype=torch.float64))
    assert c3d.conv3d_ops(ci, co, *dhw, k) == 2 * int(inside.sum())
    assert c3d.conv3d_ops(ci, co, *dhw, k, b=3) == 3 * c3d.conv3d_ops(ci, co, *dhw, k)


def test_torso_3d_convs_are_k7a():
    # every 3D conv of the standard torso model is K7a's Conv3D but the
    # estimator's 1x1x1 compress conv, which runs as a channels-last matmul
    with torch.device("meta"):
        model = torso.WarpBasedTorsoModel(scale="standard")
    convs = {n: m for n, m in model.named_modules() if isinstance(m, torch.nn.Conv3d)}
    assert {n for n, m in convs.items() if not isinstance(m, c3d.Conv3D)} == {
        "motion_field_estimator.compress"}
    assert len(convs) == 1 + 12 + 10 + 2  # compress, 12 res convs, 10 U-Net, fuser + mask

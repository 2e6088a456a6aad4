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
from real3dportrait_tpu_torch.inference.k7_shapes import TORSO_CONV3D_SHAPES
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
TILES = dict(threads=256, warp_tile=32, ci_chunk=8, stages=2, smem_max=232448,
             tail_tiles={16: (4, 32), 2: (8, 32)}, tail_ctas_per_sm=2,
             tail_groups={16: 2, 2: 1})

# every distinct 3D conv of the standard torso (models/torso.py:367-413):
# the 7^3 tgt_head_fuser, the U-Net's down_0-4 and up_0-4, the appearance
# extractor's ResBlock3D
TORSO_SHAPES = [(1, ci, co, dhw, k) for _, (ci, co, k, dhw) in TORSO_CONV3D_SHAPES]
TORSO_IDS = [tag.split()[0] for tag, _ in TORSO_CONV3D_SHAPES]


@pytest.mark.parametrize("b,ci,co,dhw,k", TORSO_SHAPES + [
    (2, 5, 7, (3, 9, 11), 3), (1, 6, 33, (5, 13, 70), 7), (1, 37, 70, (16, 4, 4), 3)],
    ids=TORSO_IDS + ["b2_odd", "k7_wide", "deep_odd"])
def test_k7_launch_plans_cover_every_voxel_and_channel(b, ci, co, dhw, k):
    # each (batch, output channel, voxel) is written once by one CTA of
    # each input-channel split; the splits cut the input channels into
    # consecutive ranges of whole steps, which the second pass adds in
    # split order; the tile fits the CTA's M and its shared memory
    d, h, w = dhw
    plan = c3d.conv3d_plan(b, ci, co, d, h, w, k, TILES, 132)
    kh, bn, td, th, tw = plan["KH"], plan["BN"], plan["TD"], plan["TH"], plan["TW"]
    assert bn in (32, 64) and (bn == 64) == (k == 3 and co > 32 and h * w <= 16)
    assert kh in (1, k) and (k == 3 or kh == 1)
    assert td * th * tw <= TILES["threads"] // 32 * TILES["warp_tile"] ** 2 // bn
    assert min(td, th) >= 1 and tw % 4 == 0 and (tw >= w or tw == 64)
    assert c3d.conv3d_smem(k, kh, bn, td, th, tw, TILES) <= TILES["smem_max"]
    per, n = plan["ci_per_split"], plan["n_split"]
    assert per % TILES["ci_chunk"] == 0 and (n - 1) * per < ci <= n * per
    ranges = [(s * per, min(ci, (s + 1) * per)) for s in range(n)]
    assert ranges[0][0] == 0 and ranges[-1][1] == ci
    assert all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:]))
    covered = np.zeros((b, -(-co // bn) * bn, -(-d // td) * td, -(-h // th) * th,
                        -(-w // tw) * tw), np.int32)
    for i in range(b):
        for c0 in range(0, co, bn):
            for d0 in range(0, d, td):
                for h0 in range(0, h, th):
                    for w0 in range(0, w, tw):
                        covered[i, c0:c0 + bn, d0:d0 + td, h0:h0 + th, w0:w0 + tw] += 1
    assert (covered[:, :co, :d, :h, :w] == 1).all()
    for tail_d in TILES["tail_tiles"]:
        _check_tail_plan(b, ci, tail_d, h, w, 132)


def _check_tail_plan(b, c, d, h, w, sms):
    """K7b's launch: every (batch, pixel) in exactly one of the grid's
    ``n_tiles`` tiles, every input channel in exactly one of its
    ``n_split`` splits, none empty, and splits where the tiles alone would
    leave CTA slots of the card idle."""
    plan = torso.mfe_tail_plan(b, c, d, h, w, TILES, sms)
    (th, tw), n, per = plan["tile"], plan["n_split"], plan["c_per_split"]
    assert (th, tw) == TILES["tail_tiles"][d]
    assert 1 <= n <= c and (n - 1) * per < c <= n * per
    channels = np.zeros(c, np.int32)
    for q in range(n):
        assert q * per < min(c, (q + 1) * per), "an empty split"
        channels[q * per:(q + 1) * per] += 1
    assert (channels == 1).all()
    tiles = [(i, y0, x0) for i in range(b) for y0 in range(0, h, th) for x0 in range(0, w, tw)]
    assert len(tiles) == plan["n_tiles"]
    covered = np.zeros((b, h, w), np.int32)
    for i, y0, x0 in tiles:
        covered[i, y0:y0 + th, x0:x0 + tw] += 1
    assert (covered == 1).all()
    slots = TILES["tail_ctas_per_sm"] * sms
    if plan["n_tiles"] < slots and c > 1:
        assert n > 1 and n * plan["n_tiles"] >= min(slots, c * plan["n_tiles"]) // 2


@pytest.mark.parametrize("b,c,d,hw,sms", [
    (1, 32, 16, (64, 64), 132), (1, 32, 16, (64, 64), 16), (2, 57, 16, (9, 37), 132),
    (1, 89, 16, (8, 8), 132), (2, 4, 2, (16, 16), 132), (1, 3, 2, (5, 70), 132),
    (1, 1, 16, (2, 2), 132), (4, 32, 16, (128, 128), 132)],
    ids=["frame", "frame_16_sms", "v1_odd", "fan_in_89", "tiny", "tiny_wide", "one_channel",
         "b4_256"])
def test_k7b_launch_plan_covers_every_pixel_and_channel(b, c, d, hw, sms):
    _check_tail_plan(b, c, d, *hw, sms)


def _tf32_rna(a: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: round fp32 to 10 mantissa bits, ties away from
    zero (the low 13 bits of the result are zero)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("ci,co,dhw,k", [(89, 4, (7, 8, 8), 7), (512, 8, (4, 4, 4), 3)],
                         ids=["fuser_fan_in", "down_4_fan_in"])
def test_split_tf32_conv3d_holds_the_chip_tolerance(ci, co, dhw, k):
    # K7a's arithmetic: each fp32 operand split as hi = tf32(x), lo =
    # tf32(x - hi), each product lo*hi + hi*lo + hi*hi, summed in fp32, on
    # the chip's inputs (N(0,1), weights N(0, 1/fan_in)) at the fuser's
    # fan-in (89 x 7^3) and down_4's (512 x 3^3). It stays within the chip
    # tolerance of 3e-4 of the float64 conv, and one-pass TF32 (hi*hi
    # alone) errs at least 10x more: why the kernel pays for 3 products
    rng = np.random.RandomState(ci)
    x = rng.randn(1, ci, *dhw).astype(np.float32)
    w = (rng.randn(co, ci, k, k, k) / np.sqrt(ci * k ** 3)).astype(np.float32)
    x_hi, w_hi = _tf32_rna(x), _tf32_rna(w)
    x_lo, w_lo = _tf32_rna(x - x_hi), _tf32_rna(w - w_hi)
    assert not (x_hi.view(np.uint32) & 0x1FFF).any()
    assert (np.abs(x - x_hi) <= 2.0 ** -11 * np.abs(x)).all()

    def conv(a, b_):
        return c3d.conv3d_plain(torch.from_numpy(a), torch.from_numpy(b_))

    want = c3d.conv3d_plain(torch.from_numpy(x).double(), torch.from_numpy(w).double())
    split = conv(x_lo, w_hi) + conv(x_hi, w_lo) + conv(x_hi, w_hi)
    one_pass = conv(x_hi, w_hi)
    err = float((split.double() - want).abs().max())
    err_one = float((one_pass.double() - want).abs().max())
    assert err <= 3e-4, f"split TF32: {err}"
    assert err_one >= 10 * err, f"one pass {err_one} against split {err}"


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

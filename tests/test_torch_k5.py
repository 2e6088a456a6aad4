"""Kernels K5a and K5b (``csrc/torso_warp.cu``) on the CPU: their index maps
emulated in numpy cover every output element exactly once, at the torso
path's shapes and at ragged ones, and K5a's arithmetic (grid coordinates,
the separable gaussian tables, the sparse motions) emulated in numpy
float32 agrees with ``kp2gaussian_3d``, ``_axis`` and
``create_sparse_motions`` as torch evaluates them on the card.
"""

import numpy as np
import pytest
import torch

from real3dportrait_tpu_torch.models import torso

f32 = np.float32

# the kernels' tiles along w (csrc/torso_warp.cu kDeformTile, kWarpTile)
DEFORM_TILE, WARP_TILE = 64, 32


def card_axis(n: int) -> np.ndarray:
    """``_axis`` as torch's CUDA kernels round it: the division by the
    scalar n - 1 is a multiply by fp32(1 / (n - 1)), then * 2 and - 1, each
    rounded to float32."""
    q = np.arange(n, dtype=f32) * (f32(1) / f32(n - 1))
    return (f32(2) * q) - f32(1)


def card_gauss(a, kp):
    """kp2gaussian_3d's factor: (a - kp)^2 * -0.5, the division by 0.01 a
    multiply by fp32(1 / fp32(0.01)) = 100, then exp, each in float32."""
    t = (np.asarray(a, f32) - np.asarray(kp, f32)).astype(f32)
    return np.exp(((f32(-0.5) * (t * t)) * f32(100)).astype(f32)).astype(f32)


def _card_axis_torch(n, device):
    return torch.from_numpy(card_axis(n)).to(device)


# ---------------------------------------------------------------------------
# index maps
# ---------------------------------------------------------------------------


def _k5a_counts(b, k, d, h, w):
    """How often the kernel's threads write each element of the
    [b, (k+1)*5, d, h, w] output under ``torso_deform_plan``."""
    plan = torso.torso_deform_plan(b, k, d, h, w)
    tile, rows, cand = plan["tile_w"], plan["rows"], plan["cand"]
    gx, gy, gz = plan["grid"]
    assert tile == DEFORM_TILE and 1 <= rows <= 16 and 1 <= cand <= min(k + 1, 8)
    assert max(gy, gz) <= 65535
    counts = np.zeros((b, (k + 1) * 5, d, h, w), np.int64)
    tx = np.arange(tile)
    for bz in range(gz):
        bb, dd = divmod(bz, d)
        for by in range(gy):
            h0 = by * rows
            for bx in range(gx):
                wv = bx * tile + tx
                wv = wv[wv < w]                      # lanes past W store nothing
                for ty in range(cand):
                    for kk in range(ty, k + 1, cand):
                        for r in range(min(rows, h - h0)):
                            for j in range(5):
                                counts[bb, kk * 5 + j, dd, h0 + r, wv] += 1
    return counts


@pytest.mark.parametrize("b,k,d,h,w", [(1, 4, 16, 64, 64), (2, 4, 2, 5, 5), (2, 4, 2, 7, 11),
                                       (2, 4, 2, 6, 70), (1, 9, 3, 9, 5)],
                         ids=["path", "b2_w5", "b2_w11", "b2_w70", "k9"])
def test_k5a_plan_covers_every_output_once(b, k, d, h, w):
    assert (_k5a_counts(b, k, d, h, w) == 1).all()


def _k5b_counts(b, c, d, h, w):
    """How often K5b computes each (voxel, channel) into its shared tile,
    and how often its stores write each element of the [b, c*d, h, w]
    output (16 B stores where W is a multiple of 4, else scalar)."""
    lanes = c // 4
    threads = WARP_TILE * lanes
    computed = np.zeros((b, d, h, w, c), np.int64)
    stored = np.zeros((b, c * d, h, w), np.int64)
    t = np.arange(threads)
    q, v = t % lanes, t // lanes
    for bd in range(b * d):
        bb, dd = divmod(bd, d)
        for hh in range(h):
            for bx in range(-(-w // WARP_TILE)):
                w0 = bx * WARP_TILE
                nvox = min(WARP_TILE, w - w0)
                for j in range(4):
                    if c == 4:                        # straight out, lanes along w
                        keep = v < nvox
                        np.add.at(stored, (bb, j * d + dd, hh, w0 + v[keep]), 1)
                    else:                             # the sampled voxels, padding too
                        keep = v < nvox
                        np.add.at(computed, (bb, dd, hh, w0 + v[keep], 4 * q[keep] + j), 1)
                if c == 4:
                    continue
                if w % 4 == 0:
                    ch, x = t // (WARP_TILE // 4), (t % (WARP_TILE // 4)) * 4
                    keep = x < nvox
                    assert (x[keep] + 3 < nvox).all()   # a vector stays in the row
                    for j in range(4):
                        np.add.at(stored, (bb, ch[keep] * d + dd, hh, w0 + x[keep] + j), 1)
                else:
                    for i in range(0, c * WARP_TILE, threads):
                        ch, x = (t + i) // WARP_TILE, (t + i) % WARP_TILE
                        keep = x < nvox
                        np.add.at(stored, (bb, ch[keep] * d + dd, hh, w0 + x[keep]), 1)
    return computed, stored


@pytest.mark.parametrize("b,c,d,h,w", [(1, 32, 16, 64, 64), (1, 4, 16, 64, 64),
                                       (2, 32, 2, 3, 5), (2, 32, 2, 3, 11),
                                       (2, 32, 2, 3, 70), (2, 32, 2, 3, 68),
                                       (2, 4, 2, 3, 5), (2, 4, 2, 3, 70)],
                         ids=["path_c32", "path_c4", "c32_w5", "c32_w11", "c32_w70",
                              "c32_w68", "c4_w5", "c4_w70"])
def test_k5b_tiles_cover_every_output_once(b, c, d, h, w):
    computed, stored = _k5b_counts(b, c, d, h, w)
    if c == 32:
        assert (computed == 1).all()
    assert (stored == 1).all()


# ---------------------------------------------------------------------------
# K5a's arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 5, 16, 64, 70])
def test_k5a_axis_is_the_cards(n):
    # the card's reciprocal multiply and torch's true division on the CPU
    # differ by at most one rounding of the quotient (2^-24 below 1, doubled
    # by * 2); the kernel follows the card's rounding, bit for bit
    got = card_axis(n)
    want = torso._axis(n, "cpu").numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.abs(got.astype(np.float64) - want).max() <= 2.0 ** -23
    q = (torch.arange(n) * torch.tensor(1 / (n - 1), dtype=torch.float32)).numpy()
    assert np.array_equal(got, 2 * q - 1)
    # the kernel's former coordinates, from the correctly rounded
    # i / (n - 1), left the card's plain version at 27 of the path's 64
    former = (f32(2) * (np.arange(n, dtype=f32) / f32(n - 1))) - f32(1)
    assert np.array_equal(former, want)
    if n == 64:
        assert (got != former).sum() == 27


@pytest.mark.parametrize("b,k,d,h,w,spread", [(1, 4, 16, 64, 64, 0.8), (1, 4, 16, 64, 64, 0.1),
                                              (2, 4, 2, 7, 11, 1.6), (1, 9, 3, 6, 70, 0.8)],
                         ids=["path", "path_near_identity", "b2_ragged_outside", "k9_w70"])
def test_k5a_gaussian_tables_match_kp2gaussian(monkeypatch, b, k, d, h, w, spread):
    # the kernel's heatmap from its tables: per warp, lane 2 r + s holds
    # gz * gy of row h0 + r (s = 0 driving, 1 source), the x factors are the
    # lane's own; heat = gzy_d * gx_d - gzy_s * gx_s. Held to kp2gaussian_3d
    # on the card's coordinates: 1e-6 absolute (exp's last ulp differs
    # between numpy and torch; the CPU divides by 0.01 where the card
    # multiplies by 100, one ulp of the exponent)
    rng = np.random.RandomState(3)
    kp_d = (spread * (2 * rng.rand(b, k, 3) - 1)).astype(f32)
    kp_s = (kp_d + 0.1 * (2 * rng.rand(b, k, 3) - 1)).astype(f32) if spread == 0.1 else \
        (spread * (2 * rng.rand(b, k, 3) - 1)).astype(f32)
    rows = torso.torso_deform_plan(b, k, d, h, w)["rows"]
    ax, ay, az = card_axis(w), card_axis(h), card_axis(d)
    heat = np.zeros((b, k, d, h, w), f32)
    lane = np.arange(32)
    for bb in range(b):
        for kk in range(k):
            kp = np.stack([kp_d[bb, kk], kp_s[bb, kk]])          # [driving, source]
            gxd, gxs = card_gauss(ax, kp[0, 0]), card_gauss(ax, kp[1, 0])
            for dd in range(d):
                for h0 in range(0, h, rows):
                    src = lane & 1
                    gy_l = ay[np.minimum(h0 + (lane >> 1), h - 1)]
                    table = (card_gauss(az[dd], kp[src, 2]) * card_gauss(gy_l, kp[src, 1])
                             ).astype(f32)
                    for r in range(min(rows, h - h0)):
                        heat[bb, kk, dd, h0 + r] = (table[2 * r] * gxd).astype(f32) - \
                            (table[2 * r + 1] * gxs).astype(f32)
    monkeypatch.setattr(torso, "_axis", _card_axis_torch)
    want = (torso.kp2gaussian_3d(torch.from_numpy(kp_d), d, h, w)
            - torso.kp2gaussian_3d(torch.from_numpy(kp_s), d, h, w)).numpy()
    assert np.abs(heat - want).max() <= 1e-6
    assert np.abs(want).max() > 0.1          # the gaussians reach the grid


@pytest.mark.parametrize("spread", [0.8, 1.6, 0.1])
def test_k5a_sparse_motions_match(monkeypatch, spread):
    # each candidate's sample (g - kp_d) + kp_s, rounded after each
    # operation, is create_sparse_motions' on the card's grid, bit for bit
    rng = np.random.RandomState(4)
    d, h, w, k = 3, 5, 64, 4
    kp_d = (spread * (2 * rng.rand(1, k, 3) - 1)).astype(f32)
    kp_s = (spread * (2 * rng.rand(1, k, 3) - 1)).astype(f32)
    monkeypatch.setattr(torso, "_axis", _card_axis_torch)
    want = torso.create_sparse_motions(torch.from_numpy(kp_s), torch.from_numpy(kp_d),
                                       d, h, w).numpy()
    axes = (card_axis(w), card_axis(h), card_axis(d))
    for kk in range(k + 1):
        for a, n in enumerate((w, h, d)):
            g = axes[a]
            got = g if kk == 0 else ((g - kp_d[0, kk - 1, a]).astype(f32)
                                     + kp_s[0, kk - 1, a]).astype(f32)
            plane = np.moveaxis(want[0, kk, ..., a], 2 - a, -1).reshape(-1, n)
            assert np.array_equal(plane, np.broadcast_to(got, plane.shape))

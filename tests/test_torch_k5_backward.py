"""The trilinear adjoints of K5a and K5b (``csrc/torso_warp.cu``
``deform_input_adjoint_kernel`` and ``warp_volume_adjoint_kernel``) on the
CPU: their index maps emulated in numpy float32 with the card's roundings.

K5a's adjoint sums the terms of neighbouring voxels that share a corner
(across lanes by shuffle, across rows in registers) before its atomics:
every term must reach exactly one atomic, at the corner where the plain
scatter adds it. K5b's adjoint scatters with one lane a voxel's channel
quad: every (voxel, corner, channel) contribution must be taken once, at
the plain version's corner and weight.
"""

import numpy as np
import pytest
import torch

from real3dportrait_tpu_torch.models import torso

f32 = np.float32

# csrc/torso_warp.cu: the rows a thread of K5a's adjoint runs (kAdjRows),
# K5b's voxels along w of a CTA (kWarpTile)
ADJ_ROWS, WARP_TILE = 16, 32


def card_axis(n: int) -> np.ndarray:
    """grid_axis: 2 * (i * fp32(1 / (n - 1))) - 1, each op rounded to fp32."""
    q = np.arange(n, dtype=f32) * (f32(1) / f32(n - 1))
    return (f32(2) * q) - f32(1)


def unnorm(c, n: int):
    """unnorm_ac: (c + 1) / 2 * (n - 1) in fp32."""
    return ((np.asarray(c, f32) + f32(1)) / f32(2)) * f32(n - 1)


def lerp_zeros(s, n: int) -> tuple:
    """lerp_zeros: the two corners' indices, clamped into [0, n), and their
    weights (f + 1) - x and x - f, 0 for a corner outside."""
    x = unnorm(s, n)
    f = np.floor(x)
    w0 = np.where((f >= 0) & (f <= n - 1), (f + f32(1)).astype(f32) - x, f32(0)).astype(f32)
    w1 = np.where((f + 1 >= 0) & (f + 1 <= n - 1), x - f, f32(0)).astype(f32)
    return (np.clip(f, 0, n - 1).astype(np.int64), np.clip(f + 1, 0, n - 1).astype(np.int64),
            w0, w1)


def sample(g: np.ndarray, k: int, kd: float, ks: float) -> np.ndarray:
    """A candidate's sample coordinates on one axis: the grid (k = 0) or
    (grid - kd) + ks, each op rounded to fp32."""
    return g if k == 0 else ((g - f32(kd)).astype(f32) + f32(ks)).astype(f32)


def keypoints(rng, b: int, k: int, spread: float) -> tuple:
    """Driving keypoints uniform in [-0.8, 0.8] with source keypoints within
    0.1 of them (spread 0.1), or both uniform in [-spread, spread]."""
    if spread == 0.1:
        kp_d = (0.8 * (2 * rng.rand(b, k, 3) - 1)).astype(f32)
        return (kp_d + 0.1 * (2 * rng.rand(b, k, 3) - 1)).astype(f32), kp_d
    return tuple((spread * (2 * rng.rand(b, k, 3) - 1)).astype(f32) for _ in range(2))


# ---------------------------------------------------------------------------
# K5a's adjoint
# ---------------------------------------------------------------------------


def k5a_adjoint_atomics(b, k, d, h, w, kp_s, kp_d):
    """The kernel's atomics, emulated lane by lane: a warp is one candidate
    of a 32-voxel row of one (b, d), a thread ADJ_ROWS rows. Per row the 8
    corner terms of each lane; lane l adds lane l - 1's upper-x terms to its
    lower-x ones where lane l - 1's upper x corner is its lower one (and
    lane l - 1 drops them); the upper-y terms ride to the next row's lower-y
    ones where that row's lower y corner is their y corner, else they are
    sent alone; the last row's are sent after the loop. Returns the atomics
    as (destination (b, z, y, x), [term]) and each term's (destination,
    weight) as the plain scatter has them; a term is (b, candidate, d, h, w,
    corner)."""
    atomics, terms = [], {}
    gx, gy, gz = card_axis(w), card_axis(h), card_axis(d)
    lanes = np.arange(32)
    for bb in range(b):
        for kk in range(k + 1):
            kd = kp_d[bb, kk - 1] if kk else np.zeros(3, f32)
            ks = kp_s[bb, kk - 1] if kk else np.zeros(3, f32)
            zi0, zi1, zw0, zw1 = lerp_zeros(sample(gz, kk, kd[2], ks[2]), d)
            yi0, yi1, yw0, yw1 = lerp_zeros(sample(gy, kk, kd[1], ks[1]), h)
            for x0 in range(0, w, 32):
                wv = x0 + lanes
                wc = np.minimum(wv, w - 1)
                xi0, xi1, xw0, xw1 = lerp_zeros(sample(gx[wc], kk, kd[0], ks[0]), w)
                xw0, xw1 = np.where(wv < w, xw0, 0), np.where(wv < w, xw1, 0)
                take = (lanes > 0) & (np.roll(xi1, 1) == xi0)
                give = (lanes < 31) & np.roll(take, -1)
                xs = (xi0, xi1)
                for dd in range(d):
                    zs = (zi0[dd], zi1[dd])
                    for h0 in range(0, h, ADJ_ROWS):
                        carry, carry_y = None, -1
                        for hh in range(h0, min(h0 + ADJ_ROWS, h)):
                            ys = (yi0[hh], yi1[hh])
                            t = {}
                            for c in range(8):
                                cz, cy, cx = c >> 2, (c >> 1) & 1, c & 1
                                wgt = ((np.where(cx, xw1, xw0) * (yw1 if cy else yw0)[hh])
                                       .astype(f32) * (zw1 if cz else zw0)[dd]).astype(f32)
                                t[cz, cy, cx] = []
                                for lane in range(32):
                                    term = (bb, kk, dd, hh, int(wv[lane]), c)
                                    if wv[lane] < w:
                                        terms[term] = ((bb, zs[cz], ys[cy], int(xs[cx][lane])),
                                                       wgt[lane])
                                    t[cz, cy, cx].append([term] if wv[lane] < w else [])
                            for cz in range(2):
                                for cy in range(2):
                                    up = t[cz, cy, 1]
                                    t[cz, cy, 0] = [t[cz, cy, 0][i] + (up[i - 1] if take[i] else [])
                                                    for i in range(32)]
                                    t[cz, cy, 1] = [[] if give[i] else up[i] for i in range(32)]
                            join = carry_y == ys[0]
                            for cz in range(2):
                                for cx in range(2):
                                    for lane in range(32):
                                        dest = (bb, zs[cz], ys[0], int(xs[cx][lane]))
                                        if carry_y >= 0 and join:
                                            t[cz, 0, cx][lane] = t[cz, 0, cx][lane] + \
                                                carry[cz, cx][lane]
                                        elif carry_y >= 0:
                                            atomics.append(((bb, zs[cz], carry_y,
                                                             int(xs[cx][lane])),
                                                            carry[cz, cx][lane]))
                                        atomics.append((dest, t[cz, 0, cx][lane]))
                            carry = {(cz, cx): t[cz, 1, cx] for cz in range(2) for cx in range(2)}
                            carry_y = ys[1]
                        for cz in range(2):
                            for cx in range(2):
                                for lane in range(32):
                                    atomics.append(((bb, zs[cz], carry_y, int(xs[cx][lane])),
                                                    carry[cz, cx][lane]))
    return atomics, terms


@pytest.mark.parametrize("spread", [0.1, 0.8, 1.6])
@pytest.mark.parametrize("b,d,h,w", [(1, 16, 64, 64), (2, 3, 19, 5), (1, 2, 9, 70)],
                         ids=["path", "w5", "w70"])
def test_k5a_adjoint_sums_each_term_once_at_its_corner(b, d, h, w, spread):
    # every (source voxel, candidate, corner) term of nonzero weight is in
    # exactly one atomic, at the corner where the plain scatter adds it; near
    # the identity the atomics that carry a nonzero term number 1.9 a
    # (voxel, candidate) at the path's shape, where 6.6 terms lie inside
    k = 4
    rng = np.random.RandomState(int(spread * 10) + w)
    kp_s, kp_d = keypoints(rng, b, k, spread)
    atomics, terms = k5a_adjoint_atomics(b, k, d, h, w, kp_s, kp_d)
    seen, sent = {}, 0
    for dest, ts in atomics:
        live = [t for t in ts if terms[t][1] != 0]
        for t in live:
            assert terms[t][0] == dest
            seen[t] = seen.get(t, 0) + 1
        sent += bool(live)
    live = {t for t, (_, wgt) in terms.items() if wgt != 0}
    assert set(seen) == live and set(seen.values()) == {1}
    assert len(live) > 0
    if spread == 0.1 and (h, w) == (64, 64):
        assert sent < 2.6 * b * (k + 1) * d * h * w


@pytest.mark.parametrize("spread", [0.1, 1.6])
def test_k5a_adjoint_sums_match_plain(monkeypatch, spread):
    # the atomics' sums of go * ((wx * wy) * wz) over channels 1..4 of each
    # candidate, against the plain scatter on the card's grid: 1e-5 of scale
    # (fp32 sums of up to 40 terms in another order)
    b, k, d, h, w = 2, 4, 3, 9, 70
    rng = np.random.RandomState(5)
    kp_s, kp_d = keypoints(rng, b, k, spread)
    dout = rng.randn(b, (k + 1) * 5, d, h, w).astype(f32)
    g = dout.reshape(b, k + 1, 5, d, h, w)[:, :, 1:]
    atomics, terms = k5a_adjoint_atomics(b, k, d, h, w, kp_s, kp_d)
    got = np.zeros((b, d, h, w, 4), np.float64)
    for dest, ts in atomics:
        for bb, kk, dd, hh, ww, _ in ts:
            got[dest] += terms[bb, kk, dd, hh, ww, _][1] * g[bb, kk, :, dd, hh, ww]
    monkeypatch.setattr(torso, "_axis", lambda n, device: torch.from_numpy(card_axis(n)))
    want = torso.torso_deform_input_backward_plain(
        torch.from_numpy(dout), torch.from_numpy(kp_s), torch.from_numpy(kp_d),
        (b, d, h, w, 4)).numpy()
    assert np.abs(want).max() > 0.5
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# K5b's adjoint
# ---------------------------------------------------------------------------


def _k5b_adjoint_counts(b, c, d, h, w):
    """How often the kernel's lanes take each (voxel, corner, channel)
    contribution, read each element of dout [b, c*d, h, w] into the
    shared tile, and store each element of dgrid [b, d, h, w, 3]."""
    lanes = c // 4
    threads = WARP_TILE * lanes
    taken = np.zeros((b, d, h, w, 8, c), np.int64)
    read = np.zeros((b, c * d, h, w), np.int64)
    stored = np.zeros((b, d, h, w, 3), np.int64)
    t = np.arange(threads)
    q, v = t % lanes, t // lanes
    for bd in range(b * d):
        bb, dd = divmod(bd, d)
        for hh in range(h):
            for bx in range(-(-w // WARP_TILE)):
                w0 = bx * WARP_TILE
                nvox = min(WARP_TILE, w - w0)
                for i in range(t[0], c * WARP_TILE, threads):
                    ch, x = (t + i) // WARP_TILE, (t + i) % WARP_TILE
                    keep = x < nvox
                    np.add.at(read, (bb, ch[keep] * d + dd, hh, w0 + x[keep]), 1)
                keep = v < nvox                     # ragged voxels weigh 0
                chans = 4 * q[keep][:, None, None] + np.arange(4)[None, None, :]
                np.add.at(taken, (bb, dd, hh, (w0 + v[keep])[:, None, None],
                                  np.arange(8)[None, :, None], chans), 1)
                for i in range(0, 3 * nvox, threads):
                    e = t + i
                    e = e[e < 3 * nvox]
                    np.add.at(stored, (bb, dd, hh, w0 + e // 3, e % 3), 1)
    return taken, read, stored


@pytest.mark.parametrize("b,c,d,h,w", [(1, 32, 16, 64, 64), (1, 4, 16, 64, 64),
                                       (2, 32, 2, 3, 5), (2, 32, 2, 3, 70), (2, 4, 2, 3, 70)],
                         ids=["path_c32", "path_c4", "c32_w5", "c32_w70", "c4_w70"])
def test_k5b_adjoint_takes_every_contribution_once(b, c, d, h, w):
    taken, read, stored = _k5b_adjoint_counts(b, c, d, h, w)
    assert (taken == 1).all() and (read == 1).all() and (stored == 1).all()


def k5b_corners(grid: np.ndarray, d: int, h: int, w: int, lanes: int) -> tuple:
    """The kernel's corners of each voxel: float4 offsets from the voxel's
    first corner (((iz * H + iy) * W + ix) * lanes, in float4s) by its x, y
    and z steps, 0 past the last voxel, and the corner weights ((wx * wy) *
    wz), border padding; as [N, 8] voxel indices and weights."""
    r = [unnorm(grid[..., a], n) for a, n in enumerate((w, h, d))]
    pos = [np.minimum(np.maximum(x, f32(0)), f32(n - 1)) for x, n in zip(r, (w, h, d))]
    fl = [np.floor(x) for x in pos]
    lerp = [(f32(1) + f - x, x - f) for x, f in zip(pos, fl)]
    ix, iy, iz = (f.astype(np.int64) for f in fl)
    first = ((iz * h + iy) * w + ix) * lanes
    steps = (np.where(ix < w - 1, lanes, 0), np.where(iy < h - 1, w * lanes, 0),
             np.where(iz < d - 1, h * w * lanes, 0))
    idx, wgt = [], []
    for corner in range(8):
        cs = (corner & 1, (corner >> 1) & 1, corner >> 2)
        off = first + sum(s * c for s, c in zip(steps, cs))
        assert (off % lanes == 0).all()
        idx.append(off // lanes)
        wgt.append(((lerp[0][cs[0]] * lerp[1][cs[1]]).astype(f32) * lerp[2][cs[2]]).astype(f32))
    return np.stack(idx, -1), np.stack(wgt, -1)


@pytest.mark.parametrize("deformation", ["near_identity", "uniform"])
@pytest.mark.parametrize("c", [32, 4])
def test_k5b_adjoint_corners_are_the_plains(deformation, c):
    # the kernel's (corner, weight) pairs of nonzero weight are the plain
    # scatter's, corner for corner: a corner past the volume (the plain
    # version's, masked) is the kernel's lower one again at weight 0
    d, h, w = 4, 9, 70
    rng = np.random.RandomState(11)
    base = torso.make_coordinate_grid_3d(d, h, w).numpy()
    if deformation == "near_identity":
        grid = (base + 0.05 * rng.randn(d, h, w, 3)).astype(f32)
    else:
        grid = (2.4 * rng.rand(d, h, w, 3) - 1.2).astype(f32)
    idx, wgt = k5b_corners(grid.reshape(-1, 3), d, h, w, c // 4)
    # the plain version's corners (_trilinear_adjoint, border)
    r = [unnorm(grid.reshape(-1, 3)[:, a], n) for a, n in enumerate((w, h, d))]
    pos = [np.clip(x, f32(0), f32(n - 1)) for x, n in zip(r, (w, h, d))]
    fl = [np.floor(x) for x in pos]
    lerp = [(f32(1) + f - x, x - f) for x, f in zip(pos, fl)]
    clamped = 0
    for corner in range(8):
        cs = (corner & 1, (corner >> 1) & 1, corner >> 2)
        ci = [f.astype(np.int64) + s for f, s in zip(fl, cs)]
        ok = (ci[0] <= w - 1) & (ci[1] <= h - 1) & (ci[2] <= d - 1)
        flat = (np.minimum(ci[2], d - 1) * h + np.minimum(ci[1], h - 1)) * w \
            + np.minimum(ci[0], w - 1)
        pw = np.where(ok, ((lerp[0][cs[0]] * lerp[1][cs[1]]).astype(f32)
                           * lerp[2][cs[2]]).astype(f32), f32(0))
        assert np.array_equal(wgt[:, corner], pw)
        nz = pw != 0
        assert np.array_equal(idx[nz, corner], flat[nz])
        clamped += int((~ok).sum())
    assert clamped > 0                     # coordinates at and past the border

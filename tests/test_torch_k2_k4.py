"""The arithmetic of kernels K2 (importance_sample) and K4 (secc_raster), as
``csrc/render_march.cu`` and ``csrc/secc_raster.cu`` order it, emulated in
float32 numpy and held to the plain PyTorch versions, which the CPU runs
(the kernels themselves run only on a CUDA device:
``tests/test_torch_kernels_cuda.py``)."""

import numpy as np
import pytest
import torch

from real3dportrait_tpu_torch.geometry import bfm
from real3dportrait_tpu_torch.geometry.rasterizer import (
    project_to_screen,
    rasterize_verts,
    rasterize_verts_plain,
    secc_raster_plain,
)
from real3dportrait_tpu_torch.geometry.secc_renderer import SECCRenderer
from real3dportrait_tpu_torch.rendering.renderer import (
    importance_sample,
    importance_sample_plain,
    importance_u,
)

torch.set_num_threads(1)
f32 = np.float32


# ---- K2 -------------------------------------------------------------------

def _scan(v: np.ndarray, op) -> np.ndarray:
    """A group's inclusive scan by shuffles (Hillis-Steele, as
    ``__shfl_up_sync``): lane l takes op(v[l - off], v[l]) for off = 1, 2, 4..."""
    v = v.copy()
    off = 1
    while off < len(v):
        v[off:] = op(v[off:], v[:-off])
        off *= 2
    return v


def _butterfly_sum(v: np.ndarray) -> np.float32:
    """A group's sum by ``__shfl_xor_sync``; every lane ends with lane 0's."""
    v = v.copy()
    off = len(v) // 2
    while off:
        v = v + v[np.arange(len(v)) ^ off]
        off //= 2
    return v[0]


def _count_le(cdf: np.ndarray, u: np.float32) -> int:
    """The kernel's search: #(cdf <= u) for a non-decreasing cdf of n
    entries, by a binary search of ceil(log2(n + 1)) fixed steps."""
    n = len(cdf)
    step, cnt = 1 << (n.bit_length() - 1), 0
    while step:
        k = cnt + step
        if k <= n and cdf[k - 1] <= u:
            cnt = k
        step >>= 1
    return cnt


def _softplus(x):
    return np.maximum(x, f32(0)) + np.log1p(np.exp(-np.abs(x)))


def _k2_emulated(d: np.ndarray, sg: np.ndarray, u: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One ray through K2's order of operations: S samples d, sg [S], u [n]
    -> (fine depths [n], the kernel's cdf [S - 2])."""
    s_all = len(d)
    n_int, s, eps = s_all - 1, s_all - 3, f32(1e-5)
    width = 16 if n_int <= 16 else 32
    slots = -(-n_int // width)
    k = np.arange(slots * width)
    on = k < n_int
    kc = np.minimum(k, n_int - 1)
    dens = _softplus((sg[kc] + sg[kc + 1]) / f32(2) - f32(1))
    alpha = np.where(on, f32(1) - np.exp(-(dens * (d[kc + 1] - d[kc]))), f32(0)).astype(f32)
    mid = ((d[kc] + d[kc + 1]) / f32(2)).astype(f32)
    # transmittance: a product scan per slot, carried from slot to slot
    w = np.zeros(slots * width, f32)
    trans = f32(1)
    for q in range(slots):
        sl = slice(q * width, (q + 1) * width)
        incl = _scan(np.where(on[sl], f32(1) - alpha[sl] + f32(1e-10), f32(1)).astype(f32),
                     np.multiply)
        excl = np.concatenate([[f32(1)], incl[:-1]]).astype(f32)
        w[sl] = alpha[sl] * (trans * excl)
        trans = f32(trans * incl[-1])
    # smoothing at k = 1 .. s, then the pdf's total by a butterfly per lane
    prev = np.concatenate([[f32(0)], w[:-1]])
    nxt = np.concatenate([w[1:], [f32(0)]])
    inner = (k >= 1) & (k <= s)
    pw = np.where(inner, (np.maximum(prev, w) + np.maximum(w, nxt)) / f32(2) + f32(0.01) + eps,
                  f32(0)).astype(f32)
    lane_sums = np.zeros(width, f32)
    for q in range(slots):
        lane_sums = (lane_sums + pw[q * width:(q + 1) * width]).astype(f32)
    total = _butterfly_sum(lane_sums)
    # cdf: a sum scan of each pdf term per slot, carried
    pdf = np.where(inner, pw / total, f32(0)).astype(f32)
    cdf = np.zeros(slots * width, f32)
    carry = f32(0)
    for q in range(slots):
        sl = slice(q * width, (q + 1) * width)
        cdf[sl] = _scan(pdf[sl], np.add) + carry
        carry = cdf[sl][-1]
    cdf = cdf[:s + 1]
    out = np.empty(len(u), f32)
    for j, uu in enumerate(u.astype(f32)):
        below = max(_count_le(cdf, uu) - 1, 0)
        above = min(below + 1, s)
        denom = f32(cdf[above] - cdf[below])
        if denom < eps:
            denom = f32(1)
        out[j] = mid[below] + ((uu - cdf[below]) / denom) * (mid[above] - mid[below])
    return out, cdf


def _plain_cdf(depths: torch.Tensor, sigma: torch.Tensor) -> np.ndarray:
    """The plain version's cdf of each ray, [R, S - 2]."""
    from real3dportrait_tpu_torch.rendering.ray_marcher import march_weights
    from real3dportrait_tpu_torch.rendering.renderer import _smooth_weights

    b, m, s, _ = depths.shape
    weights, _, _ = march_weights(sigma, depths)
    w = _smooth_weights(weights)[:, :, 1:-1].reshape(b * m, s - 3) + 1e-5
    pdf = w / w.sum(dim=-1, keepdim=True)
    return torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1).numpy()


@pytest.mark.parametrize("s", [4, 16, 33, 48, 128])
def test_k2_emulated_order_matches_plain(s):
    # the kernel sums the transmittance, the pdf total and the cdf in
    # another order than the plain version (sequential cumprod / sum /
    # cumsum). pw >= 0.01 keeps both CDFs strictly increasing, and the
    # inverse-CDF interpolation is continuous across bin edges, so where the
    # two CDFs put a u in neighbouring bins (u on a CDF entry of either) the
    # depths differ by rounding only: 2e-5 absolute on depths O(2-3), the
    # chip's 1e-4 with room (deltas down to 0.8/128, pdf terms down to
    # ~1e-4)
    rng = np.random.RandomState(s)
    r, n = 24, 40
    start = rng.uniform(1.8, 2.2, (1, r, 1, 1)).astype(f32)
    steps = (np.arange(s, dtype=f32) + f32(0.5)) / f32(s)
    depths = (start + f32(0.8) * steps[None, None, :, None]).astype(f32)
    sigma = (rng.randn(1, r, s, 1) * 3).astype(f32)
    sigma[0, :4] *= 10  # rays with saturated alphas, one sharp peak
    cdf_plain = _plain_cdf(torch.from_numpy(depths), torch.from_numpy(sigma))
    us = []
    for ray in range(r):
        _, cdf_k = _k2_emulated(depths[0, ray, :, 0], sigma[0, ray, :, 0], np.zeros(1, f32))
        pick = rng.randint(0, s - 2, 8)
        u = np.concatenate([[0.0, 1.0], cdf_k[pick], cdf_plain[ray, pick],
                            rng.uniform(0, 1, n - 18)]).astype(f32)
        us.append(np.sort(u))
    u = np.stack(us)
    for u_t in (torch.from_numpy(u), importance_u(r, n, torch.device("cpu"))):
        want = importance_sample_plain(torch.from_numpy(depths), torch.from_numpy(sigma), u_t)
        got = np.stack([_k2_emulated(depths[0, ray, :, 0], sigma[0, ray, :, 0],
                                     u_t[ray].numpy())[0] for ray in range(r)])
        np.testing.assert_allclose(got, want[0, ..., 0].numpy(), rtol=0, atol=2e-5)
        # the wrapper takes the plain version for CPU tensors, stride-0 u too
        assert torch.equal(importance_sample(torch.from_numpy(depths), torch.from_numpy(sigma),
                                             u_t), want)


def test_k2_binary_search_is_the_linear_count():
    # on every non-decreasing cdf (ties included) of 2..126 entries, for u
    # on every entry, between entries, below the first and above the last
    rng = np.random.RandomState(7)
    for n in range(2, 127):
        steps = rng.uniform(0, 1, n).astype(f32)
        steps[rng.uniform(size=n) < 0.2] = 0  # repeated entries
        cdf = np.cumsum(steps).astype(f32)
        cdf[0] = 0
        cdf /= max(cdf[-1], f32(1))
        us = np.concatenate([cdf, (cdf[:-1] + cdf[1:]) / 2, [-1.0, 0.0, 1.0, 2.0],
                             np.nextafter(cdf, f32(-1)), np.nextafter(cdf, f32(2))]).astype(f32)
        for uu in us:
            assert _count_le(cdf, uu) == int((cdf <= uu).sum()), (n, uu)


def test_importance_u_is_a_stride_zero_view():
    u = importance_u(5, 7, torch.device("cpu"))
    assert u.shape == (5, 7) and u.stride() == (0, 1)
    assert torch.equal(u[3], torch.linspace(0.0, 1.0, 7))


# ---- K4 -------------------------------------------------------------------

def _edge(ax, ay, bx, by, px, py):
    return ((px - ax) * (by - ay) - (py - ay) * (bx - ax)).astype(f32)


def _coverage_both_ways(tri: np.ndarray, size: int) -> tuple[np.ndarray, np.ndarray, dict]:
    """One face [3,2] over its clipped pixel box: (the kernel's decision,
    the quotient test b >= 0 on every pixel, counts of the cases met). The
    kernel folds s = sign(area) into each edge's deltas, rejects a pixel
    where some s * e <= -2^-100 |area|, and else divides: b = s e / |area|."""
    (x0, y0), (x1, y1), (x2, y2) = tri.astype(f32)
    area = _edge(x0, y0, x1, y1, x2, y2)
    with np.errstate(all="ignore"):
        lo = np.maximum(np.floor(tri.min(0)), 0)
        hi = np.minimum(np.floor(tri.max(0)), size - 1)
        if not (np.abs(area) > f32(1e-9)) or (hi < lo).any():
            return np.zeros(0, bool), np.zeros(0, bool), {}
        xs = np.arange(lo[0], hi[0] + 1, dtype=f32) + f32(0.5)
        ys = np.arange(lo[1], hi[1] + 1, dtype=f32) + f32(0.5)
        px, py = (a.ravel() for a in np.meshgrid(xs, ys))
        ends = (((x1, y1), (x2, y2)), ((x2, y2), (x0, y0)), ((x0, y0), (x1, y1)))
        es = [_edge(ax, ay, bx, by, px, py) for (ax, ay), (bx, by) in ends]
        quotient = np.all([(e / area).astype(f32) >= 0 for e in es], axis=0)
        s = f32(1) if area > 0 else f32(-1)
        folded = [((px - ax) * (s * (by - ay)) - (py - ay) * (s * (bx - ax))).astype(f32)
                  for (ax, ay), (bx, by) in ends]
        neg_thr = -(np.abs(area) * f32(2.0 ** -100)).astype(f32)
        maybe = np.all([e > neg_thr for e in folded], axis=0)
        kernel = maybe & np.all([(e / np.abs(area)).astype(f32) >= 0 for e in folded], axis=0)
        cases = {
            "edge zero": int(sum((e == 0).sum() for e in es)),
            "underflow": int(sum((((e / area).astype(f32) == 0) & (e != 0)).sum() for e in es)),
            "divisions skipped": int((~maybe).sum()),
        }
    return kernel, quotient, cases


def test_k4_sign_coverage_is_the_quotient_test():
    # vertices on pixel centres (edges of +-0 at those pixels), collinear,
    # coincident and tiny faces (|area| <= 1e-9: no pixel), faces with one
    # vertex ~3e38 away (edges whose quotient underflows to -0, which
    # passes b >= 0) and random faces of every size: the kernel's decision
    # is the quotient test's at every pixel of every box
    rng = np.random.RandomState(11)
    size = 24
    tris = [rng.uniform(-4, size + 4, (3, 2)) for _ in range(300)]
    tris += [rng.randint(0, size, (3, 2)) + 0.5 for _ in range(200)]
    tris += [np.array([[2.5, 2.5], [6.5, 6.5], [10.5, 10.5]]),   # collinear
             np.array([[3.0, 3.0], [3.0, 3.0], [9.0, 4.0]]),      # coincident
             np.array([[1.0, 1.0], [1.0 + 1e-6, 1.0], [1.0, 1.0 + 1e-6]])]  # tiny
    ax = np.nextafter(f32(1.5), f32(0))  # 1.5 - 2^-23: px - ax tiny at px = 1.5
    for cy, cx in ((0.5, -3e38), (7.5, -1e38), (3.5, 3e38)):
        tris.append(np.array([[ax, 0.0], [ax, 1.0], [cx, cy]]))
        tris.append(np.array([[ax, 0.0], [cx, cy], [ax, 1.0]]))
    seen = {"edge zero": 0, "underflow": 0, "divisions skipped": 0}
    for tri in tris:
        kernel, quotient, cases = _coverage_both_ways(np.asarray(tri, f32), size)
        np.testing.assert_array_equal(kernel, quotient)
        for k, v in cases.items():
            seen[k] += v
    assert all(v > 0 for v in seen.values()), seen


def test_k4_plain_is_projection_then_secc_raster_plain():
    # rasterize_verts' plain version, the wrapper on CPU tensors and the
    # SECC renderer's map are project_to_screen + secc_raster_plain bit for
    # bit, taken from [0,1] to [-1,1] as image * 2 - 1
    assets = bfm.synthetic_bfm(512)
    rng = np.random.RandomState(12)
    coeffs = [torch.from_numpy((rng.randn(2, n) * s).astype(f32))
              for n, s in ((80, 0.3), (64, 0.3), (3, 0.2), (3, 0.2))]
    verts = bfm.compute_face_vertex(assets, *coeffs)
    attr = ((assets.ncc_code + 1) / 2).contiguous()
    uv, z = project_to_screen(verts, 1015.0, 112.0, 48)
    want_m, want_i = secc_raster_plain(uv, z, assets.face_buf, attr, 48)
    for fn in (rasterize_verts_plain, rasterize_verts):
        m, i = fn(verts, assets.face_buf, attr, 1015.0, 112.0, 48)
        assert torch.equal(m, want_m) and torch.equal(i, want_i * 2.0 - 1.0)
    mask, secc = SECCRenderer(assets, rasterize_size=48, device="cpu").render(*coeffs)
    assert torch.equal(mask[..., 0], want_m) and torch.equal(secc, want_i * 2.0 - 1.0)
    assert 0.2 < float(want_m.mean()) < 0.9

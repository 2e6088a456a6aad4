"""K7a's weight gradient on the CPU: the decomposition of
``csrc/conv3d.cu`` ``conv3d_wgrad_kernel`` as ``ops/conv3d.py``
``conv3d_weight_grad_plan`` and ``conv3d_weight_grad_layout`` lay it out,
emulated here and held to ``conv3d_weight_grad_plain`` (which
``tests/test_torch_train_torso.py`` and ``test_torch_torso_grads.py`` hold to
JAX's gradient through the torso model).

The emulation walks the kernel's grid: a CTA a row of taps (kd, kh), 32
input channels (M) and 8 or 32 output channels (N, Co padded to the n8
tiles), a share of the units (row segments of SW columns) whose shifted row
lies inside the volume, R units a brick staged into the shared-memory
layout (x rows with their halo at RS, 8 zero floats after a channel's rows,
dy at DS), tap kw read through the per-voxel offset table; the operands
split as the kernel splits them (hi = tf32 to nearest, lo = v - hi, its low
13 bits dropped by the tensor cores) and a brick's products summed apart
before the running sum takes them.
"""

import math

import numpy as np
import pytest
import torch

from real3dportrait_tpu_torch.ops import conv3d as c3d


def _bits(a: torch.Tensor) -> torch.Tensor:
    return a.contiguous().view(torch.int32)


def _split(a: torch.Tensor):
    """The kernel's wg_split: hi rounded to TF32 on the bits (ties away),
    lo = a - hi with its low 13 bits dropped, as the tensor cores read it."""
    hi = ((_bits(a) + 0x1000) & -0x2000).view(torch.float32)
    lo = ((_bits(a - hi)) & -0x2000).view(torch.float32)
    return hi.double(), lo.double()


def emulate_weight_grad(x: torch.Tensor, dy: torch.Tensor, k: int, sms: int):
    """(d weight, d bias) as the kernel computes them, in float64 sums."""
    b, ci, d, h, w = x.shape
    co = dy.shape[1]
    plan = c3d.conv3d_weight_grad_plan(b, ci, co, d, h, w, k, sms)
    bn, sw, nseg, r, n_split = (plan[n] for n in ("BN", "SW", "nseg", "R", "n_split"))
    lay = c3d.conv3d_weight_grad_layout(k, bn, plan["VP"], sw, r)
    off, rs, cs, ds, nk = (lay[n] for n in ("OFF", "RS", "CS", "DS", "NK"))
    m = c3d.WGRAD_M
    p = k // 2
    e = np.arange(8 * nk)
    xoff = torch.from_numpy(np.where(e < r * sw, (e // sw) * rs + off + e % sw, r * rs))
    dw = torch.zeros((co, ci, k, k, k), dtype=torch.float64)
    db = torch.zeros((co,), dtype=torch.float64)
    covered = torch.zeros((b, d, h, w), dtype=torch.int64)  # the centre tap's voxels
    for kd in range(k):
        for kh in range(k):
            d_lo, h_lo = max(0, p - kd), max(0, p - kh)
            dv, hv = min(d, d + p - kd) - d_lo, min(h, h + p - kh) - h_lo
            if dv <= 0 or hv <= 0:
                continue
            units = b * dv * hv * nseg
            for ct in range(math.ceil(ci / m)):
                for ot in range(math.ceil(co / bn)):
                    ci0, co0 = ct * m, ot * bn
                    nci, nco = min(m, ci - ci0), min(bn, co - co0)
                    acc = torch.zeros((k, m, bn), dtype=torch.float64)
                    for z in range(n_split):
                        u_begin, u_end = units * z // n_split, units * (z + 1) // n_split
                        for u0 in range(u_begin, u_end, r):
                            xs = torch.zeros((m, cs))
                            ys = torch.zeros((bn, ds))
                            for i in range(r):
                                u = u0 + i
                                if u >= u_end:
                                    break
                                row, sg = divmod(u, nseg)
                                row, hh = divmod(row, hv)
                                bb, dd = divmod(row, dv)
                                dz, hy, c0 = d_lo + dd, h_lo + hh, sg * sw
                                lo, hi = max(0, c0 - p), min(w, c0 + sw + p)
                                if lo < hi:
                                    cols = i * rs + off + np.arange(lo, hi) - c0 + p
                                    xs[:nci, cols] = x[bb, ci0:ci0 + nci, dz + kd - p,
                                                       hy + kh - p, lo:hi]
                                n_y = max(0, min(w, c0 + sw) - c0)
                                ys[:nco, i * sw:i * sw + n_y] = dy[bb, co0:co0 + nco, dz, hy,
                                                                   c0:c0 + n_y]
                                if kd == p and kh == p and ct == 0 and ot == 0:
                                    covered[bb, dz, hy, c0:c0 + n_y] += 1
                            b_hi, b_lo = _split(ys[:, :8 * nk])
                            for kw in range(k):
                                a_hi, a_lo = _split(xs[:, xoff + kw])
                                acc[kw] += (a_lo @ b_hi.T + a_hi @ b_lo.T) + a_hi @ b_hi.T
                            if kd == p and kh == p and ct == 0:
                                db[co0:co0 + nco] += ys[:nco, :8 * nk].double().sum(1)
                    dw[co0:co0 + nco, ci0:ci0 + nci, kd, kh] = \
                        acc[:, :nci, :nco].permute(2, 1, 0)
    return dw, db, covered, plan


# Co = 5 (K7b's mask conv, one n8 tile), Ci not a multiple of 32, D = 2 at
# k = 7 (rows of taps past the volume), B = 2, W not a multiple of 4 (4 B
# copies), W over a brick (two segments a row), and few SMs (shares of a row
# of taps' units)
@pytest.mark.parametrize("b,ci,co,dhw,k,sms", [
    (2, 37, 5, (2, 5, 9), 7, 132), (2, 5, 40, (3, 4, 8), 3, 2), (1, 33, 33, (2, 3, 130), 3, 1),
    (2, 89, 32, (3, 6, 16), 7, 4), (1, 64, 9, (4, 4, 4), 3, 132)],
    ids=["mask_conv_d2", "ci5_co40", "two_segments", "fuser_like", "planes_4x4"])
def test_k7a_weight_grad_decomposition_matches_plain(b, ci, co, dhw, k, sms):
    rng = np.random.default_rng(41)
    x = torch.from_numpy(rng.standard_normal((b, ci, *dhw), dtype=np.float32))
    dy = torch.from_numpy(rng.standard_normal((b, co, *dhw), dtype=np.float32))
    got_w, got_b, covered, plan = emulate_weight_grad(x, dy, k, sms)
    want_w, want_b = c3d.conv3d_weight_grad_plain(x, dy, k)
    assert torch.equal(covered, torch.ones_like(covered)), "the centre tap's voxels once each"
    scale = float(want_w.abs().max())
    assert float((got_w - want_w.double()).abs().max()) <= 1e-4 * scale
    assert float((got_b - want_b.double()).abs().max()) <= 1e-5 * float(want_b.abs().max())


# the torso step's distinct 3D convs (standard preset, batch 4) and the test
# shapes: the plan stays inside the kernel's limits
@pytest.mark.parametrize("xs,co,k", [
    ((4, 89, 16, 64, 64), 32, 7), ((4, 32, 16, 64, 64), 5, 7), ((4, 32, 16, 64, 64), 32, 3),
    ((4, 64, 16, 64, 64), 32, 3), ((4, 64, 16, 32, 32), 128, 3), ((4, 128, 16, 16, 16), 256, 3),
    ((4, 256, 16, 8, 8), 512, 3), ((4, 1024, 16, 4, 4), 512, 3), ((4, 512, 16, 4, 4), 1024, 3),
    ((4, 25, 16, 64, 64), 64, 3), ((1, 5, 2, 7, 9), 5, 7), ((2, 33, 3, 5, 130), 33, 3),
    ((1, 3, 1, 1, 1), 2, 3), ((1, 8, 2, 3, 1000), 16, 7)])
def test_k7a_weight_grad_plan_within_the_kernel(xs, co, k):
    b, ci, d, h, w = xs
    for sms in (1, 132):
        plan = c3d.conv3d_weight_grad_plan(b, ci, co, d, h, w, k, sms)
        sw, r, nseg = plan["SW"], plan["R"], plan["nseg"]
        lay = c3d.conv3d_weight_grad_layout(k, plan["BN"], plan["VP"], sw, r)
        assert 1 <= r <= 128 and r * sw <= max(c3d.WGRAD_BRICK, sw)
        assert lay["smem"] <= c3d.WGRAD_SMEM or r == 1
        assert nseg * sw >= w and (nseg - 1) * sw < w
        assert not plan["vec"] or (w % 4 == 0 and sw % 4 == 0)
        assert 1 <= plan["n_split"] <= 65535
        assert plan["BN"] == (8 if co <= 8 else 32) and plan["VP"] == (2 if k == 3 else 1)
        assert lay["CS"] % 8 == 4 and lay["DS"] % 8 == 4 and lay["RS"] % 4 == 0
        assert (lay["OFF"] + k // 2) % 4 == 0 and lay["RS"] >= lay["OFF"] + sw + k - 1

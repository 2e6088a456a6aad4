"""K1 / K1-trigrid's backward kernel on the CPU: its arithmetic, emulated
lane by lane as ``csrc/triplane_decode.cu`` ``plane_decode_backward_kernel``
runs it, held to ``decode_backward_plain`` (which
``tests/test_torch_train_backward.py`` holds to autograd).

The kernel packs the four products' B fragments from the plain folded
weights at each CTA's start; the packing is mirrored here loop for loop
(``_packs``) and its first two packs must equal the forward's
(``pack_decoder_mlp``). A warp tile of 16 points then runs the products on
``mma.sync.m16n8k8`` fragments (lane = 4 g + t: A a0..a3 at (g, t), (g + 8,
t), (g, t + 4), (g + 8, t + 4); B b0, b1 at (k t, n g), (k t + 4, n g); C
c0..c3 at (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)), each
accumulator handed on as the next product's A fragment as it lies, and the
weight gradients leave through the kernel's map of its 45 m16n8 tiles onto
d W1, d b1, d W0 and d b0.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from real3dportrait_tpu_torch.models.decoder import (
    OSGDecoder,
    _plane_corners,
    _tf32,
    _trigrid_corners,
    decode_backward_plain,
    pack_decoder_mlp,
)
from real3dportrait_tpu_torch.rendering.renderer import _PLANE_PERMS
from real3dportrait_tpu_torch.weights import mock_init_

LANE = torch.arange(32)
G, T = LANE // 4, LANE % 4


def _frag(b0: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """bw_frag: (hi0, hi1, lo0, lo1), both parts rounded to TF32."""
    h0, h1 = _tf32(b0), _tf32(b1)
    return torch.stack((h0, h1, _tf32(b0 - h0), _tf32(b1 - h1)), dim=-1)


def _packs(w0, b0, w1, b1):
    """The kernel's shared-memory packs, as its start-up loops build them."""
    def w1p(r, c):
        rows = torch.cat((w1[1:], w1[:1], torch.zeros((7, 64))))
        return rows[r, c]

    i = torch.arange(1024)
    lane, s, j = i % 32, i // 256, i // 32 % 8
    g, t = lane // 4, lane % 4
    p1 = _frag(w0[8 * j + g, 8 * s + t], w0[8 * j + g, 8 * s + t + 4])
    jj, q = i // 128, i // 32 % 4
    p4 = _frag(w0[8 * jj + 2 * t, 8 * q + g], w0[8 * jj + 2 * t + 1, 8 * q + g])
    i = torch.arange(1280)
    lane, j, m = i % 32, i // 160, i // 32 % 5
    g, t = lane // 4, lane % 4
    p2 = _frag(w1p(8 * m + g, 8 * j + 2 * t), w1p(8 * m + g, 8 * j + 2 * t + 1))
    mm, jj = i // 256, i // 32 % 8
    p3 = _frag(w1p(8 * mm + 2 * t, 8 * jj + g), w1p(8 * mm + 2 * t + 1, 8 * jj + g))
    b1p = torch.cat((b1[1:], b1[:1], torch.zeros(7)))
    return p1, p2, p3, p4, b0.clone(), b1p


def _a_matrix(a: torch.Tensor) -> torch.Tensor:
    """[32, 4] A fragments -> the [16, 8] tile."""
    m = torch.zeros((16, 8), dtype=a.dtype)
    m[G, T], m[G + 8, T], m[G, T + 4], m[G + 8, T + 4] = a[:, 0], a[:, 1], a[:, 2], a[:, 3]
    return m


def _b_matrix(b0: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    m = torch.zeros((8, 8), dtype=b0.dtype)
    m[T, G], m[T + 4, G] = b0, b1
    return m


def _c_lanes(c: torch.Tensor) -> torch.Tensor:
    return torch.stack((c[G, 2 * T], c[G, 2 * T + 1], c[G + 8, 2 * T], c[G + 8, 2 * T + 1]), 1)


def _c_matrix(c: torch.Tensor) -> torch.Tensor:
    m = torch.zeros((16, 8), dtype=c.dtype)
    m[G, 2 * T], m[G, 2 * T + 1], m[G + 8, 2 * T], m[G + 8, 2 * T + 1] = c.unbind(1)
    return m


def _mma_split(c: torch.Tensor, a: torch.Tensor, frag: torch.Tensor) -> torch.Tensor:
    """mma_split_tf32: c += a b, a [32, 4] fp32 split here, b a [32] slice
    of float4 fragments, split beforehand; float64 sums."""
    ah = _tf32(a)
    al = _tf32(a - ah)
    bh = _b_matrix(frag[:, 0], frag[:, 1]).double()
    bl = _b_matrix(frag[:, 2], frag[:, 3]).double()
    ah, al = _a_matrix(ah).double(), _a_matrix(al).double()
    return c + _c_lanes(al @ bh + ah @ bl + ah @ bh)


def _perm(acc: torch.Tensor) -> torch.Tensor:
    """An accumulator handed on as the next A fragment: (c0, c2, c1, c3)."""
    return acc[:, [0, 2, 1, 3]].float()


def _split2(a: torch.Tensor):
    hi = _tf32(a)
    return hi.double(), _tf32(a - hi).double()


def emulate_backward(planes, coords, box_warp, w0, b0, w1, b1, drgb, dsigma):
    """(d planes, d w0, d b0, d w1, d b1) as the kernel computes them."""
    grid = planes.dim() == 6
    bsz, c = planes.shape[0], planes.shape[-1]
    m_pts = coords.shape[1]
    p1, p2, p3, p4, sb0, sb1 = _packs(w0, b0, w1, b1)
    cs = (2.0 / box_warp) * coords
    rows = planes.reshape(bsz, 3, -1, c)
    feats = torch.zeros((bsz, m_pts, c))
    corners = []
    for k, perm in enumerate(_PLANE_PERMS):
        if grid:
            idx, wts = _trigrid_corners((bsz,) + tuple(planes.shape[2:]), cs[..., list(perm)])
        else:
            idx, wts = _plane_corners((bsz,) + tuple(planes.shape[2:]), cs[..., list(perm[:2])])
        corners.append((idx, wts))
        for j in range(idx.shape[0]):
            feats = feats + torch.gather(rows[:, k], 1, idx[j][..., None].expand(-1, -1, c)) \
                * wts[j][..., None]
    f_all = (feats / 3).reshape(-1, c)
    total = f_all.shape[0]
    n_tiles = math.ceil(total / 16)
    dsig_all = None if dsigma is None else dsigma.reshape(-1)
    drgb_all = None if drgb is None else drgb.reshape(-1, 32)
    df_all = torch.zeros((n_tiles * 16, c))
    dw1t = torch.zeros((80, 40), dtype=torch.float64)  # [h | 1]^T dout
    dw0a = torch.zeros((64, 40), dtype=torch.float64)  # dh'^T [f | 1]
    for tile in range(n_tiles):
        n = tile * 16 + torch.arange(16)
        valid = n < total
        f = torch.zeros((16, 40))
        f[valid, :32] = f_all[n[valid]]
        f[:, 32] = 1.0
        hid = [torch.zeros((32, 4), dtype=torch.float64) for _ in range(8)]
        for s in range(4):
            a = torch.stack((f[G, 8 * s + T], f[G + 8, 8 * s + T], f[G, 8 * s + T + 4],
                             f[G + 8, 8 * s + T + 4]), 1)
            for j in range(8):
                hid[j] = _mma_split(hid[j], a, p1[(s * 8 + j) * 32:(s * 8 + j + 1) * 32])
        col = lambda base: base + 2 * T[:, None] + torch.tensor([0, 1, 0, 1])  # noqa: E731
        row = G[:, None] + 8 * torch.tensor([0, 0, 1, 1])
        hsp, slope = [], []
        for j in range(8):
            v = (hid[j] + sb0[col(8 * j)].double()).float()
            hsp.append(F.softplus(v))
            slope.append(torch.sigmoid(v))
        out = [torch.zeros((32, 4), dtype=torch.float64) for _ in range(5)]
        for j in range(8):
            a = _perm(hsp[j].double())
            for m in range(5):
                out[m] = _mma_split(out[m], a, p2[(j * 5 + m) * 32:(j * 5 + m + 1) * 32])
        dout = []
        for m in range(5):
            cc, rr = col(8 * m), row
            d = torch.zeros((32, 4))
            ok = valid[rr]
            if drgb_all is not None:
                sg = torch.sigmoid((out[m] + sb1[cc.clamp(max=39)].double()).float())
                rgb = (cc < 32) & ok
                g_in = drgb_all[n[rr].clamp(max=total - 1), cc.clamp(max=31)]
                d = torch.where(rgb, g_in * (1 + 2 * 0.001) * (sg * (1 - sg)), d)
            if dsig_all is not None:
                sig = (cc == 32) & ok
                d = torch.where(sig, dsig_all[n[rr].clamp(max=total - 1)], d)
            dout.append(d)
        dh = [torch.zeros((32, 4), dtype=torch.float64) for _ in range(8)]
        for m in range(5):
            a = dout[m][:, [0, 2, 1, 3]]
            for j in range(8):
                dh[j] = _mma_split(dh[j], a, p3[(m * 8 + j) * 32:(m * 8 + j + 1) * 32])
        dh = [(d.float() * s) for d, s in zip(dh, slope)]
        df = [torch.zeros((32, 4), dtype=torch.float64) for _ in range(4)]
        for j in range(8):
            a = dh[j][:, [0, 2, 1, 3]]
            for q in range(4):
                df[q] = _mma_split(df[q], a, p4[(j * 4 + q) * 32:(j * 4 + q + 1) * 32])
        df_all[tile * 16:tile * 16 + 16] = torch.cat([_c_matrix(d) for d in df], 1).float() / 3
        # the slot's operands, then the weight-gradient products over its points
        h_aug = torch.zeros((16, 80))
        h_aug[:, :64] = torch.cat([_c_matrix(h) for h in hsp], 1)
        h_aug[:, 64] = 1.0
        o_mat = torch.cat([_c_matrix(d) for d in dout], 1)
        d_mat = torch.cat([_c_matrix(d) for d in dh], 1)
        (ah, al), (bh, bl) = _split2(h_aug.T.contiguous()), _split2(o_mat)
        dw1t += al @ bh + ah @ bl + ah @ bh
        (ah, al), (bh, bl) = _split2(d_mat.T.contiguous()), _split2(f)
        dw0a += al @ bh + ah @ bl + ah @ bh
    # the kernel's map of its 45 tiles onto the gradients
    dw0, db0 = torch.zeros((64, 32)), torch.zeros(64)
    dw1, db1 = torch.zeros((33, 64)), torch.zeros(33)
    for tt in range(45):
        first = tt < 25
        mi, ni = divmod(tt if first else tt - 25, 5)
        for i in range(4):
            r = 16 * mi + G + 8 * (i // 2)
            cl = 8 * ni + 2 * T + i % 2
            for rv, cv in zip(r.tolist(), cl.tolist()):
                if first:
                    if rv > 64 or cv > 32:
                        continue
                    o = cv + 1 if cv < 32 else 0
                    if rv < 64:
                        dw1[o, rv] += float(dw1t[rv, cv])
                    else:
                        db1[o] += float(dw1t[rv, cv])
                elif cv < 32:
                    dw0[rv, cv] += float(dw0a[rv, cv])
                elif cv == 32:
                    db0[rv] += float(dw0a[rv, cv])
    # the scatter: df / 3 into each plane's corners by the forward's rules
    dfp = df_all[:total].reshape(bsz, m_pts, c)
    drows = torch.zeros_like(rows)
    for k, (idx, wts) in enumerate(corners):
        for j in range(idx.shape[0]):
            drows[:, k].scatter_add_(1, idx[j][..., None].expand(-1, -1, c),
                                     dfp * wts[j][..., None])
    return drows.reshape(planes.shape), dw0, db0, dw1, db1


def _case(grid: bool, b: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    shape = (b, 3, 3, 6, 5, 32) if grid else (b, 3, 7, 6, 32)
    planes = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    coords = torch.from_numpy((rng.random((b, n, 3), dtype=np.float32) - 0.5) * 1.4)
    dec = mock_init_(OSGDecoder(32, 64, 32), torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for p in (dec.net0.bias, dec.net1.bias):
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape, dtype=np.float32)))
    ws = [t.detach() for t in (*dec.net0.folded(), *dec.net1.folded())]
    drgb = torch.from_numpy(rng.standard_normal((b, n, 32), dtype=np.float32))
    dsig = torch.from_numpy(rng.standard_normal((b, n, 1), dtype=np.float32))
    return planes, coords, ws, drgb, dsig


def test_k1_backward_packs_extend_the_forward_packs():
    _, _, ws, _, _ = _case(True, 1, 4, 0)
    p1, p2, p3, p4, sb0, sb1 = _packs(*ws)
    fwd = pack_decoder_mlp(*ws)
    torch.testing.assert_close(torch.cat((p1.flatten(), p2.flatten(), sb0, sb1)), fwd,
                               rtol=0, atol=0)
    assert int((torch.cat((p3, p4)).view(torch.int32) & 0x1FFF).abs().max()) == 0


# tri-grids and tri-planes, B = 2 and a ragged last tile (41 points: two
# whole tiles and 9), and each output gradient alone
@pytest.mark.parametrize("grid,b,n,which", [(True, 2, 41, "both"), (False, 2, 41, "both"),
                                            (True, 1, 16, "rgb"), (False, 1, 23, "sigma")])
def test_k1_backward_emulation_matches_plain(grid, b, n, which):
    planes, coords, ws, drgb, dsig = _case(grid, b, n, 5)
    drgb = None if which == "sigma" else drgb
    dsig = None if which == "rgb" else dsig
    got = emulate_backward(planes, coords, 1.0, *ws, drgb, dsig)
    want = decode_backward_plain(planes, coords, 1.0, *ws, drgb, dsig)
    for name, g, w in zip(("d planes", "d w0", "d b0", "d w1", "d b1"), got, want):
        scale = max(float(w.abs().max()), 1e-30)
        err = float((g.double() - w.double()).abs().max()) / scale
        assert err <= 1e-4, f"{name}: {err:.3e}"

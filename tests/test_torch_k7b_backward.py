"""K7b's backward on the CPU: the decomposition of ``csrc/conv3d.cu``
``tail_dgrad_kernel`` (the tail's whole data gradient) and
``occ_wgrad_kernel`` (the occlusion heads' weight gradient), emulated here
with ``models/torso.py:mfe_tail_backward_layout`` and held to the
convolutions' gradients in ``mfe_tail_backward_plain``
(``torch.nn.grad``; ``tests/test_torch_torso_backward.py`` holds the plain
version to autograd, ``test_torch_torso_grads.py`` the model to JAX).

The data-gradient emulation walks the kernel's grid: a CTA 4 rows x 64
columns of one (b, d) plane and one block of 32 channels, a step for each
depth tap whose plane lies inside the volume and one for the heads; a
step's halo tile staged at the kernel's row and channel strides; the (k,
tap) slots addressed through the per-lane offset table the kernel builds,
the B fragments unpacked from the weights packed as ``tail_pack_weight``
packs them (flipped taps, k-major slots); each warp's
32 voxels x 32 channels summed as its two m16 by four n8 tiles would be, in
float64 (the split-TF32 products themselves are emulated for K7a in
``tests/test_torch_k7a_wgrad.py``). The heads' weight-gradient emulation
walks its CTAs (32 fold channels, a share of the pixel units), stages a
unit's halo and slides each tap row along it as a thread does.
"""

import math

import numpy as np
import pytest
import torch

from real3dportrait_tpu_torch.models import torso

torch.set_num_threads(1)

# csrc/conv3d.cu: kTgTH, kTgTW, kTgRS, kTgCS
TH, TW, RS, CS = 4, 64, 80, 816


def _table(n_pairs: int, nks: int) -> np.ndarray:
    """The kernel's offset table: entry ks * 4 + t holds the stage offsets
    of slots 8 ks + t and 8 ks + t + 4 (channel-major, taps fastest; a
    padding slot reads the last pair's word)."""
    tab = np.zeros((nks * 4, 2), np.int64)
    for q in range(nks * 4):
        for h in range(2):
            s = min((q // 4) * 8 + q % 4 + 4 * h, n_pairs - 1)
            tab[q, h] = (s // 49) * CS + (s % 49 // 7) * RS + s % 7
    return tab


def _pack(mask_w: np.ndarray, occ_w: np.ndarray, c: int, d: int) -> np.ndarray:
    """tail_pack_weight: [n_cb, steps, nt, lane, 2] (the hi/lo split left
    out): lane (g, t) of n8 tile nt at step (depth tap j, k-step ks) or
    (depth, k-step) holds slots 8 ks + t and + 4 of channel 32 cb + 8 nt + g."""
    lay = torso.mfe_tail_backward_layout(c, d, 1, 8, 8, 132)
    steps = 7 * torso.TAIL_MASK_KS + d * torso.TAIL_OCC_KS
    out = np.zeros((lay["n_cb"], steps, 4, 32, 2))
    assert out.size * 2 == lay["pack_floats"]
    mflat, oflat = mask_w.reshape(-1), occ_w.reshape(-1)
    for cb in range(lay["n_cb"]):
        for step in range(steps):
            for nt in range(4):
                for lane in range(32):
                    ch, t = cb * torso.TAIL_N + 8 * nt + lane // 4, lane % 4
                    for h in range(2):
                        if ch >= c:
                            continue
                        if step < 7 * torso.TAIL_MASK_KS:
                            j, s = step // torso.TAIL_MASK_KS, \
                                (step % torso.TAIL_MASK_KS) * 8 + t + 4 * h
                            if s < 5 * 49:
                                k, tap = s // 49, s % 49
                                out[cb, step, nt, lane, h] = \
                                    mflat[((k * c + ch) * 7 + 6 - j) * 49 + 48 - tap]
                        else:
                            q = step - 7 * torso.TAIL_MASK_KS
                            dd = q // torso.TAIL_OCC_KS
                            s = (q % torso.TAIL_OCC_KS) * 8 + t + 4 * h
                            if s < 2 * 49:
                                out[cb, step, nt, lane, h] = \
                                    oflat[((s // 49) * c * d + ch * d + dd) * 49 + 48 - s % 49]
    return out


def emulate_tail_dgrad(dl: np.ndarray, dp: np.ndarray, mask_w: np.ndarray,
                       occ_w: np.ndarray) -> np.ndarray:
    b_, _, d_, h_, w_ = dl.shape
    c = mask_w.shape[1]
    packed = _pack(mask_w, occ_w, c, d_)
    tab_m, tab_o = _table(5 * 49, torso.TAIL_MASK_KS), _table(2 * 49, torso.TAIL_OCC_KS)
    dx = np.full((b_, c, d_, h_, w_), np.nan)
    for b in range(b_):
        for d in range(d_):
            j_lo, j_hi = max(0, 3 - d), min(6, d_ + 2 - d)
            n_mask = j_hi - j_lo + 1
            for h0 in range(0, h_, TH):
                for w0 in range(0, w_, TW):
                    for cb in range(packed.shape[0]):
                        acc = np.zeros((8, 32, 32))
                        for n in range(n_mask + 1):
                            occ = n == n_mask
                            src = dp[b] if occ else dl[b, :, d + j_lo + n - 3]
                            stage = np.full(5 * CS, np.nan)
                            for ch in range(src.shape[0]):
                                for i in range(TH + 6):
                                    for jj in range(TW + 6):
                                        gy, gx = h0 - 3 + i, w0 - 3 + jj
                                        ok = 0 <= gy < h_ and 0 <= gx < w_
                                        stage[ch * CS + i * RS + jj] = src[ch, gy, gx] if ok \
                                            else 0.0
                            tab = tab_o if occ else tab_m
                            nks = len(tab) // 4
                            first = 7 * torso.TAIL_MASK_KS + d * torso.TAIL_OCC_KS if occ \
                                else (j_lo + n) * torso.TAIL_MASK_KS
                            pk = packed[cb, first:first + nks]  # [ks, nt, lane, 2]
                            bm = np.zeros((8 * nks, 32))        # B [slot][channel]
                            off = np.zeros(8 * nks, np.int64)   # slot -> stage offset
                            for t in range(4):
                                for g in range(8):
                                    lane = 4 * g + t
                                    for nt in range(4):
                                        bm[8 * np.arange(nks) + t, 8 * nt + g] = pk[:, nt, lane, 0]
                                        bm[8 * np.arange(nks) + t + 4, 8 * nt + g] = \
                                            pk[:, nt, lane, 1]
                                off[8 * np.arange(nks) + t] = tab[4 * np.arange(nks) + t, 0]
                                off[8 * np.arange(nks) + t + 4] = tab[4 * np.arange(nks) + t, 1]
                            for warp in range(8):
                                row, col0 = warp >> 1, (warp & 1) * 32
                                am = stage[row * RS + col0 + np.arange(32)[:, None] + off[None]]
                                acc[warp] += am @ bm
                        for warp in range(8):
                            row, col0 = warp >> 1, (warp & 1) * 32
                            h = h0 + row
                            for m in range(32):
                                w = w0 + col0 + m
                                for n_ in range(32):
                                    ch = cb * torso.TAIL_N + n_
                                    if h < h_ and w < w_ and ch < c:
                                        dx[b, ch, d, h, w] = acc[warp, m, n_]
    return dx


def _tail_inputs(b, c, d, h, w, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, 5, d, h, w), rng.randn(b, 2, h, w), rng.randn(5, c, 7, 7, 7),
            rng.randn(2, c * d, 7, 7))


@pytest.mark.parametrize("b,c,d,h,w", [(2, 5, 2, 5, 9), (1, 37, 4, 6, 70)],
                         ids=["tiny_depth_ragged_rows", "two_channel_blocks_two_column_tiles"])
def test_tail_dgrad_emulation_matches_plain(b, c, d, h, w):
    # float64 on both sides: only the order of the sums differs, 1e-12 of scale
    dl, dp, mask_w, occ_w = _tail_inputs(b, c, d, h, w, seed=c)
    got = emulate_tail_dgrad(dl, dp, mask_w, occ_w)
    assert np.isfinite(got).all()   # every element of dx written, no NaN of the stage read
    td = torch.from_numpy
    want = torch.nn.grad.conv3d_input((b, c, d, h, w), td(mask_w), td(dl), padding=3) \
        + torch.nn.grad.conv2d_input((b, c * d, h, w), td(occ_w), td(dp),
                                     padding=3).reshape(b, c, d, h, w)
    want = want.numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_tail_dgrad_table_fragment_loads_hit_32_banks():
    # every A fragment load of a warp (lanes (g, t): voxel column g, slot t
    # or t + 4) reads 32 distinct banks or the same word
    for n_pairs, nks in ((5 * 49, torso.TAIL_MASK_KS), (2 * 49, torso.TAIL_OCC_KS)):
        tab = _table(n_pairs, nks)
        for ks in range(nks):
            for h in range(2):
                words = {int(tab[ks * 4 + t, h]) + g for g in range(8) for t in range(4)}
                banks = [w_ % 32 for w_ in words]
                assert len(set(banks)) == len(banks), (n_pairs, ks, h)


def emulate_occ_wgrad(fold: np.ndarray, dp: np.ndarray, n_split: int):
    """occ_wgrad_kernel: (d occ_w [2,CD,7,7], d occ_b [2])."""
    b_, cd_, h_, w_ = fold.shape
    nrow, ncol = math.ceil(h_ / torso.TAIL_OCC_ROWS), math.ceil(w_ / torso.TAIL_OCC_TW)
    units = b_ * nrow * ncol
    rows, cols, ncd = torso.TAIL_OCC_ROWS, torso.TAIL_OCC_TW, torso.TAIL_OCC_CD
    dw, db = np.zeros((2, cd_, 7, 7)), np.zeros(2)
    seen = np.zeros(units, np.int64)
    for cdb in range(math.ceil(cd_ / ncd)):
        for y in range(n_split):
            acc = np.zeros((7, ncd, 2, 7))  # [ty (warp), lane, head, tx]
            for u in range(units * y // n_split, units * (y + 1) // n_split):
                if cdb == 0:
                    seen[u] += 1
                b, rc = u // (nrow * ncol), u % (nrow * ncol)
                y0, x0 = rc // ncol * rows, rc % ncol * cols
                sx = np.zeros((ncd, rows + 6, cols + 6))
                sdp = np.zeros((2, rows, cols))
                for c in range(ncd):
                    for i in range(rows + 6):
                        for jj in range(cols + 6):
                            gy, gx = y0 - 3 + i, x0 - 3 + jj
                            if cdb * ncd + c < cd_ and 0 <= gy < h_ and 0 <= gx < w_:
                                sx[c, i, jj] = fold[b, cdb * ncd + c, gy, gx]
                for i in range(rows):
                    for jj in range(cols):
                        if y0 + i < h_ and x0 + jj < w_:
                            sdp[:, i, jj] = dp[b, :, y0 + i, x0 + jj]
                for ty in range(7):
                    for r in range(rows):
                        for c0 in range(0, cols, 8):
                            xv = sx[:, r + ty, c0:c0 + 14]
                            for tx in range(7):
                                acc[ty, :, :, tx] += xv[:, tx:tx + 8] @ sdp[:, r, c0:c0 + 8].T
                if cdb == 0:
                    db += sdp.sum(axis=(1, 2))
            for lane in range(ncd):
                cd = cdb * ncd + lane
                if cd < cd_:
                    dw[:, cd] += acc[:, lane].transpose(1, 0, 2)
    assert (seen == 1).all()  # the shares cover every unit once
    return dw, db


@pytest.mark.parametrize("b,cd,h,w,sms", [(2, 10, 5, 9, 4), (1, 40, 9, 70, 3)],
                         ids=["one_cd_block_ragged", "two_cd_blocks_two_column_tiles"])
def test_occ_wgrad_emulation_matches_plain(b, cd, h, w, sms):
    rng = np.random.RandomState(cd)
    fold, dp = rng.randn(b, cd, h, w), rng.randn(b, 2, h, w)
    lay = torso.mfe_tail_backward_layout(cd, 1, b, h, w, sms)
    got_w, got_b = emulate_occ_wgrad(fold, dp, lay["n_split"])
    td = torch.from_numpy
    want_w = torch.nn.grad.conv2d_weight(td(fold), (2, cd, 7, 7), td(dp), padding=3).numpy()
    assert np.abs(got_w - want_w).max() <= 1e-12 * np.abs(want_w).max()
    assert np.abs(got_b - dp.sum(axis=(0, 2, 3))).max() <= 1e-12 * np.abs(dp).sum()


def test_mfe_tail_backward_layout():
    # the torso step's x [4,32,16,64,64] on 132 SMs: one channel block, the
    # mask conv's 7 depth taps and 16 depths of the heads packed (850 KB),
    # 64 pixel units shared by 16 CTAs of each 32 of the 512 fold channels
    # (256 CTAs, two an SM at most: one wave)
    lay = torso.mfe_tail_backward_layout(32, 16, 4, 64, 64, 132)
    assert lay == dict(n_cb=1, pack_floats=4 * (7 * 31 + 16 * 13) * 128, units=64, n_split=16)
    # the tiny preset: at least two units a CTA
    lay = torso.mfe_tail_backward_layout(4, 2, 1, 16, 16, 132)
    assert lay["units"] == 4 and lay["n_split"] == 2 and lay["n_cb"] == 1

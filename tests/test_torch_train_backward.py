"""The plain versions of the four backward kernels (K1-trigrid, K3, K6a,
K6b) against ``torch.autograd`` through their plain forwards, in float64 at
1e-6 of each gradient's largest magnitude, with K6a's and K6b's second
derivatives; the CUDA kernels are held to these plain versions on the card
(``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py``)."""

import numpy as np
import pytest
import torch

from real3dportrait_tpu_torch.models import decoder as dm
from real3dportrait_tpu_torch.ops import bias_act as ba
from real3dportrait_tpu_torch.ops import upfirdn2d as ufd
from real3dportrait_tpu_torch.rendering import renderer as rr
from tests._torch_parity import agree

torch.set_num_threads(1)
f64 = torch.float64


def _randn(rng, *shape):
    return torch.from_numpy(rng.randn(*shape)).to(f64)


@pytest.mark.parametrize("act,clamp,terms", [
    ("lrelu", 256.0, "scale+noise"), ("lrelu", 0.5, "none"), ("relu", None, "scale"),
    ("linear", 0.7, "noise"), ("lrelu", None, "flat")])
def test_bias_act_grad_plain_matches_autograd(act, clamp, terms):
    rng = np.random.RandomState(0)
    flat = terms == "flat"
    x = _randn(rng, 6, 5) if flat else _randn(rng, 2, 3, 5, 4)
    c = x.shape[1]
    b = _randn(rng, c) * 0.3
    scale = _randn(rng, 2, c).abs() + 0.5 if "scale" in terms else None
    noise = _randn(rng, 5, 4) * 0.2 if "noise" in terms else None
    leaves = [t for t in (x, b, scale, noise) if t is not None]
    for t in leaves:
        t.requires_grad_(True)
    axis = -1 if flat else 1
    y = ba.bias_act_plain(x, b, act=act, clamp=clamp, axis=axis, scale=scale, noise=noise)
    dy = _randn(rng, *y.shape)
    want = torch.autograd.grad(y, leaves, dy)
    got = ba.bias_act_grad_plain(dy, y.detach(), x.detach(), act, None, clamp, axis, scale,
                                 need_b=True, need_noise=noise is not None)
    got = [got[0], got[1]] + ([got[2]] if scale is not None else []) + \
        ([got[3]] if noise is not None else [])
    for g, w, name in zip(got, want, ("dx", "db", "dscale/dnoise", "dnoise")):
        agree(g, w, 1e-6, 1e-7, name)


@pytest.mark.parametrize("act,clamp", [("lrelu", 256.0), ("lrelu", 0.5), ("linear", None)])
def test_bias_act_second_derivative(act, clamp):
    """R1's double backward: the gradient of the gradient with respect to
    ``dy`` is the gradient kernel again (``_BiasActGrad``, which takes the
    plain version on CPU tensors) on ``ddx + ddb``, against autograd's
    double backward of the plain forward."""
    rng = np.random.RandomState(1)
    x = _randn(rng, 2, 3, 5, 4).requires_grad_(True)
    b = (_randn(rng, 3) * 0.3).requires_grad_(True)
    y = ba.bias_act_plain(x, b, act=act, clamp=clamp, axis=1)
    dy = _randn(rng, *y.shape).requires_grad_(True)
    gx, gb = torch.autograd.grad(y, (x, b), dy, create_graph=True)
    vx, vb = _randn(rng, *gx.shape), _randn(rng, 3)
    want = torch.autograd.grad((gx * vx).sum() + (gb * vb).sum(), dy)[0]
    g = ba.ACTIVATIONS[act].def_gain
    dx, db, _, _ = ba._BiasActGrad.apply(dy, y.detach(), None, None, act, g, clamp, 1, True,
                                         False, False)
    got = torch.autograd.grad((dx * vx).sum() + (db * vb).sum(), dy)[0]
    agree(got, want, 1e-6, 1e-7, "d dy")


@pytest.mark.parametrize("up,down,pad,shape", [
    (1, 1, (2, 1, 2, 1), (2, 3, 9, 11)),      # the SR block's FIR after the up-conv
    (2, 1, (2, 1, 2, 1), (2, 3, 8, 7)),       # the skip image's x2 upsample
    (1, 1, (2, 2, 2, 2), (2, 3, 10, 10)),     # the discriminator's FIR before a stride 2
    (1, 2, (1, 1, 1, 1), (1, 2, 9, 8)),       # a downsample
    (2, 2, (1, 2, 0, 3), (1, 2, 6, 5))])
def test_upfirdn2d_backward_plain_matches_autograd(up, down, pad, shape):
    rng = np.random.RandomState(2)
    f = ufd.setup_filter([1, 3, 3, 1]).to(f64) * torch.from_numpy(
        1 + 0.1 * rng.rand(4, 4)).to(f64)         # not symmetric: flips show
    x = _randn(rng, *shape).requires_grad_(True)
    y = ufd.upfirdn2d_plain(x, f, up=up, down=down, padding=pad, gain=up * up)
    dy = _randn(rng, *y.shape)
    want = torch.autograd.grad(y, x, dy)[0]
    got = ufd.upfirdn2d_backward_plain(dy, f, up, down, pad, up * up, tuple(shape[-2:]))
    agree(got, want, 1e-6, 1e-7, "dx")
    # the adjoint's adjoint is the forward again: the second derivative
    # (K6a's backward through itself) computes the original call (a
    # trailing pad that the downsampling drops may differ)
    in_hw, out_hw = tuple(shape[-2:]), tuple(y.shape[-2:])
    back = ufd.adjoint_padding(f, up, down, pad, in_hw, out_hw)
    again = ufd.adjoint_padding(torch.flip(f, (0, 1)), down, up, back, out_hw, in_hw)
    y2 = ufd.upfirdn2d_plain(x.detach(), f, up=up, down=down, padding=again, gain=up * up)
    agree(y2, y.detach(), 1e-12, 1e-13, "the adjoint's adjoint")


def _decoder(rng):
    dec = dm.OSGDecoder(32, 64, 32, lr_multiplier=0.7).to(f64)
    with torch.no_grad():
        for p in dec.parameters():
            p.copy_(_randn(rng, *p.shape) * 0.5)
    return dec


def test_trigrid_decode_backward_plain_matches_autograd():
    """Grids, coordinates partly outside (zero padding), both outputs'
    gradients, and the folded weights' gradients mapped through the
    equalised-LR gains to the parameters'."""
    rng = np.random.RandomState(3)
    dec = _decoder(rng)
    planes = _randn(rng, 2, 3, 3, 5, 6, 32).requires_grad_(True)
    coords = torch.from_numpy(rng.uniform(-0.6, 0.6, (2, 40, 3)))
    rgb, sigma = dm.trigrid_decode_plain(planes, coords, 1.0, dec)
    drgb, dsig = _randn(rng, *rgb.shape), _randn(rng, *sigma.shape)
    params = [dec.net0.weight, dec.net0.bias, dec.net1.weight, dec.net1.bias]
    want = torch.autograd.grad((rgb, sigma), [planes] + params, (drgb, dsig), retain_graph=True)
    w0, b0 = dec.net0.folded()
    w1, b1 = dec.net1.folded()
    got = dm.decode_backward_plain(planes.detach(), coords, 1.0, w0.detach(),
                                           b0.detach(), w1.detach(), b1.detach(), drgb, dsig)
    gains = [dec.net0.weight_gain, dec.net0.lr_multiplier, dec.net1.weight_gain,
             dec.net1.lr_multiplier]
    agree(got[0], want[0], 1e-6, 1e-7, "d planes")
    for g, w, gain, name in zip(got[1:], want[1:], gains, ("w0", "b0", "w1", "b1")):
        agree(g * gain, w, 1e-6, 1e-7, name)
    # one output's gradient alone (the other None)
    want = torch.autograd.grad(sigma, planes, dsig)[0]
    got = dm.decode_backward_plain(planes.detach(), coords, 1.0, w0.detach(),
                                           b0.detach(), w1.detach(), b1.detach(), None, dsig)
    agree(got[0], want, 1e-6, 1e-7, "d planes (sigma only)")


@pytest.mark.parametrize("white_back", [False, True])
def test_merge_composite_backward_plain_matches_autograd(white_back):
    """Two sorted sample lists with ties between them, the gradients of
    rgb, depth and weights at once."""
    rng = np.random.RandomState(4)
    b, m, s1, s2, c = 2, 5, 7, 6, 8
    d1 = torch.from_numpy(np.sort(rng.uniform(1, 2, (b, m, s1, 1)), axis=2))
    d2 = torch.from_numpy(np.sort(rng.uniform(1, 2, (b, m, s2, 1)), axis=2))
    d2[:, :, 2] = d1[:, :, 3]                      # a tie: the coarse sample first
    d2 = torch.sort(d2, dim=2).values
    c1, c2 = _randn(rng, b, m, s1, c), _randn(rng, b, m, s2, c)
    sg1, sg2 = _randn(rng, b, m, s1, 1) * 3, _randn(rng, b, m, s2, 1) * 3
    leaves = [c1, sg1, c2, sg2]
    for t_ in leaves:
        t_.requires_grad_(True)
    rgb, depth, weights = rr.merge_composite_plain(d1, c1, sg1, d2, c2, sg2, white_back)
    grads = [_randn(rng, *t_.shape) for t_ in (rgb, depth, weights)]
    want = torch.autograd.grad((rgb, depth, weights), leaves, grads)
    got = rr.merge_composite_backward_plain(d1, *(t_.detach() for t_ in (c1, sg1)), d2,
                                            *(t_.detach() for t_ in (c2, sg2)), white_back,
                                            *grads)
    for g, w, name in zip(got, want, ("d colours1", "d densities1", "d colours2",
                                      "d densities2")):
        agree(g, w, 1e-6, 1e-7, name)

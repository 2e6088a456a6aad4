"""The plain versions of this slice's backward kernels against
``torch.autograd`` through their plain forwards, in float64 at 1e-6 of each
gradient's largest magnitude: K1 on tri-planes, K5a's and K5b's trilinear
adjoints, K7a's weight, bias and data gradients, and K7b's (the softmax,
the deformation sum and both occlusion heads). The CUDA kernels are held to
these plain versions on the card (``chip_smoke.py`` and
``tests/test_torch_kernels_cuda.py``)."""

import numpy as np
import pytest
import torch

from real3dportrait_tpu_torch.models import decoder as dm
from real3dportrait_tpu_torch.models import torso
from real3dportrait_tpu_torch.ops import conv3d as c3d
from tests._torch_parity import agree

torch.set_num_threads(1)
f64 = torch.float64


def _randn(rng, *shape):
    return torch.from_numpy(rng.randn(*shape)).to(f64)


def test_triplane_decode_backward_plain_matches_autograd():
    """Tri-planes, coordinates partly outside (zero padding), both outputs'
    gradients, and the folded weights' gradients mapped through the
    equalised-LR gains to the parameters'."""
    rng = np.random.RandomState(3)
    dec = dm.OSGDecoder(32, 64, 32, lr_multiplier=0.7).to(f64)
    with torch.no_grad():
        for p in dec.parameters():
            p.copy_(_randn(rng, *p.shape) * 0.5)
    planes = _randn(rng, 2, 3, 5, 6, 32).requires_grad_(True)
    coords = torch.from_numpy(rng.uniform(-0.6, 0.6, (2, 40, 3)))
    rgb, sigma = dm.triplane_decode_plain(planes, coords, 1.0, dec)
    drgb, dsig = _randn(rng, *rgb.shape), _randn(rng, *sigma.shape)
    params = [dec.net0.weight, dec.net0.bias, dec.net1.weight, dec.net1.bias]
    want = torch.autograd.grad((rgb, sigma), [planes] + params, (drgb, dsig), retain_graph=True)
    w0, b0 = dec.net0.folded()
    w1, b1 = dec.net1.folded()
    folded = [t.detach() for t in (w0, b0, w1, b1)]
    got = dm.decode_backward_plain(planes.detach(), coords, 1.0, *folded, drgb, dsig)
    gains = [dec.net0.weight_gain, dec.net0.lr_multiplier, dec.net1.weight_gain,
             dec.net1.lr_multiplier]
    agree(got[0], want[0], 1e-6, 1e-7, "d planes")
    for g, w, gain, name in zip(got[1:], want[1:], gains, ("w0", "b0", "w1", "b1")):
        agree(g * gain, w, 1e-6, 1e-7, name)
    want = torch.autograd.grad(rgb, planes, drgb)[0]
    got = dm.decode_backward_plain(planes.detach(), coords, 1.0, *folded, drgb, None)
    agree(got[0], want, 1e-6, 1e-7, "d planes (rgb only)")


@pytest.mark.parametrize("spread", [0.3, 1.1])
def test_torso_deform_input_backward_plain_matches_autograd(spread):
    """K5a: the volume's gradient through the K+1 zero-padded warps (with
    ``spread`` 1.1 many samples leave the volume); the heatmaps carry none."""
    rng = np.random.RandomState(5)
    fs = _randn(rng, 2, 3, 5, 6, 4).requires_grad_(True)
    kp_s = torch.from_numpy(rng.uniform(-spread, spread, (2, 4, 3)))
    kp_d = torch.from_numpy(rng.uniform(-spread, spread, (2, 4, 3)))
    out = torso.torso_deform_input_plain(fs, kp_s, kp_d)
    dout = _randn(rng, *out.shape)
    want = torch.autograd.grad(out, fs, dout)[0]
    got = torso.torso_deform_input_backward_plain(dout, kp_s, kp_d, tuple(fs.shape))
    agree(got, want, 1e-6, 1e-7, "d fs")


@pytest.mark.parametrize("c", [4, 32])
def test_torso_warp_volume_backward_plain_matches_autograd(c):
    """K5b: the volume's and the deformation's gradients, border padding,
    the deformation partly past [-1, 1] (clamped axes take no gradient)."""
    rng = np.random.RandomState(6)
    fs = _randn(rng, 2, 3, 4, 5, c).requires_grad_(True)
    deformation = torch.from_numpy(rng.uniform(-1.3, 1.3, (2, 3, 4, 5, 3))).requires_grad_(True)
    out = torso.torso_warp_volume_plain(fs, deformation)
    dout = _randn(rng, *out.shape)
    want = torch.autograd.grad(out, (fs, deformation), dout)
    got = torso.torso_warp_volume_backward_plain(fs.detach(), deformation.detach(), dout)
    agree(got[0], want[0], 1e-6, 1e-7, "d fs")
    agree(got[1], want[1], 1e-6, 1e-7, "d deformation")


@pytest.mark.parametrize("ci,co,k", [(5, 4, 3), (25, 6, 3), (7, 9, 7), (3, 5, 7)])
def test_conv3d_backward_plain_matches_autograd(ci, co, k):
    """K7a: the weight and bias gradients (``conv3d_weight_grad_plain``) and
    the data gradient as K7a computes it (the flipped, channel-swapped conv
    of ``conv3d_data_grad``), at 2 depths (k = 7 reaches past the volume)
    and on planes of 4 x 5."""
    rng = np.random.RandomState(7)
    x = _randn(rng, 2, ci, 2 if k == 7 else 3, 4, 5).requires_grad_(True)
    w = (_randn(rng, co, ci, k, k, k) / np.sqrt(ci * k ** 3)).requires_grad_(True)
    b = _randn(rng, co).requires_grad_(True)
    y = c3d.conv3d_plain(x, w, b)
    dy = _randn(rng, *y.shape)
    want = torch.autograd.grad(y, (x, w, b), dy)
    dw, db = c3d.conv3d_weight_grad_plain(x.detach(), dy, k)
    agree(dw, want[1], 1e-6, 1e-7, "d weight")
    agree(db, want[2], 1e-6, 1e-7, "d bias")
    agree(c3d.conv3d_data_grad(dy, w.detach()), want[0], 1e-6, 1e-7, "d x")


@pytest.mark.parametrize("which", ["all", "deformation", "occlusions"])
def test_mfe_tail_backward_plain_matches_autograd(which):
    """K7b: x, the mask conv's weight and bias, both occlusion heads'
    weights and biases, from the gradients of the deformation and of both
    occlusions (or of some of them, the others None)."""
    rng = np.random.RandomState(8)
    b, c, d, h, w = 2, 3, 2, 5, 6
    x = _randn(rng, b, c, d, h, w).requires_grad_(True)
    mask_w = (_randn(rng, 5, c, 7, 7, 7) * 0.1).requires_grad_(True)
    mask_b = (_randn(rng, 5) * 0.1).requires_grad_(True)
    occ_w = (_randn(rng, 2, c * d, 7, 7) * 0.1).requires_grad_(True)
    occ_b = (_randn(rng, 2) * 0.1).requires_grad_(True)
    kp_s = torch.from_numpy(rng.uniform(-0.8, 0.8, (b, 4, 3)))
    kp_d = torch.from_numpy(rng.uniform(-0.8, 0.8, (b, 4, 3)))
    leaves = (x, mask_w, mask_b, occ_w, occ_b)
    outs = torso.mfe_tail_plain(*leaves, kp_s, kp_d)
    grads = [_randn(rng, *t.shape) for t in outs]
    if which == "deformation":
        grads[1] = grads[2] = None
    elif which == "occlusions":
        grads[0] = None
    used = [(o, g) for o, g in zip(outs, grads) if g is not None]
    want = torch.autograd.grad([o for o, _ in used], leaves, [g for _, g in used],
                               allow_unused=True)
    want = [torch.zeros_like(t) if g is None else g for g, t in zip(want, leaves)]
    with torch.no_grad():
        logits = torch.nn.functional.conv3d(x, mask_w, mask_b, padding=3)
        mask = torch.softmax(logits, dim=1)
    got = torso.mfe_tail_backward_plain(x.detach(), mask_w.detach(), occ_w.detach(), kp_s,
                                        kp_d, mask, outs[1].detach(), outs[2].detach(), *grads)
    for g, wnt, name in zip(got, want, ("d x", "d mask_w", "d mask_b", "d occ_w", "d occ_b")):
        agree(g, wnt, 1e-6, 1e-7, name)

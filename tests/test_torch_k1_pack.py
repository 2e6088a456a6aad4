"""K1 / K1-trigrid's host side on the CPU: the decoder weights packed in the
kernels' fragment order and split for the tensor cores
(``models/decoder.py`` ``pack_decoder_mlp``), the per-decoder cache of that
packing, which must follow every change of the weights, and the cost that
``chip_smoke.py`` bounds the kernels with (``k1_cost``).

The kernels' arithmetic is emulated here from the packed buffer alone, read
as ``mma.sync.m16n8k8`` reads its B fragments (lane = 4 g + t: b0 at (k t,
n g), b1 at (k t + 4, n g) of each 8 x 8 tile), with the A fragments the
kernel builds: the features, then the first product's accumulators as they
lie (column 8j + 2t of hidden at k t of step j, 8j + 2t + 1 at k t + 4).
"""

import numpy as np
import pytest
import torch

from real3dportrait_tpu_torch.models.decoder import (
    OSGDecoder,
    _tf32,
    k1_cost,
    pack_decoder_mlp,
    packed_decoder_mlp,
)
from real3dportrait_tpu_torch.weights import mock_init_


def _decoder(seed: int, lr_multiplier: float = 1.0) -> OSGDecoder:
    dec = mock_init_(OSGDecoder(32, 64, 32, lr_multiplier=lr_multiplier),
                     torch.Generator().manual_seed(seed))
    with torch.no_grad():  # non-zero biases, so that their places are checked too
        for p in (dec.net0.bias, dec.net1.bias):
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(seed + 7)))
    return dec


def _b_matrices(frags: torch.Tensor, k_steps: int, n_tiles: int):
    """(hi, lo) [8 k_steps, 8 n_tiles] B matrices from float4 fragments
    [k_step][n_tile][lane] of (hi0, hi1, lo0, lo1)."""
    f = frags.view(k_steps, n_tiles, 8, 4, 4).double()         # [s, j, g, t, part]
    out = []
    for part in (0, 2):                                        # hi, lo
        m = torch.zeros((8 * k_steps, 8 * n_tiles), dtype=torch.float64)
        for s in range(k_steps):
            for j in range(n_tiles):
                # b0 at (k t, n g), b1 at (k t + 4, n g)
                m[8 * s:8 * s + 4, 8 * j:8 * j + 8] = f[s, j, :, :, part].T
                m[8 * s + 4:8 * s + 8, 8 * j:8 * j + 8] = f[s, j, :, :, part + 1].T
        out.append(m)
    return out


def _split(a: torch.Tensor):
    hi = _tf32(a)
    return hi.double(), _tf32(a - hi).double()


def _split_matmul(a: torch.Tensor, b_hi: torch.Tensor, b_lo: torch.Tensor) -> torch.Tensor:
    """lo*hi + hi*lo + hi*hi of fp32 ``a`` split as the kernel splits it."""
    a_hi, a_lo = _split(a)
    return (a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi).float()


def _emulate(packed: torch.Tensor, feats: torch.Tensor):
    """The kernels' MLP from the packed buffer: features [P,32] -> (rgb
    [P,32], sigma [P,1])."""
    w0f, w1f = packed[:4 * 4 * 8 * 32], packed[4 * 4 * 8 * 32:4 * (4 * 8 + 8 * 5) * 32]
    b0, b1 = packed[-104:-40], packed[-40:]
    hid = _split_matmul(feats, *_b_matrices(w0f, 4, 8)) + b0
    hid = torch.nn.functional.softplus(hid)
    # k-step j's A fragment: hidden 8j + 2t at k t, 8j + 2t + 1 at k t + 4
    order = [8 * j + 2 * t + i for j in range(8) for i in (0, 1) for t in range(4)]
    out = _split_matmul(hid[:, order], *_b_matrices(w1f, 8, 5)) + b1
    rgb = torch.sigmoid(out[:, :32]) * (1 + 2 * 0.001) - 0.001
    return rgb, out[:, 32:33]


def test_tf32_split_is_cvt_rna():
    # round to 10 mantissa bits, ties away from zero; hi + lo keeps ~22 bits
    rng = np.random.RandomState(0)
    x = (rng.randn(4096) * 10.0 ** rng.uniform(-6, 6, 4096)).astype(np.float32)
    x[:4] = [1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11, 0.0]  # two ties, one above
    bits = x.view(np.uint32)
    want = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    hi = _tf32(torch.from_numpy(x))
    np.testing.assert_array_equal(hi.numpy(), want)
    assert hi[:3].tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 * 2 ** -10]
    lo = _tf32(torch.from_numpy(x) - hi)
    rel = ((hi.double() + lo.double() - torch.from_numpy(x).double()).abs()
           / torch.from_numpy(x).double().abs().clamp_min(1e-30))
    assert float(rel.max()) <= 2.0 ** -21


@pytest.mark.parametrize("seed,lr_multiplier", [(0, 1.0), (3, 0.5)])
def test_k1_packed_weights_reproduce_the_decoder(seed, lr_multiplier):
    # the emulated split-TF32 products from the packed buffer against the
    # decoder in fp32: products exact to ~2^-22, sums in another order,
    # 2e-6 absolute on rgb in [-0.001, 1.001] and sigma O(1)
    dec = _decoder(seed, lr_multiplier)
    packed = pack_decoder_mlp(*dec.net0.folded(), *dec.net1.folded())
    assert packed.shape == (9320,) and packed.dtype == torch.float32
    # every stored part is a TF32 value (low 13 mantissa bits zero)
    frags = packed[:-104].view(torch.int32)
    assert int((frags & 0x1FFF).abs().max()) == 0
    feats = torch.from_numpy(np.random.RandomState(seed).randn(3, 257, 32).astype(np.float32))
    rgb, sigma = _emulate(packed, feats.mean(0))
    with torch.no_grad():
        want = dec(feats[None])
    torch.testing.assert_close(rgb, want["rgb"][0], atol=2e-6, rtol=0)
    torch.testing.assert_close(sigma, want["sigma"][0], atol=2e-6, rtol=0)


def test_k1_packed_weights_follow_every_change():
    dec = _decoder(1)
    first = packed_decoder_mlp(dec)
    assert packed_decoder_mlp(dec) is first  # packed once while nothing changes

    def fresh(d):
        return pack_decoder_mlp(*d.net0.folded(), *d.net1.folded())

    with torch.no_grad():
        dec.net1.weight.mul_(-1.5)  # in place: the parameter's version moves
    second = packed_decoder_mlp(dec)
    assert second is not first and torch.equal(second, fresh(dec))
    assert not torch.equal(second, first)
    other = _decoder(2)
    dec.load_state_dict(other.state_dict())
    third = packed_decoder_mlp(dec)
    assert torch.equal(third, fresh(other)) and not torch.equal(third, second)
    with torch.no_grad():
        dec.net0.bias.add_(1.0)
    assert torch.equal(packed_decoder_mlp(dec)[-104:-40], dec.net0.folded()[1])
    dec.net0.lr_multiplier = 0.5  # the fold's gain, not a parameter
    assert torch.equal(packed_decoder_mlp(dec), fresh(dec))
    assert "_packed_mlp" not in dec.state_dict()


def test_k1_packing_refuses_other_widths():
    dec = mock_init_(OSGDecoder(16, 64, 32), torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        packed_decoder_mlp(dec)


@pytest.mark.parametrize("shape,n,bound_ms", [
    ((1, 3, 3, 256, 256, 32), 262144, 0.0338), ((1, 3, 3, 256, 256, 32), 524288, 0.0451),
    ((1, 3, 3, 256, 256, 32), 786432, 0.0563), ((1, 3, 256, 256, 32), 262144, 0.0188)])
def test_k1_cost_terms(shape, n, bound_ms):
    # H100 SXM: 3.35 TB/s, 495 TFLOP/s TF32 (3 products per fp32 product
    # in split TF32), 67 TFLOP/s fp32: the bytes bound at these sizes
    c = k1_cost(shape, n)
    assert c["bytes"] == 4 * int(np.prod(shape)) + n * 4 * (3 + 32 + 1)
    corners = 8 if len(shape) == 6 else 4
    assert c["mma_ops"] == n * 8320 and c["fp32_ops"] == n * (3 * corners * 64 + 96)
    terms = (c["bytes"] / 3.35e12, 3 * c["mma_ops"] / 495e12, c["fp32_ops"] / 67e12)
    assert max(terms) == terms[0]
    assert abs(1e3 * terms[0] - bound_ms) < 5e-5


@pytest.mark.parametrize("config", ["secc_img2plane_torso.yaml", "real3d_orig.yaml"])
def test_k1_planes_reach_the_kernels_contiguous(config):
    # the canonical plane is laid out once per video, so that each frame's
    # fused planes come out in the kernels' layout and the wrappers copy
    # nothing (a tri-grid of the default model is 75.5 MB a frame)
    import os

    from real3dportrait_tpu_torch.config import load_config
    from real3dportrait_tpu_torch.geometry.bfm import synthetic_bfm
    from real3dportrait_tpu_torch.inference.pipeline import Real3DPortraitPipeline
    from real3dportrait_tpu_torch.models import decoder as dm

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "configs", config), dict(
        sampling_preset="fast", final_resolution=64, neural_rendering_resolution=16,
        secc_resolution=48, sr_channel0=16, sr_channel1=16, torso_model_scale="tiny"))
    pipe = Real3DPortraitPipeline(cfg, mock_weights=True, assets=synthetic_bfm(n_vertices=2000),
                                  seed=0, device="cpu")
    rng = np.random.RandomState(0)
    src = rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
    exp = torch.from_numpy(rng.randn(1, 64).astype(np.float32) * 0.3)
    seen = []
    name = "trigrid_decode" if "secc" in config else "triplane_decode"
    kernel = getattr(dm, name)

    def capture(planes, coords, box_warp, decoder):
        seen.append(planes.is_contiguous())
        return kernel(planes, coords, box_warp, decoder)

    capture.launches = 0
    setattr(dm, name, capture)
    try:
        pipe.synthesize(src, exp, pipe.fit_source(None), blink_mode="none",
                        prepare_source_images=False)
    finally:
        setattr(dm, name, kernel)
    assert seen == [True, True]

"""Parity of the port's networks with the JAX package at narrow widths: the
SECC SegFormer, the composite canonical backbone, the StyleGAN2 synthesis
blocks and SR head, and the plain versions of kernels K6a (upfirdn2d) and
K6b (the fused bias_act epilogue). Weights are seeded numpy leaves on
each JAX module's init tree, loaded through ``torch_state_dict_from_jax``
with strict name matching."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real3dportrait_tpu.models import stylegan2 as jsg
from real3dportrait_tpu.models.img2plane_composite import (
    CompositeImg2PlaneBackbone as JaxComposite,
)
from real3dportrait_tpu.models.segformer import (
    SegFormerImg2PlaneBackbone as JaxSegImg2Plane,
    SegFormerSECC2PlaneBackbone as JaxSecc,
)
from real3dportrait_tpu.models.superresolution import SuperresolutionHybrid8XDC as JaxSR
from real3dportrait_tpu.ops import bias_act as jba
from real3dportrait_tpu.ops import upfirdn2d as jup
from real3dportrait_tpu_torch.models.img2plane_composite import (
    CompositeImg2PlaneBackbone,
    pixel_shuffle,
)
from real3dportrait_tpu_torch.models.segformer import (
    SegFormerImg2PlaneBackbone,
    SegFormerSECC2PlaneBackbone,
)
from real3dportrait_tpu_torch.models.stylegan2 import SynthesisBlock, modulated_conv2d
from real3dportrait_tpu_torch.models.superresolution import SuperresolutionHybrid8XDC
from real3dportrait_tpu_torch.ops import bias_act as tba
from real3dportrait_tpu_torch.ops import upfirdn2d as tup
from tests._torch_parity import agree, jax_run, load_from_jax, t

torch.set_num_threads(1)


_jax_run = jax_run


def _nchw(x):
    return t(x).permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


@pytest.mark.parametrize("norm_mode", ["folded_bn", "gn"])
def test_segformer_secc_backbone_matches_jax(norm_mode):
    # MiT-b0 + fuse head + plane CNN, fp32 end to end (~40 layers): 1e-4 of
    # the plane scale max, 1e-5 mean
    secc = np.random.RandomState(0).uniform(-1, 1, (1, 64, 64, 9)).astype(np.float32)
    jm = JaxSecc(scale="b0", plane_channels=8, head_norm_mode=norm_mode)
    variables, want = _jax_run(jm, secc, seed=1)
    tm = load_from_jax(SegFormerSECC2PlaneBackbone(scale="b0", plane_channels=8,
                                                   head_norm_mode=norm_mode), variables)
    with torch.no_grad():
        got = tm(t(secc))
    assert got.shape == (1, 3, 32, 32, 8)
    agree(got, want, 1e-4, 1e-5, "SECC backbone planes")


def test_segformer_img2plane_backbone_matches_jax():
    img = np.random.RandomState(2).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    jm = JaxSegImg2Plane(scale="nano", plane_channels=8, head_norm_mode="folded_bn")
    variables, want = _jax_run(jm, img, seed=3)
    tm = load_from_jax(SegFormerImg2PlaneBackbone("nano", 8, "folded_bn"), variables)
    with torch.no_grad():
        got = tm(t(img))
    agree(got, want, 1e-4, 1e-5, "segformer img2plane planes")


def test_composite_backbone_matches_jax():
    # dilated ResNet34 + ASPP + two ViTs (vit_dim 32) + detail CNN, ~60
    # layers in fp32: 2e-4 of the plane scale max, 2e-5 mean
    img = np.random.RandomState(4).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    jm = JaxComposite(plane_channels=8, scale="small", vit_dim=32, norm_mode="affine")
    variables, want = _jax_run(jm, img, seed=5)
    tm = load_from_jax(CompositeImg2PlaneBackbone(plane_channels=8, scale="small",
                                                  vit_dim=32), variables)
    with torch.no_grad():
        got = tm(t(img))
    assert got.shape == (1, 3, 32, 32, 8)
    agree(got, want, 2e-4, 2e-5, "composite planes")


def test_pixel_shuffle_matches_torch_order():
    x = np.random.RandomState(6).randn(2, 3, 4, 12).astype(np.float32)
    from real3dportrait_tpu.models.img2plane_composite import pixel_shuffle as jps

    np.testing.assert_array_equal(pixel_shuffle(t(x), 2).numpy(), np.asarray(jps(x, 2)))


def test_synthesis_block_matches_jax():
    # modulated up-conv + conv + skip toRGB with const noise: 1e-5 of scale
    # max, 1e-6 mean
    rng = np.random.RandomState(7)
    x = rng.randn(2, 8, 8, 8).astype(np.float32)
    img = rng.randn(2, 8, 8, 3).astype(np.float32)
    ws = rng.randn(2, 3, 32).astype(np.float32)
    jm = jsg.SynthesisBlock(in_channels=8, out_channels=16, w_dim=32, resolution=16,
                            img_channels=3, is_last=False)
    variables, (want_x, want_img) = _jax_run(jm, x, img, ws, seed=8, noise_mode="const")
    tm = load_from_jax(SynthesisBlock(8, 16, 32, 16, 3, is_last=False), variables)
    with torch.no_grad():
        got_x, got_img = tm(t(x), t(img), t(ws), noise_mode="const")
    agree(got_x, want_x, 1e-5, 1e-6, "block x")
    agree(got_img, want_img, 1e-5, 1e-6, "block img")


@pytest.mark.parametrize("use_fp16", [True, False], ids=["bf16", "fp32"])
def test_clamped_synthesis_block_matches_jax(use_fp16):
    # the SR heads' half-precision block: up 2, conv_clamp 256, const noise.
    # bf16: the weight and styles pre-normalised, demodulation in fp32 then
    # cast, activations rounded to bf16 (8 mantissa bits) at other points
    # in the two frameworks: 3e-2 of scale max, 3e-3 mean. The same block in
    # fp32 guards the algorithm at 1e-5 / 1e-6.
    rng = np.random.RandomState(16)
    x = rng.randn(2, 8, 8, 8).astype(np.float32)
    img = rng.randn(2, 8, 8, 3).astype(np.float32)
    ws = rng.randn(2, 3, 32).astype(np.float32)
    jm = jsg.SynthesisBlock(in_channels=8, out_channels=16, w_dim=32, resolution=16,
                            img_channels=3, is_last=False, use_fp16=use_fp16,
                            conv_clamp=256.0)
    variables, (want_x, want_img) = _jax_run(jm, x, img, ws, seed=17, noise_mode="const")
    tm = load_from_jax(SynthesisBlock(8, 16, 32, 16, 3, is_last=False, use_fp16=use_fp16,
                                      conv_clamp=256.0), variables)
    with torch.no_grad():
        got_x, got_img = tm(t(x), t(img), t(ws), noise_mode="const")
    dtype = torch.bfloat16 if use_fp16 else torch.float32
    assert got_x.dtype == dtype and got_img.dtype == torch.float32
    assert str(want_x.dtype) == str(dtype).split(".")[-1]
    tol = (3e-2, 3e-3) if use_fp16 else (1e-5, 1e-6)
    agree(got_x.float(), np.asarray(want_x, np.float32), *tol, "block x")
    agree(got_img, want_img, *tol, "block img")


@pytest.mark.parametrize("in_res", [16, 8])
def test_superresolution_matches_jax(in_res):
    # two blocks 16 -> 64 (in_res 8 first resizes to 16): 1e-5 of scale max,
    # 1e-6 mean
    rng = np.random.RandomState(9)
    rgb = rng.randn(1, in_res, in_res, 3).astype(np.float32)
    x = rng.randn(1, in_res, in_res, 8).astype(np.float32)
    ws = np.ones((1, 14, 16), np.float32)
    jm = JaxSR(w_dim=16, sr_num_fp16_res=0, input_resolution=16, block0_channels=16,
               block1_channels=8, final_resolution=64)
    variables, want = _jax_run(jm, rgb, x, ws, seed=10)
    tm = load_from_jax(SuperresolutionHybrid8XDC(8, w_dim=16, input_resolution=16,
                                                 block0_channels=16, block1_channels=8,
                                                 final_resolution=64), variables)
    with torch.no_grad():
        got = tm(t(rgb), t(x), t(ws))
    assert got.shape == (1, 64, 64, 3)
    agree(got, want, 1e-5, 1e-6, "SR image")


def test_bf16_superresolution_matches_jax():
    # both blocks in bf16 with conv_clamp 256 (sr_num_fp16_res 4, the JAX
    # default): block0's bf16 features feed block1 directly, the image
    # stays fp32. bf16 rounding at other points: 3e-2 of scale max, 3e-3 mean
    rng = np.random.RandomState(18)
    rgb = rng.randn(1, 16, 16, 3).astype(np.float32)
    x = rng.randn(1, 16, 16, 8).astype(np.float32)
    ws = np.ones((1, 14, 16), np.float32)
    jm = JaxSR(w_dim=16, sr_num_fp16_res=4, input_resolution=16, block0_channels=16,
               block1_channels=8, final_resolution=64)
    variables, want = _jax_run(jm, rgb, x, ws, seed=19)
    tm = load_from_jax(SuperresolutionHybrid8XDC(8, w_dim=16, sr_num_fp16_res=4,
                                                 input_resolution=16, block0_channels=16,
                                                 block1_channels=8, final_resolution=64),
                       variables)
    assert tm.block1.dtype == torch.bfloat16 and tm.block1.conv1.conv_clamp == 256.0
    with torch.no_grad():
        got = tm(t(rgb), t(x), t(ws))
    assert got.dtype == torch.float32
    agree(got, want, 3e-2, 3e-3, "bf16 SR image")


@pytest.mark.parametrize("act", sorted(jba.ACTIVATIONS))
def test_bias_act_matches_jax(act):
    # elementwise fp32: 1e-6 of scale
    rng = np.random.RandomState(11)
    x = (rng.randn(2, 5, 4) * 3).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    for gain, clamp in ((None, None), (0.7, 1.5)):
        want = jba.bias_act(jnp.asarray(x), jnp.asarray(b), act=act, gain=gain, clamp=clamp)
        agree(tba.bias_act(t(x), t(b), act=act, gain=gain, clamp=clamp), want, 1e-6, 1e-7,
              f"bias_act {act}")


_RESAMPLE_CASES = {
    "fir": dict(up=1, down=1, padding=(1, 2, 0, 1)),
    "up2": dict(up=2, down=1, padding=2),
    "down2": dict(up=1, down=2, padding=1),
    "up2down2_crop": dict(up=2, down=2, padding=(-1, 1, 1, -1)),
}


@pytest.mark.parametrize("case", sorted(_RESAMPLE_CASES))
def test_upfirdn2d_matches_jax(case):
    # depthwise FIR conv in fp32: 1e-5 of scale max, 1e-6 mean
    rng = np.random.RandomState(12)
    x = rng.randn(2, 9, 7, 3).astype(np.float32)
    f = np.asarray(jup.setup_filter([1, 3, 3, 1]))
    f = (f * (1 + 0.3 * rng.randn(*f.shape))).astype(np.float32)  # asymmetric
    kw = _RESAMPLE_CASES[case]
    want = jup.upfirdn2d(jnp.asarray(x), jnp.asarray(f), **kw)
    got = _nhwc(tup.upfirdn2d(_nchw(x), t(f), **kw))
    agree(got, want, 1e-5, 1e-6, f"upfirdn2d {case}")


def test_resample_helpers_match_jax():
    # upsample2d / downsample2d / conv2d_resample (up, down, plain): 1e-5 of
    # scale max, 1e-6 mean
    rng = np.random.RandomState(13)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    w = rng.randn(3, 3, 4, 5).astype(np.float32)  # HWIO
    jf = jup.setup_filter([1, 3, 3, 1])
    tf = tup.setup_filter([1, 3, 3, 1])
    agree(_nhwc(tup.upsample2d(_nchw(x), tf)), jup.upsample2d(jnp.asarray(x), jf),
          1e-5, 1e-6, "upsample2d")
    agree(_nhwc(tup.downsample2d(_nchw(x), tf)), jup.downsample2d(jnp.asarray(x), jf),
          1e-5, 1e-6, "downsample2d")
    w_oihw = t(w).permute(3, 2, 0, 1)
    for up, down in ((2, 1), (1, 2), (1, 1)):
        want = jup.conv2d_resample(jnp.asarray(x), jnp.asarray(w), f=jf, up=up, down=down,
                                   padding=1, flip_weight=(up == 1))
        got = _nhwc(tup.conv2d_resample(_nchw(x), w_oihw, f=tf, up=up, down=down,
                                        padding=1, flip_weight=(up == 1)))
        agree(got, want, 1e-5, 1e-6, f"conv2d_resample up{up} down{down}")


@pytest.mark.parametrize("up,demodulate,noise", [(1, True, True), (2, True, False),
                                                 (1, False, False)],
                         ids=["demod_noise", "up2_demod", "torgb"])
def test_k6b_plain_epilogue_matches_jax_modulated_conv(up, demodulate, noise):
    # the port's modulated_conv2d + fused epilogue (demodulation, noise,
    # bias, lrelu, gain, clamp) against JAX modulated_conv2d + bias_act:
    # fp32 conv sums in another order, 1e-5 of scale max, 1e-6 mean
    rng = np.random.RandomState(14)
    x = rng.randn(2, 6, 6, 5).astype(np.float32)
    w = rng.randn(3, 3, 5, 7).astype(np.float32)                  # HWIO
    styles = (1 + 0.3 * rng.randn(2, 5)).astype(np.float32)
    res = 6 * up
    nz = (rng.randn(res, res) * 0.7).astype(np.float32) if noise else None
    b = rng.randn(7).astype(np.float32)
    f = jup.setup_filter([1, 3, 3, 1]) if up > 1 else None
    pad = 1
    want = jsg.modulated_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(styles),
                                noise=None if nz is None else jnp.asarray(nz)[None, :, :, None],
                                up=up, padding=pad, resample_filter=f, demodulate=demodulate)
    want = jba.bias_act(want, jnp.asarray(b), act="lrelu", gain=1.3, clamp=2.5)
    y, d = modulated_conv2d(_nchw(x), t(w).permute(3, 2, 0, 1), t(styles), up=up,
                            padding=pad, demodulate=demodulate,
                            resample_filter=tup.setup_filter([1, 3, 3, 1]) if up > 1 else None)
    assert (d is None) == (not demodulate)
    got = tba.bias_act(y, t(b), act="lrelu", gain=1.3, clamp=2.5, axis=1, scale=d,
                       noise=None if nz is None else t(nz))
    agree(_nhwc(got), want, 1e-5, 1e-6, "modulated conv + epilogue")


def test_cpu_tensors_take_the_plain_k6_versions():
    # the wrappers dispatch on the tensor's device: no launch on the CPU
    rng = np.random.RandomState(15)
    x = t(rng.randn(1, 4, 7, 9))
    launches = (tba.bias_act.launches, tup.upfirdn2d.launches)
    f = tup.setup_filter([1, 3, 3, 1])
    assert torch.equal(tup.upfirdn2d(x, f, up=2, padding=(-1, 2, 1, 0), gain=4),
                       tup.upfirdn2d_plain(x, f, up=2, padding=(-1, 2, 1, 0), gain=4))
    kw = dict(act="lrelu", gain=1.4, clamp=0.5, axis=1, scale=t(rng.rand(1, 4)),
              noise=t(rng.randn(7, 9)))
    b = t(rng.randn(4))
    assert torch.equal(tba.bias_act(x, b, **kw), tba.bias_act_plain(x, b, **kw))
    assert (tba.bias_act.launches, tup.upfirdn2d.launches) == launches

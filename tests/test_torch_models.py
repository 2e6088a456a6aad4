"""Parity of the port's networks with the JAX package at narrow widths: the
SECC SegFormer, the composite canonical backbone, the StyleGAN2 synthesis
blocks and SR head, bias_act and upfirdn2d. Weights are seeded numpy leaves on
each JAX module's init tree, loaded through ``torch_state_dict_from_jax``
with strict name matching."""

import jax
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
from real3dportrait_tpu_torch.models.stylegan2 import SynthesisBlock
from real3dportrait_tpu_torch.models.superresolution import SuperresolutionHybrid8XDC
from real3dportrait_tpu_torch.ops import bias_act as tba
from real3dportrait_tpu_torch.ops import upfirdn2d as tup
from tests._torch_parity import agree, load_from_jax, random_like, t

torch.set_num_threads(1)


def _jax_run(module, *args, seed=0, **kw):
    """Seeded variables on ``module``'s init tree (no init compile) and the
    jitted apply: (variables, outputs)."""
    shapes = jax.eval_shape(lambda: module.init({"params": jax.random.PRNGKey(0)}, *args, **kw))
    variables = random_like(shapes, seed=seed)
    return variables, jax.jit(lambda v, *a: module.apply(v, *a, **kw))(variables, *args)


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

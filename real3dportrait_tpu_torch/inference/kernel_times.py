"""K1, K1-trigrid, K3, K6b and K7b at the shapes of ``chip_smoke.py``'s
kernel rows, beside their plain versions, and K1-trigrid and K3 on the
samples of a rendered frame, on a CUDA device.

    python3 real3dportrait_tpu_torch/inference/kernel_times.py [--tree DIR]

Per row: the device time of one launch (20 back-to-back calls behind a spin
kernel, ``kernels.device_ms``: the wrapper's launches, the kernel's and any
other) and of one call on an idle device (``kernels.cuda_ms``, the host's
work included), and the max abs error against the plain version (bf16: in
bf16 ulps of the plain output). Inputs as in ``chip_smoke.py``: N(0,1)
planes with points uniform in the box and a seeded decoder; K6b's
epilogues with demodulation, noise, bias, lrelu, gain sqrt 2 and a clamp,
and toRGB's bias alone; K3 on 16,384 rays of stratified coarse depths and
sorted fine depths with 32 uniform colour channels at 16+32 and 48+48; K7b
on the frame's [1,32,16,64,64] volume, 4 keypoints uniform in [-0.8, 0.8].
The frame rows are the coarse and fine passes of the default model
(``configs/secc_img2plane_torso.yaml``, ``fast``, seeded mock weights, the
35,709-vertex synthetic mesh, the neutral source coefficients), captured
from ``synthesize``: their samples follow rays, so neighbouring points
share corner rows, where uniform points do not; K3's frame row merges
those two passes' samples.
``--tree DIR`` imports the port from the checkout at DIR instead of this
one (run the file, not ``-m``), so that one run on the card can time
two trees in turns.
"""

from __future__ import annotations

import argparse
import os
import sys

# tag, planes shape, points: K1-trigrid on the default model's planes at
# the fast preset's coarse and fine passes and a 48-sample pass, K1 on the
# released geometry's
K1_ROWS = [("trigrid_decode", (1, 3, 3, 256, 256, 32), n) for n in (262144, 524288, 786432)] + [
    ("triplane_decode", (1, 3, 256, 256, 32), n) for n in (262144, 786432)]
# tag, shape, dtype name, clamp (None: toRGB, bias alone)
K6B_ROWS = [("block1 bf16", (1, 128, 512, 512), "bfloat16", 256.0),
            ("block0 bf16", (1, 256, 256, 256), "bfloat16", 256.0),
            ("block1 fp32", (1, 128, 512, 512), "float32", 4.0),
            ("head_torso_block fp32", (1, 256, 256, 256), "float32", 4.0),
            ("toRGB fp32", (1, 3, 512, 512), "float32", None)]


def frame_passes(dev) -> tuple[list, tuple]:
    """(planes, coords, box_warp, decoder) of the two K1-trigrid calls, and
    the arguments of the K3 call, of the second of two frames that the
    default model synthesises at ``fast``."""
    import numpy as np
    import torch

    from real3dportrait_tpu_torch.config import load_config
    from real3dportrait_tpu_torch.geometry.bfm import synthetic_bfm
    from real3dportrait_tpu_torch.inference.pipeline import Real3DPortraitPipeline
    from real3dportrait_tpu_torch.models import decoder as dm
    from real3dportrait_tpu_torch.rendering import renderer

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(dm.__file__))))
    cfg = load_config(os.path.join(root, "configs", "secc_img2plane_torso.yaml"),
                      dict(sampling_preset="fast"))
    pipe = Real3DPortraitPipeline(cfg, mock_weights=True, assets=synthetic_bfm(n_vertices=35709),
                                  seed=0, device=dev)
    rng = np.random.RandomState(0)
    src = rng.randint(0, 256, (512, 512, 3)).astype(np.uint8)
    exp = torch.from_numpy(rng.randn(2, 64).astype(np.float32) * 0.3)
    calls, merges = [], []
    kernel, merge = dm.trigrid_decode, renderer.merge_composite

    def capture(planes, coords, box_warp, decoder):
        calls.append((planes, coords, box_warp, decoder))
        return kernel(planes, coords, box_warp, decoder)

    def capture_merge(*args):
        merges.append(args)
        return merge(*args)

    # the wrappers count on the name they are called by
    capture.launches = capture_merge.launches = 0
    dm.trigrid_decode, renderer.merge_composite = capture, capture_merge
    try:
        pipe.synthesize(src, exp, pipe.fit_source(None), blink_mode="none",
                        prepare_source_images=False)
    finally:
        dm.trigrid_decode, renderer.merge_composite = kernel, merge
    torch.cuda.synchronize()
    return calls[-2:], merges[-1]


def merge_inputs(dev, gen, r: int, s_c: int, s_f: int, c: int) -> tuple:
    """K3's arguments as ``chip_smoke.py`` makes them: ``r`` rays of
    stratified coarse depths in [2, 3] and sorted fine depths (K2's plain
    resample of the coarse densities), N(0, 3) densities, colours uniform
    in [0, 1)."""
    import torch

    from real3dportrait_tpu_torch.rendering import renderer

    start = 2.0 + 0.2 * torch.rand((1, r, 1, 1), device=dev, generator=gen)
    steps = (torch.arange(s_c, device=dev) + 0.5)[None, None, :, None] / s_c
    depths = start + 0.8 * steps
    sigma = 3 * torch.randn((1, r, s_c, 1), device=dev, generator=gen)
    fine = renderer.importance_sample_plain(depths, sigma, renderer.importance_u(r, s_f, dev))
    c1 = torch.rand((1, r, s_c, c), device=dev, generator=gen)
    c2 = torch.rand((1, r, s_f, c), device=dev, generator=gen)
    s2 = 3 * torch.randn((1, r, s_f, 1), device=dev, generator=gen)
    return depths, c1, sigma, fine, c2, s2


def sm_clock_while(fn, calls: int = 2000) -> str:
    """The card's SM clock and power draw (``nvidia-smi``) read while
    ``calls`` calls of ``fn`` queued back to back run: an FFMA-bound
    kernel's share of its peak depends on that clock."""
    import subprocess
    import time

    import torch

    torch.cuda.synchronize()
    for _ in range(calls):
        fn()
    time.sleep(0.05)
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    torch.cuda.synchronize()
    return f"SM clock, power {out}"


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", help="a checkout of the repo to import the port from")
    args = parser.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, os.path.abspath(args.tree or here))
    import torch

    from real3dportrait_tpu_torch import kernels
    from real3dportrait_tpu_torch.models import decoder as dm
    from real3dportrait_tpu_torch.models import torso
    from real3dportrait_tpu_torch.ops import bias_act as ba
    from real3dportrait_tpu_torch.rendering import renderer
    from real3dportrait_tpu_torch.weights import mock_init_

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device is visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {kernels.card_line()}")
    print(f"tree: {os.path.dirname(os.path.dirname(dm.__file__))}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    dec = mock_init_(dm.OSGDecoder(32, 64, 32), torch.Generator().manual_seed(1)).to(dev)
    for name, shape, n in K1_ROWS:
        fn, plain = getattr(dm, name), getattr(dm, f"{name}_plain")
        planes = torch.randn(shape, device=dev, generator=gen)
        coords = torch.rand((1, n, 3), device=dev, generator=gen) - 0.5
        with torch.no_grad():
            got, want = fn(planes, coords, 1.0, dec), plain(planes, coords, 1.0, dec)
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            launch = kernels.device_ms(lambda: fn(planes, coords, 1.0, dec))
            call = kernels.cuda_ms(lambda: fn(planes, coords, 1.0, dec))
        print(f"{name} [{n} pts]: per launch {launch:.4f} ms, per call {call:.4f} ms; max abs "
              f"err {err:.2e}")
        del planes, coords, got, want

    passes, merge_args = frame_passes(dev)
    for tag, (planes, coords, box_warp, dec_f) in zip(("coarse", "fine"), passes):
        with torch.no_grad():
            got = dm.trigrid_decode(planes, coords, box_warp, dec_f)
            want = dm.trigrid_decode_plain(planes, coords, box_warp, dec_f)
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            launch = kernels.device_ms(lambda: dm.trigrid_decode(planes, coords, box_warp, dec_f))
            call = kernels.cuda_ms(lambda: dm.trigrid_decode(planes, coords, box_warp, dec_f))
        print(f"trigrid_decode [frame {tag} pass, {coords.shape[1]} pts]: per launch "
              f"{launch:.4f} ms, per call {call:.4f} ms; max abs err {err:.2e}")
        del planes, coords, got, want

    del passes
    merge_rows = [(f"{s_c}+{s_f}", merge_inputs(dev, gen, 16384, s_c, s_f, 32))
                  for s_c, s_f in ((16, 32), (48, 48))]
    merge_rows.append((f"frame {merge_args[0].shape[2]}+{merge_args[3].shape[2]}", merge_args))
    for tag, margs in merge_rows:
        got = renderer.merge_composite(*margs)
        want = renderer.merge_composite_plain(*margs)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        launch = kernels.device_ms(lambda: renderer.merge_composite(*margs))
        call = kernels.cuda_ms(lambda: renderer.merge_composite(*margs))
        print(f"merge_composite [{tag}, {margs[0].shape[1]} rays]: per launch {launch:.4f} ms, "
              f"per call {call:.4f} ms; max abs err {err:.2e}")
    del merge_rows, merge_args

    c, d, h, w = 32, 16, 64, 64
    targs = (torch.randn((1, c, d, h, w), device=dev, generator=gen),
             torch.randn((5, c, 7, 7, 7), device=dev, generator=gen) / (c * 343) ** 0.5,
             torch.randn((5,), device=dev, generator=gen),
             torch.randn((2, c * d, 7, 7), device=dev, generator=gen) / (c * d * 49) ** 0.5,
             torch.randn((2,), device=dev, generator=gen),
             1.6 * torch.rand((1, 4, 3), device=dev, generator=gen) - 0.8,
             1.6 * torch.rand((1, 4, 3), device=dev, generator=gen) - 0.8)
    got, want = torso.mfe_tail(*targs), torso.mfe_tail_plain(*targs)
    err = max(float((g - w_).abs().max()) for g, w_ in zip(got, want))
    again = torso.mfe_tail(*targs)
    same = all(torch.equal(g, a) for g, a in zip(got, again))
    launch = kernels.device_ms(lambda: torso.mfe_tail(*targs))
    call = kernels.cuda_ms(lambda: torso.mfe_tail(*targs))
    print(f"mfe_tail [1,{c},{d},{h},{w}] K+1=5: per launch {launch:.4f} ms, per call "
          f"{call:.4f} ms; max abs err {err:.2e}; two calls {'bit-equal' if same else 'DIFFER'}; "
          f"while it runs: {sm_clock_while(lambda: torso.mfe_tail(*targs))}")
    del targs, got, want, again

    for tag, shape, dtype_name, clamp in K6B_ROWS:
        dtype = getattr(torch, dtype_name)
        b, c, h, w = shape
        x = (4 * torch.randn(shape, device=dev, generator=gen)).to(dtype)
        bias = torch.randn((c,), device=dev, generator=gen)
        kw = dict(axis=1)
        if clamp is not None:
            kw.update(act="lrelu", gain=2 ** 0.5, clamp=clamp,
                      scale=torch.rand((b, c), device=dev, generator=gen) + 0.5,
                      noise=0.3 * torch.randn((h, w), device=dev, generator=gen))
        got, want = ba.bias_act(x, bias, **kw), ba.bias_act_plain(x, bias, **kw)
        if dtype == torch.bfloat16:
            ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(2.0 ** -126))) - 7)
            err = f"{float(((got.float() - want.float()).abs() / ulp).max()):g} bf16 ulps" \
                  f"{', bit-equal' if torch.equal(got, want) else ''}"
        else:
            err = f"max abs err {float((got - want).abs().max()):.2e}"
        launch = kernels.device_ms(lambda: ba.bias_act(x, bias, **kw))
        call = kernels.cuda_ms(lambda: ba.bias_act(x, bias, **kw))
        print(f"bias_act {tag} {list(shape)}: per launch {launch:.4f} ms, per call "
              f"{call:.4f} ms; {err}")
        del x, got, want


if __name__ == "__main__":
    main()

"""K1, K1-trigrid, K2, K3, K4, K5a, K5b, K6b and K7b at the shapes of
``chip_smoke.py``'s kernel rows, beside their plain versions, and
K1-trigrid, K2, K3, K5a and K5b on the inputs of a rendered frame, on a
CUDA device; K3's, K7b's, K5a's and K5b's backward kernels (``k3b``,
``k7bb``, ``k5ab``, ``k5bb``) at the training steps' calls.

    python3 real3dportrait_tpu_torch/inference/kernel_times.py [--tree DIR]
        [--only k1,k2,k3,k4,k5a,k5b,k6b,k7b,k3b,k7bb,k5ab,k5bb,k5bp]

Per row: the device time of one launch (20 back-to-back calls behind a spin
kernel, ``kernels.device_ms``: the wrapper's launches, the kernel's and any
other) and of one call on an idle device (``kernels.cuda_ms``, the host's
work included), and the max abs error against the plain version (bf16: in
bf16 ulps of the plain output). Inputs as in ``chip_smoke.py``: N(0,1)
planes with points uniform in the box and a seeded decoder; K6b's
epilogues with demodulation, noise, bias, lrelu, gain sqrt 2 and a clamp,
and toRGB's bias alone; K3 on 16,384 rays of stratified coarse depths and
sorted fine depths with 32 uniform colour channels at 16+32 and 48+48; K2
on the same rays' coarse samples; K7b on the frame's [1,32,16,64,64]
volume, 4 keypoints uniform in [-0.8, 0.8]. ``k3b``: K3's backward on
chip_smoke's [4,16384,48+48,32] lists (sorted depths in [2, 3.3], N(0, 5)
densities, N(0, 1) gradients of rgb, depth and weights). ``k7bb``: K7b's
backward at the torso step's x [4,32,16,64,64], as chip_smoke makes its
inputs, with each launch of the call timed alone by CUDA events on that
call's own intermediate tensors, the call's device kernels from
``torch.profiler``, and the occlusion heads' weight gradient through K7a's
weight-gradient kernel on the fold as a depth-1 volume beside it.
``k5ab``: K5a's adjoint at the torso step's dout [4,25,16,64,64] (the
[4,16,64,64,4] volume, K+1 = 5), keypoints uniform in [-0.8, 0.8], in
[-1.6, 1.6] and source keypoints within 0.1 of the driving ones.
``k5bb``: K5b's adjoint at the step's [4,16,64,64,32] volume, the
deformation the identity + 0.05 N(0, 1) (chip_smoke's) and uniform in
[-1.2, 1.2] and within 0.02 of the identity. Both beside
``grid_sampler_3d_backward``, with their max error of scale against the
plain version (K5a's also whether two calls are bit-equal). ``k5bp``: the
first design of K5b's adjoint (``k5b_adjoint_parts.cu`` beside this file,
built here) whole, with its atomics alone and with its corner reads alone,
the atomics alone in the layout of the current kernel, and the zero fill
of the output, at ``k5bb``'s near identity. K5a on the [1,16,64,64,4]
compressed volume with 4 keypoints uniform in [-0.8, 0.8], in [-1.6,
1.6] (samples outside the volume) and source keypoints within 0.1 of the
driving ones (near the identity); K5b on the [1,16,64,64,32] appearance
volume with a deformation uniform in [-1.2, 1.2] and one within 0.02 of
the identity grid, beside ``F.grid_sample`` (5-D, border); both also
check two launches bit-equal. K4 through ``rasterize_verts``
(a tree from before it: ``rasterize``; the camera-space vertices in, the
projection included) on T = 1, 3 and 16
frames of the 35,709-vertex synthetic mesh at 192^2, each with the
device kernels of one call from ``torch.profiler`` (launches and time
each, and the host's share of the call), then the SECC stage at T = 1,
``SECCRenderer.render`` to 512^2 as ``profile_frame`` times it, split the
same way. The frame rows are the coarse and fine passes of the default model
(``configs/secc_img2plane_torso.yaml``, ``fast``, seeded mock weights, the
35,709-vertex synthetic mesh, the neutral source coefficients), captured
from ``synthesize``: their samples follow rays, so neighbouring points
share corner rows, where uniform points do not; K2's frame row resamples
the coarse pass's samples and K3's merges those two passes' samples.
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


def frame_passes(dev) -> tuple[list, tuple, tuple, tuple, tuple]:
    """(planes, coords, box_warp, decoder) of the two K1-trigrid calls, and
    the arguments of the K2, the K3, the K5a and the K5b call, of the second
    of two frames that the default model synthesises at ``fast``."""
    import numpy as np
    import torch

    from real3dportrait_tpu_torch.config import load_config
    from real3dportrait_tpu_torch.geometry.bfm import synthetic_bfm
    from real3dportrait_tpu_torch.inference.pipeline import Real3DPortraitPipeline
    from real3dportrait_tpu_torch.models import decoder as dm
    from real3dportrait_tpu_torch.models import torso
    from real3dportrait_tpu_torch.rendering import renderer

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(dm.__file__))))
    cfg = load_config(os.path.join(root, "configs", "secc_img2plane_torso.yaml"),
                      dict(sampling_preset="fast"))
    pipe = Real3DPortraitPipeline(cfg, mock_weights=True, assets=synthetic_bfm(n_vertices=35709),
                                  seed=0, device=dev)
    rng = np.random.RandomState(0)
    src = rng.randint(0, 256, (512, 512, 3)).astype(np.uint8)
    exp = torch.from_numpy(rng.randn(2, 64).astype(np.float32) * 0.3)
    calls, samples, merges, deforms, warps = [], [], [], [], []
    kernel, sample, merge = dm.trigrid_decode, renderer.importance_sample, \
        renderer.merge_composite
    deform, warp = torso.torso_deform_input, torso.torso_warp_volume

    def capture(planes, coords, box_warp, decoder):
        calls.append((planes, coords, box_warp, decoder))
        return kernel(planes, coords, box_warp, decoder)

    def capture_sample(*args):
        samples.append(args)
        return sample(*args)

    def capture_merge(*args):
        merges.append(args)
        return merge(*args)

    def capture_deform(*args):
        deforms.append(args)
        return deform(*args)

    def capture_warp(*args):
        warps.append(args)
        return warp(*args)

    # the wrappers count on the name they are called by
    capture.launches = capture_sample.launches = capture_merge.launches = 0
    capture_deform.launches = capture_warp.launches = 0
    dm.trigrid_decode, renderer.importance_sample, renderer.merge_composite = \
        capture, capture_sample, capture_merge
    torso.torso_deform_input, torso.torso_warp_volume = capture_deform, capture_warp
    try:
        pipe.synthesize(src, exp, pipe.fit_source(None), blink_mode="none",
                        prepare_source_images=False)
    finally:
        dm.trigrid_decode, renderer.importance_sample, renderer.merge_composite = \
            kernel, sample, merge
        torso.torso_deform_input, torso.torso_warp_volume = deform, warp
    torch.cuda.synchronize()
    return calls[-2:], samples[-1], merges[-1], deforms[-1], warps[-1]


def k5_rows(dev, gen, frame: tuple | None) -> tuple[list, list]:
    """K5a's and K5b's (tag, arguments) rows: ``chip_smoke.py``'s inputs
    (see the module's note), then a frame's own calls where ``frame``
    holds them."""
    import torch

    from real3dportrait_tpu_torch.models import torso

    fs = torch.randn((1, 16, 64, 64, 4), device=dev, generator=gen)
    k5a = []
    for tag, reach in (("kp 0.8", 0.8), ("kp 1.6, outside", 1.6)):
        kp_s = reach * (2 * torch.rand((1, 4, 3), device=dev, generator=gen) - 1)
        kp_d = reach * (2 * torch.rand((1, 4, 3), device=dev, generator=gen) - 1)
        k5a.append((tag, (fs, kp_s, kp_d)))
    kp_d = 0.8 * (2 * torch.rand((1, 4, 3), device=dev, generator=gen) - 1)
    kp_s = kp_d + 0.1 * (2 * torch.rand((1, 4, 3), device=dev, generator=gen) - 1)
    k5a.append(("near identity, kp offsets <= 0.1", (fs, kp_s, kp_d)))
    vol = torch.randn((1, 16, 64, 64, 32), device=dev, generator=gen)
    uniform = 2.4 * torch.rand((1, 16, 64, 64, 3), device=dev, generator=gen) - 1.2
    near = torso.make_coordinate_grid_3d(16, 64, 64, dev)[None] \
        + 0.02 * (2 * torch.rand((1, 16, 64, 64, 3), device=dev, generator=gen) - 1)
    k5b = [("uniform in [-1.2,1.2]", (vol, uniform)), ("identity + 0.02", (vol, near))]
    if frame is not None:
        (fs_f, kps_f, kpd_f), (vol_f, def_f) = frame
        ident = torso.make_coordinate_grid_3d(*def_f.shape[1:4], dev)[None]
        k5a.append((f"frame, kp offsets <= {float((kps_f - kpd_f).abs().max()):.3f}",
                    (fs_f, kps_f, kpd_f)))
        dist = (def_f - ident).abs()
        k5b.append((f"frame, |deformation - identity| max {float(dist.max()):.3f} mean "
                    f"{float(dist.mean()):.4f}", (vol_f, def_f)))
    return k5a, k5b


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


def raster_inputs(dev, t: int) -> tuple:
    """K4's arguments as ``chip_smoke.py`` makes them: the first ``t`` of 16
    frames of the 35,709-vertex synthetic mesh (seeded expressions, zero
    pose) in camera space, its faces and NCC colours in [0, 1]."""
    import numpy as np
    import torch

    from real3dportrait_tpu_torch.geometry import bfm

    assets = bfm.synthetic_bfm(n_vertices=35709).to(dev)
    rng = np.random.RandomState(0)
    idc = torch.from_numpy(np.tile(rng.randn(1, 80).astype(np.float32) * 0.1, (16, 1))).to(dev)
    exp = torch.from_numpy(rng.randn(16, 64).astype(np.float32) * 0.1).to(dev)
    zero = torch.zeros((16, 3), device=dev)
    verts = bfm.compute_face_vertex(assets, idc, exp, zero, zero)[:t].contiguous()
    return verts, assets.face_buf, ((assets.ncc_code + 1) / 2).contiguous()


def device_split(fn, calls: int = 20) -> tuple[str, float, int]:
    """The device kernels of one call of ``fn`` from ``torch.profiler`` over
    ``calls`` calls: (a line of name, launches and ms a call for each,
    kernel ms a call, launches a call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = sorted((x for x in prof.key_averages() if x.device_type == DeviceType.CUDA),
                  key=lambda x: -x.self_device_time_total)
    ms = sum(x.self_device_time_total for x in rows) / calls / 1e3
    n = sum(x.count for x in rows) // calls
    text = "; ".join(f"{x.key[:70]} x{x.count / calls:g} "
                     f"{x.self_device_time_total / calls / 1e3:.4f} ms" for x in rows)
    return text, ms, n


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


def k3b_inputs(dev, gen) -> tuple:
    """K3's backward arguments as ``chip_smoke.py`` makes them at the
    training steps' [4,16384,48+48,32]."""
    import torch

    b, m, s1, s2, c = 4, 16384, 48, 48, 32

    def rand(shape):
        return torch.rand(shape, device=dev, generator=gen)

    def randn(shape):
        return torch.randn(shape, device=dev, generator=gen)
    d1 = torch.sort(2 + 1.3 * rand((b, m, s1, 1)), dim=2).values
    d2 = torch.sort(2 + 1.3 * rand((b, m, s2, 1)), dim=2).values
    c1, c2 = rand((b, m, s1, c)), rand((b, m, s2, c))
    sg1, sg2 = 5 * randn((b, m, s1, 1)), 5 * randn((b, m, s2, 1))
    g = (randn((b, m, c)), randn((b, m, 1)), randn((b, m, s1 + s2 - 1, 1)))
    return (d1, c1, sg1, d2, c2, sg2, False, *g)


def k7bb_inputs(dev, gen) -> tuple:
    """K7b's backward arguments as ``chip_smoke.py`` makes them at the torso
    step's x [4,32,16,64,64]: the forward's softmax and occlusions from the
    same inputs, N(0, 1) output gradients."""
    import torch
    import torch.nn.functional as F

    from real3dportrait_tpu_torch.models import torso

    b, c, d, h, w = 4, 32, 16, 64, 64

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    def rand(*shape):
        return torch.rand(shape, device=dev, generator=gen)
    x = randn(b, c, d, h, w)
    mw, mb = 0.01 * randn(5, c, 7, 7, 7), 0.1 * randn(5)
    ow, ob = 0.01 * randn(2, c * d, 7, 7), 0.1 * randn(2)
    kp_s, kp_d = rand(b, 4, 3) * 1.6 - 0.8, rand(b, 4, 3) * 1.6 - 0.8
    with torch.no_grad():
        _, occ1, occ2 = torso.mfe_tail(x, mw, mb, ow, ob, kp_s, kp_d)
        mask = torch.softmax(F.conv3d(x, mw, mb, padding=3), dim=1)
    return (x, mw, ow, kp_s, kp_d, mask, occ1, occ2, randn(b, d, h, w, 3), randn(b, h, w, 1),
            randn(b, h, w, 1))


def tail_backward_parts(args) -> list[tuple[str, object]]:
    """Each launch of ``mfe_tail_backward`` as a call of its own on that
    call's intermediate tensors: the port's ``mfe_tail_backward_steps``
    where the tree has it, else the steps of the design before it (the
    adjoint, K7a's data gradient, the weight gradient, the occlusion heads'
    two kernels in one entry)."""
    import torch

    from real3dportrait_tpu_torch import kernels
    from real3dportrait_tpu_torch.models import torso
    from real3dportrait_tpu_torch.ops import conv3d as c3d

    if hasattr(torso, "mfe_tail_backward_steps"):
        steps, _ = torso.mfe_tail_backward_steps(*args)
        for _, fn in steps:
            fn()
        return steps
    x, mw, ow, kp_s, kp_d, mask, occ1, occ2, ddef, g1, g2 = args
    b, c, d, h, w = x.shape
    dlogits = torch.empty((b, 5, d, h, w), device=x.device)
    dpre = torch.empty((b, 2, h, w), device=x.device)
    dx = torch.zeros_like(x)
    docc_w, docc_b = torch.empty_like(ow), torch.empty((2,), device=x.device)
    steps = [
        ("adjoint", lambda: kernels.launch(
            "r3dp_mfe_tail_backward_adjoint", ddef, g1, g2, mask, occ1, occ2, kp_s, kp_d, b,
            d, h, w, dlogits, dpre)),
        ("mask conv data gradient (K7a)", lambda: c3d.conv3d_data_grad(dlogits, mw)),
        ("mask conv weight gradient", lambda: c3d.conv3d_weight_grad(x, dlogits, 7)),
        ("occlusion heads (data + weight gradient kernels)", lambda: kernels.launch(
            "r3dp_mfe_tail_backward_occ", x, ow, dpre, b, c * d, h, w, dx, docc_w, docc_b))]
    steps[0][1]()
    return steps


def k5_adjoint_inputs(dev, gen) -> tuple[list, list]:
    """K5a's and K5b's adjoint rows (tag, arguments) at the torso step's
    calls, as ``chip_smoke.py`` makes their inputs (see the module's note)."""
    import torch

    from real3dportrait_tpu_torch.models import torso

    b, k, d, h, w = 4, 4, 16, 64, 64

    def rand(*shape):
        return torch.rand(shape, device=dev, generator=gen)

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen)
    dout = randn(b, (k + 1) * 5, d, h, w)
    k5a = []
    for tag, reach in (("kp 0.8 (the step's)", 0.8), ("kp 1.6, outside", 1.6)):
        k5a.append((tag, (dout, reach * (2 * rand(b, k, 3) - 1), reach * (2 * rand(b, k, 3) - 1),
                          (b, d, h, w, 4))))
    kp_d = 0.8 * (2 * rand(b, k, 3) - 1)
    k5a.append(("near identity, kp offsets <= 0.1",
                (dout, kp_d + 0.1 * (2 * rand(b, k, 3) - 1), kp_d, (b, d, h, w, 4))))
    fs, gout = randn(b, d, h, w, 32), randn(b, 32 * d, h, w)
    base = torso.make_coordinate_grid_3d(d, h, w, dev)[None].expand(b, -1, -1, -1, -1)
    k5b = [("identity + 0.05 N(0,1) (the step's)", (fs, (base + 0.05 * randn(b, d, h, w, 3))
                                                     .contiguous(), gout)),
           ("uniform in [-1.2,1.2]", (fs, 2.4 * rand(b, d, h, w, 3) - 1.2, gout)),
           ("identity + 0.02 U(-1,1)", (fs, (base + 0.02 * (2 * rand(b, d, h, w, 3) - 1))
                                        .contiguous(), gout))]
    return k5a, k5b


def k5b_adjoint_parts(k5b_args) -> None:
    """Build ``k5b_adjoint_parts.cu`` and time the first design of K5b's
    adjoint in its three modes, the current layout's atomics alone and the
    zero fill of the output, per launch."""
    import ctypes
    import subprocess

    import torch

    from real3dportrait_tpu_torch import kernels

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "k5b_adjoint_parts.cu")
    out = kernels.BUILD_DIR / "k5b_adjoint_parts.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-shared", "-I",
                    str(kernels.CSRC), "-o", str(out), src], check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).r3dp_k5b_adjoint_parts
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2 + \
        [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fs, grid, dout = k5b_args
    b, d, h, w, c = fs.shape
    dfs, dgrid = torch.zeros_like(fs), torch.empty_like(grid)
    names = ("whole", "atomics alone", "corner reads and the deformation gradient alone",
             "the current layout: its atomics alone")
    for mode, name in enumerate(names):
        def run(mode=mode):
            status = fn(fs.data_ptr(), grid.data_ptr(), dout.data_ptr(), b, d, h, w, c,
                        dfs.data_ptr(), dgrid.data_ptr(), mode,
                        torch.cuda.current_stream().cuda_stream)
            if status:
                raise RuntimeError(f"r3dp_k5b_adjoint_parts: CUDA error {status}")
        what = name if mode == 3 else f"first-design torso_warp_volume_backward kernel, {name}"
        print(f"{what} [{list(fs.shape)}, near identity]: per launch "
              f"{kernels.device_ms(run):.4f} ms")
    print(f"torch.zeros_like(fs) [{list(fs.shape)}]: per launch "
          f"{kernels.device_ms(lambda: torch.zeros_like(fs)):.4f} ms")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", help="a checkout of the repo to import the port from")
    parser.add_argument("--only",
                        default="k1,k2,k3,k4,k5a,k5b,k6b,k7b,k3b,k7bb,k5ab,k5bb,k5bp",
                        help="the kernels to time, comma-separated (default: all)")
    args = parser.parse_args()
    only = set(args.only.split(","))
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, os.path.abspath(args.tree or here))
    import torch

    from real3dportrait_tpu_torch import kernels
    from real3dportrait_tpu_torch.geometry import rasterizer
    from real3dportrait_tpu_torch.geometry.bfm import synthetic_bfm
    from real3dportrait_tpu_torch.geometry.secc_renderer import SECCRenderer
    from real3dportrait_tpu_torch.models import decoder as dm
    from real3dportrait_tpu_torch.models import torso
    from real3dportrait_tpu_torch.ops import bias_act as ba
    from real3dportrait_tpu_torch.rendering import renderer
    from real3dportrait_tpu_torch.utils.precision import set_fp32_policy
    from real3dportrait_tpu_torch.weights import mock_init_

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device is visible")
    set_fp32_policy()
    print(f"card: {kernels.card_line()}")
    print(f"tree: {os.path.dirname(os.path.dirname(dm.__file__))}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    if "k1" in only:
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

    frame_args = frame_passes(dev) if only & {"k1", "k2", "k3", "k5a", "k5b"} else None
    if "k1" in only:
        for tag, (planes, coords, box_warp, dec_f) in zip(("coarse", "fine"), frame_args[0]):
            with torch.no_grad():
                got = dm.trigrid_decode(planes, coords, box_warp, dec_f)
                want = dm.trigrid_decode_plain(planes, coords, box_warp, dec_f)
                err = max(float((g - w).abs().max()) for g, w in zip(got, want))
                launch = kernels.device_ms(
                    lambda: dm.trigrid_decode(planes, coords, box_warp, dec_f))
                call = kernels.cuda_ms(lambda: dm.trigrid_decode(planes, coords, box_warp, dec_f))
            print(f"trigrid_decode [frame {tag} pass, {coords.shape[1]} pts]: per launch "
                  f"{launch:.4f} ms, per call {call:.4f} ms; max abs err {err:.2e}")
            del planes, coords, got, want

    if "k2" in only:
        k2_rows = []
        for s_c, s_f in ((16, 32), (48, 48)):
            depths, _, sigma, _, _, _ = merge_inputs(dev, gen, 16384, s_c, s_f, 32)
            u = renderer.importance_u(16384, s_f, dev)
            k2_rows.append((f"{s_c}+{s_f}", (depths, sigma, u)))
        if frame_args:
            d_c, _, u_f = frame_args[1]
            k2_rows.append((f"frame {d_c.shape[2]}+{u_f.shape[1]}", frame_args[1]))
        for tag, kargs in k2_rows:
            err = float((renderer.importance_sample(*kargs)
                         - renderer.importance_sample_plain(*kargs)).abs().max())
            launch = kernels.device_ms(lambda: renderer.importance_sample(*kargs))
            call = kernels.cuda_ms(lambda: renderer.importance_sample(*kargs))
            print(f"importance_sample [{tag}, {kargs[0].shape[1]} rays]: per launch "
                  f"{launch:.4f} ms, per call {call:.4f} ms; max abs err {err:.2e}")
        del k2_rows

    if "k3" in only:
        merge_rows = [(f"{s_c}+{s_f}", merge_inputs(dev, gen, 16384, s_c, s_f, 32))
                      for s_c, s_f in ((16, 32), (48, 48))]
        if frame_args:
            merge_args = frame_args[2]
            merge_rows.append((f"frame {merge_args[0].shape[2]}+{merge_args[3].shape[2]}",
                               merge_args))
        for tag, margs in merge_rows:
            got = renderer.merge_composite(*margs)
            want = renderer.merge_composite_plain(*margs)
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            launch = kernels.device_ms(lambda: renderer.merge_composite(*margs))
            call = kernels.cuda_ms(lambda: renderer.merge_composite(*margs))
            print(f"merge_composite [{tag}, {margs[0].shape[1]} rays]: per launch {launch:.4f} ms, "
                  f"per call {call:.4f} ms; max abs err {err:.2e}")
        del merge_rows

    if only & {"k5a", "k5b"}:
        import torch.nn.functional as F

        k5a, k5b = k5_rows(dev, gen, frame_args[3:] if frame_args else None)
        if "k5a" in only:
            for tag, kargs in k5a:
                got = torso.torso_deform_input(*kargs)
                same = torch.equal(got, torso.torso_deform_input(*kargs))
                err = float((got - torso.torso_deform_input_plain(*kargs)).abs().max())
                launch = kernels.device_ms(lambda: torso.torso_deform_input(*kargs))
                call = kernels.cuda_ms(lambda: torso.torso_deform_input(*kargs))
                print(f"torso_deform_input {list(kargs[0].shape)} K={kargs[1].shape[1]} [{tag}]: "
                      f"per launch {launch:.4f} ms, per call {call:.4f} ms; max abs err "
                      f"{err:.2e}; two launches {'bit-equal' if same else 'DIFFER'}")
        if "k5b" in only:
            for tag, (vol, grid) in k5b:
                got = torso.torso_warp_volume(vol, grid)
                same = torch.equal(got, torso.torso_warp_volume(vol, grid))
                err = float((got - torso.torso_warp_volume_plain(vol, grid)).abs().max())
                launch = kernels.device_ms(lambda: torso.torso_warp_volume(vol, grid))
                call = kernels.cuda_ms(lambda: torso.torso_warp_volume(vol, grid))
                lib = kernels.device_ms(lambda: F.grid_sample(
                    vol.permute(0, 4, 1, 2, 3), grid, mode="bilinear", padding_mode="border",
                    align_corners=True))
                print(f"torso_warp_volume {list(vol.shape)} [{tag}]: per launch {launch:.4f} "
                      f"ms, per call {call:.4f} ms, F.grid_sample per launch {lib:.4f} ms; max "
                      f"abs err {err:.2e}; two launches {'bit-equal' if same else 'DIFFER'}")
        del k5a, k5b
    del frame_args

    if "k4" in only:
        if hasattr(rasterizer, "rasterize_verts"):
            entry, plain = rasterizer.rasterize_verts, rasterizer.rasterize_verts_plain
            tag = "rasterize_verts"
        else:  # a tree from before it: its map in [0,1]
            tag = "rasterize"

            def entry(*args, **kw):
                out = rasterizer.rasterize(*args, **kw)
                return out["mask"], out["image"]

            def plain(verts, faces, attr, image_size):
                uv, z = rasterizer.project_to_screen(verts, 1015.0, 112.0, image_size)
                return rasterizer.secc_raster_plain(uv, z, faces, attr, image_size)
        for t in (1, 3, 16):
            verts, faces, attr = raster_inputs(dev, t)
            got = entry(verts, faces, attr, image_size=192)
            want = plain(verts, faces, attr, image_size=192)
            n_mask = int((got[0] != want[0]).sum())
            err = float((got[1] - want[1]).abs().max())
            def k4(verts=verts):
                return entry(verts, faces, attr, image_size=192)

            launch, call = kernels.device_ms(k4), kernels.cuda_ms(k4)
            split, kernel_ms, n = device_split(k4)
            print(f"secc_raster [{tag}, {t} x 192^2]: per launch {launch:.4f} ms, per call "
                  f"{call:.4f} ms; {n_mask} mask pixels differ, NCC max abs err {err:.2e}; device "
                  f"kernels a call (profiler): {n} launches, {kernel_ms:.4f} ms, host share of the "
                  f"call {call - kernel_ms:.4f} ms: {split}")
        secc = SECCRenderer(synthetic_bfm(n_vertices=35709), rasterize_size=192,
                            output_resolution=512, device=dev)
        coeffs = [verts.new_zeros((1, n)) for n in (80, 64, 3, 3)]
        call = kernels.cuda_ms(lambda: secc.render(*coeffs))
        split, kernel_ms, n = device_split(lambda: secc.render(*coeffs))
        print(f"SECC stage [SECCRenderer.render, 1 x 192^2 -> 512^2]: per call {call:.4f} ms; "
              f"device kernels a call (profiler): {n} launches, {kernel_ms:.4f} ms, host share "
              f"of the call {call - kernel_ms:.4f} ms: {split}")
        del verts, faces, attr, got, want, secc

    if "k7b" in only:
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
              f"{call:.4f} ms; max abs err {err:.2e}; two calls "
              f"{'bit-equal' if same else 'DIFFER'}; "
              f"while it runs: {sm_clock_while(lambda: torso.mfe_tail(*targs))}")
        del targs, got, want, again

    if "k6b" in only:
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
                ulp = torch.exp2(
                    torch.floor(torch.log2(want.float().abs().clamp_min(2.0 ** -126))) - 7)
                err = f"{float(((got.float() - want.float()).abs() / ulp).max()):g} bf16 ulps" \
                      f"{', bit-equal' if torch.equal(got, want) else ''}"
            else:
                err = f"max abs err {float((got - want).abs().max()):.2e}"
            launch = kernels.device_ms(lambda: ba.bias_act(x, bias, **kw))
            call = kernels.cuda_ms(lambda: ba.bias_act(x, bias, **kw))
            print(f"bias_act {tag} {list(shape)}: per launch {launch:.4f} ms, per call "
                  f"{call:.4f} ms; {err}")
            del x, got, want

    if "k3b" in only:
        margs = k3b_inputs(dev, gen)
        with torch.no_grad():
            got = renderer.merge_composite_backward(*margs)
            want = renderer.merge_composite_backward_plain(*margs)
            err = max(float((g - w_).abs().max()) / max(float(w_.abs().max()), 1e-30)
                      for g, w_ in zip(got, want))
            launch = kernels.device_ms(lambda: renderer.merge_composite_backward(*margs),
                                       launches=10)
            call = kernels.cuda_ms(lambda: renderer.merge_composite_backward(*margs))
            split, kernel_ms, n = device_split(
                lambda: renderer.merge_composite_backward(*margs), calls=5)
        print(f"merge_composite_backward [4,16384,48+48,32]: per launch {launch:.4f} ms, per "
              f"call {call:.4f} ms; max err {err:.2e} of scale; device kernels a call "
              f"(profiler): {split}")
        del margs, got, want

    if "k7bb" in only:
        from real3dportrait_tpu_torch.ops import conv3d as c3d

        targs = k7bb_inputs(dev, gen)
        x, ow = targs[0], targs[2]
        with torch.no_grad():
            got = torso.mfe_tail_backward(*targs)
            want = torso.mfe_tail_backward_plain(*targs)
            errs = [float((g - w_).abs().max()) / max(float(w_.abs().max()), 1e-30)
                    for g, w_ in zip(got, want)]
            launch = kernels.device_ms(lambda: torso.mfe_tail_backward(*targs), launches=5)
            call = kernels.cuda_ms(lambda: torso.mfe_tail_backward(*targs), reps=5)
            split, kernel_ms, n = device_split(lambda: torso.mfe_tail_backward(*targs),
                                               calls=5)
            print(f"mfe_tail_backward x {list(x.shape)}: per launch {launch:.4f} ms, per call "
                  f"{call:.4f} ms; max err of scale (dx, d mask_w, d mask_b, d occ_w, d occ_b) "
                  f"{', '.join(f'{e:.2e}' for e in errs)}; device kernels a call (profiler, "
                  f"{kernel_ms:.4f} ms): {split}")
            for name, fn in tail_backward_parts(targs):
                print(f"mfe_tail_backward part [{name}]: per launch "
                      f"{kernels.device_ms(fn, launches=5):.4f} ms")
            # the occlusion heads' weight gradient through K7a's weight-gradient
            # kernel on the fold as a depth-1 volume: only its kd = 3 row of taps
            # lies inside the volume
            b, c, d, h, w = x.shape
            fold = x.reshape(b, c * d, 1, h, w)
            dpre = torch.randn((b, 2, 1, h, w), device=dev, generator=gen)

            def occ_wgrad():
                dw, db = c3d.conv3d_weight_grad(fold, dpre, 7)
                return dw[:, :, 3].contiguous(), db
            gw, gb = occ_wgrad()
            pw = torch.nn.grad.conv2d_weight(fold[:, :, 0], ow.shape, dpre[:, :, 0], padding=3)
            werr = float((gw - pw).abs().max()) / float(pw.abs().max())
            print(f"occlusion heads' weight gradient through conv3d_weight_grad "
                  f"[{b},{c * d},1,{h},{w}] k 7 -> [:, :, 3]: per launch "
                  f"{kernels.device_ms(occ_wgrad, launches=5):.4f} ms; max err {werr:.2e} of "
                  f"scale; device kernels a call (profiler): {device_split(occ_wgrad, 5)[0]}")
        del targs, got, want, fold, dpre

    if only & {"k5ab", "k5bb", "k5bp"}:
        k5a, k5b = k5_adjoint_inputs(dev, gen)
        with torch.no_grad():
            for tag, kargs in k5a if "k5ab" in only else ():
                dout, kp_s, kp_d, vol_shape = kargs
                got = torso.torso_deform_input_backward(*kargs)
                same = torch.equal(got, torso.torso_deform_input_backward(*kargs))
                want = torso.torso_deform_input_backward_plain(*kargs)
                err = float((got - want).abs().max()) / float(want.abs().max())
                launch = kernels.device_ms(lambda: torso.torso_deform_input_backward(*kargs))
                call = kernels.cuda_ms(lambda: torso.torso_deform_input_backward(*kargs))
                b, d, h, w, c = vol_shape
                k1 = kp_s.shape[1] + 1
                grid = torso.create_sparse_motions(kp_s, kp_d, d, h, w).reshape(b, k1 * d, h, w, 3)
                gout = dout.reshape(b, k1, 1 + c, d, h, w)[:, :, 1:].transpose(1, 2).reshape(
                    b, c, k1 * d, h, w).contiguous()
                vin = torch.zeros((b, c, d, h, w), device=dev)
                lib = kernels.device_ms(lambda: torch.ops.aten.grid_sampler_3d_backward(
                    gout, vin, grid, 0, 0, True, [True, False]))
                print(f"torso_deform_input_backward {list(vol_shape)} K+1={k1} [{tag}]: per "
                      f"launch {launch:.4f} ms, per call {call:.4f} ms, grid_sampler_3d_backward "
                      f"per launch {lib:.4f} ms; max err {err:.2e} of scale; two calls "
                      f"{'bit-equal' if same else 'DIFFER'}")
                del got, want, grid, gout, vin
            for tag, kargs in k5b if "k5bb" in only else ():
                fs, deform, dout = kargs
                got = torso.torso_warp_volume_backward(*kargs)
                want = torso.torso_warp_volume_backward_plain(*kargs)
                errs = [float((g - w_).abs().max()) / float(w_.abs().max())
                        for g, w_ in zip(got, want)]
                launch = kernels.device_ms(lambda: torso.torso_warp_volume_backward(*kargs))
                call = kernels.cuda_ms(lambda: torso.torso_warp_volume_backward(*kargs))
                b, d, h, w, c = fs.shape
                gout, vin = dout.view(b, c, d, h, w), fs.permute(0, 4, 1, 2, 3).contiguous()
                lib = kernels.device_ms(lambda: torch.ops.aten.grid_sampler_3d_backward(
                    gout, vin, deform, 0, 1, True, [True, True]))
                print(f"torso_warp_volume_backward {list(fs.shape)} [{tag}]: per launch "
                      f"{launch:.4f} ms, per call {call:.4f} ms, grid_sampler_3d_backward per "
                      f"launch {lib:.4f} ms; max err of scale (d fs, d deformation) "
                      f"{errs[0]:.2e}, {errs[1]:.2e}")
                del got, want, vin
            if "k5bp" in only:
                k5b_adjoint_parts(k5b[0][1])
        del k5a, k5b


if __name__ == "__main__":
    main()

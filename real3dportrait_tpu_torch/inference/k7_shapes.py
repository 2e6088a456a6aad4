"""K7a, the torso's 3D convolution, at every distinct 3D conv of the
standard torso, beside cuDNN's ``F.conv3d`` (TF32 off), on a CUDA device.

    python3 real3dportrait_tpu_torch/inference/k7_shapes.py [--tree DIR]

Per shape (``TORSO_CONV3D_SHAPES``, ``models/torso.py`` at the standard
preset): the device time of one launch (20 back-to-back launches behind a
spin kernel, ``kernels.device_ms``) and of one call on an idle device
(``kernels.cuda_ms``), for the kernel and for cuDNN, and the kernel's max
abs error against cuDNN on N(0,1) inputs with N(0, 1/fan_in) weights.
``--tree DIR`` imports the port from the checkout at DIR instead of this
one (run the file, not ``-m``), so that one session on the card can time
two trees in turns.
"""

from __future__ import annotations

import argparse
import os
import sys

# tag, (Ci, Co, k, (D, H, W)): the motion-field estimator's 7^3
# tgt_head_fuser and U-Net convs down_0-4 and up_0-4
# (models/torso.py:367-413), and the appearance extractor's ResBlock3D
TORSO_CONV3D_SHAPES = [("fuser 7^3 [1,89,16,64,64]->32", (89, 32, 7, (16, 64, 64)))] + [
    (f"{name} 3^3 [1,{ci},16,{s},{s}]->{co}", (ci, co, 3, (16, s, s))) for name, ci, co, s in (
        ("down_0", 25, 64, 64), ("down_1", 64, 128, 32), ("down_2", 128, 256, 16),
        ("down_3", 256, 512, 8), ("down_4", 512, 1024, 4), ("up_0", 1024, 512, 4),
        ("up_1", 512, 256, 8), ("up_2", 256, 128, 16), ("up_3", 128, 64, 32),
        ("up_4", 64, 32, 64), ("res3d", 32, 32, 64))]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", help="a checkout of the repo to import the port from")
    args = parser.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    root = os.path.abspath(args.tree or here)
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from real3dportrait_tpu_torch import kernels
    from real3dportrait_tpu_torch.ops import conv3d as c3d
    from real3dportrait_tpu_torch.utils.precision import set_fp32_policy

    if not torch.cuda.is_available():
        raise SystemExit("k7_shapes: no CUDA device is visible")
    set_fp32_policy()
    print(f"card: {kernels.card_line()}")
    print(f"tree: {os.path.dirname(os.path.dirname(c3d.__file__))}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    total = [0.0, 0.0]
    for tag, (ci, co, k, dhw) in TORSO_CONV3D_SHAPES:
        x = torch.randn((1, ci, *dhw), device=dev, generator=gen)
        w = torch.randn((co, ci, k, k, k), device=dev, generator=gen) / (ci * k ** 3) ** 0.5
        b = torch.randn((co,), device=dev, generator=gen)
        err = float((c3d.conv3d(x, w, b) - F.conv3d(x, w, b, padding=k // 2)).abs().max())
        ours = [kernels.device_ms(lambda: c3d.conv3d(x, w, b)),
                kernels.cuda_ms(lambda: c3d.conv3d(x, w, b))]
        theirs = [kernels.device_ms(lambda: F.conv3d(x, w, b, padding=k // 2)),
                  kernels.cuda_ms(lambda: F.conv3d(x, w, b, padding=k // 2))]
        total = [total[0] + ours[0], total[1] + theirs[0]]
        print(f"K7a {tag}: per launch {ours[0]:.4f} ms, per call {ours[1]:.4f} ms; cuDNN "
              f"per launch {theirs[0]:.4f} ms, per call {theirs[1]:.4f} ms; max abs err "
              f"{err:.2e}")
        del x, w, b
    print(f"K7a all {len(TORSO_CONV3D_SHAPES)} shapes, per launch: {total[0]:.4f} ms "
          f"(cuDNN {total[1]:.4f} ms)")


if __name__ == "__main__":
    main()

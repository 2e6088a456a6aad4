"""Digests of kernel K6b's outputs on seeded inputs, written to a file, so
that two trees' K6b can be compared bit for bit on one card.

    python3 real3dportrait_tpu_torch/inference/k6b_bits.py [--tree DIR] --out FILE
    python3 real3dportrait_tpu_torch/inference/k6b_bits.py --compare A B

The calls are the SR heads' epilogue with the shared [H,W] noise plane
(``noise_mode="const"``: demodulation, noise, bias, lrelu, gain sqrt 2,
clamp 256) at [4,256,256,256] in fp32 and [4,128,512,512] in bf16, the
forward and the gradient's dx, and the dense layers' [4,512] bias and
lrelu; inputs N(0, 2^2) from a seed, the same in every tree. (The
gradient's sums db, dscale and dnoise add by atomics, in an order that
changes from run to run: they have no bits to compare.) Each output's
SHA-256 goes to the JSON file. ``--tree DIR`` imports the port from the
checkout at DIR (each tree builds its own kernels); ``--compare`` prints,
for each output, whether the two files hold the same digest, and exits 1
where one differs.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys


def outputs() -> dict:
    import torch

    from real3dportrait_tpu_torch.ops import bias_act as ba

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    out = {}
    for shape, dtype in (((4, 256, 256, 256), torch.float32),
                         ((4, 128, 512, 512), torch.bfloat16)):
        x = (2 * randn(*shape)).to(dtype)
        noise, bias = randn(*shape[2:]), 0.3 * randn(shape[1])
        scale = torch.rand((shape[0], shape[1]), device=dev, generator=gen) + 0.5
        kw = dict(act="lrelu", gain=2 ** 0.5, clamp=256.0, axis=1, scale=scale)
        with torch.no_grad():
            y = ba.bias_act(x, bias, noise=noise, **kw)
            dy = randn(*shape).to(dtype)
            dx = ba.bias_act_grad(dy, y, x, **kw, need_noise=True)[0]
        tag = f"{list(shape)} {str(dtype)[6:]}"
        out[f"forward {tag}"] = digest(y)
        out[f"gradient dx {tag}"] = digest(dx)
    x = 2 * randn(4, 512)
    out["dense [4, 512] lrelu"] = digest(ba.bias_act(x, 0.3 * randn(512), act="lrelu"))
    return out


def digest(t) -> str:
    """SHA-256 of a tensor's bytes (its dtype and shape in the text)."""
    import torch

    raw = t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16 else t.dtype).cpu()
    return f"{t.dtype} {list(t.shape)} {hashlib.sha256(raw.numpy().tobytes()).hexdigest()}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--compare", nargs=2, default=None)
    args = ap.parse_args()
    import torch

    if args.compare:
        a, b = (json.load(open(p)) for p in args.compare)
        same = True
        for k in a:
            eq = a[k] == b.get(k)
            same &= eq
            print(f"k6b_bits {k}: {'bit-equal' if eq else 'DIFFERENT'}")
        return 0 if same and set(a) == set(b) else 1
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, os.path.abspath(args.tree or here))
    from real3dportrait_tpu_torch.kernels import card_line

    import real3dportrait_tpu_torch

    with open(args.out, "w") as f:
        json.dump(outputs(), f, indent=1)
    print(f"k6b_bits: {args.out} from {os.path.dirname(real3dportrait_tpu_torch.__file__)} "
          f"({card_line()})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

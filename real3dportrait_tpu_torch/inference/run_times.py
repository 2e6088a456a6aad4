"""Wall time per frame of ``run``, the port's end-to-end metric, repeated,
on a CUDA device.

    python3 real3dportrait_tpu_torch/inference/run_times.py [--tree DIR] [--repeat N]
        [--frame_batch FB]

The call ``chip_smoke.py``'s main path makes: ``Real3DPortraitPipeline()``'s
default model (seeded mock weights, the 35,709-vertex synthetic mesh,
``fast``) runs a 4 s seeded wav to 100 frames and a written video with the
JAX defaults, after a warm-up on 0.64 s; each of ``--repeat`` runs prints
its wall time per frame (host features, audio-to-motion, source
preparation, caches and video writing included), then their median.
``--frame_batch FB`` renders FB frames a device step (``run``'s
``frame_batch``), the warm-up too.
``--tree DIR`` imports the port and ``chip_smoke.py``'s inputs from the
checkout at DIR (run the file, not ``-m``), so that one run on the card
can alternate two trees.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile
import time


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", help="a checkout of the repo to import the port from")
    parser.add_argument("--repeat", type=int, default=3)
    parser.add_argument("--frame_batch", type=int, default=1)
    args = parser.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, os.path.abspath(args.tree or here))
    import numpy as np
    import torch

    import chip_smoke
    from real3dportrait_tpu_torch.utils.precision import set_fp32_policy

    if not torch.cuda.is_available():
        raise SystemExit("run_times: no CUDA device is visible")
    set_fp32_policy()
    print(f"card: {chip_smoke.card_line()}")
    print(f"tree: {os.path.dirname(os.path.abspath(chip_smoke.__file__))}, "
          f"frame_batch {args.frame_batch}")
    dev = torch.device("cuda", 0)
    pipe = chip_smoke.make_pipeline(chip_smoke.DEFAULT_CONFIG, "fast", dev)
    src = np.random.RandomState(0).randint(0, 256, (pipe.res, pipe.res, 3)).astype(np.uint8)
    wav = chip_smoke.seeded_wav(4.0)
    walls = []
    with tempfile.TemporaryDirectory() as out_dir:
        pipe.run(src, wav=chip_smoke.seeded_wav(0.64, seed=1), frame_batch=args.frame_batch,
                 out_path=os.path.join(out_dir, "warm.mp4"))
        for _ in range(args.repeat):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames = pipe.run(src, wav=wav, frame_batch=args.frame_batch,
                              out_path=os.path.join(out_dir, "run.mp4"))
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0) / len(frames))
            print(f"run: {len(frames)} frames, {walls[-1]:.2f} ms/frame of wall")
    print(f"run: median {statistics.median(walls):.2f} ms/frame over {len(walls)} runs")


if __name__ == "__main__":
    main()

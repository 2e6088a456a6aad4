"""How often ``torch.profiler`` with the CUDA activity alone records no
device event for one K6b call, after the K4 tests' work, on a CUDA device.

    python3 tests/cuda_profiler_probe.py [--runs 2] [--probes 4]

Each scenario runs in ``--runs`` fresh processes. A process makes the K6b
call of ``test_k6b_bf16_bit_equal_with_fp32_terms_and_no_casts``, profiles
it once (as the K1 tests profile before the K4 tests in
``test_torch_kernels_cuda.py``), does the scenario's work, then profiles
the call ``--probes`` times with the CUDA activity alone and as often with
the CPU activity too, and prints the device events each profile recorded.
Scenarios: ``none``; ``tests``, the three K4 tests of that file (T = 1, 3,
16 at 512^2, and two meshes in a row); ``tests_cleared``, the same, then
the z-buffer cache emptied and ``torch.cuda.empty_cache()``; ``scene``,
``_k4_scene`` at T = 16 alone; ``plain`` and ``kernel``, that scene through
``rasterize_verts_plain`` or ``rasterize_verts`` at 512^2.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SCENARIOS = ("none", "tests", "tests_cleared", "scene", "plain", "kernel")


def _device_events(activities, fn) -> int:
    import torch

    with torch.profiler.profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())


def child(scenario: str, probes: int) -> None:
    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [here, os.path.dirname(here)]
    import test_torch_kernels_cuda as tk

    from real3dportrait_tpu_torch.geometry import rasterizer
    from real3dportrait_tpu_torch.ops import bias_act as ba

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(25)
    x = (40 * torch.randn((1, 16, 33, 35), device=dev, generator=g)).bfloat16()
    kw = dict(act="lrelu", gain=2 ** 0.5, clamp=25.0, axis=1,
              scale=torch.rand((1, 16), device=dev, generator=g) + 0.5,
              noise=torch.randn((33, 35), device=dev, generator=g))
    b = torch.randn((16,), device=dev, generator=g)

    def k6b():
        return ba.bias_act(x, b, **kw)

    cuda = [torch.profiler.ProfilerActivity.CUDA]
    both = [torch.profiler.ProfilerActivity.CPU, *cuda]
    k6b()
    torch.cuda.synchronize()
    first = _device_events(cuda, k6b)
    if scenario.startswith("tests"):
        for t in (1, 3, 16):
            tk.test_k4_frames_512_large_faces_and_faces_across_znear(dev, t)
        tk.test_k4_two_meshes_in_a_row_and_bit_equal_launches(dev)
        if scenario == "tests_cleared":
            rasterizer._ZBUFFERS.clear()
            torch.cuda.empty_cache()
    elif scenario != "none":
        verts, faces, attr = tk._k4_scene(dev, 16, seed=36)
        fn = {"plain": rasterizer.rasterize_verts_plain,
              "kernel": rasterizer.rasterize_verts}.get(scenario)
        if fn is not None:
            fn(verts, faces, attr, 1015.0, 112.0, 512)
    torch.cuda.synchronize()
    alone = [_device_events(cuda, k6b) for _ in range(probes)]
    with_cpu = [_device_events(both, k6b) for _ in range(probes)]
    print(json.dumps({"scenario": scenario, "first": first, "cuda_alone": alone,
                      "cuda_and_cpu": with_cpu}), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=2)
    parser.add_argument("--probes", type=int, default=4)
    parser.add_argument("--child", choices=SCENARIOS, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        child(args.child, args.probes)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("cuda_profiler_probe: no CUDA device is visible")
    empty = {}
    for scenario in SCENARIOS:
        for _ in range(args.runs):
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", scenario,
                                  "--probes", str(args.probes)], capture_output=True, text=True)
            line = (out.stdout.strip().splitlines() or [""])[-1]
            print(line if out.returncode == 0 else
                  f"{scenario}: exit {out.returncode}: {out.stderr[-2000:]}", flush=True)
            if out.returncode == 0:
                row = json.loads(line)
                n = empty.setdefault(scenario, [0, 0, 0])
                n[0] += sum(v == 0 for v in row["cuda_alone"])
                n[1] += sum(v == 0 for v in row["cuda_and_cpu"])
                n[2] += len(row["cuda_alone"])
    for scenario, (alone, with_cpu, total) in empty.items():
        print(f"{scenario}: no device event in {alone} of {total} CUDA-alone profiles, "
              f"{with_cpu} of {total} with the CPU activity too")


if __name__ == "__main__":
    main()

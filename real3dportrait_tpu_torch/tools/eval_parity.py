"""PSNR / LPIPS parity of the port's renders against reference frames
(port of ``tools/eval_parity.py``):

1. build the released geometry's pipeline (``configs/real3d_orig.yaml``,
   the ``reference`` 48+48 quadrature unless ``--hparams`` names a preset)
   from converted checkpoint directories (``--a2m_ckpt``, ``--s2v_ckpt``,
   as the JAX package's checkpoints), from the released torch checkpoints
   (``--torch_a2m``, ``--torch_s2v``: converted first by the port's
   ``tools/convert_torch_ckpt.py`` into ``<out>/converted``), or seeded
   mock weights;
2. render the fixture batch: ``<fixtures>/inputs.npz`` (src_img and the
   driving coefficients id / exp / euler / trans) and
   ``<fixtures>/ref_frames.npy`` (the frames to match);
3. report per-frame and mean PSNR and LPIPS (``lpips_vgg`` where
   ``lpips_vgg_ckpt`` is wired, else the pyramid surrogate, the kind
   stamped in the report) in ``<out>/parity_report.json``, with
   ``rendered_frames.npy`` beside it, and pass or fail against the
   tolerances (mean PSNR >= 30 dB, LPIPS(vgg) <= 0.10).

The port-versus-JAX check: the JAX package's tool writes the fixtures
(``inputs.npz`` and its own ``ref_frames.npy``) and the converted
checkpoint directories; this tool renders the same driving coefficients
from the same directories; or both tools convert the same released torch
checkpoints (``--torch_a2m`` / ``--torch_s2v``), each with its own package's
converter, which write the same bytes.

Usage::

    python -m real3dportrait_tpu_torch.tools.eval_parity --fixtures F \\
        --a2m_ckpt D/audio2secc --s2v_ckpt D/secc2video --out /tmp/parity
    # the released torch checkpoints, converted into /tmp/parity/converted
    python -m real3dportrait_tpu_torch.tools.eval_parity --fixtures F \
        --torch_a2m A.ckpt --torch_s2v S.ckpt --out /tmp/parity
    # no weights: the whole mechanism on mock weights, PSNR must be inf
    python -m real3dportrait_tpu_torch.tools.eval_parity --selftest --out /tmp/parity

``--device`` is ``cuda`` by default; ``--device cpu`` runs the plain
versions on the CPU.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_pipeline(args, a2m_dir: str, s2v_dir: str):
    from real3dportrait_tpu_torch.config import load_config, parse_overrides
    from real3dportrait_tpu_torch.inference.pipeline import Real3DPortraitPipeline

    cfg = load_config(os.path.join(ROOT, "configs", "real3d_orig.yaml"),
                      parse_overrides(args.hparams))
    # parity renders integrate with the reference's quadrature (48+48); the
    # inference-speed presets are not parity-comparable
    if "sampling_preset" not in (args.hparams or ""):
        cfg = {**cfg, "sampling_preset": "reference"}
    return Real3DPortraitPipeline(
        cfg=cfg, mock_weights=args.mock_weights or not (a2m_dir and s2v_dir),
        a2m_ckpt_dir=a2m_dir, secc2video_ckpt_dir=s2v_dir, bfm_dir=args.bfm_dir or None,
        use_torso=True, seed=0, device=args.device)


def render_fixture_frames(pipe, inputs: dict) -> torch.Tensor:
    """The fixture's driving coefficients rendered as the reference's
    per-frame loop does (`real3d_infer.py:436-489`): the id / exp
    sequences and the euler / trans pose, no blink; [T,H,W,3] in [-1,1] on
    the pipeline's device."""
    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(pipe.device)

    coeffs = {
        "id": dev(inputs["id"][:1]),
        "exp": dev(inputs["src_exp"][:1]) if "src_exp" in inputs
        else torch.zeros((1, 64), device=pipe.device),
        "euler": dev(inputs["euler"][:1]),
        "trans": dev(inputs["trans"][:1]),
    }
    return pipe.synthesize(
        np.asarray(inputs["src_img"]), dev(inputs["exp"]), coeffs,
        pose_seq=(dev(inputs["euler"]), dev(inputs["trans"])), blink_mode="none",
        prepare_source_images=bool(inputs.get("prepare_source_images", False)))


def make_selftest_fixtures(pipe, path: str, t: int = 4, res: int | None = None) -> None:
    """A synthetic fixture batch (JAX's arrays from the same ``RandomState``)
    and "reference" frames rendered by this pipeline, so that the selftest
    closes with PSNR = inf."""
    res = res or pipe.res
    rng = np.random.RandomState(0)
    inputs = {
        "src_img": rng.uniform(-1, 1, (res, res, 3)).astype(np.float32),
        "id": np.tile(rng.randn(1, 80).astype(np.float32) * 0.1, (t, 1)),
        "exp": rng.randn(t, 64).astype(np.float32) * 0.1,
        "euler": np.zeros((t, 3), np.float32),
        "trans": np.zeros((t, 3), np.float32),
    }
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "inputs.npz"), **inputs)
    frames = render_fixture_frames(pipe, inputs)
    np.save(os.path.join(path, "ref_frames.npy"), frames.cpu().numpy())
    print(f"| wrote selftest fixtures ({t} frames @ {res}^2) -> {path}")


def _scores(pipe, frames: torch.Tensor, ref: torch.Tensor):
    from real3dportrait_tpu_torch.metrics import lpips, lpips_kind, psnr

    with torch.no_grad():
        psnr_v = psnr(frames, ref).cpu().numpy()
        lpips_v = lpips(frames, ref, pipe.cfg).cpu().numpy()
    return psnr_v, lpips_v, lpips_kind(pipe.cfg, pipe.device)


def evaluate(pipe, fixtures: str, out_dir: str, psnr_min: float, lpips_max: float) -> dict:
    inputs = dict(np.load(os.path.join(fixtures, "inputs.npz")))
    ref = np.load(os.path.join(fixtures, "ref_frames.npy"))
    if ref.dtype == np.uint8:
        ref = ref.astype(np.float32) / 127.5 - 1.0

    frames = render_fixture_frames(pipe, inputs)
    k = min(len(frames), len(ref))
    frames = frames[:k]
    psnr_v, lpips_v, kind = _scores(pipe, frames, torch.from_numpy(ref[:k]).to(frames.device))
    report = {
        "frames": int(k),
        "psnr_per_frame": [round(float(v), 3) for v in psnr_v],
        "psnr_mean": round(float(psnr_v.mean()), 3),
        "lpips_kind": kind,
        "lpips_per_frame": [round(float(v), 5) for v in lpips_v],
        "lpips_mean": round(float(lpips_v.mean()), 5),
        "tolerances": {"psnr_min": psnr_min, "lpips_max": lpips_max,
                       "lpips_tolerance_applies": kind == "lpips_vgg"},
        "pass": bool(psnr_v.mean() >= psnr_min
                     and (kind != "lpips_vgg" or lpips_v.mean() <= lpips_max)),
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "parity_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    np.save(os.path.join(out_dir, "rendered_frames.npy"), frames.cpu().numpy())
    return report


def preset_delta(pipe_ref, args, inputs: dict) -> dict:
    """The fixture's driving coefficients under the shipped ``fast`` preset,
    with the reference-preset pipeline's weights (its ``state_dict``),
    against the reference preset: the number that says whether the shipped default is
    visually lossless (with mock weights, the mechanism and an
    untrained-field bound)."""
    from real3dportrait_tpu_torch.inference.pipeline import (
        Real3DPortraitPipeline, SHIPPED_SAMPLING_PRESET,
    )

    ref_frames = render_fixture_frames(pipe_ref, inputs)
    pipe_fast = Real3DPortraitPipeline(
        cfg={**pipe_ref.cfg, "sampling_preset": SHIPPED_SAMPLING_PRESET}, mock_weights=True,
        bfm_dir=args.bfm_dir or None, use_torso=True, seed=0, device=pipe_ref.device)
    # identical weights: the quadrature changes sample counts, not parameters
    pipe_fast.model.load_state_dict(pipe_ref.model.state_dict())
    fast_frames = render_fixture_frames(pipe_fast, inputs)
    k = min(len(fast_frames), len(ref_frames))
    psnr_v, lpips_v, kind = _scores(pipe_ref, fast_frames[:k], ref_frames[:k])
    return {
        "fast_preset": SHIPPED_SAMPLING_PRESET,
        "frames": int(k),
        "psnr_fast_vs_reference_mean": round(float(psnr_v.mean()), 3),
        "psnr_fast_vs_reference_min": round(float(psnr_v.min()), 3),
        "lpips_kind": kind,
        "lpips_fast_vs_reference_mean": round(float(lpips_v.mean()), 5),
        "weights": "mock" if args.mock_weights or args.selftest else "real",
    }


def main(argv=None) -> int:
    import argparse

    from real3dportrait_tpu_torch.utils.precision import set_fp32_policy

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--torch_a2m", default="", help="released audio2secc torch ckpt")
    p.add_argument("--torch_s2v", default="", help="released secc2video torch ckpt")
    p.add_argument("--a2m_ckpt", default="", help="converted audio2secc checkpoint dir")
    p.add_argument("--s2v_ckpt", default="", help="converted secc2video checkpoint dir")
    p.add_argument("--fixtures", default="", help="dir with inputs.npz + ref_frames.npy")
    p.add_argument("--out", required=True)
    p.add_argument("--bfm_dir", default="")
    p.add_argument("--mock_weights", action="store_true")
    p.add_argument("--selftest", action="store_true",
                   help="mock weights + self-generated fixtures (PSNR must be inf)")
    p.add_argument("--psnr_min", type=float, default=30.0)
    p.add_argument("--lpips_max", type=float, default=0.10)
    p.add_argument("--hparams", default="", help="config overrides a=1,b=2")
    p.add_argument("--no_preset_delta", action="store_true",
                   help="skip the fast-vs-reference quadrature delta render")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    set_fp32_policy()
    a2m_dir, s2v_dir = args.a2m_ckpt, args.s2v_ckpt
    if args.torch_a2m or args.torch_s2v:
        from real3dportrait_tpu_torch.tools.convert_torch_ckpt import main as convert_main

        conv_out = os.path.join(args.out, "converted")
        conv_args = ["--out", conv_out, "--backbone_mode", "composite"]
        if args.torch_a2m:
            conv_args += ["--audio2secc", args.torch_a2m]
            a2m_dir = os.path.join(conv_out, "audio2secc")
        if args.torch_s2v:
            conv_args += ["--secc2video", args.torch_s2v]
            s2v_dir = os.path.join(conv_out, "secc2video")
        convert_main(conv_args)

    if args.selftest:
        args.mock_weights = True
    pipe = build_pipeline(args, a2m_dir, s2v_dir)

    fixtures = args.fixtures
    if args.selftest and not fixtures:
        fixtures = os.path.join(args.out, "fixtures")
        make_selftest_fixtures(pipe, fixtures)

    report = evaluate(pipe, fixtures, args.out, args.psnr_min, args.lpips_max)

    if not args.no_preset_delta:
        inputs = dict(np.load(os.path.join(fixtures, "inputs.npz")))
        report["sampling_preset_delta"] = preset_delta(pipe, args, inputs)
        with open(os.path.join(args.out, "parity_report.json"), "w") as f:
            json.dump(report, f, indent=2)

    print(json.dumps({k: report[k] for k in
                      ("frames", "psnr_mean", "lpips_mean", "lpips_kind", "pass")}))
    if "sampling_preset_delta" in report:
        print(json.dumps({"sampling_preset_delta": report["sampling_preset_delta"]}))
    print(f"| full report -> {os.path.join(args.out, 'parity_report.json')}")
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())

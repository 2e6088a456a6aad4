"""Inference CLI of the port (the flags of ``real3dportrait_tpu/inference/cli.py``
and ``--device``):

    python -m real3dportrait_tpu_torch.inference.cli --src_img face.png \\
        --drv_aud speech.wav [--drv_pose pose.npy] [--bg_img bg.png] \\
        --out_name out.mp4 [--a2m_ckpt DIR --s2v_ckpt DIR] \\
        [--hubert_path hubert.msgpack] [--temperature 0.2] [--device cuda]

The source image is any RGB image (or .npy); the driving audio a 16 kHz
wav, an .npy of HuBERT features or of a motion-coefficient dict, or an
.mp4 whose frames' fitted expression drives the face; ``--drv_pose`` takes
an .npy coefficient dict or an .mp4 whose fitted euler and trans drive the
head pose (the fit: ``geometry/fit_3dmm.py`` on the naive landmark
extractor, on ``--device``).
Weights are seeded mock weights unless both ``--a2m_ckpt`` and
``--s2v_ckpt`` are given and ``--mock_weights`` is not (the JAX CLI's
rule): directories of the JAX package's msgpack checkpoints, such as
``python -m real3dportrait_tpu_torch.tools.convert_torch_ckpt --out DIR``
writes from the released torch checkpoints (``DIR/audio2secc``,
``DIR/secc2video``). ``--hubert_path`` takes the ``.msgpack`` tree of
``convert_hubert`` (written with ``utils/msgpack_ckpt.msgpack_serialize``).
"""

from __future__ import annotations

import argparse
import os
import time
import wave

import numpy as np


def load_image(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    try:
        import imageio

        return np.asarray(imageio.imread(path))[..., :3]
    except Exception:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))


def load_wav(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    with wave.open(path, "rb") as w:
        if w.getframerate() != 16000:
            raise ValueError(f"{path}: expecting 16 kHz audio, got {w.getframerate()} Hz")
        data = np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16)
        if w.getnchannels() > 1:
            data = data.reshape(-1, w.getnchannels()).mean(-1)
        return (data / 32768.0).astype(np.float32)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    from real3dportrait_tpu_torch.inference.pipeline import SHIPPED_SAMPLING_PRESET

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--src_img", required=True)
    p.add_argument("--drv_aud", required=True,
                   help="16 kHz wav, .npy (HuBERT features or a motion-coeff dict), or .mp4 "
                        "(the expression fitted to a driving video)")
    p.add_argument("--drv_pose", default="static",
                   help="'static', an .npy coeff dict with euler and trans, or .mp4 (the pose "
                        "fitted to a driving video)")
    p.add_argument("--map_to_init_pose", default="True",
                   help="offset the driving pose so that frame 0 matches the source")
    p.add_argument("--bg_img", default="")
    p.add_argument("--out_name", default="output.mp4")
    p.add_argument("--out_mode", default="final", choices=["final", "concat_debug"])
    p.add_argument("--a2m_ckpt", default="",
                   help="directory of audio-to-motion msgpack checkpoints")
    p.add_argument("--s2v_ckpt", default="",
                   help="directory of secc2video msgpack checkpoints")
    p.add_argument("--bfm_dir", default="")
    p.add_argument("--hubert_path", default="",
                   help="a .msgpack HuBERT tree (tools/convert_torch_ckpt.py convert_hubert); "
                        "without it the log-mel is tiled to 1024 channels")
    p.add_argument("--temperature", type=float, default=0.2)
    p.add_argument("--mouth_amp", type=float, default=0.45)
    p.add_argument("--blink_mode", default="period", choices=["period", "none"])
    p.add_argument("--head_torso_threshold", type=float, default=None,
                   help="0.1-1.0; turn it up if the hair is translucent")
    p.add_argument("--min_face_area_percent", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=None,
                   help="weights and sampling seed; default derived from the time")
    p.add_argument("--sampling_preset", default=SHIPPED_SAMPLING_PRESET,
                   choices=["reference", "balanced", "fast", "config"],
                   help="volume-render samples per ray: reference 48+48, balanced 24+32, "
                        "fast 16+32 (default), config the YAML's")
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--mock_weights", action="store_true",
                   help="seeded random weights even where both checkpoints are given")
    p.add_argument("--low_memory_usage", action="store_true",
                   help="stream frames to the writer without keeping them")
    p.add_argument("--frame_batch", type=int, default=1,
                   help="frames a device step; on an H100, 2-5 are currently slower than 1 "
                        "(cuDNN picks an FFT for one conv at those batches), 8 and 16 are not")
    p.add_argument("--head_only", action="store_true", help="no torso/background fusion")
    p.add_argument("--hparams", default="", help="config overrides a.b=1,c=2")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def pipeline_from_args(args: argparse.Namespace):
    """The pipeline the flags describe: mock weights unless both checkpoint
    directories are given (and ``--mock_weights`` is not), as the JAX CLI
    decides."""
    from real3dportrait_tpu_torch.config import load_config, parse_overrides
    from real3dportrait_tpu_torch.inference.pipeline import (
        DEFAULT_CONFIG,
        Real3DPortraitPipeline,
    )

    cfg = load_config(DEFAULT_CONFIG, parse_overrides(args.hparams))
    cfg["map_to_init_pose"] = args.map_to_init_pose in ("True", "true", "1")
    if args.head_torso_threshold is not None:
        cfg["htbsr_head_threshold"] = args.head_torso_threshold
    cfg["sampling_preset"] = args.sampling_preset
    seed = args.seed if args.seed is not None else int(time.time()) % (2 ** 31)
    return Real3DPortraitPipeline(
        cfg, use_torso=not args.head_only,
        mock_weights=args.mock_weights or not (args.a2m_ckpt and args.s2v_ckpt),
        a2m_ckpt_dir=args.a2m_ckpt, secc2video_ckpt_dir=args.s2v_ckpt,
        bfm_dir=args.bfm_dir or None, seed=seed, device=args.device,
        hubert_path=args.hubert_path or None)


def main(argv: list[str] | None = None) -> None:
    from real3dportrait_tpu_torch.inference.infer_utils import load_motion_coeff_npy
    from real3dportrait_tpu_torch.utils.precision import set_fp32_policy

    set_fp32_policy()
    args = parse_args(argv)
    pipe = pipeline_from_args(args)

    src = load_image(args.src_img)
    wav = hubert = drv_motion = None
    if args.drv_aud.endswith(".mp4"):
        drv_motion = pipe.motion_from_video(args.drv_aud)
        print(f"| extracted {len(drv_motion['exp'])} exp frames from {args.drv_aud}")
    elif args.drv_aud.endswith(".npy"):
        drv_motion = load_motion_coeff_npy(args.drv_aud)
        if drv_motion is None:  # a plain array: precomputed HuBERT features
            hubert = np.load(args.drv_aud).astype(np.float32)
    else:
        wav = load_wav(args.drv_aud)
    pose = None
    if args.drv_pose.endswith(".mp4"):
        pose_coeffs = pipe.motion_from_video(args.drv_pose)
        pose = (pose_coeffs["euler"], pose_coeffs["trans"])
        print(f"| extracted {len(pose[0])} pose frames from {args.drv_pose}")
    elif args.drv_pose not in ("", "static"):
        pose_arr = np.load(args.drv_pose, allow_pickle=True)
        if isinstance(pose_arr, np.ndarray) and pose_arr.dtype == object:
            pose_arr = pose_arr.item()
        pose = (np.asarray(pose_arr["euler"]), np.asarray(pose_arr["trans"]))
    bg = load_image(args.bg_img) if args.bg_img else None
    frames = pipe.run(src, wav=wav, hubert=hubert, drv_motion=drv_motion, pose_seq=pose,
                      bg_img=bg, temperature=args.temperature, mouth_amp=args.mouth_amp,
                      out_path=args.out_name, fps=args.fps, out_mode=args.out_mode,
                      low_memory=args.low_memory_usage, frame_batch=args.frame_batch,
                      blink_mode="periodic" if args.blink_mode == "period" else "none",
                      min_face_area_percent=args.min_face_area_percent)
    out = args.out_name if os.path.exists(args.out_name) else args.out_name + ".raw"
    print(f"| wrote {len(frames) if len(frames) else 'streamed'} frames -> {out}")


if __name__ == "__main__":
    main()

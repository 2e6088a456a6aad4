"""Inference CLI of the port (the flags of ``real3dportrait_tpu/inference/cli.py``
and ``--device``):

    python -m real3dportrait_tpu_torch.inference.cli --src_img face.png \\
        --drv_aud speech.wav [--drv_pose pose.npy] [--bg_img bg.png] \\
        --out_name out.mp4 [--mock_weights] [--temperature 0.2] [--device cuda]

The source image is any RGB image (or .npy); the driving audio a 16 kHz
wav, or an .npy of HuBERT features or of a motion-coefficient dict. Only
seeded mock weights are ported (no checkpoint is in the repository); a
driving video (.mp4) is not ported yet.
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


def main(argv: list[str] | None = None) -> None:
    from real3dportrait_tpu_torch.inference.pipeline import SHIPPED_SAMPLING_PRESET

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--src_img", required=True)
    p.add_argument("--drv_aud", required=True,
                   help="16 kHz wav, or .npy (HuBERT features or a motion-coeff dict)")
    p.add_argument("--drv_pose", default="static",
                   help="'static' or an .npy coeff dict with euler and trans")
    p.add_argument("--map_to_init_pose", default="True",
                   help="offset the driving pose so that frame 0 matches the source")
    p.add_argument("--bg_img", default="")
    p.add_argument("--out_name", default="output.mp4")
    p.add_argument("--out_mode", default="final", choices=["final", "concat_debug"])
    p.add_argument("--a2m_ckpt", default="")
    p.add_argument("--s2v_ckpt", default="")
    p.add_argument("--bfm_dir", default="")
    p.add_argument("--hubert_path", default="",
                   help="a torch state dict of hubert_large (the port's weights)")
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
                   help="seeded random weights (no checkpoints are available)")
    p.add_argument("--low_memory_usage", action="store_true",
                   help="stream frames to the writer without keeping them")
    p.add_argument("--frame_batch", type=int, default=1)
    p.add_argument("--head_only", action="store_true", help="no torso/background fusion")
    p.add_argument("--hparams", default="", help="config overrides a.b=1,c=2")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from real3dportrait_tpu_torch.config import load_config, parse_overrides
    from real3dportrait_tpu_torch.inference.infer_utils import load_motion_coeff_npy
    from real3dportrait_tpu_torch.inference.pipeline import (
        DEFAULT_CONFIG,
        Real3DPortraitPipeline,
        _not_ported,
    )

    if args.drv_aud.endswith(".mp4") or args.drv_pose.endswith(".mp4"):
        raise _not_ported("driving from a video (3DMM fitting of its frames)",
                          "next order, modules")
    if args.a2m_ckpt or args.s2v_ckpt:
        raise _not_ported("loading released checkpoints into the port",
                          "queue 1 item 1, weight bridge")
    cfg = load_config(DEFAULT_CONFIG, parse_overrides(args.hparams))
    cfg["map_to_init_pose"] = args.map_to_init_pose in ("True", "true", "1")
    if args.head_torso_threshold is not None:
        cfg["htbsr_head_threshold"] = args.head_torso_threshold
    cfg["sampling_preset"] = args.sampling_preset
    seed = args.seed if args.seed is not None else int(time.time()) % (2 ** 31)
    hubert_sd = torch.load(args.hubert_path, map_location="cpu") if args.hubert_path else None
    pipe = Real3DPortraitPipeline(cfg, use_torso=not args.head_only, mock_weights=True,
                                  bfm_dir=args.bfm_dir or None, seed=seed, device=args.device,
                                  hubert_state_dict=hubert_sd)

    src = load_image(args.src_img)
    wav = hubert = drv_motion = None
    if args.drv_aud.endswith(".npy"):
        drv_motion = load_motion_coeff_npy(args.drv_aud)
        if drv_motion is None:  # a plain array: precomputed HuBERT features
            hubert = np.load(args.drv_aud).astype(np.float32)
    else:
        wav = load_wav(args.drv_aud)
    pose = None
    if args.drv_pose not in ("", "static"):
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

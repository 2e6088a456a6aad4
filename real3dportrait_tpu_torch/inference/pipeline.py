"""One-shot talking-portrait synthesis on PyTorch.

Port of ``real3dportrait_tpu/inference/pipeline.py``
(``Real3DPortraitPipeline``): :meth:`~Real3DPortraitPipeline.run` goes from
a 16 kHz wav to a written video, through the host audio front end (log-mel
and pitch; HuBERT when its weights are given, else the mel tiled to its
width, as the JAX package does), the audio-to-motion flow-VAE, source
preparation, the periodic blink edit and the frame loop. Per video it
rasterizes the canonical and source SECC maps and computes the canonical
tri-plane once, and for the torso model the torso appearance volume and
the background feature; per frame it rasterizes the target SECC map
(kernel K4) and runs the frame step: SECC SegFormer -> plane fusion ->
two-pass render (kernels K1-K3) -> SR head (the StyleGAN2 epilogue and
resampling are kernels K6a/K6b; the torso head adds the warped torso:
kernels K5a/K5b, every 3D convolution K7a and the motion field's tail
K7b).

The source's 3DMM coefficients come from its landmarks where ``run`` gets
them (``src_lm2d``: a crop to the face, then the fit of
``geometry/fit_3dmm.py`` on the device), else they are neutral; a driving
video's fitted motion (:meth:`~Real3DPortraitPipeline.motion_from_video`)
drives the expression and the pose in place of the audio.

Source preparation (the default, as in JAX) segments the source, splits it
into head (the canonical plane's input), inpainted torso and background,
and drives the torso warp with keypoints reconstructed from the
coefficients. Without it the torso is driven as the JAX pipeline drives it
then: the source image is also the torso and background image, the segmap
is all torso (class 4) and the keypoints are zero, so every warp is an
identity warp. ``bg_img`` replaces the background.

Without a config the model is the JAX pipeline's default,
``configs/secc_img2plane_torso.yaml``: tri-grids of depth 3 x 32 channels
(kernel K1-trigrid), the composite canonical backbone with GroupNorms and
bf16 SR blocks; ``configs/real3d_orig.yaml`` is the released checkpoints'
geometry (tri-planes of depth 1, kernel K1, folded BatchNorms, fp32 SR).
The pipeline runs on ``device="cuda"`` unless it is given another device.

``mock_weights=True`` (the port's default) draws every weight from a
``torch.Generator`` seeded with ``seed``; the graph is the same, only the
pixels are untrained. ``mock_weights=False`` loads the newest checkpoint
of ``a2m_ckpt_dir`` and ``secc2video_ckpt_dir`` where they are given, as
the JAX pipeline does: the msgpack files that the JAX package writes, and
that the port's ``tools/convert_torch_ckpt.py`` makes of the released
torch checkpoints, read without flax (``utils/msgpack_ckpt.py``).
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import subprocess
import time
from collections.abc import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from real3dportrait_tpu_torch import entry_device
from real3dportrait_tpu_torch.audio.features import extract_f0, extract_mel
from real3dportrait_tpu_torch.audio.hubert import hubert_large, make_hubert_extractor
from real3dportrait_tpu_torch.config import load_config
from real3dportrait_tpu_torch.geometry.bfm import BFMAssets, load_or_synthetic_bfm
from real3dportrait_tpu_torch.geometry.camera import (
    convert_eg3d_convention,
    mirror_index,
    pack_camera,
    smooth_camera_sequence,
)
from real3dportrait_tpu_torch.geometry.face3d_helper import reconstruct_lm2d
from real3dportrait_tpu_torch.geometry.fit_3dmm import fit_coeffs
from real3dportrait_tpu_torch.geometry.secc_renderer import SECCRenderer
from real3dportrait_tpu_torch.inference.edit_secc import (
    blink_eye_for_secc,
    periodic_blink_percent,
)
from real3dportrait_tpu_torch.inference.infer_utils import (
    map_pose_to_source,
    motion_from_video,
    smooth_features_1d,
)
from real3dportrait_tpu_torch.models.audio2motion import PitchContourVAEModel
from real3dportrait_tpu_torch.models.img2plane import (
    OSAvatarSECCImg2Plane,
    OSAvatarSECCImg2PlaneTorso,
)
from real3dportrait_tpu_torch.preprocess.pipeline import naive_person_segmenter
from real3dportrait_tpu_torch.preprocess.segment_utils import (
    crop_on_face_area,
    prepare_source,
)
from real3dportrait_tpu_torch.utils import msgpack_ckpt
from real3dportrait_tpu_torch.utils.precision import set_fp32_policy
from real3dportrait_tpu_torch.utils.visualization import (
    depth_to_colormap,
    side_by_side,
    to_uint8,
)
from real3dportrait_tpu_torch.weights import load_jax_variables, mock_init_

# Shared by value with the JAX package's pipeline (SAMPLING_PRESETS and the
# shipped default).
SAMPLING_PRESETS: dict[str, tuple[int, int] | None] = {
    "reference": (48, 48),
    "balanced": (24, 32),
    "fast": (16, 32),
    "config": None,
}
SHIPPED_SAMPLING_PRESET = "fast"

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the JAX pipeline's default model
DEFAULT_CONFIG = os.path.join(_ROOT, "configs", "secc_img2plane_torso.yaml")


def _expand_batch(v, n: int):
    """``v`` [1,...] (or a tuple of such) as a view of batch ``n``."""
    if isinstance(v, tuple):
        return tuple(_expand_batch(x, n) for x in v)
    return v.expand(n, *v.shape[1:])


def _resize_np(img: np.ndarray, size: int) -> np.ndarray:
    """[H,W,C] float -> [size,size,C], bilinear with antialiasing (the JAX
    package's ``jax.image.resize``); the same size is returned as it is."""
    if img.shape[0] == size and img.shape[1] == size:
        return img
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                      antialias=True)
    return x[0].permute(1, 2, 0).numpy()


def load_hubert(path: str | None, device: torch.device | str,
                model_fn: Callable[[], torch.nn.Module] = hubert_large) -> Callable | None:
    """The HuBERT extractor of a ``.msgpack`` tree in the layout that
    ``tools/convert_torch_ckpt.py:convert_hubert`` gives (written with
    ``utils/msgpack_ckpt.msgpack_serialize``), loaded strictly
    into ``model_fn()`` (``hubert_large``, as the JAX pipeline builds), or
    None: for no path, another file type, or a file that does not load,
    after one line saying why. Without HuBERT the pipeline tiles the
    log-mel to 1024 channels, as the JAX package does."""
    if not path:
        return None
    if not str(path).endswith(".msgpack"):
        print(f"| HuBERT not loaded: {path} is not a .msgpack tree; using the log-mel")
        return None
    try:
        model = model_fn()
        load_jax_variables(model, msgpack_ckpt.load_checkpoint(path))
    except (OSError, ValueError, RuntimeError, KeyError, IndexError) as err:
        print(f"| HuBERT not loaded from {path} ({type(err).__name__}: {err}); "
              f"using the log-mel")
        return None
    print(f"| loaded HuBERT from {path}")
    return make_hubert_extractor(model.to(device).eval())


def build_model(cfg: Mapping, use_torso: bool = True) -> torch.nn.Module:
    """The synthesis model a config describes, from the keys the JAX
    pipeline reads, with the sampling preset's sample counts."""
    preset = cfg.get("sampling_preset", "config")
    if preset not in SAMPLING_PRESETS:
        raise ValueError(f"sampling_preset must be one of {sorted(SAMPLING_PRESETS)}, "
                         f"got {preset!r}")
    picked = SAMPLING_PRESETS[preset]
    if picked is None:
        n_coarse = int(cfg.get("num_samples_coarse", 48))
        n_fine = int(cfg.get("num_samples_fine", 48))
    else:
        n_coarse, n_fine = picked
    model_kwargs = dict(
        triplane_hid_dim=int(cfg.get("triplane_hid_dim", 32)),
        triplane_depth=int(cfg.get("triplane_depth", 3)),
        triplane_feature_type=cfg.get("triplane_feature_type", "trigrid"),
        neural_rendering_resolution=int(cfg.get("neural_rendering_resolution", 128)),
        final_resolution=int(cfg.get("final_resolution", 512)),
        backbone_mode=cfg.get("img2plane_backbone_mode", "segformer"),
        backbone_scale=cfg.get("img2plane_backbone_scale", "b0"),
        head_norm_mode=cfg.get("head_norm_mode", "gn"),
        plane_fusion_mode=cfg.get("phase1_plane_fusion_mode", "add"),
        secc_segformer_scale=cfg.get("secc_segformer_scale", "b0"),
        pncc_cond_mode=cfg.get("pncc_cond_mode", "cano_src_tgt"),
        sr_num_fp16_res=int(cfg.get("num_fp16_layers_in_super_resolution", 4)),
        num_samples_coarse=n_coarse,
        num_samples_fine=n_fine,
        sr_channel0=int(cfg.get("sr_channel0", 256)),
        sr_channel1=int(cfg.get("sr_channel1", 128)),
    )
    if not use_torso:
        return OSAvatarSECCImg2Plane(**model_kwargs)
    return OSAvatarSECCImg2PlaneTorso(
        torso_kp_num=int(cfg.get("torso_kp_num", 4)),
        torso_scale=cfg.get("torso_model_scale", "standard"),
        fuse_mode=cfg.get("htbsr_head_weight_fuse_mode", "v2"),
        head_threshold=float(cfg.get("htbsr_head_threshold", 0.9)),
        torso_version=cfg.get("torso_model_version", "v2"),
        torso_inp_mode=cfg.get("torso_inp_mode", "rgb_alpha"),
        **model_kwargs)


class Real3DPortraitPipeline:
    """Synthesis with the torso/background model (``use_torso=True``) or
    the head only, of ``cfg`` (default :data:`DEFAULT_CONFIG`), on
    ``device`` (default ``"cuda"``; raises without a CUDA device), with the
    audio-to-motion model the config names (``audio_type``, ``use_flow``,
    ``a2m_norm_mode``). ``assets`` overrides the morphable model that
    ``bfm_dir`` would load (BFM09 if present there, else the small
    synthetic stand-in); a benchmark passes ``synthetic_bfm(n_vertices=35709)``
    to run the raster at the real mesh's scale. ``hubert_path`` (a
    ``.msgpack`` tree, :func:`load_hubert`) turns on the HuBERT front end;
    without it the log-mel is tiled to HuBERT's 1024 channels, as the JAX
    package does without HuBERT weights. Below 256^2 the torso needs
    ``torso_model_scale: tiny`` (the standard motion-field U-Net pools the
    volume's H, W five times).

    Weights (JAX ``pipeline.py:_init_weights``): every weight is first
    drawn from ``seed``; with ``mock_weights=False`` the audio-to-motion
    model then takes the newest checkpoint of ``a2m_ckpt_dir`` (its
    ``params/model`` tree, or the whole tree where there is no ``params``)
    and the synthesis model that of ``secc2video_ckpt_dir`` (``params/gen``,
    likewise, plus each collection under ``variables`` that the model has,
    such as the ``noise_const`` buffers); loading is strict. An empty
    directory argument keeps the seeded weights (JAX keeps its init)."""

    def __init__(self, cfg: Mapping | None = None, use_torso: bool = True,
                 mock_weights: bool = True, a2m_ckpt_dir: str = "",
                 secc2video_ckpt_dir: str = "", bfm_dir: str | None = None,
                 assets: BFMAssets | None = None, seed: int = 0,
                 device: torch.device | str = "cuda", hubert_path: str | None = None):
        set_fp32_policy()  # process-global: TF32 off for cuDNN and cuBLAS
        self.device = entry_device(device)
        if cfg is None:
            cfg = load_config(DEFAULT_CONFIG)
        self.cfg = cfg
        self.use_torso = use_torso
        self.res = int(cfg.get("final_resolution", 512))

        self.assets = assets if assets is not None else load_or_synthetic_bfm(bfm_dir)
        self.secc_renderer = SECCRenderer(
            self.assets, bfm_dir, rasterize_size=int(cfg.get("secc_resolution", 192)),
            output_resolution=self.res, device=self.device)

        self.audio_in_dim = 1024 if cfg.get("audio_type", "hubert") == "hubert" else 80
        self.a2m = PitchContourVAEModel(
            in_out_dim=64, audio_in_dim=self.audio_in_dim,
            use_prior_flow=bool(cfg.get("use_flow", True)),
            norm_mode=cfg.get("a2m_norm_mode", "gn"))
        self.model = build_model(cfg, use_torso)
        gen = torch.Generator().manual_seed(seed)
        mock_init_(self.model, gen)
        mock_init_(self.a2m, gen)
        if not mock_weights:
            self._load_checkpoints(a2m_ckpt_dir, secc2video_ckpt_dir)
        self.model.to(self.device).eval()
        self.a2m.to(self.device).eval()
        # the prior noise of each run: drawn on the CPU from the seed, so
        # that the same seed gives the same motion on every device
        self.sample_generator = torch.Generator().manual_seed(seed)

        self.hubert_fn = load_hubert(hubert_path, self.device)

    def _load_checkpoints(self, a2m_dir: str, s2v_dir: str) -> None:
        if a2m_dir:
            restored, path = msgpack_ckpt.get_last_checkpoint(a2m_dir)
            if restored is not None:
                src = restored.get("params", {}).get("model", restored)
                load_jax_variables(self.a2m, {"params": src})
                print(f"| loaded audio2motion from {path}")
        if s2v_dir:
            restored, path = msgpack_ckpt.get_last_checkpoint(s2v_dir)
            if restored is not None:
                variables = {"params": restored.get("params", {}).get("gen", restored)}
                # the converter's non-param collection, where the model has it
                noise = restored.get("variables", {}).get("noise_const")
                if noise is not None and any(k.endswith(".noise_const")
                                             for k in self.model.state_dict()):
                    variables["noise_const"] = noise
                load_jax_variables(self.model, variables)
                print(f"| loaded secc2video from {path}")

    def fit_source(self, src_lm2d: np.ndarray | None) -> dict:
        """Source 3DMM coefficients on the device: the neutral ones for
        ``None``, else the fit (:func:`fit_coeffs`) of 68 normalised
        landmarks [K,2] or [T,K,2], its first frame."""
        if src_lm2d is None:
            z = lambda n: torch.zeros((1, n), device=self.device)  # noqa: E731
            return {"id": z(80), "exp": z(64), "euler": z(3), "trans": z(3)}
        lm = torch.as_tensor(np.asarray(src_lm2d), dtype=torch.float32)
        fit = fit_coeffs(self.secc_renderer.assets, lm[None] if lm.dim() == 2 else lm,
                         device=self.device)
        return {"id": fit.id, "exp": fit.exp[:1], "euler": fit.euler[:1],
                "trans": fit.trans[:1]}

    def motion_from_video(self, video_path: str, landmark_extractor: Callable | None = None,
                          max_frames: int | None = None) -> dict:
        """{exp, euler, trans, id} on the device, fitted to a driving
        video's landmarks (``infer_utils.motion_from_video``)."""
        return motion_from_video(video_path, self.secc_renderer.assets,
                                 landmark_extractor=landmark_extractor,
                                 max_frames=max_frames, device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _host_image(self, img: np.ndarray | torch.Tensor) -> np.ndarray:
        """[H,W,3] uint8 or float in [-1,1] -> [res,res,3] float32 in [-1,1]
        on the host, converted and resized as the JAX pipeline does."""
        img = img.cpu().numpy() if torch.is_tensor(img) else np.asarray(img)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 127.5 - 1.0
        return _resize_np(img.astype(np.float32), self.res)

    def _image(self, img: np.ndarray | torch.Tensor) -> torch.Tensor:
        """:meth:`_host_image` as [1,res,res,3] on the device."""
        return torch.from_numpy(self._host_image(img)).to(self.device)[None]

    def mock_cond(self, img: torch.Tensor, bg_img: torch.Tensor | None = None) -> dict:
        """The torso cond without source preparation for the N source images
        ``img`` [N,res,res,3]: each image as torso and background (unless
        ``bg_img`` [1,res,res,3], broadcast over them), an all-torso segmap
        and zero keypoints."""
        n = img.shape[0]
        seg = torch.zeros((n, self.res, self.res, 6), device=self.device)
        seg[..., 4] = 1.0
        kp = torch.zeros((n, 68, 3), device=self.device)
        return {"ref_torso_img": img, "bg_img": img if bg_img is None else bg_img.expand_as(img),
                "segmap": seg, "kp_src": kp, "kp_drv": kp}

    # -- audio -----------------------------------------------------------------

    def audio_to_features(self, wav: np.ndarray | None,
                          hubert: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
        """wav (16 kHz) -> (audio features [T,C] at 50 Hz, f0 [T]) on the
        host, T cut to a multiple of 8."""
        if hubert is not None:
            feats = hubert
        elif self.hubert_fn is not None and self.audio_in_dim == 1024:
            feats = self.hubert_fn(wav)
        elif self.audio_in_dim == 1024:
            # no HuBERT weights: the mel tiled to HuBERT's width
            feats = np.tile(extract_mel(wav), (1, 1024 // 80 + 1))[:, :1024]
        else:
            feats = extract_mel(wav)
        f0 = extract_f0(wav) if wav is not None else np.zeros((len(feats),), np.float32)
        t = min(len(feats), len(f0)) if len(f0) else len(feats)
        t = t - t % 8
        f0 = f0[:t] if len(f0) >= t else np.pad(f0, (0, t - len(f0)))
        return feats[:t], f0

    @torch.no_grad()
    def audio_to_motion(self, feats: np.ndarray, f0: np.ndarray, temperature: float = 0.2,
                        mouth_amp: float = 0.4,
                        generator: torch.Generator | None = None) -> torch.Tensor:
        """[T,C] at 50 Hz -> expression sequence [T/2, 64] at 25 Hz on the
        device; the prior noise is drawn from ``generator`` (on the CPU)."""
        dev = self.device
        t50 = feats.shape[0]
        batch = {"audio": torch.as_tensor(np.asarray(feats, np.float32), device=dev)[None],
                 "f0": torch.as_tensor(np.asarray(f0, np.float32), device=dev)[None],
                 "y_mask": torch.ones((1, t50 // 2), device=dev),
                 "blink": torch.zeros((1, t50, 1), dtype=torch.long, device=dev),
                 "mouth_amp": torch.full((1, 1), float(mouth_amp), device=dev)}
        return self.a2m(batch, temperature=temperature, generator=generator)["pred"][0]

    # -- synthesis -------------------------------------------------------------

    def _prepare_source(self, src: np.ndarray, bg_img, segmap, segmenter, src_coeffs: dict,
                        idc, exp_seq, euler, trans):
        """The head / inpainted torso / background split of the source and
        the keypoints that drive the torso: (head image, cond, driving
        keypoints [T,68,3], smoothed over time)."""
        dev, res, t = self.device, self.res, exp_seq.shape[0]
        img_u8 = ((src + 1) * 127.5).clip(0, 255).astype(np.uint8)
        if segmap is None:
            segmap = (segmenter or naive_person_segmenter)(img_u8[None])[0]
        segmap = np.asarray(segmap).astype(np.int64)
        bg_u8 = None
        if bg_img is not None:
            bg_img = bg_img.cpu().numpy() if torch.is_tensor(bg_img) else np.asarray(bg_img)
            bg_u8 = bg_img if bg_img.dtype == np.uint8 else (
                (bg_img + 1) * 127.5).clip(0, 255).astype(np.uint8)
            bg_u8 = _resize_np(bg_u8.astype(np.float32), res).astype(np.uint8)
        prep = prepare_source(img_u8, segmap, bg_img=bg_u8)

        def to_pm1(u8):
            return torch.from_numpy(u8.astype(np.float32) / 127.5 - 1.0).to(dev)[None]

        def kp_of(idc_, exp_, euler_, trans_):
            lm = reconstruct_lm2d(self.secc_renderer.assets, idc_, exp_, euler_, trans_)
            lm = torch.clip((lm - 0.5) / 0.5, -1, 1)
            return torch.cat([lm, torch.zeros_like(lm[..., :1])], dim=-1)

        kp_src = kp_of(src_coeffs["id"], src_coeffs["exp"], src_coeffs["euler"],
                       src_coeffs["trans"])
        kp_drv = smooth_features_1d(kp_of(idc, exp_seq, euler, trans).reshape(t, -1),
                                    kernel_size=7).reshape(t, 68, 3)
        cond = {"ref_torso_img": to_pm1(prep["torso_img"]), "bg_img": to_pm1(prep["bg_img"]),
                "segmap": torch.from_numpy(prep["segmap_onehot"]).to(dev)[None],
                "kp_src": kp_src, "kp_drv": kp_drv[:1]}
        return to_pm1(prep["head_img"]), cond, kp_drv

    @torch.no_grad()
    def synthesize(self, src_img: np.ndarray | torch.Tensor, exp_seq: torch.Tensor,
                   src_coeffs: dict, pose_seq: tuple | None = None,
                   bg_img: np.ndarray | torch.Tensor | None = None,
                   blink_mode: str = "periodic",
                   callback: Callable[[int, np.ndarray], None] | None = None,
                   debug_mode: bool = False, stream_only: bool = False,
                   frame_batch: int = 1, segmap: np.ndarray | None = None,
                   segmenter: Callable | None = None, prepare_source_images: bool = True,
                   timings: dict | None = None) -> torch.Tensor:
        """Render all frames; returns [T,H,W,3] in [-1,1] on the device.

        ``src_img`` [H,W,3] float in [-1,1] or uint8; ``exp_seq`` [T,64];
        ``pose_seq`` optional (euler [T,3], trans [T,3]); ``bg_img``
        optional [H,W,3], uint8 or [-1,1], for the torso model.
        ``blink_mode`` "periodic" closes the eyes in the target SECC maps
        every 5 s (only those frames go to the host and back);
        ``prepare_source_images`` splits the source by ``segmap`` [H,W]
        (classes 0-5), else by ``segmenter`` (frames -> class maps), else by
        the naive segmenter. ``callback(i, frame)`` receives each frame
        [H,W,3] as float32 numpy, in order: a step's copy to pinned host
        memory overlaps the next step's kernels. ``stream_only`` keeps no
        frames (an empty [0,H,W,3] is returned). ``debug_mode`` gives final |
        raw | depth frames side by side (one frame a step only, as in JAX).

        ``frame_batch`` fb > 1 renders fb frames a device step: their
        target SECC maps in one raster call, the canonical plane and the
        per-video caches broadcast along the batch as views; the last step
        repeats frame T-1 and delivers only its valid frames. A source
        [N,H,W,3] is the batched multi-identity mode: N identities share the
        driving signal, without source preparation (the mock cond at N,
        ``bg_img`` broadcast over them); frames [T,N,H,W,3], and
        ``callback(i, [N,H,W,3])``. The two modes do not combine.

        With ``timings`` (a dict) the device is synchronised around each
        stage and the dict receives ``prep_ms`` (source preparation, host),
        ``cano_ms``, for the torso model ``appearance_ms`` and ``bg_ms``
        (the per-video caches), and ``frame_ms`` (one entry per step: SECC
        raster, blink edit, frame step).
        """
        if blink_mode not in ("periodic", "none"):
            raise ValueError(f"blink_mode must be 'periodic' or 'none', got {blink_mode!r}")
        src_np = src_img.cpu().numpy() if torch.is_tensor(src_img) else np.asarray(src_img)
        batched = src_np.ndim == 4
        srcs = [self._host_image(s) for s in (src_np if batched else src_np[None])]
        n_ident, fb = len(srcs), max(int(frame_batch), 1)
        if fb > 1 and n_ident > 1:
            raise ValueError(f"frame batching and the multi-identity mode are mutually "
                             f"exclusive: frame_batch {fb} with {n_ident} sources")
        dev = self.device
        src = srcs[0]
        img = torch.from_numpy(np.stack(srcs)).to(dev)

        exp_seq = torch.as_tensor(exp_seq, dtype=torch.float32).to(dev)
        t = exp_seq.shape[0]
        idc = src_coeffs["id"].expand(t, 80)
        if pose_seq is None:
            euler = src_coeffs["euler"].expand(t, 3)
            trans = src_coeffs["trans"].expand(t, 3)
        else:
            euler, trans = (torch.as_tensor(p, dtype=torch.float32).to(dev) for p in pose_seq)
            if euler.shape[0] < t:
                idx = mirror_index(torch.arange(t, device=dev), euler.shape[0])
                euler, trans = euler[idx], trans[idx]
            euler, trans = map_pose_to_source(
                euler[:t], trans[:t], src_coeffs["euler"], src_coeffs["trans"],
                map_to_init=bool(self.cfg.get("map_to_init_pose", True)))

        _, conv_c2w, intr = convert_eg3d_convention(euler, trans)
        cameras = smooth_camera_sequence(pack_camera(conv_c2w, intr[0]))

        zero = torch.zeros((1, 3), device=dev)
        _, cano_secc = self.secc_renderer.render(
            src_coeffs["id"], torch.zeros((1, 64), device=dev), zero, zero)
        _, src_secc = self.secc_renderer.render(
            src_coeffs["id"], src_coeffs["exp"], zero, zero)

        def timed(key, fn, *args):
            self._sync()
            t0 = time.perf_counter()
            out = fn(*args)
            if timings is not None:
                self._sync()
                timings[key] = (time.perf_counter() - t0) * 1e3
            return out

        kp_drv = None
        if prepare_source_images and not batched:
            head_img, cond, kp_drv = timed(
                "prep_ms", self._prepare_source, src, bg_img, segmap, segmenter, src_coeffs,
                idc, exp_seq, euler, trans)
            cano_plane = timed("cano_ms", self.model.cal_cano_plane, head_img)
        else:
            cano_plane = timed("cano_ms", self.model.cal_cano_plane, img)
            cond = self.mock_cond(img, None if bg_img is None else self._image(bg_img))
        blink = (periodic_blink_percent(t) if blink_mode == "periodic"
                 else np.zeros((t,), np.float32))
        if self.use_torso:
            cond["torso_appearance"] = timed("appearance_ms",
                                             self.model.cal_torso_appearance, cond)
            cond["bg_feat"] = timed("bg_ms", self.model.cal_bg_feat, cond)
        if timings is not None:
            timings["frame_ms"] = []
        # a step renders nb = fb * n_ident images: the per-video plane and
        # caches are views of that batch, and the per-frame sequences are
        # padded once to whole steps (the last step repeats frame t-1)
        nb = fb * n_ident
        cano_plane = _expand_batch(cano_plane, nb)
        cond = {k: _expand_batch(v, nb) for k, v in cond.items()}
        padded = torch.clamp(torch.arange(-(-t // fb) * fb, device=dev), max=t - 1)
        idc, exp_seq, cameras = idc[padded], exp_seq[padded], cameras[padded]
        if kp_drv is not None:
            kp_drv = kp_drv[padded]
        zero_fb = torch.zeros((fb, 3), device=dev)
        debug_mode = debug_mode and fb == 1

        frames, pinned, pending = [], [None, None], None
        if debug_mode:
            shape = (self.res, 3 * self.res, 3)
        else:
            shape = ((n_ident,) if batched else ()) + (self.res, self.res, 3)

        def deliver(start, handle, n_valid):
            """Hand a step's frames to the callback once their host copy is
            done."""
            buf, done = handle
            if done is not None:
                done.synchronize()
            host = buf.numpy()
            for k in range(n_valid):
                callback(start + k, host[k].copy())

        for step, start in enumerate(range(0, t, fb)):
            t0 = time.perf_counter()
            n_valid = min(fb, t - start)
            _, tgt_secc = self.secc_renderer.render(idc[start:start + fb],
                                                    exp_seq[start:start + fb], zero_fb, zero_fb)
            for k in range(fb):
                j = min(start + k, t - 1)
                if blink[j] > 0:
                    edited = blink_eye_for_secc(tgt_secc[k].cpu().numpy(), float(blink[j]))
                    tgt_secc[k] = torch.from_numpy(edited).to(dev)
            secc_cond = _expand_batch(torch.cat([cano_secc.expand_as(tgt_secc),
                                                 src_secc.expand_as(tgt_secc), tgt_secc],
                                                dim=-1), nb)
            cam = _expand_batch(cameras[start:start + fb], nb)
            if kp_drv is not None:
                cond = dict(cond, kp_drv=kp_drv[start:start + fb])
            if self.use_torso:
                out = self.model.synthesis(None, cam, cond, secc=secc_cond,
                                           cano_planes=cano_plane)
            else:
                out = self.model.synthesis(None, cam, secc=secc_cond, cano_planes=cano_plane)
            # the step's frames [n,...]; in the multi-identity mode one frame
            # of the N identities
            image = out["image"]
            if debug_mode:
                image = torch.from_numpy(side_by_side(
                    to_uint8(image[0].cpu().numpy()), to_uint8(out["image_raw"][0].cpu().numpy()),
                    depth_to_colormap(out["image_depth"][0, ..., 0].cpu().numpy()),
                ).astype(np.float32) / 127.5 - 1.0).to(dev)[None]
            elif batched:
                image = image[None]
            if callback is not None:
                # double-buffered: start this step's copy, then deliver the
                # step before while the device runs this one
                if dev.type == "cuda":
                    buf = pinned[step % 2]
                    if buf is None or buf.shape != image.shape:
                        buf = pinned[step % 2] = torch.empty(image.shape, pin_memory=True)
                    buf.copy_(image, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
                    handle = (buf, done)
                else:
                    handle = (image, None)
                if pending is not None:
                    deliver(*pending)
                pending = (start, handle, n_valid)
            if not stream_only:
                frames.append(image[:n_valid])
            if timings is not None:
                self._sync()
                timings["frame_ms"].append((time.perf_counter() - t0) * 1e3)
        if pending is not None:
            deliver(*pending)
        if stream_only or not frames:
            return torch.zeros((0,) + shape, device=dev)
        return torch.cat(frames)


    def run(self, src_img: np.ndarray, wav: np.ndarray | None = None,
            hubert: np.ndarray | None = None, drv_motion: dict | None = None,
            src_lm2d: np.ndarray | None = None, pose_seq: tuple | None = None,
            bg_img: np.ndarray | None = None, temperature: float = 0.2,
            mouth_amp: float = 0.4, out_path: str | None = None, fps: int = 25,
            out_mode: str = "final", low_memory: bool = False, frame_batch: int = 1,
            blink_mode: str = "periodic", min_face_area_percent: float = 0.2,
            timings: dict | None = None) -> torch.Tensor:
        """Audio- or motion-driven synthesis; frames [T,H,W,3] in [-1,1] on
        the device (empty with ``low_memory`` and ``out_path``).

        ``src_lm2d`` (the source's 68 landmarks [K,2], normalised or in
        pixels) crops the source so that the face covers at least
        ``min_face_area_percent`` of it, and its 3DMM fit gives the source
        coefficients; without it they are neutral. ``drv_motion`` ({"exp":
        [T,64], ...}, numpy or tensors, such as :meth:`motion_from_video`
        gives) drives the expression directly; otherwise ``wav`` (16 kHz) or
        ``hubert`` features go through the audio-to-motion model, its prior
        noise drawn from the pipeline's seed. With ``out_path`` the frames
        stream into a video writer as they are made (cv2, else imageio,
        else raw uint8 frames beside a JSON header); the wav is muxed in or
        written next to the video unless ``low_memory``. ``timings``
        receives ``fit_ms`` (with ``src_lm2d``), ``features_ms`` and
        ``a2m_ms`` (audio-driven) beside :meth:`synthesize`'s keys.

        ``frame_batch`` and a source [N,H,W,3] (no crop; frames
        [T,N,H,W,3]) are :meth:`synthesize`'s. Such a source writes no
        video: the JAX pipeline's writer fails on a frame of N identities,
        so ``out_path`` raises ``ValueError`` with it.
        """
        if np.ndim(src_img) == 4 and out_path:
            raise ValueError("run with [N,H,W,3] sources writes no video: the JAX pipeline's "
                             "writer fails on frames of N identities (cv2 takes 2-D images); "
                             "call it without out_path for the frames [T,N,H,W,3]")
        if src_lm2d is not None and np.asarray(src_img).ndim == 3:
            lm_px = np.asarray(src_lm2d)
            if lm_px.max() <= 1.5:  # normalised landmarks -> pixels
                lm_px = lm_px * np.array(np.asarray(src_img).shape[:2][::-1])
            src_img = crop_on_face_area(np.asarray(src_img), lm_px,
                                        min_percent=min_face_area_percent)
        t0 = time.perf_counter()
        coeffs = self.fit_source(src_lm2d)
        if timings is not None and src_lm2d is not None:
            self._sync()
            timings["fit_ms"] = (time.perf_counter() - t0) * 1e3
        if drv_motion is not None:
            exp_seq = torch.as_tensor(drv_motion["exp"], dtype=torch.float32)
        else:
            t0 = time.perf_counter()
            feats, f0 = self.audio_to_features(wav, hubert)
            t1 = time.perf_counter()
            exp_seq = self.audio_to_motion(feats, f0, temperature=temperature,
                                           mouth_amp=mouth_amp,
                                           generator=self.sample_generator)
            if timings is not None:
                self._sync()
                timings["features_ms"] = (t1 - t0) * 1e3
                timings["a2m_ms"] = (time.perf_counter() - t1) * 1e3
        writer = StreamingVideoWriter(out_path, fps=fps) if out_path else None
        frames = self.synthesize(
            src_img, exp_seq, coeffs, pose_seq=pose_seq, bg_img=bg_img,
            blink_mode=blink_mode, debug_mode=out_mode == "concat_debug",
            stream_only=low_memory and writer is not None, frame_batch=frame_batch,
            callback=None if writer is None else (lambda i, f: writer.append(f)),
            timings=timings)
        if writer is not None:
            writer.close()
            if writer._fallback is not None:
                print(f"| no video backend; wrote raw frames to {out_path}.raw")
            if wav is not None and not low_memory:
                _mux_or_save_audio(out_path, wav)
        return frames


class StreamingVideoWriter:
    """Incremental frame writer: cv2's mp4v where it opens, then imageio,
    then a raw uint8 stream (``<out>.raw`` with ``<out>.meta.json``)."""

    def __init__(self, out_path: str, fps: int = 25):
        self.out_path = out_path
        self.fps = fps
        self._cv2 = None
        self._writer = None
        self._fallback = None
        self.count = 0

    def _open(self, u8: np.ndarray):
        try:
            import cv2

            h, w = u8.shape[:2]
            vw = cv2.VideoWriter(self.out_path, cv2.VideoWriter_fourcc(*"mp4v"), self.fps,
                                 (w, h))
            if vw.isOpened():
                self._cv2 = vw
                return
        except Exception:
            pass
        try:
            import imageio

            self._writer = imageio.get_writer(self.out_path, fps=self.fps)
        except Exception:
            self._fallback = open(self.out_path + ".raw", "wb")
            self._shape = u8.shape

    def append(self, frame: np.ndarray):
        u8 = ((np.clip(frame, -1, 1) + 1) * 127.5).astype(np.uint8)
        if self._cv2 is None and self._writer is None and self._fallback is None:
            self._open(u8)
        if self._cv2 is not None:
            self._cv2.write(np.ascontiguousarray(u8[..., ::-1]))  # RGB -> BGR
        elif self._writer is not None:
            self._writer.append_data(u8)
        else:
            self._fallback.write(u8.tobytes())
        self.count += 1

    def close(self):
        if self._cv2 is not None:
            self._cv2.release()
        if self._writer is not None:
            self._writer.close()
        if self._fallback is not None:
            self._fallback.close()
            with open(self.out_path + ".meta.json", "w") as f:
                json.dump({"frames": self.count, "shape": list(self._shape),
                           "dtype": "uint8"}, f)


def write_video(frames: np.ndarray | torch.Tensor, out_path: str, fps: int = 25,
                wav: np.ndarray | None = None) -> None:
    """Write frames ([-1,1] floats) to a video file (or raw frames), and the
    wav beside it or muxed in."""
    if torch.is_tensor(frames):
        frames = frames.cpu().numpy()
    w = StreamingVideoWriter(out_path, fps=fps)
    for f in frames:
        w.append(f)
    w.close()
    if w._fallback is not None:
        print(f"| no video backend; wrote raw frames to {out_path}.raw")
    if wav is not None:
        _mux_or_save_audio(out_path, wav)


def _mux_or_save_audio(video_path: str, wav: np.ndarray, sr: int = 16000) -> None:
    """Mux the audio in with ffmpeg where the binary exists; else keep the
    16-bit PCM wav next to the video (``<video>.wav``)."""
    wav_path = video_path + ".wav"
    pcm = (np.clip(np.asarray(wav, np.float32), -1, 1) * 32767).astype("<i2")
    with open(wav_path, "wb") as f:
        data = pcm.tobytes()
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16))
        f.write(b"data" + struct.pack("<I", len(data)) + data)
    if shutil.which("ffmpeg"):
        muxed = video_path + ".muxed.mp4"
        try:
            subprocess.run(["ffmpeg", "-y", "-i", video_path, "-i", wav_path, "-c:v", "copy",
                            "-c:a", "aac", "-shortest", muxed], check=True,
                           capture_output=True)
            os.replace(muxed, video_path)
            os.remove(wav_path)
        except (OSError, subprocess.CalledProcessError):
            pass  # the wav stays beside the video

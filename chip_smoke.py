#!/usr/bin/env python3
"""Drive the PyTorch port's audio-driven ``run``, its default model and the
released geometry once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

1. toolchain: ``nvidia-smi`` name and power limit, torch and CUDA versions,
   ``nvcc --version``; exits non-zero when no CUDA device is visible;
2. build every kernel of ``real3dportrait_tpu_torch/csrc`` with nvcc for
   sm_90a (one nvcc per source, in parallel), or reuse the library built
   from identical sources (registers and spills from ptxas are printed
   either way, and, where the toolkit has ``cuobjdump``, the count of
   tensor-core ``HMMA`` instructions in the SASS of K7a, of K1 /
   K1-trigrid and of K7b's data gradient, which must not be 0; K3 and K7b
   and their backward kernels and K5a's and K5b's adjoints must not spill,
   K2, K4, K5a and K5b must keep no stack frame and not spill);
3. each kernel (K1, K1-trigrid, K2-K7b; K2 also on a rendered frame's
   coarse samples; K4 at one frame, as ``run`` calls it, and at 16; K6a/K6b
   in fp32 and bf16; K7a at every distinct 3D conv of the standard torso)
   against its plain PyTorch version at the main path's shapes, TF32 off, with the
   tolerance stated beside it; the median CUDA-event time of both, of one
   PyTorch call that computes the same function where there is one, and
   the bound: the larger of the bytes over the HBM rate and the operations
   over the peak rate of their type (H100 SXM data sheet; K7a's products
   and K1's MLP at the tensor cores' split-TF32 rate, with K1's corner
   lerps at the fp32 rate as a third term; their FFMA bounds beside them),
   per call (an event pair around one call on an idle device) and per
   launch (20 back-to-back calls queued behind a spin kernel);
4. the main path: ``Real3DPortraitPipeline().run`` with the JAX defaults
   (periodic blink, source preparation) from a 4 s seeded 16 kHz wav
   through the audio front end and the audio-to-motion flow-VAE to 100
   frames of 512^2 and a written video, with the launch counters from 0
   (the counts the kernels line reports); then its stage times,
   ``synthesize`` with an explicit seeded segmap, and ``hubert_large``
   (seeded weights) on the same wav;
4a. batching (the kernels right after phase 3, the runs right after
   phase 4): each kernel against its plain version at 8 frames a step (K6a,
   K6b and K7a also at 16, on the 2^31-byte fp32 shapes), per launch beside
   B = 1; then ``run`` at ``frame_batch`` 1, 4, 8 and 16 (after a memory
   reckoning), whose frames must agree with fb = 1's and whose launches
   must be a count a video plus a count a step, and the multi-identity
   mode with 4 sources against each source alone;
4b. checkpoints: the default model's seeded weights written in the JAX
   package's msgpack format and read back by
   ``Real3DPortraitPipeline(mock_weights=False, ...)``, whose ``run``
   frames must be bit-equal to the writer's;
4c. convert: the released lineage (``configs/real3d_orig.yaml`` at 48+48)
   written as reference torch ``.ckpt`` files, converted by ``python -m
   real3dportrait_tpu_torch.tools.convert_torch_ckpt`` in a subprocess and
   loaded with ``mock_weights=False``: weights bit-equal to the writer's,
   folded ones within their fold's bound, ``run`` frames (1 s of wav)
   within 1e-3 / 1e-4 of scale of the writer's, every kernel of the
   released path launched in that run (``convert_run_launches``);
5. the slices: ``Real3DPortraitPipeline()``'s default model,
   ``configs/secc_img2plane_torso.yaml`` (depth-3 tri-grids through
   K1-trigrid, the composite backbone with GroupNorms, bf16 SR blocks
   through bf16 K6a/K6b; the torso model, seeded mock weights) synthesises
   8 frames of 512^2 from a seeded source image, 8 expression frames and a
   background image at the ``fast`` preset (the main path, whose launch
   counts the kernels line reports) and at the config's 48+48; then
   ``configs/real3d_orig.yaml`` (tri-planes through K1, fp32) with the
   torso at ``fast`` and ``reference`` (48+48) and the head only at
   ``fast``. Each run checks which
   kernels launched and which must not have (these drive the torso
   without source preparation or blinks, as before the ``run`` path);
6. the flagship frame step (``real3dportrait_tpu_torch.flagship``, the
   released geometry) with random keypoints, so that the torso warps
   interpolate;
7. small configurations of both models, the full-width audio-to-motion
   model, a small HuBERT and a tiny-config ``run`` on both the GPU and the
   CPU (plain versions), whose outputs must agree;
8. training (``run_train_phases``): ``training.run`` on
   ``configs/secc_img2plane.yaml`` at full width and its batch of 4 for 4
   steps (R1, the density regulariser and src2src at step 0, the
   conditioning regulariser at step 3) with the launch counters from 0:
   finite losses, every group moved, every forward and backward kernel
   launched and no plain version called, the checkpoint reloaded equal,
   ms/step and peak memory; then ``train_torso``: ``training.run`` on
   ``configs/secc_img2plane_torso.yaml`` at full width (the standard v2
   torso) and batch 4 for 4 steps, started from that run's checkpoint by
   ``init_from_ckpt``: finite losses with the occlusion regularisers, the
   SR head and the discriminator moved, the head groups bit-equal to the
   checkpoint's, every forward and backward kernel of the path (K5a, K5b,
   K7a, K7b and their backwards among them) launched, no plain version
   called, its checkpoint reloaded equal; then ``train_triplane``: 2 steps
   of ``configs/real3d_orig/secc_img2plane_orig.yaml`` at batch 1 (K1
   forward and backward); then ``train_torso_orig``: the released
   lineage's torso stage, ``configs/real3d_orig/secc_img2plane_torso_orig.yaml``
   (tri-planes, ``rgb_alpha`` torso input) at batch 1 for 2 steps from
   that run's checkpoint, the same checks as ``train_torso``'s but the
   reload; then each backward kernel (K1-trigrid, K3, K6a
   through itself, K6b; K7a's weight gradient at every 3D conv of the
   torso step and its data gradient through K7a, the K5a adjoint also near
   the identity and the K5b adjoint also at a deformation uniform in
   [-1.2, 1.2], K7b's backward, K1's on tri-planes) against its plain
   version at the runs' own calls, K6a's and K6b's second derivatives, and a small
   training step on the card against the same step on the CPU;
9. records-driven training (``run_records_phases``): a full-width store
   written by the port's ``binarize`` (2 videos x 40 frames of 512^2 head,
   composed and torso frames, segmaps and a background, a ``train`` and a
   ``val`` split), read back through the native reader (g++ builds
   ``native/record_reader.cpp`` on this host) item for item against
   ``IndexedDataset``; ``train_records``: ``training.run`` on
   ``configs/secc_img2plane.yaml`` at full width and batch 4 from the
   store for 3 steps (a sanity validation, a validation at step 3 with
   the image dump, the ``vgg19_v2`` criterion on seeded VGG19 / VGGFace
   trees, the SECC renderer on the 35,709-vertex mesh): K4's 4 launches
   a batch in preparation, every step kernel launched, finite losses, the
   PNGs named as JAX names them, ms/step with the batch preparation timed
   apart (unpickling, rasters, blink edits) and peak memory, then the
   criterion alone at the step's shapes; the torso stage for 2 steps from
   its checkpoint on the same store; one record batch at the run's batch
   of 4 on the card against the CPU; ``train_syncnet``:
   ``configs/audio_lm3d_syncnet.yaml`` at full width (lm468, 8192 clip
   pairs) for 4 steps, its checkpoint reloaded through ``partial_load``;
   ``train_a2m``: ``configs/audio2motion_vae.yaml`` at full width and batch
   4 with the sync loss on, ``train_syncnet``'s checkpoint as its frozen
   SyncNet (read through ``partial_load(prefix_map=...)``), 2 steps on
   synthetic batches and 2 on the store's sequences (no kernel of the repo
   on this path: its convolutions are cuDNN's);
10. the EG3D teacher and img2plane (``run_teacher_phases``):
   ``train_eg3d``: ``configs/eg3d.yaml`` at full width (the const-input
   StyleGAN2 synthesis network to 256^2 tri-planes, K1 / K2 / K3 at 128^2
   and 48+48, the bf16 SR head, the dual discriminator) and batch 4 for 4
   steps, the density regulariser and R1 at step 0, then every distinct
   K1, K1-backward (batch 4), K6a and K6b call of its first step and K2 at
   its first call against the plain versions; ``train_img2plane``:
   ``configs/img2plane.yaml`` at full width and batch 4 for 3 steps with
   ``start_adv_iters`` cut to 1 (the frozen EG3D teacher renders the
   targets; the student's K1-trigrid forward and backward), then its
   step's distinct calls likewise. Each prints ms/step (the median after
   the first step), peak memory and each kernel's launches a step;
11. the evaluation metrics (``run_eval_phases``): ``metrics``, 64 + 64
   seeded 512^2 images through the Inception pool features (seeded weights
   read back from a ``convert_inception`` tree; 4 held against the CPU),
   ``calc_metric`` fid / kid / pr50k with the Inception extractor and the
   random projection, PSNR, SSIM, the LPIPS surrogate and LPIPS(vgg) on 16
   pairs held against the CPU, PPL of the full-width EG3D generator;
12. ``parity``: the port's parity tool ``--selftest`` at full width (the
   released geometry, 512^2, 48+48, 4 frames, the preset delta), whose
   re-render must be bit-equal to its fixture frames;
13. ``ddp``: ``training.run`` on ``configs/secc_img2plane.yaml`` at full
   width and global batch 4 for 2 steps under ``torch.distributed.run``:
   one rank over NCCL against no launch, two ranks sharing the card over
   gloo against one rank (``phase_ddp`` says what is held; its processes
   are ``python3 chip_smoke.py --ddp-worker SPEC``); then from record
   stores (``ddp_record_runs``), two gloo ranks against one process: the
   SECC stage at global batch 2 (K4 in each rank's batch preparation, the
   step's kernels on each rank's row) and audio-to-motion over token
   buckets of 4 and 3 rows (the 3-row bucket trained whole on each rank);
14. ``last_modules`` (``phase_last_modules``), the port's modules no
   stage runs, at full width: the StyleGAN2 ``Generator`` at the EG3D
   tri-plane backbone's widths (``configs/eg3d.yaml``, 256^2 x 96, c_dim
   25) at batch 4 in ``noise_mode="random"`` (K6b with a noise plane per
   sample), forward and backward; the conditional ``Discriminator`` at
   512^2 (c_dim 25, its 4 highest resolutions in bf16) at batch 4 with
   R1's double backward; ``SuperresolutionHybrid4X`` 128^2 -> 256^2 (w_dim
   512, bf16, random noise); ``TemporalAttNet`` on a window of 5 planes of
   the SECC plane's shape; the torso's ``PatchDiscriminator`` on 512^2
   with the keypoint heatmaps. Every distinct K6a and K6b call of the
   three StyleGAN2 models is then held against its plain version
   (``hold_calls``); the per-sample noise form of K6b is timed per launch
   beside its bound and its plain version;
15. ``study`` (``phase_study``): the port's sampling study
   (``real3dportrait_tpu_torch/tools/study_sampling.py``) at 128^2, its
   table printed, K2 and K3 launched (K3 at 3 colour channels, its scalar
   path), every K2 and K3 call of its merged schemes against the plain
   versions, its rows at 32^2 against the CPU's; and every port
   subpackage's exports imported on this host;
16. ``ray_cp`` (``phase_ray_cp``), the mesh's ``rays`` axis: the default
   model's frame (tri-grids from ``cal_plane_given_cano`` of a seeded
   source, its decoder, its frame camera's 128^2 rays) at ``fast`` and
   48+48 and the released geometry's tri-planes at ``fast``, rendered by
   two gloo ranks sharing the card (``python3 chip_smoke.py --ddp-worker
   SPEC`` under ``torch.distributed.run``), each on its 8,192 rays
   (``render_rays_sharded``), gathered bit-equal to the unsharded render
   (depth where the weights are not 0), K1-trigrid, K1, K2 and K3 held to
   their plain versions at each rank's block; the default model's frame
   also under a wide camera whose upper half sees past the box (rank 0's
   rays all miss it, so its fallback bounds are the all-reduce's alone),
   with its decoder and with a density that reads one feature (rays of
   zero weight in both blocks), each rank's block held on every output to
   the block rendered alone in one process with the whole frame's bounds;
   the same render in a one-rank NCCL world; one training step of
   ``configs/secc_img2plane.yaml`` at ``mesh_shape={data: 1, rays: 2}``
   on the two ranks against one process.

The last lines are the kernels JSON (the backward kernels with their
launches a step of the training run that is their main path; K4's
launches a batch of record preparation and the step kernels' a step of
``train_records`` as ``train_records_launches_per_step``; the EG3D and
img2plane stages' as ``train_eg3d_launches_per_step`` and
``train_img2plane_launches_per_step``; a rank's of the data-parallel
SECC stage from a record store as ``ddp_records_launches_per_rank``; a
rank's of the ``ray_cp`` renders as ``ray_cp_launches_per_rank``), the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

# one card: the smoke drives device 0 and reports the cards it can see
os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from real3dportrait_tpu_torch.kernels import card_line, cuda_ms, device_ms  # noqa: E402
from real3dportrait_tpu_torch.training.profile_step import FULL_STEP_HPARAMS  # noqa: E402
from real3dportrait_tpu_torch.utils.precision import set_fp32_policy  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
DEFAULT_CONFIG = "secc_img2plane_torso.yaml"
RELEASED_CONFIG = "real3d_orig.yaml"
# H100 SXM data sheet: HBM bytes/s and dense peak operations/s by type
HBM_RATE = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# fp32 products on the tensor cores in split TF32: 3 TF32 products (dense
# peak 495 TFLOP/s) for each
SPLIT_TF32_RATE = 495e12 / 3
# frames through the default model's two bf16 SR blocks: max / mean of scale
BF16_TOL = (3e-2, 3e-3)
REPLACES = {
    "triplane_decode": "real3dportrait_tpu/rendering/renderer.py:113",
    "trigrid_decode": "real3dportrait_tpu/rendering/renderer.py:81",
    "importance_sample": "real3dportrait_tpu/rendering/renderer.py:300",
    "merge_composite": "real3dportrait_tpu/rendering/renderer.py:367",
    "secc_raster": "real3dportrait_tpu/geometry/rasterizer.py:248",
    "torso_deform_input": "real3dportrait_tpu/models/torso.py:378",
    "torso_warp_volume": "real3dportrait_tpu/models/torso.py:500",
    "upfirdn2d": "real3dportrait_tpu/ops/upfirdn2d.py:59",
    "bias_act": "real3dportrait_tpu/ops/bias_act.py:37",
    "conv3d": "real3dportrait_tpu/ops/conv3d.py:21",
    "mfe_tail": "real3dportrait_tpu/models/torso.py:429",
}
SOURCES = {
    "triplane_decode": "real3dportrait_tpu_torch/csrc/triplane_decode.cu",
    "trigrid_decode": "real3dportrait_tpu_torch/csrc/triplane_decode.cu",
    "importance_sample": "real3dportrait_tpu_torch/csrc/render_march.cu",
    "merge_composite": "real3dportrait_tpu_torch/csrc/render_march.cu",
    "secc_raster": "real3dportrait_tpu_torch/csrc/secc_raster.cu",
    "torso_deform_input": "real3dportrait_tpu_torch/csrc/torso_warp.cu",
    "torso_warp_volume": "real3dportrait_tpu_torch/csrc/torso_warp.cu",
    "upfirdn2d": "real3dportrait_tpu_torch/csrc/stylegan_epilogue.cu",
    "bias_act": "real3dportrait_tpu_torch/csrc/stylegan_epilogue.cu",
    "conv3d": "real3dportrait_tpu_torch/csrc/conv3d.cu",
    "mfe_tail": "real3dportrait_tpu_torch/csrc/conv3d.cu",
}


def wrappers() -> dict:
    """The eleven kernel wrappers, by kernel name; each counts its launches
    (K6a and K6b also their bf16 launches apart, ``launches_bf16``)."""
    from real3dportrait_tpu_torch.geometry.rasterizer import rasterize_verts
    from real3dportrait_tpu_torch.models.decoder import trigrid_decode, triplane_decode
    from real3dportrait_tpu_torch.models.torso import (
        mfe_tail, torso_deform_input, torso_warp_volume)
    from real3dportrait_tpu_torch.ops.bias_act import bias_act
    from real3dportrait_tpu_torch.ops.conv3d import conv3d
    from real3dportrait_tpu_torch.ops.upfirdn2d import upfirdn2d
    from real3dportrait_tpu_torch.rendering.renderer import importance_sample, merge_composite

    return {"triplane_decode": triplane_decode, "trigrid_decode": trigrid_decode,
            "importance_sample": importance_sample, "merge_composite": merge_composite,
            "secc_raster": rasterize_verts, "torso_deform_input": torso_deform_input,
            "torso_warp_volume": torso_warp_volume, "upfirdn2d": upfirdn2d,
            "bias_act": bias_act, "conv3d": conv3d, "mfe_tail": mfe_tail}


BF16_COUNTED = ("upfirdn2d", "bias_act")


def reset_launches() -> None:
    for name, w in wrappers().items():
        w.launches = 0
        if name in BF16_COUNTED:
            w.launches_bf16 = 0


def read_launches() -> dict:
    """Launches by kernel name, and the bf16 ones as ``"<name> bf16"``."""
    counts = {k: w.launches for k, w in wrappers().items()}
    counts.update({f"{k} bf16": wrappers()[k].launches_bf16 for k in BF16_COUNTED})
    return counts


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in units of the last place of bf16 ``want``."""
    want = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
    return float(((got.float() - want).abs() / ulp).max())


def bf16_sum_err(got: torch.Tensor, want: torch.Tensor, mag: torch.Tensor,
                 n_terms: int = 16) -> float:
    """Largest |got - want| over its tolerance, for bf16 outputs of fp32
    sums taken in another order: 2 bf16 ulps of ``want`` plus the fp32
    reordering bound ``n_terms * 2^-24 * mag``, where ``mag`` is the sum of
    the terms' magnitudes (where terms cancel near zero, the order of an
    fp32 sum moves the result by up to that much, which is many ulps of a
    result near 0). At most 1 passes."""
    want = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
    tol = 2 * ulp + n_terms * 2.0 ** -24 * mag.float()
    return float(((got.float() - want).abs() / tol).max())


def bound(n_bytes: float, ops: float, dtype: torch.dtype, rate: float | None = None,
          more: tuple = ()) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations"); the
    operations at ``rate`` where given, else at the peak of ``dtype``;
    ``more``: (operations, operations/s) of work on other units, each a
    term of its own."""
    t_bytes = n_bytes / HBM_RATE
    t_ops = max([ops / (rate or PEAK_OPS[dtype])] + [o / r for o, r in more])
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    """Bytes of the tensors' distinct elements: a broadcast dimension (stride
    0, as the deterministic path's ``u``) counts once."""
    return sum(math.prod(n for n, st in zip(t.shape, t.stride()) if st != 0) * t.element_size()
               for t in ts if t is not None)


def mean_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().mean())


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def phase_toolchain() -> None:
    print(f"card: {card_line()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    from real3dportrait_tpu_torch import kernels

    nvcc = subprocess.run([kernels.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()
    print(f"nvcc: {nvcc[0]} | {nvcc[-1]}")


def phase_build() -> None:
    from real3dportrait_tpu_torch import kernels

    t0 = time.perf_counter()
    path, log = kernels.build()
    kernels.library()
    print(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")
    lines = log.splitlines()
    for line in lines:
        if "Function properties" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    # K3 and K7b's main kernels and their backward kernels, and K5a's and
    # K5b's adjoints, keep every value in registers: no spills; K2's, K4's,
    # K5a's and K5b's kernels neither spill nor keep a stack frame (K2's
    # per-ray values live in registers and shared memory; K5b fits 32
    # registers for 8 CTAs an SM)
    for i, line in enumerate(lines):
        if "Function properties for" in line and any(
                k in line for k in ("merge_composite_kernel", "mfe_tail_kernel",
                                    "merge_composite_backward_kernel", "tail_dgrad_kernel",
                                    "occ_wgrad_kernel", "deform_input_adjoint_kernel",
                                    "warp_volume_adjoint_kernel")):
            check(" 0 bytes spill stores, 0 bytes spill loads" in lines[i + 1],
                  f"ptxas spills in {line.split()[-1]}: {lines[i + 1].strip()}")
        if "Function properties for" in line and any(k in line for k in (
                "importance_sample_kernel", "secc_zbuffer_kernel", "secc_resolve_kernel",
                "deform_input_kernel", "warp_volume_kernel")):
            check("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
                  in lines[i + 1],
                  f"ptxas stack frame or spills in {line.split()[-1]}: {lines[i + 1].strip()}")
    cuobjdump = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    if os.path.isfile(cuobjdump):
        # K7a's products and weight gradient, K1's MLP and its backward's
        # products, K7b's data gradient run on the tensor cores: HMMA
        # instructions in the SASS of each instantiation
        sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                              check=True, timeout=300).stdout
        for kernel in ("conv3d_kernel", "plane_decode_kernel", "conv3d_wgrad_kernel",
                       "plane_decode_backward_kernel", "tail_dgrad_kernel"):
            hmma = {}
            for fn in sass.split("Function : ")[1:]:
                name = fn.split(None, 1)[0]
                if kernel in name:
                    hmma[name] = sum("HMMA" in line for line in fn.splitlines())
            print(f"  cuobjdump: HMMA instructions in {kernel}: {hmma}")
            check(bool(hmma) and all(hmma.values()), f"{kernel}'s SASS has no HMMA instruction")
    else:
        print("  cuobjdump: not in the toolkit; HMMA count not taken")


def phase_kernels(dev: torch.device) -> dict:
    """Each kernel vs its plain version at the main path's shapes."""
    import torch.nn.functional as F

    from real3dportrait_tpu_torch.geometry import bfm
    from real3dportrait_tpu_torch.geometry.rasterizer import (
        project_to_screen, rasterize_verts, rasterize_verts_plain)
    from real3dportrait_tpu_torch.inference.kernel_times import frame_passes
    from real3dportrait_tpu_torch.models.decoder import (
        OSGDecoder, k1_cost, trigrid_decode, trigrid_decode_plain, triplane_decode,
        triplane_decode_plain)
    from real3dportrait_tpu_torch.rendering.renderer import (
        importance_sample, importance_sample_plain, importance_u, merge_composite,
        merge_composite_plain)
    from real3dportrait_tpu_torch.weights import mock_init_

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    f32, bf16 = torch.float32, torch.bfloat16

    def record(name, tag, outs, tol, ms, plain_ms, cost, library=None, ulps=None, extra="",
               launch_ms=None):
        """``outs``: (kernel output, plain output) pairs; ``cost``: (bytes,
        operations, dtype[, operations/s where not the dtype's peak]) of the
        call; ``library``: the ms of one PyTorch
        call computing the same function, or None; ``ulps``: in bf16, the
        largest distance allowed in bf16 ulps of the plain output (then
        ``tol`` is not used); ``launch_ms``: the device time of one launch
        of the kernel and of the library call, (ms, ms or None), where the
        per-call times (``ms``, ``library``) may be the host's."""
        err = max(max_err(k, p) for k, p in outs)
        merr = max(mean_err(k, p) for k, p in outs)
        bound_ms, bound_by = bound(*cost)
        if ulps is None:
            check(err <= tol, f"{name}[{tag}] disagrees with its plain version: {err} > {tol}")
            tol_text = f"tol {tol:g}"
        else:
            u = max(bf16_ulps(k, p) for k, p in outs)
            equal = all(torch.equal(k, p) for k, p in outs)
            check(u <= ulps, f"{name}[{tag}] is {u} bf16 ulps from its plain version")
            tol_text = f"{u:g} bf16 ulps, {'bit-equal' if equal else 'not bit-equal'}, " \
                       f"tol {ulps} ulps"
        lib = "null" if library is None else f"{library:.4f} ms"
        per_launch = {}
        if launch_ms is not None:
            per_launch = dict(launch_ms=launch_ms[0], library_launch_ms=launch_ms[1])
            lib_launch = "null" if launch_ms[1] is None else f"{launch_ms[1]:.4f} ms"
            extra += f"per launch on the device: kernel {launch_ms[0]:.4f} ms library " \
                     f"{lib_launch}; per call: "
        print(f"{name}[{tag}]: max_abs_err {err:.3e} mean {merr:.3e} ({tol_text}) {extra}"
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms library {lib} "
              f"bound {bound_ms:.4f} ms ({bound_by})")
        # the JSON line keeps each kernel's first shape: the main path's
        # largest call, named with its working type
        rows.setdefault(name, dict(shape=tag, dtype=str(cost[2]).removeprefix("torch."),
                                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by,
                                   library_ms=library, **per_launch))

    # K1 and K1-trigrid: the planes of one frame, [1,3,256,256,32] and
    # [1,3,3,256,256,32]; the fast preset's coarse (16 x 128^2) and fine
    # (32 x 128^2) passes and the 48-sample passes, points uniform in the
    # box. The MLP in split TF32 and the corner sums in fp32, in another
    # order: tolerance 1e-4 absolute on rgb in [-0.001, 1.001] and sigma
    # O(1). Bound (decoder.k1_cost): the largest of the bytes (the planes
    # once, coordinates, rgb, sigma), the MLP's 2 * (32*64 + 64*33) a point
    # at the split-TF32 rate, and the corner lerps (2 a corner channel) and
    # 96 transcendentals a point at the fp32 rate; the FFMA bound (all of
    # it at 67 TFLOP/s, the CUDA-core design's bound) beside it. Per call and
    # per launch, as K6a.
    dec = mock_init_(OSGDecoder(32, 64, 32), torch.Generator().manual_seed(1)).to(dev)
    for name, shape, fn, plain in (
            ("trigrid_decode", (1, 3, 3, 256, 256, 32), trigrid_decode, trigrid_decode_plain),
            ("triplane_decode", (1, 3, 256, 256, 32), triplane_decode,
             triplane_decode_plain)):
        planes = torch.randn(shape, device=dev, generator=gen)
        counts = (524288, 262144, 786432) if name == "trigrid_decode" else (262144, 786432)
        for n in counts:
            coords = torch.rand((1, n, 3), device=dev, generator=gen) - 0.5
            with torch.no_grad():
                k_rgb, k_sig = fn(planes, coords, 1.0, dec)
                p_rgb, p_sig = plain(planes, coords, 1.0, dec)
                ms = cuda_ms(lambda: fn(planes, coords, 1.0, dec))
                pms = cuda_ms(lambda: plain(planes, coords, 1.0, dec))
                launch = device_ms(lambda: fn(planes, coords, 1.0, dec))
            c = k1_cost(tuple(planes.shape), n)
            check(c["bytes"] == nbytes(planes, coords, k_rgb, k_sig), f"{name}: k1_cost bytes")
            cost = (c["bytes"], c["mma_ops"], f32, SPLIT_TF32_RATE,
                    ((c["fp32_ops"], PEAK_OPS[f32]),))
            ffma_ms = bound(c["bytes"], c["mma_ops"] + c["fp32_ops"], f32)[0]
            record(name, f"{n} pts", [(k_rgb, p_rgb), (k_sig, p_sig)], 1e-4, ms, pms, cost,
                   launch_ms=(launch, None), extra=f"FFMA bound {ffma_ms:.4f} ms; ")
        del planes

    # K2/K3: 16,384 rays (128^2) at 16+32 and 48+48, and K2 on the coarse
    # samples of a frame that the default model renders at fast (captured
    # from synthesize; a stride-0 u, as on the main path). Depths O(2-3);
    # sums in another order (cdf, transmittance): tolerance 1e-4 absolute on
    # depths, composited rgb in [-1,1] and weights. Operations per ray: K2
    # ~16 per coarse sample (march, smoothing, pdf, cdf) and per fine sample
    # a binary search and an interpolation; K3 2 per colour channel and ~20
    # per merged sample. K2's bytes: depths, densities and fine depths, and
    # u once (one row). Per call and per launch, as K6a (below).
    r = 16384
    k2_frame = frame_passes(dev)[1]

    def k2_row(tag, depths, sigma, u):
        s_c, s_f = depths.shape[2], u.shape[1]
        fine_k = importance_sample(depths, sigma, u)
        record("importance_sample", tag, [(fine_k, importance_sample_plain(depths, sigma, u))],
               1e-4, cuda_ms(lambda: importance_sample(depths, sigma, u)),
               cuda_ms(lambda: importance_sample_plain(depths, sigma, u)),
               (nbytes(depths, sigma, u, fine_k),
                u.shape[0] * (16 * s_c + s_f * (2 * math.ceil(math.log2(s_c)) + 10)), f32),
               launch_ms=(device_ms(lambda: importance_sample(depths, sigma, u)), None))
        return fine_k

    for s_c, s_f in ((16, 32), (48, 48)):
        start = 2.0 + 0.2 * torch.rand((1, r, 1, 1), device=dev, generator=gen)
        steps = (torch.arange(s_c, device=dev) + 0.5)[None, None, :, None] / s_c
        depths = start + 0.8 * steps
        sigma = 3 * torch.randn((1, r, s_c, 1), device=dev, generator=gen)
        fine = k2_row(f"{s_c}+{s_f}", depths, sigma, importance_u(r, s_f, dev))
        c1 = torch.rand((1, r, s_c, 32), device=dev, generator=gen)
        c2 = torch.rand((1, r, s_f, 32), device=dev, generator=gen)
        s2 = 3 * torch.randn((1, r, s_f, 1), device=dev, generator=gen)
        args = (depths, c1, sigma, fine, c2, s2)
        outs = list(zip(merge_composite(*args), merge_composite_plain(*args)))
        record("merge_composite", f"{s_c}+{s_f}", outs, 1e-4,
               cuda_ms(lambda: merge_composite(*args)),
               cuda_ms(lambda: merge_composite_plain(*args)),
               (nbytes(*args, *(k for k, _ in outs)), r * (s_c + s_f) * (2 * 32 + 20), f32),
               launch_ms=(device_ms(lambda: merge_composite(*args)), None))
    check(k2_frame[2].stride(0) == 0, "the frame's u is not the stride-0 row")
    k2_row(f"frame {k2_frame[0].shape[2]}+{k2_frame[2].shape[1]}", *k2_frame)
    del k2_frame

    # K4: one frame of the 35,709-vertex synthetic mesh at 192^2 (the main
    # path's call: run rasterizes one frame at a time), then 16 frames; zero
    # pose, camera-space vertices in (the kernel projects them), the map in
    # [-1,1] as the SECC renderer asks for it. The kernel rounds every
    # operation as the plain version does and breaks depth ties by face id:
    # expected bit-equal; tolerance 0 differing mask pixels and 1e-6 on the
    # NCC. Bytes: vertices, faces, colours, mask and map. Operations: ~25
    # per pixel of each face's clipped bounding box (three edge functions,
    # depth) and ~20 per output pixel (the resolve), counted from this run's
    # projected faces. Per call and per launch (the wrapper's launches
    # together).
    assets = bfm.synthetic_bfm(n_vertices=35709).to(dev)
    rng = np.random.RandomState(0)
    idc = torch.from_numpy(np.tile(rng.randn(1, 80).astype(np.float32) * 0.1, (16, 1))).to(dev)
    exp = torch.from_numpy(rng.randn(16, 64).astype(np.float32) * 0.1).to(dev)
    zero = torch.zeros((16, 3), device=dev)
    verts16 = bfm.compute_face_vertex(assets, idc, exp, zero, zero).contiguous()
    attr = ((assets.ncc_code + 1) / 2).contiguous()
    faces = assets.face_buf
    for t in (1, 16):
        verts = verts16[:t].contiguous()
        cam = (1015.0, 112.0, 192, 5.0, 15.0)
        km, ki = rasterize_verts(verts, faces, attr, *cam)
        pm, pi = rasterize_verts_plain(verts, faces, attr, *cam)
        n_mask = int((km != pm).sum())
        check(n_mask == 0, f"secc_raster: {n_mask} mask pixels differ")
        check(0.2 < float(km.mean()) < 0.9, f"secc_raster coverage {float(km.mean())}")
        fuv = project_to_screen(verts, 1015.0, 112.0, 192)[0][:, faces.long()]  # [T,F,3,2]
        lo = torch.floor(fuv.min(dim=2).values).clamp(0, 191)
        hi = torch.floor(fuv.max(dim=2).values).clamp(0, 191)
        box_px = float((hi - lo + 1).clamp_min(0).prod(dim=-1).sum())
        record("secc_raster", f"{t}x192^2", [(ki, pi)], 1e-6,
               cuda_ms(lambda: rasterize_verts(verts, faces, attr, *cam)),
               cuda_ms(lambda: rasterize_verts_plain(verts, faces, attr, *cam), reps=5),
               (nbytes(verts, faces, attr, km, ki), 25 * box_px + 20 * km.numel(), f32),
               launch_ms=(device_ms(lambda: rasterize_verts(verts, faces, attr, *cam)), None),
               extra=f"coverage {float(km.mean()):.3f} ")
    del verts16, verts

    # K5a: the compressed volume of one 512^2 frame [1,16,64,64,4] and 4 of
    # the 68 keypoints, uniform in [-0.8,0.8]; then offsets up to 3.2 that
    # push samples outside the volume (zero padding); then source keypoints
    # within 0.1 of the driving ones, near the identity as a frame's are.
    # The kernel rounds the grid coordinates (i * fp32(1 / (n-1)), torch's
    # CUDA division by a scalar), the gaussians and the sparse motions as
    # the plain version does on the card, with no FMA contraction, and sums
    # the corners in its order: expected equal; tolerance 1e-4 absolute
    # (the kernel's former i / (n-1) coordinates left it up to ~4e-5 off).
    # Operations per voxel: 8 gaussians of ~10 and, per candidate, 8
    # corners of 4 channels (2 each) and ~20 for the weights.
    # K5b: the appearance volume [1,16,64,64,32], deformation uniform in
    # [-1.2,1.2] (border clamp), then within 0.02 of the identity grid, as
    # a frame's; the same coordinates reach both versions: 1e-5 absolute.
    # Operations per voxel: 8 corners of 32 channels, 2 each, and ~20 for
    # the weights. F.grid_sample (5-D, border) computes the same function,
    # on the volume's NCDHW view. K5a and K5b per call and per launch, the
    # library call too.
    from real3dportrait_tpu_torch.models import torso

    fs = torch.randn((1, 16, 64, 64, 4), device=dev, generator=gen)
    k5a_rows = []
    for tag, reach in (("kp 0.8", 0.8), ("kp 1.6, outside", 1.6)):
        kp_s = reach * (2 * torch.rand((1, 4, 3), device=dev, generator=gen) - 1)
        kp_d = reach * (2 * torch.rand((1, 4, 3), device=dev, generator=gen) - 1)
        k5a_rows.append((tag, kp_s, kp_d))
    kp_d = 0.8 * (2 * torch.rand((1, 4, 3), device=dev, generator=gen) - 1)
    kp_s = kp_d + 0.1 * (2 * torch.rand((1, 4, 3), device=dev, generator=gen) - 1)
    k5a_rows.append(("kp 0.8, near identity", kp_s, kp_d))
    for tag, kp_s, kp_d in k5a_rows:
        got = torso.torso_deform_input(fs, kp_s, kp_d)
        record("torso_deform_input", f"[1,16,64,64,4] {tag}",
               [(got, torso.torso_deform_input_plain(fs, kp_s, kp_d))], 1e-4,
               cuda_ms(lambda: torso.torso_deform_input(fs, kp_s, kp_d)),
               cuda_ms(lambda: torso.torso_deform_input_plain(fs, kp_s, kp_d)),
               (nbytes(fs, kp_s, kp_d, got), 65536 * (80 + 5 * (8 * 4 * 2 + 20)), f32),
               launch_ms=(device_ms(lambda: torso.torso_deform_input(fs, kp_s, kp_d)), None))
    vol = torch.randn((1, 16, 64, 64, 32), device=dev, generator=gen)
    uniform = 2.4 * torch.rand((1, 16, 64, 64, 3), device=dev, generator=gen) - 1.2
    near = torso.make_coordinate_grid_3d(16, 64, 64, dev)[None] \
        + 0.02 * (2 * torch.rand((1, 16, 64, 64, 3), device=dev, generator=gen) - 1)
    for tag, grid in (("", uniform), (" near identity", near)):
        got = torso.torso_warp_volume(vol, grid)
        plain = torso.torso_warp_volume_plain(vol, grid)

        def k5b_library():
            return F.grid_sample(vol.permute(0, 4, 1, 2, 3), grid, mode="bilinear",
                                 padding_mode="border", align_corners=True)

        check(max_err(k5b_library().reshape(plain.shape), plain) <= 1e-5,
              "torso_warp_volume: F.grid_sample computes another function")
        record("torso_warp_volume", f"[1,16,64,64,32]{tag}", [(got, plain)], 1e-5,
               cuda_ms(lambda: torso.torso_warp_volume(vol, grid)),
               cuda_ms(lambda: torso.torso_warp_volume_plain(vol, grid)),
               (nbytes(vol, grid, got), 65536 * (8 * 32 * 2 + 20), f32),
               library=cuda_ms(k5b_library),
               launch_ms=(device_ms(lambda: torso.torso_warp_volume(vol, grid)),
                          device_ms(k5b_library)))
    del fs, vol, uniform, near, grid, got, plain

    # K6a: the FIR after block1's and block0's up-convolutions (4x4 taps,
    # gain 4) in bf16, the blocks' working type on the default model, then
    # in fp32 (the released geometry), the skip image's 2x upsample at both
    # blocks (fp32 on both models), and a crop (negative padding) with a
    # downsample. bf16: the taps ({1,3,9}/16) are exact, the kernel sums in
    # fp32 and rounds once, the plain version's depthwise bf16 convolution
    # sums in another order: within 2 bf16 ulps of its output. fp32: 16
    # taps summed in another order, 1e-5 absolute on N(0,1) inputs.
    # Operations: 2 per tap that lands on the input (up 2: a quarter).
    # Library: one grouped F.conv2d (the FIR) or F.conv_transpose2d
    # (stride-2 upsample), checked to give the plain version's output.
    # Times: per call (an event pair around one call on an idle device,
    # the wrapper's host work included: what the frame pays) and per launch
    # on the device (20 back-to-back calls queued behind a spin kernel).
    from real3dportrait_tpu_torch.ops import bias_act as ba
    from real3dportrait_tpu_torch.ops import upfirdn2d as ufd

    f = ufd.setup_filter([1, 3, 3, 1], device=dev)
    cases = (("block1 FIR [1,128,515^2] bf16", (1, 128, 515, 515), bf16, dict(gain=4)),
             ("block0 FIR [1,256,259^2] bf16", (1, 256, 259, 259), bf16, dict(gain=4)),
             ("block1 FIR [1,128,515^2]", (1, 128, 515, 515), f32, dict(gain=4)),
             ("block0 FIR [1,256,259^2]", (1, 256, 259, 259), f32, dict(gain=4)),
             ("skip up2 [1,3,128^2]", (1, 3, 128, 128), f32,
              dict(up=2, padding=(2, 1, 2, 1), gain=4)),
             ("skip up2 [1,3,256^2]", (1, 3, 256, 256), f32,
              dict(up=2, padding=(2, 1, 2, 1), gain=4)),
             ("crop up2 down2 [1,8,99^2]", (1, 8, 99, 99), f32,
              dict(up=2, down=2, padding=(-3, 1, 2, -2))))
    for tag, shape, dtype, kw in cases:
        x = torch.randn(shape, device=dev, generator=gen).to(dtype)
        got = ufd.upfirdn2d(x, f, **kw)
        want = ufd.upfirdn2d_plain(x, f, **kw)
        c = shape[1]
        taps = 16 // (kw.get("up", 1) ** 2)
        library = None
        if "crop" not in tag:
            w4 = (f * kw["gain"]).to(dtype)[None, None].expand(c, 1, 4, 4).contiguous()
            if kw.get("up", 1) == 2:
                def lib(x=x, w4=w4, c=c):
                    return F.conv_transpose2d(x, w4, stride=2, padding=1, groups=c)
            else:
                w4 = torch.flip(w4, (2, 3))

                def lib(x=x, w4=w4, c=c):
                    return F.conv2d(x, w4, groups=c)
            check(max_err(lib(), want) <= (1e-5 if dtype == f32 else
                                           0.02 * float(want.abs().max())),
                  f"upfirdn2d[{tag}]: the library call computes another function")
            library = cuda_ms(lib)
        record("upfirdn2d", tag, [(got, want)], 1e-5,
               cuda_ms(lambda: ufd.upfirdn2d(x, f, **kw)),
               cuda_ms(lambda: ufd.upfirdn2d_plain(x, f, **kw)),
               (nbytes(x, got), 2 * taps * got.numel(), dtype), library=library,
               ulps=2 if dtype == bf16 else None,
               launch_ms=(device_ms(lambda: ufd.upfirdn2d(x, f, **kw)),
                          None if library is None else device_ms(lib)))
        del x, got, want

    # K6b: block1's conv epilogue (demodulation, noise, bias, lrelu, gain
    # sqrt 2, clamp 256) at [1,128,512^2] and block0's at [1,256,256^2] in
    # bf16, where every step rounds to bf16 in the plain version's order:
    # expected bit-equal, checked within 2 bf16 ulps; then block1's fp32
    # epilogue of the released geometry and head_torso_block's fp32 one at
    # [1,256,256^2] (clamp 4 so that it acts) and toRGB's [1,3,512^2]
    # (bias only), rounded in the plain version's order: 1e-6 absolute.
    # Operations: one per term (scale, noise, bias, activation, gain) and
    # two for the clamp, per element. No single PyTorch call computes this
    # epilogue. Per call and per launch, as K6a.
    for tag, shape, dtype, clamp in (("[1,128,512^2] lrelu demod noise clamp bf16",
                                      (1, 128, 512, 512), bf16, 256.0),
                                     ("[1,256,256^2] lrelu demod noise clamp bf16",
                                      (1, 256, 256, 256), bf16, 256.0),
                                     ("[1,128,512^2] lrelu demod noise clamp",
                                      (1, 128, 512, 512), f32, 4.0),
                                     ("[1,256,256^2] lrelu demod noise clamp",
                                      (1, 256, 256, 256), f32, 4.0)):
        b, c, h, w = shape
        x = (4 * torch.randn(shape, device=dev, generator=gen)).to(dtype)
        kw = dict(act="lrelu", gain=2 ** 0.5, clamp=clamp, axis=1,
                  scale=torch.rand((b, c), device=dev, generator=gen) + 0.5,
                  noise=0.3 * torch.randn((h, w), device=dev, generator=gen))
        bias = torch.randn((c,), device=dev, generator=gen)
        got = ba.bias_act(x, bias, **kw)
        record("bias_act", tag, [(got, ba.bias_act_plain(x, bias, **kw))], 1e-6,
               cuda_ms(lambda: ba.bias_act(x, bias, **kw)),
               cuda_ms(lambda: ba.bias_act_plain(x, bias, **kw)),
               (nbytes(x, got, bias, kw["scale"], kw["noise"]), 7 * x.numel(), dtype),
               ulps=2 if dtype == bf16 else None,
               launch_ms=(device_ms(lambda: ba.bias_act(x, bias, **kw)), None))
    x, bias = x[:, :3].contiguous(), bias[:3].contiguous()
    got = ba.bias_act(x, bias, axis=1)
    record("bias_act", "[1,3,512^2] linear",
           [(got, ba.bias_act_plain(x, bias, axis=1))], 1e-6,
           cuda_ms(lambda: ba.bias_act(x, bias, axis=1)),
           cuda_ms(lambda: ba.bias_act_plain(x, bias, axis=1)),
           (nbytes(x, got, bias), x.numel(), f32),
           launch_ms=(device_ms(lambda: ba.bias_act(x, bias, axis=1)), None))
    del x, got
    kernels_k7(dev, gen, record)
    return rows


def kernels_k7(dev: torch.device, gen: torch.Generator, record) -> None:
    """K7a at every distinct 3D conv of the standard torso: the 7^3
    tgt_head_fuser [1,89,16,64,64] -> 32, the U-Net's down_0-4 and up_0-4
    and the appearance extractor's ResBlock3D 3^3 [1,32,16,64,64] -> 32
    (``TORSO_CONV3D_SHAPES``; the fuser's is the JSON line's); K7b at the
    frame's [1,32,16,64,64] with 4 keypoints uniform in [-0.8, 0.8]. Inputs N(0,1), weights N(0, 1/fan_in), so every
    output is O(1). K7a sums up to 89 * 343 = 30,527 split-TF32 products in
    another order than cuDNN's fp32: 3e-4 absolute. K7b: mask logits of
    32 * 343 products and occlusion sums of 512 * 49, then softmax and
    sigmoid: 1e-4 absolute on the deformation and both maps. Operations: 2
    per product, counting only the taps inside the volume (``conv3d_ops``),
    none of the padding's. K7a's bound is the tensor cores' (3 TF32
    products per fp32 product at 495 TFLOP/s); the FFMA bound (67 TFLOP/s)
    is printed beside it. Each K7a row gives the device time of one launch
    (20 back-to-back) for the kernel and cuDNN, and one call's time; the K7b
    row one launch (its two kernels) and one call. The
    library call of K7a is cuDNN's ``F.conv3d`` (TF32 off), which is also
    the plain version; no single PyTorch call computes K7b, so cuDNN's
    ``mask_conv`` alone is printed beside it."""
    import torch.nn.functional as F

    from real3dportrait_tpu_torch.inference.k7_shapes import TORSO_CONV3D_SHAPES
    from real3dportrait_tpu_torch.models import torso
    from real3dportrait_tpu_torch.ops import conv3d as c3d

    f32 = torch.float32
    tiles, sms = c3d.kernel_tiles(), c3d.sm_count(dev)
    for tag, (ci, co, k, dhw) in TORSO_CONV3D_SHAPES:
        x = torch.randn((1, ci, *dhw), device=dev, generator=gen)
        w = torch.randn((co, ci, k, k, k), device=dev, generator=gen) / (ci * k ** 3) ** 0.5
        b = torch.randn((co,), device=dev, generator=gen)
        got = c3d.conv3d(x, w, b)
        ops = c3d.conv3d_ops(ci, co, *dhw, k)
        cost = (nbytes(x, w, b, got), ops, f32, SPLIT_TF32_RATE)
        ffma_ms = bound(*cost[:3])[0]
        record("conv3d", tag, [(got, c3d.conv3d_plain(x, w, b))], 3e-4,
               cuda_ms(lambda: c3d.conv3d(x, w, b)), cuda_ms(lambda: c3d.conv3d_plain(x, w, b)),
               cost, library=cuda_ms(lambda: F.conv3d(x, w, b, padding=k // 2)),
               launch_ms=(device_ms(lambda: c3d.conv3d(x, w, b)),
                          device_ms(lambda: F.conv3d(x, w, b, padding=k // 2))),
               extra=f"FFMA bound {ffma_ms:.4f} ms, plan "
                     f"{c3d.conv3d_plan(1, ci, co, *dhw, k, tiles, sms)}; ")
        del x, w, b, got
    c, d, h, w_ = 32, 16, 64, 64
    x = torch.randn((1, c, d, h, w_), device=dev, generator=gen)
    mask_w = torch.randn((5, c, 7, 7, 7), device=dev, generator=gen) / (c * 343) ** 0.5
    mask_b = torch.randn((5,), device=dev, generator=gen)
    occ_w = torch.randn((2, c * d, 7, 7), device=dev, generator=gen) / (c * d * 49) ** 0.5
    occ_b = torch.randn((2,), device=dev, generator=gen)
    kp_s, kp_d = (1.6 * torch.rand((1, 4, 3), device=dev, generator=gen) - 0.8
                  for _ in range(2))
    args = (x, mask_w, mask_b, occ_w, occ_b, kp_s, kp_d)
    got = torso.mfe_tail(*args)
    mask_ms = cuda_ms(lambda: F.conv3d(x, mask_w, mask_b, padding=3))
    # the 7^3 mask conv and both 7^2 heads, a conv of depth 1 over C*D channels
    ops = c3d.conv3d_ops(c, 5, d, h, w_, 7) + c3d.conv3d_ops(c * d, 2, 1, h, w_, 7)
    record("mfe_tail", "[1,32,16,64,64] K+1=5", list(zip(got, torso.mfe_tail_plain(*args))),
           1e-4, cuda_ms(lambda: torso.mfe_tail(*args)),
           cuda_ms(lambda: torso.mfe_tail_plain(*args)), (nbytes(*args, *got), ops, f32),
           launch_ms=(device_ms(lambda: torso.mfe_tail(*args)), None),
           extra=f"cuDNN mask_conv 7^3 alone {mask_ms:.4f} ms ")


def phase_batch_kernels(dev: torch.device, fb: int = 8, big: int = 16) -> dict:
    """Each of the eleven kernels against its plain version at ``fb``
    frames a step (the default model at ``fast``; K1 on the released
    geometry's tri-planes), with ``phase_kernels``' tolerances; K6a and K6b
    also at ``big`` frames on the fp32 block1 shapes, whose [big,128,512^2]
    tensors hold 2^31 bytes, and K7a at ``big`` at every torso shape. Each
    row gives the device time of one launch (10 back-to-back behind a spin
    kernel) at the batch and at B = 1 on the batch's first frame, and the
    bound at the batch's shape, reckoned as in ``phase_kernels``. Returns
    the first ``fb`` row of each kernel, by name."""
    from real3dportrait_tpu_torch.geometry import bfm
    from real3dportrait_tpu_torch.geometry.rasterizer import (
        project_to_screen, rasterize_verts, rasterize_verts_plain)
    from real3dportrait_tpu_torch.inference.k7_shapes import TORSO_CONV3D_SHAPES
    from real3dportrait_tpu_torch.models import torso
    from real3dportrait_tpu_torch.models.decoder import (
        OSGDecoder, k1_cost, trigrid_decode, trigrid_decode_plain, triplane_decode,
        triplane_decode_plain)
    from real3dportrait_tpu_torch.ops import bias_act as ba
    from real3dportrait_tpu_torch.ops import conv3d as c3d
    from real3dportrait_tpu_torch.ops import upfirdn2d as ufd
    from real3dportrait_tpu_torch.rendering.renderer import (
        importance_sample, importance_sample_plain, importance_u, merge_composite,
        merge_composite_plain)
    from real3dportrait_tpu_torch.weights import mock_init_

    gen = torch.Generator(device=dev).manual_seed(8)
    f32, bf16 = torch.float32, torch.bfloat16
    rows: dict = {}

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    def rand(*shape):
        return torch.rand(shape, device=dev, generator=gen)

    def hold(name, tag, n, call, plain, one, tol, cost, ulps=None):
        """``call()`` (the kernel at batch ``n``) against ``plain()``, tuples
        element by element; ``one()``: the kernel on the batch's first
        frame."""
        with torch.no_grad():
            got, want = call(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(max_err(k, p) for k, p in zip(got, want))
            u = None if ulps is None else max(bf16_ulps(k, p) for k, p in zip(got, want))
            del got, want
            ms = device_ms(call, launches=10, reps=3, warmup=1)
            ms1 = device_ms(one, launches=10, reps=3, warmup=1)
        if ulps is None:
            check(err <= tol, f"{name}[{tag}] disagrees with its plain version: {err} > {tol}")
            tol_text = f"tol {tol:g}"
        else:
            check(u <= ulps, f"{name}[{tag}] is {u} bf16 ulps from its plain version")
            tol_text = f"{u:g} bf16 ulps, tol {ulps} ulps"
        bound_ms, bound_by = bound(*cost)
        print(f"batch {name}[{tag}]: max_abs_err {err:.3e} ({tol_text}); per launch "
              f"{ms:.4f} ms at B={n}, {ms1:.4f} ms at B=1 ({ms / (n * ms1):.3f} of B=1 a "
              f"frame); bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of it")
        if n == fb:
            rows.setdefault(name, dict(fb=n, shape=tag, launch_ms=ms, b1_launch_ms=ms1,
                                       bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err))

    # K1-trigrid: the default model's tri-grids of fb frames, the coarse and
    # fine passes' points (uniform in the box); K1: the released geometry's
    # tri-planes and its coarse pass. Cost: decoder.k1_cost, as phase_kernels
    dec = mock_init_(OSGDecoder(32, 64, 32), torch.Generator().manual_seed(1)).to(dev)
    for name, shape, fn, plain, counts in (
            ("trigrid_decode", (fb, 3, 3, 256, 256, 32), trigrid_decode, trigrid_decode_plain,
             (262144, 524288)),
            ("triplane_decode", (fb, 3, 256, 256, 32), triplane_decode, triplane_decode_plain,
             (262144,))):
        planes = randn(*shape)
        for n in counts:
            coords = rand(fb, n, 3) - 0.5
            c = k1_cost(shape, fb * n)
            hold(name, f"{list(shape)}, {n} points a frame", fb,
                 lambda: fn(planes, coords, 1.0, dec), lambda: plain(planes, coords, 1.0, dec),
                 lambda: fn(planes[:1], coords[:1], 1.0, dec), 1e-4,
                 (c["bytes"], c["mma_ops"], f32, SPLIT_TF32_RATE,
                  ((c["fp32_ops"], PEAK_OPS[f32]),)))
            del coords
        del planes

    # K2 / K3 at 16+32 on fb frames of 128^2 rays, u the stride-0 row
    r = fb * 16384
    start = 2.0 + 0.2 * rand(fb, 16384, 1, 1)
    depths = start + 0.8 * ((torch.arange(16, device=dev) + 0.5)[None, None, :, None] / 16)
    sigma = 3 * randn(fb, 16384, 16, 1)
    u = importance_u(r, 32, dev)
    hold("importance_sample", f"[{fb},16384,16,1] 16+32", fb,
         lambda: importance_sample(depths, sigma, u),
         lambda: importance_sample_plain(depths, sigma, u),
         lambda: importance_sample(depths[:1], sigma[:1], u[:16384]), 1e-4,
         (nbytes(depths, sigma, u) + 4 * r * 32, r * (16 * 16 + 32 * (2 * 4 + 10)), f32))
    args = (depths, rand(fb, 16384, 16, 32), sigma, importance_sample(depths, sigma, u),
            rand(fb, 16384, 32, 32), 3 * randn(fb, 16384, 32, 1))
    hold("merge_composite", f"[{fb},16384] 16+32, 32 channels", fb,
         lambda: merge_composite(*args), lambda: merge_composite_plain(*args),
         lambda: merge_composite(*(a[:1] for a in args)), 1e-4,
         (nbytes(*args) + 4 * r * (32 + 1 + 47), r * 48 * (2 * 32 + 20), f32))
    del depths, sigma, args

    # K4: fb frames of the 35,709-vertex synthetic mesh at 192^2 in one
    # call, as a batched step rasterizes its target maps
    assets = bfm.synthetic_bfm(n_vertices=35709).to(dev)
    rng = np.random.RandomState(8)
    idc = torch.from_numpy(np.tile(rng.randn(1, 80).astype(np.float32) * 0.1, (fb, 1))).to(dev)
    exp = torch.from_numpy(rng.randn(fb, 64).astype(np.float32) * 0.1).to(dev)
    zero = torch.zeros((fb, 3), device=dev)
    verts = bfm.compute_face_vertex(assets, idc, exp, zero, zero).contiguous()
    attr, faces = ((assets.ncc_code + 1) / 2).contiguous(), assets.face_buf
    cam = (1015.0, 112.0, 192, 5.0, 15.0)
    km = rasterize_verts(verts, faces, attr, *cam)[0]
    n_mask = int((km != rasterize_verts_plain(verts, faces, attr, *cam)[0]).sum())
    check(n_mask == 0, f"secc_raster at {fb} frames: {n_mask} mask pixels differ")
    fuv = project_to_screen(verts, 1015.0, 112.0, 192)[0][:, faces.long()]
    lo = torch.floor(fuv.min(dim=2).values).clamp(0, 191)
    hi = torch.floor(fuv.max(dim=2).values).clamp(0, 191)
    box_px = float((hi - lo + 1).clamp_min(0).prod(dim=-1).sum())
    hold("secc_raster", f"{fb}x192^2", fb, lambda: rasterize_verts(verts, faces, attr, *cam),
         lambda: rasterize_verts_plain(verts, faces, attr, *cam),
         lambda: rasterize_verts(verts[:1], faces, attr, *cam), 1e-6,
         (nbytes(verts, faces, attr) + 4 * km.numel() * 4, 25 * box_px + 20 * km.numel(), f32))
    del verts, km, fuv

    # K5a / K5b on fb frames' volumes; K5b near the identity grid, as a
    # frame's deformation
    fs = randn(fb, 16, 64, 64, 4)
    kp_s, kp_d = (0.8 * (2 * rand(fb, 4, 3) - 1) for _ in range(2))
    hold("torso_deform_input", f"[{fb},16,64,64,4] kp 0.8", fb,
         lambda: torso.torso_deform_input(fs, kp_s, kp_d),
         lambda: torso.torso_deform_input_plain(fs, kp_s, kp_d),
         lambda: torso.torso_deform_input(fs[:1], kp_s[:1], kp_d[:1]), 1e-4,
         (nbytes(fs, kp_s, kp_d) + 4 * fb * 25 * 65536,
          fb * 65536 * (80 + 5 * (8 * 4 * 2 + 20)), f32))
    vol = randn(fb, 16, 64, 64, 32)
    grid = torso.make_coordinate_grid_3d(16, 64, 64, dev)[None] + 0.02 * (
        2 * rand(fb, 16, 64, 64, 3) - 1)
    hold("torso_warp_volume", f"[{fb},16,64,64,32] near identity", fb,
         lambda: torso.torso_warp_volume(vol, grid),
         lambda: torso.torso_warp_volume_plain(vol, grid),
         lambda: torso.torso_warp_volume(vol[:1], grid[:1]), 1e-5,
         (2 * nbytes(vol) + nbytes(grid), fb * 65536 * (8 * 32 * 2 + 20), f32))
    del fs, vol, grid

    # K6a: the default model's bf16 block FIRs, the skip image's fp32 up2
    # and a crop at fb; the fp32 block FIRs at big ([big,128,512^2] out,
    # 2^31 B). Operations: 2 per tap that lands on the input
    f = ufd.setup_filter([1, 3, 3, 1], device=dev)
    fir = dict(gain=4)
    for n, shape, dtype, kw in (
            (fb, (128, 515, 515), bf16, fir), (fb, (256, 259, 259), bf16, fir),
            (fb, (3, 128, 128), f32, dict(up=2, padding=(2, 1, 2, 1), gain=4)),
            (fb, (3, 256, 256), f32, dict(up=2, padding=(2, 1, 2, 1), gain=4)),
            (fb, (8, 99, 99), f32, dict(up=2, down=2, padding=(-3, 1, 2, -2))),
            (big, (128, 515, 515), f32, fir), (big, (256, 259, 259), f32, fir)):
        x = randn(n, *shape).to(dtype)
        y_numel = n * math.prod(ufd.upfirdn2d(x[:1], f, **kw).shape)
        taps = 16 // (kw.get("up", 1) ** 2)
        hold("upfirdn2d", f"[{n},{','.join(map(str, shape))}] {str(dtype)[6:]} "
             f"{'up2' if kw.get('up') else 'FIR'}{' crop' if 'down' in kw else ''}", n,
             lambda: ufd.upfirdn2d(x, f, **kw), lambda: ufd.upfirdn2d_plain(x, f, **kw),
             lambda: ufd.upfirdn2d(x[:1], f, **kw), 1e-5,
             (nbytes(x) + y_numel * x.element_size(), 2 * taps * y_numel, dtype),
             ulps=2 if dtype == bf16 else None)
        del x

    # K6b: the bf16 block epilogues (demodulation, noise, bias, lrelu, gain,
    # clamp 256), the fp32 one (clamp 4) and toRGB (bias only) at fb; the
    # fp32 [big,128,512^2] one (2^31 B each way)
    for n, (c, h, w), dtype, clamp in ((fb, (128, 512, 512), bf16, 256.0),
                                       (fb, (256, 256, 256), bf16, 256.0),
                                       (fb, (128, 512, 512), f32, 4.0),
                                       (fb, (3, 512, 512), f32, None),
                                       (big, (128, 512, 512), f32, 4.0)):
        x = (4 * randn(n, c, h, w)).to(dtype)
        bias = randn(c)
        kw = dict(axis=1) if clamp is None else dict(
            act="lrelu", gain=2 ** 0.5, clamp=clamp, axis=1, scale=rand(n, c) + 0.5,
            noise=0.3 * randn(h, w))
        kw1 = dict(kw, scale=kw["scale"][:1]) if "scale" in kw else kw
        hold("bias_act", f"[{n},{c},{h},{w}] {str(dtype)[6:]}"
             f"{' toRGB' if clamp is None else ''}", n,
             lambda: ba.bias_act(x, bias, **kw), lambda: ba.bias_act_plain(x, bias, **kw),
             lambda: ba.bias_act(x[:1], bias, **kw1), 1e-6,
             (2 * nbytes(x) + nbytes(bias, kw.get("scale"), kw.get("noise")),
              (1 if clamp is None else 7) * x.numel(), dtype),
             ulps=2 if dtype == bf16 else None)
        del x

    # K7a at every torso shape at fb and big (plain: cuDNN's F.conv3d, TF32
    # off); K7b on fb frames of the estimator's [32,16,64,64] with 4
    # keypoints uniform in [-0.8, 0.8]
    for n in (fb, big):
        for tag, (ci, co, k, dhw) in TORSO_CONV3D_SHAPES:
            x = randn(n, ci, *dhw)
            w = randn(co, ci, k, k, k) / (ci * k ** 3) ** 0.5
            b = randn(co)
            hold("conv3d", tag.replace("[1,", f"[{n},"), n, lambda: c3d.conv3d(x, w, b),
                 lambda: c3d.conv3d_plain(x, w, b), lambda: c3d.conv3d(x[:1], w, b), 3e-4,
                 (nbytes(x, w, b) + 4 * n * co * math.prod(dhw),
                  c3d.conv3d_ops(ci, co, *dhw, k, b=n), f32, SPLIT_TF32_RATE))
            del x, w, b
    c, d, h, w_ = 32, 16, 64, 64
    args = (randn(fb, c, d, h, w_), randn(5, c, 7, 7, 7) / (c * 343) ** 0.5, randn(5),
            randn(2, c * d, 7, 7) / (c * d * 49) ** 0.5, randn(2),
            1.6 * rand(fb, 4, 3) - 0.8, 1.6 * rand(fb, 4, 3) - 0.8)
    one = (args[0][:1], *args[1:5], args[5][:1], args[6][:1])
    ops = c3d.conv3d_ops(c, 5, d, h, w_, 7, b=fb) + c3d.conv3d_ops(c * d, 2, 1, h, w_, 7, b=fb)
    hold("mfe_tail", f"[{fb},32,16,64,64] K+1=5", fb, lambda: torso.mfe_tail(*args),
         lambda: torso.mfe_tail_plain(*args), lambda: torso.mfe_tail(*one), 1e-4,
         (nbytes(*args) + 4 * fb * (d * h * w_ * 3 + 2 * h * w_), ops, f32))
    del args, one
    torch.cuda.empty_cache()
    check(set(rows) == set(REPLACES), f"kernels held at {fb} frames: {sorted(rows)}")
    return rows


def make_pipeline(config: str, preset: str, dev, use_torso: bool = True,
                  n_vertices: int = 35709, **overrides):
    """The pipeline of ``configs/<config>`` (torso model or head only) on the
    synthetic morphable model at the BFM09 mesh's scale (35,709 vertices,
    ~70k faces), seeded mock weights."""
    from real3dportrait_tpu_torch.config import load_config
    from real3dportrait_tpu_torch.geometry.bfm import synthetic_bfm
    from real3dportrait_tpu_torch.inference.pipeline import Real3DPortraitPipeline

    cfg = load_config(os.path.join(ROOT, "configs", config),
                      dict(sampling_preset=preset, **overrides))
    return Real3DPortraitPipeline(cfg, use_torso=use_torso, mock_weights=True,
                                  assets=synthetic_bfm(n_vertices=n_vertices), seed=0,
                                  device=dev)


def slice_inputs(res: int, n_frames: int):
    rng = np.random.RandomState(0)
    src = rng.randint(0, 256, (res, res, 3)).astype(np.uint8)
    exp = torch.from_numpy(rng.randn(n_frames, 64).astype(np.float32) * 0.3)
    bg = rng.randint(0, 256, (res, res, 3)).astype(np.uint8)
    return src, exp, bg


def run_slice(name: str, pipe, src, exp, bg, expect: set, forbid: set) -> dict:
    """Warm up over the whole sequence (cuDNN plans, allocator, first
    launches), then synthesise it again with the launch counters from 0;
    check the frames, that every kernel in ``expect`` launched and that
    none in ``forbid`` did."""
    coeffs = pipe.fit_source(None)
    mock = dict(blink_mode="none", prepare_source_images=False)
    pipe.synthesize(src, exp, coeffs, bg_img=bg, **mock)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tm: dict = {}
    reset_launches()
    t0 = time.perf_counter()
    frames = pipe.synthesize(src, exp, coeffs, bg_img=bg, timings=tm, **mock)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    res = pipe.res
    check(tuple(frames.shape) == (len(exp), res, res, 3), f"frames shape {tuple(frames.shape)}")
    check(frames.is_cuda, "frames must stay on the GPU")
    check(bool(torch.isfinite(frames).all()), "non-finite frames")
    check(all(counts[k] > 0 for k in expect), f"{name}: a kernel was not launched: {counts}")
    check(all(counts[k] == 0 for k in forbid), f"{name}: a kernel of another path ran: {counts}")
    p50 = statistics.median(tm["frame_ms"])
    caches = "".join(f", {k[:-3]} {tm[k]:.2f} ms" for k in ("cano_ms", "appearance_ms", "bg_ms")
                     if k in tm)
    print(f"slice[{name}]: frames {tuple(frames.shape)} p50 {p50:.2f} ms/frame "
          f"({1e3 / p50:.2f} fps), frame ms {[round(x, 2) for x in tm['frame_ms']]}"
          f"{caches}, wall {wall:.2f} s, launches {counts}, "
          f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts


def phase_slice(dev: torch.device) -> dict:
    """The default model's torso pipeline at ``fast`` (with a background
    image) and at the config's 48+48; then the released geometry's torso
    pipeline at ``fast`` (with the background image: the path whose count
    the line reports for K1, which the default model does not run) and at
    ``reference`` (48+48: K1 on 786k points per fine pass), and its
    head-only pipeline at ``fast``. Each drives the torso without source
    preparation or blinks."""
    src, exp, bg = slice_inputs(512, 8)
    every = set(read_launches())
    trigrid = every - {"triplane_decode"}
    triplane = every - {"trigrid_decode", "upfirdn2d bf16", "bias_act bf16"}
    torso = {"torso_deform_input", "torso_warp_volume", "conv3d", "mfe_tail"}
    launches = {}
    for name, config, preset, use_torso, bg_img, expect in (
            ("default torso fast", DEFAULT_CONFIG, "fast", True, bg, trigrid),
            ("default torso 48+48", DEFAULT_CONFIG, "config", True, None, trigrid),
            ("released torso fast", RELEASED_CONFIG, "fast", True, bg, triplane),
            ("released torso reference", RELEASED_CONFIG, "reference", True, None, triplane),
            ("released head-only fast", RELEASED_CONFIG, "fast", False, None,
             triplane - torso)):
        pipe = make_pipeline(config, preset, dev, use_torso=use_torso)
        counts = run_slice(name, pipe, src, exp, bg_img, expect, every - expect)
        # K1's launches from the released torso path at fast (the main path,
        # run, has the default model's tri-grids)
        if preset == "fast" and use_torso:
            launches[name] = counts
        del pipe
        torch.cuda.empty_cache()
    return launches


def seeded_wav(seconds: float, seed: int = 0) -> np.ndarray:
    """A 120-220 Hz chirp plus noise at 16 kHz, float32 in [-1, 1]."""
    rng = np.random.RandomState(seed)
    n = int(16000 * seconds)
    tt = np.arange(n) / 16000.0
    f = 120.0 + 100.0 * tt / seconds
    wav = 0.5 * np.sin(2 * np.pi * np.cumsum(f) / 16000.0) + 0.05 * rng.randn(n)
    return np.clip(wav, -1, 1).astype(np.float32)


def portrait_segmap(res: int) -> np.ndarray:
    """A [res,res] class map shaped like a portrait: face (3) and hair (1)
    blobs, a neck band (2), the torso (4) below, a patch of "other" (5)."""
    yy, xx = np.mgrid[:res, :res] / res
    seg = np.zeros((res, res), np.int64)
    seg[(yy - 0.4) ** 2 + (xx - 0.5) ** 2 < 0.06] = 3
    seg[((yy - 0.25) ** 2 + (xx - 0.5) ** 2 < 0.04) & (yy < 0.25)] = 1
    seg[(yy > 0.62) & (yy < 0.72) & (abs(xx - 0.5) < 0.1)] = 2
    seg[yy >= 0.72] = 4
    seg[(yy > 0.3) & (yy < 0.35) & (xx < 0.1)] = 5
    return seg


def phase_run(dev: torch.device, out_dir: str) -> dict:
    """The main path: ``Real3DPortraitPipeline()`` (the default model,
    seeded mock weights, the 35,709-vertex synthetic mesh) runs
    ``run(src, wav=<4 s>, out_path=...)`` with the JAX defaults after a
    warm-up on 0.64 s, with the launch counters from 0; it must give 100
    finite frames of 512^2 on the GPU through every default-path kernel and
    a non-empty video (or raw) file. Then the same call with stage timings
    (per-frame synchronisation), ``synthesize`` with a seeded portrait
    segmap (the head/torso split), and ``hubert_large`` on the wav."""
    from real3dportrait_tpu_torch.audio.hubert import hubert_large, make_hubert_extractor
    from real3dportrait_tpu_torch.weights import mock_init_

    pipe = make_pipeline(DEFAULT_CONFIG, "fast", dev)
    res = pipe.res
    rng = np.random.RandomState(0)
    src = rng.randint(0, 256, (res, res, 3)).astype(np.uint8)
    wav = seeded_wav(4.0)
    path = os.path.join(out_dir, "run.mp4")
    pipe.run(src, wav=seeded_wav(0.64, seed=1), out_path=os.path.join(out_dir, "warm.mp4"))
    torch.cuda.synchronize()
    every = set(read_launches())
    expect = every - {"triplane_decode"}
    reset_launches()
    t0 = time.perf_counter()
    frames = pipe.run(src, wav=wav, out_path=path)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    check(tuple(frames.shape) == (100, res, res, 3), f"run frames {tuple(frames.shape)}")
    check(frames.is_cuda and bool(torch.isfinite(frames).all()),
          "run frames must be finite and on the GPU")
    check(all(counts[k] > 0 for k in expect), f"run: a kernel was not launched: {counts}")
    check(counts["triplane_decode"] == 0, f"run: a kernel of another path ran: {counts}")
    written = {f: os.path.getsize(os.path.join(out_dir, f)) for f in os.listdir(out_dir)
               if f.startswith("run.mp4")}
    check(any(written.get(f, 0) > 0 for f in ("run.mp4", "run.mp4.raw")),
          f"run wrote no video: {written}")
    print(f"run[default, 4.0 s wav, JAX defaults]: frames {tuple(frames.shape)}, wall "
          f"{wall:.2f} s ({1e3 * wall / len(frames):.2f} ms/frame, host features, a2m, "
          f"source preparation, caches and video writing included), files {written}, "
          f"launches {counts}")
    del frames
    tm: dict = {}
    frames = pipe.run(src, wav=wav, out_path=path, timings=tm)
    torch.cuda.synchronize()
    p50 = statistics.median(tm["frame_ms"])
    stages = ", ".join(f"{k[:-3]} {tm[k]:.2f} ms" for k in (
        "features_ms", "a2m_ms", "prep_ms", "cano_ms", "appearance_ms", "bg_ms"))
    blinks = sorted(tm["frame_ms"][62:67])
    print(f"run stages (synchronised): {stages}; frame p50 {p50:.2f} ms ({1e3 / p50:.2f} fps), "
          f"blink frames 62-66 p50 {blinks[2]:.2f} ms, frame ms "
          f"{[round(x, 2) for x in tm['frame_ms'][:8]]}...")
    del frames

    seg = portrait_segmap(res)
    exp = pipe.audio_to_motion(*pipe.audio_to_features(wav[:16000]), temperature=0.2,
                               generator=torch.Generator().manual_seed(1))
    tm = {}
    frames = pipe.synthesize(src, exp, pipe.fit_source(None), segmap=seg, timings=tm)
    torch.cuda.synchronize()
    check(tuple(frames.shape) == (24, res, res, 3) and bool(torch.isfinite(frames).all()),
          f"synthesize with a segmap: frames {tuple(frames.shape)}")
    print(f"run synthesize[explicit portrait segmap, 24 frames]: prep {tm['prep_ms']:.2f} ms, "
          f"appearance {tm['appearance_ms']:.2f} ms, frame p50 "
          f"{statistics.median(tm['frame_ms']):.2f} ms")
    del frames, pipe
    torch.cuda.empty_cache()

    hub = mock_init_(hubert_large(), torch.Generator().manual_seed(2)).to(dev).eval()
    extract = make_hubert_extractor(hub)
    feats = extract(wav)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        feats = extract(wav)
    torch.cuda.synchronize()
    check(feats.shape == (199, 1024) and bool(np.isfinite(feats).all()),
          f"hubert_large features {feats.shape}")
    print(f"run hubert_large[24 x 1024, seeded weights, 4.0 s wav]: features {feats.shape}, "
          f"{(time.perf_counter() - t0) * 1e3 / 3:.2f} ms per call (host normalisation and "
          f"copies included)")
    del hub
    torch.cuda.empty_cache()
    return counts


def phase_batch(dev: torch.device, out_dir: str, n_vertices: int = 35709,
                seconds: float = 4.0, batches: tuple = (1, 4, 8, 16), n_ident: int = 4,
                **overrides) -> dict:
    """``run`` with frame batching and the multi-identity mode on the default
    model (``fast``, seeded mock weights): the main path's call, from the 4 s
    seeded wav to 100 frames and a video, at temperature 0 (every call the
    same motion), at each ``frame_batch`` of ``batches`` after a warm-up at
    that batch on 0.64 s. First the memory reckoning: fb = 1's
    ``max_memory_allocated`` times each fb against the card's memory; the
    batches end at the largest that fits. Per fb: wall ms/frame, the frame
    steps' ms (synchronised; a second call with timings), the peak memory,
    the launch counts, which must be a fixed count a video plus a fixed
    count a step (K4: one a step and the two per-video maps), and the
    frames, which must agree with fb = 1's (3e-2 / 3e-3 of scale); the
    largest batch also with a seeded pose sequence, each frame its own
    camera, against fb = 1 on the same poses. Then ``n_ident`` seeded sources share the wav (``run`` without a video, the
    writer takes one identity a frame): ms per identity-frame, and each
    identity's frames against ``synthesize`` of its source alone without
    preparation, on the same motion."""
    pipe = make_pipeline(DEFAULT_CONFIG, "fast", dev, n_vertices=n_vertices, **overrides)
    res = pipe.res
    src = np.random.RandomState(0).randint(0, 256, (res, res, 3)).astype(np.uint8)
    wav, warm = seeded_wav(seconds), seeded_wav(0.64, seed=1)
    total = torch.cuda.get_device_properties(dev).total_memory
    path = os.path.join(out_dir, "batch.mp4")
    ref, stats, fits = None, {}, batches
    for fb in batches:
        if fb not in fits:
            continue
        pipe.run(src, wav=warm, temperature=0.0, frame_batch=fb,
                 out_path=os.path.join(out_dir, "warm.mp4"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        frames = pipe.run(src, wav=wav, temperature=0.0, frame_batch=fb, out_path=path)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, peak = read_launches(), torch.cuda.max_memory_allocated()
        n = len(frames)
        check(tuple(frames.shape) == (n, res, res, 3) and n > 0 and frames.is_cuda
              and bool(torch.isfinite(frames).all()), f"batch run fb={fb}: frames "
              f"{tuple(frames.shape)} not finite, on the host or of the wrong shape")
        check(os.path.getsize(path if os.path.exists(path) else path + ".raw") > 0,
              f"batch run fb={fb} wrote no video")
        tm: dict = {}
        pipe.run(src, wav=wav, temperature=0.0, frame_batch=fb, timings=tm)
        torch.cuda.synchronize()
        steps = -(-n // fb)
        check(len(tm["frame_ms"]) == steps, f"fb={fb}: {len(tm['frame_ms'])} step times")
        if ref is None:
            ref, agree_text = frames, "the reference"
            fits = [b for b in batches if b * peak <= total]
            print(f"batch memory reckoning: fb=1 peak {peak / 2**30:.2f} GiB x fb against the "
                  f"card's {total / 2**30:.2f} GiB: "
                  + ", ".join(f"fb={b} {b * peak / 2**30:.2f} GiB" for b in batches)
                  + f"; runs fb in {fits}")
        else:
            agree_text = "vs fb=1 " + compare(f"batch run fb={fb} frames vs fb=1", frames,
                                              ref, BF16_TOL)
        del frames
        stats[fb] = dict(steps=steps, counts=counts, frames=n)
        p50 = statistics.median(tm["frame_ms"])
        print(f"batch run[fb={fb}, {seconds} s wav, temperature 0]: {n} frames, wall "
              f"{wall:.2f} s ({1e3 * wall / n:.2f} ms/frame), {steps} steps p50 {p50:.2f} ms "
              f"({p50 / fb:.2f} ms/frame), steps {sum(tm['frame_ms']) / n:.2f} ms/frame in "
              f"all, peak {peak / 2**30:.2f} GiB, frames {agree_text}, launches {counts}")
    # launches: a fixed count a video plus a fixed count a step, from the
    # first two batches, must give every batch's
    (f1, s1), (f2, s2) = ((b, stats[b]["steps"]) for b in fits[:2])
    per_step, per_video = {}, {}
    for k in stats[f1]["counts"]:
        c1, c2 = stats[f1]["counts"][k], stats[f2]["counts"][k]
        per_step[k], rem = divmod(c1 - c2, s1 - s2)
        per_video[k] = c1 - per_step[k] * s1
        check(rem == 0 and per_step[k] >= 0 and per_video[k] >= 0,
              f"{k}: launches {c1} at fb={f1}, {c2} at fb={f2} are not a count a step")
        for b in fits:
            check(stats[b]["counts"][k] == per_video[k] + per_step[k] * stats[b]["steps"],
                  f"{k}: {stats[b]['counts'][k]} launches at fb={b}, not {per_video[k]} + "
                  f"{per_step[k]} x {stats[b]['steps']} steps")
    check(per_step["secc_raster"] == 1 and per_video["secc_raster"] == 2,
          f"K4: {per_step['secc_raster']} launches a step, {per_video['secc_raster']} a video")
    check(all(per_step[k] > 0 for k in per_step if k != "triplane_decode"),
          f"batch run: a kernel does not launch every step: {per_step}")
    print(f"batch launches a step at every fb in {fits}: {per_step}; a video: {per_video}")

    # a moving head: every frame of a step has its own camera, and the last
    # step of the largest batch is padded
    n, fb = stats[fits[0]]["frames"], fits[-1]
    phase = 2 * np.pi * np.arange(n)[:, None] / 50 + np.arange(3)
    pose = ((0.15 * np.sin(phase)).astype(np.float32),
            (0.03 * np.sin(phase + 1)).astype(np.float32))
    posed = [pipe.run(src, wav=wav, temperature=0.0, pose_seq=pose, frame_batch=b)
             for b in (1, fb)]
    text = compare(f"batch run fb={fb} with a pose sequence vs fb=1", posed[1], posed[0],
                   BF16_TOL)
    print(f"batch run[fb={fb}, a pose sequence of {n} frames]: frames vs fb=1 {text}")
    del posed

    # the multi-identity mode: n_ident sources share the wav's motion
    srcs = np.stack([np.random.RandomState(10 + k).randint(0, 256, (res, res, 3))
                     .astype(np.uint8) for k in range(n_ident)])
    pipe.run(srcs, wav=warm, temperature=0.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    multi = pipe.run(srcs, wav=wav, temperature=0.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, peak = read_launches(), torch.cuda.max_memory_allocated()
    n = len(multi)
    check(tuple(multi.shape) == (n, n_ident, res, res, 3) and n > 0
          and bool(torch.isfinite(multi).all()), f"multi-identity frames {tuple(multi.shape)}")
    check(counts["secc_raster"] == n + 2, f"multi-identity: K4 launched {counts['secc_raster']}")
    exp = pipe.audio_to_motion(*pipe.audio_to_features(wav), temperature=0.0)
    texts, alone_ms = [], []
    for k in range(n_ident):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        alone = pipe.synthesize(srcs[k], exp, pipe.fit_source(None),
                                prepare_source_images=False)
        torch.cuda.synchronize()
        alone_ms.append(1e3 * (time.perf_counter() - t0) / len(alone))
        texts.append(compare(f"identity {k} of {n_ident}", multi[:, k], alone, BF16_TOL))
        del alone
    print(f"batch multi-identity[N={n_ident}, {seconds} s wav, temperature 0]: frames "
          f"{tuple(multi.shape)}, wall {wall:.2f} s ({1e3 * wall / (n * n_ident):.2f} ms per "
          f"identity-frame), peak {peak / 2**30:.2f} GiB, launches {counts}; each source alone "
          f"(synthesize, no preparation) {[round(x, 2) for x in alone_ms]} ms/frame; identities "
          f"vs alone: {'; '.join(texts)}")
    del multi, pipe
    torch.cuda.empty_cache()
    return stats


def seeded_landmarks(assets, n_frames: int, seed: int) -> np.ndarray:
    """[T,68,2] normalised landmarks of the morphable model at seeded
    coefficients (numpy seed): one identity, an expression and a pose that
    drift smoothly over the frames."""
    from real3dportrait_tpu_torch.geometry.face3d_helper import reconstruct_lm2d

    rng = np.random.RandomState(seed)
    phase = np.linspace(0, 1, n_frames, dtype=np.float32)[:, None]
    idc = np.tile(rng.randn(1, 80) * 0.3, (n_frames, 1))
    exp = rng.randn(1, 64) * 0.2 + rng.randn(1, 64) * 0.1 * np.sin(2 * np.pi * phase)
    euler = rng.uniform(-0.1, 0.1, (1, 3)) + 0.05 * np.sin(3 * phase)
    trans = rng.uniform(-0.05, 0.05, (1, 3)) + 0.03 * phase
    coeffs = [torch.from_numpy(np.asarray(c, np.float32)) for c in (idc, exp, euler, trans)]
    return reconstruct_lm2d(assets, *coeffs).numpy()


def reprojection_err(assets, fit, lm: torch.Tensor) -> float:
    """Mean |landmarks of the fitted coefficients - lm| (normalised frame)."""
    from real3dportrait_tpu_torch.geometry.face3d_helper import reconstruct_lm2d

    pred = reconstruct_lm2d(assets, fit.id.expand(len(lm), 80), fit.exp, fit.euler, fit.trans)
    return float((pred - lm).abs().mean())


def fit_launches(assets, lm: torch.Tensor, dev, out_dir: str, step_ms: float,
                 steps: int = 10) -> str:
    """Per Adam step of a ``steps`` + ``steps`` fit, from ``torch.profiler``
    (``utils/profiling.trace_to``, host and device activity): the device
    operations (kernels, memsets, copies) and their device time, its share
    of ``step_ms`` (the step's time measured without the profiler), the
    host's kernel launches and its synchronisations."""
    from real3dportrait_tpu_torch.geometry.fit_3dmm import fit_coeffs
    from real3dportrait_tpu_torch.utils.profiling import trace_to

    with trace_to(os.path.join(out_dir, "fit_trace")) as prof:
        fit_coeffs(assets, lm, n_pose_iters=steps, n_joint_iters=steps, device=dev)
    events = prof.key_averages()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    on_device = sum(e.count for e in device)
    device_ms = sum(e.device_time_total for e in device) / 1e3
    launches = sum(e.count for e in events if e.key.startswith(("cudaLaunchKernel",
                                                                 "cuLaunchKernel")))
    syncs = sum(e.count for e in events if "Synchronize" in e.key)
    n = 2 * steps
    return (f"{on_device / n:.1f} device operations taking {device_ms / n:.4f} ms of device "
            f"time ({device_ms / n / step_ms:.1%} of the step), {launches / n:.1f} kernel "
            f"launches and {syncs / n:.2f} synchronisations a step (profiler, {n} steps)")


def face_video(n_frames: int, res: int, seed: int) -> np.ndarray:
    """[T,res,res,3] uint8 driving frames: a face disc in the face band and
    a body block below it drifting sideways over a still, slightly noisy
    background (the JAX package's test video at full size)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:res, :res]
    frames = rng.randint(0, 8, (n_frames, res, res, 3)).astype(np.uint8)
    offset = rng.uniform(0, 2 * np.pi)
    for i in range(n_frames):
        cx = res // 2 + int(0.1 * res * np.sin(2 * np.pi * i / 50 + offset))
        frames[i][(xx - cx) ** 2 + (yy - 0.35 * res) ** 2 < (res / 6) ** 2] = (150, 170, 200)
        frames[i][(yy >= 0.6 * res) & (abs(xx - cx) < res / 4)] = (160, 90, 90)
    return frames


def phase_fit(dev: torch.device, out_dir: str, n_vertices: int = 35709) -> None:
    """The 3DMM fit on the card (the default model's 35,709-vertex
    synthetic morphable model): ``fit_source`` of 68 landmarks made at
    seeded coefficients must reproject within 0.01 (mean abs, normalised
    frame: the JAX package's criterion) and agree with the CPU fit of the
    same landmarks (5e-3 max, 5e-4 mean, absolute: fp32 gradients in
    another order through 400 Adam steps move weakly held expression
    directions by ~2e-3). The fit runs under ``torch.cuda``'s sync debug
    mode "error", so no step waits for the device. Then a 100-frame
    sequence (the smoothness terms on). Times, steps and launches a step
    for T = 1 and T = 100."""
    from real3dportrait_tpu_torch.geometry.bfm import synthetic_bfm
    from real3dportrait_tpu_torch.geometry.fit_3dmm import fit_coeffs

    cpu_assets = synthetic_bfm(n_vertices=n_vertices)
    assets = cpu_assets.to(dev)
    steps = 400
    for n_frames in (1, 100):
        lm = seeded_landmarks(cpu_assets, n_frames, seed=n_frames)
        lm_dev = torch.from_numpy(lm).to(dev)
        fit_coeffs(assets, lm_dev, device=dev)  # warm-up: cuBLAS, the allocator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fit = fit_coeffs(assets, lm_dev, device=dev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        err = reprojection_err(assets, fit, lm_dev)
        check(all(bool(torch.isfinite(getattr(fit, k)).all()) for k in fit._fields),
              f"fit T={n_frames}: non-finite coefficients")
        line = (f"fit[T={n_frames}, {n_vertices:,}-vertex synthetic model]: {ms:.1f} ms for "
                f"{steps} Adam steps ({ms / steps:.3f} ms a step), loss {float(fit.loss):.3e}, "
                f"reprojection {err:.2e}; "
                f"{fit_launches(assets, lm_dev, dev, out_dir, ms / steps)}")
        if n_frames == 1:
            check(err < 0.01, f"fit: the source landmarks reproject at {err:.3e} (limit 0.01)")
            cpu = fit_coeffs(cpu_assets, lm, device="cpu")
            errs = {k: (getattr(fit, k).cpu() - getattr(cpu, k)).abs() for k in fit._fields[:4]}
            worst = max(float(e.max()) for e in errs.values())
            mean = max(float(e.mean()) for e in errs.values())
            check(worst <= 5e-3 and mean <= 5e-4,
                  f"fit: GPU and CPU coefficients differ by {worst:.3e} max, {mean:.3e} mean")
            line += f"; GPU vs CPU coefficients max {worst:.2e}, mean {mean:.2e} (5e-3 / 5e-4)"
        print(line)


def http_request(port: int, method: str, path: str, fields: dict | None = None):
    """(status, headers, body) of one request to the local server; a
    (filename, bytes) field is a file part of a multipart form."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        headers, body = {}, None
        if fields is not None:
            boundary = "----r3dp-chip-smoke"
            parts = []
            for name, value in fields.items():
                disp = f'form-data; name="{name}"'
                if isinstance(value, tuple):
                    disp, value = disp + f'; filename="{value[0]}"', value[1]
                else:
                    value = value.encode()
                parts.append(f"--{boundary}\r\nContent-Disposition: {disp}\r\n\r\n".encode()
                             + value + b"\r\n")
            body = b"".join(parts) + f"--{boundary}--\r\n".encode()
            headers = {"Content-Type": f"multipart/form-data; boundary={boundary}"}
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def phase_video(dev: torch.device, out_dir: str, n_vertices: int = 35709,
                **overrides) -> dict:
    """The video-driven ``run`` on the default model at 512^2: 100 seeded
    driving frames in memory -> ``naive_landmark_extractor`` ->
    ``motion_from_video_landmarks`` (the fit on the card, smoothing on) ->
    ``run(src, drv_motion=..., pose_seq=(euler, trans), src_lm2d=...,
    out_path=...)`` with the launch counters from 0: 100 finite frames on
    the GPU through every default-path kernel, K1 not launched. Then the
    same call with stage timings, and, where cv2 imports, the frames as an
    .mp4 driving the CLI as ``--drv_aud`` and ``--drv_pose``."""
    from real3dportrait_tpu_torch.inference import cli
    from real3dportrait_tpu_torch.inference.infer_utils import motion_from_video_landmarks
    from real3dportrait_tpu_torch.preprocess.pipeline import naive_landmark_extractor

    pipe = make_pipeline(DEFAULT_CONFIG, "fast", dev, n_vertices=n_vertices, **overrides)
    res = pipe.res
    drv = face_video(100, res, seed=3)
    t0 = time.perf_counter()
    lm_seq = naive_landmark_extractor(drv)
    extract_ms = (time.perf_counter() - t0) * 1e3
    motion_from_video_landmarks(pipe.secc_renderer.assets, lm_seq[:8], device=dev)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    motion = motion_from_video_landmarks(pipe.secc_renderer.assets, lm_seq, device=dev)
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t0) * 1e3
    check(tuple(motion["exp"].shape) == (100, 64) and motion["exp"].is_cuda,
          f"video motion exp {tuple(motion['exp'].shape)}")
    spread = float(motion["trans"].std(0).max())
    check(spread > 1e-4, f"the drifting face must move the fitted pose ({spread:.2e})")
    src = np.random.RandomState(0).randint(0, 256, (res, res, 3)).astype(np.uint8)
    src_lm = seeded_landmarks(pipe.assets, 1, seed=1)[0]
    pose = (motion["euler"], motion["trans"])
    path = os.path.join(out_dir, "video.mp4")
    warm = {k: v[:8] for k, v in motion.items()}
    pipe.run(src, drv_motion=warm, pose_seq=(warm["euler"], warm["trans"]), src_lm2d=src_lm,
             out_path=os.path.join(out_dir, "warm.mp4"))
    torch.cuda.synchronize()
    every = set(read_launches())
    expect = every - {"triplane_decode"}
    reset_launches()
    t0 = time.perf_counter()
    frames = pipe.run(src, drv_motion=motion, pose_seq=pose, src_lm2d=src_lm, out_path=path)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    check(tuple(frames.shape) == (100, res, res, 3), f"video run frames {tuple(frames.shape)}")
    check(frames.is_cuda and bool(torch.isfinite(frames).all()),
          "video run frames must be finite and on the GPU")
    check(all(counts[k] > 0 for k in expect), f"video run: a kernel was not launched: {counts}")
    check(counts["triplane_decode"] == 0, f"video run: a kernel of another path ran: {counts}")
    check(os.path.getsize(path) > 0 if os.path.exists(path) else
          os.path.getsize(path + ".raw") > 0, "video run wrote no video")
    print(f"video[default, 100 driving frames of {res}^2, source landmarks]: frames "
          f"{tuple(frames.shape)}, wall {wall:.2f} s ({1e3 * wall / len(frames):.2f} ms/frame, "
          f"the source fit, source preparation, caches and video writing included); "
          f"landmark extractor {extract_ms:.1f} ms (host), driving fit {fit_ms:.1f} ms "
          f"(T=100, 400 steps, smoothing included), launches {counts}")
    del frames
    tm: dict = {}
    frames = pipe.run(src, drv_motion=motion, pose_seq=pose, src_lm2d=src_lm, timings=tm)
    torch.cuda.synchronize()
    p50 = statistics.median(tm["frame_ms"])
    stages = ", ".join(f"{k[:-3]} {tm[k]:.2f} ms" for k in (
        "fit_ms", "prep_ms", "cano_ms", "appearance_ms", "bg_ms"))
    print(f"video stages (synchronised): {stages}; frame p50 {p50:.2f} ms "
          f"({1e3 / p50:.2f} fps)")
    del frames, pipe
    torch.cuda.empty_cache()

    try:
        import cv2
    except ImportError:
        print("video[cli]: cv2 does not import here, so no .mp4 was written and the CLI's "
              ".mp4 drivers were not run; the in-memory drive above was")
        return counts
    mp4 = os.path.join(out_dir, "drv.mp4")
    vw = cv2.VideoWriter(mp4, cv2.VideoWriter_fourcc(*"mp4v"), 25, (res, res))
    check(vw.isOpened(), "cv2 imports but its mp4v writer does not open")
    for f in drv:
        vw.write(np.ascontiguousarray(f[..., ::-1]))
    vw.release()
    src_path, out = os.path.join(out_dir, "src.npy"), os.path.join(out_dir, "cli.mp4")
    np.save(src_path, src)
    t0 = time.perf_counter()
    cli.main(["--src_img", src_path, "--drv_aud", mp4, "--drv_pose", mp4, "--out_name", out,
              "--seed", "0", "--device", str(dev)]
             + (["--hparams", ",".join(f"{k}={v}" for k, v in overrides.items())]
                if overrides else []))
    torch.cuda.synchronize()
    check(os.path.exists(out) and os.path.getsize(out) > 0, "the CLI wrote no video")
    print(f"video[cli]: the CLI (default model, cuda) drove by {mp4!r} as --drv_aud and "
          f"--drv_pose wrote {os.path.getsize(out)} B in {time.perf_counter() - t0:.2f} s "
          f"(pipeline build, two fits and 100 frames)")
    torch.cuda.empty_cache()
    return counts


def phase_server(dev: torch.device, n_vertices: int = 35709, **overrides) -> None:
    """``inference/server.py`` on the default model (full width, ``fast``,
    the 35,709-vertex synthetic mesh) on the card: ``ThreadingHTTPServer``
    on a free local port in a thread; three ``POST /synthesize`` requests
    (a 512^2 png, a 1 s seeded wav, temperature 0) must answer 200 with a
    body, the second and third bodies equal; ``/health`` reports the model
    loaded after the first."""
    import io
    import threading
    import wave
    from http.server import ThreadingHTTPServer

    from PIL import Image

    from real3dportrait_tpu_torch.config import load_config
    from real3dportrait_tpu_torch.geometry.bfm import synthetic_bfm
    from real3dportrait_tpu_torch.inference import server

    server._State.pipeline = None
    server._State.build_kwargs = dict(
        cfg=load_config(os.path.join(ROOT, "configs", DEFAULT_CONFIG),
                        dict(sampling_preset="fast", **overrides)),
        assets=synthetic_bfm(n_vertices=n_vertices), seed=0, device=dev)
    img = np.random.RandomState(6).randint(0, 256, (512, 512, 3)).astype(np.uint8)
    png = io.BytesIO()
    Image.fromarray(img).save(png, format="PNG")
    wav = io.BytesIO()
    with wave.open(wav, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((seeded_wav(1.0, seed=7) * 32767).astype("<i2").tobytes())
    fields = {"src_img": ("src.png", png.getvalue()), "drv_aud": ("drv.wav", wav.getvalue()),
              "temperature": "0"}
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.Handler)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        health = json.loads(http_request(port, "GET", "/health")[2])
        check(health == {"status": "ok", "model_loaded": False}, f"/health {health}")
        bodies, walls = [], []
        for i in range(3):
            t0 = time.perf_counter()
            code, headers, body = http_request(port, "POST", "/synthesize", fields)
            walls.append((time.perf_counter() - t0) * 1e3)
            check(code == 200 and len(body) > 0,
                  f"server request {i}: {code}, {body[:300]!r}")
            bodies.append(body)
            if i == 0:
                health = json.loads(http_request(port, "GET", "/health")[2])
                check(health["model_loaded"] is True, f"/health after a request: {health}")
        check(bodies[1] == bodies[2], "server: two requests with the same inputs at "
                                      "temperature 0 gave different bodies")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
        server._State.pipeline = None
    check(not thread.is_alive(), "the server thread did not stop")
    print(f"server[default, 512^2 png, 1 s wav, temperature 0]: 3 requests answered 200 with "
          f"{headers['Content-Type']} bodies of {[len(b) for b in bodies]} B, request wall ms "
          f"{[round(w, 1) for w in walls]} (the first builds the pipeline), the first body "
          f"{'equal to' if bodies[0] == bodies[1] else 'unlike'} the others")
    torch.cuda.empty_cache()


def phase_checkpoint(dev: torch.device, out_dir: str, n_vertices: int = 35709,
                     **overrides) -> None:
    """The default model from checkpoints that the port reads: the seeded
    pipeline's audio-to-motion and synthesis weights are written in the JAX
    package's msgpack format, in the payload of
    ``tools/convert_torch_ckpt.py`` (``params/model``; ``params/gen`` with
    the noise buffers under ``variables``); a pipeline drawn from another
    seed loads them with ``mock_weights=False``. Its weights must be the
    written ones and its ``run`` frames (1 s of wav, temperature 0, so that
    the prior noise, drawn from the seed, drops out) bit-equal to those of
    the pipeline that wrote them."""
    from real3dportrait_tpu_torch.config import load_config
    from real3dportrait_tpu_torch.geometry.bfm import synthetic_bfm
    from real3dportrait_tpu_torch.inference.pipeline import Real3DPortraitPipeline
    from real3dportrait_tpu_torch.utils import msgpack_ckpt
    from real3dportrait_tpu_torch.weights import jax_variables_from_torch

    written = make_pipeline(DEFAULT_CONFIG, "fast", dev, n_vertices=n_vertices, **overrides)
    t0 = time.perf_counter()
    gen = jax_variables_from_torch(written.model)
    a2m_dir, s2v_dir = os.path.join(out_dir, "audio2secc"), os.path.join(out_dir, "secc2video")
    msgpack_ckpt.save_checkpoint(a2m_dir, 0, {
        "step": 0, "params": {"model": jax_variables_from_torch(written.a2m)["params"]},
        "variables": {}})
    path = msgpack_ckpt.save_checkpoint(s2v_dir, 0, {
        "step": 0, "params": {"gen": gen["params"]},
        "variables": {k: v for k, v in gen.items() if k != "params"}})
    t1 = time.perf_counter()
    cfg = load_config(os.path.join(ROOT, "configs", DEFAULT_CONFIG),
                      dict(sampling_preset="fast", **overrides))
    loaded = Real3DPortraitPipeline(cfg, mock_weights=False, a2m_ckpt_dir=a2m_dir,
                                    secc2video_ckpt_dir=s2v_dir,
                                    assets=synthetic_bfm(n_vertices=n_vertices), seed=1,
                                    device=dev)
    t2 = time.perf_counter()
    for name, a, b in (("model", written.model, loaded.model), ("a2m", written.a2m, loaded.a2m)):
        want, got = a.state_dict(), b.state_dict()
        check(list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want),
              f"checkpoint: the loaded {name} weights are not the written ones")
    res = written.res
    src = np.random.RandomState(0).randint(0, 256, (res, res, 3)).astype(np.uint8)
    wav = seeded_wav(1.0, seed=5)
    want = written.run(src, wav=wav, temperature=0.0)
    got = loaded.run(src, wav=wav, temperature=0.0)
    torch.cuda.synchronize()
    check(got.shape == want.shape and tuple(got.shape[1:]) == (res, res, 3) and len(got) > 0
          and bool(torch.isfinite(got).all()), f"checkpoint run frames {tuple(got.shape)}")
    err = max_err(got, want)
    check(err == 0.0, f"checkpoint run frames differ from the written weights' ({err:.3e})")
    print(f"checkpoint[default model, msgpack]: secc2video "
          f"{os.path.getsize(path) / 2**20:.1f} MiB and a2m written in {t1 - t0:.2f} s, pipeline with mock_weights=False "
          f"built and loaded in {t2 - t1:.2f} s; weights equal, run frames "
          f"{tuple(got.shape)} bit-equal to the writer's")
    del written, loaded, got, want
    torch.cuda.empty_cache()


def ref_layout():
    """``tests/_torch_ref_layout.py`` (numpy, torch and the port only), by
    its path, so that no other ``tests`` package on the host shadows it."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_torch_ref_layout", os.path.join(ROOT, "tests", "_torch_ref_layout.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclass looks itself up there
    spec.loader.exec_module(mod)
    return mod


CONVERT_STEPS = {"audio2secc": 160000, "secc2video": 250000}


def phase_convert(dev: torch.device, out_dir: str, n_vertices: int = 35709,
                  **overrides) -> dict:
    """The released lineage from checkpoints in the released torch layout:
    the seeded pipeline of ``configs/real3d_orig.yaml`` (tri-planes through
    K1, the composite backbone, folded BatchNorms, the torso) at the
    ``reference`` quadrature (48+48) is written as reference
    ``model_ckpt_steps_<N>.ckpt`` files (``tests/_torch_ref_layout.py``:
    the renames and layouts inverted, the norms unfolded with seeded
    statistics); the port's converter turns them into msgpack checkpoints in
    a subprocess, as a user runs it; a pipeline drawn from another seed
    loads them with ``mock_weights=False``. Its weights must be the
    writer's, bit-equal where the converter copies or transposes a leaf and
    within the fold's bound (the stored operands' own error plus the fp32
    forward-error bound, per element) where it folds a BatchNorm, a weight
    norm or a spectral norm; its ``run`` frames (1 s of wav, temperature 0)
    within ``compare``'s fp32 tolerance of the writer's (the folded leaves
    differ at their last bits, as a reordered fp32 sum does), with every
    kernel of the released path launched in that run. Returns its launch
    counts."""
    from real3dportrait_tpu_torch.config import load_config
    from real3dportrait_tpu_torch.geometry.bfm import synthetic_bfm
    from real3dportrait_tpu_torch.inference.pipeline import Real3DPortraitPipeline

    layout = ref_layout()
    written = make_pipeline(RELEASED_CONFIG, "reference", dev, n_vertices=n_vertices,
                            **overrides)
    t0 = time.perf_counter()
    refs = {"audio2secc": layout.audio2secc(written.a2m, seed=1),
            "secc2video": layout.secc2video(written.model, seed=2)}
    torch_dirs = {}
    for name, ref in refs.items():
        torch_dirs[name] = os.path.join(out_dir, "torch", name)
        os.makedirs(torch_dirs[name])
        ref.save(os.path.join(torch_dirs[name], f"model_ckpt_steps_{CONVERT_STEPS[name]}.ckpt"),
                 CONVERT_STEPS[name])
    t1 = time.perf_counter()
    conv_dir = os.path.join(out_dir, "converted")
    proc = subprocess.run(
        [sys.executable, "-m", "real3dportrait_tpu_torch.tools.convert_torch_ckpt",
         "--audio2secc", torch_dirs["audio2secc"], "--secc2video", torch_dirs["secc2video"],
         "--out", conv_dir], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=600)
    t2 = time.perf_counter()
    check(proc.returncode == 0, f"convert_torch_ckpt failed:\n{proc.stderr[-3000:]}")
    print("\n".join(f"convert[cli] {line}" for line in proc.stdout.splitlines()))
    dirs = {name: os.path.join(conv_dir, name) for name in refs}
    paths = {name: os.path.join(d, f"model_ckpt_steps_{CONVERT_STEPS[name]}.ckpt")
             for name, d in dirs.items()}
    check(all(os.path.exists(p) for p in paths.values()), f"converted files {paths}")
    mib = sum(os.path.getsize(p) for p in paths.values()) / 2**20
    cfg = load_config(os.path.join(ROOT, "configs", RELEASED_CONFIG),
                      dict(sampling_preset="reference", **overrides))
    loaded = Real3DPortraitPipeline(cfg, mock_weights=False, a2m_ckpt_dir=dirs["audio2secc"],
                                    secc2video_ckpt_dir=dirs["secc2video"],
                                    assets=synthetic_bfm(n_vertices=n_vertices), seed=1,
                                    device=dev)
    t3 = time.perf_counter()
    held = {name: layout.check_converted(module, refs[name], got.state_dict())
            for name, module, got in (("audio2secc", written.a2m, loaded.a2m),
                                      ("secc2video", written.model, loaded.model))}
    print("convert[weights]: " + "; ".join(
        f"{name} {h['equal']} leaves bit-equal, {h['folded']} folded within their bounds "
        f"(largest error {h['worst']:.3f} of its bound)" for name, h in held.items()))
    res = written.res
    src = np.random.RandomState(0).randint(0, 256, (res, res, 3)).astype(np.uint8)
    wav = seeded_wav(1.0, seed=5)
    want = written.run(src, wav=wav, temperature=0.0)
    torch.cuda.synchronize()
    reset_launches()
    t4 = time.perf_counter()
    got = loaded.run(src, wav=wav, temperature=0.0)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t4
    counts = read_launches()
    check(got.shape == want.shape and tuple(got.shape[1:]) == (res, res, 3) and len(got) > 0
          and got.is_cuda and bool(torch.isfinite(got).all()),
          f"convert run frames {tuple(got.shape)}")
    text = compare("convert run frames", got, want, (1e-3, 1e-4))
    expect = set(REPLACES) - {"trigrid_decode"}
    check(all(counts[k] > 0 for k in expect) and counts["trigrid_decode"] == 0,
          f"convert: a kernel of the released path was not launched: {counts}")
    print(f"convert[released lineage, {res}^2, 48+48]: torch checkpoints written in "
          f"{t1 - t0:.2f} s, converted by the command line in {t2 - t1:.2f} s ({mib:.1f} MiB "
          f"written), pipeline with mock_weights=False built and loaded in {t3 - t2:.2f} s; "
          f"run frames {tuple(got.shape)} in {run_s:.2f} s "
          f"({1e3 * run_s / len(got):.2f} ms/frame), against the writer's {text}, "
          f"bit-equal {bool(torch.equal(got, want))}; launches {counts}")
    convert_no_fallback(layout, loaded, paths)
    del written, loaded, got, want
    torch.cuda.empty_cache()
    return counts


def convert_no_fallback(layout, pipe, paths: dict) -> None:
    """The converted trees with a leaf missing (secc2video) or misshaped
    (audio2secc) must not load: the strict loader raises, naming it."""
    from real3dportrait_tpu_torch.utils import msgpack_ckpt
    from real3dportrait_tpu_torch.weights import load_jax_variables

    for name, module, root in (("secc2video", pipe.model, "gen"), ("audio2secc", pipe.a2m,
                                                                    "model")):
        tree = msgpack_ckpt.load_checkpoint(paths[name])["params"][root]
        path, node = (), tree
        while isinstance(node, dict):
            key = sorted(node)[0]
            path, parent, node = path + (key,), node, node[key]
        key = layout.port_key("params", path)
        if name == "secc2video":
            del parent[path[-1]]
            want = f"Missing key(s) in state_dict: \"{key}\""
        else:
            parent[path[-1]] = np.zeros(np.shape(node) + (1,), np.float32)
            want = f"size mismatch for {key}"
        try:
            load_jax_variables(module, {"params": tree})
        except RuntimeError as err:
            check(want in str(err), f"convert: the {name} error does not name {key}: {err}")
            print(f"convert[no fallback]: {name} with {key} "
                  f"{'missing' if name == 'secc2video' else 'misshaped'} raises, naming it")
            continue
        check(False, f"convert: the {name} tree without {key} loaded")


def phase_flagship(dev: torch.device, steps: int = 16) -> None:
    """The flagship frame step at 512^2 (``fast``) with random keypoints:
    p50 of the CUDA-event time of ``steps`` steps after 3 warm-up steps."""
    from real3dportrait_tpu_torch.flagship import flagship

    t0 = time.perf_counter()
    frame_step, args = flagship(device=dev)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    for _ in range(3):
        frame_step(*args)
    torch.cuda.synchronize()
    reset_launches()
    times = []
    for _ in range(steps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        image = frame_step(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    counts = read_launches()
    check(tuple(image.shape) == (1, 512, 512, 3) and bool(torch.isfinite(image).all()),
          f"flagship image {tuple(image.shape)} not finite or of the wrong shape")
    # the step takes a SECC map as input: every tri-plane, fp32 kernel but
    # the raster
    other = {"secc_raster", "trigrid_decode", "upfirdn2d bf16", "bias_act bf16"}
    check(all(v > 0 for k, v in counts.items() if k not in other),
          f"flagship: a kernel was not launched: {counts}")
    p50 = statistics.median(times)
    print(f"flagship[fast, random keypoints]: p50 {p50:.2f} ms/step ({1e3 / p50:.2f} fps) over "
          f"{steps} steps, step ms {[round(x, 2) for x in times]}, set-up {setup:.2f} s, "
          f"launches per step {({k: v // steps for k, v in counts.items()})}")


def compare(tag: str, got: torch.Tensor, want: torch.Tensor,
            tol: tuple = (1e-3, 1e-4)) -> str:
    """Scale-normalised check of ``got`` against ``want`` (on any devices),
    max and mean: fp32 through ~100 layers of random weights, convs and sums
    in another order, 1e-3 / 1e-4; through bf16 SR blocks (cuDNN's bf16
    convolutions round their fp32 sums once, at other points than the CPU's
    or another batch's), ``BF16_TOL``. Returns the errors as text."""
    check(tuple(got.shape) == tuple(want.shape),
          f"{tag}: shape {tuple(got.shape)} against {tuple(want.shape)}")
    got = got.to(want.device)
    scale = max(float(want.abs().max()), 1e-6)
    err, merr = max_err(got, want) / scale, mean_err(got, want) / scale
    text = f"max_err/scale {err:.3e} mean {merr:.3e} (tol {tol[0]:g} / {tol[1]:g})"
    check(err <= tol[0] and merr <= tol[1], f"{tag} disagrees: {text}")
    return text

def phase_reference(dev: torch.device) -> None:
    """Small configurations on the GPU (kernels) and on the CPU (plain
    versions) from the same seed must agree: the frames of the default
    model's torso pipeline and of the released geometry's torso
    (``torso_model_scale=tiny``) and head-only pipelines, and, since random
    SR weights saturate many frame pixels at +-1, the unclamped raw render,
    depth and weight images of one frame step; for the torso models that
    step has random keypoints, and its warped torso image and occlusion are
    compared too. Then the audio path: the full-width audio-to-motion
    model, a small HuBERT and the tiny-config ``run``. The default model's
    frames and SR image pass through two bf16 blocks (3e-2 / 3e-3);
    everything before its SR head is fp32."""
    from real3dportrait_tpu_torch.geometry import camera

    small = dict(final_resolution=64, neural_rendering_resolution=16, secc_resolution=48,
                 sr_channel0=16, sr_channel1=16, torso_model_scale="tiny")
    src, exp, bg = slice_inputs(64, 2)
    rng = np.random.RandomState(1)
    secc = torch.from_numpy(rng.uniform(-1, 1, (1, 64, 64, 9)).astype(np.float32))
    img = torch.from_numpy(src[None].astype(np.float32) / 127.5 - 1.0)
    kps = [torch.from_numpy(rng.uniform(-0.8, 0.8, (1, 68, 3)).astype(np.float32))
           for _ in range(2)]
    euler = torch.tensor([[0.05, 0.2, 0.0]])
    _, c2w, intr = camera.convert_eg3d_convention(euler, torch.zeros((1, 3)))
    cam = camera.pack_camera(c2w, intr[0])
    for label, config, use_torso in (("default torso", DEFAULT_CONFIG, True),
                                     ("released torso", RELEASED_CONFIG, True),
                                     ("released head-only", RELEASED_CONFIG, False)):
        outs = []
        for d in (dev, torch.device("cpu")):
            pipe = make_pipeline(config, "fast", d, use_torso=use_torso, n_vertices=2000,
                                 **small)
            frames = pipe.synthesize(src, exp, pipe.fit_source(None), bg_img=bg,
                                     blink_mode="none", prepare_source_images=False)
            with torch.no_grad():
                m = pipe.model
                cano = m.cal_cano_plane(img.to(d))
                if use_torso:
                    cond = pipe.mock_cond(img.to(d))
                    cond.update(kp_src=kps[0].to(d), kp_drv=kps[1].to(d))
                    cond.update(torso_appearance=m.cal_torso_appearance(cond),
                                bg_feat=m.cal_bg_feat(cond))
                    step = m.synthesis(None, cam.to(d), cond, secc=secc.to(d),
                                       cano_planes=cano)
                    step.update({k: step["torso_ret"][k]
                                 for k in ("deformed_torso_img", "occlusion_2")})
                else:
                    step = m.synthesis(None, cam.to(d), secc=secc.to(d), cano_planes=cano)
            keys = ["image_raw", "image_depth", "weights_img"]
            if use_torso:
                keys += ["image", "deformed_torso_img", "occlusion_2"]
            outs.append({"frames": frames, **{k: step[k] for k in keys}})
        bf16 = config == DEFAULT_CONFIG
        for k, gpu in outs[0].items():
            tol = BF16_TOL if bf16 and k in ("frames", "image") else (1e-3, 1e-4)
            print(f"reference[{label} {k}]: GPU vs CPU "
                  f"{compare(f'GPU {label} {k}', gpu, outs[1][k], tol)}")

    # the audio path: the full-width audio-to-motion model on 1 s of the
    # mel tiled to 1024 channels, with the same prior noise (drawn on the
    # CPU); a 2-layer 256-wide HuBERT; the tiny-config run from 0.32 s of
    # wav (its frames through the default model's bf16 SR blocks)
    from real3dportrait_tpu_torch.audio.hubert import HubertEncoder, make_hubert_extractor
    from real3dportrait_tpu_torch.weights import mock_init_

    wav = seeded_wav(1.0, seed=3)
    outs = []
    for d in (dev, torch.device("cpu")):
        pipe = make_pipeline(DEFAULT_CONFIG, "fast", d, n_vertices=2000, **small)
        feats, f0 = pipe.audio_to_features(wav)
        exp = pipe.audio_to_motion(feats, f0, temperature=0.5,
                                   generator=torch.Generator().manual_seed(4))
        hub = mock_init_(HubertEncoder(hidden=256, layers=2, heads=4, ffn=512),
                         torch.Generator().manual_seed(5)).to(d).eval()
        hid = torch.from_numpy(make_hubert_extractor(hub)(wav))
        frames = pipe.run(src, wav=wav[:5120])
        outs.append({"audio-to-motion (full width)": exp, "HuBERT 2x256": hid,
                     "run frames": frames})
    for k, gpu in outs[0].items():
        text = compare(f"GPU default {k}", gpu, outs[1][k],
                       BF16_TOL if k == "run frames" else (1e-3, 1e-4))
        print(f"reference[default {k}]: GPU vs CPU {text}")


# -- the training slice -----------------------------------------------------------

# the flagship's four backward kernels: the forward each differentiates (its
# JAX place is the one the TPU kernel of the forward replaced: jax.grad
# differentiated it there) and its source
TRAIN_KERNELS = {
    "trigrid_decode_backward": "trigrid_decode",
    "merge_composite_backward": "merge_composite",
    "upfirdn2d_backward": "upfirdn2d",
    "bias_act_grad": "bias_act",
}
# the torso stage's backward kernels (K7a's data gradient is K7a itself) and
# the released lineage's tri-plane one
TORSO_KERNELS = {
    "conv3d_weight_grad": "conv3d",
    "torso_deform_input_backward": "torso_deform_input",
    "torso_warp_volume_backward": "torso_warp_volume",
    "mfe_tail_backward": "mfe_tail",
}
TRIPLANE_KERNELS = {"triplane_decode_backward": "triplane_decode"}
TRAIN_CONFIG = "secc_img2plane.yaml"
TORSO_CONFIG = "secc_img2plane_torso.yaml"
TRIPLANE_CONFIG = "real3d_orig/secc_img2plane_orig.yaml"
HEAD_GROUPS = ("img2plane_backbone", "secc_img2plane_backbone", "decoder")
RUN_HPARAMS = ",tb_log_interval=4,num_sanity_val_steps=0,val_check_interval=100000"
# the full-width run: a full step from the first (the config's batch of 4,
# every part of the step on, every generator group training from step 1),
# 4 steps, the conditioning regulariser at step 3
TRAIN_HPARAMS = FULL_STEP_HPARAMS + ",max_updates=4" + RUN_HPARAMS
TRAIN_STEPS = 4
# the torso stage: the config's batch of 4 and its own gates (the SR head and
# the discriminator train), the adversarial term on; it starts from the
# flagship run's checkpoint (init_from_ckpt, step 4) and takes 4 steps
TORSO_STEPS = 4
TORSO_HPARAMS = f"batch_size=4,start_adv_iters=0,max_updates={TRAIN_STEPS + TORSO_STEPS}" + \
    RUN_HPARAMS
# the released lineage's SECC stage on tri-planes, at its batch of 1: 2 steps
TRIPLANE_STEPS = 2
TRIPLANE_HPARAMS = FULL_STEP_HPARAMS.replace("batch_size=4", "batch_size=1") + \
    f",max_updates={TRIPLANE_STEPS}" + RUN_HPARAMS
# the released lineage's torso stage on tri-planes, from the tri-plane run's
# checkpoint at its batch of 1, the adversarial term on: 2 steps
TORSO_ORIG_CONFIG = "real3d_orig/secc_img2plane_torso_orig.yaml"
TORSO_ORIG_STEPS = 2
TORSO_ORIG_HPARAMS = "batch_size=1,start_adv_iters=0," \
    f"max_updates={TRIPLANE_STEPS + TORSO_ORIG_STEPS}" + RUN_HPARAMS


def train_wrappers() -> dict:
    """The backward kernels' wrappers by name (their launch counts)."""
    from real3dportrait_tpu_torch.models.decoder import (
        trigrid_decode_backward, triplane_decode_backward)
    from real3dportrait_tpu_torch.models.torso import (
        mfe_tail_backward, torso_deform_input_backward, torso_warp_volume_backward)
    from real3dportrait_tpu_torch.ops.bias_act import bias_act_grad
    from real3dportrait_tpu_torch.ops.conv3d import conv3d_weight_grad
    from real3dportrait_tpu_torch.ops.upfirdn2d import upfirdn2d_backward
    from real3dportrait_tpu_torch.rendering.renderer import merge_composite_backward

    return {"trigrid_decode_backward": trigrid_decode_backward,
            "merge_composite_backward": merge_composite_backward,
            "upfirdn2d_backward": upfirdn2d_backward, "bias_act_grad": bias_act_grad,
            "triplane_decode_backward": triplane_decode_backward,
            "conv3d_weight_grad": conv3d_weight_grad,
            "torso_deform_input_backward": torso_deform_input_backward,
            "torso_warp_volume_backward": torso_warp_volume_backward,
            "mfe_tail_backward": mfe_tail_backward}


class CallLog:
    """Records what the training path hands the kernels' autograd Functions
    (shapes, dtypes, the other arguments; filters as CPU copies) while
    patched in, so that the kernels can be held at exactly those calls."""

    def __init__(self):
        from real3dportrait_tpu_torch.models import decoder as dm
        from real3dportrait_tpu_torch.models import torso as tm
        from real3dportrait_tpu_torch.ops import bias_act as ba
        from real3dportrait_tpu_torch.ops import conv3d as c3d
        from real3dportrait_tpu_torch.ops import upfirdn2d as ufd
        from real3dportrait_tpu_torch.rendering import renderer as rr

        self.targets = {"trigrid": dm._TrigridDecode, "merge": rr._MergeComposite,
                        "upfirdn2d": ufd._Upfirdn2d, "bias_act": ba._BiasAct,
                        "bias_act_grad": ba._BiasActGrad, "triplane": dm._TriplaneDecode,
                        "conv3d": c3d._Conv3D, "deform": tm._TorsoDeformInput,
                        "warp": tm._TorsoWarpVolume, "mfe_tail": tm._MfeTail}
        self.calls: dict = {k: [] for k in self.targets}
        self.saved: dict = {}

    @staticmethod
    def _meta(a):
        if isinstance(a, torch.Tensor):
            if a.numel() <= 64 and a.dim() <= 2:
                return ("small", a.detach().cpu().clone())
            return ("T", tuple(a.shape), a.dtype)
        if callable(a):
            return ("fn", a.__name__)
        return a

    def __enter__(self):
        for key, cls in self.targets.items():
            self.saved[key] = cls.__dict__.get("apply")
            orig = cls.apply

            def rec(*args, _orig=orig, _key=key):
                self.calls[_key].append(tuple(self._meta(a) for a in args))
                return _orig(*args)
            cls.apply = rec
        return self

    def __exit__(self, *exc):
        for key, cls in self.targets.items():
            if self.saved[key] is None:
                del cls.apply       # the inherited classmethod again
            else:
                cls.apply = self.saved[key]


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return max_err(got, want) / max(float(want.float().abs().max()), 1e-30)


def phase_train_kernels(dev: torch.device, log: CallLog) -> dict:
    """(a) Each backward kernel against its plain version, one launch each,
    at the training step's own calls (``log``, recorded from the full-width
    run's first step): K1-
    trigrid on one frame's 1.57 M points (coarse + fine) of the step's
    grids and at the step's own calls (their batches and point counts), K3
    at the step's [4,16384,48+48], K6a and K6b at every distinct
    call, fp32 and bf16, and K6a's and K6b's second derivatives through
    ``torch.autograd.grad(create_graph=True)`` on a discriminator shape of
    each type. Tolerances: fp32 sums that the kernels take with atomics in
    a run-dependent order, 1e-4 of the largest magnitude (K6b's sums of
    random-sign terms, 1e-5 of the sum of the terms' magnitudes;
    elementwise results, 1e-6 absolute); bf16 outputs within 2 bf16 ulps
    of the plain version's, sums as fp32. Each row: the per-call and per-launch time,
    the plain version's, the bound (bytes over 3.35 TB/s, operations over
    the type's peak) and, where one PyTorch call computes the same
    function, its time."""
    import torch.nn.functional as F

    from real3dportrait_tpu_torch.models import decoder as dm
    from real3dportrait_tpu_torch.ops import bias_act as ba
    from real3dportrait_tpu_torch.ops import upfirdn2d as ufd
    from real3dportrait_tpu_torch.rendering import renderer as rr

    gen = torch.Generator(device=dev).manual_seed(7)
    f32, bf16 = torch.float32, torch.bfloat16
    rows: dict = {}

    def randn(shape, dtype=f32):
        return torch.randn(shape, device=dev, generator=gen).to(dtype)

    def rand(shape):
        return torch.rand(shape, device=dev, generator=gen)

    def row(name, tag, err, ms, plain_ms, cost, library=None, launch_ms=None, extra=""):
        bound_ms, bound_by = bound(*cost)
        lib = "null" if library is None else f"{library:.4f} ms"
        print(f"train {name}[{tag}]: {err} per launch {launch_ms:.4f} ms, per call "
              f"{ms:.4f} ms plain {plain_ms:.4f} ms library {lib} bound {bound_ms:.4f} ms "
              f"({bound_by}){extra}")
        rows.setdefault(name, dict(shape=tag, dtype=str(cost[2]).removeprefix("torch."),
                                   max_abs_err=float(err.split()[1]), ms=ms,
                                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                   library_ms=library, launch_ms=launch_ms))

    # the step's calls
    grid = next(a for a in log.calls["trigrid"][0] if isinstance(a, tuple) and a[0] == "T")[1]
    merge = log.calls["merge"][0]
    k3 = (merge[1][1], merge[4][1])                     # colours1, colours2 shapes
    k6a = {}
    for c in log.calls["upfirdn2d"]:
        if c[6] == ("fn", "upfirdn2d"):                 # forwards; each has one adjoint
            key = (c[0][1], c[0][2], c[2], c[3], tuple(c[4]) if isinstance(c[4], (list, tuple))
                   else c[4], c[5])
            k6a.setdefault(key, c[1])
    k6b = {}
    for c in log.calls["bias_act_grad"]:
        key = (c[0][1], c[0][2], c[4], c[5], c[6], c[7], c[3] is not None, c[8], c[9], c[10])
        k6b.setdefault(key, None)

    # K1-trigrid backward: one frame of the step's grids, the frame's coarse
    # and fine points (uniform in the box), rgb and sigma gradients
    planes = randn((1,) + tuple(grid[1:]))
    n = 2 * 128 * 128 * 48
    coords = rand((1, n, 3)) - 0.5
    dec = dm.OSGDecoder(32, 64, 32).to(dev)
    with torch.no_grad():
        for p in dec.parameters():
            p.copy_(randn(p.shape) * 0.3)
    w0, b0 = dec.net0.folded()
    w1, b1 = dec.net1.folded()
    ws = [t.detach() for t in (w0, b0, w1, b1)]
    drgb, dsig = randn((1, n, 32)), randn((1, n, 1))
    with torch.no_grad():
        got = dm.trigrid_decode_backward(planes, coords, 1.0, *ws, drgb, dsig)
        want = dm.decode_backward_plain(planes, coords, 1.0, *ws, drgb, dsig)
        errs = [_rel(g, w) for g, w in zip(got, want)]
        abs_err = max(max_err(g, w) for g, w in zip(got, want))
        check(max(errs) <= 1e-4, f"trigrid_decode_backward disagrees: {errs}")
        call = lambda: dm.trigrid_decode_backward(planes, coords, 1.0, *ws, drgb, dsig)  # noqa: E731
        ms, launch = cuda_ms(call, reps=5), device_ms(call, launches=3, reps=3, warmup=1)
        pms = cuda_ms(lambda: dm.decode_backward_plain(planes, coords, 1.0, *ws, drgb, dsig),
                      reps=3, warmup=1)
    # bound: the grids read and their gradient written once, coordinates,
    # output gradients, weights and their gradients; a point's six products
    # (h and the output recomputed, d w1, d h, d w0, d f: 2 x 3 x (32*64 +
    # 64*33)) at the split-TF32 rate, as the forward's row counts its MLP;
    # the corner lerps and the scatter's products (2 + 2 a corner channel)
    # and ~200 transcendentals and their derivatives a point at the fp32
    # rate. The FFMA bound (all of it at 67 TFLOP/s) beside it.
    n_bytes = 2 * nbytes(planes) + nbytes(coords, drgb, dsig) + 2 * nbytes(*ws)
    mma_ops = n * 2 * 3 * (32 * 64 + 64 * 33)
    fp32_ops = n * (3 * 8 * 32 * (2 + 2) + 200)
    ffma_ms = bound(n_bytes, mma_ops + fp32_ops, f32)[0]
    row("trigrid_decode_backward", f"{list(planes.shape)}, {n} points",
        f"max_abs_err {abs_err:.3e} (max_rel_err {max(errs):.3e} over d grids, d w0, d b0, "
        f"d w1, d b1; tol 1e-4)", ms, pms,
        (n_bytes, mma_ops, f32, SPLIT_TF32_RATE, ((fp32_ops, PEAK_OPS[f32]),)),
        launch_ms=launch, extra=f"; FFMA bound {ffma_ms:.4f} ms")
    del planes, coords, drgb, dsig, got, want

    # K1-trigrid backward at the step's own calls (their batches and point
    # counts, points uniform in the box), held to the plain version at the
    # largest: launches x launch time beside a profiled step's share. Its
    # inputs come from a generator of its own, so that the rows after it
    # keep theirs.
    step_gen = torch.Generator(device=dev).manual_seed(17)
    step_calls: dict = {}
    for c in log.calls["trigrid"]:
        key = (_meta_shape(c[0]), _meta_shape(c[1]))
        step_calls[key] = step_calls.get(key, 0) + 1
    step_launch_ms = 0.0
    for i, ((pshape, cshape), count) in enumerate(
            sorted(step_calls.items(), key=lambda kv: -math.prod(kv[0][1]))):
        planes = torch.randn(pshape, device=dev, generator=step_gen)
        coords = torch.rand(cshape, device=dev, generator=step_gen) - 0.5
        drgb = torch.randn(cshape[:2] + (32,), device=dev, generator=step_gen)
        dsig = torch.randn(cshape[:2] + (1,), device=dev, generator=step_gen)

        def call(planes=planes, coords=coords, drgb=drgb, dsig=dsig):
            return dm.trigrid_decode_backward(planes, coords, 1.0, *ws, drgb, dsig)
        with torch.no_grad():
            if i == 0:
                got = call()
                want = dm.decode_backward_plain(planes, coords, 1.0, *ws, drgb, dsig)
                errs = [_rel(g, w) for g, w in zip(got, want)]
                check(max(errs) <= 1e-4, f"trigrid_decode_backward at the step's call "
                      f"disagrees: {errs}")
                del got, want
            launch = device_ms(call, launches=3, reps=3, warmup=1)
        step_launch_ms += count * launch
        print(f"train trigrid_decode_backward[the step's call: grids {list(pshape)}, coords "
              f"{list(cshape)}, {count} in step 0]: per launch {launch:.4f} ms"
              + (f"; max_rel_err {max(errs):.3e} (tol 1e-4)" if i == 0 else ""))
        del planes, coords, drgb, dsig, call
    print(f"train trigrid_decode_backward: step 0's {sum(step_calls.values())} calls "
          f"{step_launch_ms:.4f} ms")
    rows["trigrid_decode_backward"].update(step0_calls=sum(step_calls.values()),
                                           step0_launch_ms=step_launch_ms)

    # K3 backward: the step's sample lists (sorted depths in [2, 3.3]),
    # gradients of rgb, depth and weights
    (b, m, s1, c), (_, _, s2, _) = k3
    d1 = torch.sort(2 + 1.3 * rand((b, m, s1, 1)), dim=2).values
    d2 = torch.sort(2 + 1.3 * rand((b, m, s2, 1)), dim=2).values
    c1, c2 = rand((b, m, s1, c)), rand((b, m, s2, c))
    sg1, sg2 = 5 * randn((b, m, s1, 1)), 5 * randn((b, m, s2, 1))
    g = (randn((b, m, c)), randn((b, m, 1)), randn((b, m, s1 + s2 - 1, 1)))
    args = (d1, c1, sg1, d2, c2, sg2, False, *g)
    with torch.no_grad():
        got = rr.merge_composite_backward(*args)
        want = rr.merge_composite_backward_plain(*args)
        errs = [_rel(x, y) for x, y in zip(got, want)]
        abs_err = max(max_err(x, y) for x, y in zip(got, want))
        check(max(errs) <= 1e-4, f"merge_composite_backward disagrees: {errs}")
        ms = cuda_ms(lambda: rr.merge_composite_backward(*args), reps=5)
        launch = device_ms(lambda: rr.merge_composite_backward(*args), launches=5, reps=3)
        pms = cuda_ms(lambda: rr.merge_composite_backward_plain(*args), reps=3, warmup=1)
    s = s1 + s2
    row("merge_composite_backward", f"[{b},{m},{s1}+{s2},{c}]",
        f"max_abs_err {abs_err:.3e} (max_rel_err {max(errs):.3e}, tol 1e-4)", ms, pms,
        (nbytes(d1, c1, sg1, d2, c2, sg2, *g) + nbytes(c1, sg1, c2, sg2),
         b * m * (s * c * 4 + s * 40), f32), launch_ms=launch)
    del d1, d2, c1, c2, sg1, sg2, g, got, want, args

    # K6a backward at each of the step's distinct forwards: the adjoint FIR
    # (K6a itself) against the plain adjoint; the library call, where one
    # computes it (a grouped conv or transposed conv), checked to agree
    for (shape, dtype, up, down, pad, gain), fmeta in sorted(
            k6a.items(), key=lambda kv: -math.prod(kv[0][0])):
        f = fmeta[1].to(dev) if fmeta is not None else None
        x = randn(shape, dtype)
        y = ufd.upfirdn2d_plain(x, f, up, down, pad, gain)
        dy = randn(tuple(y.shape), dtype)
        in_hw = tuple(shape[-2:])
        with torch.no_grad():
            got = ufd.upfirdn2d_backward(dy, f, up, down, pad, gain, in_hw)
            want = ufd.upfirdn2d_backward_plain(dy, f, up, down, pad, gain, in_hw)
            check(got.shape == x.shape, f"upfirdn2d_backward shape {tuple(got.shape)}")
            if dtype == bf16:
                # 2 bf16 ulps of the plain output plus the fp32 reordering
                # bound 16 * 2^-24 * sum|terms|: sum|terms| is the plain
                # adjoint on |dy| and |f| in fp32, 16 the terms of each
                # output's sum (the 4x4 FIR)
                mag = ufd.upfirdn2d_backward_plain(dy.abs().float(),
                                                   None if f is None else f.abs(), up, down,
                                                   pad, abs(gain), in_hw)
                u, r = bf16_ulps(got, want), bf16_sum_err(got, want, mag)
                check(r <= 1, f"upfirdn2d_backward[{shape}] is {u} bf16 ulps off, {r:.3f} of "
                      f"2 ulps + 16 * 2^-24 * sum|terms|")
                err = (f"max_abs_err {max_err(got, want):.3e} ({u:g} bf16 ulps; {r:.3f} of "
                       f"the tol 2 ulps + 16 * 2^-24 * sum|terms|)")
            else:
                e = max_err(got, want)
                check(e <= 1e-5, f"upfirdn2d_backward[{shape}] disagrees: {e}")
                err = f"max_abs_err {e:.3e} (tol 1e-5)"
            call = lambda: ufd.upfirdn2d_backward(dy, f, up, down, pad, gain, in_hw)  # noqa: E731
            ms, launch = cuda_ms(call), device_ms(call)
            pms = cuda_ms(lambda: ufd.upfirdn2d_backward_plain(dy, f, up, down, pad, gain,
                                                               in_hw))
            # the library call: the gradient of the forward's grouped conv
            # (up 1, down 1, even pads) or transposed conv (the skip's up2)
            library, lib = None, None
            cch = shape[1]
            w4 = (f * gain).to(dtype)[None, None].expand(cch, 1, 4, 4).contiguous()
            p4 = pad if isinstance(pad, tuple) else (pad,) * 4
            if up == 1 and down == 1 and len(set(p4)) == 1:
                def lib():
                    return F.conv_transpose2d(dy, torch.flip(w4, (2, 3)), padding=p4[0],
                                              groups=cch)
            elif up == 2 and down == 1 and p4 == (2, 1, 2, 1):
                def lib():
                    return F.conv2d(dy, w4, stride=2, padding=1, groups=cch)
            if lib is not None and lib().shape == want.shape and max_err(lib(), want) <= (
                    1e-5 if dtype == f32 else 0.02 * float(want.float().abs().max())):
                library = cuda_ms(lib)
        taps = 16 // up ** 2
        row("upfirdn2d_backward", f"{list(shape)} {str(dtype)[6:]} up {up} down {down} pad "
            f"{pad}", err, ms, pms, (nbytes(dy, got), 2 * taps * dy.numel(), dtype),
            library=library, launch_ms=launch)
        del x, y, dy, got, want

    # K6b's gradient at each of the step's distinct calls: y from the
    # forward kernel on N(0, 2^2) inputs (so that lrelu's negative side and
    # the clamp act), dy N(0,1)
    for (shape, dtype, act, gain, clamp, axis, has_scale, need_b, need_scale, need_noise) in \
            sorted(k6b, key=lambda k: -math.prod(k[0])):
        x = (2 * randn(shape)).to(dtype)
        bsz, cch = shape[0], shape[1]
        scale = rand((bsz, cch)) + 0.5 if has_scale else None
        bias = randn((cch,)) * 0.3
        with torch.no_grad():
            y = ba.bias_act(x, bias, act=act, gain=gain, clamp=clamp, axis=axis, scale=scale)
            dy = randn(shape, dtype)
            kw = dict(act=act, gain=gain, clamp=clamp, axis=axis, scale=scale, need_b=need_b,
                      need_scale=need_scale, need_noise=need_noise)
            got = ba.bias_act_grad(dy, y, x, **kw)
            want = ba.bias_act_grad_plain(dy, y, x, **kw)
            if dtype == bf16:
                u = bf16_ulps(got[0], want[0])
                check(u <= 2, f"bias_act_grad[{shape}] dx is {u} bf16 ulps off")
                err = f"max_abs_err {max_err(got[0], want[0]):.3e} (dx {u:g} bf16 ulps, tol 2"
            else:
                e = max_err(got[0], want[0])
                check(e <= 1e-6, f"bias_act_grad[{shape}] dx disagrees: {e}")
                err = f"max_abs_err {e:.3e} (dx tol 1e-6"
            # the sums, against the sums of the terms' magnitudes (random
            # signs cancel): fp32 sums in another order stay within ~n eps
            mags = ba.bias_act_grad_plain(dy.abs(), y, x.abs(), **kw)
            sums = [float(((g_ - w_).abs() / m_.clamp_min(1e-30)).max())
                    for g_, w_, m_ in zip(got[1:], want[1:], mags[1:]) if w_ is not None]
            if not all(v <= 1e-5 for v in sums):
                for i, (g_, w_, m_) in enumerate(zip(got[1:], want[1:], mags[1:])):
                    if w_ is not None:
                        r = (g_ - w_).abs() / m_.clamp_min(1e-30)
                        j = int(r.flatten().argmax())
                        print(f"bias_act_grad[{shape}] sum {i}: at {j} got "
                              f"{float(g_.flatten()[j])} want {float(w_.flatten()[j])} "
                              f"magnitude {float(m_.flatten()[j])}; y finite "
                              f"{bool(torch.isfinite(y).all())}, |y| max {float(y.abs().max())}")
            check(all(v <= 1e-5 for v in sums), f"bias_act_grad[{shape}] sums disagree: {sums}")
            err += f"; sums max err / sum of magnitudes {max(sums, default=0):.3e}, tol 1e-5)"
            call = lambda: ba.bias_act_grad(dy, y, x, **kw)  # noqa: E731
            ms, launch = cuda_ms(call), device_ms(call)
            pms = cuda_ms(lambda: ba.bias_act_grad_plain(dy, y, x, **kw))
        reads = nbytes(dy, y) + (nbytes(x) if need_scale and has_scale else 0)
        row("bias_act_grad", f"{list(shape)} {str(dtype)[6:]} {act} clamp {clamp} "
            f"{'scale ' if has_scale else ''}{'db ' if need_b else ''}"
            f"{'dscale' if need_scale and has_scale else ''}", err, ms, pms,
            (reads + nbytes(got[0]), 6 * dy.numel(), dtype), launch_ms=launch)
        del x, y, dy, got, want

    # second derivatives (R1's double backward) through the Functions: for
    # a discriminator block's epilogue and FIR in bf16 and the epilogue's
    # fp32 shapes, against autograd's double backward of the plain versions
    f = ufd.setup_filter([1, 3, 3, 1], device=dev)
    for shape, dtype in (((4, 64, 128, 128), bf16), ((4, 512, 16, 16), f32)):
        outs = []
        for fir, epi in ((ufd.upfirdn2d, ba.bias_act), (ufd.upfirdn2d_plain, ba.bias_act_plain)):
            g2 = torch.Generator(device=dev).manual_seed(11)
            x = (2 * torch.randn(shape, device=dev, generator=g2)).to(dtype).requires_grad_(True)
            bias = (0.3 * torch.randn((shape[1],), device=dev, generator=g2)).requires_grad_(True)
            h = fir(x, f, padding=(2, 2, 2, 2))
            y = epi(h, bias, act="lrelu", gain=2 ** 0.5, clamp=256.0, axis=1)
            dy = torch.randn(tuple(y.shape), device=dev, generator=g2).to(dtype)
            dy.requires_grad_(True)
            gx, gb = torch.autograd.grad(y, (x, bias), dy, create_graph=True)
            vx = torch.randn(tuple(gx.shape), device=dev, generator=g2).to(dtype)
            vb = torch.randn((shape[1],), device=dev, generator=g2)
            outs.append(torch.autograd.grad((gx.float() * vx.float()).sum()
                                            + (gb * vb).sum(), dy)[0])
        e = _rel(outs[0], outs[1])
        check(e <= (1e-4 if dtype == f32 else 2e-2),
              f"second derivative of K6a and K6b [{shape}] {dtype}: {e}")
        print(f"train second derivative (K6a then K6b, R1's double backward) {list(shape)} "
              f"{str(dtype)[6:]}: max_rel_err {e:.3e} against the plain versions' "
              f"(tol {1e-4 if dtype == f32 else 2e-2:g})")
    torch.cuda.empty_cache()
    return rows


def _grads_agree(tag: str, got: dict, want: dict, tol: tuple) -> str:
    """Per parameter, relative to its gradient's largest magnitude floored
    at 1e-3 of the largest of all (a parameter with ~no gradient is held to
    that floor); returns the worst, as text."""
    top = max(float(w.abs().max()) for w in want.values())
    worst = (0.0, 0.0, "")
    for n, w in want.items():
        g = got[n].to(w.device).float()
        check(bool(torch.isfinite(g).all()), f"{tag} {n}: non-finite gradient")
        scale = max(float(w.abs().max()), 1e-3 * top, 1e-30)
        e, me = max_err(g, w) / scale, mean_err(g, w) / scale
        check(e <= tol[0] and me <= tol[1], f"{tag} {n}: max {e:.3e} mean {me:.3e} of "
              f"{scale:.3e} (tol {tol})")
        worst = max(worst, (e, me, n))
    return f"worst {worst[2]}: max {worst[0]:.3e} mean {worst[1]:.3e} (tol {tol[0]:g} / " \
           f"{tol[1]:g})"


def phase_train_step(dev: torch.device) -> None:
    """(b) One training step on the card against the same step on the CPU
    (the plain versions): a small configuration (final 64^2, render 16^2,
    8+8 samples, narrow SR head and discriminator, fp32 blocks), the same
    seeded weights and batch, the card's draws replayed on the CPU. Step 0
    (density regulariser, src2src, R1) and step 1 (the conditioning
    regulariser): every loss at 1e-4 relative, every generator and
    discriminator (with R1) gradient within 5e-2 of its largest magnitude
    at most and 1e-3 on average (fp32 in both, sums in other orders, the L1
    regularisers' signs at ~0 differences, and GroupNorms over the 2^2
    planes of the composite backbone's last stage at this size, where a
    few elements of a deep layer's gradient move by ~1e-2 while its mean
    error stays ~1e-5)."""
    from real3dportrait_tpu_torch.config import load_config, parse_overrides
    from real3dportrait_tpu_torch.training.tasks.secc_img2plane_task import SeccImg2PlaneTask
    from real3dportrait_tpu_torch.utils.draws import RecordDraws, ReplayDraws, seeded_draws

    cfg = load_config(os.path.join(ROOT, "configs", TRAIN_CONFIG), parse_overrides(
        "batch_size=2,final_resolution=64,neural_rendering_resolution=16,"
        "num_samples_coarse=8,num_samples_fine=8,sr_channel0=32,sr_channel1=16,"
        "base_channel=1024,max_channel=64,num_fp16_layers_in_discriminator=0,"
        "num_fp16_layers_in_super_resolution=0,reg_interval_g=2,reg_interval_d=2,"
        "reg_interval_g_cond=2,update_src2src_interval=2,start_adv_iters=0"))
    cpu = torch.device("cpu")
    tasks = {d: SeccImg2PlaneTask(cfg, d) for d in (dev, cpu)}
    states = {d: tasks[d].build(0) for d in (dev, cpu)}
    batch = tasks[cpu].synthetic_batch(np.random.RandomState(0))
    t0 = time.perf_counter()
    for step in (0, 1):
        grads, losses, imgs, d_out = {}, {}, {}, {}
        rec = RecordDraws(seeded_draws(step, dev))
        for d, draws in ((dev, rec), (cpu, None)):
            task, st = tasks[d], states[d]
            st.step = step
            b = task._maybe_src2src(step, task.to_device(batch))
            _, losses[d], out, grads[d] = task.g_grads(st, b, draws or ReplayDraws(rec.records))
            if d == dev:
                imgs = (out["image"].detach().cpu(), out["image_raw"].detach().cpu())
            if step == 0:
                d_out[d] = task.d_grads(st, imgs[0].to(d), imgs[1].to(d), b)
            del out
        torch.cuda.synchronize()
        check(set(losses[dev]) == set(losses[cpu]), "train step: loss names differ")
        for k, v in losses[cpu].items():
            g = float(losses[dev][k])
            check(math.isfinite(g) and abs(g - float(v)) <= 1e-4 * max(abs(float(v)), 1e-6),
                  f"train step {step}: loss {k} {g} on the card, {float(v)} on the CPU")
        text = _grads_agree(f"train step {step} generator", grads[dev], grads[cpu], (5e-2, 1e-3))
        print(f"train step[{step}] card vs CPU: {len(losses[cpu])} losses within 1e-4; "
              f"generator gradients {text}")
        if step == 0:
            (dg, dgr, r1g), (dc, dgc, r1c) = d_out[dev], d_out[cpu]
            check(abs(float(dg) - float(dc)) <= 1e-4 * abs(float(dc)) and
                  abs(float(r1g) - float(r1c)) <= 1e-3 * abs(float(r1c)),
                  f"train step 0: D loss {float(dg)} / {float(dc)}, R1 {float(r1g)} / "
                  f"{float(r1c)}")
            text = _grads_agree("train step 0 discriminator (with R1)", dgr, dgc, (5e-2, 1e-3))
            print(f"train step[0] card vs CPU: D loss {float(dg):.6f} / {float(dc):.6f}, R1 "
                  f"{float(r1g):.4e} / {float(r1c):.4e}; discriminator gradients {text}")
    print(f"train step card vs CPU: {time.perf_counter() - t0:.1f} s")
    del tasks, states
    torch.cuda.empty_cache()


FACEV2V = ("facev2v/occlusion_reg_l1", "facev2v/occlusion_2_reg_l1",
           "facev2v/occlusion_2_weights_entropy")


def phase_train(dev: torch.device, out_dir: str, hparams: str = TRAIN_HPARAMS,
                config: str = TRAIN_CONFIG, exp: str = "train", steps: int = TRAIN_STEPS,
                path_kernels: tuple = ("trigrid_decode", "importance_sample", "merge_composite",
                                       "upfirdn2d", "bias_act", *TRAIN_KERNELS),
                frozen: tuple = (), init_from: str | None = None, losses: tuple = (),
                bf16: bool = True, reload: bool = True, instrument=None,
                modules: tuple = ("gen", "disc")) -> tuple[dict, CallLog]:
    """A full-width run of ``training.run`` on ``configs/<config>`` for
    ``steps`` steps on synthetic batches, with the launch counters from 0.
    By default (c): ``configs/secc_img2plane.yaml`` (b0 SegFormers, depth-3
    x 32 tri-grids, 128^2 render with 48+48 samples, the 512^2 SR head and
    dual discriminator with their bf16 resolutions) at the config's batch of
    4 for 4 steps. Checks: every loss finite (``losses`` among them); every
    group of the state's first module of ``modules`` (the generator, by its
    top-level names) and each other module of ``modules`` (the
    discriminator) moved, but the ``frozen`` groups or modules, which stay
    bit-equal to the run's start (and, with ``init_from``, a work dir the
    run starts from by ``init_from_ckpt``, the generator's frozen groups
    equal to that checkpoint's); every kernel of ``path_kernels`` launched
    (and a bf16 K6a and K6b where ``bf16``) and no plain version called;
    with ``reload``, the checkpoint it wrote loads into a fresh task with
    equal modules, moments and lambdas. Prints ms/step (the median of the steps after the
    first, a warm-up) and the peak memory. Returns the launches (with
    ``ms_per_step``, ``peak_gib`` and the run's ``work_dir``) and the record
    of the first step's kernel calls. ``hparams`` replaces the run's
    overrides (a tiny configuration rehearses the phase on the CPU);
    ``instrument(trainer)``, where given, is called on the run's trainer
    before it starts."""
    from real3dportrait_tpu_torch.models import decoder as dm
    from real3dportrait_tpu_torch.models import torso as tm
    from real3dportrait_tpu_torch.ops import bias_act as ba
    from real3dportrait_tpu_torch.ops import conv3d as c3d
    from real3dportrait_tpu_torch.ops import upfirdn2d as ufd
    from real3dportrait_tpu_torch.rendering import renderer as rr
    from real3dportrait_tpu_torch.training import run as trun
    from real3dportrait_tpu_torch.training.checkpoint import (
        get_all_ckpts, get_last_checkpoint, load_checkpoint)
    from real3dportrait_tpu_torch.training.schedulers import Adam
    from real3dportrait_tpu_torch.weights import torch_state_dict_from_jax

    # count the plain versions' calls: on the card none may run
    plains = [(ba, "bias_act_plain"), (ba, "bias_act_grad_plain"), (ufd, "upfirdn2d_plain"),
              (ufd, "upfirdn2d_backward_plain"), (dm, "trigrid_decode_plain"),
              (dm, "triplane_decode_plain"), (dm, "decode_backward_plain"),
              (rr, "merge_composite_plain"), (rr, "merge_composite_backward_plain"),
              (rr, "importance_sample_plain"),
              (c3d, "conv3d_plain"), (c3d, "conv3d_weight_grad_plain"),
              (tm, "torso_deform_input_plain"), (tm, "torso_deform_input_backward_plain"),
              (tm, "torso_warp_volume_plain"), (tm, "torso_warp_volume_backward_plain"),
              (tm, "mfe_tail_plain"), (tm, "mfe_tail_backward_plain")]
    plain_calls = {name: 0 for _, name in plains}
    saved = {}
    for mod, name in plains:
        saved[name] = getattr(mod, name)

        def counted(*a, _f=saved[name], _n=name, **k):
            plain_calls[_n] += 1
            return _f(*a, **k)
        setattr(mod, name, counted)
    over = hparams + (f",init_from_ckpt={init_from}" if init_from else "")
    argv = ["--config", os.path.join(ROOT, "configs", config), "--exp_name", exp,
            "--work_dir_root", out_dir, "--hparams", over, "--device", str(dev)]
    log, times, metrics, init = CallLog(), [], [], {}
    try:
        t0 = time.perf_counter()
        trainer = trun.make_trainer(argv)
        task = trainer.task
        if instrument is not None:
            instrument(trainer)
        start_fn, step_fn = trainer.init_or_restore, task.train_step

        def start_and_keep(seed):
            st = start_fn(seed)
            init["step"] = st.step
            for mod in modules:
                init[mod] = {n: p.detach().clone() for n, p in getattr(st, mod).named_parameters()}
            return st

        def timed_step(state, batch, draws):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if not times:
                with log:
                    m = step_fn(state, batch, draws)
            else:
                m = step_fn(state, batch, draws)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            metrics.append(m)
            return m

        trainer.init_or_restore, task.train_step = start_and_keep, timed_step
        reset_launches()
        for w in train_wrappers().values():
            w.launches = 0
            if hasattr(w, "launches_bf16"):
                w.launches_bf16 = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = trainer.fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        for mod, name in plains:
            setattr(mod, name, saved[name])
    counts = read_launches()
    counts.update({k: w.launches for k, w in train_wrappers().items()})
    counts.update({f"{k} bf16": w.launches_bf16 for k, w in train_wrappers().items()
                   if hasattr(w, "launches_bf16")})
    end_step = init["step"] + steps
    check(state.step == end_step and len(times) == steps,
          f"{exp}: {state.step} steps from {init['step']}, {len(times)} timed")
    host = {k: [float(m[k]) for m in metrics] for k in metrics[0]}
    bad = {k: v for k, v in host.items() if not all(math.isfinite(x) for x in v)}
    check(not bad, f"{exp}: non-finite metrics {bad}")
    check(all(f"g/{k}" in host for k in losses), f"{exp}: losses {sorted(host)}")
    groups = {}
    for mod in modules:
        for n, p in getattr(state, mod).named_parameters():
            key = n.split(".", 1)[0] if mod == modules[0] else mod
            moved = not torch.equal(p.detach(), init[mod][n])
            groups[key] = groups.get(key, False) or moved
    check(all(v == (k not in frozen) for k, v in groups.items()),
          f"{exp}: groups moved {groups}, frozen {frozen}")
    if init_from and modules[0] == "gen":
        src = torch_state_dict_from_jax({"params": get_last_checkpoint(init_from)[0][
            "params"]["gen"]})
        same = [torch.equal(p.detach().cpu(), src[n]) for n, p in state.gen.named_parameters()
                if n.split(".", 1)[0] in frozen]
        check(same and all(same), f"{exp}: frozen groups differ from {init_from}'s checkpoint")
    check(all(counts[k] > 0 for k in path_kernels), f"{exp}: launches {counts}")
    if bf16:
        check(counts["upfirdn2d bf16"] > 0 and counts["bias_act_grad bf16"] > 0,
              f"{exp}: bf16 launches {counts}")
    check(not any(plain_calls.values()), f"{exp}: plain versions called {plain_calls}")
    ckpts = get_all_ckpts(trainer.work_dir)
    check(len(ckpts) == 1 and ckpts[0].endswith(f"model_ckpt_steps_{end_step}.ckpt"),
          f"ckpts {ckpts}")
    reloaded = ""
    if reload:
        # the checkpoint back into a fresh task
        t1 = time.perf_counter()
        fresh_trainer = trun.make_trainer(argv)
        fresh = fresh_trainer.task.build(12345)
        fresh.load_state_dict(load_checkpoint(ckpts[0]))
        same = fresh.step == state.step
        for field in dataclasses.fields(state):
            o, f = getattr(state, field.name), getattr(fresh, field.name)
            if isinstance(o, torch.nn.Module):
                a, b = o.state_dict(), f.state_dict()
                same = same and list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
            elif isinstance(o, Adam):
                same = same and o.count == f.count and all(
                    torch.equal(o.mu[k], f.mu[k]) and torch.equal(o.nu[k], f.nu[k])
                    for k in o.mu)
            elif field.name == "extra":
                same = same and all(torch.equal(o[k], f[k]) for k in o)
        check(same, f"{exp}: the checkpoint does not load back to the trained state")
        reloaded = f"; the checkpoint ({os.path.getsize(ckpts[0]) / 2 ** 20:.1f} MiB) " \
                   f"reloaded equal in {time.perf_counter() - t1:.1f} s"
        del fresh, fresh_trainer
    step_ms = statistics.median(times[1:]) * 1e3
    start = f" from {init_from}'s checkpoint (step {init['step']})" if init_from else ""
    print(f"{exp} run[{config}, {steps} steps{start}]: {step_ms:.1f} ms/step (median of steps "
          f"2-{steps}; first {times[0] * 1e3:.1f} ms; steps {[round(t * 1e3, 1) for t in times]})"
          f", peak memory {peak:.2f} GiB, wall {wall:.1f} s{reloaded}")
    print(f"{exp} run: losses {json.dumps({k: v for k, v in host.items()})}")
    print(f"{exp} run: groups moved {groups}; launches over the {steps} steps {counts}; plain "
          f"calls {plain_calls}")
    counts["ms_per_step"], counts["peak_gib"] = step_ms, peak
    counts["work_dir"] = trainer.work_dir
    del state, trainer
    torch.cuda.empty_cache()
    return counts, log


def _meta_shape(meta) -> tuple:
    """The shape of a recorded tensor argument (``CallLog._meta``)."""
    return tuple(meta[1]) if meta[0] == "T" else tuple(meta[1].shape)


def phase_torso_kernels(dev: torch.device, log: CallLog, tri_log: CallLog) -> dict:
    """(b) Each backward kernel of the torso stage and the tri-plane one
    against its plain version, at the calls of the runs' first steps
    (``log``: the torso run; ``tri_log``: the tri-plane run): K7a's weight
    gradient at every distinct 3D conv of the step (and the mask conv inside
    K7b), each beside cuDNN's per launch, with the step's sums and a count
    of the calls it beats, K7a's data gradient at the fuser, K5a's adjoint
    at the step's call and near the identity, K5b's at the step's call and
    at a deformation uniform in [-1.2, 1.2], K7b's backward, K1's on one
    frame's coarse + fine points.
    Tolerances: fp32
    sums in another order, with atomics in a run-dependent order, 1e-4 of
    the largest magnitude (K5a's and K5b's adjoints, sums of at most 8 x 5
    terms, 1e-5). Each row: the per-call and per-launch time, the plain
    version's, the bound (bytes over 3.35 TB/s, operations over the fp32
    peak; K7a's data gradient, on the tensor cores, at the split-TF32 rate;
    K1's MLP as the tri-grid row counts it) and, where one PyTorch call
    computes the same function (cuDNN's weight and data gradients,
    ``grid_sampler_3d_backward``), its time."""
    from real3dportrait_tpu_torch.models import decoder as dm
    from real3dportrait_tpu_torch.models import torso as tm
    from real3dportrait_tpu_torch.ops import conv3d as c3d

    gen = torch.Generator(device=dev).manual_seed(8)
    f32 = torch.float32
    rows: dict = {}

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    def rand(*shape):
        return torch.rand(shape, device=dev, generator=gen)

    def errors(got, want):
        """(largest error relative to each output's largest magnitude, largest
        absolute error) over the outputs."""
        pairs = list(zip(got, want))
        return [_rel(g, wv) for g, wv in pairs], max(max_err(g, wv) for g, wv in pairs)

    def row(name, tag, errs, ms, launch, pms, cost, library=None, tol=1e-4, **extra):
        rel, abs_err = errs
        check(max(rel) <= tol, f"{name}[{tag}] disagrees: {rel}")
        bound_ms, bound_by = bound(*cost)
        lib = "null" if library is None else f"{library:.4f} ms"
        print(f"train {name}[{tag}]: max_abs_err {abs_err:.3e} (max_rel_err {max(rel):.3e}, tol "
              f"{tol:g}) per launch {launch:.4f} ms, per call {ms:.4f} ms plain {pms:.4f} ms "
              f"library {lib} bound {bound_ms:.4f} ms ({bound_by})"
              f"{''.join(f'; {k} {v}' for k, v in extra.items())}")
        rows.setdefault(name, dict(shape=tag, dtype="float32", max_abs_err=abs_err,
                                   max_rel_err=max(rel), ms=ms, plain_ms=pms,
                                   bound_ms=bound_ms, bound_by=bound_by, library_ms=library,
                                   launch_ms=launch, **extra))
        return bound_ms

    def times(fn, heavy=False):
        return (cuda_ms(fn, reps=3, warmup=1),
                device_ms(fn, launches=3 if heavy else 10, reps=3, warmup=1))

    def hold_row(name, tag, case, errs, ms, launch, pms, cost, library):
        """A K5 adjoint held at one more input (``case``), tolerance 1e-5 of
        scale (sums of at most 8 x 5 terms, atomics in a run-dependent
        order): the step's call is the kernel's row, each case also in its
        ``holds``."""
        bound_ms = row(name, f"{tag}, {case}", errs, ms, launch, pms, cost, library=library,
                       tol=1e-5)
        rows[name].setdefault("holds", {})[case] = dict(
            max_rel_err=max(errs[0]), max_abs_err=errs[1], launch_ms=launch, ms=ms,
            plain_ms=pms, bound_ms=bound_ms, library_ms=library)

    # K7a's weight gradient at the step's distinct 3D convs (the count of
    # each in a step), the mask conv in K7b's backward among them
    convs: dict = {}
    for c in log.calls["conv3d"]:
        key = (_meta_shape(c[0]), _meta_shape(c[1]))
        convs[key] = convs.get(key, 0) + 1
    tail = log.calls["mfe_tail"][0]
    key = (_meta_shape(tail[0]), _meta_shape(tail[1]))
    convs[key] = convs.get(key, 0) + len(log.calls["mfe_tail"])
    step_ms = step_lib = step_lib_launch = step_bound = 0.0
    faster = 0
    first = None
    for (xs, ws), n in sorted(convs.items(), key=lambda kv: -c3d.conv3d_ops(
            kv[0][0][1], kv[0][1][0], *kv[0][0][2:], kv[0][1][-1], kv[0][0][0])):
        b, ci, d, h, w = xs
        co, k = ws[0], ws[-1]
        x, dy = randn(*xs), randn(b, co, d, h, w)
        with torch.no_grad():
            got = c3d.conv3d_weight_grad(x, dy, k)
            want = c3d.conv3d_weight_grad_plain(x, dy, k)
            errs = errors(got, want)
            ms, launch = times(lambda: c3d.conv3d_weight_grad(x, dy, k), heavy=True)
            pms = cuda_ms(lambda: c3d.conv3d_weight_grad_plain(x, dy, k), reps=3, warmup=1)
            lib_launch = device_ms(lambda: c3d.conv3d_weight_grad_plain(x, dy, k), launches=3,
                                   reps=3, warmup=1)
        # the least time is on the tensor cores in split TF32, where the
        # kernel runs (the FFMA bound beside)
        ops = c3d.conv3d_ops(ci, co, d, h, w, k, b)
        cost = (nbytes(x, dy, *got), ops, f32, SPLIT_TF32_RATE)
        bnd = bound(*cost)[0]
        step_ms, step_lib, step_bound = step_ms + n * launch, step_lib + n * pms, \
            step_bound + n * bnd
        step_lib_launch += n * lib_launch
        faster += n * (launch < lib_launch)
        tag = f"x {list(xs)} -> {co}, k {k}, {n} a step"
        if first is None:
            first = (tag, errs, ms, launch, pms, cost, x, dy, ws)
        else:
            print(f"train conv3d_weight_grad[{tag}]: max_abs_err {errs[1]:.3e} (max_rel_err "
                  f"{max(errs[0]):.3e}, tol 1e-4) per launch {launch:.4f} ms, per call "
                  f"{ms:.4f} ms, cuDNN (plain and library) {pms:.4f} ms, per launch "
                  f"{lib_launch:.4f} ms, bound {bnd:.4f} ms (split TF32; FFMA "
                  f"{bound(*cost[:3])[0]:.4f} ms)")
            check(max(errs[0]) <= 1e-4, f"conv3d_weight_grad[{tag}] disagrees: {errs}")
        del x, dy, got, want
    tag, errs, ms, launch, pms, cost, x, dy, ws = first
    # K7a's data gradient at the same call: K7a on the flipped taps
    wt = randn(*ws) / math.sqrt(ws[1] * ws[-1] ** 3)
    with torch.no_grad():
        dx = c3d.conv3d_data_grad(dy, wt)
        dlib = lambda: torch.nn.grad.conv3d_input(x.shape, wt, dy, padding=ws[-1] // 2)  # noqa: E731
        derr = _rel(dx, dlib())
        check(derr <= 1e-4, f"conv3d data gradient disagrees: {derr}")
        dms, dlaunch = times(lambda: c3d.conv3d_data_grad(dy, wt), heavy=True)
        dlib_ms = cuda_ms(dlib, reps=3, warmup=1)
    dbound = bound(nbytes(dy, wt, dx), c3d.conv3d_ops(ws[0], ws[1], *x.shape[2:], ws[-1],
                                                       x.shape[0]), f32, SPLIT_TF32_RATE)[0]
    print(f"train conv3d data gradient (K7a)[{tag}]: max_rel_err {derr:.3e} (tol 1e-4) per "
          f"launch {dlaunch:.4f} ms, per call {dms:.4f} ms, cuDNN {dlib_ms:.4f} ms, bound "
          f"{dbound:.4f} ms (operations, split TF32)")
    n_calls = sum(convs.values())
    print(f"train conv3d_weight_grad, the step's {n_calls} calls: kernel {step_ms:.2f} ms a "
          f"step per launch, cuDNN {step_lib_launch:.2f} per launch ({step_lib:.2f} per call), "
          f"bound {step_bound:.3f}; the kernel faster than cuDNN on {faster} of {n_calls}")
    row("conv3d_weight_grad", tag, errs, ms, launch, pms, cost, library=pms,
        ffma_bound_ms=bound(*cost[:3])[0], step_launch_ms=step_ms, step_library_ms=step_lib,
        step_library_launch_ms=step_lib_launch, step_calls=n_calls, step_calls_faster=faster,
        step_bound_ms=step_bound,
        shapes=len(convs), data_grad_launch_ms=dlaunch, data_grad_ms=dms,
        data_grad_library_ms=dlib_ms, data_grad_bound_ms=dbound, data_grad_rel_err=derr)
    del x, dy, wt, dx

    # K5a's adjoint at the step's call (keypoints uniform in [-0.8, 0.8]), then
    # near the identity (source keypoints within 0.1 of the driving ones)
    c = log.calls["deform"][0]
    vol_shape, kps = _meta_shape(c[0]), _meta_shape(c[1])
    b, d, h, w, ch = vol_shape
    k1 = kps[1] + 1
    kp_d = rand(*kps) * 1.6 - 0.8
    cases = [("the step's call", rand(*kps) * 1.6 - 0.8, rand(*kps) * 1.6 - 0.8),
             ("near the identity", kp_d + 0.2 * rand(*kps) - 0.1, kp_d)]
    dout = randn(b, k1 * (1 + ch), d, h, w)
    vin = randn(*vol_shape).permute(0, 4, 1, 2, 3).contiguous()
    gout = dout.reshape(b, k1, 1 + ch, d, h, w)[:, :, 1:].transpose(1, 2).reshape(
        b, ch, k1 * d, h, w).contiguous()
    n_out = b * k1 * ch * d * h * w
    for case, kp_s, kp_d in cases:
        with torch.no_grad():
            got = tm.torso_deform_input_backward(dout, kp_s, kp_d, vol_shape)
            want = tm.torso_deform_input_backward_plain(dout, kp_s, kp_d, vol_shape)
            ms, launch = times(lambda: tm.torso_deform_input_backward(dout, kp_s, kp_d,
                                                                      vol_shape))
            pms = cuda_ms(lambda: tm.torso_deform_input_backward_plain(dout, kp_s, kp_d,
                                                                       vol_shape), reps=3)
            # the library call: grid_sample's 3D backward with the candidates
            # stacked along the output's depth
            grid = tm.create_sparse_motions(kp_s, kp_d, d, h, w).reshape(b, k1 * d, h, w, 3)

            def lib():
                return torch.ops.aten.grid_sampler_3d_backward(gout, vin, grid, 0, 0, True,
                                                               [True, False])[0]
            lerr = _rel(lib().permute(0, 2, 3, 4, 1), want)
            check(lerr <= 1e-4, f"grid_sampler_3d_backward (zeros) [{case}] disagrees: {lerr}")
            lms = cuda_ms(lib)
        hold_row("torso_deform_input_backward", f"{list(vol_shape)}, K+1 = {k1}", case,
                 errors([got], [want]), ms, launch, pms,
                 (4 * n_out + nbytes(got, kp_s, kp_d), 16 * n_out, f32), lms)
        del got, want, grid
    del dout, vin, gout

    # K5b's adjoint at the step's call (a deformation near the identity,
    # 0.05 N(0, 1)), then uniform in [-1.2, 1.2], the worst case for locality
    c = log.calls["warp"][0]
    fs_shape = _meta_shape(c[0])
    b, d, h, w, ch = fs_shape
    fs = randn(*fs_shape)
    base = tm.make_coordinate_grid_3d(d, h, w, dev)[None].expand(b, -1, -1, -1, -1)
    cases = [("the step's call", (base + 0.05 * randn(b, d, h, w, 3)).contiguous()),
             ("uniform in [-1.2, 1.2]", 2.4 * rand(b, d, h, w, 3) - 1.2)]
    dout = randn(b, ch * d, h, w)
    gout, vin = dout.view(b, ch, d, h, w), fs.permute(0, 4, 1, 2, 3).contiguous()
    for case, deform in cases:
        with torch.no_grad():
            got = tm.torso_warp_volume_backward(fs, deform, dout)
            want = tm.torso_warp_volume_backward_plain(fs, deform, dout)
            errs = errors(got, want)
            ms, launch = times(lambda: tm.torso_warp_volume_backward(fs, deform, dout))
            pms = cuda_ms(lambda: tm.torso_warp_volume_backward_plain(fs, deform, dout), reps=3)

            def lib():
                return torch.ops.aten.grid_sampler_3d_backward(gout, vin, deform, 0, 1, True,
                                                               [True, True])
            lg = lib()
            lerr = max(_rel(lg[0].permute(0, 2, 3, 4, 1), want[0]), _rel(lg[1], want[1]))
            check(lerr <= 1e-4, f"grid_sampler_3d_backward (border) [{case}] disagrees: {lerr}")
            lms = cuda_ms(lib)
        hold_row("torso_warp_volume_backward", f"{list(fs_shape)}", case, errs, ms, launch, pms,
                 (nbytes(dout, fs, deform, *got), b * d * h * w * ch * 8 * 4, f32), lms)
        del got, want, lg, deform
    del fs, dout, gout, vin, cases

    # K7b's backward at the step's call
    shapes = [_meta_shape(a) for a in tail[:7]]
    b, ch, d, h, w = shapes[0]
    x = randn(*shapes[0])
    mw, mb = 0.01 * randn(*shapes[1]), 0.1 * randn(*shapes[2])
    ow, ob = 0.01 * randn(*shapes[3]), 0.1 * randn(*shapes[4])
    kp_s, kp_d = rand(*shapes[5]) * 1.6 - 0.8, rand(*shapes[6]) * 1.6 - 0.8
    with torch.no_grad():
        _, occ1, occ2 = tm.mfe_tail(x, mw, mb, ow, ob, kp_s, kp_d)
        mask = torch.softmax(torch.nn.functional.conv3d(x, mw, mb, padding=3), dim=1)
        ddef, g1, g2 = randn(b, d, h, w, 3), randn(b, h, w, 1), randn(b, h, w, 1)
        args = (x, mw, ow, kp_s, kp_d, mask, occ1, occ2, ddef, g1, g2)
        got = tm.mfe_tail_backward(*args)
        want = tm.mfe_tail_backward_plain(*args)
        errs = errors(got, want)
        ms, launch = times(lambda: tm.mfe_tail_backward(*args), heavy=True)
        pms = cuda_ms(lambda: tm.mfe_tail_backward_plain(*args), reps=3, warmup=1)
        # each launch of the call alone (CUDA events, 3 back to back), on
        # the call's own intermediate tensors, in the call's order
        steps, _ = tm.mfe_tail_backward_steps(*args)
        parts = {}
        for name, fn in steps:
            parts[name] = device_ms(fn, launches=3, reps=3, warmup=1)
    # the mask conv's data and weight gradients and the occlusion heads'
    # (convolutions all): the least time is on the tensor cores in split
    # TF32; the heads' weight gradient runs on FFMA (the FFMA bound beside).
    # The part that is not the mask conv's weight gradient: its data
    # gradient and both heads' gradients; x, the adjoint's inputs and
    # outputs, dx and the heads' weight gradients once
    k1 = shapes[1][0]
    mask_ops = c3d.conv3d_ops(ch, k1, d, h, w, 7, b)
    head_ops = 2 * 2 * 2 * 49 * ch * d * b * h * w
    ops = 2 * mask_ops + head_ops
    n_bytes = nbytes(x, mask, ddef, g1, g2, occ1, occ2, *got)
    rest_bound = bound(nbytes(x, mask, ddef, g1, g2, occ1, occ2, got[0], *got[3:]),
                       mask_ops + head_ops, f32, SPLIT_TF32_RATE)[0]
    rest_ms = sum(v for k, v in parts.items() if k != "mask conv weight gradient")
    print(f"train mfe_tail_backward parts[x {list(shapes[0])}]: "
          + "; ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
          + f"; all but the weight gradient {rest_ms:.4f} ms, bound {rest_bound:.4f} ms "
          f"(operations, split TF32)")
    row("mfe_tail_backward", f"x {list(shapes[0])}, K+1 = {k1}", errs, ms, launch, pms,
        (n_bytes, ops, f32, SPLIT_TF32_RATE), ffma_bound_ms=bound(n_bytes, ops, f32)[0],
        parts_launch_ms=parts, rest_launch_ms=rest_ms, rest_bound_ms=rest_bound)
    del x, mask, ddef, g1, g2, got, want, args, steps

    # K1's backward on tri-planes: one frame of the tri-plane run's planes,
    # the frame's coarse + fine points (uniform in the box)
    c = tri_log.calls["triplane"][0]
    pshape = (1,) + _meta_shape(c[0])[1:]
    n = 2 * _meta_shape(c[1])[1]
    planes, coords = randn(*pshape), rand(1, n, 3) - 0.5
    dec = dm.OSGDecoder(32, 64, 32).to(dev)
    with torch.no_grad():
        for prm in dec.parameters():
            prm.copy_(randn(*prm.shape) * 0.3)
        ws = [t.detach() for t in (*dec.net0.folded(), *dec.net1.folded())]
        drgb, dsig = randn(1, n, 32), randn(1, n, 1)
        got = dm.triplane_decode_backward(planes, coords, 1.0, *ws, drgb, dsig)
        want = dm.decode_backward_plain(planes, coords, 1.0, *ws, drgb, dsig)
        errs = errors(got, want)
        call = lambda: dm.triplane_decode_backward(planes, coords, 1.0, *ws, drgb, dsig)  # noqa: E731
        ms, launch = times(call, heavy=True)
        pms = cuda_ms(lambda: dm.decode_backward_plain(planes, coords, 1.0, *ws, drgb, dsig),
                      reps=3, warmup=1)
    n_bytes = 2 * nbytes(planes) + nbytes(coords, drgb, dsig) + 2 * nbytes(*ws)
    mma_ops = n * 2 * 3 * (32 * 64 + 64 * 33)
    fp32_ops = n * (3 * 4 * 32 * (2 + 2) + 200)
    row("triplane_decode_backward", f"{list(pshape)}, {n} points", errs, ms, launch, pms,
        (n_bytes, mma_ops, f32, SPLIT_TF32_RATE, ((fp32_ops, PEAK_OPS[f32]),)),
        ffma_bound_ms=bound(n_bytes, mma_ops + fp32_ops, f32)[0])
    del planes, coords, drgb, dsig, got, want
    torch.cuda.empty_cache()
    return rows


def train_row(name: str, fwd: str, counts: dict, rows: dict, steps: int, path: str) -> dict:
    """A backward kernel's entry of the kernels line: its launches in the
    training run that is its main path and a step, and its row from
    ``phase_train_kernels`` or ``phase_torso_kernels``."""
    row = dict(name=name, route="cuda", source=SOURCES[fwd], replaces=REPLACES[fwd],
               launches=counts[name], path=f"{path} ({steps} steps)",
               launches_per_step=counts[name] / steps, **rows[name])
    if f"{name} bf16" in counts:
        row["launches_bf16"] = counts[f"{name} bf16"]
    return row


def run_train_phases(dev: torch.device) -> tuple[dict, dict, dict, dict, dict]:
    """The training slices: the flagship's full-width run (c), the torso
    stage's run started from its checkpoint (``train_torso``, with
    ``init_from_ckpt``), the released lineage's tri-plane run
    (``train_triplane``) and its torso stage from that run's checkpoint
    (``train_torso_orig``: tri-planes through K1, ``rgb_alpha`` torso
    input, the torso's kernels and their backwards), then each backward
    kernel at the runs' own calls (a, b), then the small flagship step on
    the card against the CPU. Returns the four runs' launches and the
    kernel rows."""
    torso_kernels = ("trigrid_decode", "importance_sample", "merge_composite", "upfirdn2d",
                     "bias_act", "torso_deform_input", "torso_warp_volume", "conv3d",
                     "mfe_tail", *TRAIN_KERNELS, *TORSO_KERNELS)
    with tempfile.TemporaryDirectory() as out_dir:
        counts, log = phase_train(dev, out_dir)
        torch.cuda.synchronize()
        torso_counts, torso_log = phase_train(
            dev, out_dir, TORSO_HPARAMS, TORSO_CONFIG, "train_torso", TORSO_STEPS,
            path_kernels=torso_kernels, frozen=HEAD_GROUPS, init_from=counts["work_dir"],
            losses=FACEV2V)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as out_dir:
        tri_counts, tri_log = phase_train(
            dev, out_dir, TRIPLANE_HPARAMS, TRIPLANE_CONFIG, "train_triplane", TRIPLANE_STEPS,
            path_kernels=("triplane_decode", "triplane_decode_backward"), bf16=False,
            reload=False)
        torch.cuda.synchronize()
        orig_counts, _ = phase_train(
            dev, out_dir, TORSO_ORIG_HPARAMS, TORSO_ORIG_CONFIG, "train_torso_orig",
            TORSO_ORIG_STEPS, path_kernels=("triplane_decode", "triplane_decode_backward",
                                            "torso_deform_input", "torso_warp_volume",
                                            "conv3d", "mfe_tail", *TORSO_KERNELS),
            frozen=HEAD_GROUPS, init_from=tri_counts["work_dir"], losses=FACEV2V, bf16=False,
            reload=False)
    torch.cuda.synchronize()
    rows = phase_train_kernels(dev, log)
    torch.cuda.synchronize()
    check(set(rows) == set(TRAIN_KERNELS), f"backward kernels measured: {sorted(rows)}")
    rows.update(phase_torso_kernels(dev, torso_log, tri_log))
    torch.cuda.synchronize()
    check(set(rows) == {*TRAIN_KERNELS, *TORSO_KERNELS, *TRIPLANE_KERNELS},
          f"backward kernels measured: {sorted(rows)}")
    phase_train_step(dev)
    torch.cuda.synchronize()
    return counts, torso_counts, tri_counts, orig_counts, rows


# records-driven training (``run_records_phases``): a full-width store of
# 2 videos of 40 frames, the flagship for 3 steps from it (one sanity
# validation, a validation and the image dump at step 3, the vgg19_v2
# criterion on seeded VGG19 / VGGFace trees), the torso stage for 2 steps
# from its checkpoint, and SyncNet for 4 steps
RECORD_FRAMES = 40
RECORD_RES = 512
RECORDS_STEPS = 3
RECORDS_TORSO_STEPS = 2
SYNCNET_STEPS = 4
RECORD_KEYS = ("head_imgs", "com_imgs", "torso_imgs")
# K4's calls of a record batch: the cano, src and tgt maps and the randn
# perturbation's (``prepare_batch_from_records``)
PREP_RASTERS = 4
VAL_IMAGES = {f"{kind}_{i:05d}.png" for i in range(4) for kind in (
    "ref_mv_reconraw_predraw_recon_pred", "depth_recon_pred")} | {"ood_probe.png"}


def seeded_store(out_dir: str) -> str:
    """The ``train`` and ``val`` splits of a record store written by the
    port's ``binarize``: ``make_synthetic_records(n_videos=2,
    t=RECORD_FRAMES)`` with seeded uint8 head / composed / torso frames
    [T,R,R,3], int8 segmaps [T,R,R] and a background [R,R,3], R =
    ``RECORD_RES``."""
    from real3dportrait_tpu_torch.data.binarizer import binarize, make_synthetic_records

    store, t, res = os.path.join(out_dir, "store"), RECORD_FRAMES, RECORD_RES
    for i, split in enumerate(("train", "val")):
        recs = make_synthetic_records(n_videos=2, t=t, seed=i)
        gen = np.random.default_rng(10 + i)
        for r in recs:
            for k in RECORD_KEYS:
                r[k] = gen.integers(0, 256, (t, res, res, 3), dtype=np.uint8)
            r["segmaps"] = gen.integers(0, 6, (t, res, res), dtype=np.int8)
            r["bg_img"] = gen.integers(0, 256, (res, res, 3), dtype=np.uint8)
        binarize(recs, os.path.join(store, split))
    return store


def phase_records(out_dir: str) -> str:
    """The store (``seeded_store``), then each split read back through the
    native reader (``native/record_reader.cpp``, built by g++ on this host)
    and held item for item against ``IndexedDataset``. Returns the store."""
    from real3dportrait_tpu_torch.data.indexed_dataset import IndexedDataset
    from real3dportrait_tpu_torch.data.native_reader import NativePrefetchReader, build_library

    t0 = time.perf_counter()
    store = seeded_store(out_dir)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_library()
    t_build = time.perf_counter() - t0
    text = []
    for split in ("train", "val"):
        path = os.path.join(store, split)
        size = sum(os.path.getsize(os.path.join(store, f)) for f in os.listdir(store)
                   if f.startswith(split + "."))
        t0 = time.perf_counter()
        with NativePrefetchReader(path) as reader:
            native = list(reader.iterate(n_threads=4))
        t_native = time.perf_counter() - t0
        ds = IndexedDataset(path)
        t0 = time.perf_counter()
        python = [ds[i] for i in range(len(ds))]
        t_python = time.perf_counter() - t0
        ds.close()
        check(len(native) == len(python) == 2, f"records {split}: {len(native)} / {len(python)}")
        for a, b in zip(native, python):
            check(list(a) == list(b) and all(np.array_equal(a[k], b[k]) for k in b),
                  f"records {split}: the native reader's item differs from IndexedDataset's")
        text.append(f"{split} {size / 2 ** 20:.1f} MiB: native {t_native * 1e3:.1f} ms, "
                    f"IndexedDataset {t_python * 1e3:.1f} ms")
    print(f"records[2 videos x {RECORD_FRAMES} frames of {RECORD_RES}^2 a split]: written in "
          f"{t_write:.2f} s; native reader built in {t_build:.2f} s; " + "; ".join(text)
          + "; every item equal")
    return store


def vgg_trees(out_dir: str) -> str:
    """Seeded VGG19 and VGGFace trees as msgpack files; the overrides that
    point the criterion at them (``vgg19_v2``)."""
    from real3dportrait_tpu_torch.models.perceptual import init_vgg19_params, init_vggface_params
    from real3dportrait_tpu_torch.utils.msgpack_ckpt import msgpack_serialize

    paths = {}
    for key, tree in (("vgg19_ckpt", init_vgg19_params(np.random.RandomState(0))),
                      ("vggface_ckpt", init_vggface_params(np.random.RandomState(1)))):
        paths[key] = os.path.join(out_dir, f"{key}.msgpack")
        with open(paths[key], "wb") as f:
            f.write(msgpack_serialize(tree))
    return ",".join(f"{k}={v}" for k, v in paths.items())


def full_mesh_renderer(task) -> None:
    """The task's SECC renderer on the 35,709-vertex synthetic morphable
    model (BFM09's vertex count, as a user's ``bfm_dir`` gives it; the
    default synthetic model has 512 vertices)."""
    from real3dportrait_tpu_torch.geometry.bfm import synthetic_bfm
    from real3dportrait_tpu_torch.geometry.secc_renderer import SECCRenderer

    task._secc_r = SECCRenderer(
        synthetic_bfm(n_vertices=35709), rasterize_size=int(task.cfg.get("secc_resolution", 256)),
        output_resolution=int(task.cfg.get("final_resolution", 512)), device=task.device)


class PrepTimer:
    """Times a records task's batch preparation apart from its steps: each
    training batch's wall (the store's unpickling and
    ``prepare_batch_from_records``, synchronised), the preparation alone,
    its SECC rasters (``SECCRenderer.render``) and its blink edits (host),
    and K4's launches in it."""

    def __init__(self):
        self.batch, self.prep, self.raster, self.blink, self.k4 = [], [], [], [], []
        self.in_train = False
        self.step_launches: dict = {}  # every kernel's launches inside the train steps

    @staticmethod
    def _launches() -> dict:
        counts = read_launches()
        counts.update({k: w.launches for k, w in train_wrappers().items()})
        return counts

    def install(self, trainer) -> None:
        from real3dportrait_tpu_torch.geometry.rasterizer import rasterize_verts
        from real3dportrait_tpu_torch.inference import edit_secc

        task = trainer.task
        full_mesh_renderer(task)
        renderer = task._secc_renderer()
        timer = self

        def timed(fn, into):
            def call(*a, **k):
                if not timer.in_train:
                    return fn(*a, **k)
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                into[-1] += time.perf_counter() - t
                return out
            return call

        prepare = task.prepare_batch_from_records

        def prepare_counted(rec):
            if not timer.in_train:
                return prepare(rec)
            for lst in (timer.raster, timer.blink):
                lst.append(0.0)
            k4 = rasterize_verts.launches
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = prepare(rec)
            torch.cuda.synchronize()
            timer.prep.append(time.perf_counter() - t)
            timer.k4.append(rasterize_verts.launches - k4)
            return out

        task.prepare_batch_from_records = prepare_counted
        renderer.render = timed(renderer.render, self.raster)
        self.original_blink = edit_secc.blink_eye_for_secc
        edit_secc.blink_eye_for_secc = timed(self.original_blink, self.blink)
        train_data = task.train_data

        def timed_train_data():
            it = train_data()
            while True:
                timer.in_train = True
                t = time.perf_counter()
                batch = next(it)
                torch.cuda.synchronize()
                timer.batch.append(time.perf_counter() - t)
                timer.in_train = False
                yield batch

        task.train_data = timed_train_data
        train_step = task.train_step

        def counted_step(*a, **k):
            before = self._launches()
            out = train_step(*a, **k)
            for name, n in self._launches().items():
                self.step_launches[name] = self.step_launches.get(name, 0) + n - before[name]
            return out

        task.train_step = counted_step

    def uninstall(self) -> None:
        from real3dportrait_tpu_torch.inference import edit_secc

        if hasattr(self, "original_blink"):
            edit_secc.blink_eye_for_secc = self.original_blink

    def summary(self) -> str:
        ms = lambda v: statistics.median(v) * 1e3  # noqa: E731
        unpickle = [b - p for b, p in zip(self.batch, self.prep)]
        return (f"batch preparation (median of {len(self.batch)}): {ms(self.batch):.1f} ms = "
                f"unpickle and pair sampling {ms(unpickle):.1f} ms + prepare_batch_from_records "
                f"{ms(self.prep):.1f} ms (SECC rasters {ms(self.raster):.1f} ms, blink edits "
                f"on the host {ms(self.blink):.1f} ms); K4 launches a batch {self.k4}")


def criterion_ms(fn, dev: torch.device) -> float:
    """CUDA-event ms of the records step's criterion alone at the step's
    shapes: ``fn`` on a [4,R,R,3] image and on its [4,R/5,R/5,3] lip crop
    (``lip_rect_size``'s default), forward and the image's gradient."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x, tgt = (torch.rand((4, RECORD_RES, RECORD_RES, 3), device=dev, generator=gen) * 2 - 1
              for _ in range(2))
    x.requires_grad_(True)
    lip = RECORD_RES // 5

    def call():
        loss = fn(x, tgt) + fn(x[:, :lip, :lip], tgt[:, :lip, :lip])
        torch.autograd.grad(loss, x)

    ms = cuda_ms(call, reps=3, warmup=1)
    del x, tgt
    torch.cuda.empty_cache()
    return ms


def phase_record_batch(dev: torch.device, store: str) -> None:
    """One record batch of the store's train split, at the ``train_records``
    run's own batch (``FULL_STEP_HPARAMS``: 4 pairs, whose frames K4 puts on
    its grid's y axis), prepared on the card and on the CPU from the same
    seed: the SECC maps (K4 against its plain version, from vertices that
    the two devices' fp32 sums may move by an ulp) agree within K4's
    tolerance, 1e-6, where both cover, with at most 1 pixel in 10^4
    covered on one device only; the cameras and the keypoint-derived values
    within 1e-5 (the images, uint8 / 127.5 - 1, within an ulp: the card
    divides by a reciprocal), the lip centres (integer pixels) and the head
    mask equal."""
    from real3dportrait_tpu_torch.config import load_config, parse_overrides
    from real3dportrait_tpu_torch.data import Motion2VideoDataset
    from real3dportrait_tpu_torch.training.tasks.secc_img2plane_task import SeccImg2PlaneTask

    cfg = load_config(os.path.join(ROOT, "configs", TRAIN_CONFIG),
                      parse_overrides(f"{FULL_STEP_HPARAMS},binary_data_dir={store}"))
    rec = next(Motion2VideoDataset(os.path.join(store, "train"), cfg, seed=0).batches())
    b = int(cfg["batch_size"])
    cpu = torch.device("cpu")
    out, secs = {}, {}
    for d in (dev, cpu):
        task = SeccImg2PlaneTask(cfg, d)
        full_mesh_renderer(task)
        t0 = time.perf_counter()
        out[d] = {k: v.cpu() for k, v in task.prepare_batch_from_records(rec).items()}
        secs[d] = time.perf_counter() - t0
    got, want = out[dev], out[cpu]
    check(set(got) == set(want), f"record batch keys {sorted(set(got) ^ set(want))}")
    text = []
    for k, w in want.items():
        g = got[k]
        check(g.shape == w.shape and g.dtype == w.dtype and g.shape[0] == b,
              f"record batch {k}: {g.shape}")
        if k.startswith(("secc", "pertube_secc", "blink_secc")):
            cov_g, cov_w = (g > -1).any(-1), (w > -1).any(-1)
            one_side = float((cov_g != cov_w).float().mean())
            both = cov_g & cov_w
            err = float((g - w).abs().amax(-1)[both].max())
            check(one_side <= 1e-4 and err <= 1e-6,
                  f"record batch {k}: {one_side:.2e} of pixels covered on one device, "
                  f"max err {err:.2e} where both cover")
            text.append(f"{k} {err:.1e}/{one_side:.1e}")
        elif w.dtype == torch.int32 or k == "head_mask":
            check(torch.equal(g, w), f"record batch {k} differs")
        else:
            e = max_err(g, w)
            check(e <= 1e-5 * max(float(w.abs().max()), 1.0), f"record batch {k}: err {e}")
            text.append(f"{k} {e:.1e}")
    print(f"record batch card vs CPU [{b} pairs of {RECORD_RES}^2, SECC maps "
          f"{tuple(want['secc_cond'].shape)} from {b} x {cfg.get('secc_resolution', 256)}^2 "
          f"rasters, 35,709-vertex mesh]: card "
          f"{secs[dev] * 1e3:.1f} ms, CPU {secs[cpu] * 1e3:.1f} ms; max err / one-sided "
          f"coverage: {', '.join(text)}; lip centres and head masks equal")


def phase_train_syncnet(dev: torch.device, out_dir: str, store: str) -> dict:
    """``training.run`` on ``configs/audio_lm3d_syncnet.yaml`` at full width
    (lm468: 1404-d landmarks, 8192 clip pairs a batch, base 128, out 1024)
    from the store for ``SYNCNET_STEPS`` steps: finite losses, a batch of the
    config's shape, the checkpoint reloaded into a fresh state through
    ``partial_load`` with equal weights and moments. Prints ms/step
    (synchronised), the mining ms a batch, the peak memory and one more
    step's device kernels (``torch.profiler``)."""
    from real3dportrait_tpu_torch.training import run as trun
    from real3dportrait_tpu_torch.training.checkpoint import get_last_checkpoint, partial_load

    steps = SYNCNET_STEPS
    argv = ["--config", os.path.join(ROOT, "configs", "audio_lm3d_syncnet.yaml"),
            "--exp_name", "syncnet", "--work_dir_root", out_dir, "--device", str(dev),
            "--hparams", f"binary_data_dir={store},max_updates={steps},"
            f"val_check_interval={steps},eval_max_batches=1,num_sanity_val_steps=0,"
            f"tb_log_interval={steps}"]
    trainer = trun.make_trainer(argv)
    task = trainer.task
    mining, step_s, metrics, shapes, last = [], [], [], [], {}
    train_data, train_step = task.train_data, task.train_step

    def timed_data():
        it = train_data()
        while True:
            t = time.perf_counter()
            batch = next(it)
            mining.append(time.perf_counter() - t)
            shapes.append({k: tuple(v.shape) for k, v in batch.items()})
            last["batch"] = batch
            yield batch

    def timed_step(state, batch, draws):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = train_step(state, batch, draws)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        metrics.append({k: float(v) for k, v in m.items()})
        return m

    task.train_data, task.train_step = timed_data, timed_step
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = trainer.fit()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = int(task.cfg.get("syncnet_num_clip_pairs", 256))
    check(state.step == steps and len(step_s) == steps, f"syncnet: {state.step} steps")
    check(task.lm_dim == 1404 and shapes[0] == {"hubert_clip": (n, 10, 1024),
                                                "mouth_clip": (n, 5, 1404), "label": (n,)},
          f"syncnet batch {shapes[0]}")
    check(all(math.isfinite(v) for m in metrics for v in m.values()), f"syncnet {metrics}")
    src, path = get_last_checkpoint(trainer.work_dir)
    fresh = task.build(777)
    merged, stats = partial_load(fresh.state_dict(), src)
    check(stats["missing"] == 0 and stats["shape_mismatch"] == 0, f"syncnet reload {stats}")
    fresh.load_state_dict(merged)
    same = fresh.step == state.step and all(
        torch.equal(a, b) for a, b in zip(fresh.model.state_dict().values(),
                                          state.model.state_dict().values()))
    same = same and all(torch.equal(fresh.opt.mu[k], state.opt.mu[k]) for k in state.opt.mu)
    check(same, "syncnet: the checkpoint does not reload to the trained state")
    # where a step's device time goes: one more step under torch.profiler
    from real3dportrait_tpu_torch.utils.profiling import kernel_table

    batch = task.to_device(last["batch"])
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        train_step(state, batch, None)
        torch.cuda.synchronize()
    device_ms, top = kernel_table(prof, 6, port=False)
    print(f"train_syncnet profile[one step]: kernel time {device_ms:.1f} ms; top: " + "; ".join(
        f"{x.key[:70]} {x.self_device_time_total / 1e3:.1f} ms x{x.count}" for x in top))
    step_ms = statistics.median(step_s[1:]) * 1e3
    print(f"train_syncnet run[audio_lm3d_syncnet.yaml, lm468, {n} clip pairs, {steps} steps]: "
          f"{step_ms:.1f} ms/step (median of steps 2-{steps}; steps "
          f"{[round(x * 1e3, 1) for x in step_s]}), mining {statistics.median(mining) * 1e3:.1f}"
          f" ms a batch (batches {[round(x * 1e3, 1) for x in mining]}), peak memory "
          f"{peak:.2f} GiB, wall {wall:.1f} s; sync_bce "
          f"{[round(m['sync_bce'], 4) for m in metrics]}"
          f"; checkpoint ({os.path.getsize(path) / 2 ** 20:.1f} MiB) reloaded through "
          f"partial_load, {stats['loaded']} leaves, equal")
    del state, fresh, trainer
    torch.cuda.empty_cache()
    return {"ms_per_step": step_ms, "mining_ms": statistics.median(mining) * 1e3, "peak_gib": peak}


def run_records_phases(dev: torch.device) -> tuple[dict, dict]:
    """Records-driven training: the store (``phase_records``), the flagship
    (``train_records``: K4 in batch preparation, finite losses, the
    validation PNGs named as JAX names them, the ``vgg19_v2`` criterion),
    the torso stage from its checkpoint, one record batch on the card
    against the CPU, SyncNet, and audio-to-motion with that SyncNet frozen,
    half its steps from the store. Returns the flagship run's launches (with
    K4's a batch in preparation), SyncNet's and audio-to-motion's numbers."""
    rec_kernels = ("secc_raster", "trigrid_decode", "importance_sample", "merge_composite",
                   "upfirdn2d", "bias_act", *TRAIN_KERNELS)
    torso_kernels = rec_kernels + ("torso_deform_input", "torso_warp_volume", "conv3d",
                                   "mfe_tail", *TORSO_KERNELS)
    with tempfile.TemporaryDirectory() as out_dir:
        store = phase_records(out_dir)
        torch.cuda.synchronize()
        vgg = vgg_trees(out_dir)
        common = f",binary_data_dir={store},{vgg},eval_max_batches=1,tb_log_interval=1"
        prep = PrepTimer()
        percep = {}

        def install(trainer):
            percep["kind"], percep["fn"] = trainer.task.percep_kind, trainer.task.percep_fn
            prep.install(trainer)

        try:
            counts, _ = phase_train(
                dev, out_dir, FULL_STEP_HPARAMS + f",max_updates={RECORDS_STEPS},"
                f"val_check_interval={RECORDS_STEPS},num_sanity_val_steps=1" + common,
                TRAIN_CONFIG, "train_records", RECORDS_STEPS, path_kernels=rec_kernels,
                reload=False, instrument=install)
        finally:
            prep.uninstall()
        check(percep["kind"] == "vgg19_v2", f"train_records criterion {percep}")
        check(len(prep.k4) == RECORDS_STEPS and all(n == PREP_RASTERS for n in prep.k4),
              f"train_records: K4 launches in batch preparation {prep.k4}")
        dump = os.path.join(counts["work_dir"], "val_images", f"iter{RECORDS_STEPS}")
        names = set(os.listdir(dump)) if os.path.isdir(dump) else set()
        check(names == VAL_IMAGES, f"train_records: val images {sorted(names)}")
        sizes = sorted(os.path.getsize(os.path.join(dump, n)) for n in names)
        check(all(prep.step_launches[k] > 0 for k in rec_kernels if k != "secc_raster"),
              f"train_records: launches in the steps {prep.step_launches}")
        print(f"train_records: {prep.summary()}; percep {percep['kind']}; {len(names)} PNGs "
              f"under val_images/iter{RECORDS_STEPS} ({sizes[0]}-{sizes[-1]} bytes); launches "
              f"in the {RECORDS_STEPS} steps {prep.step_launches}")
        crit = criterion_ms(percep.pop("fn"), dev)
        print(f"train_records: the {percep['kind']} criterion alone at the step's shapes "
              f"(4 x {RECORD_RES}^2 image and 4 x {RECORD_RES // 5}^2 lip crop, forward and "
              f"backward): {crit:.1f} ms")
        counts["prep_k4_per_step"] = sum(prep.k4) / RECORDS_STEPS
        counts["step_launches"] = prep.step_launches
        counts["prep_ms"] = statistics.median(prep.batch) * 1e3
        torch.cuda.synchronize()
        torso_prep = PrepTimer()
        try:
            phase_train(
                dev, out_dir, f"batch_size=4,start_adv_iters=0,max_updates="
                f"{RECORDS_STEPS + RECORDS_TORSO_STEPS},val_check_interval=100000,"
                f"num_sanity_val_steps=0" + common, TORSO_CONFIG, "train_records_torso",
                RECORDS_TORSO_STEPS, path_kernels=torso_kernels, frozen=HEAD_GROUPS,
                init_from=counts["work_dir"], losses=FACEV2V, reload=False,
                instrument=torso_prep.install)
        finally:
            torso_prep.uninstall()
        check(all(n == PREP_RASTERS for n in torso_prep.k4),
              f"train_records_torso: K4 launches in batch preparation {torso_prep.k4}")
        print(f"train_records_torso: {torso_prep.summary()}")
        torch.cuda.synchronize()
        phase_record_batch(dev, store)
        torch.cuda.synchronize()
        sync = phase_train_syncnet(dev, out_dir, store)
        torch.cuda.synchronize()
        a2m = phase_train_a2m(dev, out_dir, store, os.path.join(out_dir, "syncnet"))
    torch.cuda.synchronize()
    return counts, sync, a2m


# the last three training stages: audio-to-motion with its frozen SyncNet
# (inside the records phases: half its steps read the store, its SyncNet is
# train_syncnet's), the EG3D tri-plane teacher and img2plane distillation
A2M_CONFIG = "audio2motion_vae.yaml"
A2M_STEPS = 4
A2M_HPARAMS = "batch_size=4,lambda_sync=0.1" + RUN_HPARAMS
EG3D_CONFIG = "eg3d.yaml"
EG3D_STEPS = 4
# the config's batch of 4; step 0 runs the density regulariser and R1
# (reg_interval_g 4, reg_interval_d 16)
EG3D_HPARAMS = f"batch_size=4,max_updates={EG3D_STEPS}" + RUN_HPARAMS
# the backward kernels of the EG3D step (K1's on tri-planes, at batch 4)
EG3D_KERNELS = ("triplane_decode", "importance_sample", "merge_composite", "upfirdn2d",
                "bias_act", "triplane_decode_backward", "merge_composite_backward",
                "upfirdn2d_backward", "bias_act_grad")
I2P_CONFIG = "img2plane.yaml"
I2P_STEPS = 3
# start_adv_iters cut from 30000 to 1, so that the adversarial loss and the
# decoder and SR gates run within the 3 steps (the cut is printed)
I2P_HPARAMS = f"batch_size=4,start_adv_iters=1,max_updates={I2P_STEPS}" + RUN_HPARAMS
I2P_KERNELS = ("trigrid_decode", "triplane_decode", "importance_sample", "merge_composite",
               "upfirdn2d", "bias_act", "trigrid_decode_backward", "merge_composite_backward",
               "upfirdn2d_backward", "bias_act_grad")


def per_step(counts: dict, steps: int) -> dict:
    """Each kernel's launches a step of a run (the kernels that ran)."""
    return {k: v / steps for k, v in counts.items()
            if isinstance(v, int) and v > 0}


def phase_train_a2m(dev: torch.device, out_dir: str, store: str, syncnet_dir: str) -> dict:
    """``training.run`` on ``configs/audio2motion_vae.yaml`` at full width
    (the model's fixed widths, 1024-d HuBERT input) and batch 4 with the
    sync loss on (``lambda_sync`` 0.1) and ``syncnet_ckpt_dir`` at
    ``train_syncnet``'s work dir (lm468): 2 steps on synthetic batches, then
    2 more from their checkpoint (``init_from_ckpt``) on the record store's
    sequences. Checks: finite losses with ``sync``; every group of the
    model moved; the frozen SyncNet bit-equal to ``train_syncnet``'s
    checkpoint, loaded leaf for leaf through the prefix map; no kernel of
    the repo launched (its convolutions are cuDNN's); the checkpoint
    reloaded equal. Returns the launches (every count 0) with ms/step and
    peak memory of the two runs."""
    from real3dportrait_tpu_torch.training import checkpoint as ckpt
    from real3dportrait_tpu_torch.training.tasks.audio2motion_task import Audio2MotionTask
    from real3dportrait_tpu_torch.weights import torch_state_dict_from_jax

    half = A2M_STEPS // 2
    common = f"syncnet_ckpt_dir={syncnet_dir}," + A2M_HPARAMS
    shapes, stats = [], {}

    def instrument(trainer):
        task = trainer.task
        check(isinstance(task, Audio2MotionTask) and task.use_syncnet, "train_a2m: no SyncNet")
        load, data = task.load_syncnet, task.train_data

        def counted_load(syncnet):
            stats.update(load(syncnet))
            return stats

        def seen():
            for b in data():
                shapes.append({k: tuple(np.shape(v)) for k, v in b.items()})
                yield b
        task.load_syncnet, task.train_data = counted_load, seen

    runs = []
    for i, (extra, exp) in enumerate(((f",max_updates={half}", "train_a2m"),
                                      (f",max_updates={A2M_STEPS},binary_data_dir={store}",
                                       "train_a2m_records"))):
        counts, _ = phase_train(
            dev, out_dir, common + extra, A2M_CONFIG, exp, half, path_kernels=(),
            frozen=("syncnet",), init_from=runs[0]["work_dir"] if i else None,
            losses=(), bf16=False, instrument=instrument, modules=("model", "syncnet"))
        check(not any(v for k, v in counts.items() if isinstance(v, int)),
              f"{exp}: a kernel of the repo launched: {counts}")
        runs.append(counts)
    src = torch_state_dict_from_jax({"params": ckpt.get_last_checkpoint(syncnet_dir)[0][
        "params"]["syncnet"]})
    last = ckpt.load_checkpoint(ckpt.get_last_checkpoint(runs[1]["work_dir"])[1])
    got = torch_state_dict_from_jax({"params": last["params"]["syncnet"]})
    check(set(src) == set(got) and all(torch.equal(src[k], got[k]) for k in src),
          "train_a2m: the frozen SyncNet differs from train_syncnet's checkpoint")
    check(stats.get("missing") == 0 and stats.get("shape_mismatch") == 0 and
          stats.get("loaded") == len(src), f"train_a2m: SyncNet through the prefix map {stats}")
    synthetic = [s for s in shapes if s["audio"][0] == 4]
    from_store = [s for s in shapes if s not in synthetic]
    check(synthetic and from_store, f"train_a2m: batches {shapes}")
    print(f"train_a2m: SyncNet from {syncnet_dir} through prefix_map {{'syncnet': 'p'}}: "
          f"{stats}; batches synthetic {synthetic[0]}, from the store {from_store[0]}; "
          f"ms/step {runs[0]['ms_per_step']:.1f} (synthetic), {runs[1]['ms_per_step']:.1f} "
          f"(store), peak {max(r['peak_gib'] for r in runs):.2f} GiB; launches a step of the "
          f"repo's kernels: none (cuDNN 1-D convolutions)")
    return {"ms_per_step": statistics.median([r["ms_per_step"] for r in runs]),
            "peak_gib": max(r["peak_gib"] for r in runs)}


class StashK2:
    """Keeps the arguments of a run's first K2 call (``importance_sample``)
    of its first step: installed at the first step, it replaces the
    renderer's reference once and puts it back at that call."""

    def __init__(self):
        self.args = None

    def install(self, trainer):
        from real3dportrait_tpu_torch.rendering import renderer as rr

        task, step = trainer.task, trainer.task.train_step
        orig = rr.importance_sample

        def stash(depths, densities, u):
            rr.importance_sample = orig
            self.args = tuple(t.detach().clone() for t in (depths, densities, u))
            return orig(depths, densities, u)

        def first_step(state, batch, draws):
            if self.args is None:
                rr.importance_sample = stash
            try:
                return step(state, batch, draws)
            finally:
                rr.importance_sample = orig
        task.train_step = first_step


def hold_calls(dev: torch.device, log: CallLog, tag: str, seed: int,
               forward_only: tuple = ()) -> dict:
    """Each kernel of a training step at each of its distinct calls in
    ``log`` (the first step's), against its plain version, on seeded inputs
    of the recorded shapes and arguments: K1 (tri-planes) and K1-trigrid
    forward and backward (tol 1e-4 of scale), K6a forward and backward (fp32
    1e-5 absolute; bf16 2 ulps of the plain output plus the fp32
    reordering bound 16 * 2^-24 * sum|terms|, ``bf16_sum_err``), K6b
    forward (fp32 1e-6 of scale, bf16 2 ulps) and gradient (dx as the
    forward; the sums db, dscale and dnoise within 1e-5 of the sum of their
    terms' magnitudes). Prints a line a kernel with the calls held and the
    worst error; returns {kernel: (calls held, worst error, calls)}. The
    K1 layouts of ``forward_only`` ("triplane", "trigrid") took no gradient
    in the step: their backward is not held."""
    from real3dportrait_tpu_torch.models import decoder as dm
    from real3dportrait_tpu_torch.ops import bias_act as ba
    from real3dportrait_tpu_torch.ops import upfirdn2d as ufd

    gen = torch.Generator(device=dev).manual_seed(seed)
    f32, bf16 = torch.float32, torch.bfloat16
    out: dict = {}

    def randn(shape, dtype=f32):
        return torch.randn(tuple(shape), device=dev, generator=gen).to(dtype)

    def note(name, err, what):
        n, worst, shapes = out.get(name, (0, 0.0, []))
        out[name] = (n + 1, max(worst, err), shapes + [what])

    def timed(name, what, call, plain, cost):
        launch, ms, pms = device_ms(call, launches=3, reps=3, warmup=1), cuda_ms(call, reps=3), \
            cuda_ms(plain, reps=3, warmup=1)
        bound_ms, by = bound(*cost)
        print(f"{tag} {name}[the step's largest call, {what}]: per launch {launch:.4f} ms, per "
              f"call {ms:.4f} ms, plain {pms:.4f} ms, bound {bound_ms:.4f} ms ({by})")

    # K1 / K1-trigrid at each distinct (planes, coords): a seeded decoder,
    # points uniform in the box
    dec = dm.OSGDecoder(32, 64, 32).to(dev)
    with torch.no_grad():
        for p in dec.parameters():
            p.copy_(randn(p.shape) * 0.3)
    ws = [t.detach() for t in (*dec.net0.folded(), *dec.net1.folded())]
    for key, fwd, plain in (("triplane", dm.triplane_decode, dm.triplane_decode_plain),
                            ("trigrid", dm.trigrid_decode, dm.trigrid_decode_plain)):
        name = "triplane_decode" if key == "triplane" else "trigrid_decode"
        back = dm.triplane_decode_backward if key == "triplane" else dm.trigrid_decode_backward
        for i, (pshape, cshape) in enumerate(sorted(
                {(_meta_shape(c[0]), _meta_shape(c[1])) for c in log.calls[key]},
                key=lambda k: -math.prod(k[1]))):
            planes = randn(pshape)
            coords = torch.rand(cshape, device=dev, generator=gen) - 0.5
            with torch.no_grad():
                e = max(_rel(g, w) for g, w in zip(fwd(planes, coords, 1.0, dec),
                                                   plain(planes, coords, 1.0, dec)))
                check(e <= 1e-4, f"{tag} {name}[{pshape}, {cshape}] disagrees: {e}")
                note(name, e, f"{list(pshape)} x {list(cshape)}")
                if key in forward_only:
                    continue
                drgb, dsig = randn(cshape[:2] + (32,)), randn(cshape[:2] + (1,))
                got = back(planes, coords, 1.0, *ws, drgb, dsig)
                want = dm.decode_backward_plain(planes, coords, 1.0, *ws, drgb, dsig)
                e = max(_rel(g, w) for g, w in zip(got, want))
                check(e <= 1e-4, f"{tag} {name}_backward[{pshape}, {cshape}] disagrees: {e}")
                note(f"{name}_backward", e, f"{list(pshape)} x {list(cshape)}")
                del got, want
                if i == 0:
                    # the bound as phase_train_kernels counts it: the planes
                    # and their gradient once, six products a point at
                    # split TF32, the corner lerps, the scatter and ~200
                    # transcendentals a point at the fp32 rate
                    n = cshape[0] * cshape[1]
                    corners = 8 if key == "trigrid" else 4
                    timed(f"{name}_backward", f"{list(pshape)} x {list(cshape)}",
                          lambda: back(planes, coords, 1.0, *ws, drgb, dsig),
                          lambda: dm.decode_backward_plain(planes, coords, 1.0, *ws, drgb, dsig),
                          (2 * nbytes(planes) + nbytes(coords, drgb, dsig) + 2 * nbytes(*ws),
                           n * 2 * 3 * (32 * 64 + 64 * 33), f32, SPLIT_TF32_RATE,
                           ((n * (3 * corners * 32 * (2 + 2) + 200), PEAK_OPS[f32]),)))
            del planes, coords, drgb, dsig

    # K6a forward and backward at each distinct forward call
    k6a = {}
    for c in log.calls["upfirdn2d"]:
        if c[6] == ("fn", "upfirdn2d"):
            key = (c[0][1], c[0][2], c[2], c[3], tuple(c[4]) if isinstance(c[4], (list, tuple))
                   else c[4], c[5])
            k6a.setdefault(key, c[1])
    for (shape, dtype, up, down, pad, gain), fmeta in k6a.items():
        f = fmeta[1].to(dev) if fmeta is not None else None
        fa = None if f is None else f.abs()
        x = randn(shape, dtype)
        in_hw = tuple(shape[-2:])
        with torch.no_grad():
            got, want = ufd.upfirdn2d(x, f, up, down, pad, gain), ufd.upfirdn2d_plain(
                x, f, up, down, pad, gain)
            dy = randn(tuple(want.shape), dtype)
            gb = ufd.upfirdn2d_backward(dy, f, up, down, pad, gain, in_hw)
            wb = ufd.upfirdn2d_backward_plain(dy, f, up, down, pad, gain, in_hw)
            if dtype == bf16:
                e = bf16_sum_err(got, want, ufd.upfirdn2d_plain(x.abs().float(), fa, up, down,
                                                                pad, abs(gain)))
                eb = bf16_sum_err(gb, wb, ufd.upfirdn2d_backward_plain(
                    dy.abs().float(), fa, up, down, pad, abs(gain), in_hw))
                check(e <= 1 and eb <= 1, f"{tag} upfirdn2d[{shape} bf16 up {up} down {down}]: "
                      f"{e:.3f}, backward {eb:.3f} of 2 ulps + 16 * 2^-24 * sum|terms|")
            else:
                e, eb = max_err(got, want), max_err(gb, wb)
                check(e <= 1e-5 and eb <= 1e-5, f"{tag} upfirdn2d[{shape} up {up} down {down}]"
                      f": {e}, backward {eb} (tol 1e-5)")
        what = f"{list(shape)} up {up} down {down} pad {pad}"
        unit = "bf16 (of 2 ulps + 16 * 2^-24 * sum|terms|)" if dtype == bf16 else \
            "fp32 (abs, tol 1e-5)"
        note(f"upfirdn2d {unit}", e, what)
        note(f"upfirdn2d_backward {unit}", eb, what)
        del x, dy, got, want, gb, wb

    # K6b forward and gradient at each distinct call: inputs N(0, 2^2), so
    # that lrelu's negative side and the clamp act
    def aux(meta, shape):
        if meta is None:
            return None
        return torch.rand(_meta_shape(meta), device=dev, generator=gen) + 0.5 \
            if shape == "scale" else randn(_meta_shape(meta)) * 0.3

    k6b = {}
    for c in log.calls["bias_act"]:
        key = (c[0][1], c[0][2], c[1] is not None, c[2] is not None and _meta_shape(c[2]),
               c[3] is not None and _meta_shape(c[3]), c[4], c[5], c[6], c[7])
        k6b.setdefault(key, c)
    for (shape, dtype, has_b, sshape, nshape, act, gain, clamp, axis), c in k6b.items():
        x = (2 * randn(shape)).to(dtype)
        b = aux(c[1], "b") if has_b else None
        scale = aux(c[2], "scale") if sshape else None
        noise = aux(c[3], "noise") if nshape else None
        kw = dict(act=act, gain=gain, clamp=clamp, axis=axis, scale=scale)
        with torch.no_grad():
            got = ba.bias_act(x, b, noise=noise, **kw)
            want = ba.bias_act_plain(x, b, noise=noise, **kw)
            e = bf16_ulps(got, want) if dtype == bf16 else _rel(got, want)
            check(e <= (2 if dtype == bf16 else 1e-6), f"{tag} bias_act[{shape}] disagrees: {e}")
            need = dict(need_b=has_b, need_scale=bool(sshape), need_noise=bool(nshape),
                        noise_per_sample=bool(nshape) and len(nshape) == 3)
            dy = randn(shape, dtype)
            gg = ba.bias_act_grad(dy, got, x, **kw, **need)
            wg = ba.bias_act_grad_plain(dy, got, x, **kw, **need)
            mags = ba.bias_act_grad_plain(dy.abs(), got, x.abs(), **kw, **need)
            ex = bf16_ulps(gg[0], wg[0]) if dtype == bf16 else max_err(gg[0], wg[0])
            sums = [float(((g_ - w_).abs() / m_.clamp_min(1e-30)).max())
                    for g_, w_, m_ in zip(gg[1:], wg[1:], mags[1:]) if w_ is not None]
            check(ex <= (2 if dtype == bf16 else 1e-6) and all(v <= 1e-5 for v in sums),
                  f"{tag} bias_act_grad[{shape}] disagrees: dx {ex}, sums {sums}")
        what = (f"{list(shape)} {act}{' scale' if sshape else ''}"
                f"{' noise ' + str(list(nshape)) if nshape else ''}")
        unit = "bf16 (ulps, tol 2)" if dtype == bf16 else "fp32 (of scale, tol 1e-6)"
        note(f"bias_act {unit}", e, what)
        note(f"bias_act_grad {unit}", ex, what)
        note("bias_act_grad sums (of the sum of magnitudes, tol 1e-5)", max(sums, default=0.0),
             what + (" (dnoise)" if nshape else ""))
        del x, got, want, dy, gg, wg, mags
    for name, (n, worst, shapes) in out.items():
        print(f"{tag} {name}: {n} distinct calls of the step held to the plain version, worst "
              f"error {worst:.3e}; calls {shapes}")
    torch.cuda.empty_cache()
    return out


def phase_train_eg3d(dev: torch.device, out_dir: str) -> dict:
    """``training.run`` on ``configs/eg3d.yaml`` at full width (256^2
    tri-planes of 32 channels from the const-input StyleGAN2 synthesis
    network, 128^2 render at 48+48, the 512^2 SR head and dual
    discriminator with their bf16 resolutions) and batch 4 for
    ``EG3D_STEPS`` steps, the density regulariser and R1 at step 0: finite
    losses, every generator group and the discriminator moved, every kernel
    of the step forward and backward launched (K1's backward on tri-planes
    at batch 4), no plain version called, the checkpoint reloaded equal.
    Then every distinct K1, K1-backward, K6a and K6b call of step 0 against
    its plain version (``hold_calls``), and K2 at the step's first call
    ("auto" ray bounds over the batch's cameras). Returns the launches with
    ms/step and peak memory."""
    from real3dportrait_tpu_torch.rendering.renderer import (
        importance_sample, importance_sample_plain)

    k2 = StashK2()
    counts, log = phase_train(dev, out_dir, EG3D_HPARAMS, EG3D_CONFIG, "train_eg3d",
                              EG3D_STEPS, path_kernels=EG3D_KERNELS,
                              losses=("adv", "density_reg"), instrument=k2.install)
    torch.cuda.synchronize()
    pb = {(_meta_shape(c[0]), _meta_shape(c[1])) for c in log.calls["triplane"]}
    check(any(p[0] == 4 and c[0] == 4 for p, c in pb), f"train_eg3d: K1 calls {pb}")
    held = hold_calls(dev, log, "train_eg3d", 23)
    check({"triplane_decode", "triplane_decode_backward"} <= set(held) and all(
        any(k.startswith(f"{name} {t}") for k in held) for name in (
            "upfirdn2d", "upfirdn2d_backward", "bias_act", "bias_act_grad")
        for t in ("fp32", "bf16")), f"train_eg3d: held {sorted(held)}")
    depths, sigma, u = k2.args
    with torch.no_grad():
        e = _rel(importance_sample(depths, sigma, u), importance_sample_plain(depths, sigma, u))
    check(e <= 1e-4, f"train_eg3d importance_sample at the step's call disagrees: {e}")
    print(f"train_eg3d importance_sample[the step's first call: depths {list(depths.shape)} "
          f"from auto bounds over {depths.shape[0]} cameras, depth range "
          f"{float(depths.min()):.4f}-{float(depths.max()):.4f}]: max_rel_err {e:.3e} "
          f"(tol 1e-4)")
    print(f"train_eg3d: launches a step {per_step(counts, EG3D_STEPS)}")
    del k2, log
    torch.cuda.empty_cache()
    return counts


def phase_train_img2plane(dev: torch.device, out_dir: str) -> dict:
    """``training.run`` on ``configs/img2plane.yaml`` at full width (the
    frozen EG3D teacher at 256^2 tri-planes; the student's b0 SegFormer,
    depth-3 x 32 tri-grids, 128^2 render at 48+48 and 512^2 SR; the dual
    discriminator) and batch 4 for ``I2P_STEPS`` steps, with
    ``start_adv_iters`` cut to 1 (from 30000) so that the adversarial loss
    and the decoder and SR gates run: finite losses, every student group and
    the discriminator moved, the teacher bit-equal to its start, the
    teacher's K1 forward and the student's K1-trigrid forward and backward
    launched, no K1 backward (the teacher takes no gradient), no plain
    version called, the checkpoint (the teacher in it) reloaded equal; then
    every distinct K1-trigrid backward call of the student at batch 4 (and
    the step's K6a and K6b calls) against the plain versions. Returns the
    launches with ms/step and peak memory."""
    print(f"train_img2plane: start_adv_iters cut from 30000 to 1 (the adversarial loss and "
          f"the decoder and SR gates within {I2P_STEPS} steps)")
    counts, log = phase_train(dev, out_dir, I2P_HPARAMS, I2P_CONFIG, "train_img2plane",
                              I2P_STEPS, path_kernels=I2P_KERNELS,
                              losses=("adv", "mse_mv", "percep"), frozen=("teacher",),
                              modules=("student", "disc", "teacher"))
    check(counts["triplane_decode_backward"] == 0,
          f"train_img2plane: the frozen teacher took a gradient: {counts}")
    torch.cuda.synchronize()
    held = hold_calls(dev, log, "train_img2plane", 29, forward_only=("triplane",))
    calls = held.get("trigrid_decode_backward", (0, 0.0, []))[2]
    check(any(s.startswith("[4,") for s in calls),
          f"train_img2plane: K1-trigrid backward calls {calls}")
    print(f"train_img2plane: launches a step {per_step(counts, I2P_STEPS)}")
    del log
    torch.cuda.empty_cache()
    return counts


def run_teacher_phases(dev: torch.device) -> tuple[dict, dict]:
    """The EG3D teacher's stage, then img2plane distillation; returns their
    launches."""
    with tempfile.TemporaryDirectory() as out_dir:
        eg3d = phase_train_eg3d(dev, out_dir)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as out_dir:
        i2p = phase_train_img2plane(dev, out_dir)
    torch.cuda.synchronize()
    return eg3d, i2p


# -- 11-13: the evaluation metrics, the parity tool, data-parallel training ----------

METRIC_RES = 512
METRIC_IMAGES = 64      # a side: real and fake
METRIC_PAIRS = 16
METRIC_HOLD = 4         # images held against the CPU path
PPL_SAMPLES = 16
PARITY_KERNELS = ("triplane_decode", "importance_sample", "merge_composite", "secc_raster",
                  "torso_deform_input", "torso_warp_volume", "upfirdn2d", "bias_act",
                  "conv3d", "mfe_tail")
# psnr's MSE floor (1e-12) over a range of 2: what bit-equal frames read
PSNR_EXACT = round(10 * math.log10(4.0 / 1e-12), 3)
DDP_STEPS = 2
# fp32 throughout, as the train phase's card-vs-CPU step: the bf16 layers
# round otherwise at 2 rows than at 4 (R1 1.6e-3 apart on an H100)
DDP_HPARAMS = FULL_STEP_HPARAMS + f",max_updates={DDP_STEPS},group_size_for_mini_batch_std=1," \
    "tb_log_interval=1,num_sanity_val_steps=0,val_check_interval=100000," \
    "num_fp16_layers_in_discriminator=0,num_fp16_layers_in_super_resolution=0"
# Adam's first steps take each gradient element to about +-lr whatever its
# size, so an element at the noise of the card's reordered sums may change
# sign: the parameter change is held by the share of elements past the
# tolerance (on an H100: two identical runs 1-8 of 126.7 M, two ranks
# against one ~1500)
DDP_FLIP_SHARE = 1e-4
DDP_TIMEOUT = 400
# the ddp phase's record-store runs (``ddp_record_runs``): the SECC stage at
# global batch 2 (1 + 1 rows) from ``seeded_store``'s store, the path's
# kernels on each rank (K4 in each rank's batch preparation); and
# audio-to-motion from a store whose token buckets alternate 4 sequences of
# 64 frames (split 2 + 2) and 3 of 96 (trained whole on each rank):
# ``max_tokens_per_batch`` 288 admits 4 x 64 and 3 x 96 tokens, and a
# fifth row (5 x 96) would pass it. A bucket's sequences are of one length,
# so a split bucket's masked means over each rank's rows average to the
# global batch's (masked means are per rank, ROADMAP's known difference).
DDP_RECORD_HPARAMS = DDP_HPARAMS.replace("batch_size=4", "batch_size=2")
DDP_RECORD_KERNELS = ("secc_raster", "trigrid_decode", "importance_sample", "merge_composite",
                      "upfirdn2d", "bias_act", *TRAIN_KERNELS)
DDP_A2M_BUCKETS = ((4, 64), (3, 96))
DDP_A2M_STEPS = 3
DDP_A2M_HPARAMS = f"max_tokens_per_batch=288,max_updates={DDP_A2M_STEPS},tb_log_interval=1," \
    "num_sanity_val_steps=0,val_check_interval=100000"
DDP_SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _wall_ms(fn, dev: torch.device):
    """(fn's result, host wall ms of one call with the device synchronised
    around it)."""
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, 1e3 * (time.perf_counter() - t)


def seeded_inception(seed: int = 0):
    """``InceptionV3Features`` with seeded weights: He-normal convs, BN
    affines 1 + 0.1 N(0,1) and 0.1 N(0,1) (mock weights: no pytorch-fid
    file is in the repo)."""
    from real3dportrait_tpu_torch.metrics.inception import BasicConv2d, InceptionV3Features

    g = torch.Generator().manual_seed(seed)
    model = InceptionV3Features()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BasicConv2d):
                w = m.conv.weight
                w.normal_(generator=g).mul_((2.0 / w[0].numel()) ** 0.5)
                m.bn_scale.normal_(generator=g).mul_(0.1).add_(1.0)
                m.bn_bias.normal_(generator=g).mul_(0.1)
    return model.eval()


def phase_metrics(dev: torch.device, out_dir: str, ppl_hparams: str = "") -> dict:
    """The evaluation metrics at full size on seeded mock weights: 64 + 64
    seeded 512^2 images through ``inception_pool_features`` (the seeded
    network written as a ``convert_inception`` msgpack tree and read back
    by ``resolve_extractor``), 4 of them held against the CPU path at 1e-4
    of the features' scale; ``calc_metric`` fid, kid and pr50k with the
    Inception extractor and with the random projection; PSNR, SSIM, the
    LPIPS surrogate and ``lpips_vgg`` (``init_lpips_params``) on 16 pairs of
    512^2 frames, held against the CPU at 1e-4 of scale; ``ppl`` of
    ``configs/eg3d.yaml``'s ``TriPlaneGenerator`` at full width (16
    samples). Prints each one's ms; returns them. ``ppl_hparams`` (config
    overrides) make the generator small to rehearse the phase on the CPU."""
    from real3dportrait_tpu_torch.config import load_config, parse_overrides
    from real3dportrait_tpu_torch.metrics import calc_metric, image_metrics
    from real3dportrait_tpu_torch.metrics.gan_metrics import resolve_extractor
    from real3dportrait_tpu_torch.metrics.inception import (
        inception_pool_features, load_inception_params)
    from real3dportrait_tpu_torch.models.perceptual import init_lpips_params, lpips_vgg
    from real3dportrait_tpu_torch.training.tasks.eg3d_task import EG3DTask
    from real3dportrait_tpu_torch.utils.msgpack_ckpt import msgpack_serialize
    from real3dportrait_tpu_torch.weights import (
        jax_variables_from_torch, lpips_weights_from_jax, mock_init_)

    ms: dict = {}
    cpu = torch.device("cpu")
    path = os.path.join(out_dir, "inception.msgpack")
    with open(path, "wb") as f:
        f.write(msgpack_serialize(jax_variables_from_torch(seeded_inception())))
    extract, kind = resolve_extractor({"inception_ckpt": path}, device=dev)
    check(kind == "inception_v3", f"metrics: extractor {kind}")
    g = torch.Generator(device=dev).manual_seed(11)
    shape = (METRIC_IMAGES, METRIC_RES, METRIC_RES, 3)
    real = torch.tanh(torch.randn(shape, generator=g, device=dev))
    fake = torch.tanh(1.3 * torch.randn(shape, generator=g, device=dev) + 0.1)
    model = load_inception_params(path, dev)
    with torch.no_grad():
        feats, ms["inception_128"] = _wall_ms(
            lambda: torch.cat([inception_pool_features(model, x) for x in (
                real[:32], real[32:], fake[:32], fake[32:])]), dev)
        want = inception_pool_features(load_inception_params(path, cpu),
                                       real[:METRIC_HOLD].cpu())
    e = _rel(feats[:METRIC_HOLD].cpu(), want)
    check(feats.shape == (2 * METRIC_IMAGES, 2048) and bool(torch.isfinite(feats).all())
          and e <= 1e-4, f"metrics: inception features {tuple(feats.shape)}, card vs CPU {e}")
    print(f"metrics inception[{2 * METRIC_IMAGES} x {METRIC_RES}^2 -> 299^2, seeded weights]: "
          f"{ms['inception_128']:.1f} ms ({ms['inception_128'] / (2 * METRIC_IMAGES):.2f} "
          f"ms an image), card vs CPU on {METRIC_HOLD} images max_rel_err {e:.3e} (tol 1e-4)")
    del model
    results = {}
    for tag, kw in (("inception_v3", {"extractor": extract}),
                    ("random_projection", {"device": dev})):
        for name, extra in (("fid", {}), ("kid", {}), ("pr50k", {})):
            out, t = _wall_ms(lambda: calc_metric(name, real_images=real, fake_images=fake,
                                                  **kw, **extra), dev)
            ms[f"{name} {tag}"] = t
            value = out["results"][name]
            vals = list(value.values()) if isinstance(value, dict) else [value]
            check(all(math.isfinite(v) for v in vals) and out["extractor"] == (
                "custom" if tag == "inception_v3" else "random_projection"),
                f"metrics: {name} {tag} {out}")
            results[f"{name} {tag}"] = value
            print(f"metrics {name}[{METRIC_IMAGES} + {METRIC_IMAGES} images, extractor "
                  f"{tag}, payload extractor {out['extractor']!r}, comparable_to_published "
                  f"{out['comparable_to_published']}]: {value} in {t:.1f} ms")
    del real, fake, feats
    # image metrics on frame pairs
    a = torch.tanh(torch.randn((METRIC_PAIRS, METRIC_RES, METRIC_RES, 3), generator=g,
                               device=dev))
    b = torch.clamp(a + 0.2 * torch.randn(a.shape, generator=g, device=dev), -1, 1)
    lp_tree = init_lpips_params()
    lp_dev, lp_cpu = lpips_weights_from_jax(lp_tree, dev), lpips_weights_from_jax(lp_tree, cpu)
    fns = {"psnr": image_metrics.psnr, "ssim": image_metrics.ssim,
           "lpips_surrogate": image_metrics.lpips_surrogate,
           "lpips_vgg": lambda x, y, w=None: lpips_vgg(w or lp_dev, x, y)}
    for name, fn in fns.items():
        with torch.no_grad():
            got, ms[name] = _wall_ms(lambda: fn(a, b), dev)
            got, ms[name] = _wall_ms(lambda: fn(a, b), dev)     # the first call warms cuDNN
            t = time.perf_counter()
            args = (a.cpu(), b.cpu())
            want = fn(*args, lp_cpu) if name == "lpips_vgg" else fn(*args)
            cpu_s = time.perf_counter() - t
        e = _rel(got.cpu(), want)
        check(got.shape == (METRIC_PAIRS,) and bool(torch.isfinite(got).all()) and e <= 1e-4,
              f"metrics {name}: {tuple(got.shape)}, card vs CPU {e}")
        print(f"metrics {name}[{METRIC_PAIRS} pairs of {METRIC_RES}^2]: mean "
              f"{float(got.mean()):.6f}, {ms[name]:.2f} ms, card vs CPU on every pair "
              f"max_rel_err {e:.3e} (tol 1e-4; the CPU's {cpu_s:.1f} s)")
    del a, b, lp_dev
    # PPL of the EG3D generator at full width, a fixed camera
    cfg = load_config(os.path.join(ROOT, "configs", EG3D_CONFIG), parse_overrides(ppl_hparams))
    task = EG3DTask(cfg, dev)
    gen = mock_init_(task.build_generator(), torch.Generator().manual_seed(0)).to(dev).eval()
    cam = torch.as_tensor(task.synthetic_batch(np.random.RandomState(0))["camera"][:1]).to(dev)

    def synth(z):
        return gen(z, cam.expand(z.shape[0], -1))["image"]

    out, ms["ppl"] = _wall_ms(lambda: calc_metric("ppl", synth_fn=synth, z_dim=gen.z_dim,
                                                  n_samples=PPL_SAMPLES, device=dev), dev)
    value = out["results"]["ppl"]
    check(math.isfinite(value) and value >= 0, f"metrics: ppl {out}")
    print(f"metrics ppl[configs/eg3d.yaml TriPlaneGenerator, full width, {PPL_SAMPLES} samples, "
          f"epsilon 1e-4, LPIPS surrogate]: {value:.6g} in {ms['ppl']:.1f} ms")
    print(f"metrics: {card_line()}")
    del task, gen
    torch.cuda.empty_cache()
    return ms


def phase_parity(dev: torch.device, out_dir: str) -> dict:
    """The port's parity tool, ``--selftest --device cuda`` at full width
    (``configs/real3d_orig.yaml``, 512^2, the ``reference`` 48+48 quadrature,
    4 frames, the preset delta): exit 0, pass, and the fixture frames
    rendered again bit-equal (PSNR at its 1e-12 MSE floor, which JAX's tool
    calls inf); every kernel of the released geometry's torso path
    launched. Returns the report."""
    from real3dportrait_tpu_torch.tools import eval_parity

    out = os.path.join(out_dir, "parity")
    reset_launches()
    rc, t = _wall_ms(lambda: eval_parity.main(["--selftest", "--device", str(dev), "--out",
                                               out]), dev)
    counts = read_launches()
    with open(os.path.join(out, "parity_report.json")) as f:
        report = json.load(f)
    rendered = np.load(os.path.join(out, "rendered_frames.npy"))
    ref = np.load(os.path.join(out, "fixtures", "ref_frames.npy"))
    diff = float(np.abs(rendered.astype(np.float64) - ref).max())
    delta = report["sampling_preset_delta"]
    print(f"parity selftest[configs/real3d_orig.yaml, {rendered.shape[1]}^2, reference 48+48, "
          f"{report['frames']} frames]: rc {rc}, pass {report['pass']}, psnr_mean "
          f"{report['psnr_mean']} (per frame {report['psnr_per_frame']}), lpips "
          f"{report['lpips_kind']} {report['lpips_mean']}, max |frame - fixture| {diff:g}; "
          f"fast vs reference: psnr mean {delta['psnr_fast_vs_reference_mean']} min "
          f"{delta['psnr_fast_vs_reference_min']}, lpips "
          f"{delta['lpips_fast_vs_reference_mean']}; {t / 1e3:.1f} s; {card_line()}")
    print(f"parity launches: { {k: counts[k] for k in PARITY_KERNELS} }")
    check(rc == 0 and report["pass"] and report["frames"] == 4,
          f"parity: rc {rc}, report {report}")
    check(diff == 0.0 and report["psnr_mean"] == PSNR_EXACT,
          f"parity: two renders from the same weights differ by {diff} (psnr "
          f"{report['psnr_mean']}): the card is not bit-reproducible here")
    check(all(counts[k] > 0 for k in PARITY_KERNELS), f"parity: launches {counts}")
    check(math.isfinite(delta["psnr_fast_vs_reference_mean"]), f"parity: delta {delta}")
    report["wall_s"] = t / 1e3
    return report


# each trained module of a stage's state and its optimiser
DDP_MODULES = {"gen": "opt_g", "disc": "opt_d", "model": "opt"}


def ddp_worker(spec_json: str) -> int:
    """One process of the ``ddp`` phase (``python3 chip_smoke.py --ddp-worker
    SPEC``, under ``torch.distributed.run`` or alone): with ``spec["gloo"]``
    the process joins its group over gloo first (two ranks sharing one
    card), and the trainer's join then only reports; then each of
    ``spec["runs"]`` (or ``spec`` itself) in turn, by ``ddp_run`` (by
    ``ray_cp_run`` for a run of ``kind`` "ray_cp")."""
    spec = json.loads(spec_json)
    set_fp32_policy()
    if spec.get("gloo"):
        import torch.distributed as dist

        dist.init_process_group("gloo", init_method="env://")
    for run in spec.get("runs", [spec]):
        (ray_cp_run if run.get("kind") == "ray_cp" else ddp_run)(run)
    return 0


def ddp_run(spec: dict) -> None:
    """``training.run``'s trainer (``run.make_trainer``, then ``fit``) on
    ``spec["argv"]``, the work dir under ``spec["root"]/rank<RANK>``; its
    draws recorded to ``records_out`` or replayed, split by rows where they
    divide over the data axis of ``mesh_shape`` (the world's processes
    without it), from ``records_in``; with ``full_mesh``, the SECC renderer on
    the 35,709-vertex morphable model (``full_mesh_renderer``); each step
    timed and its batch's rows kept (with ``step_sha1``, the parameters'
    sha1 taken after it); the launch counts set to 0 before ``fit`` and
    read after (less the noise probe's); with ``noise_probe``, the card's
    batch-size noise of the first step's generator gradients
    (``batch_size_noise``) taken before it; the parameters' change over
    the run, the first step's all-reduced gradients and that noise written
    to ``deltas_out`` by rank 0; a line
    ``ddp_worker {...}`` with the run's tag, the rank, ms/step, peak GiB,
    the global batch's rows and this rank's, the sha1s, the launches and whether the trainer reported a
    batch kept whole."""
    import hashlib

    from real3dportrait_tpu_torch.parallel.distributed import batch_rows
    from real3dportrait_tpu_torch.parallel.mesh import axis_sizes, mesh_coords
    from real3dportrait_tpu_torch.training import run as trun
    from real3dportrait_tpu_torch.training import trainer as tmod
    from real3dportrait_tpu_torch.utils.draws import RecordDraws, ReplayDraws, rank_records

    rank, world = int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1))
    seeded = tmod.seeded_draws
    if spec.get("records_in"):
        # a rank replays the rows of its coordinate on the mesh's data axis
        shape = axis_sizes(spec.get("mesh_shape"), world)
        draws = ReplayDraws(rank_records(torch.load(spec["records_in"]), shape.get("data", 1),
                                         mesh_coords(shape, rank).get("data", 0)))
        tmod.seeded_draws = lambda seed, device: draws
    elif spec.get("records_out"):
        draws = None

        def recording(seed, device):
            nonlocal draws
            draws = RecordDraws(seeded(seed, device))
            return draws
        tmod.seeded_draws = recording
    argv = spec["argv"] + ["--work_dir_root", os.path.join(spec["root"], f"rank{rank}")]
    trainer = trun.make_trainer(argv)
    task, init, times, rows, sha1s, local_rows = trainer.task, {}, [], [], [], []
    if spec.get("full_mesh"):
        full_mesh_renderer(task)
    start_fn, step_fn, batch_fn = trainer.init_or_restore, task.train_step, trainer.batch
    grads0: dict = {}

    def trained(st) -> dict:
        return {f"{m}.{n}": p for m in DDP_MODULES if getattr(st, m, None) is not None
                for n, p in getattr(st, m).named_parameters()}

    def start_and_keep(seed):
        st = start_fn(seed)
        init.update({k: p.detach().clone() for k, p in trained(st).items()})
        for m, o in DDP_MODULES.items():
            if getattr(st, m, None) is None:
                continue
            opt = getattr(st, o)

            def first(grads, _updates=opt.updates, _m=m):
                out = _updates(grads)       # the gradients, all-reduced in place
                if not any(k.startswith(f"{_m}.") for k in grads0):
                    grads0.update({f"{_m}.{n}": g.detach().cpu().clone()
                                   for n, g in grads.items()})
                return out
            opt.updates = first
        return st

    on_card = task.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def sha1_of(params: dict) -> str:
        h = hashlib.sha1()
        for k in sorted(params):
            h.update(params[k].detach().cpu().numpy().tobytes())
        return h.hexdigest()

    noise: dict = {}
    probe_launches: dict = {}

    def timed_step(state, batch, d):
        if spec.get("noise_probe") and not noise:
            before = PrepTimer._launches()
            noise.update(batch_size_noise(task, state, batch))
            probe_launches.update({k: v - before[k] for k, v in PrepTimer._launches().items()})
        sync()
        t = time.perf_counter()
        m = step_fn(state, batch, d)
        sync()
        times.append(1e3 * (time.perf_counter() - t))
        if spec.get("step_sha1"):
            sha1s.append(sha1_of(trained(state)))
        return m

    def rows_of(batch):
        rows.append(batch_rows(batch))
        local = batch_fn(batch)
        local_rows.append(batch_rows(local))
        return local

    trainer.init_or_restore, task.train_step, trainer.batch = start_and_keep, timed_step, rows_of
    if spec.get("no_save"):
        trainer.save = lambda *a, **k: None
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for w in train_wrappers().values():
        w.launches = 0
    state = trainer.fit()
    sync()
    # the run's own launches: the noise probe's are not the path's
    launches = {k: v - probe_launches.get(k, 0) for k, v in PrepTimer._launches().items()}
    tmod.seeded_draws = seeded
    if spec.get("records_in"):
        check(not draws.records, "ddp: a rank drew less than the single process")
    if spec.get("records_out"):
        torch.save(draws.records, spec["records_out"])
    deltas = {k: (p.detach() - init[k]).cpu() for k, p in trained(state).items()}
    if rank == 0:
        torch.save({"grads": grads0, "deltas": deltas, "noise": noise}, spec["deltas_out"])
    print("ddp_worker " + json.dumps({
        "run": spec.get("tag", ""), "rank": rank, "world": world, "device": str(task.device),
        "ms_per_step": times, "rows": rows, "local_rows": local_rows, "step_sha1": sha1s,
        "peak_gib": torch.cuda.max_memory_allocated(task.device) / 2 ** 30 if on_card else 0.0,
        "sha1": sha1_of(deltas), "launches": {k: v for k, v in launches.items() if v},
        "told_whole": trainer.told_whole}), flush=True)


def _ddp_launch(tag: str, nproc: int | None, spec: dict) -> list[dict]:
    """Run ``ddp_worker`` alone (``nproc`` None) or under
    ``torch.distributed.run --standalone --nproc_per_node nproc`` with a
    timeout; returns its ranks' ``ddp_worker`` lines (a line a rank and
    run), by run and rank."""
    cmd = [sys.executable] + (["-m", "torch.distributed.run", "--standalone",
                               f"--nproc_per_node={nproc}"] if nproc else []) + \
        [DDP_SCRIPT, "--ddp-worker", json.dumps(spec)]
    env = {k: v for k, v in os.environ.items() if k not in (
        "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=DDP_TIMEOUT, cwd=ROOT,
                          env=env)
    lines = [json.loads(line.split(" ", 1)[1]) for line in proc.stdout.splitlines()
             if line.startswith("ddp_worker ")]
    runs = [r.get("tag", "") for r in spec.get("runs", [spec])]
    check(proc.returncode == 0 and len(lines) == (nproc or 1) * len(runs),
          f"ddp {tag}: rc {proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return sorted(lines, key=lambda r: (runs.index(r["run"]), r["rank"]))


def _train_log(work_dir: str) -> list[dict]:
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _logs_agree(tag: str, got: list[dict], want: list[dict]) -> str:
    """Every logged value of every step, the losses, the loss lambdas and
    the gradient norms, at 1e-4 relative (the train phase's card-vs-CPU
    loss tolerance; in fp32 the norms read within 2.2e-6 on an H100); all
    printed before the check. Returns the worst of each kind, as text."""
    check([r["step"] for r in got] == [r["step"] for r in want], f"ddp {tag}: logged steps")
    worst = {}
    for g, w in zip(got, want):
        for k, v in w.items():
            if k not in ("step", "prefix", "steps_per_sec"):
                e = abs(g[k] - v) / max(abs(v), 1e-6) if math.isfinite(g[k]) else math.inf
                kind = "grad_norm" if k.endswith("grad_norm") else "loss"
                worst.setdefault(kind, []).append((e, f"step {w['step']} {k}"))
    text = "; ".join(f"{label} worst {max(es)[1]} {max(es)[0]:.3e} (tol {tol:g})"
                     for kind, label, tol in (("loss", "losses", 1e-4),
                                              ("grad_norm", "gradient norms", 1e-4))
                     for es in [worst.get(kind, [(0.0, "-")])])
    print(f"ddp {tag}: logged values: {text}")
    for kind, tol in (("loss", 1e-4), ("grad_norm", 1e-4)):
        bad = [f"{n} {e:.3e}" for e, n in worst.get(kind, []) if not e <= tol]
        check(not bad, f"ddp {tag}: {kind}s beyond {tol:g}: {bad}")
    return text


def _leaf_err(got: torch.Tensor, want: torch.Tensor, top: float) -> torch.Tensor:
    """|got - want| relative to ``want``'s largest magnitude floored at 1e-3
    of ``top`` (the largest of its tree)."""
    scale = max(float(want.abs().max()), 1e-3 * top, 1e-30)
    return (got.to(want.device).float() - want).abs() / scale


def _trees_agree(tag: str, what: str, got: dict, want: dict, tol: tuple = (5e-2, 1e-3),
                 share: float | None = None, floor: dict | None = None) -> str:
    """Each leaf of ``got`` (tensors by parameter name) against ``want``'s,
    relative to its largest magnitude floored at 1e-3 of the largest of all
    (the train phase's gradient rule and tolerance), all printed before the
    check: the worst leaf by max and by mean, and the number of elements
    past the max tolerance. With ``share``, the check is instead that at
    most that share of all elements is past the max tolerance. With
    ``floor`` ({name: (max, mean)}, the card's own batch-size noise of a
    leaf, ``batch_size_noise``), a leaf past the tolerance passes where it
    is within that noise, and is printed."""
    top = max(float(w.abs().max()) for w in want.values())
    rows, n_past, n_all = [], 0, 0
    for n, w in want.items():
        err = _leaf_err(got[n], w, top)
        n_past += int((err > tol[0]).sum())
        n_all += err.numel()
        rows.append((float(err.max()) if bool(torch.isfinite(got[n]).all()) else math.inf,
                     float(err.mean()), n))
    by_max, by_mean = max(rows), max(rows, key=lambda r: r[1])
    text = (f"worst by max {by_max[2]}: {by_max[0]:.3e}; worst by mean {by_mean[2]}: "
            f"{by_mean[1]:.3e}; {n_past} of {n_all} elements past {tol[0]:g} (tol {tol[0]:g} "
            f"/ {tol[1]:g})")
    print(f"ddp {tag}: {what} {text}")
    if share is not None:
        check(n_past <= share * n_all, f"ddp {tag}: {what}: {n_past} of {n_all} elements "
              f"past {tol[0]:g}, more than a share of {share:g}")
        return text
    past = [r for r in rows if not (r[0] <= tol[0] and r[1] <= tol[1])]
    floor = floor or {}
    bad = [r for r in past if not (r[0] <= max(tol[0], floor.get(r[2], (0.0, 0.0))[0]) and
                                   r[1] <= max(tol[1], floor.get(r[2], (0.0, 0.0))[1]))]
    for r in past:
        if r not in bad:
            print(f"ddp {tag}: {what} {r[2]} max {r[0]:.3e} mean {r[1]:.3e}, within the card's "
                  f"batch-size noise of the leaf (max {floor[r[2]][0]:.3e} mean "
                  f"{floor[r[2]][1]:.3e})")
    check(not bad, f"ddp {tag}: {what} beyond tolerance: {bad[:5]}")
    return text


def batch_size_noise(task, state, batch: dict) -> dict:
    """The card's own noise of a step-0 generator gradient between batch
    sizes: each row of the 2-row ``batch`` doubled (2 rows of the same
    data, the same draws) against the row alone, in exact arithmetic equal;
    by ``gen.<name>`` the larger over the rows of each leaf's (max, mean)
    relative difference (``_leaf_err``). A conv bias's gradient is a sum
    over the rows and pixels that cancels, so the card's choice of kernels
    for 1 row and for 2 moves it (``secc_img2plane_backbone.prenet.bias``:
    2.3e-3 of scale by mean on an H100)."""
    from real3dportrait_tpu_torch.utils.draws import RecordDraws, ReplayDraws, seeded_draws

    b = task._maybe_src2src(state.step, batch)
    rec = RecordDraws(seeded_draws(5, task.device))
    task.g_grads(state, b, rec)

    def grads(sel: list) -> dict:
        sub = {k: v[sel] if getattr(v, "ndim", 0) >= 1 and v.shape[0] == 2 else v
               for k, v in b.items()}
        draws = [(kind, torch.cat([v.chunk(2)[i] for i in sel]) if v.ndim and v.shape[0] > 1
                  and v.shape[0] % 2 == 0 else v) for kind, v in rec.records]
        return {k: g.detach() for k, g in task.g_grads(state, sub, ReplayDraws(draws))[3].items()}

    noise: dict = {}
    for i in (0, 1):
        alone, doubled = grads([i]), grads([i, i])
        top = max(float(w.abs().max()) for w in alone.values())
        for n, w in alone.items():
            e = _leaf_err(doubled[n], w, top)
            old = noise.get(f"gen.{n}", (0.0, 0.0))
            noise[f"gen.{n}"] = (max(old[0], float(e.max())), max(old[1], float(e.mean())))
    return noise


def phase_ddp(dev: torch.device, out_dir: str, hparams: str = DDP_HPARAMS) -> dict:
    """Data-parallel training of ``configs/secc_img2plane.yaml`` at full
    width, global batch 4, 2 steps, ``group_size_for_mini_batch_std`` 1, in
    fp32 (``DDP_HPARAMS``): (a) one rank under ``torch.distributed.run
    --nproc_per_node 1`` over NCCL (its draws recorded), against (a0) the
    same run with no launch; (b) two ranks on the one card over gloo (CUDA
    tensors), 2 + 2 rows, (a)'s draws replayed on each rank's rows, against
    (a). Each run goes through ``training.run``'s ``make_trainer`` and
    ``fit``. Held, with the train phase's tolerances: every logged loss
    and gradient norm (rank 0's log, the means over the ranks) at 1e-4
    relative; step 0's gradients after the all-reduce within 5e-2 max /
    1e-3 mean of each leaf's largest magnitude (floored at 1e-3 of the
    largest of all); the parameters' change over the steps, each leaf
    against its own change's scale, at most ``DDP_FLIP_SHARE`` of its
    elements past 5e-2 (the parameters themselves start equal, so this
    holds them after the steps); (b)'s two ranks bit-equal; rank 1's work
    dir holds no file, rank 0's its config, log and checkpoint. Prints
    ms/step and each rank's peak memory."""
    # (a) and (a0) on "cuda" (torchrun's LOCAL_RANK picks the card), (b) on
    # the one card named; on the CPU (a rehearsal) gloo throughout
    on_card = dev.type == "cuda"
    base = {"argv": ["--config", os.path.join(ROOT, "configs", TRAIN_CONFIG), "--exp_name",
                     "ddp"]}
    runs, deltas = {}, {}
    t0 = time.perf_counter()
    for tag, nproc, extra, spec in (
            ("a", 1, ["--device", dev.type, "--hparams", hparams],
             {"records_out": "a_draws.pt", "no_save": True}),
            ("a0", None, ["--device", dev.type, "--hparams", hparams], {"no_save": True}),
            ("b", 2, ["--device", str(dev), "--hparams", hparams],
             {"records_in": "a_draws.pt", "gloo": on_card})):
        spec = {**base, **{k: os.path.join(out_dir, v) if k.startswith("records") else v
                           for k, v in spec.items()},
                "root": os.path.join(out_dir, tag), "deltas_out": os.path.join(out_dir,
                                                                               f"{tag}.pt")}
        t = time.perf_counter()
        runs[tag] = _ddp_launch(tag, nproc, {**spec, "argv": spec["argv"] + extra})
        wall = time.perf_counter() - t
        deltas[tag] = torch.load(spec["deltas_out"])
        for r in runs[tag]:
            print(f"ddp {tag}[rank {r['rank']} of {r['world']}, {r['device']}]: ms/step "
                  f"{[round(x, 1) for x in r['ms_per_step']]}, peak {r['peak_gib']:.2f} GiB; "
                  f"process wall {wall:.1f} s")
    logs = {tag: _train_log(os.path.join(out_dir, tag, "rank0", "ddp")) for tag in runs}
    check(len(logs["a"]) == DDP_STEPS, f"ddp: logged {logs['a']}")
    check(runs["b"][0]["sha1"] == runs["b"][1]["sha1"], "ddp b: the ranks' parameters differ")
    rank1 = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(out_dir, "b", "rank1"))
             for f in fs]
    check(not rank1, f"ddp b: rank 1 wrote {rank1}")
    wrote = sorted(os.listdir(os.path.join(out_dir, "b", "rank0", "ddp")))
    check({"config.yaml", "metrics.jsonl", f"model_ckpt_steps_{DDP_STEPS}.ckpt"} <= set(wrote),
          f"ddp b: rank 0 wrote {wrote}")
    failed = []
    for tag, ref in (("a", "a0"), ("b", "a")):
        for fn, args in ((_logs_agree, (logs[tag], logs[ref])),
                         (_trees_agree, ("step 0 gradient", deltas[tag]["grads"],
                                         deltas[ref]["grads"])),
                         (functools.partial(_trees_agree, share=DDP_FLIP_SHARE),
                          ("parameter change", deltas[tag]["deltas"],
                           deltas[ref]["deltas"]))):
            try:
                fn(f"{tag} vs {ref}", *args)
            except AssertionError as e:     # print every comparison before failing
                failed.append(str(e))
    check(not failed, "; ".join(failed))
    print(f"ddp: rank 1 wrote no file; rank 0 wrote {wrote}; {time.perf_counter() - t0:.1f} s; "
          f"{card_line()}")
    del deltas
    out = {tag: [dict(rank=r["rank"], ms_per_step=r["ms_per_step"], peak_gib=r["peak_gib"])
                 for r in rs] for tag, rs in runs.items()}
    return {**out, **ddp_record_runs(dev, out_dir)}


def ddp_record_runs(dev: torch.device, out_dir: str) -> dict:
    """The ``ddp`` phase's record-store runs (``DDP_RECORD_HPARAMS``,
    ``DDP_A2M_HPARAMS``), each through ``training.run``'s trainer: one
    process with no launch (its draws recorded), then two ranks on the one
    card over gloo with those draws replayed (``rank_records``), each
    process running the SECC stage and then audio-to-motion. The SECC
    stage: both ranks prepare the same record batch of 2 rows (K4, 4
    launches a batch, on the 35,709-vertex model) and train their row;
    every kernel of the path launched on each rank, the ranks' parameters
    bit-equal, and held to the one process as ``phase_ddp`` holds (b) to
    (a), but that a step-0 gradient leaf past the tolerance passes within
    the card's own batch-size noise of that leaf, measured in the one
    process (``batch_size_noise``). Audio-to-motion: the buckets' rows 4, 3, 4, split, whole on each
    rank (the trainer says so), split; the ranks' parameters bit-equal
    after each step; held to the one process likewise. Prints K4's
    launches a rank, each step's rows and ms/step, and the runs' wall."""
    from real3dportrait_tpu_torch.data.binarizer import binarize, make_synthetic_records

    t0 = time.perf_counter()
    secc_store = seeded_store(os.path.join(out_dir, "secc"))
    a2m_store = os.path.join(out_dir, "a2m_store")
    recs = [r for i, (n, t) in enumerate(DDP_A2M_BUCKETS)
            for r in make_synthetic_records(n, t, seed=i)]
    for split in ("train", "val"):
        binarize(recs, os.path.join(a2m_store, split))
    stages = {"secc": (TRAIN_CONFIG, DDP_RECORD_HPARAMS + f",binary_data_dir={secc_store}",
                       {"full_mesh": True}),
              "a2m": (A2M_CONFIG, DDP_A2M_HPARAMS + f",binary_data_dir={a2m_store}",
                      {"step_sha1": True})}

    def specs(tag: str, device: str, draws: str) -> list[dict]:
        # the one process also measures the card's batch-size noise
        return [{"tag": name, "root": os.path.join(out_dir, tag, name), "no_save": True,
                 "deltas_out": os.path.join(out_dir, f"{tag}_{name}.pt"),
                 draws: os.path.join(out_dir, f"draws_{name}.pt"),
                 "noise_probe": name == "secc" and tag == "one",
                 "argv": ["--config", os.path.join(ROOT, "configs", cfg), "--exp_name",
                          f"ddp_{name}", "--device", device, "--hparams", hp], **extra}
                for name, (cfg, hp, extra) in stages.items()]

    walls, lines = {}, {}
    for tag, nproc, spec in (
            ("one", None, {"runs": specs("one", dev.type, "records_out")}),
            ("two", 2, {"runs": specs("two", str(dev), "records_in"),
                        "gloo": dev.type == "cuda"})):
        t = time.perf_counter()
        lines[tag] = _ddp_launch(f"records {tag}", nproc, spec)
        walls[tag] = time.perf_counter() - t
    runs = {f"records {tag} {name}": [r for r in rs if r["run"] == name]
            for tag, rs in lines.items() for name in stages}
    failed = []
    for name in stages:
        one, two = runs[f"records one {name}"], runs[f"records two {name}"]
        for r in one + two:
            how = ["split" if n % r["world"] == 0 and r["world"] > 1 else "whole"
                   for n in r["rows"]]
            print(f"ddp records {name}[rank {r['rank']} of {r['world']}, {r['device']}]: rows "
                  f"{r['rows']} ({', '.join(how)}), ms/step "
                  f"{[round(x, 1) for x in r['ms_per_step']]}, peak {r['peak_gib']:.2f} GiB, "
                  f"K4 launches {r['launches'].get('secc_raster', 0)}; launches "
                  f"{r['launches']}")
        check(two[0]["sha1"] == two[1]["sha1"], f"ddp records {name}: the ranks' parameters "
              "differ")
        check(all(r["rows"] == one[0]["rows"] for r in two), f"ddp records {name}: rows")
        logs = {k: _train_log(os.path.join(out_dir, k, name, "rank0", f"ddp_{name}"))
                for k in ("one", "two")}
        got, want = (torch.load(os.path.join(out_dir, f"{k}_{name}.pt")) for k in ("two", "one"))
        if want["noise"]:
            worst = max(want["noise"].items(), key=lambda kv: kv[1][1])
            print(f"ddp records {name}: the card's batch-size noise of the step 0 gradient, "
                  f"worst by mean {worst[0]}: max {worst[1][0]:.3e} mean {worst[1][1]:.3e}")
        for fn, args in ((_logs_agree, (logs["two"], logs["one"])),
                         (functools.partial(_trees_agree, floor=want["noise"]),
                          ("step 0 gradient", got["grads"], want["grads"])),
                         (functools.partial(_trees_agree, share=DDP_FLIP_SHARE),
                          ("parameter change", got["deltas"], want["deltas"]))):
            try:
                fn(f"records {name} two vs one", *args)
            except AssertionError as e:     # print every comparison before failing
                failed.append(str(e))
    secc, a2m = runs["records two secc"], runs["records two a2m"]
    for r in runs["records one secc"] + secc:
        check(r["rows"] == [2] * DDP_STEPS, f"ddp records secc: rows {r['rows']}")
        check(r["launches"].get("secc_raster") == PREP_RASTERS * DDP_STEPS,
              f"ddp records secc: K4 launches {r['launches'].get('secc_raster')}")
        check(all(r["launches"].get(k, 0) > 0 for k in DDP_RECORD_KERNELS),
              f"ddp records secc: launches {r['launches']}")
    for r in runs["records one a2m"] + a2m:
        check(r["rows"] == [4, 3, 4], f"ddp records a2m: rows {r['rows']}")
        check(not r["launches"], f"ddp records a2m: a kernel of the repo launched "
              f"{r['launches']}")
    check(len(a2m[0]["step_sha1"]) == DDP_A2M_STEPS and
          a2m[0]["step_sha1"] == a2m[1]["step_sha1"],
          "ddp records a2m: the ranks' parameters differ after a step")
    check(all(r["told_whole"] for r in a2m) and not runs["records one a2m"][0]["told_whole"],
          "ddp records a2m: the trainer did not report the whole batch")
    check(not failed, "; ".join(failed))
    print(f"ddp records: a2m ranks bit-equal after each of {DDP_A2M_STEPS} steps; process wall "
          f"one {walls['one']:.1f} s, two {walls['two']:.1f} s; {time.perf_counter() - t0:.1f} "
          f"s; {card_line()}")
    return {tag: [dict(rank=r["rank"], ms_per_step=r["ms_per_step"], peak_gib=r["peak_gib"],
                       launches=r["launches"]) for r in rs] for tag, rs in runs.items()}


def run_eval_phases(dev: torch.device) -> tuple[dict, dict, dict]:
    """The metrics, the parity tool and data-parallel training; prints
    each phase's wall seconds."""
    walls = {}
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        metrics = phase_metrics(dev, out_dir)
    torch.cuda.synchronize()
    walls["metrics"], t = time.perf_counter() - t, time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        parity = phase_parity(dev, out_dir)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    walls["parity"], t = time.perf_counter() - t, time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        ddp = phase_ddp(dev, out_dir)
    walls["ddp"] = time.perf_counter() - t
    print("eval phases wall s: " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    return metrics, parity, ddp


# -- 14: the last modules -------------------------------------------------------------

LAST_BATCH = 4
LAST_KERNELS = ("upfirdn2d", "upfirdn2d_backward", "bias_act", "bias_act_grad")


def phase_last_modules(dev: torch.device) -> dict:
    """The port's last modules at full width (see the module docstring,
    14): each model's wall ms (forward, or forward and backward; its first
    call, then a second, warm one) and the phase's peak memory with the
    card's line; every K6a and K6b call of the
    StyleGAN2 models held to the plain versions (``hold_calls``: K6b's
    forward and gradient with a [B,H,W] noise plane among them, fp32 and
    bf16); K6b's per-sample noise form timed per launch at the largest
    fp32 and bf16 calls, beside the bound (bytes) and the plain version.
    Returns {"launches": the phase's launches by kernel, "k6b_noise": the
    timing rows, "wall_ms": ..., "peak_gib": ...}."""
    from real3dportrait_tpu_torch.config import load_config
    from real3dportrait_tpu_torch.models.stylegan2 import Discriminator, Generator
    from real3dportrait_tpu_torch.models.superresolution import SuperresolutionHybrid4X
    from real3dportrait_tpu_torch.models.temporal_att import TemporalAttNet
    from real3dportrait_tpu_torch.models.torso import PatchDiscriminator
    from real3dportrait_tpu_torch.ops import bias_act as ba
    from real3dportrait_tpu_torch.utils.draws import seeded_draws

    cfg = load_config(os.path.join(ROOT, "configs", EG3D_CONFIG))
    z_dim, w_dim = int(cfg.get("z_dim", 512)), int(cfg.get("w_dim", 512))
    plane_res = int(cfg.get("teacher_plane_resolution", 256))
    hid = int(cfg.get("triplane_hid_dim", 32))
    base, cmax = int(cfg.get("base_channel", 32768)), int(cfg.get("max_channel", 512))
    b = LAST_BATCH
    torch.manual_seed(24)
    gen = torch.Generator(device=dev).manual_seed(24)

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    def strengthen(model):
        # the layers' noise strengths start at 0: make the noise count
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n.endswith("noise_strength"):
                    p.fill_(0.1)
        return model

    g = strengthen(Generator(z_dim, 25, w_dim, plane_res, 3 * hid,
                             mapping_layers=int(cfg.get("mapping_network_depth", 2)),
                             channel_base=base, channel_max=cmax)).to(dev)
    d = Discriminator(25, 512, 3, channel_base=base, channel_max=cmax, num_fp16_res=4).to(dev)
    sr = strengthen(SuperresolutionHybrid4X(hid, w_dim=w_dim)).to(dev)
    att = TemporalAttNet(3 * hid).to(dev)
    patch = PatchDiscriminator(num_keypoints=4).to(dev)
    z, c = randn(b, z_dim), randn(b, 25)
    walls, log = {}, CallLog()

    def twice(name, fn):
        """fn's result and wall ms, first call and warm (the second)."""
        out, walls[f"{name} first"] = _wall_ms(fn, dev)
        out, walls[name] = _wall_ms(fn, dev)
        return out
    reset_launches()
    for w in train_wrappers().values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with log:
        def gen_step():
            img = g(z, c, noise_mode="random", draws=seeded_draws(1, dev))
            (img.float().square().mean()).backward()
            return img
        img = twice("generator fwd+bwd", gen_step)
        check(img.shape == (b, plane_res, plane_res, 3 * hid) and bool(torch.isfinite(img).all())
              and all(p.grad is not None and torch.isfinite(p.grad).all()
                      for n, p in g.named_parameters() if n.endswith("noise_strength")),
              f"last_modules: generator image {tuple(img.shape)} or its noise gradients")

        def disc_r1():
            x = randn(b, 512, 512, 3).clamp(-1, 1).requires_grad_(True)
            logits = d(x, c)
            (gx,) = torch.autograd.grad(logits.sum(), x, create_graph=True)
            (gx.square().sum() + logits.sum()).backward()
            return logits, gx
        logits, gx = twice("discriminator R1 fwd+bwd", disc_r1)
        check(logits.shape == (b, 1) and bool(torch.isfinite(logits).all())
              and bool(torch.isfinite(gx).all()) and float(gx.detach().abs().max()) > 0,
              "last_modules: discriminator logits or R1's input gradient")

        def sr_step():
            out = sr(randn(b, 128, 128, 3), randn(b, 128, 128, hid), randn(b, 3, w_dim),
                     noise_mode="random", draws=seeded_draws(2, dev))
            out.float().square().mean().backward()
            return out
        out = twice("superresolution 4x fwd+bwd", sr_step)
        check(out.shape == (b, 256, 256, 3) and bool(torch.isfinite(out).all()),
              f"last_modules: SR 4x {tuple(out.shape)}")
    with torch.no_grad():
        win = randn(1, 5, plane_res, plane_res, 3 * hid)
        sm = twice("temporal att fwd", lambda: att(win))
        check(sm.shape == win.shape[:1] + win.shape[2:] and bool(torch.isfinite(sm).all())
              and float((sm - win.mean(1)).abs().max()) < float(win.abs().max()),
              "last_modules: temporal attention")
    kp = torch.rand((b, 4, 3), device=dev, generator=gen) * 2 - 1

    def patch_step():
        logit, feats = patch(randn(b, 512, 512, 3), kp)
        logit.square().mean().backward()
        return logit, feats
    logit, feats = twice("patch discriminator fwd+bwd", patch_step)
    check(logit.shape == (b, 64, 64, 1) and len(feats) == 4
          and bool(torch.isfinite(logit).all()), f"last_modules: patch D {tuple(logit.shape)}")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = read_launches()
    launches.update({k: w.launches for k, w in train_wrappers().items()})
    check(all(launches[k] > 0 for k in LAST_KERNELS) and launches["bias_act bf16"] > 0,
          f"last_modules: launches {launches}")
    per_sample = [cl for cl in log.calls["bias_act"]
                  if cl[3] is not None and len(_meta_shape(cl[3])) == 3]
    check(len({cl[0][2] for cl in per_sample}) == 2,
          f"last_modules: K6b calls with a noise plane per sample: {len(per_sample)}")
    print(f"last_modules ({card_line()}): " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in walls.items()) + f"; peak {peak:.2f} GiB; launches "
        + ", ".join(f"{k} {launches[k]}" for k in LAST_KERNELS) + f"; K6b calls with a "
        f"per-sample noise plane {len(per_sample)}")
    del g, d, sr, att, patch, img, logits, gx, out, sm, win, logit, feats
    torch.cuda.empty_cache()
    held = hold_calls(dev, log, "last_modules", 25)
    check(all(any(k.startswith(f"{name} {t}") for k in held) for name in (
        "upfirdn2d", "upfirdn2d_backward", "bias_act", "bias_act_grad")
        for t in ("fp32", "bf16")), f"last_modules: held {sorted(held)}")
    check(all(any("noise" in w and "[4," in w.split("noise")[1] for w in held[name][2])
              for name in held if name.startswith("bias_act")),
          "last_modules: no per-sample noise call held")

    # the per-sample noise form per launch at the largest fp32 and bf16
    # calls: x, the noise and y once (the noise a plane a sample), forward;
    # dy, y once, dx once and the sums (db [C], dnoise [B,H,W]), gradient
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        calls = [cl for cl in per_sample if cl[0][2] == dtype]
        cl = max(calls, key=lambda cl: math.prod(cl[0][1]))
        shape, (act, gain, clamp, axis) = cl[0][1], cl[4:8]
        x = (2 * randn(*shape)).to(dtype)
        noise, bias = 0.3 * randn(*_meta_shape(cl[3])), 0.3 * randn(shape[1])
        scale = torch.rand((shape[0], shape[1]), device=dev, generator=gen) + 0.5
        kw = dict(act=act, gain=gain, clamp=clamp, axis=axis, scale=scale)
        with torch.no_grad():
            fwd = lambda: ba.bias_act(x, bias, noise=noise, **kw)  # noqa: E731
            y = fwd()
            dy = randn(*shape).to(dtype)
            need = dict(need_b=True, need_scale=False, need_noise=True, noise_per_sample=True)
            grad = lambda: ba.bias_act_grad(dy, y, x, **kw, **need)  # noqa: E731
            gg = grad()
            for what, call, plain, n_bytes in (
                    ("forward", fwd, lambda: ba.bias_act_plain(x, bias, noise=noise, **kw),
                     nbytes(x, noise, y)),
                    ("gradient", grad, lambda: ba.bias_act_grad_plain(dy, y, x, **kw, **need),
                     nbytes(dy, y, gg[0], gg[1], gg[3]))):
                bound_ms, by = bound(n_bytes, 6 * x.numel(), dtype)
                rows[f"{what} {str(dtype)[6:]}"] = r = dict(
                    shape=list(shape), launch_ms=device_ms(call), ms=cuda_ms(call),
                    plain_ms=cuda_ms(plain), bound_ms=bound_ms, bound_by=by)
                print(f"last_modules K6b per-sample noise {what} {list(shape)} "
                      f"{str(dtype)[6:]}: per launch {r['launch_ms']:.4f} ms, per call "
                      f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
                      f"{bound_ms:.4f} ms ({by}) ({card_line()})")
        del x, noise, y, dy, gg
    torch.cuda.empty_cache()
    return dict(launches=launches, k6b_noise=rows, wall_ms=walls, peak_gib=peak)


# -- 15: the sampling study ----------------------------------------------------------

STUDY_RES = 128
STUDY_CHECK_RES = 32    # the card's study against the CPU's at this grid
# the port's subpackages (and its config module), whose exports must import here
PORT_SUBPACKAGES = ("audio", "config", "data", "geometry", "inference", "metrics", "models",
                    "ops", "parallel", "preprocess", "rendering", "training", "utils")


def phase_study(dev: torch.device) -> dict:
    """``tools/study_sampling.py`` at 128^2 on the card (see the module
    docstring, 15): every port subpackage's exports imported on this host;
    the study's table printed, with the launch counters from 0 (K2 once a
    scheme that marches the full grid's proposals, K3 once a merged scheme,
    no other kernel); its rows at 32^2 against the CPU's (PSNR within 0.05
    dB, depth MAE within 1e-4, the bounds its CPU test holds the JAX tool
    to); then every K2 and K3 call of the merged schemes, rebuilt from the
    same deterministic inputs (K3's rgb bit-equal to the study's, so they
    are its calls), against the plain versions at phase 3's tolerance,
    1e-4 absolute, K3 at C = 3 on its scalar path. Returns {"launches":
    the study's K2 and K3 launches, "k3_c3": K3's C = 3 timing rows,
    "wall_s": ...}."""
    import importlib

    from real3dportrait_tpu_torch.rendering import renderer as rr
    from real3dportrait_tpu_torch.tools import study_sampling as study

    t0 = time.perf_counter()
    n_names = 0
    for sub in PORT_SUBPACKAGES:
        mod = importlib.import_module(f"real3dportrait_tpu_torch.{sub}")
        for name in mod.__all__:
            check(getattr(mod, name) is not None, f"study: {sub}.{name}")
            n_names += 1
    check(not any(m == "jax" or m.startswith(("jax.", "flax", "real3dportrait_tpu."))
                  for m in sys.modules), "study: a JAX module is imported")
    print(f"study: {n_names} exports of {len(PORT_SUBPACKAGES)} port subpackages import here")

    reset_launches()
    rows = study.study(STUDY_RES, dev, keep=True)
    torch.cuda.synchronize()
    counts = read_launches()
    full_grid = [kw for _, kw in study.SCHEMES if kw.get("coarse_downsample", 1) == 1]
    merged = [kw for kw in full_grid if kw["mode"] == "merged"]
    want = {k: 0 for k in counts}
    want.update(importance_sample=len(full_grid), merge_composite=len(merged))
    check(counts == want, f"study: launches {counts}, want {want}")
    check(all(math.isfinite(r["psnr_gt"]) and math.isfinite(r["depth_mae"])
              and bool(torch.isfinite(r["rgb"]).all()) and bool(torch.isfinite(r["depth"]).all())
              and r["rgb"].shape == (1, STUDY_RES ** 2, 3) for r in rows)
          and rows[0]["psnr_ref"] == float("inf")
          and all(math.isfinite(r["psnr_ref"]) for r in rows[1:]), "study: rows not finite")

    small = study.study(STUDY_CHECK_RES, dev, log=lambda line: None)
    cpu = study.study(STUDY_CHECK_RES, "cpu", log=lambda line: None)
    worst = dict(psnr=0.0, mae=0.0)
    for g, c in zip(small, cpu):
        worst["psnr"] = max(worst["psnr"], abs(g["psnr_gt"] - c["psnr_gt"]),
                            0.0 if c is cpu[0] else abs(g["psnr_ref"] - c["psnr_ref"]))
        worst["mae"] = max(worst["mae"], abs(g["depth_mae"] - c["depth_mae"]))
    check(worst["psnr"] <= 0.05 and worst["mae"] <= 1e-4,
          f"study at {STUDY_CHECK_RES}^2: card vs CPU {worst}")
    print(f"study at {STUDY_CHECK_RES}^2, card vs CPU: PSNR within {worst['psnr']:.2e} dB, "
          f"depth MAE within {worst['mae']:.2e}")

    # the merged schemes' K2 and K3 calls, rebuilt
    rays = study.study_rays(STUDY_RES, dev)
    origins, dirs, ray_start, ray_end = rays
    m = origins.shape[1]
    errs = {"importance_sample": 0.0, "merge_composite": 0.0}
    k3_rows = {}
    with torch.no_grad():
        for (name, kw), row in zip(study.SCHEMES, rows):
            if kw["mode"] != "merged":
                continue
            depths_c = rr._stratified_depths(ray_start, ray_end, kw["n_coarse"])
            colors_c, dens_c = study.eval_field(origins, dirs, depths_c)
            u = rr.importance_u(m, kw["n_fine"], dev)
            fine = rr.importance_sample(depths_c, dens_c, u)
            errs["importance_sample"] = max(errs["importance_sample"], max_err(
                fine, rr.importance_sample_plain(depths_c, dens_c, u)))
            colors_f, dens_f = study.eval_field(origins, dirs, fine)
            args = (depths_c, colors_c, dens_c, fine, colors_f, dens_f)
            got, plain = rr.merge_composite(*args), rr.merge_composite_plain(*args)
            check(torch.equal(got[0], row["rgb"]), f"study: {name}'s K3 call not rebuilt")
            errs["merge_composite"] = max(errs["merge_composite"],
                                          *(max_err(k, p) for k, p in zip(got, plain)))
            if kw["n_coarse"] + kw["n_fine"] in (48, 96):
                c = kw["n_coarse"] + kw["n_fine"]
                bound_ms, by = bound(nbytes(*args, *got), m * c * (2 * 3 + 20), torch.float32)
                k3_rows[f"{kw['n_coarse']}+{kw['n_fine']}"] = r = dict(
                    launch_ms=device_ms(lambda: rr.merge_composite(*args)),
                    ms=cuda_ms(lambda: rr.merge_composite(*args)),
                    plain_ms=cuda_ms(lambda: rr.merge_composite_plain(*args)),
                    bound_ms=bound_ms, bound_by=by)
                print(f"study merge_composite[{m} rays {kw['n_coarse']}+{kw['n_fine']}, 3 "
                      f"channels, scalar path]: per launch {r['launch_ms']:.4f} ms, per call "
                      f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {bound_ms:.4f} "
                      f"ms ({by}) ({card_line()})")
    check(all(e <= 1e-4 for e in errs.values()), f"study: kernels vs plain {errs}")
    wall = time.perf_counter() - t0
    print(f"study: {len(merged)} merged schemes' K2 and K3 calls held, max_abs_err K2 "
          f"{errs['importance_sample']:.3e} K3 {errs['merge_composite']:.3e} (tol 1e-4); "
          f"launches {want['importance_sample']} K2, {want['merge_composite']} K3; phase wall "
          f"{wall:.1f} s ({card_line()})")
    return dict(launches={k: counts[k] for k in ("importance_sample", "merge_composite")},
                k3_c3=k3_rows, wall_s=wall)


# -- 16: ray context parallelism -----------------------------------------------------

RAY_CP_RES = 128
RAY_CP_KERNELS = ("trigrid_decode", "triplane_decode", "importance_sample", "merge_composite")
# the rays mesh's training step: global batch 2, one fp32 step (as ``ddp``)
RAY_CP_TRAIN_HPARAMS = DDP_HPARAMS.replace("batch_size=4", "batch_size=2").replace(
    f"max_updates={DDP_STEPS}", "max_updates=1")
RAY_CP_MESH = "{data: 1, rays: 2}"
# the wide camera: normalised focal length 1 (the frame camera's is 4.26)
# and the principal point at 0.8 of the height, so that the rows of the
# upper half (rank 0's block) pass beside the box and the lower half's
# partly hit it
RAY_CP_WIDE = (1.0, 0.8)


def rig_density(planes: torch.Tensor, decoder, seed: int = 0):
    """(planes, decoder) whose density reads feature 0 alone: the planes'
    feature 0 set to 2 +- 0.1 (seeded), a copy of the decoder with hidden
    unit 0 = softplus(8 f0 - 8) and density = 8.6 h0 - 25.6, about 43 where
    every sample lies inside the box and about -25 (alpha exactly 0) in
    the grids' zero padding outside it. Rays through the box composite;
    rays that miss it sum weights of exactly 0, and their depth takes the
    block's clamp."""
    import copy

    g = torch.Generator().manual_seed(seed)
    planes = planes.clone()
    planes[..., 0] = 2.0 + 0.1 * torch.randn(planes.shape[:-1], generator=g).to(planes.device)
    dec = copy.deepcopy(decoder)
    with torch.no_grad():
        for net, w, b in ((dec.net0, 8.0, -8.0), (dec.net1, 8.6, -25.6)):
            net.weight[0] = 0.0
            net.weight[0, 0] = w / net.weight_gain
            net.bias[0] = b / net.lr_multiplier
    return planes.contiguous(), dec


def ray_cp_inputs(dev: torch.device, **overrides) -> list[dict]:
    """The renders of the ``ray_cp`` phase: the default model's frame (its
    tri-grids from ``cal_plane_given_cano`` of a seeded 512^2 source and
    the SECC of the morphable model at zero pose, its decoder, its frame
    camera's 128^2 rays) at ``fast`` 16+32 and at 48+48, and the released
    geometry's tri-planes of the same source likewise at ``fast``; then
    the default model's tri-grids at ``fast`` under the wide camera
    (``RAY_CP_WIDE``), with its decoder and with ``rig_density``'s (cases
    with ``wide`` set)."""
    from real3dportrait_tpu_torch.geometry import camera
    from real3dportrait_tpu_torch.rendering.ray_sampler import sample_rays

    cases, wide = [], []
    for config, presets in ((DEFAULT_CONFIG, ("fast", "config")), (RELEASED_CONFIG, ("fast",))):
        pipe = make_pipeline(config, "fast", dev, use_torso=False, **overrides)
        m = pipe.model
        src, exp, _ = slice_inputs(pipe.res, 1)
        with torch.no_grad():
            img = torch.from_numpy(src[None].astype(np.float32) / 127.5 - 1.0).to(dev)
            zero = torch.zeros((1, 3), device=dev)
            secc = pipe.secc_renderer.render(pipe.fit_source(None)["id"], exp[:1].to(dev), zero,
                                             zero)[1]
            planes = m.cal_plane_given_cano(m.cal_cano_plane(img), torch.cat([secc] * 3, -1))
            _, c2w, intr = camera.convert_eg3d_convention(zero, zero)
            origins, dirs = sample_rays(c2w, intr, RAY_CP_RES)
        for preset in presets:
            n = (16, 32) if preset == "fast" else (48, 48)
            opts = m.render_options._replace(depth_resolution=n[0],
                                             depth_resolution_importance=n[1])
            name = f"{'default' if config == DEFAULT_CONFIG else 'released'} " \
                   f"{opts.depth_resolution}+{opts.depth_resolution_importance}"
            cases.append(dict(name=name, planes=planes.contiguous(), decoder=m.decoder,
                              origins=origins.contiguous(), dirs=dirs.contiguous(),
                              options=opts._asdict()))
        if config == DEFAULT_CONFIG:
            intr = intr.clone()
            intr[:, 0, 0] = intr[:, 1, 1] = RAY_CP_WIDE[0]
            intr[:, 1, 2] = RAY_CP_WIDE[1]
            origins, dirs = sample_rays(c2w, intr, RAY_CP_RES)
            base = dict(origins=origins.contiguous(), dirs=dirs.contiguous(), wide=True,
                        options=cases[0]["options"])
            wide += [dict(base, name="default 16+32 wide", planes=planes.contiguous(),
                          decoder=m.decoder),
                     dict(base, name="default 16+32 wide, density of feature 0",
                          **dict(zip(("planes", "decoder"), rig_density(planes, m.decoder))))]
        del pipe, m
    torch.cuda.empty_cache()
    return cases + wide


def frame_bounds(origins: torch.Tensor, dirs: torch.Tensor, box_warp: float):
    """The whole frame's fallback bounds of rays that miss the box (the
    least and the largest entry depth of the rays that hit it; 1e10 and
    -1e10 where none does), as the rays axis's MIN / MAX all-reduce gives
    them to every block."""
    from real3dportrait_tpu_torch.rendering import math_utils

    start, _, valid = math_utils.get_ray_limits_box(origins, dirs, box_warp)
    return (torch.where(valid[..., None], start, torch.full_like(start, 1e10)).min(),
            torch.where(valid[..., None], start, torch.full_like(start, -1e10)).max())


class FrameBounds:
    """The rays axis in one process, for a block rendered alone: its MIN /
    MAX all-reduce gives the whole frame's fallback bounds
    (``frame_bounds``), as the axis's processes together would."""

    def __init__(self, lo: torch.Tensor, hi: torch.Tensor):
        self.lo, self.hi = lo, hi

    def all_reduce(self, t: torch.Tensor, op, axis: str) -> torch.Tensor:
        import torch.distributed as dist

        return self.lo if op == dist.ReduceOp.MIN else self.hi


def ray_cp_calls(case: dict, block: slice, mesh_rgb: torch.Tensor) -> dict:
    """The kernel calls of ``render_rays`` on this process's ``block`` of
    the case's rays, rebuilt from its deterministic inputs (the fallback
    bounds from the whole set of rays, as the all-reduce gives them), each
    held to its plain version at ``phase_kernels``' tolerance, 1e-4
    absolute; K3's rgb must be bit-equal to ``mesh_rgb``, the sharded
    render's block, so that they are its calls. Returns the largest errors
    by kernel and the block's shapes."""
    from real3dportrait_tpu_torch.models.decoder import (
        trigrid_decode_plain, triplane_decode_plain)
    from real3dportrait_tpu_torch.rendering import math_utils
    from real3dportrait_tpu_torch.rendering import renderer as rr

    planes, dec, opts = case["planes"], case["decoder"], case["options"]
    o, d = case["origins"], case["dirs"]
    start, end, valid = math_utils.get_ray_limits_box(o, d, opts["box_warp"])
    lo, hi = frame_bounds(o, d, opts["box_warp"])
    ok = valid[:, block, None]
    start = torch.where(ok, start[:, block], lo)
    end = torch.where(ok, end[:, block], hi)
    o, d = o[:, block].contiguous(), d[:, block].contiguous()
    b, m = o.shape[:2]
    k1 = "trigrid_decode" if planes.dim() == 6 else "triplane_decode"
    plain = trigrid_decode_plain if planes.dim() == 6 else triplane_decode_plain
    errs = dict.fromkeys((k1, "importance_sample", "merge_composite"), 0.0)

    def decode(depths):
        coords = (o[:, :, None, :] + depths * d[:, :, None, :]).reshape(b, -1, 3)
        rgb, sigma = dec.decode_points(planes, coords, opts["box_warp"])
        p_rgb, p_sigma = plain(planes, coords, opts["box_warp"], dec)
        errs[k1] = max(errs[k1], max_err(rgb, p_rgb), max_err(sigma, p_sigma))
        n = depths.shape[2]
        return rgb.reshape(b, m, n, -1), sigma.reshape(b, m, n, 1)

    with torch.no_grad():
        depths_c = rr._stratified_depths(start, end, opts["depth_resolution"])
        colors_c, dens_c = decode(depths_c)
        u = rr.importance_u(b * m, opts["depth_resolution_importance"], o.device)
        fine = rr.importance_sample(depths_c, dens_c, u)
        errs["importance_sample"] = max_err(fine, rr.importance_sample_plain(depths_c, dens_c, u))
        colors_f, dens_f = decode(fine)
        args = (depths_c, colors_c, dens_c, fine, colors_f, dens_f, opts["white_back"])
        got, want = rr.merge_composite(*args), rr.merge_composite_plain(*args)
        errs["merge_composite"] = max(max_err(k, p) for k, p in zip(got, want))
    check(torch.equal(got[0], mesh_rgb), f"ray_cp {case['name']}: the rebuilt K3 call is not "
          "the sharded render's")
    check(all(e <= 1e-4 for e in errs.values()), f"ray_cp {case['name']}: kernels vs plain "
          f"{errs}")
    return dict(errs=errs, rays=m, samples=[opts["depth_resolution"],
                                            opts["depth_resolution_importance"]])


def ray_cp_run(spec: dict) -> None:
    """One rank of the ``ray_cp`` phase's render (``ddp_worker``, run
    ``kind`` "ray_cp"): each case of ``spec["inputs"]`` rendered on the
    mesh ``{"rays": -1}`` by ``render_rays_sharded`` (once to warm, then
    with the launch counters from 0, timed), the gathered outputs saved;
    then the kernels held at this rank's block (``ray_cp_calls``). Prints a
    line ``ddp_worker {...}`` with each case's wall ms, launches and
    errors."""
    from real3dportrait_tpu_torch.parallel import make_mesh
    from real3dportrait_tpu_torch.rendering.renderer import RenderOptions, render_rays_sharded

    dev = torch.device(spec["device"])
    rank, world = int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1))
    mesh = make_mesh({"rays": -1})
    cases = torch.load(spec["inputs"], map_location=dev, weights_only=False)
    out = {}
    for case in cases:
        opts = RenderOptions(**case["options"])
        args = (case["planes"], case["decoder"], case["origins"], case["dirs"], opts, mesh)
        with torch.no_grad():
            render_rays_sharded(*args)
            reset_launches()
            got, ms = _wall_ms(lambda: render_rays_sharded(*args), dev)
        counts = {k: read_launches()[k] for k in RAY_CP_KERNELS}
        torch.save({k: v.cpu() for k, v in got.items()},
                   os.path.join(spec["out_dir"], f"rank{rank}_{case['name']}.pt"))
        m = case["origins"].shape[1] // mesh.size("rays")
        block = slice(mesh.coord("rays") * m, (mesh.coord("rays") + 1) * m)
        held = ray_cp_calls(case, block, got["rgb"][:, block])
        out[case["name"]] = dict(ms=ms, launches=counts, **held)
    print("ddp_worker " + json.dumps({"run": spec["tag"], "rank": rank, "world": world,
                                      "coords": dict(mesh.coords), "cases": out}), flush=True)


def ray_cp_blocks(case: dict, n: int) -> dict:
    """The case's rays cut into ``n`` blocks as the rays axis cuts them,
    each rendered alone in this process with the whole frame's fallback
    bounds (``FrameBounds``; what each rank of the axis must compute),
    concatenated as "blocks"; the frame's bounds as "bounds" and each
    block's own (what it would take without the all-reduce) as "own"; and
    block 0 rendered with the lower half of the frame's interval, as
    "narrowed", to show whether the bounds reach its outputs. (Not with
    its own bounds: a block without a ray in the box has 1e10 and -1e10,
    an interval no render is meant to march.)"""
    from real3dportrait_tpu_torch.rendering.renderer import RenderOptions, render_rays

    o, d, opts = case["origins"], case["dirs"], RenderOptions(**case["options"])
    lo, hi = frame_bounds(o, d, opts.box_warp)
    m = o.shape[1] // n
    block = [(o[:, i * m:(i + 1) * m].contiguous(), d[:, i * m:(i + 1) * m].contiguous())
             for i in range(n)]
    with torch.no_grad():
        parts = [render_rays(case["planes"], case["decoder"], bo, bd, opts, axis_name="rays",
                             mesh=FrameBounds(lo, hi)) for bo, bd in block]
        narrowed = render_rays(case["planes"], case["decoder"], *block[0], opts,
                               axis_name="rays", mesh=FrameBounds(lo, (lo + hi) / 2))
    return dict(blocks={k: torch.cat([p[k] for p in parts], dim=1).cpu() for k in parts[0]},
                bounds=(float(lo), float(hi)),
                own=[tuple(float(x) for x in frame_bounds(bo, bd, opts.box_warp))
                     for bo, bd in block],
                narrowed={k: v.cpu() for k, v in narrowed.items()})


def ray_cp_wide_check(name: str, local: dict, ref: dict) -> None:
    """The wide camera's case really needs the all-reduce: rank 0's block
    has no ray in the box (its own bounds are 1e10 and -1e10, not the
    frame's) and rank 1's has rays in it and beside it; rank 0's block
    rendered with other bounds differs from its block of the sharded
    render on some output; with the density of feature 0, both blocks
    hold rays of zero weight, whose depths (each block's clamp) differ
    from the unsharded render's."""
    blocks, m = local["blocks"], ref["rgb"].shape[1] // 2
    valid = blocks["is_ray_valid"][0]
    check(not valid[:m].any() and valid[m:].any() and not valid[m:].all(),
          f"ray_cp {name}: rays in the box by block {int(valid[:m].sum())}, "
          f"{int(valid[m:].sum())} of {m}")
    check(local["own"][0] == (1e10, -1e10) != local["bounds"],
          f"ray_cp {name}: bounds {local['bounds']}, rank 0's own {local['own'][0]}")
    differs = [k for k in blocks if not torch.equal(local["narrowed"][k], blocks[k][:, :m])]
    check(differs, f"ray_cp {name}: rank 0's block does not depend on the fallback bounds")
    zero = blocks["weights_sum"][0, :, 0] == 0
    line = (f"ray_cp {name}: rays in the box {int(valid[:m].sum())} and {int(valid[m:].sum())} "
            f"of {m} by block; the frame's fallback bounds {local['bounds']}, rank 0's own "
            f"{local['own'][0]}, rank 1's {local['own'][1]}; rank 0's block with the lower "
            f"half of the frame's interval differs on {differs}; rays of zero weight "
            f"{int(zero[:m].sum())} and {int(zero[m:].sum())} by block")
    if "density" in name:
        check(bool(zero[:m].any() and zero[m:].any()), line)
        moved = int((blocks["depth"][0, zero] != ref["depth"][0, zero]).sum())
        check(moved > 0, f"ray_cp {name}: the zero-weight rays' depths are the unsharded "
              "render's")
        line += f", {moved} of whose depths (the block's clamp) differ from the unsharded render"
    print(line)


def ray_cp_nccl(cases: list[dict], want: dict, dev: torch.device) -> None:
    """A one-rank NCCL world in this process: the first case rendered on
    ``{"rays": -1}``, whose all-reduce and all-gather then go through NCCL,
    bit-equal to the unsharded render; the group is left after."""
    import socket

    import torch.distributed as dist

    from real3dportrait_tpu_torch.parallel import make_mesh
    from real3dportrait_tpu_torch.rendering.renderer import RenderOptions, render_rays_sharded

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        mesh = make_mesh({"rays": -1})
        check(dist.get_backend(mesh.group("rays")) == "nccl", "ray_cp nccl: not an NCCL group")
        case = cases[0]
        with torch.no_grad():
            got = render_rays_sharded(case["planes"], case["decoder"], case["origins"],
                                      case["dirs"], RenderOptions(**case["options"]), mesh)
        torch.cuda.synchronize(dev)
        for k, v in want[case["name"]].items():
            check(torch.equal(got[k], v), f"ray_cp nccl {case['name']}: {k} differs from the "
                  "unsharded render")
        print(f"ray_cp nccl[{case['name']}, one rank]: bit-equal to the unsharded render")
    finally:
        dist.destroy_process_group()


def phase_ray_cp(dev: torch.device, out_dir: str, hparams: str = RAY_CP_TRAIN_HPARAMS,
                 **overrides) -> dict:
    """The mesh's ``rays`` axis (see the module docstring, 16): the renders
    of ``ray_cp_inputs`` unsharded in this process, then on two gloo ranks
    sharing the card (``ray_cp_run``), whose gathered ``rgb``,
    ``weights_sum`` and ``is_ray_valid`` must be bit-equal to the
    unsharded render's, and ``depth`` wherever the weights are not 0 (a
    ray of zero weight takes its rank's own bound, as in JAX; their count
    is printed), and every output bit-equal to the blocks rendered alone
    in this process with the whole frame's bounds (``ray_cp_blocks``; for
    the wide camera's cases, ``ray_cp_wide_check`` shows that these bounds
    decide rank 0's block), with K1-trigrid, K1, K2 and K3 launched on each
    rank and held to their plain versions at the rank's block; a one-rank
    NCCL world (``ray_cp_nccl``); then one training step of
    ``configs/secc_img2plane.yaml`` at ``mesh_shape={data: 1, rays: 2}``
    on the two gloo ranks (each training the whole batch of 2), held to
    one process as ``phase_ddp`` holds (b) to (a), with the card's
    batch-size noise as the floor (``hparams``; ``overrides``: the models'
    config overrides, for a rehearsal at a small size). Returns
    {"launches_per_rank": by kernel, rank 0's over the renders, "wall_s":
    ...}."""
    from real3dportrait_tpu_torch.rendering.renderer import RenderOptions, render_rays

    t0 = time.perf_counter()
    cases = ray_cp_inputs(dev, **overrides)
    want, ms, local = {}, {}, {}
    for case in cases:
        with torch.no_grad():
            args = (case["planes"], case["decoder"], case["origins"], case["dirs"],
                    RenderOptions(**case["options"]))
            render_rays(*args)
            want[case["name"]], ms[case["name"]] = _wall_ms(lambda: render_rays(*args), dev)
            local[case["name"]] = ray_cp_blocks(case, 2)
    inputs = os.path.join(out_dir, "ray_cp_inputs.pt")
    torch.save(cases, inputs)

    # the one process's training step (its draws recorded, the card's
    # batch-size noise measured), in this process
    train = {"argv": ["--config", os.path.join(ROOT, "configs", TRAIN_CONFIG), "--exp_name",
                      "ray_cp", "--device", str(dev), "--hparams", hparams],
             "no_save": True, "noise_probe": True, "tag": "train"}
    ddp_run({**train, "root": os.path.join(out_dir, "one"), "records_out":
             os.path.join(out_dir, "ray_cp_draws.pt"), "deltas_out":
             os.path.join(out_dir, "ray_cp_one.pt")})
    torch.cuda.empty_cache()
    t = time.perf_counter()
    lines = _ddp_launch("ray_cp", 2, {"gloo": True, "runs": [
        {"kind": "ray_cp", "tag": "render", "inputs": inputs, "out_dir": out_dir,
         "device": str(dev)},
        {**train, "noise_probe": False, "root": os.path.join(out_dir, "two"),
         "mesh_shape": {"data": 1, "rays": 2},
         "argv": train["argv"][:-1] + [hparams + f",mesh_shape={RAY_CP_MESH}"],
         "records_in": os.path.join(out_dir, "ray_cp_draws.pt"),
         "deltas_out": os.path.join(out_dir, "ray_cp_two.pt")}]})
    ranks_wall = time.perf_counter() - t
    renders = [r for r in lines if r["run"] == "render"]
    check([r["coords"] for r in renders] == [{"rays": 0}, {"rays": 1}],
          f"ray_cp: coordinates {[r['coords'] for r in renders]}")
    for case in cases:
        name = case["name"]
        for r in renders:
            got = torch.load(os.path.join(out_dir, f"rank{r['rank']}_{name}.pt"))
            ref = {k: v.cpu() for k, v in want[name].items()}
            for k in ("rgb", "weights_sum", "is_ray_valid"):
                check(torch.equal(got[k], ref[k]), f"ray_cp {name} rank {r['rank']}: {k} "
                      f"differs from the unsharded render by {max_err(got[k], ref[k])}")
            weighted = ref["weights_sum"] != 0
            check(torch.equal(got["depth"][weighted], ref["depth"][weighted]),
                  f"ray_cp {name} rank {r['rank']}: depth differs where the weights are not 0")
            for k, v in local[name]["blocks"].items():
                check(torch.equal(got[k], v), f"ray_cp {name} rank {r['rank']}: {k} differs "
                      "from the blocks rendered alone with the whole frame's bounds")
            c = r["cases"][name]
            check(all(c["launches"][k] > 0 for k in (
                "trigrid_decode" if case["planes"].dim() == 6 else "triplane_decode",
                "importance_sample", "merge_composite")), f"ray_cp {name}: launches {c}")
            print(f"ray_cp {name}[rank {r['rank']} of 2, {c['rays']} rays, "
                  f"{c['samples'][0]}+{c['samples'][1]}]: sharded render wall {c['ms']:.2f} ms "
                  f"(unsharded {ms[name]:.2f} ms in one process); launches {c['launches']}; "
                  f"kernels vs plain at the block {c['errs']} (tol 1e-4)")
        own = int((~weighted).sum())
        print(f"ray_cp {name}: gathered rgb, weights_sum, is_ray_valid bit-equal to the "
              f"unsharded render on both ranks; depth bit-equal on the "
              f"{int(weighted.sum())} rays of nonzero weight; {own} rays of zero weight take "
              f"their rank's own bound; {int((~ref['is_ray_valid']).sum())} rays miss the box; "
              f"every output bit-equal to the blocks rendered alone with the frame's bounds")
        if case.get("wide"):
            ray_cp_wide_check(name, local[name], ref)
    ray_cp_nccl(cases, want, dev)
    del cases, want, local

    # the rays mesh's training step against the one process
    two = [r for r in lines if r["run"] == "train"]
    check(two[0]["sha1"] == two[1]["sha1"], "ray_cp train: the ranks' parameters differ")
    # each rank trains the whole global batch (replicated over rays)
    check(all(r["rows"] == r["local_rows"] == [2] for r in two)
          and not any(r["told_whole"] for r in two),
          f"ray_cp train: rows {[(r['rows'], r['local_rows']) for r in two]}")
    logs = {k: _train_log(os.path.join(out_dir, k, "rank0", "ray_cp")) for k in ("one", "two")}
    got, ref = (torch.load(os.path.join(out_dir, f"ray_cp_{k}.pt")) for k in ("two", "one"))
    failed = []
    for fn, args in ((_logs_agree, (logs["two"], logs["one"])),
                     (functools.partial(_trees_agree, floor=ref["noise"]),
                      ("step 0 gradient", got["grads"], ref["grads"])),
                     (functools.partial(_trees_agree, share=DDP_FLIP_SHARE),
                      ("parameter change", got["deltas"], ref["deltas"]))):
        try:
            fn("ray_cp train rays mesh vs one", *args)
        except AssertionError as e:     # print every comparison before failing
            failed.append(str(e))
    check(not failed, "; ".join(failed))
    for r in two:
        print(f"ray_cp train[rank {r['rank']} of 2, mesh_shape {RAY_CP_MESH}]: rows "
              f"{r['local_rows']} of {r['rows']}, ms/step {[round(x, 1) for x in r['ms_per_step']]}, peak "
              f"{r['peak_gib']:.2f} GiB")
    wall = time.perf_counter() - t0
    launches = {k: sum(c["launches"][k] for c in renders[0]["cases"].values())
                for k in RAY_CP_KERNELS}
    print(f"ray_cp: two ranks' processes {ranks_wall:.1f} s; phase wall {wall:.1f} s; "
          f"launches a rank over the renders {launches} ({card_line()})")
    return dict(launches_per_rank=launches, wall_s=wall)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    check(torch.cuda.device_count() == 1,
          f"chip_smoke uses one card; {torch.cuda.device_count()} are visible "
          f"(CUDA_VISIBLE_DEVICES={os.environ['CUDA_VISIBLE_DEVICES']})")
    dev = torch.device("cuda", 0)
    set_fp32_policy()

    t0 = time.perf_counter()
    phase_toolchain()
    phase_build()
    torch.cuda.synchronize()
    rows = phase_kernels(dev)
    torch.cuda.synchronize()
    batch_rows = phase_batch_kernels(dev)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as out_dir:
        run_counts = phase_run(dev, out_dir)
        torch.cuda.synchronize()
        phase_batch(dev, out_dir)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as out_dir:
        phase_fit(dev, out_dir)
        torch.cuda.synchronize()
        video_counts = phase_video(dev, out_dir)
    torch.cuda.synchronize()
    phase_server(dev)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as out_dir:
        phase_checkpoint(dev, out_dir)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as out_dir:
        convert_counts = phase_convert(dev, out_dir)
    torch.cuda.synchronize()
    slice_counts = phase_slice(dev)
    torch.cuda.synchronize()
    phase_flagship(dev)
    torch.cuda.synchronize()
    phase_reference(dev)
    torch.cuda.synchronize()
    train_counts, torso_counts, tri_counts, orig_counts, train_rows = run_train_phases(dev)
    rec_counts, sync, a2m = run_records_phases(dev)
    eg3d_counts, i2p_counts = run_teacher_phases(dev)
    metric_ms, parity, ddp = run_eval_phases(dev)
    t_last = time.perf_counter()
    last = phase_last_modules(dev)
    print(f"last_modules wall s: {time.perf_counter() - t_last:.1f}")
    torch.cuda.synchronize()
    study_out = phase_study(dev)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as out_dir:
        ray_cp = phase_ray_cp(dev, out_dir)
    print(f"train summary: flagship {train_counts['ms_per_step']:.1f} ms/step, peak "
          f"{train_counts['peak_gib']:.2f} GiB; torso {torso_counts['ms_per_step']:.1f} ms/step, "
          f"peak {torso_counts['peak_gib']:.2f} GiB; tri-plane {tri_counts['ms_per_step']:.1f} "
          f"ms/step, peak {tri_counts['peak_gib']:.2f} GiB; tri-plane torso "
          f"{orig_counts['ms_per_step']:.1f} ms/step, peak {orig_counts['peak_gib']:.2f} GiB; "
          + "; ".join(
              f"{k} launch {r['launch_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {r['launch_ms'] / r['bound_ms']:.2f}x"
              for k, r in train_rows.items()))
    print(f"records summary: train_records {rec_counts['ms_per_step']:.1f} ms/step + batch "
          f"preparation {rec_counts['prep_ms']:.1f} ms, peak {rec_counts['peak_gib']:.2f} GiB, "
          f"K4 {rec_counts['prep_k4_per_step']:g} launches a batch in preparation; "
          f"train_syncnet {sync['ms_per_step']:.1f} ms/step, mining {sync['mining_ms']:.1f} ms, "
          f"peak {sync['peak_gib']:.2f} GiB")
    print(f"last stages summary: train_a2m {a2m['ms_per_step']:.1f} ms/step, peak "
          f"{a2m['peak_gib']:.2f} GiB; train_eg3d {eg3d_counts['ms_per_step']:.1f} ms/step, peak "
          f"{eg3d_counts['peak_gib']:.2f} GiB; train_img2plane {i2p_counts['ms_per_step']:.1f} "
          f"ms/step, peak {i2p_counts['peak_gib']:.2f} GiB")
    print(f"eval summary: inception {metric_ms['inception_128']:.1f} ms for "
          f"{2 * METRIC_IMAGES} images, lpips_vgg {metric_ms['lpips_vgg']:.1f} ms for "
          f"{METRIC_PAIRS} pairs, ppl {metric_ms['ppl']:.1f} ms; parity selftest psnr "
          f"{parity['psnr_mean']}, fast vs reference "
          f"{parity['sampling_preset_delta']['psnr_fast_vs_reference_mean']} dB, "
          f"{parity['wall_s']:.1f} s; ddp ms/step (the last step) " + "; ".join(
              f"{tag} rank {r['rank']} {r['ms_per_step'][-1]:.1f}, peak "
              f"{r['peak_gib']:.2f} GiB" for tag, rs in ddp.items() for r in rs))
    print("eval metric ms: " + ", ".join(f"{k} {v:.1f}" for k, v in metric_ms.items()))
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    check(set(rows) == set(REPLACES), f"kernels measured: {sorted(rows)}")
    # each kernel's launches on the main path (run); K1, which the default
    # model does not run, from the released torso slice at fast
    launches = {}
    for k in REPLACES:
        path, counts = "run", run_counts
        if counts[k] == 0:
            path, counts = "released torso fast", slice_counts["released torso fast"]
        launches[k] = dict(launches=counts[k], path=path, video_run_launches=video_counts[k],
                           convert_run_launches=convert_counts[k],
                           **{f"fb8_{m}": batch_rows[k][m] for m in (
                               "launch_ms", "b1_launch_ms", "bound_ms", "max_abs_err")})
        if k in BF16_COUNTED:
            launches[k]["launches_bf16"] = counts[f"{k} bf16"]
    check(all(v["launches"] > 0 for v in launches.values()), f"kernels launched: {launches}")
    for k in ("trigrid_decode", "importance_sample", "merge_composite", "upfirdn2d",
              "bias_act"):
        launches[k]["train_launches_per_step"] = train_counts[k] / TRAIN_STEPS
    for k in ("torso_deform_input", "torso_warp_volume", "conv3d", "mfe_tail"):
        launches[k]["train_torso_launches_per_step"] = torso_counts[k] / TORSO_STEPS
        launches[k]["train_torso_orig_launches_per_step"] = orig_counts[k] / TORSO_ORIG_STEPS
    launches["triplane_decode"]["train_triplane_launches_per_step"] = \
        tri_counts["triplane_decode"] / TRIPLANE_STEPS
    # the records run: K4 in batch preparation, the step's kernels in its steps
    launches["secc_raster"]["train_records_launches_per_step"] = rec_counts["prep_k4_per_step"]
    for k in ("trigrid_decode", "importance_sample", "merge_composite", "upfirdn2d",
              "bias_act"):
        launches[k]["train_records_launches_per_step"] = \
            rec_counts["step_launches"][k] / RECORDS_STEPS
    kernels_json = [dict(name=k, route="cuda", source=SOURCES[k], replaces=REPLACES[k],
                         **launches[k], **rows[k]) for k in REPLACES]
    kernels_json += [dict(train_row(k, f, train_counts, train_rows, TRAIN_STEPS, "train run"),
                          train_records_launches_per_step=rec_counts["step_launches"][k]
                          / RECORDS_STEPS)
                     for k, f in TRAIN_KERNELS.items()]
    kernels_json += [dict(train_row(k, f, torso_counts, train_rows, TORSO_STEPS,
                                    "train_torso run"),
                          train_torso_orig_launches_per_step=orig_counts[k] / TORSO_ORIG_STEPS)
                     for k, f in TORSO_KERNELS.items()]
    kernels_json += [train_row(k, f, tri_counts, train_rows, TRIPLANE_STEPS,
                               "train_triplane run") for k, f in TRIPLANE_KERNELS.items()]
    # the EG3D and img2plane stages' launches a step, forward and backward
    for entry in kernels_json:
        for key, counts, steps in (("train_eg3d", eg3d_counts, EG3D_STEPS),
                                   ("train_img2plane", i2p_counts, I2P_STEPS)):
            if counts.get(entry["name"], 0) > 0:
                entry[f"{key}_launches_per_step"] = counts[entry["name"]] / steps
    check(all(any(f"{key}_launches_per_step" in e for e in kernels_json)
              for key in ("train_eg3d", "train_img2plane")), "the last stages' launches")
    # the last modules' launches (StyleGAN2 Generator, Discriminator, SR 4x)
    for entry in kernels_json:
        if entry["name"] in LAST_KERNELS:
            entry["last_modules_launches"] = last["launches"][entry["name"]]
    for entry in kernels_json:
        if entry["name"] == "bias_act":
            entry["per_sample_noise"] = last["k6b_noise"]
    # the sampling study's launches at 128^2, and K3's C = 3 calls timed
    for entry in kernels_json:
        if entry["name"] in study_out["launches"]:
            entry["study_launches"] = study_out["launches"][entry["name"]]
        if entry["name"] == "merge_composite":
            entry["study_c3"] = study_out["k3_c3"]
    # the data-parallel SECC stage from a record store: each kernel's
    # launches on rank 0 of two over the run's steps (K4 in preparation)
    for entry in kernels_json:
        n = ddp["records two secc"][0]["launches"].get(entry["name"], 0)
        if n:
            entry["ddp_records_launches_per_rank"] = n
    # the sharded render's launches on each of two ranks (rays mesh)
    for entry in kernels_json:
        if entry["name"] in RAY_CP_KERNELS:
            entry["ray_cp_launches_per_rank"] = ray_cp["launches_per_rank"][entry["name"]]
    check(all(ray_cp["launches_per_rank"][k] > 0 for k in RAY_CP_KERNELS),
          f"ray_cp launches {ray_cp['launches_per_rank']}")
    print(json.dumps({"kernels": kernels_json}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-worker"]:
        sys.exit(ddp_worker(sys.argv[2]))
    sys.exit(main())

"""The port's 3DMM fitting and video-driven path against the JAX package on
the CPU: optax's Adam step, short fits of one frame and of a smoothed
sequence, the full fit's pose recovery, the naive landmark extractor and
its template, the video decoder, segmentation, blinks and audio features
of the preprocessing pipeline, ``process_video_to_record``, the fitted
motion of driving landmarks and of a driving video, a tiny ``run`` from
source landmarks and a tiny video-driven ``run``, and the CLI with .mp4
drivers. Landmarks come from the synthetic morphable model at seeded
coefficients; driving videos are a face blob drifting sideways, written by
cv2 into the test's directory (their tests skip where cv2 has no mp4
encoder, as the JAX package's do)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from real3dportrait_tpu.geometry import face3d_helper as jf3d
from real3dportrait_tpu.geometry import synthetic_bfm as jax_synthetic_bfm
from real3dportrait_tpu.geometry.fit_3dmm import fit_coeffs as jax_fit_coeffs
from real3dportrait_tpu.inference import infer_utils as jiu
from real3dportrait_tpu.preprocess import pipeline as jprep
from real3dportrait_tpu_torch.geometry import face3d_helper
from real3dportrait_tpu_torch.geometry.bfm import synthetic_bfm
from real3dportrait_tpu_torch.geometry.fit_3dmm import adam_update, fit_coeffs
from real3dportrait_tpu_torch.inference import infer_utils
from real3dportrait_tpu_torch.preprocess import pipeline as prep
from tests._torch_parity import agree, t
from tests.test_torch_audio import chirp_wav
from tests.test_torch_run import ROOT, SMALL, pipelines  # noqa: F401  (a fixture)

torch.set_num_threads(1)

COEFFS = ("id", "exp", "euler", "trans")


def seeded_landmarks(jassets, n_frames: int, seed: int) -> np.ndarray:
    """[T,68,2] landmarks of the synthetic model at seeded coefficients:
    one identity, a pose drifting smoothly, small expressions."""
    rng = np.random.RandomState(seed)
    idc = np.tile(rng.randn(1, 80).astype(np.float32) * 0.3, (n_frames, 1))
    exp = (rng.randn(n_frames, 64) * 0.2).astype(np.float32)
    phase = np.linspace(0, 1, n_frames, dtype=np.float32)[:, None]
    euler = (rng.uniform(-0.1, 0.1, (1, 3)) + 0.05 * np.sin(3 * phase)).astype(np.float32)
    trans = (rng.uniform(-0.05, 0.05, (1, 3)) + 0.03 * phase).astype(np.float32)
    return np.asarray(jf3d.reconstruct_lm2d(jassets, *map(jnp.asarray, (idc, exp, euler, trans))))


def drifting_face_frames(n_frames: int = 12, size: int = 64) -> np.ndarray:
    """[T,size,size,3] uint8 RGB: a face disc in the face band drifting
    sideways and a body block below (the JAX package's driving video)."""
    import cv2

    frames = np.zeros((n_frames, size, size, 3), np.uint8)
    for i in range(n_frames):
        cx = size // 2 + int(6 * np.sin(2 * np.pi * i / n_frames))
        cv2.circle(frames[i], (cx, int(size * 0.35)), size // 6, (150, 170, 200), -1)
        cv2.rectangle(frames[i], (cx - size // 4, int(size * 0.6)), (cx + size // 4, size - 1),
                      (160, 90, 90), -1)
    return frames


def write_mp4(path, frames: np.ndarray) -> bool:
    """``frames`` (RGB) as an mp4v file; False where cv2 has no encoder."""
    import cv2

    h, w = frames.shape[1:3]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25, (w, h))
    if not vw.isOpened():
        return False
    for f in frames:
        vw.write(np.ascontiguousarray(f[..., ::-1]))
    vw.release()
    return True


def fits_agree(got, want, what: str) -> None:
    """Coefficients of two full fits (200 + 200 Adam steps) of the same
    landmarks: fp32 gradients summed in another order move a few weakly
    held expression directions by up to ~2e-3 after 400 steps (scale
    0.03-0.12), so 5e-3 max and 5e-4 mean, absolute."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    err = np.abs(got - want)
    assert err.max() <= 5e-3 and err.mean() <= 5e-4, (
        f"{what}: max err {err.max():.3e}, mean {err.mean():.3e}")


@pytest.fixture
def driving_mp4(tmp_path):
    path = tmp_path / "drv.mp4"
    if not write_mp4(path, drifting_face_frames()):
        pytest.skip("no cv2 video encoder in this image")
    return str(path)


def test_adam_steps_match_optax():
    # three steps of optax.adam(0.05) from the same zero state on seeded
    # gradients of mixed scale, zeros included: 1e-7 absolute
    rng = np.random.RandomState(0)
    param = rng.randn(50).astype(np.float32)
    grads = [rng.randn(50).astype(np.float32) * 10.0 ** rng.uniform(-6, 1, 50) for _ in range(3)]
    grads[1][:5] = 0.0
    opt = optax.adam(0.05)
    jp, state = jnp.asarray(param), opt.init(jnp.asarray(param))
    p, mu, nu = t(param.copy()), torch.zeros(50), torch.zeros(50)
    for step, g in enumerate(grads, start=1):
        updates, state = opt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        adam_update(p, t(g), mu, nu, step, 0.05)
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=0, atol=1e-7)
    np.testing.assert_allclose(mu.numpy(), np.asarray(state[0].mu), rtol=0, atol=1e-7)


@pytest.mark.parametrize("n_frames", [1, 6])
def test_short_fit_matches_jax(n_frames):
    # 20 pose-only + 20 joint steps on the 256-vertex synthetic model; T = 6
    # has the smoothness terms. fp32 gradients in another order, through 40
    # Adam steps: coefficients within 1e-3 absolute (scale ~0.1), the loss
    # within 1e-4 of itself
    jassets, assets = jax_synthetic_bfm(n_vertices=256), synthetic_bfm(n_vertices=256)
    lm = seeded_landmarks(jassets, n_frames, seed=n_frames)
    want = jax_fit_coeffs(jassets, jnp.asarray(lm), n_pose_iters=20, n_joint_iters=20)
    got = fit_coeffs(assets, lm, n_pose_iters=20, n_joint_iters=20, device="cpu")
    for k in COEFFS:
        assert tuple(getattr(got, k).shape) == np.asarray(getattr(want, k)).shape, k
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=0, atol=1e-3, err_msg=k)
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-4, atol=0)
    assert not got.exp.requires_grad and got.loss.dim() == 0


def test_full_fit_recovers_pose():
    # the JAX package's own criterion (tests/test_inference.py): 150 + 150
    # steps at lr 0.03 reproject within 0.01 (mean abs, normalised frame)
    # with a loss below 1e-3
    assets = synthetic_bfm(n_vertices=256)
    exp = torch.zeros((1, 64))
    exp[0, 0] = 0.3
    euler, trans = torch.tensor([[0.1, -0.15, 0.05]]), torch.tensor([[0.05, -0.02, 0.1]])
    lm2d = face3d_helper.reconstruct_lm2d(assets, torch.zeros((1, 80)), exp, euler, trans)
    with torch.no_grad():  # the fit takes its gradients under a caller's no_grad too
        fit = fit_coeffs(assets, lm2d, n_pose_iters=150, n_joint_iters=150, lr=0.03,
                         device="cpu")
    pred = face3d_helper.reconstruct_lm2d(assets, fit.id, fit.exp, fit.euler, fit.trans)
    assert float((pred - lm2d).abs().mean()) < 0.01
    assert float(fit.loss) < 1e-3


def test_projection_matrix_is_made_once_per_device():
    # a CUDA copy of a host list waits for the device, so the fit's loop
    # must not build the matrix per step: one tensor per (focal, center,
    # device), equal to the JAX package's
    from real3dportrait_tpu.geometry import bfm as jbfm
    from real3dportrait_tpu_torch.geometry import bfm

    p = bfm.perspective_projection_matrix(1015.0, 112.0, torch.device("cpu"))
    assert bfm.perspective_projection_matrix(1015.0, 112.0, torch.device("cpu")) is p
    np.testing.assert_array_equal(p.numpy(), np.asarray(jbfm.perspective_projection_matrix()))


def test_landmark_template_and_extractor_match_jax():
    # the neutral template (fp32 matmuls and a divide: 1e-6) and the naive
    # extractor (1e-6 of the normalised frame) on frames whose face shows
    # only in frames 3-6: before them the central fallback box, after them
    # frame 6's box
    np.testing.assert_allclose(prep._neutral_lm_template(), jprep._neutral_lm_template(),
                               rtol=0, atol=1e-6)
    frames = drifting_face_frames(10)
    frames[:3] = frames[7:] = 0
    got, want = prep.naive_landmark_extractor(frames), jprep.naive_landmark_extractor(frames)
    assert got.shape == (10, 68, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[9], got[6])
    np.testing.assert_array_equal(got[0], got[2])
    assert not np.array_equal(got[3], got[0]) and not np.array_equal(got[6], got[3])


def test_resample_video_is_bit_equal_to_jax(driving_mp4):
    for kw in (dict(), dict(fps=10, size=48), dict(max_frames=5)):
        got = prep.resample_video(driving_mp4, **kw)
        np.testing.assert_array_equal(got, jprep.resample_video(driving_mp4, **kw), str(kw))
    assert got.shape == (5, 512, 512, 3)


def test_segment_frames_and_blinks_are_bit_equal_to_jax():
    frames = drifting_face_frames(8)
    got, want = prep.segment_frames(frames), jprep.segment_frames(frames)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["segmap"] == 3).any() and (got["segmap"] == 4).any()
    # seeded landmarks with open eyes (corners 0.1 apart, lids 0.06 apart),
    # closed (the lids on the corners' line) in frames 4-6
    rng = np.random.RandomState(3)
    lm = rng.uniform(0.2, 0.8, (16, 68, 2)).astype(np.float32)
    for start, x in ((36, 0.3), (42, 0.6)):
        lm[:, start:start + 6] = [[x, 0.5], [x + 0.03, 0.47], [x + 0.07, 0.47],
                                  [x + 0.1, 0.5], [x + 0.07, 0.53], [x + 0.03, 0.53]]
    lm[4:7, 36:48, 1] = 0.5
    blink = prep.extract_blink(lm)
    np.testing.assert_array_equal(blink, jprep.extract_blink(lm))
    assert blink[4:7].all() and not blink[:4].any() and not blink[7:].any()


def test_audio_features_are_bit_equal_to_jax():
    wav = chirp_wav(0.6, seed=2)
    got, want = prep.extract_audio_features(wav), jprep.extract_audio_features(wav)
    assert sorted(got) == sorted(want) == ["f0", "mel"]
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_process_video_to_record_matches_jax(driving_mp4):
    # precomputed landmarks of 12 frames, 0.4 s of wav (10 motion frames),
    # the images stored: the fit's coefficients (200 + 200 steps, smoothness
    # on) as ``fits_agree`` bounds them, everything else bit-equal
    lm = seeded_landmarks(jax_synthetic_bfm(), 12, seed=5)
    wav = chirp_wav(0.4, seed=6)
    got = prep.process_video_to_record(driving_mp4, wav, lm2d_seq=lm, store_images=True,
                                       device="cpu")
    want = jprep.process_video_to_record(driving_mp4, wav, lm2d_seq=lm, store_images=True)
    assert sorted(got) == sorted(want)
    assert got["exp"].shape == (10, 64) and got["mel"].shape == (20, 80)
    for k in want:
        assert got[k].shape == np.asarray(want[k]).shape, k
        if k in COEFFS:
            fits_agree(got[k], want[k], k)
        else:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_motion_from_video_landmarks_matches_jax():
    # 10 frames (> 7: exp smoothed by 5 / sigma 1, the pose by 7 / sigma 2)
    # and 5 (not smoothed), on the 256-vertex model (``fits_agree``)
    jassets, assets = jax_synthetic_bfm(n_vertices=256), synthetic_bfm(n_vertices=256)
    for n in (10, 5):
        lm = seeded_landmarks(jassets, n, seed=7 + n)
        got = infer_utils.motion_from_video_landmarks(assets, lm, device="cpu")
        want = jiu.motion_from_video_landmarks(jassets, lm)
        assert sorted(got) == sorted(want)
        for k in want:
            fits_agree(got[k].numpy(), want[k], f"{k}, T={n}")
    unsmoothed = infer_utils.motion_from_video_landmarks(assets, lm, smooth=False, device="cpu")
    torch.testing.assert_close(unsmoothed["exp"], got["exp"], rtol=0, atol=0)


def test_tiny_run_from_source_landmarks_matches_jax(pipelines):
    # landmarks of the pipeline's morphable model at seeded coefficients:
    # the face crop and the fitted source (id, exp, pose) through the torso
    # model, 8 frames at temperature 0 (``fits_agree``); frames through the
    # bf16 SR blocks: 3e-2 of scale max, 3e-3 mean
    jp, pipe = pipelines
    lm = seeded_landmarks(jp.assets, 1, seed=11)[0]
    src = np.random.RandomState(12).randint(0, 256, (64, 64, 3)).astype(np.uint8)
    wav = chirp_wav(0.32, seed=13)
    coeffs, jcoeffs = pipe.fit_source(lm), jp.fit_source(lm)
    for k in COEFFS:
        assert tuple(coeffs[k].shape) == (1, {"id": 80, "exp": 64}.get(k, 3))
        fits_agree(coeffs[k].numpy(), jcoeffs[k], k)
    timings = {}
    got = pipe.run(src, wav=wav, src_lm2d=lm, temperature=0.0, timings=timings)
    want = jp.run(src, wav=wav, src_lm2d=lm, temperature=0.0)
    assert got.shape == (8, 64, 64, 3) and "fit_ms" in timings
    agree(got, want, 3e-2, 3e-3, "run frames from source landmarks")


def test_tiny_video_driven_run_matches_jax(pipelines, driving_mp4):
    # the motion of a driving video (12 frames) fitted by both, then the
    # JAX motion drives both runs (expression and pose, mapped to the
    # neutral source): frames 3e-2 max, 3e-3 mean
    jp, pipe = pipelines
    motion = pipe.motion_from_video(driving_mp4, max_frames=12)
    jmotion = jp.motion_from_video(driving_mp4, max_frames=12)
    for k in jmotion:
        fits_agree(motion[k].numpy(), jmotion[k], k)
    assert float(motion["trans"].std(0).max()) > 1e-4  # the drift moves the fitted pose
    drive = {k: np.asarray(v) for k, v in jmotion.items()}
    src = np.random.RandomState(14).uniform(-1, 1, (64, 64, 3)).astype(np.float32)
    pose = (drive["euler"], drive["trans"])
    got = pipe.run(src, drv_motion=drive, pose_seq=pose, blink_mode="none")
    want = jp.run(src, drv_motion=drive, pose_seq=pose, blink_mode="none")
    assert got.shape == (12, 64, 64, 3) and torch.isfinite(got).all()
    agree(got, want, 3e-2, 3e-3, "video-driven run frames")
    # the port's own tensors drive it as well
    own = pipe.run(src, drv_motion=motion, pose_seq=(motion["euler"], motion["trans"]),
                   blink_mode="none")
    agree(own, want, 3e-2, 3e-3, "run driven by the port's fitted motion")


def test_cli_with_mp4_drivers_writes_its_video(tmp_path, driving_mp4):
    src = tmp_path / "src.npy"
    np.save(src, np.random.RandomState(15).randint(0, 256, (64, 64, 3)).astype(np.uint8))
    out = tmp_path / "out.mp4"
    hparams = ",".join(f"{k}={v}" for k, v in SMALL.items() if k != "sampling_preset")
    proc = subprocess.run(
        [sys.executable, "-m", "real3dportrait_tpu_torch.inference.cli", "--src_img", str(src),
         "--drv_aud", driving_mp4, "--drv_pose", driving_mp4, "--out_name", str(out),
         "--device", "cpu", "--seed", "0", "--blink_mode", "none", "--hparams", hparams],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "extracted 12 exp frames" in proc.stdout and "extracted 12 pose frames" in proc.stdout
    assert "wrote 12 frames" in proc.stdout
    assert out.stat().st_size > 0

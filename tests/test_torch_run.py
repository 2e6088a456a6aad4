"""The port's audio-driven ``run`` path against the JAX package on the CPU:
the landmark reconstruction, the temporal smoothing, source preparation and
the naive segmenter, the blink edit and its periodic schedule, the
pipeline's audio stages, the whole tiny-config ``run`` (0.32 s of wav,
8 frames) and ``synthesize`` with an explicit segmap, and a CLI run that
writes its video. The JAX pipeline's weights are seeded numpy leaves on its
init trees (the audio-to-motion model's training tree, encoder included),
carried into the port with ``torch_state_dict_from_jax`` and strict name
matching."""

import os
import subprocess
import sys
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real3dportrait_tpu.config import load_config as jax_load_config
from real3dportrait_tpu.geometry import bfm as jbfm
from real3dportrait_tpu.geometry import face3d_helper as jf3d
from real3dportrait_tpu.inference import edit_secc as jedit
from real3dportrait_tpu.inference import infer_utils as jiu
from real3dportrait_tpu.inference.pipeline import Real3DPortraitPipeline as JaxPipeline
from real3dportrait_tpu.preprocess import pipeline as jprep
from real3dportrait_tpu.preprocess import segment_utils as jseg
from real3dportrait_tpu_torch import config as port_config
from real3dportrait_tpu_torch.geometry import bfm, face3d_helper
from real3dportrait_tpu_torch.inference import edit_secc, infer_utils
from real3dportrait_tpu_torch.inference.pipeline import Real3DPortraitPipeline, write_video
from real3dportrait_tpu_torch.preprocess import pipeline as prep
from real3dportrait_tpu_torch.preprocess import segment_utils as seg
from real3dportrait_tpu_torch.weights import torch_state_dict_from_jax
from tests._torch_parity import agree, random_like, t
from tests.test_torch_audio import chirp_wav

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "secc_img2plane_torso.yaml")
SMALL = dict(final_resolution=64, neural_rendering_resolution=16, secc_resolution=32,
             sr_channel0=16, sr_channel1=8, torso_model_scale="tiny", sampling_preset="fast")


def test_reconstruct_lm2d_matches_jax():
    # the 68 landmarks of posed coefficients in the 224 fit frame, [T,C]
    # and [B,T,C]: fp32 matmuls and a perspective divide, 1e-6 of scale
    jassets, assets = jbfm.synthetic_bfm(), bfm.synthetic_bfm()
    rng = np.random.RandomState(0)
    coeffs = [rng.randn(2, 3, n).astype(np.float32) * s
              for n, s in ((80, 0.5), (64, 0.5), (3, 0.2), (3, 0.1))]
    want = jf3d.reconstruct_lm2d(jassets, *map(jnp.asarray, coeffs))
    got = face3d_helper.reconstruct_lm2d(assets, *map(t, coeffs))
    assert got.shape == (2, 3, 68, 2)
    agree(got, want, 1e-6, 1e-7, "lm2d [B,T,C]")
    flat = [c[0] for c in coeffs]
    agree(face3d_helper.reconstruct_lm2d(assets, *map(t, flat)),
          jf3d.reconstruct_lm2d(jassets, *map(jnp.asarray, flat)), 1e-6, 1e-7, "lm2d [T,C]")
    agree(face3d_helper.reconstruct_idexp_lm3d(assets, t(flat[0]), t(flat[1])),
          jf3d.reconstruct_idexp_lm3d(jassets, jnp.asarray(flat[0]), jnp.asarray(flat[1])),
          1e-6, 1e-7, "idexp lm3d")
    packed = rng.randn(4, 257).astype(np.float32)
    for k, v in face3d_helper.split_coeff(t(packed)).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jf3d.split_coeff(packed)[k]))


@pytest.mark.parametrize("n,kernel,sigma", [(1, 7, 2.0), (2, 7, 2.0), (3, 7, 2.0),
                                            (12, 7, 2.0), (9, 5, 1.0), (5, 4, 2.0)])
def test_smooth_features_1d_matches_jax(n, kernel, sigma):
    # reflect-padded gaussian over time, the kernel shrunk below 2T: 1e-6
    x = np.random.RandomState(n).randn(n, 4, 3).astype(np.float32)
    got = infer_utils.smooth_features_1d(t(x), kernel_size=kernel, sigma=sigma)
    want = jiu.smooth_features_1d(jnp.asarray(x), kernel_size=kernel, sigma=sigma)
    agree(got, want, 1e-6, 1e-7, "smoothed")


def test_map_pose_and_motion_files_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    euler, trans = rng.randn(5, 3).astype(np.float32), rng.randn(5, 3).astype(np.float32)
    src_e, src_t = rng.randn(1, 3).astype(np.float32), rng.randn(1, 3).astype(np.float32)
    for z_fix, to_init in ((True, True), (False, True), (True, False)):
        got = infer_utils.map_pose_to_source(t(euler), t(trans), t(src_e), t(src_t),
                                             z_fix, to_init)
        want = jiu.map_pose_to_source(euler, trans, src_e, src_t, z_fix, to_init)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    np.save(tmp_path / "coeff.npy", {"exp": rng.randn(4, 64), "euler": euler})
    np.save(tmp_path / "feats.npy", rng.randn(6, 1024).astype(np.float32))
    for name in ("coeff.npy", "feats.npy"):
        got = infer_utils.load_motion_coeff_npy(str(tmp_path / name))
        want = jiu.load_motion_coeff_npy(str(tmp_path / name))
        assert (got is None) == (want is None)
        if got is not None:
            assert sorted(got) == sorted(want)
            np.testing.assert_array_equal(got["exp"], want["exp"])


def _portrait(res: int, seed: int):
    """A seeded RGB image and a segmap of blobs: head (hair, face, other),
    neck and torso where a portrait has them, background elsewhere."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (res, res, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:res, :res] / res
    segmap = np.zeros((res, res), np.int64)
    segmap[(yy - 0.4) ** 2 + (xx - 0.5) ** 2 < 0.06] = 3
    segmap[((yy - 0.25) ** 2 + (xx - 0.5) ** 2 < 0.04) & (yy < 0.25)] = 1
    segmap[(yy > 0.62) & (yy < 0.72) & (abs(xx - 0.5) < 0.1)] = 2
    segmap[yy >= 0.72] = 4
    segmap[(yy > 0.3) & (yy < 0.35) & (xx < 0.1)] = 5
    return img, segmap


@pytest.mark.parametrize("with_bg", [False, True])
def test_prepare_source_matches_jax(with_bg):
    # host numpy and scipy, the same code: bit-equal
    img, segmap = _portrait(64, 2)
    bg = np.random.RandomState(3).randint(0, 256, (64, 64, 3)).astype(np.uint8) \
        if with_bg else None
    got, want = seg.prepare_source(img, segmap, bg), jseg.prepare_source(img, segmap, bg)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["torso_mask"].any() and (got["head_img"] > 0).any()
    lm = np.random.RandomState(4).uniform(20, 30, (68, 2))
    np.testing.assert_array_equal(seg.crop_on_face_area(img, lm, 0.2),
                                  jseg.crop_on_face_area(img, lm, 0.2))


def test_naive_segmenter_matches_jax_and_sees_one_frame_as_background():
    frames = np.random.RandomState(5).randint(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    np.testing.assert_array_equal(prep.naive_person_segmenter(frames),
                                  jprep.naive_person_segmenter(frames))
    one = prep.naive_person_segmenter(frames[:1])
    np.testing.assert_array_equal(one, jprep.naive_person_segmenter(frames[:1]))
    assert not one.any()  # the median of one frame is the frame: all background


def _secc_with_eyes(res: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    secc = rng.uniform(-0.9, 1, (res, res, 3)).astype(np.float32)
    secc[20:26, 20:30] = -1.0   # two eye holes inside the face
    secc[21:28, 36:44] = -1.0
    return secc


@pytest.mark.parametrize("percent", [0.0, 0.25, 0.625, 1.0])
def test_blink_edit_matches_jax(percent):
    secc = _secc_with_eyes(64, 6)
    got = edit_secc.blink_eye_for_secc(secc, percent)
    np.testing.assert_array_equal(got, jedit.blink_eye_for_secc(secc, percent))
    assert (not np.array_equal(got, secc)) == (percent > 0)


@pytest.mark.parametrize("n_frames", [67, 68, 200, 320])
def test_blink_schedule_matches_jax_synthesize(monkeypatch, n_frames):
    # the schedule JAX's synthesize applies: its blink edit recorded per
    # frame, with the renderer, model and caches stubbed out
    calls = []
    monkeypatch.setattr(jedit, "blink_eye_for_secc",
                        lambda secc, p: calls.append(p) or secc)
    res = 8

    class Renderer:
        def render(self, idc, exp, euler, trans):
            return None, jnp.zeros((idc.shape[0], res, res, 3))

    jp = object.__new__(JaxPipeline)
    jp.res, jp.cfg, jp.use_torso, jp.secc_renderer = res, {}, False, Renderer()
    jp._cal_cano = lambda v, img: None
    jp.model_variables = None
    frame_i = iter(range(n_frames))
    jp._frame_step = lambda *a: (np.full((1, res, res, 3), next(frame_i), np.float32),
                                 None, None)
    coeffs = {"id": jnp.zeros((1, 80)), "exp": jnp.zeros((1, 64)),
              "euler": jnp.zeros((1, 3)), "trans": jnp.zeros((1, 3))}
    jp.synthesize(np.zeros((res, res, 3), np.float32), jnp.zeros((n_frames, 64)), coeffs,
                  prepare_source_images=False)
    schedule = edit_secc.periodic_blink_percent(n_frames)
    np.testing.assert_array_equal(schedule[schedule > 0], np.asarray(calls, np.float32))
    assert (schedule > 0).any() == (n_frames >= 68)


@pytest.fixture(scope="module")
def pipelines():
    """The JAX pipeline of the default config at 64^2 (weights: seeded
    leaves on its init trees) and the port's pipeline carrying them."""
    def init_from_shapes(self, mock, a2m_dir, s2v_dir):
        keys = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
        a2m_batch = {"audio": jnp.zeros((1, 32, self.audio_in_dim)), "f0": jnp.zeros((1, 32)),
                     "y_mask": jnp.ones((1, 16)), "blink": jnp.zeros((1, 32, 1), jnp.int32),
                     "y": jnp.zeros((1, 16, 64))}
        self.a2m_params = random_like(jax.eval_shape(
            lambda: self.a2m.init(keys, a2m_batch, train=True))["params"], seed=30)
        res = self.res
        cam = jnp.concatenate([jnp.eye(4).reshape(1, 16), jnp.eye(3).reshape(1, 9)], -1)
        shapes = jax.eval_shape(lambda: self.model.init(
            keys, jnp.zeros((1, res, res, 3)), cam, secc=jnp.zeros((1, res, res, 9)),
            cond=self._mock_cond(np.zeros((res, res, 3), np.float32))))
        self.model_variables = random_like(shapes, seed=31)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxPipeline, "_init_weights", init_from_shapes)
        jp = JaxPipeline(jax_load_config(CONFIG, SMALL), mock_weights=True, seed=0)
    pipe = Real3DPortraitPipeline(port_config.load_config(CONFIG, SMALL), seed=0,
                                  device="cpu")
    pipe.model.load_state_dict(torch_state_dict_from_jax(jp.model_variables), strict=True)
    pipe.a2m.load_state_dict(torch_state_dict_from_jax(jp.a2m_params), strict=True)
    return jp, pipe


def test_audio_stages_match_jax(pipelines):
    # features bit-equal; the motion at temperature 0 through the
    # full-width flow-VAE: 1e-5 of scale max, 1e-6 mean
    jp, pipe = pipelines
    wav = chirp_wav(0.5, seed=7)
    feats, f0 = pipe.audio_to_features(wav)
    jfeats, jf0 = jp.audio_to_features(wav)
    assert feats.shape == (24, 1024) and f0.shape == (24,)
    np.testing.assert_array_equal(feats, jfeats)
    np.testing.assert_array_equal(f0, jf0)
    agree(pipe.audio_to_motion(feats, f0, temperature=0.0),
          jp.audio_to_motion(feats, f0, temperature=0.0), 1e-5, 1e-6, "exp sequence")
    zero_f0 = pipe.audio_to_features(None, hubert=feats[:20])[1]
    assert zero_f0.shape == (16,) and not zero_f0.any()


def test_tiny_run_matches_jax(pipelines, tmp_path):
    # the JAX defaults (source preparation from the naive segmenter, the
    # periodic blink) from 0.32 s of wav to 8 frames at temperature 0, and
    # a video file. Frames through the default model's two bf16 SR blocks:
    # 3e-2 of scale max, 3e-3 mean (as the default model's frame step)
    jp, pipe = pipelines
    wav = chirp_wav(0.32, seed=8)
    src = np.random.RandomState(9).randint(0, 256, (64, 64, 3)).astype(np.uint8)
    want = jp.run(src, wav=wav, temperature=0.0)
    timings = {}
    got = pipe.run(src, wav=wav, temperature=0.0, out_path=str(tmp_path / "run.mp4"),
                   timings=timings)
    assert got.shape == (8, 64, 64, 3) and torch.isfinite(got).all()
    agree(got, want, 3e-2, 3e-3, "run frames")
    written = [p for p in tmp_path.iterdir() if p.name.startswith("run.mp4")]
    assert any(p.stat().st_size > 0 for p in written), written
    assert {"features_ms", "a2m_ms", "prep_ms", "cano_ms"} <= set(timings)
    assert len(timings["frame_ms"]) == 8


def test_tiny_synthesize_with_segmap_matches_jax(pipelines):
    # an explicit segmap: real head / inpainted torso / background split
    # and keypoints from the coefficients; fp32 until the bf16 SR blocks
    jp, pipe = pipelines
    img, segmap = _portrait(64, 10)
    exp = np.random.RandomState(11).randn(3, 64).astype(np.float32) * 0.3
    want = jp.synthesize(img, jnp.asarray(exp), jp.fit_source(None), segmap=segmap,
                         blink_mode="none")
    got = pipe.synthesize(img, t(exp), pipe.fit_source(None), segmap=segmap,
                          blink_mode="none")
    agree(got, want, 3e-2, 3e-3, "frames with a segmap")
    streamed = []
    empty = pipe.synthesize(img, t(exp), pipe.fit_source(None), segmap=segmap,
                            blink_mode="none", stream_only=True,
                            callback=lambda i, f: streamed.append((i, f)))
    assert empty.shape == (0, 64, 64, 3) and [i for i, _ in streamed] == [0, 1, 2]
    np.testing.assert_array_equal(np.stack([f for _, f in streamed]), got.numpy())


def test_debug_view_and_video_writer(pipelines, tmp_path):
    # final | raw | depth side by side at the output's height, and the
    # writer's file with the wav beside it (or muxed in)
    _, pipe = pipelines
    src = np.random.RandomState(14).randint(0, 256, (64, 64, 3)).astype(np.uint8)
    frames = pipe.synthesize(src, torch.zeros((2, 64)), pipe.fit_source(None),
                             debug_mode=True)
    assert frames.shape == (2, 64, 3 * 64, 3) and frames.abs().max() <= 1.0
    out = tmp_path / "debug.mp4"
    write_video(frames, str(out), wav=chirp_wav(0.08))
    written = {p.name: p.stat().st_size for p in tmp_path.iterdir()}
    assert written.get("debug.mp4", 0) > 0 or written.get("debug.mp4.raw", 0) > 0, written
    assert written.get("debug.mp4.wav", 1) > 0


def test_cli_run_on_cpu_writes_its_video(tmp_path):
    rng = np.random.RandomState(12)
    src = tmp_path / "src.npy"
    np.save(src, rng.randint(0, 256, (64, 64, 3)).astype(np.uint8))
    wav_path = tmp_path / "drv.wav"
    with wave.open(str(wav_path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((chirp_wav(0.32, seed=13) * 32767).astype("<i2").tobytes())
    out = tmp_path / "out.mp4"
    hparams = ",".join(f"{k}={v}" for k, v in SMALL.items() if k != "sampling_preset")
    proc = subprocess.run(
        [sys.executable, "-m", "real3dportrait_tpu_torch.inference.cli", "--src_img", str(src),
         "--drv_aud", str(wav_path), "--out_name", str(out), "--device", "cpu", "--seed", "0",
         "--hparams", hparams], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "wrote 8 frames" in proc.stdout
    written = [p for p in tmp_path.iterdir() if p.name.startswith("out.mp4")]
    assert any(p.stat().st_size > 0 for p in written), written

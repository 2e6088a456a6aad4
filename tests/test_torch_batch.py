"""Frame batching and the batched multi-identity mode of the port's
``synthesize`` / ``run`` against the JAX package on the CPU: ``frame_batch``
4 and 5 (a ragged last step) with a segmap, still and with a pose sequence
(a camera a frame), a blink inside a batched step,
N = 2 identities and N = 1, the two modes together raising, the streamed
frames of a batched run, ``run`` with [N,H,W,3] sources, and the tiny
flagship at a frame batch of 2 against ``__graft_entry__._flagship`` under
``BENCH_FRAME_BATCH=2``. The pipelines are ``tests/test_torch_run.py``'s:
the JAX pipeline of the default config at 64^2 on seeded leaves, and the
port's carrying its weights. Frames pass the default model's two bf16 SR
blocks: 3e-2 of scale max, 3e-3 mean."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real3dportrait_tpu_torch.flagship import flagship
from real3dportrait_tpu_torch.inference import pipeline
from tests._torch_parity import agree, load_from_jax, t
from tests.test_torch_audio import chirp_wav
from tests.test_torch_run import _portrait, pipelines  # noqa: F401  (module fixture)

torch.set_num_threads(1)

TOL = (3e-2, 3e-3)


def _exp(n: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randn(n, 64).astype(np.float32) * 0.3


@pytest.mark.parametrize("posed", [False, True], ids=["still", "posed"])
@pytest.mark.parametrize("fb", [4, 5])
def test_frame_batch_matches_jax(pipelines, fb, posed):
    # 7 frames: at fb 4 two steps, the last padded with frame 6; at fb 5 a
    # ragged last step of 2. Source preparation from an explicit segmap,
    # the driving keypoints indexed per step; posed, a seeded pose sequence
    # gives every frame of a step its own camera
    jp, pipe = pipelines
    img, segmap = _portrait(64, 20)
    exp = _exp(7, 21)
    rng = np.random.RandomState(32)
    pose = ((rng.randn(7, 3) * 0.15).astype(np.float32),
            (rng.randn(7, 3) * 0.03).astype(np.float32)) if posed else None
    want = jp.synthesize(img, jnp.asarray(exp), jp.fit_source(None), pose_seq=pose,
                         segmap=segmap, frame_batch=fb)
    timings = {}
    got = pipe.synthesize(img, t(exp), pipe.fit_source(None), pose_seq=pose, segmap=segmap,
                          frame_batch=fb, timings=timings)
    assert got.shape == (7, 64, 64, 3) and len(timings["frame_ms"]) == 2
    agree(got, want, *TOL, f"frames at frame_batch {fb}")
    one = pipe.synthesize(img, t(exp), pipe.fit_source(None), pose_seq=pose, segmap=segmap)
    agree(got, one, *TOL, f"frame_batch {fb} against 1")
    if posed:
        still = pipe.synthesize(img, t(exp), pipe.fit_source(None), segmap=segmap,
                                frame_batch=fb)
        assert ((got - still).abs().amax(dim=(1, 2, 3)) > 0).all()


def test_blink_inside_a_batched_step_equals_one_frame_a_step(pipelines, monkeypatch):
    # blinks at frames 1, 2 (step 0 of fb 4) and 6 (step 1, beside its
    # padded copy, edited too, as JAX edits it); the edit is the
    # real eyelid slide, then a dimming, so that every edited map changes
    _, pipe = pipelines
    schedule = np.zeros((7,), np.float32)
    schedule[[1, 2, 6]] = (0.5, 1.0, 0.25)
    monkeypatch.setattr(pipeline, "periodic_blink_percent", lambda n: schedule[:n])
    calls = []
    real_edit = pipeline.blink_eye_for_secc

    def edit(secc, p):
        calls.append(p)
        return (real_edit(secc, p) * (1.0 - 0.5 * p)).astype(np.float32)

    monkeypatch.setattr(pipeline, "blink_eye_for_secc", edit)
    src = np.random.RandomState(22).randint(0, 256, (64, 64, 3)).astype(np.uint8)
    exp, coeffs = t(_exp(7, 23)), pipe.fit_source(None)
    batched = pipe.synthesize(src, exp, coeffs, frame_batch=4)
    assert calls == [0.5, 1.0, 0.25, 0.25]
    calls.clear()
    single = pipe.synthesize(src, exp, coeffs)
    assert calls == [0.5, 1.0, 0.25]
    agree(batched, single, *TOL, "blinking frames, fb 4 against 1")
    still = pipe.synthesize(src, exp, coeffs, blink_mode="none", frame_batch=4)
    moved = (batched - still).abs().amax(dim=(1, 2, 3))
    assert (moved[[1, 2, 6]] > 0).all() and (moved[[0, 3, 4, 5]] == 0).all(), moved


def test_multi_identity_matches_jax(pipelines):
    # two identities share the motion: no source preparation, the mock cond
    # at N = 2 with one background broadcast over them; identity k's frames
    # are those of source k alone without preparation
    jp, pipe = pipelines
    rng = np.random.RandomState(24)
    srcs = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    bg = rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
    exp = _exp(3, 25)
    want = jp.synthesize(srcs, jnp.asarray(exp), jp.fit_source(None), bg_img=bg)
    seen = []
    got = pipe.synthesize(srcs, t(exp), pipe.fit_source(None), bg_img=bg,
                          callback=lambda i, f: seen.append((i, f)))
    assert got.shape == (3, 2, 64, 64, 3) and np.asarray(want).shape == (3, 2, 64, 64, 3)
    agree(got, want, *TOL, "frames of 2 identities")
    assert [i for i, _ in seen] == [0, 1, 2] and seen[0][1].shape == (2, 64, 64, 3)
    np.testing.assert_array_equal(np.stack([f for _, f in seen]), got.numpy())
    for k in range(2):
        alone = pipe.synthesize(srcs[k], t(exp), pipe.fit_source(None), bg_img=bg,
                                prepare_source_images=False)
        agree(got[:, k], alone, *TOL, f"identity {k} against its source alone")


def test_one_identity_keeps_its_axis(pipelines):
    _, pipe = pipelines
    src = np.random.RandomState(26).randint(0, 256, (64, 64, 3)).astype(np.uint8)
    exp, coeffs = t(_exp(2, 27)), pipe.fit_source(None)
    got = pipe.synthesize(src[None], exp, coeffs)
    assert got.shape == (2, 1, 64, 64, 3)
    alone = pipe.synthesize(src, exp, coeffs, prepare_source_images=False)
    agree(got[:, 0], alone, 1e-6, 1e-7, "one identity against its source alone")
    empty = pipe.synthesize(src[None], exp, coeffs, stream_only=True)
    assert empty.shape == (0, 1, 64, 64, 3)


def test_frame_batch_with_identities_raises(pipelines):
    # JAX asserts; the port raises ValueError before any work
    jp, pipe = pipelines
    srcs = np.zeros((2, 64, 64, 3), np.uint8)
    with pytest.raises(AssertionError, match="mutually exclusive"):
        jp.synthesize(srcs, jnp.zeros((2, 64)), jp.fit_source(None), frame_batch=2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        pipe.synthesize(srcs, torch.zeros((2, 64)), pipe.fit_source(None), frame_batch=2)


def test_stream_only_delivers_a_batched_run_in_order(pipelines):
    # fb 3 over 8 frames: steps of 3, 3 and 2; the callback sees frames
    # 0-7 in order, one at a time, equal to the kept frames of the same call
    _, pipe = pipelines
    src = np.random.RandomState(28).randint(0, 256, (64, 64, 3)).astype(np.uint8)
    exp, coeffs = t(_exp(8, 29)), pipe.fit_source(None)
    kept = pipe.synthesize(src, exp, coeffs, frame_batch=3)
    seen, timings = [], {}
    empty = pipe.synthesize(src, exp, coeffs, frame_batch=3, stream_only=True,
                            callback=lambda i, f: seen.append((i, f)), timings=timings)
    assert empty.shape == (0, 64, 64, 3) and len(timings["frame_ms"]) == 3
    assert [i for i, _ in seen] == list(range(8))
    assert all(f.shape == (64, 64, 3) and f.dtype == np.float32 for _, f in seen)
    np.testing.assert_array_equal(np.stack([f for _, f in seen]), kept.numpy())


def test_run_with_identities_matches_jax(pipelines, tmp_path):
    # run with [N,H,W,3]: no crop, the same motion and synthesis; with
    # out_path the JAX pipeline's writer fails on the 4-D frames where cv2
    # imports (its raw fallback would write them), and the port raises
    jp, pipe = pipelines
    wav = chirp_wav(0.32, seed=30)
    srcs = np.random.RandomState(31).randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    want = jp.run(srcs, wav=wav, temperature=0.0)
    got = pipe.run(srcs, wav=wav, temperature=0.0)
    assert got.shape == (8, 2, 64, 64, 3)
    agree(got, want, *TOL, "run frames of 2 identities")
    try:
        import cv2  # noqa: F401
    except ImportError:
        cv2 = None
    if cv2 is not None:
        with pytest.raises(Exception):
            jp.run(srcs, wav=wav, temperature=0.0, out_path=str(tmp_path / "jax.mp4"))
    with pytest.raises(ValueError, match="writes no video"):
        pipe.run(srcs, wav=wav, temperature=0.0, out_path=str(tmp_path / "port.mp4"))
    assert not (tmp_path / "port.mp4").exists()


def test_tiny_flagship_frame_batch_equals_jax(monkeypatch):
    # the port's flagship(tiny=True, frame_batch=2) on the JAX tiny
    # flagship's variables and inputs under BENCH_FRAME_BATCH=2 (its own
    # switch): 1e-4 of scale max, 1e-5 mean, as at one frame
    import __graft_entry__

    monkeypatch.setenv("BENCH_FRAME_BATCH", "2")
    jstep, (variables, cam, secc, cano, cond) = __graft_entry__._flagship(tiny=True)
    want = jax.jit(jstep)(variables, cam, secc, cano, cond)
    step, (pcam, psecc, pcano, pcond) = flagship(tiny=True, frame_batch=2, device="cpu")
    assert step.frames_per_call == jstep.frames_per_call == 2
    assert pcam.shape == (2, 25) and psecc.shape == (2, 64, 64, 9)
    assert pcano.shape == (2, 3, 2, 32, 32, 8) and pcano.stride(0) == 0
    assert all(v.shape[0] == 2 for k, v in pcond.items() if k != "bg_feat")
    mine = step(pcam, psecc, pcano, pcond)
    assert mine.shape == (2, 64, 64, 3) and torch.isfinite(mine).all()
    load_from_jax(step.model, jax.tree.map(np.asarray, variables))
    tcond = {k: t(v) for k, v in cond.items() if k != "bg_feat"}
    tcond["bg_feat"] = tuple(t(v) for v in cond["bg_feat"])
    got = step(t(cam), t(secc), t(cano), tcond)
    assert cano.shape == (2, 3, 2, 32, 32, 8)
    agree(got, want, 1e-4, 1e-5, "tiny flagship frames at a frame batch of 2")

"""Parity of the port's host helpers with the JAX package's: the landmark
edits of ``geometry/face3d_helper.py`` (torch on tensors), the audio
utilities of ``audio/features.py`` (numpy, the same arrays) and the
visualisation helpers of ``utils/visualization.py`` (the same images and
figures)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real3dportrait_tpu.audio import features as jfeat
from real3dportrait_tpu.geometry import face3d_helper as jf3d
from real3dportrait_tpu.utils import visualization as jvis
from real3dportrait_tpu_torch.audio import features as feat
from real3dportrait_tpu_torch.geometry import face3d_helper as f3d
from real3dportrait_tpu_torch.utils import visualization as vis
from tests._torch_parity import agree, t

torch.set_num_threads(1)


def _lm3d(shape=(3, 68, 3), seed=0):
    return (np.random.RandomState(seed).randn(*shape) * 0.1).astype(np.float32)


def test_get_eye_mouth_lm_matches_jax():
    lm = _lm3d((2, 5, 68, 3))
    for g, w in zip(f3d.get_eye_mouth_lm(t(lm)), jf3d.get_eye_mouth_lm(jnp.asarray(lm))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("freeze", [True, False])
def test_close_mouth_matches_jax(freeze):
    # the same fp32 means and sums: 1e-6 / 1e-7 of scale; the input is kept
    lm = _lm3d((2, 4, 68 * 3), seed=1)
    x = t(lm)
    got = f3d.close_mouth_for_idexp_lm3d(x, freeze_as_first_frame=freeze)
    want = jf3d.close_mouth_for_idexp_lm3d(jnp.asarray(lm), freeze_as_first_frame=freeze)
    assert got.shape == x.shape
    agree(got, want, 1e-6, 1e-7, "close mouth")
    np.testing.assert_array_equal(x.numpy(), lm)


def test_close_eyes_matches_jax():
    lm = _lm3d(seed=2)
    got = f3d.close_eyes_for_idexp_lm3d(t(lm), eps=0.004)
    agree(got, jf3d.close_eyes_for_idexp_lm3d(jnp.asarray(lm), eps=0.004), 1e-6, 1e-7,
          "close eyes")


def _wav(seconds=0.6, seed=3):
    rng = np.random.RandomState(seed)
    n = int(16000 * seconds)
    tt = np.arange(n) / 16000.0
    wav = 0.3 * np.sin(2 * np.pi * 220 * tt) + 0.01 * rng.randn(n)
    wav[: n // 3] *= 1e-4                    # a quiet start the VAD drops
    return wav.astype(np.float32)


def test_audio_helpers_match_jax():
    # numpy on the host in both packages: the same arrays, bit for bit
    wav = _wav()
    np.testing.assert_array_equal(feat.extract_mfcc(wav), jfeat.extract_mfcc(wav))
    np.testing.assert_array_equal(feat.extract_mfcc(wav, n_mfcc=20),
                                  jfeat.extract_mfcc(wav, n_mfcc=20))
    v = feat.vad(wav)
    np.testing.assert_array_equal(v, jfeat.vad(wav))
    assert v.dtype == bool and v.any() and not v.all()
    mag = np.abs(np.random.RandomState(4).randn(12, 257)).astype(np.float32)
    out = feat.griffin_lim(mag, n_iters=3)
    np.testing.assert_array_equal(out, jfeat.griffin_lim(mag, n_iters=3))
    assert out.shape == ((12 - 1) * feat.HOP + feat.N_FFT,)


def test_image_helpers_match_jax(tmp_path):
    # the same uint8 images, and the same files
    rng = np.random.RandomState(5)
    img = rng.uniform(-1, 1, (40, 48, 3)).astype(np.float32)
    lm = rng.uniform(0, 1, (68, 2)).astype(np.float32)
    np.testing.assert_array_equal(vis.draw_landmarks(img, lm, radius=3),
                                  jvis.draw_landmarks(img, lm, radius=3))
    ims = [img, rng.uniform(-1, 1, (40, 48, 1)).astype(np.float32),
           rng.uniform(-1, 1, (40, 48)).astype(np.float32)]
    grid = vis.image_grid(ims, cols=2)
    np.testing.assert_array_equal(grid, jvis.image_grid(ims, cols=2))
    assert grid.shape == (2 * 40 + 2, 2 * 48 + 2, 3)
    att = rng.rand(9, 7).astype(np.float32)
    for cmap in ("jet", "viridis"):
        np.testing.assert_array_equal(vis.plot_attention_img(att, cmap),
                                      jvis.plot_attention_img(att, cmap))
    import cv2

    for name, mod in (("port.png", vis), ("jax.png", jvis)):
        mod.save_image(os.path.join(tmp_path, name), img)
    a, b = (cv2.imread(os.path.join(tmp_path, n)) for n in ("port.png", "jax.png"))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a[..., ::-1], vis.to_uint8(img))


def _pixels(fig) -> np.ndarray:
    import matplotlib.pyplot as plt

    fig.canvas.draw()
    out = np.asarray(fig.canvas.buffer_rgba()).copy()
    plt.close(fig)
    return out


def test_figures_match_jax():
    # matplotlib figures (imported where used): the same pixels
    rng = np.random.RandomState(6)
    spec = rng.randn(30, 16).astype(np.float32)
    f0 = np.abs(rng.randn(30)).astype(np.float32) * 100
    for f0s in (None, f0, {"a": f0, "b": f0 * 0.5}):
        np.testing.assert_array_equal(_pixels(vis.spec_to_figure(spec, title="s", f0s=f0s)),
                                      _pixels(jvis.spec_to_figure(spec, title="s", f0s=f0s)))
    feats = rng.randn(24, 5).astype(np.float32)
    labels = np.arange(24) % 3
    got, want = vis.tsne_scatter(feats, labels, seed=1), jvis.tsne_scatter(feats, labels, seed=1)
    for cg, cw in zip(got.axes[0].collections, want.axes[0].collections):
        np.testing.assert_array_equal(cg.get_offsets(), cw.get_offsets())
    np.testing.assert_array_equal(_pixels(got), _pixels(want))
    # the numpy t-SNE the scatter falls back on without sklearn
    np.testing.assert_array_equal(vis._tsne_numpy(feats, perplexity=5.0, n_iter=50),
                                  jvis._tsne_numpy(feats, perplexity=5.0, n_iter=50))

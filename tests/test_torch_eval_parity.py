"""The port's parity tool (``python -m real3dportrait_tpu_torch.tools.eval_parity``)
against the JAX package's ``tools/eval_parity.py`` on the CPU, at the tiny
widths of tests/test_torch_run.py on the released geometry
(``configs/real3d_orig.yaml``, the ``reference`` preset): the JAX pipeline,
loaded from checkpoint directories that the JAX package wrote, writes a
2-frame fixture with JAX's ``make_selftest_fixtures``; the port's tool
renders the same driving coefficients from the same directories and
scores its frames against JAX's. Then the port's own ``--selftest``."""

import json
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real3dportrait_tpu.config import load_config as jax_load_config
from real3dportrait_tpu.inference import pipeline as jpipe
from real3dportrait_tpu.metrics import image_metrics as jimg
from real3dportrait_tpu.training import checkpoint as jckpt
from real3dportrait_tpu_torch.tools import eval_parity
from tests._torch_parity import random_like
from tests.test_torch_ckpt import _seeded_init
from tests.test_torch_run import ROOT, SMALL
from tools import eval_parity as jtool

torch.set_num_threads(1)

ORIG = os.path.join(ROOT, "configs", "real3d_orig.yaml")
TINY = {k: v for k, v in SMALL.items() if k != "sampling_preset"}
HPARAMS = ",".join(f"{k}={v}" for k, v in TINY.items())
# psnr's MSE floor of 1e-12 over a range of 2: bit-equal frames read this,
# which the JAX tool's docstring calls "inf"
PSNR_EXACT = round(float(10 * np.log10(4.0 / 1e-12)), 3)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """Checkpoint directories of seeded leaves on the JAX init trees (the
    converter's payload), the JAX pipeline loaded from them, its 2-frame
    fixture and the JAX tool's report on it."""
    root = tmp_path_factory.mktemp("parity")
    cfg = jax_load_config(ORIG, TINY).replace(sampling_preset="reference")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe.Real3DPortraitPipeline, "_init_weights", lambda *a: None)
        shell = jpipe.Real3DPortraitPipeline(cfg, mock_weights=True, seed=0)
    keys = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    a2m_batch = {"audio": jnp.zeros((1, 32, shell.audio_in_dim)), "f0": jnp.zeros((1, 32)),
                 "y_mask": jnp.ones((1, 16)), "blink": jnp.zeros((1, 32, 1), jnp.int32),
                 "y": jnp.zeros((1, 16, 64))}
    a2m = random_like(jax.eval_shape(lambda: shell.a2m.init(keys, a2m_batch, train=True)),
                      seed=60)
    res = shell.res
    cam = jnp.concatenate([jnp.eye(4).reshape(1, 16), jnp.eye(3).reshape(1, 9)], -1)
    model = random_like(jax.eval_shape(lambda: shell.model.init(
        keys, jnp.zeros((1, res, res, 3)), cam, secc=jnp.zeros((1, res, res, 9)),
        cond=shell._mock_cond(np.zeros((res, res, 3), np.float32)))), seed=61)
    dirs = {"a2m": str(root / "audio2secc"), "s2v": str(root / "secc2video")}
    jckpt.save_checkpoint(dirs["a2m"], 100, {"step": 100, "params": {"model": a2m["params"]},
                                             "variables": {}})
    jckpt.save_checkpoint(dirs["s2v"], 200, {
        "step": 200, "params": {"gen": model["params"]},
        "variables": {k: v for k, v in model.items() if k != "params"}})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _seeded_init(62))
        jp = jpipe.Real3DPortraitPipeline(cfg, mock_weights=False, seed=0,
                                          a2m_ckpt_dir=dirs["a2m"],
                                          secc2video_ckpt_dir=dirs["s2v"])
    fixtures = str(root / "fixtures")
    jtool.make_selftest_fixtures(jp, fixtures, t=2)
    jreport = jtool.evaluate(jp, fixtures, str(root / "jax_out"), 30.0, 0.10)
    return root, dirs, fixtures, jreport


def test_port_tool_scores_its_frames_against_jax_fixtures(jax_side):
    """The port renders JAX's driving coefficients from the JAX-written
    directories: a report with JAX's keys, mean PSNR at least 50 dB against
    JAX's frames, and each frame's PSNR as the JAX package's ``psnr``
    computes it on the same frames, to 1e-3 dB. Measured: the frames differ
    by at most 1.1e-6, an MSE of 7e-14 (137 dB), below ``psnr``'s 1e-12
    floor, so both packages read 126.021 dB."""
    root, dirs, fixtures, jreport = jax_side
    out = str(root / "port_out")
    rc = eval_parity.main(["--fixtures", fixtures, "--a2m_ckpt", dirs["a2m"], "--s2v_ckpt",
                           dirs["s2v"], "--out", out, "--device", "cpu", "--hparams", HPARAMS,
                           "--no_preset_delta"])
    with open(os.path.join(out, "parity_report.json")) as f:
        report = json.load(f)
    assert rc == 0 and report["pass"] is True
    assert list(report) == list(jreport)
    assert list(report["tolerances"]) == list(jreport["tolerances"])
    assert report["lpips_kind"] == jreport["lpips_kind"] == "surrogate"
    assert report["frames"] == jreport["frames"] == 2
    assert jreport["psnr_mean"] == PSNR_EXACT     # JAX against its own frames
    assert report["psnr_mean"] >= 50.0, report
    frames = np.load(os.path.join(out, "rendered_frames.npy"))
    ref = np.load(os.path.join(fixtures, "ref_frames.npy"))
    want = np.asarray(jimg.psnr(jnp.asarray(frames), jnp.asarray(ref)))
    np.testing.assert_allclose(report["psnr_per_frame"], want, rtol=0, atol=1e-3)
    lp = np.asarray(jimg.lpips_surrogate(jnp.asarray(frames), jnp.asarray(ref)))
    np.testing.assert_allclose(report["lpips_per_frame"], lp, rtol=0, atol=1e-5)


def test_port_selftest_is_exact_on_the_cpu(tmp_path):
    """``--selftest``: mock weights, the port's own fixtures (JAX's arrays
    from the same seed), the same frames rendered twice, bit-equal: PSNR at
    its exact value, pass; the fast-versus-reference delta with JAX's keys."""
    out = str(tmp_path / "selftest")
    rc = eval_parity.main(["--selftest", "--device", "cpu", "--hparams", HPARAMS, "--out", out])
    with open(os.path.join(out, "parity_report.json")) as f:
        report = json.load(f)
    assert rc == 0 and report["pass"] is True
    assert report["psnr_mean"] == PSNR_EXACT and report["frames"] == 4
    np.testing.assert_array_equal(np.load(os.path.join(out, "rendered_frames.npy")),
                                  np.load(os.path.join(out, "fixtures", "ref_frames.npy")))
    inputs = np.load(os.path.join(out, "fixtures", "inputs.npz"))
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(inputs["src_img"],
                                  rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32))
    delta = report["sampling_preset_delta"]
    assert list(delta) == ["fast_preset", "frames", "psnr_fast_vs_reference_mean",
                           "psnr_fast_vs_reference_min", "lpips_kind",
                           "lpips_fast_vs_reference_mean", "weights"]
    assert delta["fast_preset"] == "fast" and delta["weights"] == "mock"
    assert np.isfinite(delta["psnr_fast_vs_reference_mean"])


def test_tool_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_parity.main(["--selftest", "--hparams", HPARAMS, "--out", str(tmp_path)])

"""The JAX package's public surface in the port: every name its subpackage
``__init__`` files export, the host helpers and options that had no
counterpart (landmarks, blink injection, visualisation, the native reader's
probe, ``mirror_index``, ``load_vgg19_params``, ``FrozenConfig``), each
against its JAX twin on seeded numpy inputs."""

import importlib
import os
import pkgutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import real3dportrait_tpu
from tests._torch_parity import agree, t, to_np

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# JAX exports with no counterpart, each with its reason (ROADMAP queue 3
# and "Not to port"): HuBERT from a HuggingFace directory; the plane
# sample and the decoder, fused into kernels K1 and K2
NOT_EXPORTED = {"audio": {"load_hubert_extractor"},
                "rendering": {"run_model", "sample_features"}}


def _jax_subpackages() -> list[str]:
    """Dotted names (below the package) of the JAX subpackages that export names."""
    out = []
    for info in pkgutil.walk_packages(real3dportrait_tpu.__path__, "real3dportrait_tpu."):
        if info.ispkg:
            mod = importlib.import_module(info.name)
            if getattr(mod, "__all__", None):
                out.append(info.name.split(".", 1)[1])
    return sorted(out)


JAX_SUBPACKAGES = _jax_subpackages()


def test_jax_subpackages_found():
    assert {"audio", "config", "geometry", "inference", "models", "rendering",
            "training"} <= set(JAX_SUBPACKAGES)


@pytest.mark.parametrize("sub", JAX_SUBPACKAGES)
def test_port_subpackage_exports_the_jax_names(sub):
    # the port's same subpackage (its config module for the config
    # subpackage) exports each name, in the JAX order, but the recorded ones
    want = [n for n in importlib.import_module(f"real3dportrait_tpu.{sub}").__all__
            if n not in NOT_EXPORTED.get(sub, set())]
    port = importlib.import_module(f"real3dportrait_tpu_torch.{sub}")
    assert list(port.__all__) == want
    for name in want:
        assert getattr(port, name) is not None, name
        assert not getattr(port, name).__module__.startswith("real3dportrait_tpu."), name


def test_port_subpackages_import_without_jax():
    # a fresh interpreter in which jax and flax cannot be imported: every
    # port subpackage and its exports import (no cycle, no stray import)
    subs = JAX_SUBPACKAGES + ["data", "metrics", "parallel", "tools"]
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'flax'):\n"
        "    sys.modules[m] = None\n"
        f"for sub in {sorted(set(subs))!r}:\n"
        "    mod = importlib.import_module('real3dportrait_tpu_torch.' + sub)\n"
        "    for name in getattr(mod, '__all__', []):\n"
        "        getattr(mod, name)\n"
        "assert not any(m.startswith('real3dportrait_tpu.') or m == 'real3dportrait_tpu'\n"
        "               for m in sys.modules)\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-3000:]


# -- the helpers --------------------------------------------------------------------------


def test_compute_landmarks_2d_matches_jax():
    # the synthetic morphable model, seeded coefficients: 1e-4 px
    from real3dportrait_tpu.geometry import bfm as jbfm
    from real3dportrait_tpu_torch.geometry import bfm

    rng = np.random.RandomState(0)
    ident = (rng.randn(3, 80) * 0.3).astype(np.float32)
    exp = (rng.randn(3, 64) * 0.3).astype(np.float32)
    euler = rng.uniform(-0.3, 0.3, (3, 3)).astype(np.float32)
    trans = rng.uniform(-0.1, 0.1, (3, 3)).astype(np.float32)
    want = jbfm.compute_landmarks_2d(jbfm.synthetic_bfm(), *map(jnp.asarray, (ident, exp,
                                                                             euler, trans)))
    got = bfm.compute_landmarks_2d(bfm.synthetic_bfm(), *map(t, (ident, exp, euler, trans)))
    assert got.shape == want.shape == (3, 68, 2)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0, atol=1e-4)


def _secc_with_eyes(t_frames: int, size: int = 32) -> np.ndarray:
    rng = np.random.RandomState(1)
    secc = np.full((t_frames, size, size, 3), -1.0, np.float32)
    secc[:, 4:28, 4:28] = rng.uniform(-0.5, 0.9, (t_frames, 24, 24, 3))
    secc[:, 10:14, 9:14] = -1.0     # left eye hole
    secc[:, 10:15, 18:23] = -1.0    # right eye hole
    return secc


@pytest.mark.parametrize("seed", [0, 3])
def test_inject_blink_to_secc_sequence_matches_jax(seed):
    from real3dportrait_tpu.inference.edit_secc import (
        inject_blink_to_secc_sequence as jax_inject)
    from real3dportrait_tpu_torch.inference.edit_secc import inject_blink_to_secc_sequence

    secc = _secc_with_eyes(60)
    kw = dict(fps=5, period_s=2.0, blink_frames=5, seed=seed)
    got, want = inject_blink_to_secc_sequence(secc, **kw), jax_inject(secc, **kw)
    assert got.tobytes() == want.tobytes()
    assert not np.array_equal(got, secc), "no blink was injected"


def _figure(seed: int):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.RandomState(seed)
    fig = plt.figure(figsize=(3, 2), dpi=50)
    plt.pcolor(rng.rand(8, 12))
    plt.plot(np.arange(12), rng.rand(12) * 8)
    return fig


def test_figure_to_image_matches_jax():
    from real3dportrait_tpu.utils.visualization import figure_to_image as jax_figure_to_image
    from real3dportrait_tpu_torch.utils.visualization import figure_to_image

    got, want = figure_to_image(_figure(2)), jax_figure_to_image(_figure(2))
    assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[-1] == 3
    np.testing.assert_array_equal(got, want)


def test_render_lm3d_video_frames_match_jax(monkeypatch):
    # ffmpeg replaced by a recorder of its command and of the PNGs it would
    # encode, in both modules: the frames byte-equal, the commands equal
    # but for the temporary directory
    import glob

    from real3dportrait_tpu.utils import visualization as jvis
    from real3dportrait_tpu_torch.utils import visualization as pvis

    calls = []

    def fake_run(cmd, **kw):
        pattern = cmd[cmd.index("-i") + 1]
        frames = [open(p, "rb").read() for p in sorted(glob.glob(pattern))]
        calls.append((cmd, kw, frames))
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(subprocess, "run", fake_run)
    rng = np.random.RandomState(4)
    seq = (rng.randn(5, 68, 3) * 4).astype(np.float32)
    for mod in (pvis, jvis):
        mod.render_lm3d_video(seq, "out.mp4", audio_path="a.wav", fps=4, size=64)
    (p_cmd, p_kw, p_frames), (j_cmd, j_kw, j_frames) = calls
    assert len(p_frames) == len(j_frames) == 5
    assert p_frames == j_frames
    assert p_kw == j_kw

    def strip(cmd):
        return [c for c in cmd if "*.png" not in c]
    assert strip(p_cmd) == strip(j_cmd)
    assert p_cmd[-1] == "out.mp4" and "libx264" in p_cmd


def test_imgs_to_video_command_matches_jax(monkeypatch):
    from real3dportrait_tpu.utils import visualization as jvis
    from real3dportrait_tpu_torch.utils import visualization as pvis

    calls = []
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: calls.append((cmd, kw)))
    for mod in (pvis, jvis):
        mod.imgs_to_video("frames", "v.mp4", fps=30, verbose=True)
    assert calls[0] == calls[1]


def test_native_available_matches_jax():
    from real3dportrait_tpu.data.native_reader import native_available as jax_native_available
    from real3dportrait_tpu_torch.data.native_reader import native_available

    assert native_available() is jax_native_available()


@pytest.mark.parametrize("length", [1, 2, 5])
def test_mirror_index_matches_jax(length):
    from real3dportrait_tpu.geometry.camera import mirror_index as jax_mirror_index
    from real3dportrait_tpu_torch.geometry.camera import mirror_index
    from real3dportrait_tpu_torch.inference import pipeline

    assert pipeline.mirror_index is mirror_index
    idx = np.arange(-4, 23)
    got = mirror_index(torch.as_tensor(idx), length)
    np.testing.assert_array_equal(to_np(got), np.asarray(jax_mirror_index(jnp.asarray(idx),
                                                                          length)))
    assert int(mirror_index(7, length)) == int(jax_mirror_index(7, length))


def test_load_vgg19_params_matches_jax(tmp_path):
    from real3dportrait_tpu.models.perceptual import load_vgg19_params as jax_load
    from real3dportrait_tpu_torch.models.perceptual import init_vgg19_params, load_vgg19_params
    from real3dportrait_tpu_torch.utils.msgpack_ckpt import msgpack_serialize

    path = str(tmp_path / "vgg19.msgpack")
    tree = init_vgg19_params(np.random.RandomState(5))
    with open(path, "wb") as f:
        f.write(msgpack_serialize(tree))
    got, want = load_vgg19_params(path), jax_load(path)
    assert sorted(got) == sorted(want)
    for k in got:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(np.asarray(got[k][leaf]), np.asarray(want[k][leaf]))
    assert load_vgg19_params(str(tmp_path / "missing")) is None is jax_load(
        str(tmp_path / "missing"))
    bad = dict(tree, conv0={"kernel": np.zeros((3, 3, 3, 5), np.float32),
                            "bias": np.zeros((5,), np.float32)})
    with open(path, "wb") as f:
        f.write(msgpack_serialize(bad))
    for fn in (load_vgg19_params, jax_load):
        with pytest.raises(ValueError):
            fn(path)


def test_frozen_config_behaves_as_jax(tmp_path):
    from real3dportrait_tpu.config import FrozenConfig as JaxFrozenConfig
    from real3dportrait_tpu_torch.config import FrozenConfig, load_config

    data = {"model": {"lr": 1e-4, "widths": [32, 64]}, "name": "x",
            "stages": [{"k": 1}, {"k": 2}]}
    cfg, jcfg = FrozenConfig(data), JaxFrozenConfig(data)
    assert cfg.model.lr == cfg["model"]["lr"] == jcfg.model.lr
    assert cfg.model.widths == jcfg.model.widths == (32, 64)
    assert cfg.stages[1].k == 2 and cfg.get("missing", 7) == 7
    assert cfg.to_dict() == jcfg.to_dict() == data
    assert cfg == data and cfg == jcfg.to_dict() and hash(cfg) == hash(jcfg)
    assert repr(cfg) == repr(jcfg)
    with pytest.raises(TypeError):
        cfg.name = "y"
    with pytest.raises(AttributeError):
        cfg.nothing  # noqa: B018
    assert cfg.replace(name="y").to_dict() == jcfg.replace(name="y").to_dict()
    dotted = {"model.lr": 0.5, "new.deep.key": 1}
    assert cfg.replace_dotted(dotted).to_dict() == jcfg.replace_dotted(dotted).to_dict()
    cfg.save(str(tmp_path / "a" / "c.yaml"))
    jcfg.save(str(tmp_path / "b" / "c.yaml"))
    assert open(tmp_path / "a" / "c.yaml").read() == open(tmp_path / "b" / "c.yaml").read()
    # the port's loader keeps returning a plain dict, which FrozenConfig wraps
    loaded = load_config(os.path.join(ROOT, "configs", "secc_img2plane.yaml"))
    assert type(loaded) is dict and FrozenConfig(loaded).to_dict() == loaded


# -- the options --------------------------------------------------------------------------


@pytest.mark.parametrize("align_corners,padding_mode", [(True, "zeros"), (False, "border"),
                                                        (True, "border")])
def test_grid_sample_2d_options_match_jax(align_corners, padding_mode):
    from real3dportrait_tpu.ops.grid_sample import grid_sample_2d as jax_grid_sample_2d
    from real3dportrait_tpu_torch.ops.grid_sample import grid_sample_2d

    rng = np.random.RandomState(6)
    feats = rng.randn(2, 7, 9, 5).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (2, 60, 2)).astype(np.float32)
    agree(grid_sample_2d(t(feats), t(coords), align_corners, padding_mode),
          jax_grid_sample_2d(feats, coords, align_corners, padding_mode), 1e-5, 1e-6,
          f"grid_sample_2d {align_corners} {padding_mode}")


def test_partial_load_strict_shapes_and_verbose_match_jax(capsys):
    from real3dportrait_tpu.training.checkpoint import partial_load as jax_partial_load
    from real3dportrait_tpu_torch.training.checkpoint import partial_load

    target = {"a": {"w": np.zeros((2, 3), np.float32), "b": np.zeros((3,), np.float32)},
              "c": np.zeros((4,), np.float32)}
    source = {"a": {"w": np.ones((3, 3), np.float32), "b": np.ones((3,), np.float32)}}
    for fn in (partial_load, jax_partial_load):
        with pytest.raises(ValueError, match="shape mismatch at a.w"):
            fn(target, source, strict_shapes=True)
    capsys.readouterr()
    got, got_stats = partial_load(target, source, verbose=True)
    got_out = capsys.readouterr().out
    want, want_stats = jax_partial_load(target, source, verbose=True)
    assert got_out == capsys.readouterr().out and "skip a.w" in got_out
    assert got_stats == want_stats == {"loaded": 1, "shape_mismatch": 1, "missing": 1}
    np.testing.assert_array_equal(got["a"]["b"], want["a"]["b"])


def test_parallel_map_ordered_matches_jax():
    import math

    from real3dportrait_tpu.preprocess.parallel_map import parallel_map as jax_parallel_map
    from real3dportrait_tpu_torch.preprocess.parallel_map import parallel_map

    kw = dict(num_workers=3, ordered=False, use_threads=True)
    assert parallel_map(math.factorial, range(12), **kw) == jax_parallel_map(
        math.factorial, range(12), **kw) == [math.factorial(i) for i in range(12)]


@pytest.mark.parametrize("factor,t_in", [(2, 20), (3, 17)])
def test_downsample_time_linear_matches_jax(factor, t_in):
    from real3dportrait_tpu.models.audio2motion import downsample_time as jax_downsample_time
    from real3dportrait_tpu_torch.models.audio2motion import downsample_time

    x = np.random.RandomState(factor).randn(2, t_in, 6).astype(np.float32)
    for method in ("linear", "nearest"):
        got = downsample_time(t(x), factor, method=method)
        want = jax_downsample_time(jnp.asarray(x), factor, method=method)
        agree(got, want, 1e-6, 1e-7, f"downsample_time {method}")
    with pytest.raises(ValueError):
        downsample_time(t(x), factor, method="cubic")

"""Parity of the port's sampling study (``real3dportrait_tpu_torch/tools/
study_sampling.py``) with the JAX tool (``tools/study_sampling.py``) at a
16^2 ray grid on the CPU, where K2 and K3 run their plain versions, and of
the weights-in resampler ``rendering/renderer.py:sample_importance``."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real3dportrait_tpu.rendering.ray_marcher import march_weights as jax_march_weights
from real3dportrait_tpu.rendering.renderer import sample_importance as jax_sample_importance
from real3dportrait_tpu_torch.rendering.ray_marcher import march_weights
from real3dportrait_tpu_torch.rendering.renderer import sample_importance
from real3dportrait_tpu_torch.tools import study_sampling as study
from tests._torch_parity import agree, t, to_np
from tools import study_sampling as jax_study

torch.set_num_threads(1)
RES = 16
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jax_lines():
    """The JAX tool's output at RES^2, run once."""
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.setenv("STUDY_RES", str(RES))
        jax_study.main()
    return buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def port_rows():
    lines = []
    return study.study(RES, CPU, keep=True, log=lines.append), lines


def _parse(line: str) -> tuple[str, float, float, float, float]:
    name, nums = line[:40].rstrip(), line[40:].split()
    return (name, *map(float, nums))


def test_study_prints_the_jax_header(jax_lines, port_rows):
    _, lines = port_rows
    assert lines[:2] == jax_lines[:2]
    assert len(lines) == len(jax_lines) == 2 + len(study.SCHEMES)


@pytest.mark.parametrize("i", range(len(study.SCHEMES)))
def test_study_row_matches_jax(jax_lines, port_rows, i):
    # the JAX values are printed rounded (PSNR to 0.01 dB, MAE to 1e-4):
    # PSNR within 0.05 dB, depth MAE within 1e-4, rows/ray equal
    rows, lines = port_rows
    name, n_rows, p_gt, p_ref, mae = _parse(jax_lines[2 + i])
    row = rows[i]
    assert row["name"] == name == study.SCHEMES[i][0]
    assert _parse(lines[2 + i])[0] == name
    assert row["rows"] == n_rows
    assert abs(row["psnr_gt"] - p_gt) <= 0.05, (row["psnr_gt"], p_gt)
    if i == 0:
        assert row["psnr_ref"] == p_ref == float("inf")
    else:
        assert abs(row["psnr_ref"] - p_ref) <= 0.05, (row["psnr_ref"], p_ref)
    assert abs(row["depth_mae"] - mae) <= 1e-4, (row["depth_mae"], mae)


def test_study_rays_match_jax():
    # the frontal camera's rays and the missing rays' bounds (the max of
    # the valid rays' starts): float rounding only
    from real3dportrait_tpu.geometry import fov_to_intrinsics, lookat_pose
    from real3dportrait_tpu.geometry.camera import pack_camera, unpack_camera
    from real3dportrait_tpu.rendering import math_utils
    from real3dportrait_tpu.rendering.ray_sampler import sample_rays

    cam = pack_camera(lookat_pose(jnp.zeros((1,)), jnp.zeros((1,)), jnp.zeros((1, 3))),
                      fov_to_intrinsics())
    origins, dirs = sample_rays(*unpack_camera(cam), RES)
    start, end, valid = math_utils.get_ray_limits_box(origins, dirs, 1.0)
    smin = jnp.min(jnp.where(valid[..., None], start, 1e10))
    smax = jnp.max(jnp.where(valid[..., None], start, -1e10))
    want = (origins, dirs, jnp.where(valid[..., None], start, smin),
            jnp.where(valid[..., None], end, smax))
    for got, w, what in zip(study.study_rays(RES, CPU), want, ("origins", "dirs", "start",
                                                                "end")):
        agree(got, w, 1e-6, 1e-7, what)


@pytest.mark.parametrize("name", ["32+48 merged", "48+64 fine-only march",
                                  "lowres/4 coarse 48 + 64 fine-only"])
def test_render_two_pass_matches_jax(name):
    # one scheme of each path on the same rays: the render bound of
    # test_torch_render.py, 1e-4 of scale max, 1e-5 mean
    kw = dict(study.SCHEMES)[name]
    rays = study.study_rays(RES, CPU)
    rgb, depth = study.render_two_pass(*rays, res=RES, **kw)
    want_rgb, want_depth = jax_study.render_two_pass(*(jnp.asarray(to_np(r)) for r in rays),
                                                     res=RES, **kw)
    agree(rgb, want_rgb, 1e-4, 1e-5, f"{name} rgb")
    agree(depth, want_depth, 1e-4, 1e-5, f"{name} depth")


@pytest.mark.parametrize("sigma", [5.0, 30.0, 100.0])
def test_eval_field_matches_jax(sigma):
    # the inverse softplus on both branches (sigma above and below 20)
    rng = np.random.RandomState(7)
    o = rng.uniform(-0.2, 0.2, (1, 40, 3)).astype(np.float32)
    d = rng.randn(1, 40, 3).astype(np.float32)
    dep = np.sort(rng.uniform(0.0, 0.6, (1, 40, 12, 1)), axis=2).astype(np.float32)
    scale = sigma / 90.0
    rgb, sig = study.eval_field(t(o * scale), t(d), t(dep))
    want_rgb, want_sig = jax_study.eval_field(jnp.asarray(o * scale), jnp.asarray(d),
                                              jnp.asarray(dep))
    agree(rgb, want_rgb, 1e-5, 1e-6, "field rgb")
    agree(sig, want_sig, 1e-5, 1e-6, "field sigma")
    assert torch.isfinite(sig).all()


@pytest.mark.parametrize("s,n", [(16, 32), (48, 64)])
def test_sample_importance_matches_jax(s, n):
    # K2's bounds (test_torch_render.py): 1e-5 of the depth scale max, 1e-6
    # mean; weights from the march of random densities, plus a smooth
    # positive field as the upsampled proposals give
    rng = np.random.RandomState(8)
    start = rng.uniform(1.8, 2.2, (1, 120, 1, 1)).astype(np.float32)
    depths = (start + 0.8 * (np.arange(s, dtype=np.float32) + 0.5)[None, None, :, None] / s)
    sigma = (rng.randn(1, 120, s, 1) * 3).astype(np.float32)
    w_march, _, _ = jax_march_weights(jnp.asarray(sigma), jnp.asarray(depths))
    w_smooth = rng.uniform(0.0, 0.2, (1, 120, s - 1, 1)).astype(np.float32)
    for w in (np.asarray(w_march), w_smooth):
        want = jax_sample_importance(jnp.asarray(depths), jnp.asarray(w), n, None)
        got = sample_importance(t(depths), t(w), n)
        agree(got, want, 1e-5, 1e-6, "sample_importance")
        assert np.all(np.diff(to_np(got)[..., 0], axis=-1) >= 0)
    # the port's march weights give the same fine depths
    w_port, _, _ = march_weights(t(sigma), t(depths))
    agree(sample_importance(t(depths), w_port, n),
          jax_sample_importance(jnp.asarray(depths), w_march, n, None), 1e-5, 1e-6,
          "sample_importance on the port's weights")


def test_sample_importance_draws_match_jax():
    # with draws: JAX's uniform draw replayed through the port's draws,
    # sorted by both, gives the same fine depths
    import jax

    from real3dportrait_tpu_torch.utils.draws import ReplayDraws

    rng = np.random.RandomState(9)
    depths = np.sort(rng.uniform(2.0, 3.0, (2, 30, 24, 1)), axis=2).astype(np.float32)
    w = rng.uniform(0.0, 0.3, (2, 30, 23, 1)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jax_sample_importance(jnp.asarray(depths), jnp.asarray(w), 40, key)
    u = np.asarray(jax.random.uniform(key, (60, 40)))
    got = sample_importance(t(depths), t(w), 40, draws=ReplayDraws([("uniform", u)]))
    agree(got, want, 1e-5, 1e-6, "sample_importance with draws")


def test_study_cli_requires_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        study.study(RES)

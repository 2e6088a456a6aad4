"""Parity of the port's geometry with the JAX package: morphable-model assets
and ops, cameras, and the SECC raster (kernel K4's plain version, what the
wrapper runs on CPU tensors)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real3dportrait_tpu.geometry import bfm as jbfm
from real3dportrait_tpu.geometry import camera as jcam
from real3dportrait_tpu.geometry.secc_renderer import SECCRenderer as JaxSECCRenderer
from real3dportrait_tpu_torch.geometry import bfm, camera
from real3dportrait_tpu_torch.geometry.rasterizer import (
    project_to_screen,
    rasterize_verts,
    secc_raster_plain,
)
from real3dportrait_tpu_torch.geometry.secc_renderer import (
    SECCRenderer,
    resize_bilinear_nhwc,
)
from tests._torch_parity import agree, t, to_np

torch.set_num_threads(1)

_FIELDS = ("mean_shape", "id_base", "exp_base", "key_mean_shape", "key_id_base",
           "key_exp_base", "keypoints", "face_buf", "ncc_code")


@pytest.mark.parametrize("n_vertices,n_keypoints", [(512, 68), (3000, 468)])
def test_synthetic_bfm_assets_bit_equal(n_vertices, n_keypoints):
    ja = jbfm.synthetic_bfm(n_vertices, n_keypoints=n_keypoints)
    ta = bfm.synthetic_bfm(n_vertices, n_keypoints=n_keypoints)
    for f in _FIELDS:
        want = np.asarray(getattr(ja, f))
        got = to_np(getattr(ta, f))
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert (ta.n_vertices, ta.n_faces, ta.n_keypoints) == (ja.n_vertices, ja.n_faces,
                                                           ja.n_keypoints)


def test_face_vertex_chain_matches_jax():
    # same fp32 matmuls and trig: 1e-6 of the vertex scale
    rng = np.random.RandomState(0)
    ja, ta = jbfm.synthetic_bfm(512), bfm.synthetic_bfm(512)
    idc, exp = (rng.randn(2, 80) * 0.5).astype(np.float32), (rng.randn(2, 64) * 0.5).astype(np.float32)
    euler = rng.uniform(-0.3, 0.3, (2, 3)).astype(np.float32)
    trans = rng.uniform(-0.2, 0.2, (2, 3)).astype(np.float32)
    want = jbfm.compute_face_vertex(ja, *map(jnp.asarray, (idc, exp, euler, trans)))
    got = bfm.compute_face_vertex(ta, *map(t, (idc, exp, euler, trans)))
    agree(got, want, 1e-6, 1e-7, "camera-space vertices")
    agree(bfm.compute_rotation(t(euler)), jbfm.compute_rotation(jnp.asarray(euler)),
          1e-6, 1e-7, "rotation")


def test_cameras_match_jax():
    # fp32 trig, norms and a 3x3 SVD: 1e-5 of scale max, 1e-6 mean
    rng = np.random.RandomState(1)
    euler = rng.uniform(-0.3, 0.3, (9, 3)).astype(np.float32)
    trans = rng.uniform(-0.2, 0.2, (9, 3)).astype(np.float32)
    want = jcam.convert_eg3d_convention(jnp.asarray(euler), jnp.asarray(trans))
    got = camera.convert_eg3d_convention(t(euler), t(trans))
    for g, w, name in zip(got, want, ("c2w", "conv_c2w", "intrinsics")):
        agree(g, w, 1e-6, 1e-7, name)
    packed = camera.pack_camera(got[1], got[2][0])
    agree(packed, jcam.pack_camera(want[1], want[2][0]), 1e-6, 1e-7, "pack_camera")
    c2w, intr = camera.unpack_camera(packed)
    assert torch.equal(c2w, got[1]) and torch.equal(intr, got[2])
    agree(camera.smooth_camera_sequence(packed),
          jcam.smooth_camera_sequence(jnp.asarray(to_np(packed))), 1e-5, 1e-6, "smooth")
    yaw, pitch = rng.uniform(-0.5, 0.5, (2, 4)).astype(np.float32)
    look = np.tile(np.array([[0.0, 0.0, 0.2]], np.float32), (4, 1))
    agree(camera.lookat_pose(t(yaw), t(pitch), t(look)),
          jcam.lookat_pose(jnp.asarray(yaw), jnp.asarray(pitch), jnp.asarray(look)),
          1e-6, 1e-7, "lookat_pose")
    agree(camera.fov_to_intrinsics(), jcam.fov_to_intrinsics(), 1e-7, 1e-8, "intrinsics")


@pytest.mark.parametrize("size", [64, 96])
def test_plain_zbuffer_matches_jax_secc_renderer(size):
    # Coverage does not depend on which face wins, so masks may differ only
    # where the JAX bucketed patches miss a pixel: bound 0.5% of pixels.
    # The JAX winner is the least 15-bit-quantised depth with ties in no
    # order, the port's the least exact depth; adjacent faces agree on the
    # NCC along their shared edge, so the NCC agrees within 1e-4 wherever
    # both masks cover the pixel.
    rng = np.random.RandomState(2)
    idc = (rng.randn(3, 80) * 0.5).astype(np.float32)
    exp = (rng.randn(3, 64) * 0.5).astype(np.float32)
    zero = np.zeros((3, 3), np.float32)
    jm, js = JaxSECCRenderer(jbfm.synthetic_bfm(512), rasterize_size=size).render(
        *map(jnp.asarray, (idc, exp, zero, zero)))
    tm, ts = SECCRenderer(bfm.synthetic_bfm(512), rasterize_size=size, device="cpu").render(
        *map(t, (idc, exp, zero, zero)))
    jm, js, tm, ts = map(to_np, (jm, js, tm, ts))
    assert tm.shape == (3, size, size, 1) and ts.shape == (3, size, size, 3)
    assert 0.2 < tm.mean() < 0.9, "the mesh should cover part of the frame"
    assert (jm != tm).mean() <= 0.005
    both = (jm[..., 0] > 0) & (tm[..., 0] > 0)
    assert np.abs(js - ts).max(-1)[both].max() <= 1e-4
    outside = tm[..., 0] == 0
    assert np.all(ts[outside] == -1.0), "background must map to -1"


def test_secc_renderer_upsample_matches_jax_resize():
    # F.interpolate(bilinear, align_corners=False) vs jax.image.resize
    # bilinear for upsampling by a non-integer factor (the pipeline's
    # 192 -> 512): 1e-6 of scale
    x = np.random.RandomState(3).randn(2, 24, 24, 3).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 64, 64, 3), method="bilinear")
    agree(resize_bilinear_nhwc(t(x), 64), want, 1e-6, 1e-7, "resize 24->64")
    mask, secc = SECCRenderer(bfm.synthetic_bfm(512), rasterize_size=24,
                              output_resolution=64, device="cpu").render(
        *(torch.zeros((1, n)) for n in (80, 64, 3, 3)))
    assert mask.shape == (1, 64, 64, 1) and secc.shape == (1, 64, 64, 3)


def test_secc_raster_wrapper_uses_plain_on_cpu_and_rejects_other_devices():
    # K4's wrapper takes camera-space vertices; on CPU tensors it is its
    # plain version, project_to_screen + secc_raster_plain, its map taken
    # from [0,1] to [-1,1]
    ta = bfm.synthetic_bfm(512)
    verts = bfm.compute_face_vertex(ta, *(torch.zeros((1, n)) for n in (80, 64, 3, 3)))
    uv, z = project_to_screen(verts, 1015.0, 112.0, 48)
    attr = ((ta.ncc_code + 1) / 2).contiguous()
    m1, i1 = rasterize_verts(verts, ta.face_buf, attr, 1015.0, 112.0, 48)
    m2, i2 = secc_raster_plain(uv, z, ta.face_buf, attr, 48)
    assert torch.equal(m1, m2) and torch.equal(i1, i2 * 2.0 - 1.0)
    with pytest.raises(ValueError):
        rasterize_verts(verts.to("meta"), ta.face_buf.to("meta"), attr.to("meta"),
                        1015.0, 112.0, 48)


@pytest.mark.parametrize("bad", [-1, 512])
def test_assets_reject_face_indices_outside_the_mesh(bad):
    # the raster kernel reads vertices at the face indices unchecked
    ta = bfm.synthetic_bfm(512)
    faces = to_np(ta.face_buf).copy()
    faces[7, 1] = bad
    with pytest.raises(ValueError, match="face indices"):
        bfm._make_assets(to_np(ta.mean_shape), to_np(ta.id_base), to_np(ta.exp_base),
                         to_np(ta.keypoints), faces, to_np(ta.ncc_code))

"""BFM09 parametric 3D face model on PyTorch tensors.

Port of ``real3dportrait_tpu/geometry/bfm.py``. The assets are built in
numpy exactly as the JAX package builds them (bit-equal arrays), then held
as float32/int32 tensors; every operation is a batched function of tensors.

Conventions (shared with the reference ``ParametricFaceModel``):

* shape = mean + id_base @ id(80) + exp_base @ exp(64), xyz interleaved;
* ``compute_rotation(euler)`` returns ``(Rz @ Ry @ Rx)^T`` for ``pts @ R + t``;
* camera looks down +z at distance 10; ``to_camera`` maps ``z -> 10 - z``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

DEFAULT_CAMERA_DISTANCE = 10.0
DEFAULT_FOCAL = 1015.0
DEFAULT_CENTER = 112.0


@dataclasses.dataclass(frozen=True)
class BFMAssets:
    """Morphable-model bases (float32 tensors; index tensors int32)."""

    mean_shape: torch.Tensor      # [3N] recentered mean shape
    id_base: torch.Tensor         # [3N, 80]
    exp_base: torch.Tensor        # [3N, 64]
    key_mean_shape: torch.Tensor  # [K, 3]
    key_id_base: torch.Tensor     # [3K, 80]
    key_exp_base: torch.Tensor    # [3K, 64]
    keypoints: torch.Tensor       # [K] vertex indices
    face_buf: torch.Tensor        # [F, 3] triangle vertex indices
    ncc_code: torch.Tensor        # [N, 3] per-vertex NCC colour in [-1, 1]
    n_vertices: int = 0
    n_faces: int = 0
    n_keypoints: int = 0

    def to(self, device: torch.device | str) -> "BFMAssets":
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **moved)


def _make_assets(mean_shape, id_base, exp_base, keypoints, face_buf, ncc_code) -> BFMAssets:
    n = mean_shape.size // 3
    # the raster kernel reads vertices at these indices unchecked
    if face_buf.size and (face_buf.min() < 0 or face_buf.max() >= n):
        raise ValueError(f"face indices must lie in [0, {n}), got "
                         f"[{face_buf.min()}, {face_buf.max()}]")
    ms = mean_shape.reshape(-1, 3)
    ms = ms - ms.mean(axis=0, keepdims=True)
    key_mean_shape = ms[keypoints]
    key_id_base = id_base.reshape(n, 3, -1)[keypoints].reshape(-1, id_base.shape[-1])
    key_exp_base = exp_base.reshape(n, 3, -1)[keypoints].reshape(-1, exp_base.shape[-1])

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32))

    return BFMAssets(
        mean_shape=f32(ms.reshape(-1)),
        id_base=f32(id_base),
        exp_base=f32(exp_base),
        key_mean_shape=f32(key_mean_shape),
        key_id_base=f32(key_id_base),
        key_exp_base=f32(key_exp_base),
        keypoints=i32(keypoints),
        face_buf=i32(face_buf),
        ncc_code=f32(ncc_code),
        n_vertices=int(n),
        n_faces=int(face_buf.shape[0]),
        n_keypoints=int(np.asarray(keypoints).shape[0]),
    )


def load_bfm(bfm_dir: str, keypoint_mode: str = "lm68") -> BFMAssets:
    """Load BFM09 assets from ``BFM_model_front.mat`` (+ optional aux npys)."""
    from scipy.io import loadmat

    model = loadmat(os.path.join(bfm_dir, "BFM_model_front.mat"))
    mean_shape = model["meanshape"].astype(np.float32).reshape(-1)
    id_base = model["idBase"].astype(np.float32)
    exp_base = model["exBase"].astype(np.float32)
    face_buf = model["tri"].astype(np.int64) - 1
    if keypoint_mode == "mediapipe":
        kp = np.load(os.path.join(bfm_dir, "index_mp468_from_mesh35709.npy")).astype(np.int64)
        kp[kp < 0] = 0
    else:
        kp = np.squeeze(model["keypoints"]).astype(np.int64) - 1
    ncc_path = os.path.join(bfm_dir, "ncc_code.npy")
    if os.path.isfile(ncc_path):
        ncc = np.load(ncc_path).astype(np.float32)
        if ncc.shape[0] == 3 and ncc.shape[-1] != 3:
            ncc = ncc.T
    else:
        ncc = _default_ncc_code(mean_shape)
    return _make_assets(mean_shape, id_base, exp_base, kp, face_buf, ncc)


def _default_ncc_code(mean_shape: np.ndarray) -> np.ndarray:
    """Normalized Coordinate Code: mean-shape xyz min-max normalized to [-1,1]."""
    v = mean_shape.reshape(-1, 3).astype(np.float64)
    lo, hi = v.min(axis=0), v.max(axis=0)
    return (2.0 * (v - lo) / (hi - lo) - 1.0).astype(np.float32)


def synthetic_bfm(
    n_vertices: int = 512,
    n_keypoints: int = 68,
    n_id: int = 80,
    n_exp: int = 64,
    seed: int = 0,
) -> BFMAssets:
    """Deterministic stand-in morphable model: a lat-long sphere at the BFM09
    face-box scale with a local triangulation and small random bases."""
    rng = np.random.RandomState(seed)
    rows = max(int(np.sqrt(n_vertices / 2)), 2)
    cols = max(n_vertices // rows, 2)
    n_grid = rows * cols
    theta = np.linspace(0.15, np.pi - 0.15, rows)
    phi = np.linspace(0, 2 * np.pi, cols, endpoint=False)
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    pts = np.stack(
        [np.sin(tt) * np.cos(pp), np.cos(tt), np.sin(tt) * np.sin(pp)], axis=-1
    ).reshape(-1, 3)
    if n_grid < n_vertices:
        extra = pts[: n_vertices - n_grid] * 0.999
        pts = np.concatenate([pts, extra], axis=0)
    pts = pts[:n_vertices]
    mean_shape = (pts * 0.9).astype(np.float32).reshape(-1)

    def vid(r, c):
        return r * cols + (c % cols)

    quads = [
        (vid(r, c), vid(r + 1, c), vid(r + 1, c + 1), vid(r, c + 1))
        for r in range(rows - 1)
        for c in range(cols)
    ]
    face_buf = np.array(
        [(a, b, c) for a, b, c, d in quads] + [(a, c, d) for a, b, c, d in quads],
        np.int64,
    )
    face_buf = face_buf[(face_buf < n_vertices).all(axis=1)]

    id_base = (rng.randn(3 * n_vertices, n_id) * 1e-3).astype(np.float32)
    exp_base = (rng.randn(3 * n_vertices, n_exp) * 1e-3).astype(np.float32)
    kp = rng.choice(n_vertices, size=n_keypoints, replace=False).astype(np.int64)
    ncc = _default_ncc_code(mean_shape)
    return _make_assets(mean_shape, id_base, exp_base, kp, face_buf, ncc)


def load_or_synthetic_bfm(bfm_dir: str | None, keypoint_mode: str = "lm68") -> BFMAssets:
    if bfm_dir and os.path.isfile(os.path.join(bfm_dir, "BFM_model_front.mat")):
        return load_bfm(bfm_dir, keypoint_mode=keypoint_mode)
    return synthetic_bfm(n_keypoints=468 if keypoint_mode == "mediapipe" else 68)


def compute_shape(assets: BFMAssets, id_coeff: torch.Tensor, exp_coeff: torch.Tensor) -> torch.Tensor:
    """[B,80],[B,64] -> [B,N,3] face shape in model space."""
    flat = (id_coeff @ assets.id_base.T + exp_coeff @ assets.exp_base.T
            + assets.mean_shape[None, :])
    return flat.reshape(id_coeff.shape[0], -1, 3)


def compute_rotation(euler: torch.Tensor) -> torch.Tensor:
    """[B,3] radians (pitch-x, yaw-y, roll-z) -> [B,3,3], R = (Rz Ry Rx)^T."""
    x, y, z = euler[:, 0], euler[:, 1], euler[:, 2]
    cx, sx = torch.cos(x), torch.sin(x)
    cy, sy = torch.cos(y), torch.sin(y)
    cz, sz = torch.cos(z), torch.sin(z)
    one = torch.ones_like(cx)
    zero = torch.zeros_like(cx)
    rot_x = torch.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx], -1).reshape(-1, 3, 3)
    rot_y = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy], -1).reshape(-1, 3, 3)
    rot_z = torch.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one], -1).reshape(-1, 3, 3)
    return (rot_z @ rot_y @ rot_x).transpose(-1, -2)


def transform(shape: torch.Tensor, rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """[B,N,3] @ [B,3,3] + [B,3] -> world-space shape."""
    return shape @ rot + trans[:, None, :]


def to_camera(shape: torch.Tensor, camera_distance: float = DEFAULT_CAMERA_DISTANCE) -> torch.Tensor:
    """Flip the depth axis into the camera frame: z -> d - z."""
    return torch.cat([shape[..., :2], camera_distance - shape[..., 2:]], dim=-1)


def compute_face_vertex(
    assets: BFMAssets,
    id_coeff: torch.Tensor,
    exp_coeff: torch.Tensor,
    euler: torch.Tensor,
    trans: torch.Tensor,
    camera_distance: float = DEFAULT_CAMERA_DISTANCE,
) -> torch.Tensor:
    """coeffs -> camera-space vertices [B,N,3]."""
    shape = compute_shape(assets, id_coeff, exp_coeff)
    shape = transform(shape, compute_rotation(euler), trans)
    return to_camera(shape, camera_distance)


def compute_key_shape(assets: BFMAssets, id_coeff: torch.Tensor,
                      exp_coeff: torch.Tensor) -> torch.Tensor:
    """[B,80],[B,64] -> [B,K,3] landmark subset of the face shape."""
    flat = (id_coeff @ assets.key_id_base.T + exp_coeff @ assets.key_exp_base.T
            + assets.key_mean_shape.reshape(-1)[None, :])
    return flat.reshape(id_coeff.shape[0], -1, 3)


def perspective_projection_matrix(focal: float = DEFAULT_FOCAL,
                                  center: float = DEFAULT_CENTER,
                                  device: torch.device | str = "cpu") -> torch.Tensor:
    """Row-vector projection matrix P with pts @ P semantics."""
    return torch.tensor([[focal, 0, center], [0, focal, center], [0, 0, 1]],
                        dtype=torch.float32, device=device).T


def to_image(shape_cam: torch.Tensor, focal: float = DEFAULT_FOCAL,
             center: float = DEFAULT_CENTER) -> torch.Tensor:
    """[B,N,3] camera-space -> [B,N,2] pixel coordinates (224 scale)."""
    proj = shape_cam @ perspective_projection_matrix(focal, center, shape_cam.device)
    return proj[..., :2] / proj[..., 2:]

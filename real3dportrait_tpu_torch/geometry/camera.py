"""Camera pose construction and convention conversion on PyTorch tensors.

Port of ``real3dportrait_tpu/geometry/camera.py``. The EG3D camera vector is
25-d: ``concat(flatten(c2w 4x4), flatten(intrinsics 3x3))``.
"""

from __future__ import annotations

import math

import torch

from real3dportrait_tpu_torch.geometry.bfm import compute_rotation

DEFAULT_FOV_DEGREES = 18.837
EG3D_CAMERA_RADIUS = 2.7

_EG3D_CONVENTION_FOCAL = 2985.29 / 700.0
_EG3D_TRANS_SCALE = 0.27
_EG3D_TRANS_OFFSET = (0.0, 0.006, 0.161)


def normalize(v: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + eps)


def fov_to_intrinsics(fov_degrees: float = DEFAULT_FOV_DEGREES,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """FOV -> normalized 3x3 intrinsics."""
    focal = 1.0 / (math.tan(fov_degrees * math.pi / 360.0) * 1.414)
    return torch.tensor([[focal, 0.0, 0.5], [0.0, focal, 0.5], [0.0, 0.0, 1.0]],
                        dtype=torch.float32, device=device)


def create_cam2world_matrix(forward_vector: torch.Tensor, origin: torch.Tensor,
                            roll: torch.Tensor | None = None) -> torch.Tensor:
    """[B,3] forward, [B,3] origin (+ optional [B] roll) -> [B,4,4]; the
    rotation block's columns are (right, up, forward)."""
    b = forward_vector.shape[0]
    forward = normalize(forward_vector)
    if roll is None:
        roll = torch.zeros((b,), dtype=forward.dtype, device=forward.device)
    roll = roll.reshape(b)
    up = torch.stack([torch.sin(roll), torch.cos(roll), torch.zeros_like(roll)], -1)
    right = -normalize(torch.linalg.cross(up, forward))
    up = normalize(torch.linalg.cross(forward, right))
    c2w = torch.zeros((b, 4, 4), dtype=forward.dtype, device=forward.device)
    c2w[:, :3, :3] = torch.stack([right, up, forward], dim=-1)
    c2w[:, :3, 3] = origin
    c2w[:, 3, 3] = 1.0
    return c2w


def lookat_pose(horizontal: torch.Tensor, vertical: torch.Tensor,
                lookat_position: torch.Tensor, radius: float = EG3D_CAMERA_RADIUS,
                roll: torch.Tensor | None = None) -> torch.Tensor:
    """Angles (radians offset from frontal) -> [B,4,4] cam2world looking at
    ``lookat_position``."""
    h = horizontal + math.pi / 2
    v = torch.clamp(vertical + math.pi / 2, 1e-5, math.pi - 1e-5)
    cam = torch.stack([
        radius * torch.sin(v) * torch.cos(math.pi - h),
        radius * torch.cos(v),
        radius * torch.sin(v) * torch.sin(math.pi - h),
    ], dim=-1)
    origin = cam + lookat_position
    forward = normalize(lookat_position - origin)
    return create_cam2world_matrix(forward, origin, roll)


def sample_uniform_pose(draws, batch_size: int, pitch_range: float = math.radians(26.0),
                        yaw_range: float = math.radians(38.0),
                        lookat_position: torch.Tensor | None = None,
                        radius: float = EG3D_CAMERA_RADIUS,
                        device: torch.device | str = "cpu") -> torch.Tensor:
    """[B,4,4] cam2world with pitch and yaw uniform around frontal (the
    distillation's +-26 / +-38 degrees), looking at ``lookat_position``
    (default (0, 0, 0.2)). ``draws`` is a ``utils/draws.Draws`` or a
    ``torch.Generator`` (on ``device``); pitch is drawn first, then yaw."""
    if isinstance(draws, torch.Generator):
        from real3dportrait_tpu_torch.utils.draws import Draws

        draws = Draws(draws)
    if lookat_position is None:
        lookat_position = torch.tensor([0.0, 0.0, 0.2], device=device)
    pitch = draws.uniform((batch_size,), device, -pitch_range, pitch_range)
    yaw = draws.uniform((batch_size,), device, -yaw_range, yaw_range)
    look = lookat_position.to(device).expand(batch_size, 3)
    return lookat_pose(yaw, pitch, look, radius=radius)


def pack_camera(c2w: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """[B,4,4],[B or 1,3,3] -> [B,25]."""
    b = c2w.shape[0]
    intr = intrinsics.reshape(-1, 9).expand(b, 9)
    return torch.cat([c2w.reshape(b, 16), intr], dim=-1)


def unpack_camera(camera: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B,25] -> ([B,4,4] c2w, [B,3,3] intrinsics)."""
    return camera[:, :16].reshape(-1, 4, 4), camera[:, 16:25].reshape(-1, 3, 3)


def convert_eg3d_convention(euler: torch.Tensor, trans: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched 3DMM (euler, trans) -> (c2w, convention_c2w, intrinsics),
    shapes [B,4,4], [B,4,4], [B,3,3]."""
    b = euler.shape[0]
    dev = euler.device
    rot = compute_rotation(euler)
    t = trans.to(torch.float32).clone()
    t[:, 2] = t[:, 2] - 10.0
    c = -torch.einsum("bij,bj->bi", rot, t)
    c = c * _EG3D_TRANS_SCALE + torch.tensor(_EG3D_TRANS_OFFSET, device=dev)[None]

    flip = torch.diag(torch.tensor([1.0, -1.0, -1.0], device=dev))
    c2w = torch.zeros((b, 4, 4), dtype=torch.float32, device=dev)
    c2w[:, :3, :3] = rot @ flip[None]
    c2w[:, :3, 3] = c
    c2w[:, 3, 3] = 1.0

    radius = torch.linalg.norm(c, dim=-1, keepdim=True)
    conv_c2w = c2w.clone()
    conv_c2w[:, :3, 3] = c / torch.clamp(radius, min=1e-9) * EG3D_CAMERA_RADIUS

    f = _EG3D_CONVENTION_FOCAL
    intrinsics = torch.tensor([[f, 0.0, 0.5], [0.0, f, 0.5], [0.0, 0.0, 1.0]],
                              dtype=torch.float32, device=dev).expand(b, 3, 3)
    return c2w, conv_c2w, intrinsics


def smooth_camera_sequence(camera: torch.Tensor, kernel_size: int = 7) -> torch.Tensor:
    """Box-filter a [T,25] camera sequence along time (reflect padding) and
    re-orthonormalize each rotation with an SVD; intrinsics pass through."""
    t = camera.shape[0]
    kernel_size = min(kernel_size, 2 * t - 1)
    if kernel_size % 2 == 0:
        kernel_size -= 1
    if t < 2 or kernel_size < 3:
        return camera
    pad = kernel_size // 2
    c2w = camera[:, :16]
    padded = torch.cat([c2w[1:pad + 1].flip(0), c2w, c2w[-1 - pad:-1].flip(0)], dim=0)
    smoothed = padded.unfold(0, kernel_size, 1).mean(dim=-1)  # [T,16]
    sm = smoothed.reshape(t, 4, 4).clone()
    u, _, vt = torch.linalg.svd(sm[:, :3, :3])
    sm[:, :3, :3] = u @ vt
    return torch.cat([sm.reshape(t, 16), camera[:, 16:]], dim=-1)


def mirror_index(idx: torch.Tensor | int, length: int) -> torch.Tensor:
    """Ping-pong looping index: 0, 1, ..., length - 1, length - 2, ..., 1, 0, 1, ..."""
    period = 2 * (length - 1) if length > 1 else 1
    r = torch.remainder(torch.as_tensor(idx), period)
    return torch.where(r < length, r, period - r)

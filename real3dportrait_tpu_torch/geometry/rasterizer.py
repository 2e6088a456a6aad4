"""Forward z-buffer rasterizer for the fixed-topology BFM mesh.

Port of the semantics of ``real3dportrait_tpu/geometry/rasterizer.py``
(``project_to_screen`` and the two-pass scatter z-buffer of
``rasterize_scatter``): screen-space affine barycentrics at pixel centres
(pytorch3d ``perspective_correct=False``), coverage ``b >= 0`` inclusive,
``|area| > 1e-9`` and ``znear < depth < zfar``; the camera is
u = c + f·x/z, v = c − f·y/z scaled from the 2·center fit frame.

The winner of a pixel is the face of least exact depth, ties broken by the
lower face id, through a 64-bit key ``(float bits of depth) << 32 | face``.
The JAX package quantises depth to the key's low bits and breaks ties in no
fixed order, so at pixels where two faces' depths agree to within that
quantum the two packages may pick different (adjacent) faces.

:func:`rasterize_verts` is the wrapper of kernel K4 (``csrc/secc_raster.cu``),
which projects the camera-space vertices itself, as the JAX
``rasterize_grouped`` does; its plain PyTorch version,
:func:`rasterize_verts_plain`, is :func:`project_to_screen` followed by
:func:`secc_raster_plain`, with the map taken from [0,1] to the SECC
renderer's [-1,1].
"""

from __future__ import annotations

import torch

from real3dportrait_tpu_torch import kernels

_EMPTY = torch.iinfo(torch.int64).max


def project_to_screen(verts_cam: torch.Tensor, focal: float, center: float,
                      image_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """[B,N,3] camera-space verts -> ([B,N,2] pixel uv, [B,N] depth)."""
    scale = image_size / (2.0 * center)
    x, y, z = verts_cam[..., 0], verts_cam[..., 1], verts_cam[..., 2]
    u = (center + focal * x / z) * scale
    v = (center - focal * y / z) * scale
    return torch.stack([u, v], dim=-1), z


def _edge(ax, ay, bx, by, px, py):
    return (px - ax) * (by - ay) - (py - ay) * (bx - ax)


def _barycentric(fuv: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """fuv [...,3,2] face corners, px/py broadcastable pixel centres ->
    (b0, b1, b2, area) in the JAX package's operation order."""
    x0, y0 = fuv[..., 0, 0], fuv[..., 0, 1]
    x1, y1 = fuv[..., 1, 0], fuv[..., 1, 1]
    x2, y2 = fuv[..., 2, 0], fuv[..., 2, 1]
    area = _edge(x0, y0, x1, y1, x2, y2)
    while area.dim() < px.dim():
        area, x0, y0, x1, y1, x2, y2 = (a[..., None] for a in (area, x0, y0, x1, y1, x2, y2))
    b0 = _edge(x1, y1, x2, y2, px, py) / area
    b1 = _edge(x2, y2, x0, y0, px, py) / area
    b2 = _edge(x0, y0, x1, y1, px, py) / area
    return b0, b1, b2, area


def secc_raster_plain(uv: torch.Tensor, z: torch.Tensor, faces: torch.Tensor,
                      attr: torch.Tensor, image_size: int, znear: float = 5.0,
                      zfar: float = 15.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K4: uv [T,N,2], z [T,N], faces [F,3] int, attr [N,3] ->
    (mask [T,H,W], image [T,H,W,3]); a ``scatter_reduce("amin")`` z-buffer
    over each face's pixel bounding box, then a per-pixel resolve."""
    t_frames = uv.shape[0]
    hw = image_size * image_size
    faces_l = faces.long()
    face_id = torch.arange(faces.shape[0], device=uv.device)
    masks, images = [], []
    for t in range(t_frames):
        fuv = uv[t][faces_l]                                  # [F,3,2]
        fz = z[t][faces_l]                                    # [F,3]
        # each face's pixel box, clipped to the image
        lo = torch.floor(fuv.min(dim=1).values).clamp(min=0)  # [F,2]
        hi = torch.floor(fuv.max(dim=1).values).clamp(max=image_size - 1)
        k = int((hi - lo).nan_to_num(0.0).max().clamp(0, image_size - 1).item()) + 1
        offs = torch.arange(k, device=uv.device, dtype=uv.dtype)
        xs = lo[:, 0, None, None] + offs[None, None, :]       # [F,1,K]
        ys = lo[:, 1, None, None] + offs[None, :, None]       # [F,K,1]
        px, py = xs + 0.5, ys + 0.5
        b0, b1, b2, area = _barycentric(fuv, px, py)
        depth = (b0 * fz[:, 0, None, None] + b1 * fz[:, 1, None, None]
                 + b2 * fz[:, 2, None, None])
        valid = ((b0 >= 0) & (b1 >= 0) & (b2 >= 0) & (area.abs() > 1e-9)
                 & (xs <= hi[:, 0, None, None]) & (ys <= hi[:, 1, None, None])
                 & (xs >= 0) & (xs < image_size) & (ys >= 0) & (ys < image_size)
                 & (depth > znear) & (depth < zfar))
        pix = (ys * image_size + xs).long().clamp(0, hw - 1)
        pix = torch.where(valid, pix, torch.full_like(pix, hw))
        key = (depth.contiguous().view(torch.int32).long() << 32) | face_id[:, None, None]
        zbuf = torch.full((hw + 1,), _EMPTY, dtype=torch.int64, device=uv.device)
        zbuf.scatter_reduce_(0, pix.reshape(-1), key.reshape(-1), "amin")
        zbuf = zbuf[:hw]
        covered = zbuf != _EMPTY
        win = torch.where(covered, zbuf & 0xFFFFFFFF, torch.zeros_like(zbuf))
        wf = faces_l[win]                                     # [HW,3]
        pidx = torch.arange(hw, device=uv.device)
        cx = (pidx % image_size).to(uv.dtype) + 0.5
        cy = (pidx // image_size).to(uv.dtype) + 0.5
        wb0, wb1, wb2, _ = _barycentric(uv[t][wf], cx, cy)
        a = attr[wf]                                          # [HW,3,C]
        img = wb0[:, None] * a[:, 0] + wb1[:, None] * a[:, 1] + wb2[:, None] * a[:, 2]
        masks.append(covered.to(uv.dtype).reshape(image_size, image_size))
        img = torch.where(covered[:, None], img, torch.zeros_like(img))
        images.append(img.reshape(image_size, image_size, -1))
    return torch.stack(masks), torch.stack(images)


def rasterize_verts_plain(verts_cam: torch.Tensor, faces: torch.Tensor, attr: torch.Tensor,
                          focal: float = 1015.0, center: float = 112.0, image_size: int = 512,
                          znear: float = 5.0, zfar: float = 15.0
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K4: camera-space verts [T,N,3], faces [F,3] int, attr
    [N,3] in [0,1] -> (mask [T,H,W], SECC map [T,H,W,3] in [-1,1]):
    :func:`project_to_screen`, :func:`secc_raster_plain`, then
    ``image * 2 - 1`` (-1 outside the mask)."""
    uv, z = project_to_screen(verts_cam, focal, center, image_size)
    mask, image = secc_raster_plain(uv, z, faces, attr, image_size, znear, zfar)
    return mask, image * 2.0 - 1.0


# one z-buffer per (device, size, stream), as many frames as the largest
# call so far, all EMPTY between calls: the kernel's resolve cleans every
# word that its z-test wrote
_ZBUFFERS: dict[tuple, torch.Tensor] = {}


def rasterize_verts(verts_cam: torch.Tensor, faces: torch.Tensor, attr: torch.Tensor,
                    focal: float = 1015.0, center: float = 112.0, image_size: int = 512,
                    znear: float = 5.0, zfar: float = 15.0
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4 wrapper: same contract as :func:`rasterize_verts_plain`.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``verts_cam`` fp32 [T,N,3], ``faces`` int32 [F,3], ``attr`` fp32
    [N,3], ``znear >= 0``) or raise. The kernel does not bounds-check
    ``faces``: every index must lie in [0, N), as ``geometry.bfm`` checks
    for the ``face_buf`` of every mesh it loads or synthesises. Calls on one
    stream share a z-buffer, so call it from one host thread at a time.
    """
    if verts_cam.device.type == "cpu":
        return rasterize_verts_plain(verts_cam, faces, attr, focal, center, image_size, znear,
                                     zfar)
    name = "secc_raster"
    verts_cam = verts_cam.contiguous()
    kernels.require(name, "verts_cam", verts_cam)
    kernels.require(name, "faces", faces, torch.int32)
    kernels.require(name, "attr", attr)
    t_frames, n = verts_cam.shape[:2]
    if verts_cam.shape != (t_frames, n, 3) or faces.dim() != 2 or faces.shape[1] != 3 \
            or attr.shape != (n, 3) or znear < 0:
        raise ValueError(f"{name}: bad arguments verts {tuple(verts_cam.shape)} faces "
                         f"{tuple(faces.shape)} attr {tuple(attr.shape)} znear {znear}")
    if t_frames > 65535:
        raise ValueError(f"{name}: the kernel puts the frames on the grid's y axis, at most "
                         f"65535 a call; got {t_frames}")
    dev = verts_cam.device
    key = (dev.index, image_size, torch.cuda.current_stream(dev).cuda_stream)
    zbuf = _ZBUFFERS.get(key)
    if zbuf is None or zbuf.shape[0] < t_frames:
        zbuf = _ZBUFFERS[key] = torch.full((t_frames, image_size * image_size), _EMPTY,
                                           dtype=torch.int64, device=dev)
    mask = torch.empty((t_frames, image_size, image_size), device=dev)
    image = torch.empty((t_frames, image_size, image_size, 3), device=dev)
    try:
        kernels.launch("r3dp_secc_raster", verts_cam, t_frames, n, faces, faces.shape[0], attr,
                       focal, center, image_size / (2.0 * center), image_size, znear, zfar,
                       zbuf, mask, image)
    except RuntimeError:
        del _ZBUFFERS[key]  # a launch that failed may have left keys in it
        raise
    rasterize_verts.launches += 1
    return mask, image


rasterize_verts.launches = 0

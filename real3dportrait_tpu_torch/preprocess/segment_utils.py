"""Source-image preparation on the host from a segmentation map (port of
``real3dportrait_tpu/preprocess/segment_utils.py``, the port's own copy;
numpy and scipy):

* :func:`inpaint_torso`: the head-free torso image, with the band a moving
  head may expose above the torso and neck filled by darkened vertical
  streaks;
* :func:`extract_background_knn`: a person-free background, per pixel from
  the frame where it lies farthest from any person pixel (distance
  transforms);
* :func:`prepare_source`: the head / inpainted-torso / background split of
  one source image for inference;
* :func:`crop_on_face_area`: the enlarge-to-face crop, so that the face
  covers at least ``min_percent`` of the square image.

Segmap classes (MediaPipe's convention): 0 background, 1 hair, 2 body skin
and neck, 3 face, 4 clothes and torso, 5 other. Every function takes a
class-index map [H,W]; images are uint8 RGB [H,W,3].
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

HEAD_CLASSES = (1, 3, 5)
NECK_CLASS = 2
TORSO_CLASS = 4


def _streak_up(img: np.ndarray, paint_mask: np.ndarray, source_rows: np.ndarray,
               cols: np.ndarray, colors: np.ndarray, length: int,
               darken: float = 0.98) -> None:
    """Paint ``colors`` upward from (source_rows, cols) for ``length`` rows,
    darkening by ``darken**k`` per step; records painted pixels in
    ``paint_mask``. In-place."""
    for k in range(length):
        rows = source_rows - k
        valid = rows >= 0
        if not valid.any():
            break
        img[rows[valid], cols[valid]] = (
            colors[valid].astype(np.float32) * (darken ** k)
        ).astype(img.dtype)
        paint_mask[rows[valid], cols[valid]] = True


def _top_pixels_per_column(part: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """For each column with any True in ``part``, the row of its top-most
    True pixel. Returns (rows, cols)."""
    h = part.shape[0]
    rows_idx = np.where(part, np.arange(h)[:, None], h)
    top = rows_idx.min(axis=0)  # [W]
    cols = np.nonzero(top < h)[0]
    return top[cols], cols


def inpaint_torso(gt_img: np.ndarray, segmap: np.ndarray):
    """Head-free torso image with the exposed band above torso/neck
    inpainted by darkened vertical streaks (``inpaint_torso_job``).

    Returns ``(torso_img, torso_mask)``: uint8 [H,W,3] (zero outside the
    mask) and bool [H,W].
    """
    head = np.isin(segmap, HEAD_CLASSES)
    neck = segmap == NECK_CLASS
    torso = segmap == TORSO_CLASS

    img = gt_img.copy()
    img[head] = 0
    painted = np.zeros(segmap.shape, bool)

    # torso band: columns whose top torso pixel borders head, streak 9 up
    rows, cols = _top_pixels_per_column(torso)
    if rows.size:
        touch = head[np.maximum(rows - 1, 0), cols] & (rows > 0)
        rows, cols = rows[touch], cols[touch]
        _streak_up(img, painted, rows, cols, gt_img[rows, cols], length=9)

    # neck band: vertically dilated, top pushed down up to 4 px, streak 53 up
    v_struct = np.zeros((3, 3), bool)
    v_struct[:, 1] = True
    neck_d = ndimage.binary_dilation(neck, structure=v_struct, iterations=3)
    rows, cols = _top_pixels_per_column(neck_d)
    if rows.size:
        touch = head[np.maximum(rows - 1, 0), cols] & (rows > 0)
        rows, cols = rows[touch], cols[touch]
        # column heights bound the push-down (reference `push_down=4`)
        counts = neck_d[:, cols].sum(axis=0)
        rows = rows + np.minimum(counts - 1, 4)
        rows = np.minimum(rows, segmap.shape[0] - 1)
        neck_mask = np.zeros(segmap.shape, bool)
        _streak_up(img, neck_mask, rows, cols, gt_img[rows, cols], length=53)
        # blur the streaks to avoid vertical-line artifacts (`:223-226`)
        blurred = np.stack([
            ndimage.gaussian_filter(img[..., c].astype(np.float32), sigma=1.1)
            for c in range(img.shape[-1])
        ], axis=-1).astype(img.dtype)
        img[neck_mask] = blurred[neck_mask]
        painted |= neck_mask

    torso_mask = neck_d | torso | painted
    out = img.copy()
    out[~torso_mask] = 0
    return out, torso_mask


def extract_background_knn(frames: np.ndarray, segmaps: np.ndarray,
                           min_dist: float = 10.0) -> np.ndarray:
    """Assemble a person-free background from frames (``extract_background``).

    For each pixel, take the frame where it is farthest from any person
    pixel; pixels never far enough (< ``min_dist``) copy their nearest
    confident background pixel. Distance transforms replace the reference's
    per-frame KD-trees — same metric, fraction of the cost.
    """
    frames = np.asarray(frames)
    if frames.ndim == 3:
        frames, segmaps = frames[None], np.asarray(segmaps)[None]
    t = len(frames)
    interval = 5 if t < 100 else (20 if t < 10000 else t // 500)
    sel = np.arange(0, t, interval) if t > interval else np.arange(min(t, 1))
    frames, segmaps = frames[sel], np.asarray(segmaps)[sel]

    dists = np.stack([
        ndimage.distance_transform_edt(seg == 0) for seg in segmaps
    ])  # [N,H,W]: distance to the nearest person pixel, 0 inside the person
    best = dists.argmax(axis=0)
    max_dist = dists.max(axis=0)

    h, w = max_dist.shape
    idx = np.broadcast_to(best[None, ..., None], (1,) + best.shape + (frames.shape[-1],))
    bg = np.take_along_axis(frames, idx, axis=0)[0].copy()
    confident = max_dist > min_dist
    if confident.any() and not confident.all():
        # fill unconfident pixels from their nearest confident one
        _, (ri, ci) = ndimage.distance_transform_edt(
            ~confident, return_indices=True
        )
        bg[~confident] = bg[ri[~confident], ci[~confident]]
    elif not confident.any():
        # degenerate: person covers everything; leave the farthest-pixel mosaic
        pass
    return bg.astype(frames.dtype)


def prepare_source(img: np.ndarray, segmap: np.ndarray,
                   bg_img: np.ndarray | None = None) -> dict:
    """Head / inpainted-torso / background split of ONE source image for
    inference (`real3d_infer.py:246-262`). ``img`` uint8 [H,W,3]."""
    head = np.isin(segmap, HEAD_CLASSES)
    head_img = np.where(head[..., None], img, 0).astype(np.uint8)
    torso_img, torso_mask = inpaint_torso(img, segmap)
    if bg_img is None:
        bg_img = extract_background_knn(img[None], segmap[None])
    return {
        "head_img": head_img,
        "torso_img": torso_img,
        "torso_mask": torso_mask,
        "bg_img": bg_img,
        "segmap_onehot": np.stack(
            [segmap == c for c in range(6)], axis=-1
        ).astype(np.float32),
    }


def crop_on_face_area(img: np.ndarray, lm2d: np.ndarray,
                      min_percent: float = 0.2) -> np.ndarray:
    """Crop a square so the face bbox occupies >= ``min_percent`` of it,
    then resize back to the input size (`real3d_infer.py:76`,
    ``crop_img_on_face_area_percent``). ``lm2d`` [68,2] in pixels (x, y)."""
    h, w = img.shape[:2]
    x0, y0 = lm2d.min(axis=0)
    x1, y1 = lm2d.max(axis=0)
    face_area = max((x1 - x0) * (y1 - y0), 1.0)
    if face_area / (h * w) >= min_percent:
        return img
    side = int(np.sqrt(face_area / min_percent))
    side = max(side, int(max(x1 - x0, y1 - y0)) + 2)
    cx, cy = int((x0 + x1) / 2), int((y0 + y1) / 2)
    left = int(np.clip(cx - side // 2, 0, w - side)) if side < w else 0
    top = int(np.clip(cy - side // 2, 0, h - side)) if side < h else 0
    side_w, side_h = min(side, w), min(side, h)
    crop = img[top:top + side_h, left:left + side_w]
    # bilinear resize back to the original square size
    zoom = (h / crop.shape[0], w / crop.shape[1], 1)
    return ndimage.zoom(crop, zoom, order=1).astype(img.dtype)

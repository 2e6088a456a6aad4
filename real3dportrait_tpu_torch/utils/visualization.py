"""Visualisation helpers on the host (port of
``real3dportrait_tpu/utils/visualization.py``): debug views of a frame
(``to_uint8``, ``depth_to_colormap``, ``side_by_side``, for the
``concat_debug`` output mode), landmark overlays, image grids and files,
the figures of the validation dumps (spectrogram, attention map,
t-SNE) and a figure as an image, and landmark videos through ffmpeg. cv2,
matplotlib and ffmpeg are used where needed: the card's host may lack
matplotlib and has no ffmpeg."""

from __future__ import annotations

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1,1] float image -> uint8."""
    if img.dtype == np.uint8:
        return img
    return ((np.clip(img, -1, 1) + 1) * 127.5).astype(np.uint8)


def depth_to_colormap(depth: np.ndarray) -> np.ndarray:
    """[H,W] depth -> uint8 heat image (min-max over the positive depths)."""
    import cv2

    d = np.asarray(depth, np.float32)
    mask = d > 0
    if mask.any():
        lo, hi = d[mask].min(), d[mask].max()
        norm = np.where(mask, (d - lo) / max(hi - lo, 1e-9), 0.0)
    else:
        norm = np.zeros_like(d)
    return cv2.applyColorMap((norm * 255).astype(np.uint8), cv2.COLORMAP_VIRIDIS)


def side_by_side(*images: np.ndarray) -> np.ndarray:
    """Horizontal concat, each image resized to the tallest one's height."""
    ims = [to_uint8(im) for im in images]
    h = max(im.shape[0] for im in ims)
    padded = []
    for im in ims:
        if im.ndim == 2:
            im = np.repeat(im[..., None], 3, -1)
        if im.shape[0] != h:
            import cv2

            im = cv2.resize(im, (int(im.shape[1] * h / im.shape[0]), h))
        padded.append(im[..., :3])
    return np.concatenate(padded, axis=1)


def draw_landmarks(img: np.ndarray, lm2d: np.ndarray, radius: int = 2) -> np.ndarray:
    """Draw normalized [0,1] landmarks on an image (eyes red, mouth green,
    rest blue)."""
    import cv2

    out = to_uint8(img).copy()
    h, w = out.shape[:2]
    for i, (x, y) in enumerate(np.asarray(lm2d)):
        if 36 <= i < 48:
            color = (255, 0, 0)
        elif 48 <= i < 68:
            color = (0, 255, 0)
        else:
            color = (0, 0, 255)
        cv2.circle(out, (int(x * w), int(y * h)), radius, color, -1)
    return out


def image_grid(images: list[np.ndarray], cols: int | None = None,
               pad: int = 2) -> np.ndarray:
    """Tile images (same HW) into one grid image for validation dumps."""
    images = [to_uint8(im) for im in images]
    n = len(images)
    cols = cols or int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    h, w = images[0].shape[:2]
    grid = np.full((rows * (h + pad) - pad, cols * (w + pad) - pad, 3), 255,
                   np.uint8)
    for i, im in enumerate(images):
        r, c = divmod(i, cols)
        if im.ndim == 2 or im.shape[-1] == 1:
            im = np.repeat(im.reshape(h, w, 1), 3, axis=-1)
        grid[r * (h + pad): r * (h + pad) + h,
             c * (w + pad): c * (w + pad) + w] = im[..., :3]
    return grid


def save_image(path: str, image: np.ndarray) -> None:
    """Write an RGB (or grey) image to ``path`` through cv2."""
    import cv2

    img = to_uint8(image)
    if img.ndim == 3 and img.shape[-1] == 3:
        img = img[..., ::-1]  # RGB -> BGR for cv2
    cv2.imwrite(path, img)


def spec_to_figure(spec: np.ndarray, vmin: float | None = None,
                   vmax: float | None = None, title: str = "",
                   f0s: np.ndarray | dict | None = None):
    """Mel-spectrogram [T, n_mels] -> matplotlib figure, with optional F0
    overlays scaled onto the mel-bin axis (Hz / 10)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    spec = np.asarray(spec)
    fig = plt.figure(figsize=(12, 6))
    plt.title(title)
    plt.pcolor(spec.T, vmin=vmin, vmax=vmax)
    if f0s is not None:
        if not isinstance(f0s, dict):
            f0s = {"f0": f0s}
        h = spec.shape[1]
        for label, f0 in f0s.items():
            f0 = np.asarray(f0, np.float32)
            plt.plot(np.arange(len(f0)), np.clip(f0 / 10.0, 0, h - 1),
                     label=label, linewidth=1.0)
        plt.legend()
    return fig


def plot_attention_img(attention: np.ndarray, color_bar: str = "jet") -> np.ndarray:
    """[H,W] attention map -> uint8 heat image (min-max, a cv2 colormap)."""
    import cv2

    att = np.asarray(attention, np.float32)
    att = (att - att.min()) / max(att.max() - att.min(), 1e-9)
    cmap = {"jet": cv2.COLORMAP_JET, "viridis": cv2.COLORMAP_VIRIDIS}.get(
        color_bar, cv2.COLORMAP_JET)
    return cv2.applyColorMap((att * 255).astype(np.uint8), cmap)


def tsne_scatter(features: np.ndarray, labels: np.ndarray | None = None,
                 title: str = "t-SNE", perplexity: float = 30.0,
                 seed: int = 0):
    """[N,D] features -> 2-D t-SNE scatter figure.

    Uses sklearn when present; otherwise a numpy PCA-initialized
    Barnes-Hut-free gradient t-SNE (small N — validation embeddings).
    """
    feats = np.asarray(features, np.float32)
    try:
        from sklearn.manifold import TSNE  # type: ignore

        emb = TSNE(n_components=2, perplexity=min(perplexity,
                                                  max(2, len(feats) // 4)),
                   random_state=seed, init="pca").fit_transform(feats)
    except Exception:
        emb = _tsne_numpy(feats, perplexity=min(perplexity,
                                                max(2.0, len(feats) / 4)),
                          seed=seed)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(6, 6))
    plt.title(title)
    if labels is None:
        plt.scatter(emb[:, 0], emb[:, 1], s=8)
    else:
        labels = np.asarray(labels)
        for lab in np.unique(labels):
            m = labels == lab
            plt.scatter(emb[m, 0], emb[m, 1], s=8, label=str(lab))
        plt.legend()
    return fig


def _tsne_numpy(x: np.ndarray, perplexity: float = 30.0, n_iter: int = 300,
                seed: int = 0) -> np.ndarray:
    """Minimal exact t-SNE (O(N^2), fine for validation-sized N)."""
    n = len(x)
    rng = np.random.RandomState(seed)
    # pairwise affinities with per-point bandwidth matched to perplexity
    d2 = np.square(x[:, None] - x[None]).sum(-1)
    p = np.zeros((n, n))
    target = np.log(perplexity)
    for i in range(n):
        lo, hi, beta = 1e-20, 1e20, 1.0
        di = np.delete(d2[i], i)
        for _ in range(40):
            e = np.exp(-di * beta)
            s = e.sum() + 1e-12
            h = np.log(s) + beta * (di * e).sum() / s
            if h > target:
                lo = beta
                beta = beta * 2 if hi > 1e19 else (beta + hi) / 2
            else:
                hi = beta
                beta = beta / 2 if lo < 1e-19 else (beta + lo) / 2
        row = np.exp(-d2[i] * beta)
        row[i] = 0
        p[i] = row / (row.sum() + 1e-12)
    p = (p + p.T) / (2 * n)
    p = np.maximum(p, 1e-12)

    # PCA init
    xc = x - x.mean(0)
    _, _, vt = np.linalg.svd(xc, full_matrices=False)
    y = xc @ vt[:2].T * 1e-2 + rng.randn(n, 2) * 1e-4
    gain, inc = np.ones_like(y), np.zeros_like(y)
    for it in range(n_iter):
        num = 1.0 / (1.0 + np.square(y[:, None] - y[None]).sum(-1))
        np.fill_diagonal(num, 0)
        q = np.maximum(num / num.sum(), 1e-12)
        pq = (p * (4.0 if it < 100 else 1.0)) - q
        grad = 4 * ((pq * num)[:, :, None] * (y[:, None] - y[None])).sum(1)
        gain = np.where(np.sign(grad) != np.sign(inc), gain + 0.2, gain * 0.8)
        gain = np.maximum(gain, 0.01)
        inc = 0.8 * inc - 200.0 * gain * grad
        y = y + inc
        y = y - y.mean(0)
    return y


def figure_to_image(fig) -> np.ndarray:
    """Matplotlib figure -> uint8 RGB array [H,W,3] (its PNG, tight bounds,
    decoded); the figure is closed."""
    import io

    import cv2
    import matplotlib.pyplot as plt

    buf = io.BytesIO()
    fig.savefig(buf, format="png", bbox_inches="tight")
    plt.close(fig)
    arr = np.frombuffer(buf.getvalue(), np.uint8)
    return cv2.cvtColor(cv2.imdecode(arr, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def imgs_to_video(img_dir: str, video_path: str, audio_path: str | None = None,
                  fps: int = 25, verbose: bool = False) -> None:
    """The PNG frames of ``img_dir`` (in name order) -> an H.264 video
    through ``ffmpeg``, with ``audio_path`` muxed in (cut to the shorter)
    where given. Raises where ffmpeg is missing or fails."""
    import subprocess

    cmd = ["ffmpeg", "-y", "-framerate", str(fps), "-pattern_type", "glob",
           "-i", f"{img_dir}/*.png"]
    if audio_path:
        cmd += ["-i", audio_path, "-shortest"]
    cmd += ["-c:v", "libx264", "-pix_fmt", "yuv420p", video_path]
    subprocess.run(cmd, check=True, capture_output=not verbose)


def render_lm3d_video(lm3d_seq: np.ndarray, out_path: str, audio_path: str | None = None,
                      fps: int = 25, size: int = 512) -> None:
    """Landmark offsets [T,K,3] -> a video of black dots on white, size^2:
    each frame's offsets / 10 taken from [-1, 1] onto the pixel grid (y
    up), written as PNGs and encoded by :func:`imgs_to_video`."""
    import os
    import tempfile

    import cv2

    seq = np.asarray(lm3d_seq, np.float32)
    with tempfile.TemporaryDirectory() as td:
        for t in range(len(seq)):
            img = np.full((size, size, 3), 255, np.uint8)
            xy = ((seq[t, :, :2] / 10.0 * 0.5 + 0.5) * (size - 1)).astype(int)
            for x, y in xy:
                cv2.circle(img, (int(x), int(size - 1 - y)), 2, (0, 0, 0), -1)
            cv2.imwrite(os.path.join(td, f"{t:06d}.png"), img)
        imgs_to_video(td, out_path, audio_path, fps=fps)

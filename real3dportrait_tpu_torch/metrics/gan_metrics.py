"""Generator evaluation: FID / KID / IS / precision-recall / PPL with a
metric registry (port of ``real3dportrait_tpu/metrics/gan_metrics.py``).

The statistics (Frechet distance, polynomial-kernel MMD, KL-based IS,
k-NN precision and recall) are the JAX package's numpy code; the feature
extractors run on the images' device. The default extractor is a fixed
random-projection conv net, whose scores compare checkpoints of one run
but not published numbers: ``calc_metric`` stamps the payload with the
extractor. Its weights are drawn from a ``torch.Generator``, which cannot
reproduce JAX's ``jax.random`` draws, so the two packages' default
extractors differ; given the same weights (``weights=``) they agree.
Real Inception weights (``inception_ckpt``) give the comparable FID.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from real3dportrait_tpu_torch import entry_device
from real3dportrait_tpu_torch.utils.draws import seeded_draws

_METRICS: dict[str, Callable] = {}


def register_metric(fn: Callable) -> Callable:
    """Decorator registry (`metric_main.py:31`)."""
    _METRICS[fn.__name__] = fn
    return fn


def list_metrics() -> list[str]:
    return sorted(_METRICS)


def calc_metric(name: str, **kwargs) -> dict:
    """Run a registered metric; the payload is the JAX package's, key for
    key: ``results``, ``metric`` and, for the feature metrics, ``extractor``
    ("custom" where one was given, else "random_projection") and
    ``comparable_to_published``."""
    if name not in _METRICS:
        raise KeyError(f"unknown metric {name!r}; known: {list_metrics()}")
    value = _METRICS[name](**kwargs)
    out = {"results": {name: value}, "metric": name}
    if name in ("fid", "kid", "pr50k"):
        custom = kwargs.get("extractor") is not None
        out["extractor"] = "custom" if custom else "random_projection"
        out["comparable_to_published"] = bool(custom)
    return out


# --- statistics (numpy, as the JAX package computes them) ---------------------


def _matrix_sqrt_eig(mat: np.ndarray) -> np.ndarray:
    """PSD matrix square root by symmetric eigendecomposition."""
    vals, vecs = np.linalg.eigh(mat)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    """FID between two feature sets [N,D], [M,D]: the trace term through
    sqrt(sqrt(Ca) Cb sqrt(Ca)), which shares the trace of sqrt(Ca Cb)."""
    mu_a, mu_b = feats_a.mean(0), feats_b.mean(0)
    cov_a = np.cov(feats_a, rowvar=False)
    cov_b = np.cov(feats_b, rowvar=False)
    diff = mu_a - mu_b
    sqrt_a = _matrix_sqrt_eig(cov_a)
    inner = _matrix_sqrt_eig(sqrt_a @ cov_b @ sqrt_a)
    return float(diff @ diff + np.trace(cov_a) + np.trace(cov_b) - 2 * np.trace(inner))


def kernel_distance(feats_a: np.ndarray, feats_b: np.ndarray,
                    max_subset_size: int = 1000, num_subsets: int = 10,
                    seed: int = 0) -> float:
    """KID: polynomial-kernel MMD^2, averaged over seeded subsets."""
    rng = np.random.RandomState(seed)
    n = feats_a.shape[1]
    m = min(min(len(feats_a), len(feats_b)), max_subset_size)
    total = 0.0
    for _ in range(num_subsets):
        x = feats_a[rng.choice(len(feats_a), m, replace=False)].astype(np.float64)
        y = feats_b[rng.choice(len(feats_b), m, replace=False)].astype(np.float64)
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        total += (a.sum() - np.trace(a)) / (m - 1) - b.sum() * 2 / m
    return float(total / num_subsets / m)


def inception_score(probs: np.ndarray, num_splits: int = 10) -> tuple[float, float]:
    """IS over class probabilities [N,C]: (mean, std) over the splits."""
    scores = []
    n = len(probs)
    for i in range(num_splits):
        part = probs[i * n // num_splits: (i + 1) * n // num_splits]
        kl = part * (np.log(part + 1e-12) - np.log(part.mean(0, keepdims=True) + 1e-12))
        scores.append(np.exp(kl.sum(1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


def _distance_rows(samples: np.ndarray, manifold: np.ndarray, block_bytes: int):
    """(start, [rows, M] distances) over row blocks of ``samples``: JAX's
    ``norm(samples[:, None] - manifold[None], axis=-1)`` with the difference
    array at most ``block_bytes`` (at least a row) at a time, element for
    element the same values."""
    row = max(1, manifold.size * samples.dtype.itemsize)
    step = max(1, block_bytes // row)
    for i in range(0, len(samples), step):
        yield i, np.linalg.norm(samples[i:i + step, None] - manifold[None], axis=-1)


def precision_recall(real_feats: np.ndarray, fake_feats: np.ndarray,
                     nhood_size: int = 3, block_bytes: int = 1 << 28
                     ) -> tuple[float, float]:
    """Improved precision / recall (Kynkaanniemi et al.): a sample counts
    where it falls inside the k-NN hypersphere of the other set. The
    JAX package's values; its N x N x D difference array taken in row
    blocks of at most ``block_bytes``, so that 50k rows fit."""

    def manifold_radii(feats):
        radii = np.empty(len(feats), feats.dtype)
        for i, d in _distance_rows(feats, feats, block_bytes):
            d[np.arange(len(d)), i + np.arange(len(d))] = np.inf
            radii[i:i + len(d)] = np.sort(d, axis=1)[:, nhood_size - 1]
        return radii

    def coverage(samples, manifold, radii):
        hits = np.zeros(len(samples), bool)
        for i, d in _distance_rows(samples, manifold, block_bytes):
            hits[i:i + len(d)] = np.any(d <= radii[None], axis=1)
        return float(np.mean(hits))

    r_real = manifold_radii(real_feats)
    r_fake = manifold_radii(fake_feats)
    precision = coverage(fake_feats, real_feats, r_real)
    recall = coverage(real_feats, fake_feats, r_fake)
    return precision, recall


# --- feature extractors ---------------------------------------------------------


def _batched(fn: Callable, device: torch.device, batch: int) -> Callable:
    """images [N,H,W,3] (numpy or a tensor) -> fn's features as fp32 numpy,
    ``batch`` images at a time on ``device``."""

    @torch.no_grad()
    def extract(images) -> np.ndarray:
        outs = []
        for i in range(0, len(images), batch):
            x = torch.as_tensor(np.asarray(images[i:i + batch]) if not torch.is_tensor(images)
                                else images[i:i + batch])
            outs.append(fn(x.to(device, torch.float32)).cpu().numpy())
        return np.concatenate(outs, 0)

    return extract


def _conv_same(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """NCHW conv with JAX's ``SAME`` padding: ceil(n / stride) outputs,
    the padding split low = total // 2, high = the rest (for a 64^2 image,
    k 5, stride 4: (0, 1))."""
    k = w.shape[-1]
    pads = []
    for n in (x.shape[3], x.shape[2]):           # F.pad's order: w, then h
        out = -(-n // stride)
        total = max((out - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), w, stride=stride)


def random_projection_weights(feature_dim: int = 512, seed: int = 0) -> tuple:
    """(w1 [5,5,3,32], w2 [3,3,32,64], w_out [128, feature_dim]) fp32, HWIO,
    drawn from a ``torch.Generator`` seeded with ``seed`` with JAX's scales."""
    g = torch.Generator().manual_seed(int(seed))
    return (torch.randn((5, 5, 3, 32), generator=g) / np.sqrt(75),
            torch.randn((3, 3, 32, 64), generator=g) / np.sqrt(288),
            torch.randn((64 * 2, feature_dim), generator=g) / np.sqrt(128))


def make_random_projection_extractor(feature_dim: int = 512, seed: int = 0, batch: int = 32,
                                     weights: tuple | None = None,
                                     device="cuda") -> Callable:
    """Deterministic conv random-feature extractor on ``device``: images
    [N,H,W,3] in [-1,1] -> features [N, feature_dim] (fp32 numpy).
    ``weights`` (w1, w2, w_out), HWIO as JAX holds them, replace the
    seeded draw (:func:`random_projection_weights`)."""
    dev = entry_device(device)
    w1, w2, w_out = weights if weights is not None else random_projection_weights(
        feature_dim, seed)
    w1, w2 = (torch.as_tensor(np.asarray(w)).permute(3, 2, 0, 1).contiguous().to(dev)
              for w in (w1, w2))
    w_out = torch.as_tensor(np.asarray(w_out)).to(dev)

    def features(x):
        h = F.leaky_relu(_conv_same(x.permute(0, 3, 1, 2), w1, 4), 0.2)
        h = F.leaky_relu(_conv_same(h, w2, 4), 0.2)
        pooled = torch.cat([h.mean(dim=(2, 3)), h.amax(dim=(2, 3))], -1)
        return pooled @ w_out

    return _batched(features, dev, batch)


def make_inception_extractor(weights_path: str, batch: int = 16,
                             device="cuda") -> Callable | None:
    """InceptionV3 pool features from a ``convert_inception`` msgpack tree
    (pytorch-fid convention), the comparable-FID path; None where the
    weight file is absent."""
    from real3dportrait_tpu_torch.metrics.inception import (
        inception_pool_features, load_inception_params,
    )

    dev = entry_device(device)
    model = load_inception_params(weights_path, dev)
    if model is None:
        return None
    return _batched(lambda x: inception_pool_features(model, x), dev, batch)


def resolve_extractor(cfg=None, device="cuda") -> tuple[Callable, str]:
    """(extractor, kind): Inception where ``cfg['inception_ckpt']`` holds
    weights, else the random projection. The kind goes next to any
    reported score."""
    cfg = cfg or {}
    inc = make_inception_extractor(str(cfg.get("inception_ckpt", "") or ""), device=device)
    if inc is not None:
        return inc, "inception_v3"
    return make_random_projection_extractor(device=device), "random_projection"


# --- registered metrics -----------------------------------------------------------


@register_metric
def fid(real_images=None, fake_images=None, extractor=None, **kw) -> float:
    extractor = extractor or make_random_projection_extractor(device=kw.get("device", "cuda"))
    return frechet_distance(extractor(real_images), extractor(fake_images))


@register_metric
def kid(real_images=None, fake_images=None, extractor=None, **kw) -> float:
    extractor = extractor or make_random_projection_extractor(device=kw.get("device", "cuda"))
    return kernel_distance(extractor(real_images), extractor(fake_images),
                           max_subset_size=kw.get("max_subset_size", 1000),
                           num_subsets=kw.get("num_subsets", 10))


def perceptual_path_length(synth_fn, z_dim: int, n_samples: int = 64, epsilon: float = 1e-4,
                           seed: int = 0, distance_fn=None, draws=None,
                           device="cuda") -> float:
    """PPL: the mean perceptual distance between renders at slerp(z0, z1, t)
    and at t + eps, over eps^2. ``synth_fn(z [N,z_dim]) -> images
    [N,H,W,3]``; ``distance_fn`` defaults to the LPIPS surrogate. z0, z1
    (normal) and t (uniform) come from ``draws`` (``utils/draws.py``;
    seeded with ``seed`` on ``device`` by default), in JAX's order."""
    from real3dportrait_tpu_torch.metrics.image_metrics import lpips_surrogate

    dev = entry_device(device)
    distance_fn = distance_fn or lpips_surrogate
    draws = draws or seeded_draws(seed, dev)
    z0 = draws.normal((n_samples, z_dim), dev)
    z1 = draws.normal((n_samples, z_dim), dev)
    t = draws.uniform((n_samples, 1), dev)

    def slerp(a, b, tt):
        a_n = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
        b_n = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
        omega = torch.arccos(torch.clamp((a_n * b_n).sum(-1, keepdim=True), -1, 1))
        so = torch.sin(omega)
        return (torch.sin((1 - tt) * omega) / so) * a + (torch.sin(tt * omega) / so) * b

    with torch.no_grad():
        d = distance_fn(synth_fn(slerp(z0, z1, t)), synth_fn(slerp(z0, z1, t + epsilon)))
    return float(d.double().mean().cpu() / epsilon ** 2)


@register_metric
def pr50k(real_images=None, fake_images=None, extractor=None, **kw) -> dict:
    extractor = extractor or make_random_projection_extractor(device=kw.get("device", "cuda"))
    p, r = precision_recall(extractor(real_images), extractor(fake_images),
                            nhood_size=kw.get("nhood_size", 3))
    return {"precision": p, "recall": r}


@register_metric
def ppl(synth_fn=None, z_dim: int = 512, **kw) -> float:
    return perceptual_path_length(synth_fn, z_dim,
                                  n_samples=kw.get("n_samples", 64),
                                  epsilon=kw.get("epsilon", 1e-4),
                                  seed=kw.get("seed", 0), draws=kw.get("draws"),
                                  device=kw.get("device", "cuda"))

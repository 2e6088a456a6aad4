"""Padding collators and token-bucketed batching (port of
``real3dportrait_tpu/data/collate.py``): pad variable-length sequences into
dense arrays, and group items into batches bounded by both a sentence count
and a token budget. Numpy on the host."""

from __future__ import annotations

import numpy as np


def collate_nd(items: list[np.ndarray], pad_value: float = 0.0,
               max_len: int | None = None) -> np.ndarray:
    """Pad a list of [T, ...] arrays along axis 0 into [B, T_max, ...]."""
    t_max = max(len(x) for x in items) if max_len is None else max_len
    rest = items[0].shape[1:]
    out = np.full((len(items), t_max, *rest), pad_value, dtype=items[0].dtype)
    for i, x in enumerate(items):
        out[i, : len(x)] = x[:t_max]
    return out


def make_mask(lengths: list[int], max_len: int | None = None) -> np.ndarray:
    """[B, T_max] float32 mask, 1 over each item's first ``lengths[i]`` steps."""
    t_max = max(lengths) if max_len is None else max_len
    mask = np.zeros((len(lengths), t_max), np.float32)
    for i, n in enumerate(lengths):
        mask[i, : min(n, t_max)] = 1.0
    return mask


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def batch_by_size(
    indices: list[int],
    sizes: list[int],
    max_tokens: int = 20000,
    max_sentences: int = 512,
    required_batch_size_multiple: int = 1,
    bucket_by_size: bool = True,
) -> list[list[int]]:
    """Group indices into batches bounded by token and sentence budgets;
    sorting by size first keeps the padding small."""
    order = sorted(indices, key=lambda i: sizes[i]) if bucket_by_size else list(indices)
    batches, cur, cur_max = [], [], 0
    for idx in order:
        n = sizes[idx]
        new_max = max(cur_max, n)
        if cur and ((len(cur) + 1) * new_max > max_tokens or len(cur) >= max_sentences):
            keep = len(cur) - len(cur) % required_batch_size_multiple or len(cur)
            batches.append(cur[:keep])
            cur, cur_max = cur[keep:], max((sizes[i] for i in cur[keep:]), default=0)
        cur.append(idx)
        cur_max = max(cur_max, n)
    if cur:
        batches.append(cur)
    return batches

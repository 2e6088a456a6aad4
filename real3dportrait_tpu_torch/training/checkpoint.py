"""Step-indexed checkpoints of the training state (port of
``real3dportrait_tpu/training/checkpoint.py``): ``model_ckpt_steps_<N>.ckpt``
files in the JAX package's msgpack layout, written through the port's own
``utils/msgpack_ckpt.py`` (atomically), keep-newest-K plus every milestone,
and a best-validation copy. The JAX package's ``load_checkpoint`` reads
them, and the port reads the JAX package's. :func:`partial_load` merges a
checkpoint's leaves into a state's tree where their dotted paths and shapes
match (the trainer's lenient restore and ``init_from_ckpt``), renaming
prefixes where asked (the audio-to-motion stage's frozen SyncNet)."""

from __future__ import annotations

import copy
import os

import numpy as np

from real3dportrait_tpu_torch.utils.msgpack_ckpt import (
    _step_of,
    get_all_ckpts,
    get_last_checkpoint,
    load_checkpoint,
    msgpack_serialize,
)
from real3dportrait_tpu_torch.utils.msgpack_ckpt import save_checkpoint as _save

__all__ = ["get_all_ckpts", "get_last_checkpoint", "load_checkpoint", "partial_load",
           "save_checkpoint", "save_best"]


def save_checkpoint(work_dir: str, step: int, tree: dict, num_keep: int = 3,
                    milestone_interval: int = 100000, not_save_keys: tuple = ()) -> str:
    """Write ``tree`` (``TrainState.state_dict()``) and prune: keep the
    ``num_keep`` newest files and every milestone step. ``not_save_keys``
    (the config's ``not_save_modules``) are left out: matched against the
    tree's top-level keys and against the module names inside ``params``,
    ``variables`` and ``opt_states``, as the JAX package matches them."""
    if not_save_keys:
        drop = set(not_save_keys)
        tree = {k: v for k, v in tree.items() if k not in drop}
        for group in ("params", "variables", "opt_states"):
            if isinstance(tree.get(group), dict):
                tree[group] = {k: v for k, v in tree[group].items() if k not in drop}
    path = _save(work_dir, step, tree)
    for old in get_all_ckpts(work_dir)[num_keep:]:
        s = _step_of(old)
        if milestone_interval and s % milestone_interval == 0:
            continue
        os.remove(old)
    return path


def save_best(work_dir: str, tree: dict) -> str:
    path = os.path.join(work_dir, "model_ckpt_best.ckpt")
    with open(path + ".part", "wb") as f:
        f.write(msgpack_serialize(tree))
    os.replace(path + ".part", path)
    return path


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    else:
        yield prefix, tree


def _set_path(tree: dict, path: tuple, value) -> None:
    node = tree
    for p in path[:-1]:
        node = node[p]
    node[path[-1]] = value


def partial_load(target: dict, source: dict, prefix_map: dict | None = None,
                 strict_shapes: bool = False, verbose: bool = False) -> tuple[dict, dict]:
    """Copy the leaves of ``source`` into (a copy of) ``target`` where their
    dotted paths match; a leaf whose shape differs is skipped (printed with
    ``verbose``), or raises ``ValueError`` with ``strict_shapes``.
    ``prefix_map`` {source prefix: target prefix} renames: a target path
    that starts with a target prefix (the first that matches, as a string)
    reads the source path with that prefix replaced. Returns (the merged
    tree, {"loaded", "shape_mismatch", "missing"} counts of the target's
    leaves)."""
    target = copy.deepcopy(target)
    src_leaves = {".".join(p): v for p, v in _flatten(source)}
    stats = {"loaded": 0, "shape_mismatch": 0, "missing": 0}
    for path, tgt_leaf in list(_flatten(target)):
        dotted = src_key = ".".join(path)
        for sp, tp in (prefix_map or {}).items():
            if dotted.startswith(tp):
                src_key = sp + dotted[len(tp):]
                break
        if src_key not in src_leaves:
            stats["missing"] += 1
            continue
        src_leaf = src_leaves[src_key]
        if np.shape(src_leaf) != np.shape(tgt_leaf):
            if strict_shapes:
                raise ValueError(f"shape mismatch at {dotted}: "
                                 f"{np.shape(src_leaf)} vs {np.shape(tgt_leaf)}")
            stats["shape_mismatch"] += 1
            if verbose:
                print(f"| skip {dotted}: {np.shape(src_leaf)} != {np.shape(tgt_leaf)}")
            continue
        _set_path(target, path, np.asarray(src_leaf))
        stats["loaded"] += 1
    return target, stats

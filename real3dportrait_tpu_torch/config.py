"""Experiment YAML for the port, read without the JAX package.

The same semantics as ``real3dportrait_tpu.config.load_config``: a
``base_config:`` path (or list of paths) is loaded depth-first and merged
under the file, then dot-path overrides (``{"a.b": 1}``) are applied. The
result is a plain nested ``dict``; the port reads it with ``cfg.get``.
"""

from __future__ import annotations

import os
from collections.abc import Mapping
from typing import Any

import yaml


def _merge(base: dict, child: dict) -> dict:
    out = dict(base)
    for k, v in child.items():
        if isinstance(out.get(k), dict) and isinstance(v, dict):
            v = _merge(out[k], v)
        out[k] = v
    return out


def _load_with_bases(path: str, seen: frozenset = frozenset()) -> dict:
    path = os.path.abspath(path)
    if path in seen:
        raise ValueError(f"circular base_config chain at {path}")
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    bases = raw.pop("base_config", [])
    merged: dict = {}
    for b in [bases] if isinstance(bases, str) else bases:
        merged = _merge(merged, _load_with_bases(
            os.path.join(os.path.dirname(path), b), seen | {path}))
    return _merge(merged, raw)


def load_config(path: str, overrides: Mapping[str, Any] | None = None) -> dict:
    """Load a YAML experiment config with its ``base_config`` chain."""
    cfg = _load_with_bases(path)
    for dotted, value in (overrides or {}).items():
        *parents, leaf = dotted.split(".")
        node = cfg
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return cfg

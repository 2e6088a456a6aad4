"""Experiment YAML for the port, read without the JAX package.

The same semantics as ``real3dportrait_tpu.config.load_config``: a
``base_config:`` path (or list of paths) is loaded depth-first and merged
under the file, then dot-path overrides (``{"a.b": 1}``, or the CLI's
``"a.b=1,c=true"`` through :func:`parse_overrides`) are applied. The result
is a plain nested ``dict``; the port reads it with ``cfg.get``.
"""

from __future__ import annotations

import os
import re
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


def _parse_scalar(v: str) -> Any:
    """A CLI override value: bool, None, int, float, a YAML list or dict, or
    the string itself."""
    s = v.strip()
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    if s.lower() in ("none", "null"):
        return None
    if re.fullmatch(r"[+-]?\d+", s):
        return int(s)
    try:
        return float(s)
    except ValueError:
        pass
    if s.startswith("[") or s.startswith("{"):
        try:
            return yaml.safe_load(s)
        except yaml.YAMLError:
            pass
    return s


def parse_overrides(spec: str) -> dict[str, Any]:
    """``"a.b=1,c=true,d=[1,2]"`` -> a dot-path dict; commas inside
    brackets and braces do not split."""
    items, cur, depth = [], [], 0
    for ch in spec or "":
        depth += (ch in "[{(") - (ch in "]})")
        if ch == "," and depth == 0:
            items.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    items.append("".join(cur))
    out: dict[str, Any] = {}
    for item in filter(None, (i.strip() for i in items)):
        if "=" not in item:
            raise ValueError(f"override {item!r} must look like key=value")
        k, v = item.split("=", 1)
        out[k.strip()] = _parse_scalar(v)
    return out

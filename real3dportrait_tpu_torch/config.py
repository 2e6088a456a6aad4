"""Experiment YAML for the port, read without the JAX package.

The same semantics as ``real3dportrait_tpu.config.load_config``: a
``base_config:`` path (or list of paths) is loaded depth-first and merged
under the file, then dot-path overrides (``{"a.b": 1}``, or the CLI's
``"a.b=1,c=true"`` through :func:`parse_overrides`) are applied. The result
is a plain nested ``dict``; the port reads it with ``cfg.get``.
:class:`FrozenConfig`, the JAX package's immutable tree with attribute
access, wraps such a dict where a caller wants one.
"""

from __future__ import annotations

import json
import os
import re
from collections.abc import Iterator, Mapping
from typing import Any

import yaml


__all__ = ["FrozenConfig", "load_config", "parse_overrides"]


class FrozenConfig(Mapping):
    """An immutable nested mapping with attribute access: ``cfg.model.lr``
    is ``cfg["model"]["lr"]``, ``cfg.get("k", default)`` is dict's.
    Nested mappings become FrozenConfigs and lists tuples; setting an
    attribute raises, :meth:`replace` / :meth:`replace_dotted` make an
    updated copy. Equal to a mapping with the same plain contents."""

    __slots__ = ("_data",)

    def __init__(self, data: Mapping | None = None):
        d = {}
        for k, v in dict(data or {}).items():
            if isinstance(v, Mapping) and not isinstance(v, FrozenConfig):
                v = FrozenConfig(v)
            elif isinstance(v, list):
                v = tuple(FrozenConfig(x) if isinstance(x, Mapping) else x for x in v)
            d[str(k)] = v
        object.__setattr__(self, "_data", d)

    def __getitem__(self, k: str) -> Any:
        return self._data[k]

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, k) -> bool:
        return k in self._data

    def __getattr__(self, k: str) -> Any:
        try:
            return self._data[k]
        except KeyError:
            raise AttributeError(k) from None

    def __setattr__(self, k, v):
        raise TypeError("FrozenConfig is immutable; use .replace()")

    def __repr__(self) -> str:
        return f"FrozenConfig({self._data!r})"

    def __eq__(self, other) -> bool:
        if isinstance(other, FrozenConfig):
            return self._data == other._data
        if isinstance(other, Mapping):
            return self.to_dict() == dict(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(json.dumps(self.to_dict(), sort_keys=True, default=str))

    def to_dict(self) -> dict:
        """The plain nested dict (tuples of mappings back to lists)."""
        out = {}
        for k, v in self._data.items():
            if isinstance(v, FrozenConfig):
                v = v.to_dict()
            elif isinstance(v, tuple):
                v = [x.to_dict() if isinstance(x, FrozenConfig) else x for x in v]
            out[k] = v
        return out

    def replace(self, **updates) -> "FrozenConfig":
        """A copy with top-level keys replaced."""
        d = self.to_dict()
        d.update(updates)
        return FrozenConfig(d)

    def replace_dotted(self, dotted: Mapping[str, Any]) -> "FrozenConfig":
        """A copy with dot-path keys (``a.b.c``) replaced."""
        d = self.to_dict()
        for path, value in dotted.items():
            node = d
            *parents, leaf = path.split(".")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = value
        return FrozenConfig(d)

    def save(self, path: str) -> None:
        """Write the tree as sorted YAML (through a temporary file)."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".part"
        with open(tmp, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=True)
        os.replace(tmp, path)


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

"""The data-parallel mesh (port of the data-parallel part of
``real3dportrait_tpu/parallel/mesh.py``).

JAX's mesh is a grid of devices that one program spans; the port's is the
world of processes, one card each, along the ``data`` axis: parameters
replicated (broadcast from rank 0), the global batch split by rows. The
JAX mesh's ``rays`` axis (the renderer's context-parallel ``shard_map``)
is not ported (ROADMAP "Not to port").
"""

from __future__ import annotations

import itertools
from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn

from real3dportrait_tpu_torch.parallel.distributed import broadcast_tensors, rank, world_size


@dataclass(frozen=True)
class Mesh:
    """The ``data`` axis: ``shape = {"data": world size}``."""

    shape: Mapping[str, int]


def make_mesh(mesh_shape: Mapping[str, int] | None = None) -> Mesh:
    """``{"data": -1}`` (the default) is the world; ``{"data": n}`` must
    equal it. Any other axis raises: only data parallelism is ported."""
    mesh_shape = dict(mesh_shape or {"data": -1})
    other = set(mesh_shape) - {"data"}
    if other:
        raise NotImplementedError(
            f"mesh axes {sorted(other)}: only the data-parallel axis is ported; the ray "
            "context-parallel shard_map is under ROADMAP's 'Not to port'")
    n = world_size()
    size = int(mesh_shape.get("data", -1))
    if size not in (-1, n):
        raise ValueError(f"mesh {{'data': {size}}} != {n} processes")
    return Mesh({"data": n})


def _state_tensors(obj, seen: set) -> list[torch.Tensor]:
    """Every tensor a training state holds: its modules' parameters and
    buffers, the optimisers' moments and accumulators, ``extra``'s scalars."""
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, nn.Module):
        out = []
        for t in itertools.chain(obj.parameters(), obj.buffers()):
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
        return out
    if isinstance(obj, Mapping):
        return [t for v in obj.values() for t in _state_tensors(v, seen)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _state_tensors(v, seen)]
    if hasattr(obj, "__dict__"):
        return [t for v in vars(obj).values() for t in _state_tensors(v, seen)]
    return []


def replicate_to_mesh(state, mesh: Mesh | None = None):
    """Broadcast every parameter, buffer and optimiser moment of ``state``
    (a training state, a module or a dict of tensors) from rank 0, in
    place; returns ``state``."""
    broadcast_tensors(_state_tensors(state, set()), src=0)
    return state


def shard_batch(batch: dict, mesh: Mesh, axis: str = "data") -> dict:
    """JAX's ``shard_batch``, leaf by leaf: each leaf whose leading size
    divides by the axis size is split in equal blocks of rows, the others
    (tiny smoke batches, per-batch scalars) are kept whole, as JAX
    replicates them. Whole leaves are then computed on every process, so
    the trainer takes its rows with ``shard_global_batch``, which cuts the
    batch as one (every leaf of its rows) and keeps a batch whose rows do
    not divide whole on every process."""
    n, i = mesh.shape[axis], rank()

    def local(x):
        if np.ndim(x) >= 1 and x.shape[0] % n == 0:
            per = x.shape[0] // n
            return x[i * per:(i + 1) * per]
        return x

    return {k: local(v) for k, v in batch.items()}

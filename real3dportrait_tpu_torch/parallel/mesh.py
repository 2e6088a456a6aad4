"""The process mesh (port of ``real3dportrait_tpu/parallel/mesh.py``).

JAX's mesh is a grid of devices that one program spans; the port's is a
grid of processes, one card each, laid out as JAX lays out its devices:
rank r sits at the row-major coordinate of ``np.arange(world).reshape(
sizes)``. Axes:

* ``data``: batch parallel. Parameters are replicated (broadcast from
  rank 0) and a global batch is cut by rows along this axis
  (``shard_batch``, ``distributed.shard_global_batch``); processes that
  differ only in another axis get the same rows, as JAX replicates a batch
  over an axis its spec does not name.
* ``rays``: the renderer's context-parallel axis. A render's rays are cut
  into contiguous blocks along it (``rendering/renderer.py:
  render_rays_sharded``, JAX's ``shard_map`` with ``P(None, "rays",
  None)``); the only cross-ray reductions, the fallback bounds of rays that
  miss the box, run over the axis's process group.

Each axis line (the processes that differ only in that axis) has its
process group, built on every rank in one fixed order (``new_group`` is
collective); the trainer, which cuts batches by coordinate alone, builds
none. With one process there are no groups, and every collective over an
axis is the identity.
"""

from __future__ import annotations

import itertools
from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from real3dportrait_tpu_torch.parallel.distributed import broadcast_tensors, rank, world_size


def axis_sizes(mesh_shape: Mapping[str, int] | None, n: int) -> dict:
    """JAX's ``make_mesh`` arithmetic: the axes in the order given, one -1
    taking the processes left over; raises ``ValueError`` where JAX's
    assertions fail (the sizes' product is not ``n``)."""
    mesh_shape = dict(mesh_shape or {"data": -1})
    sizes = [int(s) for s in mesh_shape.values()]
    known = int(np.prod([s for s in sizes if s != -1])) or 1
    if -1 in sizes:
        if n % known:
            raise ValueError(f"mesh {mesh_shape}: {n} processes do not divide by {known}")
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {dict(zip(mesh_shape, sizes))} != {n} processes")
    return dict(zip(mesh_shape, sizes))


def mesh_coords(shape: Mapping[str, int], r: int) -> dict:
    """Rank ``r``'s coordinate on each axis (row-major, as JAX reshapes its
    device list)."""
    return {k: int(c) for k, c in zip(shape, np.unravel_index(r, tuple(shape.values())))}


@dataclass(frozen=True)
class Mesh:
    """``shape``: axis -> size, in order; ``coords``: this process's
    coordinate on each axis; ``groups``: axis -> the process group of this
    process's line along it (None for a line of one process). A mesh
    without ``groups`` (``make_mesh`` outside a process group, or a layout
    that only cuts by coordinate, as the trainer's) runs no collective over
    an axis of more than one process."""

    shape: Mapping[str, int]
    coords: Mapping[str, int]
    groups: Mapping[str, object] | None = None

    def size(self, axis: str) -> int:
        """The axis's size; 1 for an axis the mesh does not have."""
        return int(self.shape.get(axis, 1))

    def coord(self, axis: str) -> int:
        """This process's coordinate on ``axis`` (0 off the mesh's axes)."""
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """The process group of this process's line along ``axis``, or None
        where its collectives are the identity (a line of one process)."""
        if axis not in self.shape:
            raise ValueError(f"the mesh {dict(self.shape)} has no axis {axis!r}")
        if self.size(axis) == 1:
            return None
        if self.groups is None:
            raise ValueError(f"the mesh {dict(self.shape)} holds no process groups: "
                             "make_mesh builds them")
        return self.groups[axis]

    def all_reduce(self, t: torch.Tensor, op, axis: str) -> torch.Tensor:
        """``t`` reduced with ``op`` (a ``dist.ReduceOp``) over the axis's
        line, as a new tensor (JAX's ``pmin`` / ``pmax``)."""
        group = self.group(axis)
        if group is None:
            return t
        out = _to_collective(t, group)
        dist.all_reduce(out, op=op, group=group)
        return out.to(t.device)

    def all_gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The blocks of the axis's line concatenated along ``dim``, in the
        order of their coordinates; every process of the line gets the whole."""
        group = self.group(axis)
        if group is None:
            return t
        src = _to_collective(t.contiguous(), group)
        parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim=dim).to(t.device)


def _to_collective(t: torch.Tensor, group) -> torch.Tensor:
    """A copy of ``t`` that the group's backend takes: gloo reduces and
    gathers in host memory, so a CUDA tensor is copied to the host there
    (and the result copied back by the caller). This is a copy, not a
    fallback: the work around the collective stays on the card."""
    if t.device.type == "cuda" and dist.get_backend(group) == "gloo":
        return t.cpu()
    return t.clone()


def _axis_groups(shape: dict, r: int) -> dict:
    """Every axis line's process group, created on every rank in one order
    (axes in order, lines in row-major order of the other coordinates);
    this rank's line's group by axis. A line of the whole world is the
    default group; a line of one process needs none."""
    n = int(np.prod(list(shape.values())))
    grid = np.arange(n).reshape(tuple(shape.values()))
    groups = {}
    for i, (axis, size) in enumerate(shape.items()):
        if size == n:
            groups[axis] = dist.group.WORLD
            continue
        if size == 1:
            groups[axis] = None
            continue
        for line in np.moveaxis(grid, i, -1).reshape(-1, size):
            g = dist.new_group([int(x) for x in line])
            if r in line:
                groups[axis] = g
    return groups


def make_mesh(mesh_shape: Mapping[str, int] | None = None) -> Mesh:
    """The mesh of the world's processes: ``{"data": -1}`` (the default) is
    pure data parallelism; ``{"data": -1, "rays": 2}`` gives pairs of
    processes that split a render's rays. Axis sizes as JAX's
    ``make_mesh`` (``axis_sizes``); in a process group every axis line's
    group is built here, on every rank, for the collectives over an axis
    (``render_rays_sharded``). A caller that only cuts by coordinate
    builds ``Mesh(shape, mesh_coords(shape, rank()))`` instead, and no
    group."""
    shape = axis_sizes(mesh_shape, world_size())
    r = rank()
    groups = _axis_groups(shape, r) if dist.is_initialized() else None
    return Mesh(shape, mesh_coords(shape, r), groups)


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
    divides by the axis size is split in equal blocks of rows, this
    process keeping the block of its coordinate on the axis (processes
    that differ only in another axis keep the same block); the others
    (tiny smoke batches, per-batch scalars) are kept whole, as JAX
    replicates them. Whole leaves are then computed on every process, so
    the trainer takes its rows with ``shard_global_batch``, which cuts the
    batch as one (every leaf of its rows) and keeps a batch whose rows do
    not divide whole on every process."""
    n, i = mesh.size(axis), mesh.coord(axis)

    def local(x):
        if np.ndim(x) >= 1 and x.shape[0] % n == 0:
            per = x.shape[0] // n
            return x[i * per:(i + 1) * per]
        return x

    return {k: local(v) for k, v in batch.items()}

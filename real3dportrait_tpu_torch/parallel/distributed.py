"""Multi-process data-parallel training over ``torch.distributed`` (port of
``real3dportrait_tpu/parallel/distributed.py``).

JAX connects its processes with ``jax.distributed.initialize`` and lets
XLA all-reduce the gradients of one global program; the port runs one
process a card, each on its rows of the global batch, and all-reduces the
gradients itself (``all_reduce_mean``, called at the top of
``training/schedulers.py:Adam.updates``).

Launch contract (either works; the environment wins, as in JAX):

* ``MASTER_ADDR`` + ``MASTER_PORT`` / cfg ``coordinator_address``
  ("host:port" of rank 0);
* ``WORLD_SIZE`` / cfg ``num_processes``;
* ``RANK`` / cfg ``process_id``;
* ``LOCAL_RANK``: the card of this process (``training/run.py`` puts
  ``--device cuda`` on ``cuda:LOCAL_RANK``).

``python -m torch.distributed.run --nproc_per_node N -m
real3dportrait_tpu_torch.training.run ...`` sets all of them. The backend
is NCCL for CUDA devices and gloo for the CPU; a caller that wants
another joins its group before the trainer does (``torch.distributed.
init_process_group``), and ``maybe_initialize_distributed`` then only
reports. A launch that asks for processes and cannot join raises;
nothing falls back to a single process.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def _get(cfg, key: str):
    return cfg.get(key) if cfg is not None else None


def maybe_initialize_distributed(cfg=None, device: torch.device | str = "cpu") -> bool:
    """Join the process group when a multi-process launch is asked for
    (by the environment or by ``cfg``); True when the world has more than
    one process. Idempotent: a second call only reports."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    coord = _get(cfg, "coordinator_address")
    addr, port = env.get("MASTER_ADDR"), env.get("MASTER_PORT")
    if (addr is None or port is None) and coord:
        c_addr, c_port = str(coord).rsplit(":", 1)
        addr, port = addr or c_addr, port or c_port
    world = env.get("WORLD_SIZE") or _get(cfg, "num_processes")
    rank = env.get("RANK")
    if rank is None:
        rank = _get(cfg, "process_id")
    if world is None and addr is None:
        return False
    if world is None or rank is None or addr is None or port is None:
        raise RuntimeError(
            f"a multi-process launch needs its address, port, world size and rank; got "
            f"address {addr!r}, port {port!r}, world size {world!r}, rank {rank!r}")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://{addr}:{int(port)}",
                            world_size=int(world), rank=int(rank))
    return dist.get_world_size() > 1


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """True on the process that writes checkpoints, logs and images (rank 0)."""
    return rank() == 0


def _data_axis(mesh) -> tuple[int, int]:
    """(processes a batch is cut over, this process's block): the mesh's
    ``data`` axis and coordinate, or the world and the rank without one."""
    if mesh is None:
        return world_size(), rank()
    return mesh.size("data"), mesh.coord("data")


def process_local_batch_slice(global_batch_size: int, mesh=None) -> slice:
    """The [start, stop) rows of the global batch this process feeds (the
    reference's DistributedSampler); the rows must divide by the number of
    processes, or with ``mesh`` by its ``data`` size, this process taking
    the block of its ``data`` coordinate."""
    n, i = _data_axis(mesh)
    assert global_batch_size % n == 0, (global_batch_size, n)
    per = global_batch_size // n
    return slice(i * per, (i + 1) * per)


def batch_rows(batch: dict) -> int:
    """A batch's rows: its leaves' largest leading size (0 for a batch of
    scalars)."""
    return max((v.shape[0] for v in batch.values() if getattr(v, "ndim", 0) >= 1), default=0)


def shard_global_batch(global_batch: dict, device=None, mesh=None) -> dict:
    """This process's rows of a global batch that every process builds
    alike. The batch's rows are its leaves' largest leading size
    (``batch_rows``). Where they divide by the number of processes (with
    ``mesh``: by its ``data`` size), every leaf of that leading size is cut
    to this process's slice (``process_local_batch_slice``: processes that
    differ only in another axis, ``rays``, get the same rows, as JAX
    replicates the batch over an axis its spec does not name) and the
    others (per-batch values) are kept whole. Where they do not (an uneven
    token bucket), every leaf is kept whole and each process trains on the
    whole batch, as JAX's ``shard_global_batch`` replicates such a leaf
    (``P()``); the all-reduce then averages the processes' gradients on
    the same rows. With ``device``, host arrays are copied there and
    tensors moved."""
    rows = batch_rows(global_batch)
    out = dict(global_batch)
    if rows % _data_axis(mesh)[0] == 0:
        sl = process_local_batch_slice(rows, mesh)
        out = {k: v[sl] if getattr(v, "ndim", 0) >= 1 and v.shape[0] == rows else v
               for k, v in global_batch.items()}
    if device is None:
        return out
    return {k: v.to(device) if torch.is_tensor(v) else torch.as_tensor(np.asarray(v)).to(device)
            for k, v in out.items()}


def _buckets(tensors: list[torch.Tensor]) -> dict:
    """Tensors grouped by (device, dtype), in order."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    return groups


@torch.no_grad()
def all_reduce_mean(tensors: dict) -> dict:
    """Replace each tensor of ``tensors`` (a dict, in place) by its mean
    over the processes: one flattened bucket a (device, dtype), summed and
    divided by the world size (gloo has no ``ReduceOp.AVG``). Without a
    process group, nothing happens; a failed collective raises."""
    if not dist.is_initialized():
        return tensors
    n = dist.get_world_size()
    for group in _buckets(list(tensors.values())).values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat.div_(n)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))
    return tensors


@torch.no_grad()
def broadcast_tensors(tensors: list[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` in place with rank ``src``'s values, one
    flattened bucket a (device, dtype)."""
    if not dist.is_initialized():
        return
    for group in _buckets(tensors).values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))

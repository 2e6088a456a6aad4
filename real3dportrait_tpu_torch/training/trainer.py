"""The training loop (port of ``real3dportrait_tpu/training/trainer.py``).

The step is kept on the host, each step's metrics stay on the device and
are read back once per ``tb_log_interval`` steps (one copy of all of
them); validation and checkpoints every ``val_check_interval`` steps and
at the end; at each validation the task's ``val_images`` (where it has
them) are written as PNGs under ``work_dir/val_images/iter<step>/`` unless
``save_val_images`` is false. Checkpoints are the JAX package's files
(``training/checkpoint.py``); a run restores the newest one in its work
dir, or else starts from the newest of ``init_from_ckpt``, both merged
leniently (``checkpoint.partial_load``).

Data parallel (``parallel/``): one process a card, launched by
``python -m torch.distributed.run --nproc_per_node N -m
real3dportrait_tpu_torch.training.run ...`` (NCCL on the cards, gloo on
the CPU). ``batch_size`` is the global batch: every process builds the
same global batch and keeps the rows of its coordinate on the mesh's
``data`` axis (``parallel.shard_global_batch``; ``mesh_shape`` as in JAX,
default ``{data: -1}``); processes that differ only in ``rays`` train the
same rows, as JAX replicates the batch over that axis, and the world's
all-reduce then averages those replicas, each with its own draws. A batch
whose rows do not divide by the ``data`` size (an
audio-to-motion token bucket) is trained whole on every process, as JAX
replicates it (the update is then the mean over the processes'
differently drawn copies of the batch, as over JAX's stitched copies),
and the first such batch is reported on stdout; the state is broadcast
from rank 0 after the restore; each optimiser all-reduces the gradients
to the global batch's mean
(``schedulers.Adam.updates``); the logged and validation metrics are
means over the processes, in one collective a read; each process draws
its noise from a generator seeded with (seed, step, rank). Rank 0 alone
writes the work dir: ``config.yaml``, ``metrics.jsonl``, checkpoints and
the validation PNGs. The JAX trainer's terminal tee and code snapshot have
no counterpart.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch
import yaml

from real3dportrait_tpu_torch.parallel import (
    is_main_process,
    maybe_initialize_distributed,
    replicate_to_mesh,
    shard_global_batch,
)
from real3dportrait_tpu_torch.parallel.distributed import (
    all_reduce_mean,
    batch_rows,
    rank,
    world_size,
)
from real3dportrait_tpu_torch.parallel.mesh import Mesh, axis_sizes, mesh_coords
from real3dportrait_tpu_torch.training import checkpoint as ckpt
from real3dportrait_tpu_torch.training.train_state import TrainState
from real3dportrait_tpu_torch.utils.draws import seeded_draws


class MetricLogger:
    """``metrics.jsonl`` in the work dir (where ``write_files``: rank 0),
    and a line on stdout (every process, so that a stuck one shows)."""

    def __init__(self, work_dir: str, log_interval: int = 100, write_files: bool = True):
        self.path = None
        if write_files:
            os.makedirs(work_dir, exist_ok=True)
            self.path = os.path.join(work_dir, "metrics.jsonl")
        self.log_interval = log_interval

    def log(self, step: int, metrics: dict, prefix: str = "train") -> None:
        rec = {"step": int(step), "prefix": prefix, **{k: float(v) for k, v in metrics.items()}}
        if self.path is not None:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        msg = " ".join(f"{k}={float(v):.4g}" for k, v in list(metrics.items())[:8])
        print(f"| {prefix} step {step}: {msg}", flush=True)


def _read(metrics: dict[str, list]) -> dict[str, np.ndarray]:
    """Every metric's values, averaged over the processes in one collective
    (where there are several) and read back in one device-to-host copy."""
    names = list(metrics)
    stacked = torch.stack([torch.stack([v.float() for v in metrics[k]]) for k in names])
    host = all_reduce_mean({"m": stacked})["m"].cpu().numpy()
    return dict(zip(names, host))


class Trainer:
    """Drives a task: ``build(seed)``, ``train_step(state, batch, draws)``,
    ``val_step(state, batch)``, ``to_device(batch)``, the batch iterators
    ``train_data()`` / ``val_data()`` and, optionally,
    ``val_images(state, batch, draws)``."""

    def __init__(self, cfg: dict, task, work_dir: str):
        self.cfg, self.task, self.work_dir = cfg, task, work_dir
        # the process group first (``training/run.py`` has joined it already)
        maybe_initialize_distributed(cfg, task.device)
        self.is_main = is_main_process()
        # the mesh's layout alone: training cuts batches by the data
        # coordinate and runs its all-reduces over the world, so it builds
        # no axis line's process group
        shape = axis_sizes(dict(cfg.get("mesh_shape", None) or {"data": -1}), world_size())
        self.mesh = Mesh(shape, mesh_coords(shape, rank()))
        if self.is_main:
            os.makedirs(work_dir, exist_ok=True)
        self.logger = MetricLogger(work_dir, int(cfg.get("tb_log_interval", 100)),
                                   write_files=self.is_main)
        self.max_updates = int(cfg.get("max_updates", 1000))
        self.val_check_interval = int(cfg.get("val_check_interval", 2000))
        self.num_ckpt_keep = int(cfg.get("num_ckpt_keep", 3))
        self.milestone_interval = int(cfg.get("ckpt_milestone_interval", 100000))
        self.monitor_mode = cfg.get("valid_monitor_mode", "min")
        self.monitor_key = cfg.get("valid_monitor_key", "val_loss")
        self.best_val = np.inf if self.monitor_mode == "min" else -np.inf
        self.told_whole = False
        if self.is_main:
            with open(os.path.join(work_dir, "config.yaml"), "w") as f:
                yaml.safe_dump(cfg, f)

    def init_or_restore(self, seed: int) -> TrainState:
        """The task's seeded state, then the newest checkpoint of the work
        dir merged in leniently (leaves left out of it keep their built
        values); with no such checkpoint, the newest one of
        ``init_from_ckpt`` (a work dir) merged in the same way, as the torso
        stage starts from the head stage's run. In a multi-process run the
        result is then broadcast from rank 0."""
        state = self.task.build(seed)
        restored, path = ckpt.get_last_checkpoint(self.work_dir)
        if restored is not None:
            merged, stats = ckpt.partial_load(state.state_dict(), restored)
            state.load_state_dict(merged)
            print(f"| restored checkpoint {path} at step {state.step} ({stats['loaded']} "
                  f"leaves)", flush=True)
        init_from = self.cfg.get("init_from_ckpt", "")
        if restored is None and init_from:
            src, path = ckpt.get_last_checkpoint(init_from)
            if src is not None:
                merged, stats = ckpt.partial_load(state.state_dict(), src)
                state.load_state_dict(merged)
                print(f"| partial init from {path}: {stats}", flush=True)
        return replicate_to_mesh(state, self.mesh)

    def batch(self, batch: dict) -> dict:
        """This process's rows of a global batch, on the task's device: the
        block of its ``data`` coordinate (the same rows along ``rays``); a
        batch whose rows do not divide by the ``data`` size is kept whole,
        and the first such batch is reported on stdout."""
        rows, n = batch_rows(batch), self.mesh.size("data")
        if rows % n and not self.told_whole:
            self.told_whole = True
            print(f"| a batch of {rows} rows does not divide over {n} processes: each rank "
                  f"trains on the whole batch", flush=True)
        return shard_global_batch(batch, self.task.device, self.mesh)

    def save(self, state: TrainState, not_save_keys: tuple = ()) -> str:
        return ckpt.save_checkpoint(self.work_dir, state.step, state.state_dict(),
                                    num_keep=self.num_ckpt_keep,
                                    milestone_interval=self.milestone_interval,
                                    not_save_keys=not_save_keys)

    def fit(self) -> TrainState:
        seed = int(self.cfg.get("seed", 9999))
        state = self.init_or_restore(seed)
        # the step's draws: one generator on the device, seeded from the run
        # seed, the step it starts at and the rank (0 for a single process)
        draws = seeded_draws((rank() << 48) + seed * 1000003 + state.step, self.task.device)
        for _, batch in zip(range(int(self.cfg.get("num_sanity_val_steps", 1))),
                            self.task.val_data()):
            self.task.val_step(state, self.batch(batch))
        train_iter = iter(self.task.train_data())
        meters: dict[str, list] = {}
        t0 = time.time()
        while state.step < self.max_updates:
            batch = self.batch(next(train_iter))
            metrics = self.task.train_step(state, batch, draws)
            for k, v in metrics.items():
                meters.setdefault(k, []).append(v)
            step = state.step
            if step % self.logger.log_interval == 0:
                host = _read(meters)
                avg = {k: float(np.mean(v)) for k, v in host.items()}
                if "total_loss" in host and not np.all(np.isfinite(host["total_loss"])):
                    print(f"| WARNING: non-finite total_loss near step {step}", flush=True)
                avg["steps_per_sec"] = self.logger.log_interval / max(time.time() - t0, 1e-9)
                self.logger.log(step, avg)
                meters.clear()
                t0 = time.time()
            if step % self.val_check_interval == 0:
                self.run_validation(state)
                if self.is_main:
                    self.dump_val_images(state, step)
                    # the validation saves leave out ``not_save_modules``; the
                    # final save keeps everything, as in the JAX trainer
                    self.save(state, tuple(self.cfg.get("not_save_modules", []) or ()))
        if self.is_main:
            self.save(state)
        return state

    def dump_val_images(self, state: TrainState, step: int) -> list[str]:
        """The task's ``val_images(state, batch, draws)`` of the first
        validation batch (whole; draws seeded with 0), written as
        ``work_dir/val_images/iter<step>/<name>.png`` (by rank 0: ``fit``
        calls it there only); returns the paths."""
        if not hasattr(self.task, "val_images") or not bool(
                self.cfg.get("save_val_images", True)):
            return []
        import cv2

        batch = self.task.to_device(next(iter(self.task.val_data())))
        images = self.task.val_images(state, batch, seeded_draws(0, self.task.device))
        out_dir = os.path.join(self.work_dir, "val_images", f"iter{step}")
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for name, img in images.items():
            path = os.path.join(out_dir, f"{name}.png")
            if not cv2.imwrite(path, np.ascontiguousarray(np.asarray(img)[..., ::-1])):
                raise OSError(f"cv2.imwrite could not write {path}")
            paths.append(path)
        return paths

    def run_validation(self, state: TrainState) -> dict:
        metrics: dict[str, list] = {}
        for _, batch in zip(range(int(self.cfg.get("eval_max_batches", 10))),
                            self.task.val_data()):
            for k, v in self.task.val_step(state, self.batch(batch)).items():
                metrics.setdefault(k, []).append(v)
        avg = {k: float(np.mean(v)) for k, v in _read(metrics).items()}
        self.logger.log(state.step, avg, prefix="val")
        val = avg.get(self.monitor_key)
        if val is not None and self.cfg.get("save_best", True):
            better = val < self.best_val if self.monitor_mode == "min" else val > self.best_val
            if better:
                self.best_val = val
                if self.is_main:
                    ckpt.save_best(self.work_dir, state.state_dict())
        return avg

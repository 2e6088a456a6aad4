"""Task base (port of ``real3dportrait_tpu/training/tasks/base_task.py``):
configuration, model definitions and the train / val step over a
:class:`~real3dportrait_tpu_torch.training.train_state.TrainState`.
``resolve_task`` maps the config's ``task_cls`` (a path in the JAX package)
to the port's class of the same module and name."""

from __future__ import annotations

import importlib

import numpy as np
import torch

_JAX_PACKAGE, _PORT_PACKAGE = "real3dportrait_tpu.", "real3dportrait_tpu_torch."


def resolve_task(cfg: dict, device: torch.device):
    """Instantiate the port's twin of the task named by ``cfg['task_cls']``."""
    path = cfg["task_cls"]
    if path.startswith(_JAX_PACKAGE):
        path = _PORT_PACKAGE + path[len(_JAX_PACKAGE):]
    module, cls_name = path.rsplit(".", 1)
    try:
        cls = getattr(importlib.import_module(module), cls_name)
    except (ImportError, AttributeError) as e:
        raise NotImplementedError(f"task {cfg['task_cls']!r} is not ported") from e
    return cls(cfg, device)


class BaseTask:
    def __init__(self, cfg: dict, device: torch.device):
        self.cfg = cfg
        self.device = torch.device(device)

    def build(self, seed: int):
        raise NotImplementedError

    def train_step(self, state, batch: dict, draws):
        raise NotImplementedError

    def val_step(self, state, batch: dict):
        raise NotImplementedError

    def to_device(self, batch: dict) -> dict:
        """Host arrays to the device; tensors (made there) as they are."""
        return {k: v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v)).to(self.device)
                for k, v in batch.items()}

    # data: synthetic batches, the same arrays as the JAX package's from the
    # same seeds; a task that reads a record store overrides these
    def train_data(self):
        rng = np.random.RandomState(self.cfg.get("seed", 0))
        while True:
            yield self.synthetic_batch(rng)

    def val_data(self):
        rng = np.random.RandomState(1234)
        while True:
            yield self.synthetic_batch(rng)

    def synthetic_batch(self, rng: np.random.RandomState) -> dict:
        raise NotImplementedError(f"{type(self).__name__} has no synthetic batch generator")

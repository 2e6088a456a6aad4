"""Step-indexed checkpoints of the training state (port of
``real3dportrait_tpu/training/checkpoint.py``): ``model_ckpt_steps_<N>.ckpt``
files in the JAX package's msgpack layout, written through the port's own
``utils/msgpack_ckpt.py`` (atomically), keep-newest-K plus every milestone,
and a best-validation copy. The JAX package's ``load_checkpoint`` reads
them, and the port reads the JAX package's."""

from __future__ import annotations

import os

from real3dportrait_tpu_torch.utils.msgpack_ckpt import (
    _step_of,
    get_all_ckpts,
    get_last_checkpoint,
    load_checkpoint,
    msgpack_serialize,
)
from real3dportrait_tpu_torch.utils.msgpack_ckpt import save_checkpoint as _save

__all__ = ["get_all_ckpts", "get_last_checkpoint", "load_checkpoint", "save_checkpoint",
           "save_best"]


def save_checkpoint(work_dir: str, step: int, tree: dict, num_keep: int = 3,
                    milestone_interval: int = 100000) -> str:
    """Write ``tree`` (``TrainState.state_dict()``) and prune: keep the
    ``num_keep`` newest files and every milestone step."""
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

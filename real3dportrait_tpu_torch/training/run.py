"""Training CLI (port of ``real3dportrait_tpu/training/run.py``):

    python -m real3dportrait_tpu_torch.training.run --config configs/<stage>.yaml \
        --exp_name <name> [--hparams k=v,...] [--device cuda|cuda:<i>|cpu]

resolves ``task_cls`` from the config to the port's task and trains it.
The device defaults to ``cuda`` and the run raises without a card; pass
``--device cpu`` for the CPU (tests, tiny smoke runs).

Several processes, one a card, train data-parallel on the global batch
``batch_size`` (``training/trainer.py``); rank 0 alone writes the work
dir:

    python -m torch.distributed.run --nproc_per_node 8 \
        -m real3dportrait_tpu_torch.training.run --config ... --exp_name ...

runs over NCCL, each process on ``cuda:LOCAL_RANK`` (an explicit
``--device cuda:<i>`` keeps that card); with ``--device cpu`` over gloo.
``--hparams "mesh_shape={data: -1, rays: 2}"`` (JAX's mesh) cuts the
batch over ``data`` and trains the same rows on the processes that differ
only in ``rays``; their gradients are averaged with the rest.
Across hosts, torchrun's ``--nnodes``, ``--node_rank`` and
``--master_addr`` (or the config's ``coordinator_address``,
``num_processes``, ``process_id``) say where rank 0 listens.
"""

from __future__ import annotations

import argparse
import os

import torch


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--exp_name", default="")
    parser.add_argument("--hparams", default="", help="dot-path overrides a.b=1,c=2")
    parser.add_argument("--work_dir_root", default="checkpoints")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def make_trainer(argv=None):
    """The :class:`~.trainer.Trainer` of the command line ``argv``, joined
    to its process group first where the launch asks for one."""
    from real3dportrait_tpu_torch.config import load_config, parse_overrides
    from real3dportrait_tpu_torch.parallel import maybe_initialize_distributed
    from real3dportrait_tpu_torch.training.tasks.base_task import resolve_task
    from real3dportrait_tpu_torch.training.trainer import Trainer

    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training.run: no CUDA device; pass --device cpu to train on the CPU")
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    cfg = load_config(args.config, parse_overrides(args.hparams))
    maybe_initialize_distributed(cfg, device)
    work_dir = cfg.get("work_dir") or os.path.join(args.work_dir_root,
                                                   args.exp_name or "default")
    cfg["work_dir"] = work_dir
    return Trainer(cfg, resolve_task(cfg, device), work_dir)


def main(argv=None):
    from real3dportrait_tpu_torch.utils.precision import set_fp32_policy

    set_fp32_policy()
    return make_trainer(argv).fit()


if __name__ == "__main__":
    main()

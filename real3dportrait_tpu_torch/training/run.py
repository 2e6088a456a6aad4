"""Training CLI (port of ``real3dportrait_tpu/training/run.py``):

    python -m real3dportrait_tpu_torch.training.run --config configs/<stage>.yaml \
        --exp_name <name> [--hparams k=v,...] [--device cuda|cpu]

resolves ``task_cls`` from the config to the port's task and trains it.
The device defaults to ``cuda`` and the run raises without a card; pass
``--device cpu`` for the CPU (tests, tiny smoke runs).
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
    """The :class:`~.trainer.Trainer` of the command line ``argv``."""
    from real3dportrait_tpu_torch.config import load_config, parse_overrides
    from real3dportrait_tpu_torch.training.tasks.base_task import resolve_task
    from real3dportrait_tpu_torch.training.trainer import Trainer

    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training.run: no CUDA device; pass --device cpu to train on the CPU")
    cfg = load_config(args.config, parse_overrides(args.hparams))
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

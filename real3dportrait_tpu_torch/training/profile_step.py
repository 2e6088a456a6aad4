"""Where a training step's time goes on a CUDA device.

    python -m real3dportrait_tpu_torch.training.profile_step [--config secc_img2plane.yaml]
        [--hparams k=v,...] [--steps 3] [--top 25]

Any training config: the SECC stages, ``eg3d.yaml``, ``img2plane.yaml``,
``audio2motion_vae.yaml`` (without a ``syncnet_ckpt_dir`` override its
sync loss is off, as the config ships).

Builds the task of ``configs/NAME`` on the card with seeded weights (by
default ``FULL_STEP_HPARAMS``: the config's batch of 4, the adversarial
term on, every group training), takes step 0 (R1, the
density regulariser, src2src) as a warm-up, then ``steps`` steps of
``train_step`` as it is, and prints:

* wall ms per step (synchronised) and the peak memory allocated;
* the step's parts by CUDA events around the task's own methods as
  ``train_step`` calls them, those the task has: for the SECC tasks the
  generator forward with its losses, its backward, the G update, the D
  forward, its backward, R1's forward and double backward (on R1 steps),
  the D update, the lambdas and the EMA; for ``eg3d.yaml`` the generator
  forward with its losses and the EMA; for ``img2plane.yaml`` the
  teacher's views and the student's forward with its losses; for
  ``audio2motion_vae.yaml`` the forward with its losses;
* from ``torch.profiler`` over the same steps, the kernel time a step and
  the busy share, the ``top`` kernels, and the port's own kernels
  (``csrc/``, forward and backward) below them.

fp32 with TF32 off, as chip_smoke. Event pairs include the host's launch
gaps, so the parts do not add up to the step exactly.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from real3dportrait_tpu_torch.kernels import card_line
from real3dportrait_tpu_torch.training import run as trun
from real3dportrait_tpu_torch.utils.draws import seeded_draws
from real3dportrait_tpu_torch.utils.precision import set_fp32_policy
from real3dportrait_tpu_torch.utils.profiling import kernel_table

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# a full training step from the first: the config's batch of 4, the
# adversarial term, R1, the density regulariser and src2src at step 0;
# every generator group's gate non-zero from step 1 (two-stage training
# off, no warm-ups). chip_smoke's training run takes these too.
FULL_STEP_HPARAMS = ("batch_size=4,start_adv_iters=0,two_stage_training=false,"
                     "group_warmup_iters=0,start_update_sr_iters=0")


class PartTimer:
    """CUDA events around methods of ``task`` (instance attributes wrap
    them), those of them it has; a backward (``grads``) is named after the
    forward before it."""

    def __init__(self, task):
        self.times: dict[str, list] = {}
        self.last = "?"
        for attr, name in (("prepare_batch", "teacher views"),
                           ("_g_loss", "G forward + losses"), ("_losses", "forward + losses"),
                           ("_d_loss", "D forward"), ("_r1", "R1 forward"), ("grads", None),
                           ("apply_gen_update", "G update"), ("apply_disc_update", "D update"),
                           ("tune_lambdas", "lambdas"), ("update_ema", "EMA")):
            if hasattr(task, attr):
                setattr(task, attr, self._wrap(getattr(task, attr), name))

    def _wrap(self, fn, name):
        def timed(*a, **k):
            label = name or f"{self.last.split(' ')[0]} backward"
            if name is not None:
                self.last = name
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*a, **k)
            end.record()
            self.times.setdefault(label, []).append((start, end))
            return out
        return timed

    def per_step_ms(self, steps: int) -> dict:
        torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v) / steps for k, v in self.times.items()}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="secc_img2plane.yaml")
    parser.add_argument("--hparams", default=FULL_STEP_HPARAMS)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--top", type=int, default=25)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device is visible")
    set_fp32_policy()
    print(f"card: {card_line()}")
    with tempfile.TemporaryDirectory() as work:
        trainer = trun.make_trainer(["--config", os.path.join(_ROOT, "configs", args.config),
                                     "--hparams", args.hparams, "--work_dir_root", work])
    task = trainer.task
    state = task.build(int(trainer.cfg.get("seed", 9999)))
    draws = seeded_draws(0, task.device)
    data = iter(task.train_data())
    batches = [task.to_device(next(data)) for _ in range(args.steps + 1)]
    task.train_step(state, batches[0], draws)               # step 0, the warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    parts = PartTimer(task)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches[1:]:
            t0 = time.perf_counter()
            task.train_step(state, b, draws)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    n = args.steps
    wall = sum(walls) / n
    print(f"config {args.config} [{args.hparams}]: steps 1-{n} {[round(w, 1) for w in walls]} "
          f"ms, {wall:.1f} ms/step of wall, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB (under the profiler)")
    for name, ms in parts.per_step_ms(n).items():
        print(f"  part {name:24s} {ms:9.2f} ms/step ({ms / wall:6.1%})")
    busy, table = kernel_table(prof, args.top)
    busy /= n
    print(f"profiler: kernel time {busy:.1f} ms/step, busy share {busy / wall:.3f}")
    for x in table:
        print(f"  {x.self_device_time_total / n / 1e3:9.3f} ms/step x{x.count / n:7.1f}  "
              f"{x.key[:110]}")


if __name__ == "__main__":
    main()

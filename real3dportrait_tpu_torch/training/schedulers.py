"""Step-indexed learning rates and the Adam optimiser (port of
``real3dportrait_tpu/training/schedulers.py``, with its ``build_schedule``,
and of the ``optax.adam`` / ``optax.MultiSteps`` the JAX tasks build from
it).

Schedules are plain functions of the host step, evaluated in fp32 as the
JAX package evaluates them. :class:`Adam` is ``optax.adam(schedule, b1, b2,
eps=1e-8)`` written out over a dict of named parameters, its moments on the
device and its counts on the host; a float for ``schedule`` is optax's
constant rate (whose state holds no count). ``clip_norm`` chains
``optax.clip_by_global_norm`` before it (the audio-to-motion task's
``optax.chain``). ``every_k > 1`` is ``optax.MultiSteps`` (gradients
averaged over k calls, the update applied on every k-th, zero updates
between), which JAX's ``with_grad_accumulation`` wraps around the
optimiser where ``accumulate_grad_batches`` is k > 1; the tasks pass that
key as ``every_k``, and the clip acts on the averaged gradient that
``MultiSteps`` hands its inner optimiser. :meth:`Adam.state_dict` gives the
optax state's tree as flax's ``to_state_dict`` lays it out in a checkpoint.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from real3dportrait_tpu_torch.parallel.distributed import all_reduce_mean

f32 = np.float32


def none_schedule(lr: float) -> Callable[[int], float]:
    return lambda step: float(f32(lr))


def exponential_schedule(lr: float, decay_rate: float = 0.98, decay_interval: int = 5000,
                         warmup: int = 0) -> Callable[[int], float]:
    """lr * decay^(step/interval), with an optional linear warmup."""

    def fn(step):
        s = f32(step)
        base = f32(lr) * f32(decay_rate) ** (s / f32(decay_interval))
        if warmup > 0:
            base = base * np.clip(s / f32(warmup), f32(0), f32(1))
        return float(base)

    return fn


def rsqrt_schedule(lr: float, warmup: int = 4000, hidden_size: int = 256
                   ) -> Callable[[int], float]:
    def fn(step):
        s = max(f32(step), f32(1))
        warm = f32(warmup) ** f32(-0.5) * min(s * f32(warmup) ** f32(-1.5), s ** f32(-0.5)) \
            * f32(warmup) ** f32(0.5)
        return float(f32(lr) * warm * f32(hidden_size) ** f32(-0.5))

    return fn


def cosine_schedule(lr: float, total_steps: int, warmup: int = 0, min_lr: float = 0.0
                    ) -> Callable[[int], float]:
    def fn(step):
        s = f32(step)
        frac = np.clip((s - f32(warmup)) / f32(max(total_steps - warmup, 1)), f32(0), f32(1))
        cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * frac))
        base = f32(min_lr) + (f32(lr) - f32(min_lr)) * cos
        if warmup > 0 and s < warmup:
            base = f32(lr) * s / f32(warmup)
        return float(base)

    return fn


def gan_lr_schedule(lr: float, decay_rate: float = 0.95, decay_interval: int = 5000,
                    warmup: int = 0, floor: float = 5e-6) -> Callable[[int], float]:
    """The GAN stages' base rate: linear warmup, stepped exponential decay,
    floored: ``max(floor, lr * rate ** (step // interval))``. The per-group
    gates multiply the updates in the task."""

    def fn(step):
        s = f32(step)
        base = f32(lr)
        if warmup > 0:
            base = max(f32(lr) * np.clip(s / f32(warmup), f32(0), f32(1)), f32(1e-7))
        return float(max(base * f32(decay_rate) ** np.floor(s / f32(decay_interval)),
                         f32(floor)))

    return fn


class Adam:
    """``optax.adam(schedule, b1, b2, eps)`` over named parameters, wrapped in
    ``optax.MultiSteps`` when ``every_k > 1``.

    :meth:`updates` takes the gradients (a dict by name; in a multi-process
    run each is first replaced in place by its mean over the processes)
    and returns the updates to add (``-lr * m_hat / (sqrt(v_hat) + eps)``,
    zero between accumulation steps), advancing the state. With ``clip_norm`` the
    gradients are first scaled by ``clip_norm / global_norm`` where their
    global norm is at least ``clip_norm`` (optax's
    ``clip_by_global_norm``).
    """

    def __init__(self, params: dict[str, torch.Tensor],
                 schedule: Callable[[int], float] | float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, every_k: int = 1,
                 clip_norm: float | None = None):
        self.constant = not callable(schedule)
        if self.constant:
            schedule = none_schedule(float(schedule))
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.clip_norm = clip_norm
        self.mu = {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for n, p in params.items()}
        self.count = 0          # scale_by_adam's count
        self.sched_count = 0    # scale_by_schedule's count
        self.every_k = int(every_k)
        if self.every_k > 1:
            self.acc = {n: torch.zeros_like(p) for n, p in params.items()}
            self.mini_step = 0
            self.gradient_step = 0

    def _clip(self, grads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """optax's ``clip_by_global_norm``: ``g / norm * clip_norm`` where the
        norm is at least ``clip_norm``, on the device (nothing read back)."""
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        keep = norm < self.clip_norm
        return {n: torch.where(keep, g, g / norm * self.clip_norm) for n, g in grads.items()}

    def _inner(self, grads: dict[str, torch.Tensor], commit: bool) -> dict[str, torch.Tensor]:
        if self.clip_norm is not None:
            grads = self._clip(grads)
        count = self.count + 1
        c1 = float(1 - f32(self.b1) ** f32(count))
        c2 = float(1 - f32(self.b2) ** f32(count))
        lr = self.schedule(self.sched_count)
        out = {}
        for n, g in grads.items():
            mu = self.mu[n] * self.b1 + g * (1 - self.b1)
            nu = self.nu[n] * self.b2 + g.square() * (1 - self.b2)
            out[n] = (mu / c1) / (torch.sqrt(nu / c2) + self.eps) * (-lr)
            if commit:
                self.mu[n], self.nu[n] = mu, nu
        if commit:
            self.count, self.sched_count = count, self.sched_count + 1
        return out

    @torch.no_grad()
    def updates(self, grads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        # data parallel: the gradient of the global batch's mean, before the
        # clip and the accumulation, as JAX's one program computes it
        all_reduce_mean(grads)
        if self.every_k == 1:
            return self._inner(grads, True)
        n_acc = self.mini_step
        for n, g in grads.items():
            self.acc[n] = self.acc[n] + (g - self.acc[n]) / (n_acc + 1)
        emit = self.mini_step == self.every_k - 1
        out = self._inner(self.acc, emit)
        self.mini_step = (self.mini_step + 1) % self.every_k
        if not emit:
            return {n: torch.zeros_like(u) for n, u in out.items()}
        self.gradient_step += 1
        self.acc = {n: torch.zeros_like(a) for n, a in self.acc.items()}
        return out

    def state_dict(self, to_tree: Callable[[dict], dict]) -> dict:
        """The optax state as a checkpoint holds it; ``to_tree`` turns a dict
        of tensors by parameter name into the Flax parameter tree."""
        inner = {"0": {"count": np.int32(self.count), "mu": to_tree(self.mu),
                       "nu": to_tree(self.nu)},
                 "1": {} if self.constant else {"count": np.int32(self.sched_count)}}
        if self.clip_norm is not None:
            inner = {"0": {}, "1": inner}
        if self.every_k == 1:
            return inner
        return {"mini_step": np.int32(self.mini_step),
                "gradient_step": np.int32(self.gradient_step),
                "inner_opt_state": inner, "acc_grads": to_tree(self.acc), "skip_state": {}}

    def load_state_dict(self, tree: dict, from_tree: Callable[[dict], dict]) -> None:
        """The reverse of :meth:`state_dict`; ``from_tree`` turns a Flax
        parameter tree into tensors by parameter name, on the device."""
        if self.every_k > 1:
            self.mini_step = int(tree["mini_step"])
            self.gradient_step = int(tree["gradient_step"])
            self.acc = from_tree(tree["acc_grads"])
            tree = tree["inner_opt_state"]
        if self.clip_norm is not None:
            tree = tree["1"]
        self.count = int(tree["0"]["count"])
        self.mu, self.nu = from_tree(tree["0"]["mu"]), from_tree(tree["0"]["nu"])
        self.sched_count = self.count if self.constant else int(tree["1"]["count"])


def build_schedule(cfg, lr_key: str = "lr") -> Callable[[int], float]:
    """The schedule a config names (``scheduler``: exponential, rsqrt,
    cosine, else constant) with its rate and decay keys."""
    lr = float(cfg.get(lr_key, 1e-4))
    kind = cfg.get("scheduler", "none")
    if kind == "exponential":
        return exponential_schedule(lr, float(cfg.get("lr_decay_rate", 0.98)),
                                    int(cfg.get("lr_decay_interval", 5000)),
                                    int(cfg.get("warmup_updates", 0)))
    if kind == "rsqrt":
        return rsqrt_schedule(lr, int(cfg.get("warmup_updates", 4000)),
                              int(cfg.get("hidden_size", 256)))
    if kind == "cosine":
        return cosine_schedule(lr, int(cfg.get("max_updates", 100000)),
                               int(cfg.get("warmup_updates", 0)))
    return none_schedule(lr)

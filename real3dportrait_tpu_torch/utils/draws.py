"""The random draws of a training step.

The JAX package threads ``jax.random`` keys through its training step; the
port takes one :class:`Draws`, which makes each draw from a
``torch.Generator`` on the device, in the order the step asks for them:
the renderer's jittered depths and K2's uniform ``u``
(``rendering/renderer.py``), the density regulariser's points and their
perturbation, the SECC perturbation noise, the latents, the pose swap and
the SyncNet clips of the training tasks (``training/tasks``). The two
packages' generators give different numbers from one seed, so a test that
compares them hands the port the JAX package's draws through
:class:`ReplayDraws`; :class:`RecordDraws` keeps a step's own draws, so
that the same step on another device replays them; :func:`rank_records`
cuts a single process's records to one data-parallel rank's rows.
"""

from __future__ import annotations

import torch


class Draws:
    """Uniform and normal draws from one ``torch.Generator``."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def uniform(self, shape: tuple, device, low: float = 0.0, high: float = 1.0
                ) -> torch.Tensor:
        """[shape] fp32, uniform in [low, high)."""
        u = torch.rand(shape, generator=self.generator, device=device)
        return u if (low, high) == (0.0, 1.0) else u * (high - low) + low

    def normal(self, shape: tuple, device) -> torch.Tensor:
        """[shape] fp32, standard normal."""
        return torch.randn(shape, generator=self.generator, device=device)

    def integers(self, shape: tuple, device, low: int, high: int) -> torch.Tensor:
        """[shape] int64, uniform in [low, high)."""
        return torch.randint(low, high, shape, generator=self.generator, device=device)


def seeded_draws(seed: int, device) -> Draws:
    """:class:`Draws` on a generator of ``device`` seeded with ``seed``."""
    return Draws(torch.Generator(device=device).manual_seed(int(seed)))


class RecordDraws(Draws):
    """``draws``' draws, passed on and kept in order as (kind, CPU copy)
    in ``records``."""

    def __init__(self, draws: Draws):
        self.draws, self.records = draws, []

    def uniform(self, shape, device, low=0.0, high=1.0):
        v = self.draws.uniform(shape, device, low, high)
        self.records.append(("uniform", v.cpu()))
        return v

    def normal(self, shape, device):
        v = self.draws.normal(shape, device)
        self.records.append(("normal", v.cpu()))
        return v

    def integers(self, shape, device, low, high):
        v = self.draws.integers(shape, device, low, high)
        self.records.append(("integers", v.cpu()))
        return v


class ReplayDraws(Draws):
    """Recorded draws, (kind, values) in order, handed out again (fp32, or
    float64 where they were recorded so, and int64 for ``integers``); a draw
    of another kind or shape than the next record, or past the last, raises.
    ``records`` keeps those not yet drawn."""

    def __init__(self, records):
        self.records = list(records)

    def _next(self, kind: str, shape: tuple, device) -> torch.Tensor:
        if not self.records:
            raise RuntimeError(f"a {kind} {tuple(shape)} draw past the recorded ones")
        k, v = self.records.pop(0)
        v = torch.as_tensor(v)
        if kind == "integers":
            v = v.long()
        elif v.dtype != torch.float64:
            v = v.float()
        if (k, tuple(v.shape)) != (kind, tuple(shape)):
            raise RuntimeError(f"a {kind} {tuple(shape)} draw where the record holds {k} "
                               f"{tuple(v.shape)}")
        return v.to(device)

    def uniform(self, shape, device, low=0.0, high=1.0):
        return self._next("uniform", shape, device)

    def normal(self, shape, device):
        return self._next("normal", shape, device)

    def integers(self, shape, device, low, high):
        return self._next("integers", shape, device)


def rank_records(records, world: int, rank: int) -> list:
    """A single process's recorded draws, (kind, values) in order, as rank
    ``rank`` of ``world`` processes draws them for its rows of the global
    batch: a record of leading size above 1 (batch-major: B rows, or B x
    rays) gives the rank its block of rows where its rows divide by
    ``world``; a record of leading size 1 (a draw the batch shares), or
    one whose rows do not divide (a batch that every rank trains whole,
    ``parallel.shard_global_batch``), stays whole."""
    out = []
    for kind, v in records:
        if v.ndim >= 1 and v.shape[0] > 1 and v.shape[0] % world == 0:
            per = v.shape[0] // world
            v = v[rank * per:(rank + 1) * per]
        out.append((kind, v))
    return out

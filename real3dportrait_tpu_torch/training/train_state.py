"""The training state (port of ``real3dportrait_tpu/training/train_state.py``).

JAX's immutable ``TrainState`` pytree becomes a mutable holder: the step on
the host, the three modules (``gen``, ``disc`` and the generator's EMA
``gen_ema``, updated in place), the two :class:`~.schedulers.Adam`
optimisers and ``extra``, the adaptive loss lambdas as device scalars.
:meth:`TrainState.state_dict` lays it out as flax's ``to_state_dict`` lays
out the JAX state in a checkpoint (``step``, ``params``, ``variables``,
``opt_states``, ``extra``), so either package reads the other's files.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn as nn

from real3dportrait_tpu_torch.training.schedulers import Adam
from real3dportrait_tpu_torch.weights import (
    jax_variables_from_torch,
    load_jax_variables,
    tensors_by_name,
)


@dataclass
class TrainState:
    step: int
    gen: nn.Module
    disc: nn.Module
    gen_ema: nn.Module | None
    opt_g: Adam
    opt_d: Adam
    extra: dict = field(default_factory=dict)

    def state_dict(self) -> dict:
        """The JAX package's checkpoint tree of this state (numpy leaves)."""
        def tree_of(module):
            def to_tree(named: dict) -> dict:
                return jax_variables_from_torch(module, named)["params"]
            return to_tree

        gen_vars = jax_variables_from_torch(self.gen)
        params = {"gen": gen_vars["params"], "disc": jax_variables_from_torch(self.disc)["params"]}
        if self.gen_ema is not None:
            params["gen_ema"] = jax_variables_from_torch(self.gen_ema)["params"]
        return {
            "step": np.int32(self.step),
            "params": params,
            "variables": {k: v for k, v in gen_vars.items() if k != "params"},
            "opt_states": {"gen": self.opt_g.state_dict(tree_of(self.gen)),
                           "disc": self.opt_d.state_dict(tree_of(self.disc))},
            "extra": {k: np.float32(v.detach().cpu()) for k, v in self.extra.items()},
        }

    def load_state_dict(self, tree: dict) -> None:
        """Load a checkpoint tree of either package, strictly."""
        def load(module, params, variables=None):
            load_jax_variables(module, {"params": params, **(variables or {})})

        def from_tree(module):
            return functools.partial(tensors_by_name, module)

        self.step = int(np.asarray(tree["step"]))
        load(self.gen, tree["params"]["gen"], tree.get("variables"))
        load(self.disc, tree["params"]["disc"])
        if self.gen_ema is not None:
            load(self.gen_ema, tree["params"]["gen_ema"], tree.get("variables"))
        self.opt_g.load_state_dict(tree["opt_states"]["gen"], from_tree(self.gen))
        self.opt_d.load_state_dict(tree["opt_states"]["disc"], from_tree(self.disc))
        dev = next(self.gen.parameters()).device
        self.extra = {k: torch.tensor(float(np.asarray(v)), device=dev)
                      for k, v in tree["extra"].items()}

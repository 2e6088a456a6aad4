"""SyncNet training (port of
``real3dportrait_tpu/training/tasks/syncnet_task.py``): the audio /
mouth-landmark sync discriminator learns a BCE on the cosine similarity of
positive and mined negative clip pairs (``data/datasets.SyncNetDataset``,
from ``<binary_data_dir>/<split>``; synthetic clips without a store).
Adam on the exponential schedule, wrapped in the gradient accumulation of
``accumulate_grad_batches``. Checkpoints are the JAX task's tree
(``params.syncnet``, ``opt_states.syncnet``), which the audio-to-motion
stage loads through ``partial_load``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from real3dportrait_tpu_torch.models.syncnet import LandmarkHubertSyncNet, cal_sync_loss
from real3dportrait_tpu_torch.training.schedulers import Adam, exponential_schedule
from real3dportrait_tpu_torch.training.tasks.base_task import BaseTask
from real3dportrait_tpu_torch.weights import (
    jax_variables_from_torch,
    mock_init_,
    tensors_by_name,
    torch_state_dict_from_jax,
)

# landmark dims of ``syncnet_keypoint_mode``; the released lineage is lm468
LM_DIMS = {"lip": 60, "centered_lip": 60, "centered_lip2d": 40, "lm68": 68 * 3,
           "lm468": 468 * 3}


@dataclass
class SyncNetState:
    """The step on the host, the model and its optimiser;
    :meth:`state_dict` is the JAX task's ``TrainState`` tree."""

    step: int
    model: LandmarkHubertSyncNet
    opt: Adam

    def _to_tree(self, named: dict) -> dict:
        return jax_variables_from_torch(self.model, named)["params"]

    def _from_tree(self, tree: dict) -> dict:
        return tensors_by_name(self.model, tree)

    def state_dict(self) -> dict:
        return {"step": np.int32(self.step),
                "params": {"syncnet": jax_variables_from_torch(self.model)["params"]},
                "variables": {}, "opt_states": {"syncnet": self.opt.state_dict(self._to_tree)},
                "extra": {}}

    def load_state_dict(self, tree: dict) -> None:
        """Load a checkpoint tree of either package, strictly."""
        self.step = int(np.asarray(tree["step"]))
        self.model.load_state_dict(torch_state_dict_from_jax(
            {"params": tree["params"]["syncnet"]}), strict=True)
        self.opt.load_state_dict(tree["opt_states"]["syncnet"], self._from_tree)


class SyncNetTask(BaseTask):
    def __init__(self, cfg: dict, device):
        super().__init__(cfg, device)
        self.lm_dim = LM_DIMS[cfg.get("syncnet_keypoint_mode", "lm468")]
        self.schedule = exponential_schedule(float(cfg.get("lr", 1e-3)),
                                             float(cfg.get("lr_decay_rate", 0.98)),
                                             int(cfg.get("lr_decay_interval", 5000)))

    def build_model(self) -> LandmarkHubertSyncNet:
        cfg = self.cfg
        return LandmarkHubertSyncNet(
            lm_dim=self.lm_dim, audio_dim=1024,
            num_layers_per_block=int(cfg.get("syncnet_num_layers_per_block", 3)),
            base_hid_size=int(cfg.get("syncnet_base_hid_size", 128)),
            out_dim=int(cfg.get("syncnet_out_hid_size", 1024)))

    def build(self, seed: int) -> SyncNetState:
        """Seeded weights (the JAX package's initialisers, drawn on the host)
        and ``optax.adam`` on the schedule, b1 0.9, b2 0.999."""
        model = mock_init_(self.build_model(), torch.Generator().manual_seed(seed))
        model = model.to(self.device).train()
        opt = Adam(dict(model.named_parameters()), self.schedule,
                   every_k=int(self.cfg.get("accumulate_grad_batches", 1)))
        return SyncNetState(0, model, opt)

    def _loss(self, model, batch: dict) -> tuple:
        audio_emb, mouth_emb = model(batch["hubert_clip"], batch["mouth_clip"])
        loss, sim = cal_sync_loss(audio_emb, mouth_emb, batch["label"])
        loss = loss.mean()
        return loss, {"sync_bce": loss.detach(), "cos_sim": sim.mean().detach()}

    def train_step(self, state: SyncNetState, batch: dict, draws=None) -> dict:
        """One Adam update of ``state`` in place; the step's metrics as
        device scalars (it draws nothing: ``draws`` is the trainer's)."""
        names, params = zip(*state.model.named_parameters())
        loss, metrics = self._loss(state.model, batch)
        grads = dict(zip(names, torch.autograd.grad(loss, params)))
        updates = state.opt.updates(grads)
        with torch.no_grad():
            for n, p in zip(names, params):
                p.add_(updates[n])
        state.step += 1
        metrics["total_loss"] = loss.detach()
        return metrics

    @torch.no_grad()
    def val_step(self, state: SyncNetState, batch: dict) -> dict:
        loss, metrics = self._loss(state.model, batch)
        return {"val_loss": loss, **{f"val_{k}": v for k, v in metrics.items()}}

    def _mined_batches(self, split: str, shuffle: bool, seed: int):
        """Mined clip batches of ``<binary_data_dir>/<split>`` (the host-side
        ``phase`` list dropped), or None where the store has no index."""
        store = os.path.join(str(self.cfg.get("binary_data_dir", "")), split)
        if not os.path.isfile(store + ".idx"):
            return None
        from real3dportrait_tpu_torch.data.datasets import SyncNetDataset

        ds = SyncNetDataset(store, self.cfg, shuffle=shuffle, seed=seed, device=self.device)
        return ({k: v for k, v in b.items() if k != "phase"} for b in ds.batches())

    def train_data(self):
        real = self._mined_batches("train", True, int(self.cfg.get("seed", 0)))
        yield from (real if real is not None else super().train_data())

    def val_data(self):
        real = self._mined_batches("val", False, 1234)
        yield from (real if real is not None else super().val_data())

    def synthetic_batch(self, rng: np.random.RandomState) -> dict:
        b = int(self.cfg.get("batch_size", 4))
        label = (rng.rand(b) > 0.5).astype(np.float32)
        return {"hubert_clip": rng.randn(b, 10, 1024).astype(np.float32),
                "mouth_clip": rng.randn(b, 5, self.lm_dim).astype(np.float32),
                "label": label}

"""Audio-to-motion VAE training (port of
``real3dportrait_tpu/training/tasks/audio2motion_task.py``): the
pitch-conditioned flow-VAE learns the 3DMM expression from HuBERT features
with a cyclically annealed KL, masked MSE on the expression and on the
mediapipe-468 landmarks it reconstructs (eyes and lips weighted), a
temporal laplacian, an L2 magnitude term and, where ``syncnet_ckpt_dir``
is set and ``lambda_sync > 0``, a lip-sync loss from a frozen SyncNet over
random 5-frame clips.

The optimiser is JAX's ``optax.chain(clip_by_global_norm(clip_grad_norm or
1e9), adam(build_schedule(cfg)))`` under the gradient accumulation of
``accumulate_grad_batches`` (:class:`~..schedulers.Adam` with
``clip_norm``); the ``grad_norm`` metric is the gradient's norm before the
clip. The frozen SyncNet is restored from the newest checkpoint of a
``SyncNetTask`` work dir through ``checkpoint.partial_load(prefix_map=
{"syncnet": "p"})``, as JAX restores it; it takes no gradient and has no
optimiser state. Its convolutions are 1-D cuDNN calls: this stage
launches no kernel of the repo.

Batches come from ``data/datasets.Audio2MotionDataset`` where
``<binary_data_dir>/<split>.idx`` exists, else from
:meth:`Audio2MotionTask.synthetic_batch`. Every random draw (the
posterior's noise, the clips' starts) comes from the step's
``utils/draws.Draws`` in the JAX task's order.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from real3dportrait_tpu_torch.geometry.bfm import load_or_synthetic_bfm
from real3dportrait_tpu_torch.geometry.face3d_helper import reconstruct_idexp_lm3d
from real3dportrait_tpu_torch.models.audio2motion import PitchContourVAEModel
from real3dportrait_tpu_torch.models.syncnet import LandmarkHubertSyncNet, cal_sync_loss
from real3dportrait_tpu_torch.training import checkpoint as ckpt
from real3dportrait_tpu_torch.training import losses as L
from real3dportrait_tpu_torch.training.schedulers import Adam, build_schedule
from real3dportrait_tpu_torch.training.tasks.base_task import BaseTask
from real3dportrait_tpu_torch.utils.draws import seeded_draws
from real3dportrait_tpu_torch.weights import (
    jax_variables_from_torch,
    load_jax_variables,
    mock_init_,
    tensors_by_name,
)


def _params_to_tree(module, named: dict | None = None) -> dict:
    return jax_variables_from_torch(module, named)["params"]


@dataclass
class Audio2MotionState:
    """The step on the host, the model, its optimiser and the frozen
    SyncNet (or None); :meth:`state_dict` is the JAX task's ``TrainState``
    tree (``params.model``, ``params.syncnet``, ``opt_states.model``)."""

    step: int
    model: PitchContourVAEModel
    opt: Adam
    syncnet: LandmarkHubertSyncNet | None = None

    def state_dict(self) -> dict:
        params = {"model": _params_to_tree(self.model)}
        if self.syncnet is not None:
            params["syncnet"] = _params_to_tree(self.syncnet)
        return {"step": np.int32(self.step), "params": params, "variables": {},
                "opt_states": {"model": self.opt.state_dict(
                    lambda named: _params_to_tree(self.model, named))},
                "extra": {}}

    def load_state_dict(self, tree: dict) -> None:
        """Load a checkpoint tree of either package, strictly."""
        self.step = int(np.asarray(tree["step"]))
        load_jax_variables(self.model, {"params": tree["params"]["model"]})
        if self.syncnet is not None:
            load_jax_variables(self.syncnet, {"params": tree["params"]["syncnet"]})
        self.opt.load_state_dict(tree["opt_states"]["model"],
                                 functools.partial(tensors_by_name, self.model))


class Audio2MotionTask(BaseTask):
    def __init__(self, cfg: dict, device):
        super().__init__(cfg, device)
        self.audio_dim = 1024 if cfg.get("audio_type", "hubert") == "hubert" else 80
        # the reference trains against mediapipe-468 landmarks
        self.keypoint_mode = cfg.get("audio2motion_keypoint_mode", "mediapipe")
        self.assets = load_or_synthetic_bfm(cfg.get("bfm_dir"),
                                            keypoint_mode=self.keypoint_mode).to(self.device)
        self.schedule = build_schedule(cfg)
        self.clip_norm = float(cfg.get("clip_grad_norm", 1.0)) or 1e9
        self.use_syncnet = bool(cfg.get("syncnet_ckpt_dir")) and float(
            cfg.get("lambda_sync", 0.0)) > 0
        # lm468 feeds all 468 x 3 landmarks to the SyncNet, lm68 modes the
        # 20 mouth points
        self.sync_lm_dim = 468 * 3 if self.keypoint_mode == "mediapipe" else 60

    def build_model(self) -> PitchContourVAEModel:
        cfg = self.cfg
        return PitchContourVAEModel(
            in_out_dim=64, audio_in_dim=self.audio_dim,
            use_prior_flow=bool(cfg.get("use_flow", True)),
            use_pitch=bool(cfg.get("use_pitch", True)),
            use_mouth_amp_embed=bool(cfg.get("use_mouth_amp_embed", True)),
            use_eye_amp_embed=bool(cfg.get("use_eye_amp_embed", False)))

    def build_syncnet(self) -> LandmarkHubertSyncNet:
        return LandmarkHubertSyncNet(
            lm_dim=self.sync_lm_dim,
            base_hid_size=int(self.cfg.get("syncnet_base_hid_size", 128)),
            out_dim=int(self.cfg.get("syncnet_out_hid_size", 1024)))

    def load_syncnet(self, syncnet: LandmarkHubertSyncNet) -> dict | None:
        """The newest checkpoint of ``syncnet_ckpt_dir`` merged into
        ``syncnet`` (its ``params.syncnet`` read through the prefix map
        {"syncnet": "p"}); returns the merge's counts, or None where the
        dir has no checkpoint (the SyncNet keeps its seeded weights)."""
        restored, _ = ckpt.get_last_checkpoint(str(self.cfg["syncnet_ckpt_dir"]))
        if restored is None:
            return None
        merged, stats = ckpt.partial_load({"p": _params_to_tree(syncnet)},
                                          restored.get("params", restored),
                                          prefix_map={"syncnet": "p"})
        load_jax_variables(syncnet, {"params": merged["p"]})
        return stats

    def build(self, seed: int) -> Audio2MotionState:
        """Seeded weights (the JAX package's initialisers, drawn on the host),
        the clipped Adam and, where configured, the frozen SyncNet."""
        model = mock_init_(self.build_model(), torch.Generator().manual_seed(seed))
        model = model.to(self.device).train()
        opt = Adam(dict(model.named_parameters()), self.schedule,
                   b1=float(self.cfg.get("optimizer_adam_beta1", 0.9)),
                   b2=float(self.cfg.get("optimizer_adam_beta2", 0.999)),
                   every_k=int(self.cfg.get("accumulate_grad_batches", 1)),
                   clip_norm=self.clip_norm)
        syncnet = None
        if self.use_syncnet:
            syncnet = mock_init_(self.build_syncnet(), torch.Generator().manual_seed(seed + 1))
            self.load_syncnet(syncnet)
            syncnet = syncnet.to(self.device).requires_grad_(False)
        return Audio2MotionState(0, model, opt, syncnet)

    # -- losses ---------------------------------------------------------------

    def _idexp_lm3d(self, exp: torch.Tensor) -> torch.Tensor:
        """[B,T,64] expressions on a zero identity -> [B,T,K,3] landmarks."""
        b, t = exp.shape[:2]
        flat = exp.reshape(b * t, 64)
        idc = torch.zeros((b * t, 80), dtype=flat.dtype, device=flat.device)
        return reconstruct_idexp_lm3d(self.assets, idc, flat).reshape(b, t, -1, 3)

    def _sync_loss(self, syncnet, pred_lm: torch.Tensor, audio: torch.Tensor, draws
                   ) -> torch.Tensor:
        """The frozen SyncNet's BCE (label 1) over ``syncnet_num_clip_pairs
        // 64`` random 5-frame clips of every sample, the audio embedding's
        gradient stopped."""
        b, t = pred_lm.shape[:2]
        n_clips = min(int(self.cfg.get("syncnet_num_clip_pairs", 8192)) // 64, t - 5)
        starts = draws.integers((n_clips,), pred_lm.device, 0, t - 5)
        if self.keypoint_mode == "mediapipe":
            mouth = pred_lm.reshape(b, t, -1)
        else:
            mouth = pred_lm[:, :, 48:68].reshape(b, t, -1)
        ar = torch.arange(10, device=audio.device)
        hub = audio[:, 2 * starts[:, None] + ar]                    # [B,n,10,A]
        mouth = mouth[:, starts[:, None] + ar[:5]]                  # [B,n,5,D]
        hub = hub.transpose(0, 1).reshape(-1, 10, audio.shape[-1])
        mouth = mouth.transpose(0, 1).reshape(-1, 5, mouth.shape[-1])
        a_emb, m_emb = syncnet(hub, mouth)
        loss, _ = cal_sync_loss(a_emb.detach(), m_emb, 1.0)
        return loss.mean()

    def _losses(self, state: Audio2MotionState, batch: dict, draws) -> tuple:
        """(total, losses) at ``state.step``, differentiable in the model's
        parameters."""
        cfg = self.cfg
        out = state.model(batch, train=True, draws=draws)
        pred, mask, gt = out["pred"], batch["y_mask"], batch["y"]
        losses = {
            "mse_exp": L.masked_mse(pred, gt, mask[..., None]),
            "lap_exp": L.temporal_laplacian(pred, mask),
            "l2_reg_exp": pred.square().mean(),
            "kl": out["loss_kl"],
        }
        pred_lm, gt_lm = self._idexp_lm3d(pred), self._idexp_lm3d(gt)
        losses["mse_lm3d"] = L.weighted_lm3d_mse(pred_lm, gt_lm, mask,
                                                 n_landmarks=pred_lm.shape[2])
        if state.syncnet is not None:
            losses["sync"] = self._sync_loss(state.syncnet, pred_lm, batch["audio"], draws)
        weights = {
            "mse_exp": float(cfg.get("lambda_mse_exp", 0.5)),
            "mse_lm3d": float(cfg.get("lambda_mse_lm3d", 0.5)),
            "lap_exp": float(cfg.get("lambda_lap_exp", 1.0)),
            "l2_reg_exp": float(cfg.get("lambda_l2_reg_exp", 0.1)),
            "sync": float(cfg.get("lambda_sync", 0.0)),
        }
        kl_w = L.kl_annealing_weight(state.step, float(cfg.get("lambda_kl", 0.02)),
                                     int(cfg.get("lambda_kl_t1", 2000)),
                                     int(cfg.get("lambda_kl_t2", 2000)))
        total = L.weighted_loss_sum(losses, weights) + kl_w * losses["kl"]
        return total, losses

    # -- the step -------------------------------------------------------------

    def train_step(self, state: Audio2MotionState, batch: dict, draws) -> dict:
        """One update of ``state`` in place (zero between accumulation
        steps); the step's metrics as device scalars."""
        names, params = zip(*state.model.named_parameters())
        total, losses = self._losses(state, batch, draws)
        grads = dict(zip(names, torch.autograd.grad(total, params)))
        updates = state.opt.updates(grads)
        with torch.no_grad():
            for n, p in zip(names, params):
                p.add_(updates[n])
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        metrics["grad_norm"] = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        return metrics

    @torch.no_grad()
    def val_step(self, state: Audio2MotionState, batch: dict) -> dict:
        """The losses on a validation batch, its draws seeded with 0."""
        total, losses = self._losses(state, batch, seeded_draws(0, self.device))
        return {"val_loss": total, **{f"val_{k}": v for k, v in losses.items()}}

    # -- data -----------------------------------------------------------------

    def _store_batches(self, split: str, shuffle: bool, seed: int):
        store = os.path.join(str(self.cfg.get("binary_data_dir", "")), split)
        if not os.path.isfile(store + ".idx"):
            return None
        from real3dportrait_tpu_torch.data.datasets import Audio2MotionDataset

        return Audio2MotionDataset(store, self.cfg, shuffle=shuffle, seed=seed).batches()

    def train_data(self):
        real = self._store_batches("train", True, int(self.cfg.get("seed", 0)))
        yield from (real if real is not None else super().train_data())

    def val_data(self):
        real = self._store_batches("val", False, 1234)
        yield from (real if real is not None else super().val_data())

    def synthetic_batch(self, rng: np.random.RandomState) -> dict:
        """The JAX task's synthetic batch, array for array."""
        b = int(self.cfg.get("batch_size", 2))
        t50 = 2 * int(self.cfg.get("sample_min_length", 32))
        return {
            "audio": rng.randn(b, t50, self.audio_dim).astype(np.float32),
            "f0": np.abs(rng.randn(b, t50)).astype(np.float32) * 200,
            "y": (rng.randn(b, t50 // 2, 64) * 0.1).astype(np.float32),
            "y_mask": np.ones((b, t50 // 2), np.float32),
            "blink": np.zeros((b, t50, 1), np.int32),
            "mouth_amp": np.full((b, 1), 0.4, np.float32),
        }

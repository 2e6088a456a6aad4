"""Torso-stage GAN training (port of
``real3dportrait_tpu/training/tasks/secc_img2plane_torso_task.py``): only
the SR head, which owns the torso warp and the fusion nets, and the
discriminator learn.

The head groups (the two backbones and the decoder) come from a
``secc_img2plane`` checkpoint through the trainer's ``init_from_ckpt``
(``configs/secc_img2plane_torso.yaml``); their gates are 0, so Adam's
updates leave them as they are while their gradients and moments are kept,
as in the JAX task. The generator returns the torso model's occlusion
regularisers, which the flagship task's ``_g_loss`` weighs. On the card the
torso's kernels K5a, K5b, K7a and K7b run forward and backward as
hand-written kernels. ``ood_probe_batch`` and records-driven batches
(``prepare_batch_from_records``) are not ported.
"""

from __future__ import annotations

import numpy as np

from real3dportrait_tpu_torch.models.img2plane import OSAvatarSECCImg2PlaneTorso
from real3dportrait_tpu_torch.training.tasks.secc_img2plane_task import SeccImg2PlaneTask


class SeccImg2PlaneTorsoTask(SeccImg2PlaneTask):
    def build_generator(self) -> OSAvatarSECCImg2PlaneTorso:
        cfg = self.cfg
        return OSAvatarSECCImg2PlaneTorso(
            torso_kp_num=int(cfg.get("torso_kp_num", 4)),
            torso_scale=cfg.get("torso_model_scale", "standard"),
            fuse_mode=cfg.get("htbsr_head_weight_fuse_mode", "v2"),
            head_threshold=float(cfg.get("htbsr_head_threshold", 0.9)),
            torso_version=cfg.get("torso_model_version", "v2"),
            torso_inp_mode=cfg.get("torso_inp_mode", "rgb_alpha"),
            **self._generator_kwargs())

    def _gen_apply_kwargs(self, batch: dict) -> dict:
        return {"cond": {k: batch[k] for k in ("ref_torso_img", "bg_img", "segmap", "kp_src",
                                               "kp_drv")}}

    def _grad_gates(self, step: int) -> dict:
        """Only the SR head (with the torso model) trains."""
        return {"img2plane_backbone": 0.0, "secc_img2plane_backbone": 0.0, "decoder": 0.0,
                "superresolution": 1.0}

    def synthetic_batch(self, rng: np.random.RandomState) -> dict:
        """The flagship's synthetic batch and the torso stage's inputs, the
        same arrays as the JAX task's from the same ``RandomState``."""
        batch = super().synthetic_batch(rng)
        b = int(self.cfg.get("batch_size", 1))
        final = int(self.cfg.get("final_resolution", 512))
        seg = np.zeros((b, final, final, 6), np.float32)
        seg[..., 4] = 1.0
        batch.update({
            "ref_torso_img": rng.uniform(-1, 1, (b, final, final, 3)).astype(np.float32),
            "bg_img": rng.uniform(-1, 1, (b, final, final, 3)).astype(np.float32),
            "segmap": seg,
            "kp_src": rng.uniform(-0.8, 0.8, (b, 68, 3)).astype(np.float32),
            "kp_drv": rng.uniform(-0.8, 0.8, (b, 68, 3)).astype(np.float32),
        })
        return batch

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
hand-written kernels. Record batches add the torso stage's inputs to the
flagship's: the composed person + background frame as the target, the
torso image, the background, the one-hot segmap and the keypoints of the
fitted coefficients.
"""

from __future__ import annotations

import numpy as np
import torch

from real3dportrait_tpu_torch.geometry.face3d_helper import reconstruct_lm2d
from real3dportrait_tpu_torch.models.img2plane import OSAvatarSECCImg2PlaneTorso
from real3dportrait_tpu_torch.training.tasks.secc_img2plane_task import (
    SeccImg2PlaneTask,
    resize_nearest,
)


def _segmap_one_hot(final: int, b: int, device) -> torch.Tensor:
    """[B,final,final,6] with every pixel in class 4 (the torso's)."""
    seg = torch.zeros((b, final, final, 6), device=device)
    seg[..., 4] = 1.0
    return seg


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

    @torch.no_grad()
    def prepare_batch_from_records(self, rec: dict) -> dict:
        """The flagship's record batch, with the composed frame
        (``tgt_com_imgs``) as the target, ``ref_torso_img``, ``bg_img``, the
        one-hot ``segmap`` (nearest resize; a class outside 0-5 is all
        zeros, as ``jax.nn.one_hot`` gives) and the keypoints ``kp_src`` /
        ``kp_drv``: the coefficients' 2D landmarks in [-1,1] with z = 0."""
        batch = super().prepare_batch_from_records(rec)
        if "tgt_com_imgs" in rec:
            batch["tgt_img"] = self._to_img(rec["tgt_com_imgs"])
        batch["ref_torso_img"] = self._to_img(rec.get("src_torso_imgs", rec["src_head_imgs"]))
        bg = rec.get("src_bg_img")
        batch["bg_img"] = self._to_img(bg) if bg is not None else torch.zeros_like(
            batch["src_img"])
        b, final = batch["src_img"].shape[:2]
        if "src_segmaps" in rec:
            seg = torch.as_tensor(np.asarray(rec["src_segmaps"])).to(self.device).long()
            segmap = (seg[..., None] == torch.arange(6, device=self.device)).float()
            if segmap.shape[1] != final:
                segmap = resize_nearest(segmap, final)
        else:
            segmap = _segmap_one_hot(final, b, self.device)
        batch["segmap"] = segmap
        assets, c = self._secc_renderer().assets, self._coeffs

        def kp(id_c, exp_c, euler, trans):
            lm = reconstruct_lm2d(assets, c(id_c), c(exp_c), c(euler), c(trans))
            return torch.cat([lm * 2 - 1, torch.zeros_like(lm[..., :1])], dim=-1)

        batch["kp_src"] = kp(rec["src_id"], rec["src_exp"], rec["src_euler"], rec["src_trans"])
        batch["kp_drv"] = kp(rec["src_id"], rec["tgt_exp"], rec["tgt_euler"], rec["tgt_trans"])
        return batch

    def ood_probe_batch(self) -> dict:
        """The flagship's probe with the torso inputs: its image as the torso
        and the background, the torso class everywhere, zero keypoints."""
        probe = super().ood_probe_batch()
        if "ref_torso_img" not in probe:
            res, dev = int(probe["src_img"].shape[1]), self.device
            probe.update({"ref_torso_img": probe["src_img"], "bg_img": probe["src_img"],
                          "segmap": _segmap_one_hot(res, 1, dev),
                          "kp_src": torch.zeros((1, 68, 3), device=dev),
                          "kp_drv": torch.zeros((1, 68, 3), device=dev)})
        return probe

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

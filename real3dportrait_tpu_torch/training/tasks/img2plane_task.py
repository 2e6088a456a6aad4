"""img2plane distillation from a frozen EG3D teacher (port of
``real3dportrait_tpu/training/tasks/img2plane_task.py``).

The teacher (:class:`~..models.eg3d.TriPlaneGenerator`) draws a latent and
renders a reference view and a novel view of it (:meth:`prepare_batch`,
no gradient, const noise); the student (:class:`~..models.img2plane.
OSAvatarImg2Plane`, tri-grids, so kernel K1-trigrid and its backward on
the card) rebuilds both views from the teacher's reference image. The
generator's losses are L1 on the image and the raw image of both views,
the Laplacian-pyramid loss on the novel view and, from
``start_adv_iters``, the adversarial loss against the dual discriminator;
then the discriminator's step with lazy R1 on the teacher's novel views.
The student's Adam runs on ``gan_lr_schedule(lr_g, ..., floor=1e-5)``,
and its updates are gated by group: the decoder from ``min(2000,
start_adv_iters)``, the SR head from ``start_adv_iters``.

Two properties of the JAX task are reproduced, not changed: nothing reads
``pretrained_eg3d_ckpt``, so the teacher starts from its init; and
``not_save_modules`` names ``eg3d_model``, which is not the state's
``teacher`` key, so checkpoints carry the teacher. The renders are the
deterministic ones (JAX renders without a key); the only random draw is
the teacher's latent, from the step's ``utils/draws.Draws``. Batches are
cameras only (``synthetic_batch``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from real3dportrait_tpu_torch.models.dual_discriminator import DualDiscriminator
from real3dportrait_tpu_torch.models.eg3d import TriPlaneGenerator
from real3dportrait_tpu_torch.models.img2plane import OSAvatarImg2Plane
from real3dportrait_tpu_torch.training import losses as L
from real3dportrait_tpu_torch.training.schedulers import Adam, gan_lr_schedule
from real3dportrait_tpu_torch.training.tasks.base_task import BaseTask
from real3dportrait_tpu_torch.training.tasks.eg3d_task import (
    apply_updates,
    build_dual_discriminator,
    grads_of,
    r1_grads,
    synthetic_cameras,
)
from real3dportrait_tpu_torch.training.tasks.secc_img2plane_task import global_norm
from real3dportrait_tpu_torch.utils.draws import seeded_draws
from real3dportrait_tpu_torch.weights import (
    jax_variables_from_torch,
    load_jax_variables,
    mock_init_,
    tensors_by_name,
)


def _variables(module) -> dict:
    return {k: v for k, v in jax_variables_from_torch(module).items() if k != "params"}


@dataclass
class Img2PlaneState:
    """The step on the host, the student, the frozen teacher, the
    discriminator and the two optimisers (``opt_g`` the student's);
    :meth:`state_dict` is the JAX task's ``TrainState`` tree (``params``
    and ``variables`` by ``student`` / ``teacher`` / ``disc``,
    ``opt_states`` ``gen`` and ``disc``)."""

    step: int
    student: OSAvatarImg2Plane
    teacher: TriPlaneGenerator
    disc: DualDiscriminator
    opt_g: Adam
    opt_d: Adam

    def state_dict(self) -> dict:
        def tree_of(module):
            return lambda named: jax_variables_from_torch(module, named)["params"]

        return {
            "step": np.int32(self.step),
            "params": {k: jax_variables_from_torch(m)["params"] for k, m in (
                ("student", self.student), ("teacher", self.teacher), ("disc", self.disc))},
            "variables": {"student": _variables(self.student),
                          "teacher": _variables(self.teacher)},
            "opt_states": {"gen": self.opt_g.state_dict(tree_of(self.student)),
                           "disc": self.opt_d.state_dict(tree_of(self.disc))},
            "extra": {},
        }

    def load_state_dict(self, tree: dict) -> None:
        """Load a checkpoint tree of either package, strictly."""
        self.step = int(np.asarray(tree["step"]))
        variables = tree.get("variables", {})
        for key in ("student", "teacher", "disc"):
            load_jax_variables(getattr(self, key), {"params": tree["params"][key],
                                                    **variables.get(key, {})})
        self.opt_g.load_state_dict(tree["opt_states"]["gen"],
                                   functools.partial(tensors_by_name, self.student))
        self.opt_d.load_state_dict(tree["opt_states"]["disc"],
                                   functools.partial(tensors_by_name, self.disc))


class Img2PlaneTask(BaseTask):
    def __init__(self, cfg: dict, device):
        super().__init__(cfg, device)
        self.start_adv = int(cfg.get("start_adv_iters", 30000))
        self.sched_g = gan_lr_schedule(float(cfg.get("lr_g", 1e-4)),
                                       float(cfg.get("lr_decay_rate", 0.95)),
                                       int(cfg.get("lr_decay_interval", 5000)),
                                       int(cfg.get("warmup_updates", 0)), floor=1e-5)

    def _common(self) -> dict:
        cfg = self.cfg
        return dict(
            triplane_hid_dim=int(cfg.get("triplane_hid_dim", 32)),
            neural_rendering_resolution=int(cfg.get("neural_rendering_resolution", 128)),
            final_resolution=int(cfg.get("final_resolution", 512)),
            num_samples_coarse=int(cfg.get("num_samples_coarse", 48)),
            num_samples_fine=int(cfg.get("num_samples_fine", 48)),
            sr_num_fp16_res=int(cfg.get("num_fp16_layers_in_super_resolution", 4)))

    def build_student(self) -> OSAvatarImg2Plane:
        """The JAX task's student: its backbone mode is the class default
        (the SegFormer), whatever ``img2plane_backbone_mode`` says."""
        cfg = self.cfg
        return OSAvatarImg2Plane(
            triplane_depth=int(cfg.get("triplane_depth", 3)),
            triplane_feature_type=cfg.get("triplane_feature_type", "trigrid"),
            backbone_scale=cfg.get("img2plane_backbone_scale", "b0"),
            sr_channel0=int(cfg.get("sr_channel0", 256)),
            sr_channel1=int(cfg.get("sr_channel1", 128)), **self._common())

    def build_teacher(self) -> TriPlaneGenerator:
        cfg = self.cfg
        return TriPlaneGenerator(
            z_dim=int(cfg.get("z_dim", 512)), w_dim=int(cfg.get("w_dim", 512)),
            plane_resolution=int(cfg.get("teacher_plane_resolution", 256)),
            channel_base=int(cfg.get("base_channel", 32768)),
            channel_max=int(cfg.get("max_channel", 512)),
            mapping_layers=int(cfg.get("mapping_network_depth", 2)), **self._common())

    def build(self, seed: int) -> Img2PlaneState:
        """Seeded weights (the JAX package's initialisers, drawn on the
        host); the teacher is frozen (no gradient, no optimiser)."""
        cfg = self.cfg
        student = mock_init_(self.build_student(), torch.Generator().manual_seed(seed))
        teacher = mock_init_(self.build_teacher(), torch.Generator().manual_seed(seed + 1))
        disc = mock_init_(build_dual_discriminator(cfg), torch.Generator().manual_seed(seed + 2))
        student, disc = student.to(self.device).train(), disc.to(self.device).train()
        teacher = teacher.to(self.device).requires_grad_(False)
        k = int(cfg.get("accumulate_grad_batches", 1))
        opt_g = Adam(dict(student.named_parameters()), self.sched_g,
                     b1=float(cfg.get("optimizer_adam_beta1_g", 0.0)),
                     b2=float(cfg.get("optimizer_adam_beta2_g", 0.99)), every_k=k)
        opt_d = Adam(dict(disc.named_parameters()), float(cfg.get("lr_d", 2e-4)),
                     b1=float(cfg.get("optimizer_adam_beta1_d", 0.0)),
                     b2=float(cfg.get("optimizer_adam_beta2_d", 0.99)), every_k=k)
        return Img2PlaneState(0, student, teacher, disc, opt_g, opt_d)

    # -- the teacher's batch --------------------------------------------------

    @torch.no_grad()
    def prepare_batch(self, state: Img2PlaneState, batch: dict, draws) -> dict:
        """One latent from ``draws``; the teacher's reference view under
        ``camera`` and novel view under ``camera_mv`` (each camera also
        conditions the mapping), const noise, no gradient."""
        ref_cam, mv_cam = batch["camera"], batch["camera_mv"]
        z = draws.normal((ref_cam.shape[0], state.teacher.z_dim), ref_cam.device)
        ref = state.teacher(z, ref_cam, noise_mode="const")
        mv = state.teacher(z, mv_cam, noise_mode="const")
        return {"ref_img": ref["image"], "ref_raw": ref["image_raw"],
                "mv_img": mv["image"], "mv_raw": mv["image_raw"],
                "ref_cam": ref_cam, "mv_cam": mv_cam}

    # -- the step -------------------------------------------------------------

    def _g_loss(self, state: Img2PlaneState, prepared: dict) -> tuple:
        """(total, losses, the novel view's outputs) at ``state.step``,
        differentiable in the student's parameters."""
        cfg = self.cfg
        student = state.student
        planes = student.cal_cano_plane(prepared["ref_img"])
        out_ref = student(prepared["ref_img"], prepared["ref_cam"], planes=planes)
        out_mv = student(prepared["ref_img"], prepared["mv_cam"], planes=planes)
        losses = {
            "mse_ref": L.masked_l1(out_ref["image"], prepared["ref_img"]),
            "mse_ref_raw": L.masked_l1(out_ref["image_raw"], prepared["ref_raw"]),
            "mse_mv": L.masked_l1(out_mv["image"], prepared["mv_img"]),
            "mse_mv_raw": L.masked_l1(out_mv["image_raw"], prepared["mv_raw"]),
            "percep": L.laplacian_pyramid_loss(out_mv["image"], prepared["mv_img"]),
        }
        if state.step >= self.start_adv:
            losses["adv"] = L.g_nonsaturating_loss(
                state.disc(out_mv["image"], out_mv["image_raw"], prepared["mv_cam"]))
        else:
            losses["adv"] = torch.zeros((), device=self.device)
        lam = float(cfg.get("lambda_mse", 1.0))
        weights = {"mse_ref": lam, "mse_ref_raw": lam, "mse_mv": lam, "mse_mv_raw": lam,
                   "percep": float(cfg.get("lambda_lpips", 0.5)),
                   "adv": float(cfg.get("lambda_adv", 0.002))}
        return L.weighted_loss_sum(losses, weights), losses, out_mv

    def grad_gates(self, step: int) -> dict:
        """The update gates of the student's groups: the decoder from
        ``min(2000, start_adv_iters)``, the SR head from ``start_adv_iters``,
        the backbone always."""
        return {"decoder": 1.0 if step >= min(2000, self.start_adv) else 0.0,
                "superresolution": 1.0 if step >= self.start_adv else 0.0}

    def train_step(self, state: Img2PlaneState, batch: dict, draws) -> dict:
        """The teacher's batch, one student update and one D update of
        ``state`` in place; the step's metrics as device scalars."""
        prepared = self.prepare_batch(state, batch, draws)
        g_total, losses, out_mv = self._g_loss(state, prepared)
        g_grads = grads_of(g_total, state.student)
        apply_updates(state.student, state.opt_g.updates(g_grads), self.grad_gates(state.step))
        fake, fake_raw = out_mv["image"].detach(), out_mv["image_raw"].detach()
        del out_mv
        disc, mv_cam = state.disc, prepared["mv_cam"]
        d_total = L.d_logistic_loss(disc(prepared["mv_img"], prepared["mv_raw"], mv_cam),
                                    disc(fake, fake_raw, mv_cam))
        d_grads, r1_val = r1_grads(self.cfg, disc, prepared["mv_img"], prepared["mv_raw"],
                                   mv_cam, state.step, grads_of(d_total, disc))
        apply_updates(disc, state.opt_d.updates(d_grads), {})
        state.step += 1
        metrics = {f"g/{k}": v.detach() for k, v in losses.items()}
        metrics.update({"total_loss": g_total.detach(), "d/loss": d_total.detach(),
                        "d/r1": r1_val, "g/grad_norm": global_norm(g_grads),
                        "d/grad_norm": global_norm(d_grads)})
        return metrics

    @torch.no_grad()
    def val_step(self, state: Img2PlaneState, batch: dict) -> dict:
        """The student's losses on a validation batch, the latent seeded
        with 0."""
        prepared = self.prepare_batch(state, batch, seeded_draws(0, self.device))
        total, losses, _ = self._g_loss(state, prepared)
        return {"val_loss": total, **{f"val_{k}": v for k, v in losses.items()}}

    def synthetic_batch(self, rng: np.random.RandomState) -> dict:
        """Camera-only batches: poses uniform over +-26 degrees of pitch and
        +-38 of yaw."""
        camera, camera_mv = synthetic_cameras(rng, int(self.cfg.get("batch_size", 1)))
        return {"camera": camera, "camera_mv": camera_mv}

"""EG3D generator training (port of
``real3dportrait_tpu/training/tasks/eg3d_task.py``), the teacher of the
img2plane distillation: the :class:`~..models.eg3d.TriPlaneGenerator`
against the camera-conditioned dual discriminator.

One :meth:`EG3DTask.train_step` is the generator update, then the
discriminator update, with the JAX task's terms:

* generator pose conditioning: with probability ``gpc_reg_prob`` the
  mapping network sees ``camera_swap`` instead of the rendered camera;
* the density regulariser every ``reg_interval_g`` steps, through the
  planes (K1 and its backward on the card);
* lazy R1 every ``reg_interval_d`` steps, interval-scaled, through a
  double backward (K6a and K6b differentiate twice on the card);
* the generator's EMA with ``ema_interval``; Adam at constant rates with
  beta1 = 0 (``optax.adam(lr)``), under ``accumulate_grad_batches``.

The renders are the deterministic ones (midpoint depths, linspace ``u``),
as JAX renders them without a key, and the noise is the const noise. The
mapping network's w average is not updated (JAX's step does not ask for
it). Every random draw (the latents, the swap, the regulariser's points)
comes from the step's ``utils/draws.Draws`` in the JAX task's order.
Batches are synthetic: cameras from :func:`sample_uniform_pose` on a
``torch.Generator`` seeded from the batch's ``RandomState`` (JAX seeds its
PRNG key there) and uniform real images.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from real3dportrait_tpu_torch.geometry.camera import (
    fov_to_intrinsics,
    pack_camera,
    sample_uniform_pose,
)
from real3dportrait_tpu_torch.models.dual_discriminator import DualDiscriminator
from real3dportrait_tpu_torch.models.eg3d import TriPlaneGenerator
from real3dportrait_tpu_torch.training import losses as L
from real3dportrait_tpu_torch.training.schedulers import Adam
from real3dportrait_tpu_torch.training.tasks.base_task import BaseTask
from real3dportrait_tpu_torch.training.tasks.secc_img2plane_task import (
    SeccImg2PlaneTask,
    global_norm,
)
from real3dportrait_tpu_torch.training.train_state import TrainState
from real3dportrait_tpu_torch.utils.draws import seeded_draws
from real3dportrait_tpu_torch.weights import mock_init_

grads_of, apply_updates = SeccImg2PlaneTask.grads, SeccImg2PlaneTask._apply


def ema_beta(cfg) -> float:
    return 0.5 ** (1.0 / max(float(cfg.get("ema_interval", 400)), 1.0))


def synthetic_cameras(rng: np.random.RandomState, b: int) -> tuple[np.ndarray, np.ndarray]:
    """Two batches of uniform poses (+-26 / +-38 degrees) as [B,25] cameras,
    from a ``torch.Generator`` seeded with ``rng.randint(0, 2**31 - 1)``."""
    gen = torch.Generator().manual_seed(int(rng.randint(0, 2**31 - 1)))
    intr = fov_to_intrinsics()
    return tuple(pack_camera(sample_uniform_pose(gen, b), intr).numpy() for _ in range(2))


def build_dual_discriminator(cfg) -> DualDiscriminator:
    return DualDiscriminator(
        img_resolution=int(cfg.get("final_resolution", 512)),
        channel_base=int(cfg.get("base_channel", 32768)),
        channel_max=int(cfg.get("max_channel", 512)),
        num_fp16_res=int(cfg.get("num_fp16_layers_in_discriminator", 4)),
        mbstd_group_size=int(cfg.get("group_size_for_mini_batch_std", 2)))


def r1_grads(cfg, disc, image, image_raw, camera, step: int, d_grads: dict) -> tuple:
    """Lazy R1 every ``reg_interval_d`` steps: (d grads with the penalty's,
    scaled by ``lambda_gradient_penalty / 2 * reg_interval_d``, added; the
    penalty, 0 off its steps)."""
    reg_d = int(cfg.get("reg_interval_d", 16))
    if step % reg_d != 0:
        return d_grads, torch.zeros((), device=image.device)
    r1 = L.r1_penalty(disc, image, image_raw, camera)
    gp_w = float(cfg.get("lambda_gradient_penalty", 5.0)) / 2.0 * reg_d
    r1_g = grads_of(r1, disc)
    return {n: g + gp_w * r1_g[n] for n, g in d_grads.items()}, r1.detach()


class EG3DTask(BaseTask):
    def __init__(self, cfg: dict, device):
        super().__init__(cfg, device)
        self.z_dim = int(cfg.get("z_dim", 512))

    def build_generator(self) -> TriPlaneGenerator:
        cfg = self.cfg
        return TriPlaneGenerator(
            z_dim=self.z_dim, w_dim=int(cfg.get("w_dim", 512)),
            plane_resolution=int(cfg.get("teacher_plane_resolution", 256)),
            triplane_hid_dim=int(cfg.get("triplane_hid_dim", 32)),
            neural_rendering_resolution=int(cfg.get("neural_rendering_resolution", 128)),
            final_resolution=int(cfg.get("final_resolution", 512)),
            channel_base=int(cfg.get("base_channel", 32768)),
            channel_max=int(cfg.get("max_channel", 512)),
            mapping_layers=int(cfg.get("mapping_network_depth", 2)),
            sr_num_fp16_res=int(cfg.get("num_fp16_layers_in_super_resolution", 4)),
            num_samples_coarse=int(cfg.get("num_samples_coarse", 48)),
            num_samples_fine=int(cfg.get("num_samples_fine", 48)))

    def build(self, seed: int) -> TrainState:
        """Seeded weights (the JAX package's initialisers, drawn on the host),
        the EMA copy and the two optimisers."""
        cfg = self.cfg
        gen = mock_init_(self.build_generator(), torch.Generator().manual_seed(seed))
        disc = mock_init_(build_dual_discriminator(cfg), torch.Generator().manual_seed(seed + 1))
        gen, disc = gen.to(self.device).train(), disc.to(self.device).train()
        gen_ema = copy.deepcopy(gen).requires_grad_(False)
        k = int(cfg.get("accumulate_grad_batches", 1))
        opt_g = Adam(dict(gen.named_parameters()), float(cfg.get("lr_g", 0.0025)),
                     b1=float(cfg.get("optimizer_adam_beta1_g", 0.0)),
                     b2=float(cfg.get("optimizer_adam_beta2_g", 0.99)), every_k=k)
        opt_d = Adam(dict(disc.named_parameters()), float(cfg.get("lr_d", 0.002)),
                     b1=float(cfg.get("optimizer_adam_beta1_d", 0.0)),
                     b2=float(cfg.get("optimizer_adam_beta2_d", 0.99)), every_k=k)
        return TrainState(0, gen, disc, gen_ema, opt_g, opt_d, {})

    # -- the step -------------------------------------------------------------

    def gen_images(self, gen: TriPlaneGenerator, batch: dict, draws) -> dict:
        """z and the pose-conditioning swap from ``draws``, then the render
        of ``batch['camera']``."""
        camera = batch["camera"]
        b = camera.shape[0]
        z = draws.normal((b, self.z_dim), camera.device)
        swap = draws.uniform((b, 1), camera.device) < float(self.cfg.get("gpc_reg_prob", 0.5))
        cond_cam = torch.where(swap, batch["camera_swap"], camera)
        return gen.synthesis(gen.map_latents(z, cond_cam), camera)

    def _g_loss(self, state: TrainState, batch: dict, draws) -> tuple:
        """(total, losses, outputs) at ``state.step``, differentiable in the
        generator's parameters."""
        cfg = self.cfg
        gen = state.gen
        out = self.gen_images(gen, batch, draws)
        losses = {"adv": L.g_nonsaturating_loss(
            state.disc(out["image"], out["image_raw"], batch["camera"]))}
        reg_g = int(cfg.get("reg_interval_g", 4))
        if state.step % reg_g == 0:
            losses["density_reg"] = L.density_regularization(
                lambda pts: gen.sample_points(out["plane"], pts), draws, self.device,
                box_warp=float(cfg.get("box_warp", 1.0)),
                p_dist=float(cfg.get("density_reg_p_dist", 0.004)))
        else:
            losses["density_reg"] = torch.zeros((), device=self.device)
        total = losses["adv"] + float(cfg.get("lambda_density_reg", 0.25)) * reg_g \
            * losses["density_reg"]
        return total, losses, out

    @torch.no_grad()
    def update_ema(self, state: TrainState) -> None:
        beta = ema_beta(self.cfg)
        params = dict(state.gen.named_parameters())
        for name, e in state.gen_ema.named_parameters():
            e.copy_(e * beta + params[name] * (1.0 - beta))

    def train_step(self, state: TrainState, batch: dict, draws) -> dict:
        """One G update and one D update of ``state`` in place; the step's
        metrics as device scalars."""
        g_total, losses, out = self._g_loss(state, batch, draws)
        g_grads = grads_of(g_total, state.gen)
        apply_updates(state.gen, state.opt_g.updates(g_grads), {})
        fake, fake_raw = out["image"].detach(), out["image_raw"].detach()
        del out
        disc, camera = state.disc, batch["camera"]
        d_total = L.d_logistic_loss(disc(batch["real_img"], batch["real_raw"], camera),
                                    disc(fake, fake_raw, camera))
        d_grads, r1_val = r1_grads(self.cfg, disc, batch["real_img"], batch["real_raw"],
                                   camera, state.step, grads_of(d_total, disc))
        apply_updates(disc, state.opt_d.updates(d_grads), {})
        self.update_ema(state)
        state.step += 1
        return {"total_loss": g_total.detach(), "g/adv": losses["adv"].detach(),
                "g/density_reg": losses["density_reg"].detach(), "d/loss": d_total.detach(),
                "d/r1": r1_val, "g/grad_norm": global_norm(g_grads),
                "d/grad_norm": global_norm(d_grads)}

    @torch.no_grad()
    def val_step(self, state: TrainState, batch: dict) -> dict:
        """The generator's losses on a validation batch, its draws seeded
        with 0."""
        total, losses, _ = self._g_loss(state, batch, seeded_draws(0, self.device))
        return {"val_loss": total, **{f"val_{k}": v for k, v in losses.items()}}

    def synthetic_batch(self, rng: np.random.RandomState) -> dict:
        cfg = self.cfg
        b = int(cfg.get("batch_size", 4))
        final = int(cfg.get("final_resolution", 512))
        res = int(cfg.get("neural_rendering_resolution", 128))
        camera, camera_swap = synthetic_cameras(rng, b)
        return {"camera": camera, "camera_swap": camera_swap,
                "real_img": rng.uniform(-1, 1, (b, final, final, 3)).astype(np.float32),
                "real_raw": rng.uniform(-1, 1, (b, res, res, 3)).astype(np.float32)}

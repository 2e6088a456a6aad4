"""SECC-conditioned motion-to-plane GAN training (port of
``real3dportrait_tpu/training/tasks/secc_img2plane_task.py``).

One :meth:`SeccImg2PlaneTask.train_step` is the generator update, then the
discriminator update, with the JAX task's step-indexed terms:

* src2src self-reconstruction every ``update_src2src_interval`` steps;
* the adversarial term from ``start_adv_iters``; the per-group gates of
  the two-stage schedule multiply the Adam updates (:meth:`_grad_gates`);
* EG3D density regularisation every ``reg_interval_g`` steps;
* lazy R1 every ``reg_interval_d`` steps, interval-scaled, through a double
  backward (kernels K6a and K6b differentiate twice on the card);
* the SECC-perturbation regularisers every ``reg_interval_g_cond`` steps
  with their self-tuning lambdas in ``state.extra``, tuned on the device;
* the generator EMA with ``ema_beta``.

The step runs on the host's step count, so the step-indexed choices are
Python branches, and reads nothing back from the device. Every random draw
comes from the step's :class:`~real3dportrait_tpu_torch.utils.draws.Draws`,
in the JAX task's order. On the card the render's kernels K1-trigrid (or
K1 for tri-planes) and K3, and the SR head's and the discriminator's K6a
and K6b, run forward and backward as hand-written kernels. A generator
that returns ``facev2v_losses`` (the torso task's) adds them with the
config's ``lam_occlusion_*`` weights.

Batches come from a binarized record store where
``<binary_data_dir>/<split>.idx`` exists (``data/datasets.Motion2VideoDataset``
pairs through :meth:`prepare_batch_from_records`, whose SECC maps K4
rasterizes on the task's device), else from :meth:`synthetic_batch`, as in
JAX. :meth:`val_images` renders the validation strips the trainer writes
as PNGs, with the fixed :meth:`ood_probe_batch`.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch
import torch.nn.functional as F

from real3dportrait_tpu_torch.geometry.camera import (
    convert_eg3d_convention,
    fov_to_intrinsics,
    lookat_pose,
    pack_camera,
)
from real3dportrait_tpu_torch.models.dual_discriminator import DualDiscriminator
from real3dportrait_tpu_torch.models.img2plane import OSAvatarSECCImg2Plane
from real3dportrait_tpu_torch.models.perceptual import make_perceptual_fn
from real3dportrait_tpu_torch.ops.resize import resize_linear
from real3dportrait_tpu_torch.parallel.distributed import all_reduce_mean
from real3dportrait_tpu_torch.training import losses as L
from real3dportrait_tpu_torch.training.schedulers import Adam, gan_lr_schedule
from real3dportrait_tpu_torch.training.tasks.base_task import BaseTask
from real3dportrait_tpu_torch.training.train_state import TrainState
from real3dportrait_tpu_torch.weights import mock_init_

f32 = np.float32


def resize_nearest(x: torch.Tensor, size: int) -> torch.Tensor:
    """NHWC ``jax.image.resize(..., "nearest")`` (half-pixel centres)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="nearest-exact")
    return y.permute(0, 2, 3, 1)


def global_norm(grads: dict) -> torch.Tensor:
    return torch.sqrt(sum(g.float().square().sum() for g in grads.values()))


class SeccImg2PlaneTask(BaseTask):
    def __init__(self, cfg: dict, device):
        super().__init__(cfg, device)
        self.percep_fn, self.percep_kind = make_perceptual_fn(cfg, self.device)
        decay = float(cfg.get("lr_decay_rate", 0.95))
        interval = int(cfg.get("lr_decay_interval", 5000))
        warm = int(cfg.get("warmup_updates", 0))
        self.sched_g = gan_lr_schedule(float(cfg.get("lr_g", 1e-4)), decay, interval, warm)
        self.sched_d = gan_lr_schedule(float(cfg.get("lr_d", 2e-4)), decay, interval, warm)
        self.neural_rendering_resolution = int(cfg.get("neural_rendering_resolution", 128))
        self._secc_r = None       # the SECC renderer of record batches, built at first use
        self._prep_rng = None     # the record batches' RandomState, seeded at first use
        self._ood_probe = None

    # -- models ---------------------------------------------------------------

    def _generator_kwargs(self) -> dict:
        """The generator's configuration, shared with the torso task."""
        cfg = self.cfg
        return dict(
            triplane_hid_dim=int(cfg.get("triplane_hid_dim", 32)),
            triplane_depth=int(cfg.get("triplane_depth", 3)),
            triplane_feature_type=cfg.get("triplane_feature_type", "trigrid"),
            neural_rendering_resolution=self.neural_rendering_resolution,
            final_resolution=int(cfg.get("final_resolution", 512)),
            backbone_mode=cfg.get("img2plane_backbone_mode", "segformer"),
            backbone_scale=cfg.get("img2plane_backbone_scale", "b0"),
            head_norm_mode=cfg.get("head_norm_mode", "gn"),
            secc_segformer_scale=cfg.get("secc_segformer_scale", "b0"),
            pncc_cond_mode=cfg.get("pncc_cond_mode", "cano_src_tgt"),
            plane_fusion_mode=cfg.get("phase1_plane_fusion_mode", "add"),
            sr_num_fp16_res=int(cfg.get("num_fp16_layers_in_super_resolution", 4)),
            num_samples_coarse=int(cfg.get("num_samples_coarse", 48)),
            num_samples_fine=int(cfg.get("num_samples_fine", 48)),
            sr_channel0=int(cfg.get("sr_channel0", 256)),
            sr_channel1=int(cfg.get("sr_channel1", 128)))

    def build_generator(self) -> OSAvatarSECCImg2Plane:
        return OSAvatarSECCImg2Plane(**self._generator_kwargs())

    def build_discriminator(self) -> DualDiscriminator:
        cfg = self.cfg
        return DualDiscriminator(
            img_resolution=int(cfg.get("final_resolution", 512)),
            channel_base=int(cfg.get("base_channel", 32768)),
            channel_max=int(cfg.get("max_channel", 512)),
            num_fp16_res=int(cfg.get("num_fp16_layers_in_discriminator", 4)),
            mbstd_group_size=int(cfg.get("group_size_for_mini_batch_std", 2)),
            disc_c_noise=0.0)

    def build(self, seed: int) -> TrainState:
        """Seeded weights (the JAX package's initialisers, drawn on the host
        from ``seed``), the EMA copy, the optimisers and the lambdas."""
        cfg = self.cfg
        gen = mock_init_(self.build_generator(), torch.Generator().manual_seed(seed))
        disc = mock_init_(self.build_discriminator(), torch.Generator().manual_seed(seed + 1))
        gen, disc = gen.to(self.device).train(), disc.to(self.device).train()
        gen_ema = None
        if bool(cfg.get("use_gen_ema", True)):
            gen_ema = copy.deepcopy(gen).requires_grad_(False)
        k = int(cfg.get("accumulate_grad_batches", 1))
        opt_g = Adam(dict(gen.named_parameters()), self.sched_g,
                     b1=float(cfg.get("optimizer_adam_beta1_g", 0.0)),
                     b2=float(cfg.get("optimizer_adam_beta2_g", 0.99)), every_k=k)
        opt_d = Adam(dict(disc.named_parameters()), self.sched_d,
                     b1=float(cfg.get("optimizer_adam_beta1_d", 0.0)),
                     b2=float(cfg.get("optimizer_adam_beta2_d", 0.99)), every_k=k)
        extra = {
            "lambda_pertube_secc": torch.tensor(
                float(cfg.get("lambda_pertube_secc_init", 0.0)), device=self.device),
            "lambda_pertube_blink_secc": torch.tensor(
                float(cfg.get("lambda_pertube_blink_secc_init", 0.0)), device=self.device),
        }
        return TrainState(0, gen, disc, gen_ema, opt_g, opt_d, extra)

    @property
    def ema_beta(self) -> float:
        interval = float(self.cfg.get("ema_interval", 400))
        return 0.5 ** (1.0 / max(interval, 1.0))

    # -- per-group learning-rate multipliers ------------------------------------

    def _grad_gates(self, step: int) -> dict:
        """Per-group multipliers of the Adam updates (the reference's
        ``param_groups[i]['lr']`` ramps; under Adam a multiplier of the
        gradient would do nothing): the canonical backbone ramps in after
        ``group_warmup_iters`` and stops at ``stop_update_i2p_iters``, the
        SECC backbone and the decoder train in stage 1, the SR head from
        ``start_update_sr_iters``. The two-stage gates compose."""
        cfg = self.cfg
        start_adv = int(cfg.get("start_adv_iters", 200000))
        stop_i2p = int(cfg.get("stop_update_i2p_iters", 70000))
        group_warm = int(cfg.get("group_warmup_iters", 6000))
        start_sr = int(cfg.get("start_update_sr_iters", 30000))
        two_stage = bool(cfg.get("two_stage_training", True))
        also_dec = bool(cfg.get("also_update_decoder", False))
        in_stage1 = step < start_adv if two_stage else True
        ramp = min(f32(1.0), f32(step) / f32(start_adv + 20000))
        i2p = f32(float(cfg.get("lr_mul_cano_img2plane", 1.0))) * ramp
        return {
            "img2plane_backbone": float(i2p) if (group_warm <= step < stop_i2p and in_stage1)
            else 0.0,
            "secc_img2plane_backbone": 1.0 if in_stage1 else 0.0,
            "decoder": 1.0 if ((in_stage1 or also_dec) and step >= group_warm) else 0.0,
            "superresolution": 1.0 if step >= start_sr else 0.0,
        }

    @staticmethod
    @torch.no_grad()
    def _apply(module, updates: dict, gates: dict) -> None:
        """p += update * gate, in place (each parameter's version moves, so
        caches keyed on it, the decoder's packed copy, are rebuilt)."""
        for name, p in module.named_parameters():
            gate = gates.get(name.split(".", 1)[0], 1.0)
            u = updates[name]
            p.add_(u * gate if gate != 1.0 else u)

    # -- batches ------------------------------------------------------------------

    def _maybe_src2src(self, step: int, batch: dict) -> dict:
        """Every ``update_src2src_interval`` steps the target is the source
        frame itself, for G and D alike."""
        interval = int(self.cfg.get("update_src2src_interval", 16))
        if interval <= 0 or step % interval != 0:
            return batch
        batch = dict(batch)
        batch["tgt_img"] = batch["src_img"]
        batch["secc_cond"] = batch["secc_cond_src"]
        batch["camera"] = batch["camera_src"]
        if "lip_center" in batch and "lip_center_src" in batch:
            batch["lip_center"] = batch["lip_center_src"]
        return batch

    # -- generator losses -------------------------------------------------------------

    def _gen_apply_kwargs(self, batch: dict) -> dict:
        """Per-task forward inputs; the torso task's conditioning."""
        return {}

    def _gen_forward(self, gen, batch: dict, draws) -> dict:
        return gen(batch["src_img"], batch["camera"], secc=batch["secc_cond"], draws=draws,
                   **self._gen_apply_kwargs(batch))

    def _recon_losses(self, out: dict, batch: dict, losses: dict) -> dict:
        cfg = self.cfg
        res = self.neural_rendering_resolution
        tgt = batch["tgt_img"]
        tgt_raw = resize_linear(tgt, res, res)
        losses["mse"] = L.masked_l1(out["image"], tgt, clamp_quantile=0.95)
        losses["mse_raw"] = L.masked_l1(out["image_raw"], tgt_raw, clamp_quantile=0.95)
        losses["percep"] = self.percep_fn(out["image"], tgt)
        if "lip_center" in batch:
            size = int(cfg.get("lip_rect_size", max(tgt.shape[1] // 5, 8)))
            losses["lip_mae"], losses["lip_percep"] = L.lip_crop_losses(
                out["image"], tgt, batch["lip_center"], size, self.percep_fn)
        if "head_mask" in batch:
            mask_raw = resize_nearest(batch["head_mask"].float(), res)
            losses["weights_l1"] = L.weights_mask_match_loss(out["weights_img"], mask_raw)
        losses["weights_entropy"] = L.weights_entropy_loss(out["weights_img"])
        return losses

    def _variant_keys(self, batch: dict) -> list:
        mode = self.cfg.get("secc_pertube_mode", "randn")
        keys = []
        if mode != "none":
            keys += ["__base__", "pertube_secc_1" if "pertube_secc_1" in batch else "__randn__"]
            if mode == "laplacian" and "pertube_secc_2" in batch:
                keys.append("pertube_secc_2")
        if "blink_secc_1" in batch:
            keys += ["blink_secc_1", "blink_secc_2", "blink_secc_3"]
        return keys

    def _cond_losses(self, gen, batch: dict, keys: list, draws) -> tuple:
        """The SECC perturbation and blink regularisers: all variants
        through one batched ``cal_secc_plane``."""
        cfg = self.cfg
        secc = batch["secc_cond"]
        head = secc[..., :-3]

        def variant(key):
            if key == "__base__":
                return secc
            if key == "__randn__":
                scale = float(cfg.get("secc_pertube_randn_scale", 0.01))
                noise = draws.normal(tuple(secc[..., -3:].shape), secc.device) * scale
                return torch.cat([head, secc[..., -3:] + noise], dim=-1)
            return torch.cat([head, batch[key]], dim=-1)

        planes = gen.cal_secc_plane(torch.cat([variant(k) for k in keys], dim=0))
        planes = dict(zip(keys, torch.chunk(planes, len(keys), dim=0)))
        zero = torch.zeros((), device=secc.device)
        pert = blink = zero
        if "__base__" in planes:
            base = planes["__base__"]
            p1 = planes.get("pertube_secc_1", planes.get("__randn__"))
            if "pertube_secc_2" in planes:
                pert = (base - (p1 + planes["pertube_secc_2"]) / 2.0).abs().mean()
            else:
                pert = (base - p1).abs().mean()
        if "blink_secc_1" in planes:
            blink = (planes["blink_secc_2"]
                     - (planes["blink_secc_1"] + planes["blink_secc_3"]) / 2.0).abs().mean()
        return pert, blink

    def _g_loss(self, state: TrainState, batch: dict, draws) -> tuple:
        """(total, losses, generator outputs) of the generator step at
        ``state.step``, differentiable in the generator's parameters."""
        cfg = self.cfg
        step = state.step
        gen = state.gen
        out = self._gen_forward(gen, batch, draws)
        losses: dict = {}
        self._recon_losses(out, batch, losses)
        if "facev2v_losses" in out:
            losses.update(out["facev2v_losses"])
        zero = torch.zeros((), device=self.device)
        if step >= int(cfg.get("start_adv_iters", 200000)):
            fake_logits = state.disc(out["image"], out["image_raw"], batch["camera"])
            losses["adv"] = L.g_nonsaturating_loss(fake_logits)
        else:
            losses["adv"] = zero
        reg_g = int(cfg.get("reg_interval_g", 4))
        if step % reg_g == 0:
            losses["density_reg"] = L.density_regularization(
                lambda pts: gen.sample_points(out["plane"], pts), draws, self.device,
                box_warp=float(cfg.get("box_warp", 1.0)),
                p_dist=float(cfg.get("density_reg_p_dist", 0.004)))
        else:
            losses["density_reg"] = zero
        reg_cond = int(cfg.get("reg_interval_g_cond", 4))
        keys = self._variant_keys(batch)
        if keys:
            if (step + 1) % reg_cond == 0:
                pert, blink = self._cond_losses(gen, batch, keys, draws)
            else:
                pert = blink = zero
            if "__base__" in keys:
                losses["pertube_secc"] = pert
            if "blink_secc_1" in keys:
                losses["pertube_blink_secc"] = blink
        weights = {
            "mse": float(cfg.get("lambda_mse", 1.0)),
            "mse_raw": float(cfg.get("lambda_mse", 1.0)),
            "percep": float(cfg.get("lambda_lpips", 0.5)),
            "weights_l1": float(cfg.get("lambda_weights_l1", 0.1)),
            "weights_entropy": float(cfg.get("lambda_weights_entropy", 0.01)),
            "adv": float(cfg.get("lambda_th1kh_mv_adv", 0.002)),
            "lip_mae": float(cfg.get("lambda_lip_mae", 0.5)),
            "lip_percep": float(cfg.get("lambda_lip_lpips", 0.05)),
            "density_reg": float(cfg.get("lambda_density_reg", 0.25)) * reg_g,
            "facev2v/occlusion_reg_l1": float(cfg.get("lam_occlusion_reg_l1", 0.0)),
            "facev2v/occlusion_2_reg_l1": float(cfg.get("lam_occlusion_2_reg_l1", 0.0)),
            "facev2v/occlusion_2_weights_entropy": float(
                cfg.get("lam_occlusion_weights_entropy", 0.001)),
        }
        total = L.weighted_loss_sum(losses, weights)
        if "pertube_secc" in losses:
            total = total + state.extra["lambda_pertube_secc"] * reg_cond * losses["pertube_secc"]
        if "pertube_blink_secc" in losses:
            total = total + (state.extra["lambda_pertube_blink_secc"] * reg_cond
                             * losses["pertube_blink_secc"])
        return total, losses, out

    # -- discriminator losses -----------------------------------------------------------

    def _d_loss(self, disc, fake_image, fake_raw, batch: dict) -> torch.Tensor:
        tgt, nr = batch["tgt_img"], self.neural_rendering_resolution
        real_raw = resize_linear(tgt, nr, nr)
        real_logits = disc(tgt, real_raw, batch["camera"])
        fake_logits = disc(fake_image, fake_raw, batch["camera"])
        return L.d_logistic_loss(real_logits, fake_logits)

    def _r1(self, disc, batch: dict) -> torch.Tensor:
        tgt, nr = batch["tgt_img"], self.neural_rendering_resolution
        real_raw = resize_linear(tgt, nr, nr)
        return L.r1_penalty(disc, tgt, real_raw, batch["camera"])

    # -- the step -------------------------------------------------------------------------

    @staticmethod
    def grads(loss: torch.Tensor, module) -> dict:
        """d loss / d parameters of ``module`` by name (zeros where unused)."""
        names, params = zip(*module.named_parameters())
        gs = torch.autograd.grad(loss, params, allow_unused=True)
        return {n: torch.zeros_like(p) if g is None else g
                for n, p, g in zip(names, params, gs)}

    def g_grads(self, state: TrainState, batch: dict, draws) -> tuple:
        total, losses, out = self._g_loss(state, batch, draws)
        return total.detach(), {k: v.detach() for k, v in losses.items()}, out, \
            self.grads(total, state.gen)

    def d_grads(self, state: TrainState, fake_image, fake_raw, batch: dict) -> tuple:
        """(D loss, d grads with R1's added at R1 steps, R1 value)."""
        d_total = self._d_loss(state.disc, fake_image, fake_raw, batch)
        d_grads = self.grads(d_total, state.disc)
        reg_d = int(self.cfg.get("reg_interval_d", 16))
        r1_val = torch.zeros((), device=self.device)
        if state.step % reg_d == 0:
            r1 = self._r1(state.disc, batch)
            gp_w = float(self.cfg.get("lambda_gradient_penalty", 5.0)) / 2.0 * reg_d
            r1_grads = self.grads(r1, state.disc)
            d_grads = {n: g + gp_w * r1_grads[n] for n, g in d_grads.items()}
            r1_val = r1.detach()
        return d_total.detach(), d_grads, r1_val

    def apply_gen_update(self, state: TrainState, g_grads: dict) -> None:
        self._apply(state.gen, state.opt_g.updates(g_grads), self._grad_gates(state.step))

    def apply_disc_update(self, state: TrainState, d_grads: dict) -> None:
        self._apply(state.disc, state.opt_d.updates(d_grads), {})

    @torch.no_grad()
    def tune_lambdas(self, state: TrainState, losses: dict) -> None:
        """log10-space proportional control of the perturbation lambdas
        toward their target losses, on cond-reg steps, clamped; a target of
        0 zeroes the lambda. On the device, nothing read back. In a
        multi-process run the two losses are first averaged over the
        processes (the global batch's, as in JAX), so every lambda stays
        the same on every process."""
        cfg = self.cfg
        all_reduce_mean({k: losses[k] for k in ("pertube_secc", "pertube_blink_secc")
                         if k in losses})
        do_cond = (state.step + 1) % int(cfg.get("reg_interval_g_cond", 4)) == 0
        lr_lam = float(cfg.get("lr_lambda_pertube_secc", 0.01))

        def tune(lam, loss_val, target, cap):
            if target == 0.0:
                return torch.zeros_like(lam)
            if not do_cond:
                return lam
            grad = torch.log10(loss_val + 1e-15) - float(np.log10(target + 1e-15))
            return torch.clamp(lam + lr_lam * grad, 0.0, cap)

        if "pertube_secc" in losses:
            state.extra["lambda_pertube_secc"] = tune(
                state.extra["lambda_pertube_secc"], losses["pertube_secc"],
                float(cfg.get("target_pertube_secc_loss", 0.0)), 0.2)
        if "pertube_blink_secc" in losses:
            state.extra["lambda_pertube_blink_secc"] = tune(
                state.extra["lambda_pertube_blink_secc"], losses["pertube_blink_secc"],
                float(cfg.get("target_pertube_blink_secc_loss", 0.3)), 2.0)

    @torch.no_grad()
    def update_ema(self, state: TrainState) -> None:
        if state.gen_ema is None:
            return
        beta = self.ema_beta
        params = dict(state.gen.named_parameters())
        for name, e in state.gen_ema.named_parameters():
            e.copy_(e * beta + params[name] * (1.0 - beta))

    def train_step(self, state: TrainState, batch: dict, draws) -> dict:
        """One G update and one D update of ``state`` in place, on a batch of
        device tensors; returns the step's metrics as device scalars."""
        batch = self._maybe_src2src(state.step, batch)
        g_total, losses, out, g_grads = self.g_grads(state, batch, draws)
        self.apply_gen_update(state, g_grads)
        d_total, d_grads, r1_val = self.d_grads(
            state, out["image"].detach(), out["image_raw"].detach(), batch)
        del out
        self.apply_disc_update(state, d_grads)
        self.tune_lambdas(state, losses)
        metrics = {f"g/{k}": v for k, v in losses.items()}
        metrics.update({f"g/{k}": v for k, v in state.extra.items() if k.startswith("lambda_")})
        metrics.update({"total_loss": g_total, "d/loss": d_total, "d/r1": r1_val,
                        "g/grad_norm": global_norm(g_grads),
                        "d/grad_norm": global_norm(d_grads)})
        self.update_ema(state)
        state.step += 1
        return metrics

    @torch.no_grad()
    def val_step(self, state: TrainState, batch: dict) -> dict:
        out = self._gen_forward(state.gen, batch, None)
        losses: dict = {}
        self._recon_losses(out, batch, losses)
        psnr = -10.0 * torch.log10((out["image"] - batch["tgt_img"]).square().mean() / 4.0
                                   + 1e-10)
        return {"val_loss": losses["mse"], "val_psnr": psnr,
                **{f"val_{k}": v for k, v in losses.items()}}

    # -- validation images ----------------------------------------------------------------

    @torch.no_grad()
    def val_images(self, state: TrainState, batch: dict, draws,
                   max_samples: int | None = None) -> dict:
        """The validation dumps, rendered by the EMA generator: for each of
        the first ``num_valid_plots`` samples a strip ``[ref | mv |
        recon_raw | pred_raw | recon | pred | ref_secc | mv_secc]`` (recon
        driven by the ref frame's own SECC and camera, pred by the mv
        frame's) and a ``[recon | pred]`` depth pair, and the
        :meth:`ood_probe_batch` render. Returns {name: uint8 HxWx3}, the JAX
        task's names; the trainer writes them as PNGs."""
        from real3dportrait_tpu_torch.utils import visualization as viz

        gen = state.gen_ema if state.gen_ema is not None else state.gen
        n = min(int(batch["src_img"].shape[0]),
                max_samples or int(self.cfg.get("num_valid_plots", 4)))
        batch = {k: v[:n] if getattr(v, "ndim", 0) > 0 else v for k, v in batch.items()}
        pred = self._gen_forward(gen, batch, draws)
        recon_b = dict(batch)
        recon_b["secc_cond"] = batch.get("secc_cond_src", batch["secc_cond"])
        recon_b["camera"] = batch.get("camera_src", batch["camera"])
        recon = self._gen_forward(gen, recon_b, draws)
        final = int(batch["tgt_img"].shape[1])

        def host(x):
            return x.float().cpu().numpy()

        def up(x):
            return host(resize_linear(x.float(), final, final))

        ref, mv = host(batch["src_img"]), host(batch["tgt_img"])
        pred_img, recon_img = host(pred["image"]), host(recon["image"])
        pred_raw, recon_raw = up(pred["image_raw"]), up(recon["image_raw"])
        # the cond layout is cano | src | tgt (``pncc_cond_mode: cano_src_tgt``)
        secc = batch["secc_cond"]
        ref_secc = up(secc[..., 3:6] if secc.shape[-1] >= 9 else secc[..., -3:])
        mv_secc = up(secc[..., -3:])
        recon_depth, pred_depth = host(recon["image_depth"]), host(pred["image_depth"])
        images = {}
        for i in range(n):
            images[f"ref_mv_reconraw_predraw_recon_pred_{i:05d}"] = viz.side_by_side(
                ref[i], mv[i], recon_raw[i], pred_raw[i], recon_img[i], pred_img[i],
                ref_secc[i], mv_secc[i])
            images[f"depth_recon_pred_{i:05d}"] = np.concatenate([
                viz.depth_to_colormap(recon_depth[i, ..., 0]),
                viz.depth_to_colormap(pred_depth[i, ..., 0])], axis=1)
        ood = self._gen_forward(gen, self.ood_probe_batch(), draws)
        images["ood_probe"] = viz.to_uint8(host(ood["image"])[0])
        return images

    def ood_probe_batch(self) -> dict:
        """A fixed held-out probe, rendered at every validation so that the
        dumps compare: with ``cfg['ood_image']`` its segmented head crop
        (coefficients fitted from ``cfg['ood_landmarks']`` where given, a
        [K,2] .npy of normalised landmarks), else a seeded synthetic
        identity whose SECC map stands in for the image. Made once."""
        if self._ood_probe is None:
            r = self._secc_renderer()
            dev = self.device
            final = int(self.cfg.get("final_resolution", 512))
            rng = np.random.RandomState(777)
            idc = torch.from_numpy(rng.randn(1, 80).astype(np.float32) * 0.1).to(dev)
            exp = torch.from_numpy(rng.randn(1, 64).astype(np.float32) * 0.1).to(dev)
            src_img = None
            path = str(self.cfg.get("ood_image", "") or "")
            if path and os.path.exists(path):
                import cv2

                from real3dportrait_tpu_torch.preprocess.pipeline import naive_person_segmenter
                from real3dportrait_tpu_torch.preprocess.segment_utils import prepare_source

                img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
                img = cv2.resize(img, (final, final))
                segmap = naive_person_segmenter(img[None])[0]
                head = prepare_source(img, segmap)["head_img"]
                src_img = torch.from_numpy(np.asarray(head, np.float32)).to(dev)[None] \
                    / 127.5 - 1.0
                lm_path = str(self.cfg.get("ood_landmarks", "") or "")
                if lm_path and os.path.exists(lm_path):
                    from real3dportrait_tpu_torch.geometry.fit_3dmm import fit_coeffs

                    lm2d = np.load(lm_path).reshape(1, -1, 2).astype(np.float32)
                    fit = fit_coeffs(r.assets, torch.from_numpy(lm2d), device=dev)
                    idc, exp = fit.id.reshape(1, 80), fit.exp.reshape(1, 64)
            zero3 = torch.zeros((1, 3), device=dev)
            _, cano_secc = r.render(idc, torch.zeros_like(exp), zero3, zero3)
            _, ref_secc = r.render(idc, exp, zero3, zero3)
            if src_img is None:
                src_img = ref_secc
            _, c2w, _ = convert_eg3d_convention(zero3, zero3)
            cam = pack_camera(c2w, fov_to_intrinsics().to(dev)).reshape(1, 25)
            parts = [cano_secc, ref_secc]
            if self.cfg.get("pncc_cond_mode", "cano_src_tgt") == "cano_src_tgt":
                parts.append(ref_secc)
            self._ood_probe = {"src_img": src_img, "tgt_img": src_img,
                               "secc_cond": torch.cat(parts, dim=-1), "camera": cam,
                               "camera_src": cam}
        return self._ood_probe

    # -- record batches -------------------------------------------------------------------

    def _secc_renderer(self):
        """The SECC renderer of record batches on the task's device: the
        z-buffer at ``secc_resolution`` (256^2), resized to
        ``final_resolution``."""
        if self._secc_r is None:
            from real3dportrait_tpu_torch.geometry.bfm import load_or_synthetic_bfm
            from real3dportrait_tpu_torch.geometry.secc_renderer import SECCRenderer

            bfm_dir = self.cfg.get("bfm_dir")
            self._secc_r = SECCRenderer(
                load_or_synthetic_bfm(bfm_dir), bfm_dir,
                rasterize_size=int(self.cfg.get("secc_resolution", 256)),
                output_resolution=int(self.cfg.get("final_resolution", 512)), device=self.device)
        return self._secc_r

    def _to_img(self, x) -> torch.Tensor:
        """[B,H,W,3] uint8 (copied to the device as bytes) or float -> fp32 in
        [-1,1] at ``final_resolution`` (antialiased where that shrinks)."""
        final = int(self.cfg.get("final_resolution", 512))
        x = torch.as_tensor(np.asarray(x)).to(self.device)
        if x.dtype == torch.uint8:
            x = x.float() / 127.5 - 1.0
        if x.shape[1] != final:
            x = resize_linear(x, final, final)
        return x

    def _coeffs(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

    @torch.no_grad()
    def prepare_batch_from_records(self, rec: dict) -> dict:
        """A ``Motion2VideoDataset`` pair batch -> the train step's inputs, on
        the task's device: the cano / src / tgt SECC maps and the perturbed
        ones through K4, the blink-edited triplet (on the host), the lip
        centres and the cameras. Every random draw comes from the task's
        ``RandomState`` (seeded with ``cfg['seed']``) in the JAX task's
        order."""
        from real3dportrait_tpu_torch.geometry.face3d_helper import reconstruct_lm2d
        from real3dportrait_tpu_torch.inference.edit_secc import blink_eye_for_secc

        cfg = self.cfg
        if self._prep_rng is None:
            self._prep_rng = np.random.RandomState(int(cfg.get("seed", 0)))
        rng = self._prep_rng
        r = self._secc_renderer()
        c = self._coeffs
        src_id = c(rec["src_id"])
        zero = torch.zeros_like(c(rec["src_euler"]))
        _, cano = r.render(src_id, torch.zeros_like(c(rec["src_exp"])), zero, zero)
        _, src_secc = r.render(src_id, c(rec["src_exp"]), zero, zero)
        _, tgt_secc = r.render(src_id, c(rec["tgt_exp"]), zero, zero)

        # the perturbed-expression maps of the conditioning regulariser: the
        # neighbour frames' exps (laplacian), else gaussian-noised exps
        extra = {}
        mode = cfg.get("secc_pertube_mode", "randn")
        if mode != "none":
            if mode == "laplacian" and "tgt_pertube_exp_1" in rec:
                p1, p2 = c(rec["tgt_pertube_exp_1"]), c(rec["tgt_pertube_exp_2"])
            else:
                scale = float(cfg.get("secc_pertube_randn_scale", 0.01))
                noise = rng.randn(*np.shape(rec["tgt_exp"])).astype(np.float32)
                p1 = c(rec["tgt_exp"]) + c(noise * scale)
                p2 = 2 * c(rec["tgt_exp"]) - p1
            _, extra["pertube_secc_1"] = r.render(src_id, p1, zero, zero)
            if mode == "laplacian":
                _, extra["pertube_secc_2"] = r.render(src_id, p2, zero, zero)

        # the blink triplet: with probability pertube_ref_prob the src map is
        # edited, else the tgt map; close percents p1 < p2 < p3 over [0,1]
        if bool(cfg.get("use_blink_reg", True)):
            pick_src = rng.rand() < float(cfg.get("pertube_ref_prob", 0.25))
            base = (src_secc if pick_src else tgt_secc).cpu().numpy()
            b = base.shape[0]
            p1s = rng.rand(b) * 0.5
            p3s = 0.5 + rng.rand(b) * 0.5
            p2s = (p1s + p3s) / 2
            for key, ps in (("blink_secc_1", p1s), ("blink_secc_2", p2s),
                            ("blink_secc_3", p3s)):
                extra[key] = torch.from_numpy(np.stack([
                    blink_eye_for_secc(base[i], float(ps[i])) for i in range(b)])).to(
                        self.device)

        final = int(cfg.get("final_resolution", 512))

        def lip_center(exp, euler, trans):
            lm2d = reconstruct_lm2d(r.assets, src_id, c(exp), c(euler), c(trans))
            return L.lip_rect_centers(lm2d * final)

        def cam(euler, trans):
            _, conv, intr = convert_eg3d_convention(c(euler), c(trans))
            return pack_camera(conv, intr[0])

        src_img, tgt_img = self._to_img(rec["src_head_imgs"]), self._to_img(rec["tgt_head_imgs"])
        return {
            "src_img": src_img,
            "tgt_img": tgt_img,
            "secc_cond": torch.cat([cano, src_secc, tgt_secc], dim=-1),
            "secc_cond_src": torch.cat([cano, src_secc, src_secc], dim=-1),
            "camera": cam(rec["tgt_euler"], rec["tgt_trans"]),
            "camera_src": cam(rec["src_euler"], rec["src_trans"]),
            "head_mask": (tgt_img.mean(dim=-1, keepdim=True) > -0.999).float(),
            "lip_center": lip_center(rec["tgt_exp"], rec["tgt_euler"], rec["tgt_trans"]),
            "lip_center_src": lip_center(rec["src_exp"], rec["src_euler"], rec["src_trans"]),
            **extra,
        }

    def _record_batches(self, split: str):
        """Record batches of the store ``<binary_data_dir>/<split>``, or None
        where it has no index."""
        store = os.path.join(str(self.cfg.get("binary_data_dir", "")), split)
        if not os.path.isfile(store + ".idx"):
            return None
        from real3dportrait_tpu_torch.data import Motion2VideoDataset

        ds = Motion2VideoDataset(store, self.cfg, shuffle=(split == "train"),
                                 seed=int(self.cfg.get("seed", 0)))
        return (self.prepare_batch_from_records(rec) for rec in ds.batches())

    def train_data(self):
        real = self._record_batches("train")
        yield from (real if real is not None else super().train_data())

    def val_data(self):
        real = self._record_batches("val")
        yield from (real if real is not None else super().val_data())

    # -- synthetic batches ----------------------------------------------------------------

    def synthetic_batch(self, rng: np.random.RandomState) -> dict:
        """The JAX task's synthetic batch: the same arrays from the same
        ``RandomState`` (cameras to the last ulp of the two frameworks'
        trigonometry)."""
        cfg = self.cfg
        b = int(cfg.get("batch_size", 1))
        final = int(cfg.get("final_resolution", 512))
        secc_size = int(cfg.get("secc_cond_resolution", final))

        def cam():
            yaw = torch.from_numpy(rng.uniform(-0.3, 0.3, (b,)).astype(np.float32))
            pitch = torch.from_numpy(rng.uniform(-0.2, 0.2, (b,)).astype(np.float32))
            c2w = lookat_pose(yaw, pitch, torch.zeros((b, 3)))
            return pack_camera(c2w, fov_to_intrinsics()).numpy()

        secc_ch = 9 if cfg.get("pncc_cond_mode", "cano_src_tgt") == "cano_src_tgt" else 6
        batch = {
            "src_img": rng.uniform(-1, 1, (b, final, final, 3)).astype(np.float32),
            "tgt_img": rng.uniform(-1, 1, (b, final, final, 3)).astype(np.float32),
            "secc_cond": rng.uniform(-1, 1, (b, secc_size, secc_size, secc_ch)).astype(
                np.float32),
            "secc_cond_src": rng.uniform(-1, 1, (b, secc_size, secc_size, secc_ch)).astype(
                np.float32),
            "camera": cam(),
            "camera_src": cam(),
            "head_mask": (rng.rand(b, final, final, 1) > 0.5).astype(np.float32),
            "lip_center": rng.randint(final // 4, 3 * final // 4, (b, 2)).astype(np.int32),
            "lip_center_src": rng.randint(final // 4, 3 * final // 4, (b, 2)).astype(np.int32),
        }
        if bool(cfg.get("use_blink_reg", True)):
            for i in (1, 2, 3):
                batch[f"blink_secc_{i}"] = rng.uniform(
                    -1, 1, (b, secc_size, secc_size, 3)).astype(np.float32)
        return batch


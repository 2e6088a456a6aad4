"""3DMM coefficient fitting by gradient descent on landmark reprojection.

Port of ``real3dportrait_tpu/geometry/fit_3dmm.py``: two phases of Adam
(optax's update, written out here), first the pose alone, then every
coefficient. The loss is the 2D landmark MSE in the normalised image
frame, L2 priors on id and exp, and velocity and Laplacian smoothness over
time when the sequence has more than two frames.

The loop stays on the device: the coefficients are one flat tensor, each
step is autograd through :func:`face3d_helper.reconstruct_lm2d` and a few
tensor ops of Adam, and nothing is read back to the host until the result
is returned. The fit runs on ``device`` (``"cuda"`` unless the caller
asks for another).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from real3dportrait_tpu_torch import entry_device
from real3dportrait_tpu_torch.geometry import face3d_helper
from real3dportrait_tpu_torch.geometry.bfm import BFMAssets

# optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
_SIZES = (("id", 80), ("exp", 64), ("euler", 3), ("trans", 3))


class FitResult(NamedTuple):
    id: torch.Tensor      # [1, 80] (shared across frames)
    exp: torch.Tensor     # [T, 64]
    euler: torch.Tensor   # [T, 3]
    trans: torch.Tensor   # [T, 3]
    loss: torch.Tensor    # scalar loss at the last step's parameters, before its update


def adam_update(param: torch.Tensor, grad: torch.Tensor, mu: torch.Tensor,
                nu: torch.Tensor, step: int, lr: float) -> None:
    """One step of ``optax.adam(lr)`` in place: the moments
    ``(1 - b) * g + b * m``, bias-corrected by step ``step`` (1-based) with
    ``1 - b ** step`` in fp32 as optax computes it, then
    ``m / (sqrt(v) + eps)`` with eps outside the root."""
    mu.mul_(ADAM_B1).add_(grad, alpha=1 - ADAM_B1)
    nu.mul_(ADAM_B2).addcmul_(grad, grad, value=1 - ADAM_B2)
    mu_hat = mu / float(1 - np.float32(ADAM_B1) ** np.float32(step))
    nu_hat = nu / float(1 - np.float32(ADAM_B2) ** np.float32(step))
    param.sub_(mu_hat / (nu_hat.sqrt() + ADAM_EPS) * lr)


def _unpack(flat: torch.Tensor, t: int) -> dict:
    """Views of the flat coefficient vector: id [1,80], exp [T,64],
    euler [T,3], trans [T,3]."""
    out, at = {}, 0
    for name, n in _SIZES:
        rows = 1 if name == "id" else t
        out[name] = flat[at:at + rows * n].view(rows, n)
        at += rows * n
    return out


def fit_coeffs(
    assets: BFMAssets,
    lm2d: torch.Tensor,           # [T, K, 2] normalised [0,1] landmarks
    n_pose_iters: int = 200,
    n_joint_iters: int = 200,
    lr: float = 0.05,
    lambda_reg_id: float = 3e-4,
    lambda_reg_exp: float = 3e-4,
    lambda_vel: float = 1e-2,
    lambda_lap: float = 1e-2,
    device: torch.device | str = "cuda",
) -> FitResult:
    """Fit (id, exp, euler, trans) to 2D landmarks: ``n_pose_iters`` Adam
    steps on euler and trans (id and exp get zero gradients, their moments
    stay zero), then ``n_joint_iters`` on all four, each phase with fresh
    Adam state. Runs on ``device``; the morphable model moves there if it
    lies elsewhere."""
    dev = entry_device(device)
    assets = assets.to(dev)  # tensors already there are not copied
    lm2d = torch.as_tensor(lm2d, dtype=torch.float32).to(dev)
    t = lm2d.shape[0]
    flat = torch.zeros(80 + t * 70, device=dev)
    pose_only = torch.zeros_like(flat)
    pose_only[80 + t * 64:] = 1.0

    def loss_fn(p: dict) -> torch.Tensor:
        pred = face3d_helper.reconstruct_lm2d(assets, p["id"].expand(t, 80), p["exp"],
                                              p["euler"], p["trans"])
        lm_loss = torch.mean(torch.square(pred - lm2d))
        reg = (lambda_reg_id * torch.mean(torch.square(p["id"]))
               + lambda_reg_exp * torch.mean(torch.square(p["exp"])))
        if t <= 2:
            return lm_loss + reg
        smooth = 0.0
        for k in ("exp", "euler", "trans"):
            v = p[k]
            smooth = smooth + lambda_vel * torch.mean(torch.square(v[1:] - v[:-1]))
            smooth = smooth + lambda_lap * torch.mean(
                torch.square(v[:-2] - 2 * v[1:-1] + v[2:]))
        return lm_loss + reg + smooth

    def phase(n_iters: int, mask: torch.Tensor | None) -> torch.Tensor | None:
        mu, nu, loss = torch.zeros_like(flat), torch.zeros_like(flat), None
        for step in range(1, n_iters + 1):
            p = flat.detach().requires_grad_(True)
            loss = loss_fn(_unpack(p, t))
            (grad,) = torch.autograd.grad(loss, p)
            if mask is not None:
                grad = grad * mask
            adam_update(flat, grad, mu, nu, step, lr)
        return loss

    with torch.enable_grad():  # a caller may hold torch.no_grad()
        phase(n_pose_iters, pose_only)
        final_loss = phase(n_joint_iters, None)
    p = _unpack(flat, t)
    return FitResult(p["id"].clone(), p["exp"].clone(), p["euler"].clone(),
                     p["trans"].clone(), final_loss.detach())

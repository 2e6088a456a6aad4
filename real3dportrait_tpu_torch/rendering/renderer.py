"""Two-pass importance-sampled tri-plane / tri-grid volume renderer, with
kernels K2 and K3.

Port of ``real3dportrait_tpu/rendering/renderer.py`` (EG3D's
``ImportanceRenderer``) for tri-planes ``[B,3,H,W,C]`` and tri-grids
``[B,3,D,H,W,C]``. Per frame:

1. ray/box limits; rays that miss the box take the valid population's
   depth range (two reductions over all rays, in PyTorch);
2. stratified coarse depths, sampled and decoded by kernel K1 or, for
   tri-grids, K1-trigrid (``OSGDecoder.decode_points``);
3. kernel K2, :func:`importance_sample`: coarse march + weight smoothing +
   inverse-CDF resampling into the fine depths;
4. the fine depths through K1 or K1-trigrid;
5. kernel K3, :func:`merge_composite`: merge of the sorted coarse and fine
   samples, march and composite; the depth clip to the batch's depth range
   is a reduction over all rays and runs after it, in PyTorch.

Without ``draws`` the render is the deterministic inference path (midpoint
depths, linspace ``u``). A training render passes ``draws``
(``utils/draws.py``): jittered stratified depths and K2's sorted uniform
``u``, the JAX package's two draws, in its order. Gradients reach the
colours and densities of both sample lists through K3's backward
(:func:`merge_composite_backward`) and the tri-grids and decoder through
K1-trigrid's; the depths take none (K2's inputs are detached, as the JAX
package stops them).

Ray context parallelism (JAX's ``shard_map`` over the mesh's ``rays``
axis): :func:`render_rays_sharded` renders this process's contiguous block
of the rays with ``render_rays(..., axis_name="rays", mesh=...)``, whose
only collectives are the two bounds of step 1, and gathers the blocks;
steps 2-5 run on the block alone, the depth clip over the block's depths.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from real3dportrait_tpu_torch import kernels
from real3dportrait_tpu_torch.ops.grid_sample import grid_sample_2d, grid_sample_3d
from real3dportrait_tpu_torch.rendering import math_utils
from real3dportrait_tpu_torch.rendering.ray_marcher import march_rays, march_weights

# world xyz onto the three planes: (x, y | z), (x, z | y), (z, x | y)
_PLANE_PERMS = ((0, 1, 2), (0, 2, 1), (2, 0, 1))
_MAX_SAMPLES = 128  # longest per-ray sample list the K2/K3 kernels take


class RenderOptions(NamedTuple):
    depth_resolution: int = 48
    depth_resolution_importance: int = 48
    box_warp: float = 1.0
    ray_start: float | str = "auto"
    ray_end: float | str = "auto"
    white_back: bool = False
    density_noise: float = 0.0  # std of the normal noise a training render adds to sigma


def sample_from_planes(planes: torch.Tensor, coordinates: torch.Tensor,
                       box_warp: float) -> torch.Tensor:
    """planes [B,3,H,W,C], coords [B,M,3] -> features [B,3,M,C]."""
    coords = (2.0 / box_warp) * coordinates
    outs = [grid_sample_2d(planes[:, k], coords[..., list(perm[:2])])
            for k, perm in enumerate(_PLANE_PERMS)]
    return torch.stack(outs, dim=1)


def sample_from_trigrids(planes: torch.Tensor, coordinates: torch.Tensor,
                         box_warp: float) -> torch.Tensor:
    """planes [B,3,D,H,W,C], coords [B,M,3] -> features [B,3,M,C]; the
    third projected coordinate indexes the depth axis D trilinearly."""
    coords = (2.0 / box_warp) * coordinates
    outs = [grid_sample_3d(planes[:, k], coords[..., list(perm)])
            for k, perm in enumerate(_PLANE_PERMS)]
    return torch.stack(outs, dim=1)


def _stratified_depths(ray_start: torch.Tensor, ray_end: torch.Tensor, n: int,
                       draws=None) -> torch.Tensor:
    """[B,M,1] bounds -> [B,M,n,1] jittered depths (uniform jitter in each
    bin from ``draws``), or the bins' midpoints without ``draws``."""
    depths = math_utils.broadcast_linspace(ray_start, ray_end, n).movedim(0, 2)
    delta = ((ray_end - ray_start) / (n - 1))[:, :, None, :]
    jitter = 0.5 if draws is None else draws.uniform(tuple(depths.shape), depths.device)
    return depths + jitter * delta


def _smooth_weights(weights: torch.Tensor) -> torch.Tensor:
    """max-pool(2, pad -inf) then avg-pool(2) along samples, + 0.01."""
    w = weights[..., 0]
    pad = torch.full_like(w[..., :1], float("-inf"))
    padded = torch.cat([pad, w, pad], dim=-1)
    mx = torch.maximum(padded[..., :-1], padded[..., 1:])
    return (mx[..., :-1] + mx[..., 1:]) / 2.0 + 0.01


def _sample_pdf(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """Inverse-CDF sampling; bins [R,s+2], weights [R,s], u [R,n] -> [R,n]."""
    s = weights.shape[-1]
    weights = weights + eps
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, dim=-1)], dim=-1)
    inds = torch.searchsorted(cdf, u.contiguous(), right=True)  # count of cdf <= u
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(below + 1, max=s)
    cdf_b, cdf_a = cdf.gather(-1, below), cdf.gather(-1, above)
    bins_b, bins_a = bins.gather(-1, below), bins.gather(-1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bins_b + (u - cdf_b) / denom * (bins_a - bins_b)


def importance_u(n_rays: int, n_importance: int, device: torch.device) -> torch.Tensor:
    """[R, n] CDF positions of the deterministic path: linspace(0, 1), one
    row expanded over the rays (a view, ray stride 0)."""
    return torch.linspace(0.0, 1.0, n_importance, device=device).expand(n_rays, n_importance)


def _resample(depths: torch.Tensor, weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Coarse depths [B,M,S,1] and march weights [B,M,S-1,1], u [B*M,n] ->
    fine depths [B,M,n,1]: smoothing, then the inverse CDF over the
    intervals' midpoints."""
    b, m, s, _ = depths.shape
    z = depths.reshape(b * m, s)
    w = _smooth_weights(weights.reshape(b, m, s - 1, 1)).reshape(b * m, s - 1)
    z_mid = (z[:, :-1] + z[:, 1:]) / 2.0
    fine = _sample_pdf(z_mid, w[:, 1:-1], u)
    return fine.reshape(b, m, -1, 1)


def sample_importance(depths: torch.Tensor, weights: torch.Tensor, n_importance: int,
                      draws=None) -> torch.Tensor:
    """Coarse depths [B,M,S,1] + march weights [B,M,S-1,1] -> fine depths
    [B,M,n,1], gradients stopped: the JAX package's weights-in resampler.
    ``u`` is linspace(0, 1) without ``draws``, else sorted uniform draws.
    Plain PyTorch on any device: the render path takes densities through
    K2 (:func:`importance_sample`) and never calls this; the sampling
    study's low-resolution proposals, whose weights are upsampled, do."""
    b, m = depths.shape[:2]
    if draws is None:
        u = importance_u(b * m, n_importance, depths.device)
    else:
        u = torch.sort(draws.uniform((b * m, n_importance), depths.device), dim=-1).values
    return _resample(depths.detach(), weights.detach(), u)


def importance_sample_plain(depths: torch.Tensor, densities: torch.Tensor,
                            u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2: coarse depths/densities [B,M,S,1], u [B*M,n] ->
    fine depths [B,M,n,1] (``march_weights`` + ``sample_importance``)."""
    weights, _, _ = march_weights(densities, depths)
    return _resample(depths, weights, u)


def importance_sample(depths: torch.Tensor, densities: torch.Tensor,
                      u: torch.Tensor) -> torch.Tensor:
    """K2 wrapper, same contract as :func:`importance_sample_plain`.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (fp32, 4 <= S <= 128) or raise. ``u`` is read through its ray stride, so
    the deterministic path's expanded row (stride 0) is never copied.
    """
    if depths.device.type == "cpu":
        return importance_sample_plain(depths, densities, u)
    name = "importance_sample"
    b, m, s, _ = depths.shape
    n = u.shape[-1]
    depths, densities = depths.contiguous(), densities.contiguous()
    if n > 1 and u.stride(-1) != 1:
        u = u.contiguous()
    for arg, t in (("depths", depths), ("densities", densities)):
        kernels.require(name, arg, t)
    if not u.is_cuda or u.dtype != torch.float32 or densities.shape != depths.shape \
            or u.shape != (b * m, n) or not 4 <= s <= _MAX_SAMPLES:
        raise ValueError(f"{name}: bad arguments depths {tuple(depths.shape)} densities "
                         f"{tuple(densities.shape)} u {tuple(u.shape)} {u.dtype} {u.device}")
    fine = torch.empty((b, m, n, 1), device=depths.device)
    kernels.launch("r3dp_importance_sample", depths, densities, u, u.stride(0), b * m, s, n,
                   fine)
    importance_sample.launches += 1
    return fine


importance_sample.launches = 0


def merge_composite_plain(depths1, colors1, densities1, depths2, colors2, densities2,
                          white_back: bool = False):
    """Plain PyTorch K3: two per-ray sorted sample sets ([B,M,S_i,1] depths
    and densities, [B,M,S_i,C] colours) -> (rgb [B,M,C] in [-1,1],
    unclipped depth [B,M,1], weights [B,M,S-1,1]).

    A stable sort of the concatenation puts a coarse sample before an equal
    fine one."""
    all_d = torch.cat([depths1, depths2], dim=-2)
    order = torch.sort(all_d, dim=-2, stable=True).indices
    md = all_d.gather(-2, order)
    msig = torch.cat([densities1, densities2], dim=-2).gather(-2, order)
    colors = torch.cat([colors1, colors2], dim=-2)
    mcol = colors.gather(-2, order.expand(-1, -1, -1, colors.shape[-1]))
    weights, w_c, depths_mid = march_weights(msig, md)
    rgb = torch.einsum("bms,bmsc->bmc", w_c, mcol)
    weight_total = weights.sum(dim=-2)
    depth = (weights * depths_mid).sum(dim=-2) / weight_total
    if white_back:
        rgb = rgb + 1.0 - weight_total
    return rgb * 2.0 - 1.0, depth, weights


def merge_composite_backward_plain(depths1, colors1, densities1, depths2, colors2,
                                   densities2, white_back: bool = False, drgb=None,
                                   ddepth=None, dweights=None):
    """Plain PyTorch K3 backward: the inputs of :func:`merge_composite_plain`
    and the gradients of its (rgb, unclipped depth, weights), each None for
    zero -> (d colours1, d densities1, d colours2, d densities2), written
    out (no autograd); depths take no gradient."""
    b, m, s1, c = colors1.shape
    s = s1 + colors2.shape[2]
    all_d = torch.cat([depths1, depths2], dim=-2)[..., 0]
    order = torch.sort(all_d, dim=-1, stable=True).indices          # merged -> concat
    md = all_d.gather(-1, order)
    msig = torch.cat([densities1, densities2], dim=-2)[..., 0].gather(-1, order)
    colors = torch.cat([colors1, colors2], dim=-2)
    delta = md[..., 1:] - md[..., :-1]
    u = (msig[..., :-1] + msig[..., 1:]) / 2 - 1.0
    dens = F.softplus(u)
    alpha = 1.0 - torch.exp(-(dens * delta))
    keep = 1.0 - alpha + 1e-10
    trans = torch.cumprod(torch.cat([torch.ones_like(keep[..., :1]), keep], -1), -1)[..., :-1]
    w = alpha * trans
    zero = torch.zeros_like(w[..., :1])
    wc = (torch.cat([zero, w], -1) + torch.cat([w, zero], -1)) / 2.0   # merged order
    g2 = 2.0 * drgb if drgb is not None else torch.zeros((b, m, c), device=colors1.device)
    inv = torch.argsort(order, dim=-1)                                 # concat -> merged
    dcolors = wc.gather(-1, inv)[..., None] * g2[:, :, None, :]
    e = torch.einsum("bmsc,bmc->bms", colors, g2).gather(-1, order)   # merged order
    dw = (e[..., :-1] + e[..., 1:]) / 2.0
    if dweights is not None:
        dw = dw + dweights[..., 0]
    if ddepth is not None:
        total = w.sum(-1, keepdim=True)
        mid = (md[..., :-1] + md[..., 1:]) / 2
        depth = (w * mid).sum(-1, keepdim=True) / total
        dw = dw + ddepth * (mid - depth) / total
    if white_back:
        dw = dw - g2.sum(-1, keepdim=True)
    # reverse scan of the transmittance's adjoint
    rk = torch.zeros_like(dw[..., 0])
    dalpha = torch.empty_like(dw)
    for k in range(s - 2, -1, -1):
        dalpha[..., k] = trans[..., k] * (dw[..., k] - rk)
        rk = dw[..., k] * alpha[..., k] + keep[..., k] * rk
    du = dalpha * torch.exp(-(dens * delta)) * delta * torch.sigmoid(u)
    dz = torch.zeros_like(du[..., :1])
    dsig = (torch.cat([dz, du], -1) + torch.cat([du, dz], -1)) / 2.0
    dsig = dsig.gather(-1, inv)[..., None]
    return dcolors[:, :, :s1], dsig[:, :, :s1], dcolors[:, :, s1:], dsig[:, :, s1:]


def merge_composite_backward(depths1, colors1, densities1, depths2, colors2, densities2,
                             white_back: bool = False, drgb=None, ddepth=None,
                             dweights=None):
    """K3 backward wrapper, same contract as
    :func:`merge_composite_backward_plain`. CPU tensors take the plain
    version; CUDA tensors launch the kernel (fp32, S1 + S2 <= 128) or raise.
    ``merge_composite_backward.launches`` counts its launches."""
    if depths1.device.type == "cpu":
        return merge_composite_backward_plain(depths1, colors1, densities1, depths2, colors2,
                                              densities2, white_back, drgb, ddepth, dweights)
    name = "merge_composite_backward"
    d1, c1, sg1, d2, c2, sg2 = _merge_args(name, depths1, colors1, densities1, depths2,
                                           colors2, densities2)
    b, m, s1, c = c1.shape
    s2 = c2.shape[2]
    grads = []
    for arg, t, shape in (("drgb", drgb, (b, m, c)), ("ddepth", ddepth, (b, m, 1)),
                          ("dweights", dweights, (b, m, s1 + s2 - 1, 1))):
        if t is not None:
            t = t.contiguous()
            kernels.require(name, arg, t)
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: {arg} must be {shape}, got {tuple(t.shape)}")
        grads.append(t)
    dc1, ds1, dc2, ds2 = (torch.empty_like(t) for t in (c1, sg1, c2, sg2))
    kernels.launch("r3dp_merge_composite_backward", d1, c1, sg1, s1, d2, c2, sg2, s2, b * m, c,
                   int(white_back), *grads, dc1, ds1, dc2, ds2)
    merge_composite_backward.launches += 1
    return dc1, ds1, dc2, ds2


merge_composite_backward.launches = 0


def _merge_args(name, *tensors):
    """The six K3 inputs, contiguous, checked."""
    args = [t.contiguous() for t in tensors]
    for arg, t in zip(("depths1", "colors1", "densities1", "depths2", "colors2",
                       "densities2"), args):
        kernels.require(name, arg, t)
    d1, c1, sg1, d2, c2, sg2 = args
    b, m, s1, c = c1.shape
    s2 = c2.shape[2]
    if d1.shape != (b, m, s1, 1) or sg1.shape != d1.shape or d2.shape != (b, m, s2, 1) \
            or sg2.shape != d2.shape or c2.shape != (b, m, s2, c) \
            or s1 + s2 > _MAX_SAMPLES:
        raise ValueError(f"{name}: bad shapes {[tuple(t.shape) for t in args]}")
    return args


class _MergeComposite(torch.autograd.Function):
    """K3 with its backward kernel; depths take no gradient."""

    @staticmethod
    def forward(ctx, d1, c1, sg1, d2, c2, sg2, white_back):
        ctx.save_for_backward(d1, c1, sg1, d2, c2, sg2)
        ctx.white_back = white_back
        b, m, s1, c = c1.shape
        s2 = c2.shape[2]
        s = s1 + s2
        rgb = torch.empty((b, m, c), device=d1.device)
        depth = torch.empty((b, m, 1), device=d1.device)
        weights = torch.empty((b, m, s - 1, 1), device=d1.device)
        kernels.launch("r3dp_merge_composite", d1, c1, sg1, s1, d2, c2, sg2, s2, b * m, c,
                       int(white_back), rgb, depth, weights)
        merge_composite.launches += 1
        return rgb, depth, weights

    @staticmethod
    def backward(ctx, drgb, ddepth, dweights):
        dc1, ds1, dc2, ds2 = merge_composite_backward(*ctx.saved_tensors, ctx.white_back,
                                                      drgb, ddepth, dweights)
        return None, dc1, ds1, None, dc2, ds2, None


def merge_composite(depths1, colors1, densities1, depths2, colors2, densities2,
                    white_back: bool = False):
    """K3 wrapper, same contract as :func:`merge_composite_plain`.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (fp32, S1 + S2 <= 128) or raise. The call is a
    ``torch.autograd.Function`` whose backward is
    :func:`merge_composite_backward`; depths that need a gradient raise.
    """
    if depths1.device.type == "cpu":
        return merge_composite_plain(depths1, colors1, densities1, depths2, colors2,
                                     densities2, white_back)
    name = "merge_composite"
    args = _merge_args(name, depths1, colors1, densities1, depths2, colors2, densities2)
    if torch.is_grad_enabled() and (args[0].requires_grad or args[3].requires_grad):
        raise ValueError(f"{name}: depths that need a gradient are not supported")
    return _MergeComposite.apply(*args, white_back)


merge_composite.launches = 0


def render_rays(planes: torch.Tensor, decoder, ray_origins: torch.Tensor,
                ray_directions: torch.Tensor, options: RenderOptions,
                draws=None, axis_name: str | None = None, mesh=None) -> dict[str, Any]:
    """Full two-pass render of tri-planes [B,3,H,W,C] or tri-grids
    [B,3,D,H,W,C] along rays [B,M,3].

    ``decoder`` is an ``OSGDecoder`` (its ``decode_points`` is kernel K1 or
    K1-trigrid, by the planes' rank). ``draws`` (``utils/draws.Draws``)
    makes the training render's jittered depths and K2's random ``u``, and
    with ``options.density_noise > 0`` the normal noise (times it) added to
    each pass's densities between the decode and the march, as the JAX
    package draws it.
    Returns ``rgb`` [B,M,C], ``depth``
    [B,M,1], ``weights_sum`` [B,M,1], ``is_ray_valid`` [B,M].

    ``axis_name``: JAX's, set where the rays are this process's block of a
    render split over that axis of ``mesh`` (``parallel.mesh.Mesh``; what
    ``shard_map``'s context gives JAX; ``render_rays_sharded``). Every ray
    is rendered alone but for the fallback bounds of rays that miss the
    box, whose min / max then run over the axis's processes, as JAX's
    ``pmin`` / ``pmax``; the composite depth's clamp stays this block's
    own, as in JAX. An axis name without a mesh raises.
    """
    if axis_name is not None and mesh is None:
        raise ValueError(f"render_rays: axis_name {axis_name!r} needs the mesh it names")
    b, m, _ = ray_origins.shape
    if options.ray_start == "auto" or options.ray_end == "auto":
        ray_start, ray_end, is_valid = math_utils.get_ray_limits_box(
            ray_origins, ray_directions, options.box_warp)
        valid = is_valid[..., None]
        start_min = torch.where(valid, ray_start, torch.full_like(ray_start, 1e10)).min()
        start_max = torch.where(valid, ray_start, torch.full_like(ray_start, -1e10)).max()
        if axis_name is not None:
            start_min = mesh.all_reduce(start_min, dist.ReduceOp.MIN, axis_name)
            start_max = mesh.all_reduce(start_max, dist.ReduceOp.MAX, axis_name)
        ray_start = torch.where(valid, ray_start, start_min)
        ray_end = torch.where(valid, ray_end, start_max)
    else:
        ray_start = torch.full((b, m, 1), float(options.ray_start), device=planes.device)
        ray_end = torch.full((b, m, 1), float(options.ray_end), device=planes.device)
        is_valid = torch.ones((b, m), dtype=torch.bool, device=planes.device)

    def eval_at(depths: torch.Tensor):
        n_s = depths.shape[2]
        coords = (ray_origins[:, :, None, :] + depths * ray_directions[:, :, None, :])
        rgb, sigma = decoder.decode_points(planes, coords.reshape(b, -1, 3),
                                           options.box_warp)
        if options.density_noise > 0 and draws is not None:
            sigma = sigma + draws.normal(tuple(sigma.shape), sigma.device) \
                * options.density_noise
        return rgb.reshape(b, m, n_s, -1), sigma.reshape(b, m, n_s, 1)

    depths_coarse = _stratified_depths(ray_start, ray_end, options.depth_resolution, draws)
    colors_coarse, densities_coarse = eval_at(depths_coarse)

    n_imp = options.depth_resolution_importance
    if n_imp > 0:
        if draws is None:
            u = importance_u(b * m, n_imp, planes.device)
        else:
            # sorted, as the JAX package sorts them: the fine depths come out sorted
            u = torch.sort(draws.uniform((b * m, n_imp), planes.device), dim=-1).values
        depths_fine = importance_sample(depths_coarse, densities_coarse.detach(), u)
        colors_fine, densities_fine = eval_at(depths_fine)
        rgb, depth, weights = merge_composite(
            depths_coarse, colors_coarse, densities_coarse,
            depths_fine, colors_fine, densities_fine, options.white_back)
        lo = torch.minimum(depths_coarse.min(), depths_fine.min())
        hi = torch.maximum(depths_coarse.max(), depths_fine.max())
        depth = torch.clamp(torch.nan_to_num(depth, nan=float("inf")), lo, hi)
    else:
        rgb, depth, weights = march_rays(colors_coarse, densities_coarse, depths_coarse,
                                         options.white_back)
    return {"rgb": rgb, "depth": depth, "weights_sum": weights.sum(dim=-2),
            "is_ray_valid": is_valid}


def render_rays_sharded(planes: torch.Tensor, decoder, ray_origins: torch.Tensor,
                        ray_directions: torch.Tensor, options: RenderOptions,
                        mesh) -> dict[str, Any]:
    """The port's ``shard_map`` of the render over the ``rays`` axis of
    ``mesh``: the rays [B,M,3] cut into contiguous blocks of M along the
    axis (JAX's ``P(None, "rays", None)``; M must divide by the axis size,
    as ``shard_map`` requires), this process's block rendered by
    ``render_rays(..., axis_name="rays")`` with the planes and decoder
    replicated, and ``rgb``, ``depth``, ``weights_sum`` and
    ``is_ray_valid`` gathered back to [B,M,...] on every process of the
    axis, as JAX's ``out_specs`` reassemble the global arrays."""
    m = ray_origins.shape[1]
    n, i = mesh.size("rays"), mesh.coord("rays")
    if m % n:
        raise ValueError(f"render_rays_sharded: {m} rays do not divide over {n} processes "
                         "of axis 'rays'")
    block = slice(i * (m // n), (i + 1) * (m // n))
    out = render_rays(planes, decoder, ray_origins[:, block].contiguous(),
                      ray_directions[:, block].contiguous(), options, axis_name="rays",
                      mesh=mesh)
    gathered = {k: mesh.all_gather(out[k], "rays", dim=1)
                for k in ("rgb", "depth", "weights_sum")}
    # bool is gathered as bytes (not every backend reduces or gathers bool)
    gathered["is_ray_valid"] = mesh.all_gather(out["is_ray_valid"].to(torch.uint8), "rays",
                                               dim=1).bool()
    return gathered

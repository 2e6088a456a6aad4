"""K3's backward on the CPU: the port's plain version
(``rendering/renderer.py:merge_composite_backward_plain``, which the CUDA
kernel is held to on the card) against ``jax.vjp`` of the JAX package's
``_march_merged``, and the kernel's reverse recurrence
(``csrc/render_march.cu`` ``merge_composite_backward_kernel``: a warp suffix
scan of affine maps, run from the last chunk of 32 intervals to the first
with the carry between them) emulated lane by lane and held to the plain
version's serial loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real3dportrait_tpu.rendering.renderer import _march_merged
from real3dportrait_tpu_torch.rendering.renderer import (
    merge_composite_backward,
    merge_composite_backward_plain,
    merge_composite_plain,
)
from tests._torch_parity import agree, t

torch.set_num_threads(1)


def _tied_inputs(rng, r, s1, s2, c):
    """Sorted coarse depths in [2, 3.3], sorted fine depths of which every
    third ties a coarse depth of the same ray, N(0, 3) densities, colours
    uniform in [0, 1)."""
    d1 = np.sort(rng.uniform(2.0, 3.3, (1, r, s1)), axis=-1).astype(np.float32)
    d2 = rng.uniform(2.0, 3.3, (1, r, s2)).astype(np.float32)
    pick = rng.randint(0, s1, (1, r, s2))
    d2[..., ::3] = np.take_along_axis(d1, pick, axis=-1)[..., ::3]
    d2 = np.sort(d2, axis=-1)
    c1 = rng.uniform(0, 1, (1, r, s1, c)).astype(np.float32)
    c2 = rng.uniform(0, 1, (1, r, s2, c)).astype(np.float32)
    sg1 = (rng.randn(1, r, s1, 1) * 3).astype(np.float32)
    sg2 = (rng.randn(1, r, s2, 1) * 3).astype(np.float32)
    return d1[..., None], c1, sg1, d2[..., None], c2, sg2


def _against_vjp(s1, s2, white, terms, seed):
    r, c = 96, 32
    rng = np.random.RandomState(seed)
    args = _tied_inputs(rng, r, s1, s2, c)
    ties = (args[3][..., 0][..., :, None] == args[0][..., 0][..., None, :]).any(-1)
    assert ties.any(-1).all(), "every ray has a fine depth equal to a coarse one"
    cots = {"rgb": rng.randn(1, r, c), "depth": rng.randn(1, r, 1),
            "weights": rng.randn(1, r, s1 + s2 - 1, 1)}
    cots = {k: (v if k in terms else np.zeros_like(v)).astype(np.float32)
            for k, v in cots.items()}
    d1, c1, sg1, d2, c2, sg2 = args

    def f(c1_, sg1_, c2_, sg2_):
        return _march_merged(jnp.asarray(d1), c1_, sg1_, jnp.asarray(d2), c2_, sg2_, white)
    _, vjp = jax.vjp(f, *map(jnp.asarray, (c1, sg1, c2, sg2)))
    want = vjp(tuple(jnp.asarray(cots[k]) for k in ("rgb", "depth", "weights")))
    # JAX clips the depth to the batch's depth range inside; the port clips
    # after the kernel, so its depth gradient is JAX's where the clip is
    # inactive and zero where it is active
    _, depth, _ = merge_composite_plain(*map(t, args), white)
    lo, hi = min(d1.min(), d2.min()), max(d1.max(), d2.max())
    inside = ((depth > lo) & (depth < hi)).float()
    assert inside.sum() > 0
    got = merge_composite_backward_plain(*map(t, args), white, t(cots["rgb"]),
                                         t(cots["depth"]) * inside, t(cots["weights"]))
    return got, want


@pytest.mark.parametrize("white", [False, True], ids=["black", "white_back"])
@pytest.mark.parametrize("s1,s2", [(16, 32), (48, 48)])
def test_k3_backward_plain_matches_jax_vjp(s1, s2, white):
    # gradients of rgb, depth and weights at once, ties between the lists:
    # the transmittance's adjoint runs as a reverse loop here and through
    # the log-space cumprod matmul's VJP in JAX, the colour sums in another
    # order: fp32 rounding of ~100-term sums and products (6.4e-7 of scale
    # max, 1.8e-8 mean measured), held to 5e-6 max, 2e-7 mean
    got, want = _against_vjp(s1, s2, white, ("rgb", "depth", "weights"), seed=11)
    for g, w, name in zip(got, want, ("colours1", "densities1", "colours2", "densities2")):
        agree(g, w, 5e-6, 2e-7, f"d {name}")


@pytest.mark.parametrize("term", ["rgb", "depth", "weights"])
def test_k3_backward_each_term_matches_jax_vjp(term):
    # each output's gradient alone, so that no term hides behind a larger
    # one; tolerances as above
    got, want = _against_vjp(48, 48, False, (term,), seed=12)
    for g, w, name in zip(got, want, ("colours1", "densities1", "colours2", "densities2")):
        if term == "depth" and name.startswith("colours"):
            assert float(g.abs().max()) == 0.0 and float(np.abs(np.asarray(w)).max()) == 0.0
            continue
        agree(g, w, 5e-6, 2e-7, f"d {name} ({term})")


def _shfl_down(v: np.ndarray, off: int) -> np.ndarray:
    """__shfl_down_sync over a warp: lane l reads lane l + off, or its own
    value where l + off is past the warp."""
    lane = np.arange(32)
    return np.where(lane + off < 32, v[np.minimum(lane + off, 31)], v)


def _kernel_reverse_scan(dw, alpha, trans):
    """d alpha as the kernel computes it for one ray (float32): lane k of a
    chunk holds the map r -> dw[k] alpha[k] + (1 - alpha[k] + 1e-10) r
    (the identity past the last interval), a Hillis-Steele suffix scan
    composes lanes k..31, R[k - 1] is that composite applied to the carry
    R[base + 31], R[k] comes from lane k + 1 (lane 31: the carry), and lane
    0's R[base - 1] is the next chunk's carry."""
    f32 = np.float32
    n = len(dw)
    lane = np.arange(32)
    dalpha = np.zeros(n, f32)
    carry = f32(0.0)
    for q in reversed(range((n + 31) // 32)):
        k = q * 32 + lane
        on = k < n
        kk = np.minimum(k, n - 1)
        a = np.where(on, f32(1.0) - alpha[kk] + f32(1e-10), f32(1.0)).astype(f32)
        b = np.where(on, dw[kk] * alpha[kk], f32(0.0)).astype(f32)
        off = 1
        while off < 32:
            a2, b2 = _shfl_down(a, off), _shfl_down(b, off)
            live = lane + off < 32
            b = np.where(live, a * b2 + b, b).astype(f32)
            a = np.where(live, a * a2, a).astype(f32)
            off *= 2
        rprev = (a * carry + b).astype(f32)
        rk = np.where(lane == 31, carry, _shfl_down(rprev, 1)).astype(f32)
        carry = rprev[0]
        dalpha[k[on]] = (trans[kk] * (dw[kk] - rk))[on]
    return dalpha


@pytest.mark.parametrize("n", [1, 31, 32, 33, 95, 127])
def test_k3_backward_reverse_scan_matches_serial_loop(n):
    # the plain version's loop (renderer.py merge_composite_backward_plain)
    # in float64 against the kernel's scan in float32: the same sums
    # associated differently, 1e-5 of the largest |d alpha|
    rng = np.random.RandomState(n)
    alpha = np.where(rng.rand(n) < 0.2, 1.0 - rng.rand(n) * 1e-6, rng.rand(n)).astype(np.float32)
    trans = np.cumprod(np.concatenate([[1.0], 1.0 - alpha[:-1] + 1e-10])).astype(np.float32)
    dw = rng.randn(n).astype(np.float32)
    want = np.zeros(n)
    rk = 0.0
    for k in range(n - 1, -1, -1):
        want[k] = float(trans[k]) * (float(dw[k]) - rk)
        rk = float(dw[k]) * float(alpha[k]) + (1.0 - float(alpha[k]) + 1e-10) * rk
    got = _kernel_reverse_scan(dw, alpha, trans)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= 1e-5 * scale


def test_k3_backward_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.RandomState(13)
    args = [t(a) for a in _tied_inputs(rng, 7, 5, 9, 12)]
    grads = (t(rng.randn(1, 7, 12).astype(np.float32)), None,
             t(rng.randn(1, 7, 13, 1).astype(np.float32)))
    got = merge_composite_backward(*args, True, *grads)
    want = merge_composite_backward_plain(*args, True, *grads)
    for g, w in zip(got, want):
        assert torch.equal(g, w)

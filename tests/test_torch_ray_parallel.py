"""The mesh's ``rays`` axis in the port (``parallel/mesh.py``,
``rendering/renderer.py:render_rays(axis_name=...)`` and
``render_rays_sharded``) against the JAX package on the CPU: the mesh's
shapes, coordinates and errors against JAX's ``make_mesh``; a one-process
``{"rays": -1}`` render bit-equal to the plain call; two processes over
gloo on localhost (tests/_torch_ddp_worker.py) rendering tiny tri-planes
and tri-grids, some of whose rays miss the box and some of whose weights
are all 0, held to JAX's ``shard_map`` render over 2 of the 8 virtual CPU
devices and to its unsharded render; the batch cut of a ``data`` x
``rays`` mesh (patched ranks, no processes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from real3dportrait_tpu.models.decoder import OSGDecoder as JaxOSGDecoder
from real3dportrait_tpu.parallel import make_mesh as jax_make_mesh
from real3dportrait_tpu.parallel import shard_batch as jax_shard_batch
from real3dportrait_tpu.rendering.renderer import (
    RenderOptions as JaxRenderOptions,
    render_rays as jax_render_rays,
)
from real3dportrait_tpu_torch.geometry.camera import (
    fov_to_intrinsics,
    lookat_pose,
    pack_camera,
    unpack_camera,
)
from real3dportrait_tpu_torch.models.decoder import OSGDecoder
from real3dportrait_tpu_torch.parallel import distributed
from real3dportrait_tpu_torch.parallel import mesh as pmesh
from real3dportrait_tpu_torch.parallel import (
    make_mesh,
    process_local_batch_slice,
    shard_batch,
    shard_global_batch,
)
from real3dportrait_tpu_torch.rendering.ray_sampler import sample_rays
from real3dportrait_tpu_torch.rendering.renderer import (
    RenderOptions,
    render_rays,
    render_rays_sharded,
)
from tests._torch_launch import _launch, _world
from tests._torch_parity import load_from_jax, t, to_np

torch.set_num_threads(1)

# 8 x 8 rays at a 40-degree field of view (27 miss the box), 4 + 4 samples
RES, FOV, OPTS = 8, 40.0, dict(depth_resolution=4, depth_resolution_importance=4)
KEYS = ("rgb", "depth", "weights_sum", "is_ray_valid")


def _set_patched_world(monkeypatch, world: int, r: int) -> None:
    for mod in (distributed, pmesh):
        monkeypatch.setattr(mod, "world_size", lambda: world, raising=False)
        monkeypatch.setattr(mod, "rank", lambda: r)


# -- the mesh ----------------------------------------------------------------------------

MESHES = [({"data": -1}, 8), ({"data": -1, "rays": 2}, 8), ({"rays": -1}, 2),
          ({"rays": 2, "data": -1}, 8), ({"data": 2, "rays": 4}, 8), ({"data": -1}, 1),
          ({"data": -1, "rays": 1}, 4)]
BAD_MESHES = [({"data": -1, "rays": 2}, 1), ({"data": 3, "rays": -1}, 8),
              ({"data": 4, "rays": 4}, 8), ({"data": 2}, 4), ({"rays": -1, "data": -1}, 4)]


@pytest.mark.parametrize("shape,world", MESHES)
def test_make_mesh_shapes_and_coordinates_match_jax(monkeypatch, shape, world):
    jm = jax_make_mesh(shape, devices=jax.devices()[:world])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r in range(world):
        _set_patched_world(monkeypatch, world, r)
        m = make_mesh(shape)
        assert dict(m.shape) == dict(jm.shape) and list(m.shape) == list(jm.axis_names)
        want = {k: int(c) for k, c in zip(jm.axis_names, np.argwhere(ids == r)[0])}
        assert m.coords == want, (r, m.coords, want)
        assert m.groups is None     # outside a process group no group is built
        assert all(m.coord(k) == v for k, v in want.items()) and m.coord("other") == 0
        # a line of one process needs no group; a longer line's collective
        # raises without one, rather than being the identity
        for k, n in m.shape.items():
            if n == 1:
                assert m.group(k) is None
            else:
                with pytest.raises(ValueError, match="no process groups"):
                    m.all_reduce(torch.zeros(()), dist.ReduceOp.MIN, k)
        with pytest.raises(ValueError, match="no axis"):
            m.group("other")


@pytest.mark.parametrize("shape,world", BAD_MESHES)
def test_make_mesh_raises_where_jax_asserts(monkeypatch, shape, world):
    with pytest.raises(AssertionError):
        jax_make_mesh(shape, devices=jax.devices()[:world])
    _set_patched_world(monkeypatch, world, 0)
    with pytest.raises(ValueError):
        make_mesh(shape)


# -- the render's inputs -----------------------------------------------------------------


def _rays():
    # pitched, so that the two blocks (the upper and lower 4 rows) reach
    # different depths and clip their zero-weight rays apart
    c2w = lookat_pose(torch.full((1,), 0.2), torch.full((1,), 0.1),
                      torch.tensor([[0.0, 0.0, 0.2]]))
    c2w, intr = unpack_camera(pack_camera(c2w, fov_to_intrinsics(FOV)))
    return sample_rays(c2w, intr, RES)


def _case(kind: str, seed: int) -> dict:
    """Seeded planes (tri-planes [1,3,64,64,8] or tri-grids of depth 8) and
    a JAX decoder whose density reads feature 0 alone, through hidden unit
    0: 2 +- 0.1 inside the box, a density of 22-64; two thirds of that
    where one plane's sample falls outside it (zero padding), about -2; a
    third or less (two or three planes outside), -25 or below, whose alpha
    is exactly 0. Rays whose samples all take the latter sum weights of 0,
    and their depth takes the block's bound; the others composite. Fine
    planes keep the padding's fade, where the density passes the values
    whose alpha rounds to a few ulps, thin."""
    rng = np.random.RandomState(seed)
    shape = (1, 3, 64, 64, 8) if kind == "triplane" else (1, 3, 8, 64, 64, 8)
    planes = rng.randn(*shape).astype(np.float32)
    planes[..., 0] = 2.0 + 0.1 * planes[..., 0]
    jdec = JaxOSGDecoder(hidden_dim=64, output_dim=32)
    variables = jax.tree_util.tree_map(np.array, jdec.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 3, 4, 8))))
    net0, net1 = variables["params"]["net0"], variables["params"]["net1"]
    # (equalised learning rate: the layers scale their weights by
    # 1/sqrt(fan_in), 1/sqrt(8) and 1/8)
    net0["weight"][:, 0] = 0.0
    net0["weight"][0, 0] = 8.0 * np.sqrt(8.0)
    net0["bias"][0] = -8.0
    net1["weight"][:, 0] = 0.0
    net1["weight"][0, 0] = 8.6 * 8.0
    net1["bias"][0] = -25.6
    o, d = _rays()
    return dict(kind=kind, planes=planes, jdec=jdec, variables=variables,
                dec=load_from_jax(OSGDecoder(8, 64, 32), variables), origins=o, dirs=d)


CASES = {"triplane": _case("triplane", 1), "trigrid": _case("trigrid", 2)}


def _jax_render(case: dict, sharded: bool) -> dict:
    dec = lambda f, _d: case["jdec"].apply(case["variables"], f)  # noqa: E731
    opts = JaxRenderOptions(**OPTS)

    def render(planes, o, d):
        out = jax_render_rays(planes, dec, o, d, opts, axis_name="rays" if sharded else None)
        return tuple(out[k] for k in KEYS)

    args = (jnp.asarray(case["planes"]), jnp.asarray(to_np(case["origins"])),
            jnp.asarray(to_np(case["dirs"])))
    if sharded:
        rays = P(None, "rays", None)
        render = shard_map(render, mesh=jax_make_mesh({"rays": 2}, devices=jax.devices()[:2]),
                           in_specs=(P(), rays, rays), out_specs=(rays, rays, rays,
                                                                   P(None, "rays")),
                           check_rep=False)
    return dict(zip(KEYS, (np.asarray(x) for x in jax.jit(render)(*args))))


@pytest.mark.parametrize("kind", sorted(CASES))
def test_one_process_rays_mesh_renders_bit_equal_to_the_plain_call(kind):
    case = CASES[kind]
    m = make_mesh({"rays": -1})
    assert m.shape == {"rays": 1} and m.groups is None
    args = (t(case["planes"]), case["dec"], case["origins"], case["dirs"], RenderOptions(**OPTS))
    with torch.no_grad():
        want = render_rays(*args)
        got = render_rays_sharded(*args, m)
        named = render_rays(*args, axis_name="rays", mesh=m)
    for k in KEYS:
        assert torch.equal(got[k], want[k]) and torch.equal(named[k], want[k]), k
    with pytest.raises(ValueError, match="needs the mesh"):
        render_rays(*args, axis_name="rays")
    with pytest.raises(ValueError, match="do not divide"):
        render_rays_sharded(*args, pmesh.Mesh({"rays": 3}, {"rays": 0}))


@pytest.fixture(scope="module")
def gloo_renders(tmp_path_factory):
    """Both cases rendered by two gloo ranks on ``{"rays": -1}``: by case,
    each rank's gathered outputs; and the inputs' file."""
    tmp = tmp_path_factory.mktemp("ray_cp")
    inputs = [dict(planes=t(c["planes"]), decoder=c["dec"].state_dict(), channels=8,
                   origins=c["origins"], dirs=c["dirs"], options=OPTS)
              for c in CASES.values()]
    torch.save(inputs, tmp / "inputs.pt")
    ranks = _launch(_world(tmp, "rank", 2, mode="ray_render", mesh_shape={"rays": -1},
                           inputs=str(tmp / "inputs.pt")))
    return {kind: [torch.load(r["cases"][i]) for r in ranks]
            for i, kind in enumerate(CASES)} | {"inputs": str(tmp / "inputs.pt")}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_two_gloo_ranks_render_as_jax_shard_map(gloo_renders, kind):
    """The gathered render of two ranks, each on its 32 rays, within 1e-5
    of JAX's ``shard_map`` render over two devices on every output (the
    depth of rays whose weights sum to 0 included: both clip it to their
    block's depth range), and of JAX's unsharded render on ``rgb``,
    ``weights_sum`` and ``is_ray_valid``; both ranks hold the same whole."""
    case = CASES[kind]
    a, b = gloo_renders[kind]
    assert (a["coords"], b["coords"]) == ({"rays": 0}, {"rays": 1})
    for k in KEYS:
        assert torch.equal(a[k], b[k]), k
    sharded, whole = _jax_render(case, True), _jax_render(case, False)
    valid = to_np(a["is_ray_valid"])[0]
    w, w_jax = to_np(a["weights_sum"])[0, :, 0], sharded["weights_sum"][0, :, 0]
    zero = w == 0
    print(f"{kind}: {int((~valid).sum())} rays miss the box, {int(zero.sum())} have zero "
          f"weights")
    # rays that miss the box, rays of zero weight in each block and rays that
    # composite; none whose weights sum to a few ulps (there the last
    # rounding of each package would decide between a depth and the bound)
    assert 0 < valid.sum() < valid.size and zero[:32].any() and zero[32:].any()
    assert np.array_equal(w_jax == 0, zero) and not ((w > 0) & (w < 1e-4)).any()
    # JAX's blocks clip the zero-weight depths to their own bounds
    assert not np.array_equal(sharded["depth"][0][zero], whole["depth"][0][zero])
    for k in KEYS:
        assert a[k].shape == sharded[k].shape, k
        np.testing.assert_allclose(to_np(a[k]), sharded[k], rtol=0, atol=1e-5, err_msg=k)
        if k != "depth":
            np.testing.assert_allclose(to_np(a[k]), whole[k], rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(to_np(a["depth"])[0][~zero], whole["depth"][0][~zero],
                               rtol=0, atol=1e-5)


def test_four_gloo_ranks_on_a_data_by_rays_mesh_render_each_data_line(gloo_renders,
                                                                       tmp_path):
    """``{"data": -1, "rays": 2}`` on four ranks: every axis line's group
    built on every rank (the two ``data`` lines and the two ``rays``
    lines), rank r at (r // 2, r % 2) as JAX lays out its devices, each
    line's all-reduce over its own ranks; each ``data`` coordinate's pair
    renders both cases over its ``rays`` group, bit-equal to the two-rank
    world's render."""
    ranks = _launch(_world(tmp_path, "rank", 4, mode="ray_render",
                           mesh_shape={"data": -1, "rays": 2}, inputs=gloo_renders["inputs"]))
    for r, res in enumerate(ranks):
        for i, kind in enumerate(CASES):
            got = torch.load(res["cases"][i])
            assert got["coords"] == {"data": r // 2, "rays": r % 2}
            # the data line {r % 2, r % 2 + 2}, the rays line {r - r % 2, r - r % 2 + 1}
            assert got["line_sums"] == {"data": 2 * (r % 2) + 2, "rays": 2 * (r - r % 2) + 1}
            for k in KEYS:
                assert torch.equal(got[k], gloo_renders[kind][0][k]), (r, kind, k)


# -- the batch on a data x rays mesh -------------------------------------------------------


@pytest.mark.parametrize("shape", [{"data": 2, "rays": 1}, {"data": 1, "rays": 2},
                                   {"data": -1, "rays": 2}])
def test_shard_global_batch_cuts_rows_over_data_and_replicates_over_rays(monkeypatch, shape):
    """Each rank's rows against the block that JAX's ``shard_batch`` puts on
    its device; ranks that differ only in ``rays`` hold the same rows; a
    batch whose rows do not divide by the data size stays whole."""
    batch = {"a": np.arange(8).reshape(4, 2), "s": np.float32(3.0), "odd": np.arange(3)}
    odd = {"a": np.arange(6).reshape(3, 2), "s": np.float32(1.0)}
    world = 4 if -1 in shape.values() else 2
    jm = jax_make_mesh(shape, devices=jax.devices()[:world])
    shards = {s.device.id: np.asarray(s.data)
              for s in jax_shard_batch({"a": batch["a"]}, jm)["a"].addressable_shards}
    for r in range(world):
        _set_patched_world(monkeypatch, world, r)
        m = make_mesh(shape)
        n, i = m.size("data"), m.coord("data")
        assert process_local_batch_slice(4, m) == slice(i * 4 // n, (i + 1) * 4 // n)
        local = shard_global_batch(batch, torch.device("cpu"), m)
        np.testing.assert_array_equal(local["a"].numpy(), shards[r])
        np.testing.assert_array_equal(shard_batch(batch, m)["a"], shards[r])
        assert torch.equal(local["odd"], torch.from_numpy(batch["odd"]))
        assert float(local["s"]) == 3.0
        whole = shard_global_batch(odd, None, m)
        assert all(np.array_equal(whole[k], v) for k, v in odd.items())
        for q in range(world):
            same_data = pmesh.mesh_coords(m.shape, q)["data"] == i
            assert np.array_equal(shards[q], shards[r]) == same_data

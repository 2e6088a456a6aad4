"""One process of the port's multi-process tests on the CPU
(tests/test_torch_ddp.py, tests/test_torch_ray_parallel.py):

    python tests/_torch_ddp_worker.py '<json spec>'

``spec``: ``mode`` ("gan_step", "fit", "replicate" or "ray_render"),
``world`` (0: no process group) and ``rank``, ``port`` (rank 0's, on localhost), ``config``
and ``hparams`` (a dict; ``binary_data_dir`` in it trains from a record
store), ``steps``, the draws (``draws_seed``, recorded to ``records_out``,
or replayed from ``records_in``, each record split by rows across the
mesh's ``data`` axis where its rows divide; ``hparams["mesh_shape"]``,
default the world on ``data``), ``ref_params`` (a reference's parameters to
measure against), ``params_out``, ``work_dir``, ``no_save`` (the trainer
writes no checkpoint) and ``out_json``. In "fit" mode the result also has
each step's global and local batch rows and the parameters' sha1 after it. "ray_render"
renders ``inputs`` on the mesh ``mesh_shape`` (``ray_render``). Imports
nothing of JAX."""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

# the join and every collective of a multi-rank world fail after this long
JOIN_TIMEOUT_S = 120


def draws_for(spec: dict, device):
    from real3dportrait_tpu_torch.parallel.mesh import axis_sizes, mesh_coords
    from real3dportrait_tpu_torch.utils.draws import (
        RecordDraws, ReplayDraws, rank_records, seeded_draws)

    if spec.get("records_in"):
        with open(spec["records_in"], "rb") as f:
            records = pickle.load(f)
        # the rank's rows are those of its coordinate on the mesh's data axis
        shape = axis_sizes(spec["hparams"].get("mesh_shape"), max(spec["world"], 1))
        coord = mesh_coords(shape, spec["rank"])
        return ReplayDraws(rank_records(records, shape.get("data", 1), coord.get("data", 0)))
    draws = seeded_draws(spec.get("draws_seed", 7), device)
    return RecordDraws(draws) if spec.get("records_out") else draws


def params_of(state) -> dict:
    """Every parameter of the state's modules, by ``<module>.<name>``."""
    out = {}
    for key in ("gen", "disc", "model"):
        mod = getattr(state, key, None)
        if mod is not None:
            out.update({f"{key}.{n}": p.detach().clone() for n, p in mod.named_parameters()})
    return out


def sha1_of(params: dict) -> str:
    h = hashlib.sha1()
    for n in sorted(params):
        h.update(params[n].numpy().tobytes())
    return h.hexdigest()


def summarise(params: dict, ref_path: str | None) -> dict:
    """The parameters' sha1, and against a reference: the largest
    |difference| over each leaf's scale (its largest magnitude, floored at
    1e-3 of the tree's), the leaf where it is, and the largest absolute one."""
    out = {"sha1": sha1_of(params), "n_params": len(params)}
    if ref_path:
        ref = torch.load(ref_path)
        assert set(ref) == set(params)
        top = max(float(r.abs().max()) for r in ref.values())
        worst, where, abs_max = 0.0, "", 0.0
        for n, r in ref.items():
            err = float((params[n].double() - r.double()).abs().max())
            rel = err / max(float(r.abs().max()), 1e-3 * top)
            abs_max = max(abs_max, err)
            if rel > worst:
                worst, where = rel, n
        out.update(worst_rel=worst, worst_leaf=where, max_abs=abs_max, top=top)
    return out


def ray_render(spec: dict) -> list[str]:
    """Each case of ``spec["inputs"]`` (a ``torch.save`` list of planes,
    decoder state dict and channels, rays and render options) rendered on
    the mesh ``spec["mesh_shape"]`` by ``render_rays_sharded``: this rank's
    block of the rays, the blocks gathered; the gathered outputs saved, a
    file a case, with the rank's coordinates and the sum of the ranks of
    its line along each axis (an all-reduce over the line's group);
    returns the files."""
    import torch.distributed as dist

    from real3dportrait_tpu_torch.models.decoder import OSGDecoder
    from real3dportrait_tpu_torch.parallel import make_mesh
    from real3dportrait_tpu_torch.rendering.renderer import RenderOptions, render_rays_sharded

    mesh = make_mesh(spec["mesh_shape"])
    # each axis line's group: the sum of its ranks
    sums = {axis: int(mesh.all_reduce(torch.tensor([spec["rank"]]), dist.ReduceOp.SUM, axis))
            for axis in mesh.shape}
    paths = []
    for i, case in enumerate(torch.load(spec["inputs"])):
        dec = OSGDecoder(case["channels"], 64, 32)
        dec.load_state_dict(case["decoder"])
        with torch.no_grad():
            out = render_rays_sharded(case["planes"], dec, case["origins"], case["dirs"],
                                      RenderOptions(**case["options"]), mesh)
        paths.append(spec["out_json"].replace(".json", f"_case{i}.pt"))
        torch.save({**out, "coords": dict(mesh.coords), "line_sums": sums}, paths[-1])
    return paths


def main(spec: dict) -> None:
    from real3dportrait_tpu_torch.config import load_config
    from real3dportrait_tpu_torch.parallel import (
        distributed, make_mesh, maybe_initialize_distributed, replicate_to_mesh,
        shard_global_batch)
    from real3dportrait_tpu_torch.training.tasks.base_task import resolve_task

    dev = torch.device("cpu")
    hparams = spec.get("hparams", {})
    if spec["world"] > 0:
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(spec["port"]),
                          WORLD_SIZE=str(spec["world"]), RANK=str(spec["rank"]),
                          LOCAL_RANK="0")
    if spec["world"] > 1:
        # several ranks join here, under a timeout, so that a dead rank fails
        # the test instead of hanging it; the trainer's join then only
        # reports. A world of one joins through the launch contract.
        import datetime

        import torch.distributed as dist

        dist.init_process_group("gloo", init_method="env://",
                                timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    result: dict = {}
    if spec["mode"] == "ray_render":
        result["cases"] = ray_render(spec)
        with open(spec["out_json"], "w") as f:
            json.dump(result, f)
        return
    if spec["mode"] == "fit":
        from real3dportrait_tpu_torch.training import run, trainer

        draws = draws_for(spec, dev)
        trainer.seeded_draws = lambda seed, device: draws
        argv = ["--config", os.path.join(ROOT, "configs", spec["config"]), "--device", "cpu",
                "--work_dir_root", spec["work_dir"], "--exp_name", "run", "--hparams",
                ",".join(f"{k}={v}" for k, v in hparams.items())]
        t = run.make_trainer(argv)
        step, take = t.task.train_step, t.batch
        result.update(rows=[], local_rows=[], step_sha1=[], mesh=dict(
            shape=dict(t.mesh.shape), coords=dict(t.mesh.coords),
            groups=t.mesh.groups is not None))

        def batch_of(batch):
            result["rows"].append(distributed.batch_rows(batch))
            local = take(batch)
            result["local_rows"].append(distributed.batch_rows(local))
            return local

        def hashed_step(state, batch, d):
            metrics = step(state, batch, d)
            result["step_sha1"].append(sha1_of(params_of(state)))
            return metrics
        t.batch, t.task.train_step = batch_of, hashed_step
        if spec.get("no_save"):
            t.save = lambda *a, **k: None
        state = t.fit()
        result["lambdas"] = {k: float(v) for k, v in getattr(state, "extra", {}).items()}
        if spec.get("records_in"):
            assert not draws.records, "fewer draws than the single process made"
        with open(os.path.join(spec["work_dir"], "run", "metrics.jsonl")
                  if t.is_main else os.devnull) as f:
            result["log"] = [json.loads(line) for line in f if line.strip()]
    else:
        cfg = load_config(os.path.join(ROOT, "configs", spec["config"]), hparams)
        maybe_initialize_distributed(cfg, dev)
        task = resolve_task(cfg, dev)
        mesh = make_mesh({"data": -1})
        # "replicate": each rank builds from its own seed; the broadcast
        # must leave rank 0's state everywhere
        state = task.build(spec["rank"] if spec["mode"] == "replicate" else 0)
        replicate_to_mesh(state, mesh)
        draws = draws_for(spec, dev)
        result["metrics"] = []
        for _ in range(spec.get("steps", 0)):
            batch = shard_global_batch(task.synthetic_batch(np.random.RandomState(0)), dev)
            metrics = task.train_step(state, batch, draws)
            result["metrics"].append({k: float(v) for k, v in metrics.items()})
        result["lambdas"] = {k: float(v) for k, v in getattr(state, "extra", {}).items()}
        if spec.get("records_in"):
            assert not draws.records, "fewer draws than the single process made"
    if spec.get("records_out"):
        with open(spec["records_out"], "wb") as f:
            pickle.dump([(k, v.numpy()) for k, v in draws.records], f)
    params = params_of(state)
    if spec.get("params_out"):
        torch.save(params, spec["params_out"])
    result.update(summarise(params, spec.get("ref_params")))
    with open(spec["out_json"], "w") as f:
        json.dump(result, f)


if __name__ == "__main__":
    main(json.loads(sys.argv[1]))

"""The port's data-parallel training (``real3dportrait_tpu_torch/parallel``,
the all-reduce in ``training/schedulers.py:Adam.updates``, the trainer's
wiring) on the CPU: the batch slice, the mesh and the launch contract in
one process; then processes over gloo on localhost (tests/_torch_ddp_worker.py),
each under a join timeout and a process timeout, so that a dead rank fails
its test instead of hanging the suite. Two ranks on 2 + 2 rows reproduce
one process's steps on the 4-row global batch, as JAX's single program
computes them (tools/dryrun_multihost.py's contract), with the single
process's per-row draws replayed on each rank's rows."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from real3dportrait_tpu_torch.parallel import distributed, mesh as pmesh
from real3dportrait_tpu_torch.parallel import (
    make_mesh,
    maybe_initialize_distributed,
    process_local_batch_slice,
    shard_batch,
    shard_global_batch,
)
from real3dportrait_tpu_torch.utils.draws import rank_records
from tests._torch_launch import _launch, _spec, _world
from tests._torch_train_parity import TINY_GAN

torch.set_num_threads(1)

GAN = {**{k: v for k, v in TINY_GAN.items() if k != "mesh_shape"},
       "batch_size": 4, "group_size_for_mini_batch_std": 1}
GAN_STEPS = 2
# the audio-to-motion stage with a clip so small that every step clips
A2M = {"batch_size": 4, "sample_min_length": 16, "clip_grad_norm": 0.001, "max_updates": 2,
       "tb_log_interval": 1, "num_sanity_val_steps": 0, "val_check_interval": 100000}


# -- one process ----------------------------------------------------------------------


def test_process_local_batch_slice_and_shards(monkeypatch):
    assert not dist.is_initialized()
    assert process_local_batch_slice(4) == slice(0, 4)
    batch = {"a": np.arange(8).reshape(4, 2), "s": np.float32(3.0), "odd": np.arange(3)}
    m = make_mesh()
    assert m.shape == {"data": 1}
    assert all(np.array_equal(shard_batch(batch, m)[k], v) for k, v in batch.items())
    # rank 1 of 2 (JAX's arithmetic; no group needed to slice)
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    monkeypatch.setattr(distributed, "rank", lambda: 1)
    monkeypatch.setattr(pmesh, "rank", lambda: 1)
    assert process_local_batch_slice(4) == slice(2, 4)
    with pytest.raises(AssertionError):
        process_local_batch_slice(3)
    local = shard_batch(batch, pmesh.Mesh({"data": 2}, {"data": 1}))
    np.testing.assert_array_equal(local["a"], batch["a"][2:])
    np.testing.assert_array_equal(local["odd"], batch["odd"])   # 3 rows: kept whole
    assert local["s"] == batch["s"]
    # the trainer's: the batch's rows (4) cut to the rank's slice on every
    # leaf of 4 rows, the rest kept whole, on the device
    on_dev = shard_global_batch(batch, torch.device("cpu"))
    assert torch.equal(on_dev["a"], torch.from_numpy(batch["a"][2:]))
    assert torch.equal(on_dev["odd"], torch.from_numpy(batch["odd"]))
    assert float(on_dev["s"]) == 3.0
    host = shard_global_batch({"a": torch.arange(4), "b": np.ones((4, 3))})
    assert torch.equal(host["a"], torch.arange(2, 4)) and host["b"].shape == (2, 3)
    # a global batch whose rows do not split over the processes is kept
    # whole, every leaf (JAX replicates such a leaf); a slice is still refused
    odd = {"a": np.arange(6).reshape(3, 2), "b": np.arange(2), "s": np.float32(1.0)}
    whole = shard_global_batch(odd)
    assert set(whole) == set(odd) and all(np.array_equal(whole[k], v) for k, v in odd.items())
    whole = shard_global_batch(odd, torch.device("cpu"))
    assert torch.equal(whole["a"], torch.from_numpy(odd["a"])) and whole["b"].shape == (2,)
    assert distributed.batch_rows(odd) == 3 and distributed.batch_rows({"s": 1.0}) == 0
    # the draws of rank 1 of 2: a record of 4 rows gives it rows 2-3, one
    # of 3 rows (a batch kept whole) and one of a single row stay whole
    recs = [("normal", torch.arange(8.0).reshape(4, 2)), ("uniform", torch.arange(3.0)),
            ("integers", torch.tensor([5])), ("normal", torch.arange(12.0).reshape(6, 2))]
    got = rank_records(recs, 2, 1)
    assert [k for k, _ in got] == [k for k, _ in recs]
    assert torch.equal(got[0][1], recs[0][1][2:])
    assert torch.equal(got[1][1], recs[1][1]) and torch.equal(got[2][1], recs[2][1])
    assert torch.equal(got[3][1], recs[3][1][3:])
    # rank 2 of 3: 4 rows stay whole, 3 and 6 rows are cut
    got = rank_records(recs, 3, 2)
    assert torch.equal(got[0][1], recs[0][1]) and torch.equal(got[1][1], recs[1][1][2:])
    assert torch.equal(got[3][1], recs[3][1][4:])


def test_make_mesh_axes_and_errors():
    assert make_mesh({"data": -1}).shape == make_mesh({"data": 1}).shape == {"data": 1}
    with pytest.raises(ValueError):
        make_mesh({"data": 2})
    # JAX's make_mesh on one device: 2 does not divide 1, its assertion fails
    with pytest.raises(ValueError):
        make_mesh({"data": -1, "rays": 2})
    m = make_mesh({"data": -1, "rays": 1})
    assert m.shape == {"data": 1, "rays": 1} and list(m.shape) == ["data", "rays"]
    assert m.coords == {"data": 0, "rays": 0} and m.groups is None


def test_launch_contract_env_wins_and_partial_launch_raises(monkeypatch):
    calls = []

    class Joined(Exception):
        pass

    def fake_init(backend, init_method, world_size, rank):
        calls.append((backend, init_method, world_size, rank))
        raise Joined

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    # no launch asked for: a single process
    assert maybe_initialize_distributed({"seed": 1}) is False
    assert maybe_initialize_distributed(None) is False
    # JAX's config keys alone
    cfg = {"coordinator_address": "10.0.0.1:1234", "num_processes": 2, "process_id": 1}
    with pytest.raises(Joined):
        maybe_initialize_distributed(cfg)
    assert calls[-1] == ("gloo", "tcp://10.0.0.1:1234", 2, 1)
    # torchrun's environment wins over the config, key for key
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    with pytest.raises(Joined):
        maybe_initialize_distributed(cfg)
    assert calls[-1] == ("gloo", "tcp://127.0.0.1:29500", 4, 3)
    # a card's process joins over NCCL, on its card
    cards = []
    monkeypatch.setattr(torch.cuda, "set_device", cards.append)
    with pytest.raises(Joined):
        maybe_initialize_distributed(cfg, torch.device("cuda", 3))
    assert calls[-1][0] == "nccl" and cards == [torch.device("cuda", 3)]
    # a launch that names processes but not where to join raises
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK"):
        monkeypatch.delenv(k)
    with pytest.raises(RuntimeError, match="address"):
        maybe_initialize_distributed({"num_processes": 2})


# -- several processes over gloo ----------------------------------------------------


@pytest.fixture(scope="module")
def single_gan(tmp_path_factory):
    """One process (no group) on the 4-row global batch: its metrics, its
    parameters and every draw it made."""
    tmp = tmp_path_factory.mktemp("ddp_gan")
    spec = _spec(tmp, "single", mode="gan_step", config="secc_img2plane.yaml", hparams=GAN,
                 steps=GAN_STEPS, records_out=str(tmp / "draws.pkl"),
                 params_out=str(tmp / "params.pt"))
    (res,) = _launch([spec])
    return tmp, spec, res


def test_two_gloo_ranks_reproduce_the_global_batch_step(single_gan):
    """2 + 2 rows on two ranks, the single process's draws replayed on each
    rank's rows: the losses averaged over the ranks (as the trainer logs
    them) and the parameters after the steps within 1e-5 of scale; both
    ranks hold the same parameters, bit for bit."""
    tmp, single, want = single_gan
    got = _launch(_world(tmp, "pair", 2, mode="gan_step", config="secc_img2plane.yaml",
                         hparams=GAN, steps=GAN_STEPS, records_in=single["records_out"],
                         ref_params=single["params_out"]))
    assert got[0]["sha1"] == got[1]["sha1"], "the ranks' parameters differ"
    for r in got:
        assert r["worst_rel"] <= 1e-5, (r["worst_leaf"], r["worst_rel"], r["max_abs"])
        assert r["lambdas"] == got[0]["lambdas"]
    for step, w in enumerate(want["metrics"]):
        assert set(got[0]["metrics"][step]) == set(w)
        for k, v in w.items():
            mean = (got[0]["metrics"][step][k] + got[1]["metrics"][step][k]) / 2
            np.testing.assert_allclose(mean, v, rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {step} {k}")
    for k, v in want["lambdas"].items():
        np.testing.assert_allclose(got[0]["lambdas"][k], v, rtol=1e-5, err_msg=k)


def test_one_rank_gloo_world_is_bit_equal_to_no_launch(single_gan):
    tmp, single, want = single_gan
    (got,) = _launch(_world(tmp, "one", 1, mode="gan_step", config="secc_img2plane.yaml",
                            hparams=GAN, steps=GAN_STEPS, draws_seed=7))
    assert got["sha1"] == want["sha1"]
    assert got["metrics"] == want["metrics"]


def test_replicate_broadcasts_rank0_state(tmp_path):
    # each rank builds the audio-to-motion state from its own seed; after
    # replicate_to_mesh both hold rank 0's, which is the seed-0 build
    hp = {"batch_size": 2, "sample_min_length": 16}
    (ref,) = _launch([_spec(tmp_path, "ref", mode="replicate", config="audio2motion_vae.yaml",
                            hparams=hp)])
    got = _launch(_world(tmp_path, "rep", 2, mode="replicate", config="audio2motion_vae.yaml",
                         hparams=hp))
    assert got[0]["sha1"] == got[1]["sha1"] == ref["sha1"]


def test_all_reduce_before_the_clip_and_rank1_writes_nothing(tmp_path):
    """``training.run``'s trainer, audio-to-motion with a global-norm clip
    that acts on every step: two ranks on 2 + 2 rows match one process on
    the 4 rows (a clip of each rank's own gradient would not); rank 0 logs
    the same metrics; rank 1's work dir stays empty."""
    (want,) = _launch([_spec(tmp_path, "single", mode="fit", config="audio2motion_vae.yaml",
                             hparams=A2M, work_dir=str(tmp_path / "single"),
                             records_out=str(tmp_path / "a2m_draws.pkl"),
                             params_out=str(tmp_path / "a2m_params.pt"))])
    specs = _world(tmp_path, "fit", 2, mode="fit", config="audio2motion_vae.yaml", hparams=A2M,
                   records_in=str(tmp_path / "a2m_draws.pkl"),
                   ref_params=str(tmp_path / "a2m_params.pt"))
    for s in specs:
        s["work_dir"] = str(tmp_path / f"rank{s['rank']}")
    got = _launch(specs)
    assert got[0]["sha1"] == got[1]["sha1"]
    assert got[0]["worst_rel"] <= 1e-5, (got[0]["worst_leaf"], got[0]["worst_rel"])
    assert [r["step"] for r in got[0]["log"]] == [r["step"] for r in want["log"]] == [1, 2]
    for g, w in zip(got[0]["log"], want["log"]):
        for k in w:
            if k not in ("step", "prefix", "steps_per_sec"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert sorted(os.listdir(tmp_path / "rank0" / "run")) == \
        sorted(os.listdir(tmp_path / "single" / "run"))
    assert not os.path.exists(tmp_path / "rank1") or not any(
        files for _, _, files in os.walk(tmp_path / "rank1")), "rank 1 wrote files"
    assert got[1]["log"] == []


def _fit_pair(tmp, name: str, config: str, hparams: dict,
              rank_hparams: dict | None = None) -> tuple[dict, list[dict]]:
    """``training.run``'s trainer, writing no checkpoint: one process with
    its draws recorded, then two ranks (with ``rank_hparams`` added) with
    them replayed (``rank_records``: a rank's rows of a batch that splits
    over the mesh's data axis, the whole draw of one kept whole); (one,
    ranks)."""
    draws, params = str(tmp / f"{name}_draws.pkl"), str(tmp / f"{name}_params.pt")
    (want,) = _launch([_spec(tmp, f"{name}_single", mode="fit", config=config,
                             hparams=hparams, work_dir=str(tmp / f"{name}_single"),
                             records_out=draws, params_out=params, no_save=True)])
    specs = _world(tmp, name, 2, mode="fit", config=config,
                   hparams={**hparams, **(rank_hparams or {})},
                   records_in=draws, ref_params=params, no_save=True)
    for s in specs:
        s["work_dir"] = str(tmp / f"{name}_rank{s['rank']}")
    return want, _launch(specs)


# the SECC task's perturbation lambdas step by lr_lambda_pertube_secc x
# log10 of the loss each is tuned from (``tune_lambdas``)
LR_LAMBDA = 0.01
TUNED_FROM = {"lambda_pertube_secc": "g/pertube_secc",
              "lambda_pertube_blink_secc": "g/pertube_blink_secc"}


def _assert_ranks_reproduce(want: dict, got: list[dict], tol: float = 1e-5,
                            atol: float = 1e-7) -> None:
    """Both ranks' parameters bit-equal after every step, within ``tol`` of
    scale of the one process's after the last; rank 0's log (the means
    over the ranks) within ``tol`` / ``atol`` of the one process's, step
    for step. A perturbation lambda is held to its loss's tolerance carried
    through the log10 of its tuning, summed over the steps so far: a loss
    near 1e-5 (a difference of two nearly equal planes) is known to
    ``atol``, not to ``tol`` of itself."""
    assert got[0]["rows"] == got[1]["rows"] == want["rows"]
    assert got[0]["step_sha1"] == got[1]["step_sha1"], "the ranks' parameters differ"
    assert len(got[0]["step_sha1"]) == len(want["step_sha1"])
    for r in got:
        assert r["worst_rel"] <= tol, (r["worst_leaf"], r["worst_rel"], r["max_abs"])
    assert [r["step"] for r in got[0]["log"]] == [r["step"] for r in want["log"]]
    carried = dict.fromkeys(TUNED_FROM, 0.0)
    for g, w in zip(got[0]["log"], want["log"]):
        for lam, loss in TUNED_FROM.items():
            if w.get(loss):
                carried[lam] += LR_LAMBDA * (tol + atol / abs(w[loss])) / np.log(10)
        for k in w:
            if k not in ("step", "prefix", "steps_per_sec"):
                lam_tol = carried.get(k.removeprefix("g/"), 0.0)
                np.testing.assert_allclose(g[k], w[k], rtol=tol, atol=max(atol, lam_tol),
                                           err_msg=f"step {w['step']} {k}")
    for k, v in want["lambdas"].items():
        np.testing.assert_allclose(got[0]["lambdas"][k], v, rtol=tol,
                                   atol=carried.get(k, 0.0), err_msg=k)


WHOLE = "each rank trains on the whole batch"


def test_two_ranks_train_a_global_batch_that_does_not_split_whole(tmp_path):
    """``training.run``'s trainer on two ranks with a global batch of 3
    rows: each rank trains on the whole batch (as JAX replicates a leaf
    whose rows do not divide) and says so once; with the single process's
    draws replayed whole on each rank, the ranks' parameters are bit-equal
    after each step and match one process on the 3 rows."""
    want, got = _fit_pair(tmp_path, "odd", "audio2motion_vae.yaml", {**A2M, "batch_size": 3})
    assert want["rows"] == [3, 3]
    _assert_ranks_reproduce(want, got)
    for r in got:
        assert r["stdout"].count(WHOLE) == 1, r["stdout"][-4000:]
        assert "| a batch of 3 rows does not divide over 2 processes" in r["stdout"]
    assert WHOLE not in want["stdout"]


# audio-to-motion from a store whose token buckets alternate 4 rows of 16
# frames and 3 of 24 (``max_tokens_per_batch`` 72: a fifth 16-frame row or
# a fourth 24-frame one would pass it). Within a bucket the sequences are
# of one length, so a split bucket's masked means over each rank's rows
# average to the global batch's (ROADMAP lists masked means per rank as a
# known difference of uneven masks).
A2M_BUCKETS = ((4, 16), (3, 24))
A2M_STORE = {**A2M, "max_tokens_per_batch": 72, "max_updates": 3}


@pytest.fixture(scope="module")
def a2m_store(tmp_path_factory):
    from real3dportrait_tpu_torch.data.binarizer import binarize, make_synthetic_records

    out = tmp_path_factory.mktemp("a2m_store")
    recs = [r for i, (n, t) in enumerate(A2M_BUCKETS) for r in make_synthetic_records(n, t, i)]
    for split in ("train", "val"):
        binarize(recs, str(out / split))
    return str(out)


def test_two_ranks_train_audio2motion_from_a_store_with_odd_buckets(tmp_path, a2m_store):
    """``configs/audio2motion_vae.yaml`` from the store: the 4-row buckets
    split 2 + 2, the 3-row one trained whole on each rank; held to one
    process on the same store with its draws replayed."""
    want, got = _fit_pair(tmp_path, "a2m", "audio2motion_vae.yaml",
                          {**A2M_STORE, "binary_data_dir": a2m_store})
    assert want["rows"] == [4, 3, 4]
    _assert_ranks_reproduce(want, got)
    assert all(r["stdout"].count(WHOLE) == 1 for r in got)


@pytest.fixture(scope="module")
def secc_store(tmp_path_factory):
    """Two videos of 24 frames with every image key at 48^2 (shrunk to
    TINY_GAN's 32^2), as train and val splits."""
    from real3dportrait_tpu_torch.data.binarizer import binarize, make_synthetic_records

    out = tmp_path_factory.mktemp("secc_store")
    recs = make_synthetic_records(2, 24, seed=1)
    rng = np.random.RandomState(2)
    for r in recs:
        for k in ("head_imgs", "com_imgs", "torso_imgs"):
            r[k] = rng.randint(0, 256, (24, 48, 48, 3), dtype=np.uint8)
        r["segmaps"] = rng.randint(-1, 7, (24, 48, 48)).astype(np.int8)
        r["bg_img"] = rng.randint(0, 256, (48, 48, 3), dtype=np.uint8)
    for split in ("train", "val"):
        binarize(recs, str(out / split))
    return str(out)


def test_two_ranks_train_the_secc_stage_from_a_store(tmp_path, secc_store):
    """``configs/secc_img2plane.yaml`` at the tiny GAN widths from the
    store, global batch 2: each rank prepares the same record batch (the
    pair sampler and the perturbation draws seeded from ``seed``, K4's
    plain version for every row) and trains its row; held to one process
    on the same store, with its draws replayed, at the tolerances of
    ``test_two_gloo_ranks_reproduce_the_global_batch_step``."""
    hp = {**GAN, "batch_size": 2, "binary_data_dir": secc_store, "secc_resolution": 64,
          "max_updates": GAN_STEPS, "tb_log_interval": 1, "num_sanity_val_steps": 0,
          "val_check_interval": 100000}
    want, got = _fit_pair(tmp_path, "secc", "secc_img2plane.yaml", hp)
    assert want["rows"] == [2] * GAN_STEPS
    _assert_ranks_reproduce(want, got)
    assert not any(WHOLE in r["stdout"] for r in got)


def test_two_ranks_on_a_rays_mesh_train_replicas_of_the_global_batch(tmp_path):
    """``training.run``'s trainer with ``mesh_shape={data: 1, rays: 2}``
    (JAX's ``{"data": -1, "rays": 2}`` on two devices) for one step: each
    rank trains the whole 4-row global batch, as JAX replicates the batch
    over ``rays``, and the world's all-reduce averages the two replicas.
    With the single process's draws replayed whole on each rank, the
    replicas are the one process's step: held to it as the data-parallel
    pair is, and the ranks' parameters bit-equal to its own."""
    want, got = _fit_pair(tmp_path, "rays", "audio2motion_vae.yaml", {**A2M, "max_updates": 1},
                          rank_hparams={"mesh_shape": {"data": 1, "rays": 2}})
    assert want["rows"] == want["local_rows"] == [4]
    assert all(r["local_rows"] == [4] for r in got), [r["local_rows"] for r in got]
    # the trainer lays the ranks out on the mesh and builds no axis group
    assert [r["mesh"] for r in got] == [
        {"shape": {"data": 1, "rays": 2}, "coords": {"data": 0, "rays": i}, "groups": False}
        for i in range(2)]
    _assert_ranks_reproduce(want, got)
    assert got[0]["step_sha1"] == want["step_sha1"]
    assert not any(WHOLE in r["stdout"] for r in got)

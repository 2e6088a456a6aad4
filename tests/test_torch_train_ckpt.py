"""The weight bridge and checkpoints of the training state: a JAX
``SeccImg2PlaneTask.build`` state goes to the port and back strictly and
bit-equal; a checkpoint the port's trainer writes is read by the JAX
package's ``load_checkpoint`` with the JAX state's leaves; the port's
trainer resumes from a JAX checkpoint; the CLI trains on the CPU and, with
no card, refuses the default device."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from real3dportrait_tpu.training import checkpoint as jckpt
from real3dportrait_tpu_torch.training import run as trun
from tests._torch_train_parity import CONFIG, ROOT, TINY_GAN, tasks

torch.set_num_threads(1)

HPARAMS = ",".join(f"{k}={v}" for k, v in TINY_GAN.items() if k != "mesh_shape")


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def built():
    from flax import serialization

    jtask, ptask = tasks()
    jstate = jtask.build(jax.random.PRNGKey(0))
    return jtask, ptask, _flat(serialization.to_state_dict(jax.device_get(jstate)))


def test_jax_build_state_round_trips_bit_equal(built):
    """Every leaf of the JAX state (params of gen, disc and gen_ema, the
    noise constants, both optax states, step and lambdas) into the port's
    state (strict loads) and back."""
    _, ptask, want = built
    state = ptask.build(1)
    tree = {}
    for key, v in want.items():     # rebuild the nested tree from the flat keys
        parts = [p.strip("[]'") for p in key.split("][")]
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    state.load_state_dict(tree)
    got = _flat(state.state_dict())
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_port_checkpoint_reads_in_jax_and_resumes(built, tmp_path):
    """The port's trainer (2 steps on the CPU) writes a checkpoint that the
    JAX package's ``load_checkpoint`` reads with exactly the JAX state's
    leaves, holding the port's values; a second run resumes from it."""
    _, _, want = built
    argv = ["--config", CONFIG, "--exp_name", "run", "--work_dir_root", str(tmp_path),
            "--device", "cpu", "--hparams", HPARAMS + ",max_updates=2,num_sanity_val_steps=0"]
    try:
        state = trun.main(argv)
        path = os.path.join(tmp_path, "run", "model_ckpt_steps_2.ckpt")
        got = _flat(jckpt.load_checkpoint(path))
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        mine = _flat(state.state_dict())
        for k, v in mine.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert int(got["['step']"]) == 2
        resumed = trun.main(argv[:-1] + [HPARAMS + ",max_updates=3,num_sanity_val_steps=0"])
        assert resumed.step == 3
        assert os.path.exists(os.path.join(tmp_path, "run", "model_ckpt_steps_3.ckpt"))
    finally:
        shutil.rmtree(tmp_path / "run", ignore_errors=True)     # ~1.5 GB a checkpoint


def test_cli_trains_on_cpu_and_refuses_a_missing_card(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "real3dportrait_tpu_torch.training.run", "--config", CONFIG,
           "--work_dir_root", str(tmp_path), "--exp_name", "cli", "--hparams",
           HPARAMS + ",max_updates=1,num_sanity_val_steps=0,tb_log_interval=1"]
    try:
        done = subprocess.run(cmd + ["--device", "cpu"], capture_output=True, text=True,
                              env=env, timeout=300, cwd=ROOT)
        assert done.returncode == 0, done.stderr[-2000:]
        assert "train step 1" in done.stdout
        assert os.path.exists(os.path.join(tmp_path, "cli", "model_ckpt_steps_1.ckpt"))
    finally:
        shutil.rmtree(tmp_path / "cli", ignore_errors=True)     # ~1.5 GB a checkpoint
    done = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert done.returncode != 0 and "no CUDA device" in done.stderr

"""The torso stage's start from a head-stage checkpoint: the port's
``training/checkpoint.py:partial_load`` and ``Trainer.init_or_restore``
with ``init_from_ckpt`` against the JAX package's ``partial_load`` on a
checkpoint the JAX package wrote (tiny GAN widths, the SegFormer backbone so
that the file stays small): the same statistics, the same merged leaves,
and the trainer's state carrying them."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import serialization

from real3dportrait_tpu.training import checkpoint as jckpt
from real3dportrait_tpu_torch.training import checkpoint as pckpt
from real3dportrait_tpu_torch.training.trainer import Trainer
from tests._torch_train_parity import TORSO_CONFIG, jax_state, port_state, tasks

torch.set_num_threads(1)
OVER = {"batch_size": 1, "torso_model_scale": "tiny", "img2plane_backbone_mode": "segformer"}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (str(k),))
    else:
        yield ".".join(prefix), np.asarray(tree)


def test_init_from_ckpt_matches_jax(tmp_path):
    jhead, _ = tasks(OVER)
    hb = jax.tree_util.tree_map(jnp.asarray, jhead.synthetic_batch(np.random.RandomState(0)))
    head = jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(
        jax_state(jhead, hb, seed=3).replace(step=jnp.asarray(7, jnp.int32))))
    head_dir = str(tmp_path / "head")
    jckpt.save_checkpoint(head_dir, 7, head)

    jtorso, ptorso = tasks(OVER, TORSO_CONFIG)
    tb = jax.tree_util.tree_map(jnp.asarray, jtorso.synthetic_batch(np.random.RandomState(0)))
    jstate = jax_state(jtorso, tb, seed=4)
    target = jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(jstate))
    src, _ = jckpt.get_last_checkpoint(head_dir)
    jmerged, jstats = jckpt.partial_load(target, src)

    pstate = port_state(ptorso, jstate)
    psrc, path = pckpt.get_last_checkpoint(head_dir)
    assert path.endswith("model_ckpt_steps_7.ckpt")
    pmerged, pstats = pckpt.partial_load(pstate.state_dict(), psrc)
    assert pstats == jstats
    assert pstats["loaded"] > 0 and pstats["missing"] > 0     # the torso's leaves are new
    want, got = dict(_flat(jmerged)), dict(_flat(pmerged))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and np.array_equal(got[k], v), k

    # the trainer: a fresh seeded state, then the head checkpoint merged in
    cfg = dict(ptorso.cfg, init_from_ckpt=head_dir)
    trainer = Trainer(cfg, ptorso, str(tmp_path / "run"))
    state = trainer.init_or_restore(0)
    assert state.step == 7
    built = dict(_flat(ptorso.build(0).state_dict()))
    mine = dict(_flat(state.state_dict()))
    head_leaves = {k: v for k, v in _flat(src)}
    for k, v in mine.items():
        if k in head_leaves and head_leaves[k].shape == v.shape:
            assert np.array_equal(v, head_leaves[k]), k
        else:
            assert np.array_equal(v, built[k]), k

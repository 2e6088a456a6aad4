"""Parity of the port's data tools with the JAX package: collators, the
record store (each package reads the other's, compressed and appended),
record validation, the three task datasets from one store and seed, the
native reader and ``parallel_map``."""

import os

import numpy as np
import pytest

from real3dportrait_tpu.data import collate as jcollate
from real3dportrait_tpu.data import datasets as jds
from real3dportrait_tpu.data import indexed_dataset as jidx
from real3dportrait_tpu.data.binarizer import binarize as jbinarize
from real3dportrait_tpu.data.binarizer import make_synthetic_records as jrecords
from real3dportrait_tpu.data.binarizer import validate_record as jvalidate
from real3dportrait_tpu.geometry import bfm as jbfm
from real3dportrait_tpu_torch.data import collate, datasets
from real3dportrait_tpu_torch.data import indexed_dataset as idx
from real3dportrait_tpu_torch.data.binarizer import binarize, make_synthetic_records
from real3dportrait_tpu_torch.data.binarizer import validate_record
from real3dportrait_tpu_torch.geometry import bfm

_RAGGED = [np.arange(n * 3, dtype=np.float32).reshape(n, 3) for n in (5, 2, 7, 1)]


def assert_trees_equal(got, want, what=""):
    assert type(got) is type(want) or isinstance(want, np.ndarray), what
    if isinstance(want, dict):
        assert list(got) == list(want), f"{what}: keys {list(got)} != {list(want)}"
        for k in want:
            assert_trees_equal(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.dtype == want.dtype and np.array_equal(got, want), what
    else:
        assert got == want, what


_LENGTHS = [len(x) for x in _RAGGED]
_COLLATE = {
    "collate": lambda m: m.collate_nd(_RAGGED),
    "collate_max_len": lambda m: m.collate_nd(_RAGGED, max_len=4),
    "collate_pad": lambda m: m.collate_nd(_RAGGED, pad_value=-1.0, max_len=9),
    "mask": lambda m: m.make_mask(_LENGTHS),
    "mask_max_len": lambda m: m.make_mask(_LENGTHS, max_len=3),
    "round_up": lambda m: np.asarray([m.round_up(x, 8) for x in range(20)]),
}


@pytest.mark.parametrize("case", sorted(_COLLATE))
def test_collate_and_mask_match_jax(case):
    assert_trees_equal(_COLLATE[case](collate), _COLLATE[case](jcollate), case)


@pytest.mark.parametrize("kw", [dict(), dict(max_tokens=40), dict(max_sentences=3),
                                dict(max_tokens=50, required_batch_size_multiple=2),
                                dict(max_tokens=30, bucket_by_size=False)])
def test_batch_by_size_matches_jax(kw):
    sizes = list(np.random.RandomState(0).randint(1, 20, size=30))
    indices = list(range(30))
    got = collate.batch_by_size(indices, sizes, **kw)
    assert got == jcollate.batch_by_size(indices, sizes, **kw)
    assert sorted(i for b in got for i in b) == indices


def _items(n, seed):
    rng = np.random.RandomState(seed)
    return [{"i": i, "x": rng.randn(i + 1, 3).astype(np.float32),
             "img": rng.randint(0, 256, (4, 4, 3), dtype=np.uint8)} for i in range(n)]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("compress", [False, True])
def test_stores_cross_packages(tmp_path, writer, compress):
    # one package writes (and appends), the other reads, and the reverse
    w, r = (jidx, idx) if writer == "jax" else (idx, jidx)
    path = str(tmp_path / "store")
    first, more = _items(5, 0), _items(3, 1)
    with w.IndexedDatasetBuilder(path, compress=compress) as b:
        for it in first:
            b.add_item(it)
    with r.IndexedDatasetBuilder(path, append=True) as b:  # the reader's package appends
        for it in more:
            b.add_item(it)
    for reader in (w, r):
        ds = reader.IndexedDataset(path)
        assert len(ds) == 8 and ds.compress == compress
        for got, want in zip(ds, first + more):
            assert_trees_equal(got, want, f"{writer} store read by {reader.__name__}")
        ds.close()


def test_synthetic_records_and_binarize_match_jax(tmp_path):
    recs, jrecs = make_synthetic_records(2, 20, seed=3), jrecords(2, 20, seed=3)
    for got, want in zip(recs, jrecs):
        assert_trees_equal(got, want, "synthetic record")
    assert binarize(recs, str(tmp_path / "p" / "train")) == 2
    assert jbinarize(jrecs, str(tmp_path / "j" / "train")) == 2
    for k in (".idx", ".data-00000"):
        with open(tmp_path / "p" / f"train{k}", "rb") as a, \
                open(tmp_path / "j" / f"train{k}", "rb") as b:
            assert a.read() == b.read(), f"stores differ in {k}"


def _bad(change):
    rec = make_synthetic_records(1, 20, seed=0)[0]
    change(rec)
    return rec


_BAD = {
    "missing_exp": lambda r: r.pop("exp"),
    "missing_f0": lambda r: r.pop("f0"),
    "no_audio": lambda r: r.pop("hubert"),
    "exp_width": lambda r: r.update(exp=np.zeros((20, 63), np.float32)),
    "euler_shape": lambda r: r.update(euler=np.zeros((19, 3), np.float32)),
    "trans_shape": lambda r: r.update(trans=np.zeros((20, 2), np.float32)),
    "audio_length": lambda r: r.update(hubert=np.zeros((45, 1024), np.float32)),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_validate_record_rejects_what_jax_rejects(case):
    with pytest.raises(AssertionError):
        jvalidate(_bad(_BAD[case]))
    with pytest.raises(ValueError):
        validate_record(_bad(_BAD[case]))


def test_validate_record_accepts_mel_and_near_lengths():
    for change in (lambda r: r.update(mel=r.pop("hubert")[:, :80]),
                   lambda r: r.update(hubert=r["hubert"][:36])):
        rec = _bad(change)
        jvalidate(rec)
        assert validate_record(rec) is rec


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A small video store with images: 3 videos of 24 frames at 16^2."""
    path = str(tmp_path_factory.mktemp("store") / "train")
    recs = make_synthetic_records(3, 24, seed=5)
    rng = np.random.RandomState(6)
    for r in recs:
        for k in ("head_imgs", "com_imgs", "torso_imgs"):
            r[k] = rng.randint(0, 256, (24, 16, 16, 3), dtype=np.uint8)
        r["segmaps"] = rng.randint(0, 6, (24, 16, 16)).astype(np.int8)
        r["bg_img"] = rng.randint(0, 256, (16, 16, 3), dtype=np.uint8)
    binarize(recs, path)
    return path


def _take(it, n):
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("shuffle", [True, False])
def test_motion2video_batches_match_jax(store, shuffle):
    cfg = {"batch_size": 3, "sample_pair_max_offset": 6}
    got = _take(datasets.Motion2VideoDataset(store, cfg, shuffle=shuffle, seed=4).batches(), 3)
    want = _take(jds.Motion2VideoDataset(store, cfg, shuffle=shuffle, seed=4).batches(), 3)
    for g, w in zip(got, want):
        assert_trees_equal(g, w, "motion2video batch")
    assert {"src_head_imgs", "tgt_segmaps", "src_bg_img", "tgt_pertube_exp_2"} <= set(got[0])


@pytest.mark.parametrize("cfg", [dict(max_tokens_per_batch=60, sample_min_length=8),
                                 dict(max_frames=16, sample_min_length=8,
                                      max_sentences_per_batch=2)])
def test_audio2motion_batches_match_jax(store, cfg):
    got = _take(datasets.Audio2MotionDataset(store, cfg, seed=2).batches(), 4)
    want = _take(jds.Audio2MotionDataset(store, cfg, seed=2).batches(), 4)
    for g, w in zip(got, want):
        assert_trees_equal(g, w, "audio2motion batch")


@pytest.mark.parametrize("mode,n_kp", [("lm468", 468), ("lip", 68)])
def test_syncnet_batches_match_jax(store, mode, n_kp):
    # the same clips, labels and phases; the mouth landmarks (fp32 matmuls in
    # two frameworks) within 1e-5 of their scale
    cfg = {"syncnet_keypoint_mode": mode}
    got = _take(datasets.SyncNetDataset(store, cfg, assets=bfm.synthetic_bfm(
        512, n_keypoints=n_kp), seed=3).batches(40), 2)
    want = _take(jds.SyncNetDataset(store, cfg, assets=jbfm.synthetic_bfm(
        512, n_keypoints=n_kp), seed=3).batches(40), 2)
    for g, w in zip(got, want):
        assert g["phase"] == w["phase"]
        assert_trees_equal(g["label"], w["label"], "labels")
        assert_trees_equal(g["hubert_clip"], w["hubert_clip"], "audio clips")
        assert g["mouth_clip"].shape == w["mouth_clip"].shape == (40, 5, {
            "lm468": 1404, "lip": 60}[mode])
        scale = np.abs(w["mouth_clip"]).max()
        assert np.abs(g["mouth_clip"] - w["mouth_clip"]).max() <= 1e-5 * scale
    assert sorted(set(got[0]["phase"])) == ["neg_large", "neg_small", "neg_swap", "pos"]


def test_native_reader_matches_python_reader(tmp_path):
    from real3dportrait_tpu_torch.data import native_reader as nr

    for compress in (False, True):
        path = str(tmp_path / f"store{int(compress)}")
        items = _items(30, 2)
        with idx.IndexedDatasetBuilder(path, compress=compress) as b:
            for it in items:
                b.add_item(it)
        order = np.random.RandomState(1).permutation(30)
        with nr.NativePrefetchReader(path) as reader:
            got = list(reader.iterate(order, n_threads=3, ring_capacity=4))
        py = idx.IndexedDataset(path)
        for k, g in zip(order, got):
            assert_trees_equal(g, py[int(k)], "native record")
        with nr.NativePrefetchReader(path) as reader, pytest.raises(IndexError):
            next(reader.iterate([30]))
    assert os.path.dirname(nr.build_library()).endswith(os.path.join("build", "native"))


def test_parallel_map_and_iter_parallel():
    import math

    from real3dportrait_tpu.preprocess.parallel_map import parallel_map as jparallel_map
    from real3dportrait_tpu_torch.preprocess.parallel_map import iter_parallel, parallel_map

    want = jparallel_map(math.factorial, range(10), num_workers=3, use_threads=True)
    assert parallel_map(math.factorial, range(10), num_workers=3, use_threads=True) == want
    # spawned processes (a builtin, so that the workers import no test module)
    assert parallel_map(math.factorial, range(6), num_workers=2) == want[:6]
    assert dict(iter_parallel(lambda x: -x, range(5), num_workers=2)) == {
        i: -i for i in range(5)}

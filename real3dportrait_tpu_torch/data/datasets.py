"""Task datasets over the indexed record store (port of
``real3dportrait_tpu/data/datasets.py``): host-side numpy that draws from
``np.random.RandomState`` in the JAX package's order, so the same store and
seed give the same batches.

* :class:`Audio2MotionDataset`: variable-length (hubert, f0, exp, blink)
  sequences, token-bucketed, padded to multiples of 8 frames;
* :class:`SyncNetDataset`: mined (audio, mouth-landmark, label) clip pairs
  with the positive / negative phase mix;
* :class:`Motion2VideoDataset`: (src, tgt) frame pairs with the adaptive
  offset, the neighbour-frame perturbed expressions and the images.

A record (``data/binarizer.py``) is one video: ``{id, exp, euler, trans,
f0, hubert | mel, blink}`` and, for the video stages, ``head_imgs``,
``com_imgs``, ``torso_imgs``, ``segmaps`` ([T,...]) and ``bg_img``.
"""

from __future__ import annotations

import numpy as np
import torch

from real3dportrait_tpu_torch.data.collate import batch_by_size, collate_nd, make_mask, round_up
from real3dportrait_tpu_torch.data.indexed_dataset import IndexedDataset


class Audio2MotionDataset:
    def __init__(self, path: str, cfg, shuffle: bool = True, seed: int = 0):
        self.ds = IndexedDataset(path)
        self.cfg = cfg
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.audio_key = "hubert" if cfg.get("audio_type", "hubert") == "hubert" else "mel"
        self.min_len = int(cfg.get("sample_min_length", 32))
        self.sizes = [len(item["exp"]) for item in self.ds]

    def __len__(self) -> int:
        return len(self.ds)

    def _clip(self, item) -> dict:
        t = len(item["exp"])
        max_t = min(t, int(self.cfg.get("max_frames", 600)))
        max_t -= max_t % 8
        start = self.rng.randint(0, max(t - max_t, 0) + 1) if self.shuffle else 0
        sl = slice(start, start + max_t)
        audio = np.asarray(item[self.audio_key], np.float32)
        blink = np.asarray(item.get("blink", np.zeros((t, 1), np.int64)))
        return {
            "audio": audio[2 * start: 2 * (start + max_t)],
            "f0": np.asarray(item["f0"], np.float32)[2 * start: 2 * (start + max_t)],
            "y": np.asarray(item["exp"], np.float32)[sl],
            "blink": blink[2 * start: 2 * (start + max_t)],
            "id": np.asarray(item["id"], np.float32)[:1],
        }

    def batches(self):
        """Padded, token-bucketed batches, indefinitely."""
        indices = [i for i in range(len(self)) if self.sizes[i] >= self.min_len]
        if not indices:
            raise ValueError(f"no sequence of at least sample_min_length={self.min_len} "
                             f"frames in {self.ds.path}")
        while True:
            if self.shuffle:
                self.rng.shuffle(indices)
            groups = batch_by_size(
                indices, self.sizes,
                max_tokens=int(self.cfg.get("max_tokens_per_batch", 20000)),
                max_sentences=int(self.cfg.get("max_sentences_per_batch", 512)))
            for group in groups:
                items = [self._clip(self.ds[i]) for i in group]
                t_max = round_up(max(len(x["y"]) for x in items), 8)
                yield {
                    "audio": collate_nd([x["audio"] for x in items], max_len=2 * t_max),
                    "f0": collate_nd([x["f0"][:, None] for x in items],
                                     max_len=2 * t_max)[..., 0],
                    "y": collate_nd([x["y"] for x in items], max_len=t_max),
                    "y_mask": make_mask([len(x["y"]) for x in items], max_len=t_max),
                    "blink": collate_nd([x["blink"].astype(np.int32) for x in items],
                                        max_len=2 * t_max),
                    "mouth_amp": np.full((len(items), 1), 0.4, np.float32),
                }


class SyncNetDataset:
    """Clip-pair miner of the SyncNet stage: fixed-shape batches
    ``{'hubert_clip' [N,10,A], 'mouth_clip' [N,5,lm_dim], 'label' [N],
    'phase'}`` with the phase mix positives 0.4, same-video negatives at a
    small offset (+-[2,5] frames) 0.3 and at a large one (+-[5,10]) 0.2,
    and audio from another video 0.1. A 5-frame mouth window pairs with 10
    frames of 50 Hz audio. Each video's landmarks
    (``geometry/face3d_helper.reconstruct_idexp_lm3d`` on ``device``) are
    cached, up to ``cache_videos`` videos."""

    PHASES = (("pos", 0.4), ("neg_small", 0.3), ("neg_large", 0.2), ("neg_swap", 0.1))
    CLIP_LEN = 5  # video frames; audio clips are twice as long

    def __init__(self, path: str, cfg, assets=None, shuffle: bool = True, seed: int = 0,
                 cache_videos: int = 64, device: torch.device | str = "cpu"):
        self.ds = IndexedDataset(path)
        self.cfg = cfg
        self.rng = np.random.RandomState(seed)
        # lip modes slice the 20 mouth points of the 68 landmarks; lm68 and
        # lm468 feed the whole set
        self.keypoint_mode = cfg.get("syncnet_keypoint_mode", "lm468")
        if assets is None:
            from real3dportrait_tpu_torch.geometry.bfm import load_or_synthetic_bfm

            assets = load_or_synthetic_bfm(
                cfg.get("bfm_dir"),
                keypoint_mode="mediapipe" if self.keypoint_mode == "lm468" else "lm68")
        self.device = torch.device(device)
        self.assets = assets.to(self.device)
        self.audio_key = "hubert" if cfg.get("audio_type", "hubert") == "hubert" else "mel"
        self.cache_videos = cache_videos
        self._cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def __len__(self) -> int:
        return len(self.ds)

    def _mouth_and_audio(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        """([t, lm_dim] landmark offsets, [2t, A] audio) of video ``idx``."""
        if idx not in self._cache:
            from real3dportrait_tpu_torch.geometry.face3d_helper import reconstruct_idexp_lm3d

            item = self.ds[idx]
            exp = np.asarray(item["exp"], np.float32)
            t = len(exp)
            idc = np.asarray(item["id"], np.float32).reshape(-1, 80)
            if len(idc) != t:  # one identity for the video
                idc = np.broadcast_to(idc[:1], (t, 80))
            with torch.no_grad():
                lm = reconstruct_idexp_lm3d(
                    self.assets, torch.from_numpy(np.ascontiguousarray(idc)).to(self.device),
                    torch.from_numpy(exp).to(self.device)).cpu().numpy()
            if self.keypoint_mode in ("lm68", "lm468"):
                mouth = lm.reshape(t, -1)
            else:
                mouth = lm[:, 48:68].reshape(t, -1)
            audio = np.asarray(item[self.audio_key], np.float32)
            t = min(t, len(audio) // 2)
            if len(self._cache) >= self.cache_videos:
                self._cache.pop(next(iter(self._cache)))
            self._cache[idx] = (mouth[:t], audio[: 2 * t])
        return self._cache[idx]

    def _usable(self) -> list[int]:
        need = self.CLIP_LEN + 11  # room for the largest offset
        idxs = [i for i in range(len(self.ds)) if len(self.ds[i]["exp"]) >= need]
        if not idxs:
            raise ValueError(f"no video of at least {need} frames for SyncNet mining in "
                             f"{self.ds.path}")
        return idxs

    def mine_clip(self, phase: str, idxs: list[int]) -> tuple:
        L = self.CLIP_LEN
        rng = self.rng
        i = idxs[rng.randint(len(idxs))]
        mouth, audio = self._mouth_and_audio(i)
        t = len(mouth)
        if phase == "pos":
            offset = 0
        elif phase == "neg_small":
            offset = int(rng.choice([-1, 1])) * rng.randint(2, 6)
        elif phase == "neg_large":
            offset = int(rng.choice([-1, 1])) * rng.randint(5, 11)
        else:  # neg_swap: a random offset, the audio of another video
            offset = rng.randint(-10, 11)
        t0 = rng.randint(max(0, -offset), t - L - max(0, offset) + 1)
        mouth_clip = mouth[t0: t0 + L]
        if phase == "neg_swap" and len(idxs) > 1:
            j = idxs[rng.randint(len(idxs))]
            while j == i:
                j = idxs[rng.randint(len(idxs))]
            _, audio = self._mouth_and_audio(j)
            a0 = min(2 * (t0 + offset), len(audio) - 2 * L)
        else:
            a0 = 2 * (t0 + offset)
        audio_clip = audio[a0: a0 + 2 * L]
        return mouth_clip, audio_clip, (1.0 if phase == "pos" else 0.0), phase

    def batches(self, num_clip_pairs: int | None = None):
        n = num_clip_pairs or int(self.cfg.get("syncnet_num_clip_pairs", 256))
        counts = {k: int(n * r) for k, r in self.PHASES}
        counts["pos"] += n - sum(counts.values())  # the remainder are positives
        idxs = self._usable()
        while True:
            mouth_lst, audio_lst, labels, phases = [], [], [], []
            for phase, count in counts.items():
                for _ in range(count):
                    m, a, lab, ph = self.mine_clip(phase, idxs)
                    mouth_lst.append(m)
                    audio_lst.append(a)
                    labels.append(lab)
                    phases.append(ph)
            yield {
                "hubert_clip": np.stack(audio_lst),
                "mouth_clip": np.stack(mouth_lst),
                "label": np.asarray(labels, np.float32),
                "phase": phases,  # host-side diagnostic; the task drops it
            }


class Motion2VideoDataset:
    """(src, tgt) frame-pair sampler of the SECC-to-plane and torso stages.
    The pair's offset adapts, ``min(max_offset, max((t-1-j)//2, j//2))``
    with up to 20 redraws, and each frame carries its neighbour-frame
    expressions ``*_pertube_exp_1`` (the exp of frame +-1) and
    ``*_pertube_exp_2`` (``2 * exp - exp_1``) for the SECC regulariser."""

    IMAGE_KEYS = ("head_imgs", "com_imgs", "torso_imgs", "bg_img", "segmaps")

    def __init__(self, path: str, cfg, shuffle: bool = True, seed: int = 0,
                 min_offset: int | None = None):
        self.ds = IndexedDataset(path)
        self.cfg = cfg
        self.shuffle = shuffle
        self.max_offset = int(min_offset if min_offset is not None
                              else cfg.get("sample_pair_max_offset", 50))
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.ds)

    def _pertube_exps(self, exp: np.ndarray, i: int) -> tuple:
        t = len(exp)
        cands = [k for k in (i - 1, i + 1) if 0 <= k < t]
        p1 = exp[int(self.rng.choice(cands))]
        return p1, 2.0 * exp[i] - p1

    def sample_pair(self, item) -> dict:
        t = len(item["exp"])
        i = self.rng.randint(0, t)
        j = self.rng.randint(0, t)
        for _ in range(20):
            min_off = min(self.max_offset, max((t - 1 - j) // 2, j // 2))
            if abs(j - i) >= min_off:
                break
            j = self.rng.randint(0, t)
        out = {"src_idx": i, "tgt_idx": j}
        for k in ("id", "exp", "euler", "trans"):
            arr = np.asarray(item[k], np.float32)
            out[f"src_{k}"] = arr[i] if arr.ndim > 1 else arr
            out[f"tgt_{k}"] = arr[j] if arr.ndim > 1 else arr
        exp = np.asarray(item["exp"], np.float32)
        out["src_pertube_exp_1"], out["src_pertube_exp_2"] = self._pertube_exps(exp, i)
        out["tgt_pertube_exp_1"], out["tgt_pertube_exp_2"] = self._pertube_exps(exp, j)
        for k in self.IMAGE_KEYS:
            if k in item:
                arr = item[k]
                out[f"src_{k}"] = arr[i] if k != "bg_img" else arr
                out[f"tgt_{k}"] = arr[j] if k != "bg_img" else arr
        return out

    def batches(self, batch_size: int | None = None):
        b = batch_size or int(self.cfg.get("batch_size", 4))
        while True:
            idxs = self.rng.randint(0, len(self.ds), size=b)
            pairs = [self.sample_pair(self.ds[int(i)]) for i in idxs]
            yield {k: np.stack([np.asarray(p[k]) for p in pairs]) for k in pairs[0]}

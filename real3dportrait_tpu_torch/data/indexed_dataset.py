"""Binary record store for preprocessed training data (port of
``real3dportrait_tpu/data/indexed_dataset.py``; the two packages read each
other's stores).

An append-only store of pickled items: ``<path>.idx`` (the pickled
``{"offsets": [(chunk, start, end), ...], "compress": bool}``) beside the
``<path>.data-NNNNN`` chunks, a new chunk beyond 64 GB, each item
optionally gzip-compressed. Unpickling runs code from the file: read only
stores this program wrote.
"""

from __future__ import annotations

import gzip
import os
import pickle
from typing import Any, Iterator

_CHUNK_LIMIT = 64 * 2**30  # start a new data file beyond 64 GB


class IndexedDataset:
    def __init__(self, path: str):
        self.path = path
        with open(path + ".idx", "rb") as f:
            meta = pickle.load(f)
        self.offsets = meta["offsets"]          # [(chunk, start, end), ...]
        self.compress = meta.get("compress", False)
        self._files: dict[int, Any] = {}

    def __len__(self) -> int:
        return len(self.offsets)

    def _file(self, chunk: int):
        if chunk not in self._files:
            self._files[chunk] = open(f"{self.path}.data-{chunk:05d}", "rb")
        return self._files[chunk]

    def __getitem__(self, i: int):
        chunk, start, end = self.offsets[i]
        f = self._file(chunk)
        f.seek(start)
        raw = f.read(end - start)
        if self.compress:
            raw = gzip.decompress(raw)
        return pickle.loads(raw)

    def __iter__(self) -> Iterator:
        for i in range(len(self)):
            yield self[i]

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()


class IndexedDatasetBuilder:
    """Writes a store; ``append`` continues an existing one (its last chunk
    and its compression). The index is written atomically by
    :meth:`finalize` (or on leaving a ``with`` block)."""

    def __init__(self, path: str, append: bool = False, compress: bool = False):
        self.path = path
        if append and os.path.exists(path + ".idx"):
            with open(path + ".idx", "rb") as f:
                meta = pickle.load(f)
            self.offsets = meta["offsets"]
            self.compress = meta["compress"]
            self.chunk = self.offsets[-1][0] if self.offsets else 0
        else:
            self.offsets = []
            self.compress = compress
            self.chunk = 0
        self._out = open(self._chunk_path(self.chunk), "ab" if append else "wb")

    def _chunk_path(self, chunk: int) -> str:
        return f"{self.path}.data-{chunk:05d}"

    def add_item(self, item: Any) -> int:
        raw = pickle.dumps(item, protocol=pickle.HIGHEST_PROTOCOL)
        if self.compress:
            raw = gzip.compress(raw)
        if self._out.tell() + len(raw) > _CHUNK_LIMIT and self._out.tell() > 0:
            self._out.close()
            self.chunk += 1
            self._out = open(self._chunk_path(self.chunk), "wb")
        start = self._out.tell()
        self._out.write(raw)
        self.offsets.append((self.chunk, start, start + len(raw)))
        return len(self.offsets) - 1

    def finalize(self) -> None:
        self._out.close()
        tmp = self.path + ".idx.part"
        with open(tmp, "wb") as f:
            pickle.dump({"offsets": self.offsets, "compress": self.compress}, f)
        os.replace(tmp, self.path + ".idx")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finalize()

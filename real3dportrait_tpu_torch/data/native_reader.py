"""ctypes bindings of the native prefetching record reader (port of
``real3dportrait_tpu/data/native_reader.py``).

At first use ``g++`` builds the repository's ``native/record_reader.cpp``
(C++ threads read, in the order asked, the records of an indexed store into
a bounded ring, off the interpreter lock) into
``build/native/librecord_reader.so`` at the root of the checkout, and
rebuilds it when the source is newer. Without ``g++`` it raises: there is
no quiet fall back to :class:`~.indexed_dataset.IndexedDataset`.
"""

from __future__ import annotations

import ctypes
import gzip
import os
import pickle
import shutil
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "record_reader.cpp")
_BUILD_DIR = os.path.join(_ROOT, "build", "native")
_SO = os.path.join(_BUILD_DIR, "librecord_reader.so")
_lock = threading.Lock()
_lib = None


def build_library() -> str:
    """The shared object's path, built from the source if it is missing or
    older (written to a temporary name and moved, so concurrent builders
    never load a half-written file)."""
    if os.path.isfile(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("native_reader: g++ is not on PATH; it builds "
                           "native/record_reader.cpp")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.part"
    proc = subprocess.run([cxx, "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread", _SRC,
                           "-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native_reader: g++ failed:\n{proc.stderr}")
    os.replace(tmp, _SO)
    return _SO


def native_available() -> bool:
    """Whether the native reader builds (or is built) and loads here."""
    try:
        _load_library()
        return True
    except Exception:
        return False


def _load_library():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build_library())
        lib.rr_create.restype = ctypes.c_void_p
        lib.rr_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
                                  ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        lib.rr_start.restype = ctypes.c_int32
        lib.rr_start.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
                                 ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
        lib.rr_next.restype = ctypes.c_int64
        lib.rr_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
                                ctypes.POINTER(ctypes.c_int64)]
        lib.rr_release.restype = None
        lib.rr_release.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_char)]
        lib.rr_destroy.restype = None
        lib.rr_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class NativePrefetchReader:
    """Iterate the records of an indexed store with native threaded prefetch::

        reader = NativePrefetchReader(path)
        for item in reader.iterate(order, n_threads=4):
            ...
        reader.close()

    One :meth:`iterate` a reader (the native side keeps one order)."""

    def __init__(self, path: str):
        self.path = path
        with open(path + ".idx", "rb") as f:
            meta = pickle.load(f)
        self.offsets = np.asarray(meta["offsets"], np.int64).reshape(-1, 3)
        self.compress = meta.get("compress", False)
        n_chunks = int(self.offsets[:, 0].max()) + 1 if len(self.offsets) else 0
        self.chunk_paths = [f"{path}.data-{i:05d}".encode() for i in range(n_chunks)]
        self._lib = _load_library()
        arr = (ctypes.c_char_p * len(self.chunk_paths))(*self.chunk_paths)
        flat = np.ascontiguousarray(self.offsets.reshape(-1))
        self._handle = self._lib.rr_create(
            arr, len(self.chunk_paths), flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(self.offsets))
        # the native reader keeps these pointers for the handle's lifetime
        self._keepalive = (arr, flat)

    def __len__(self) -> int:
        return len(self.offsets)

    def iterate(self, order=None, n_threads: int = 4, ring_capacity: int = 16):
        """Yield the records of ``order`` (default: all, in store order)."""
        order = np.ascontiguousarray(
            order if order is not None else np.arange(len(self)), np.int32)
        if len(order) and (order.min() < 0 or order.max() >= len(self)):
            raise IndexError(f"record index out of range 0..{len(self) - 1}")
        rc = self._lib.rr_start(self._handle,
                                order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                len(order), n_threads, ring_capacity)
        if rc != 0:
            raise RuntimeError("native reader already started")
        ptr = ctypes.POINTER(ctypes.c_char)()
        length = ctypes.c_int64()
        while True:
            seq = self._lib.rr_next(self._handle, ctypes.byref(ptr), ctypes.byref(length))
            if seq == -1:
                break
            if seq == -2:
                raise IOError(f"native reader IO error in {self.path}")
            raw = ctypes.string_at(ptr, length.value)
            self._lib.rr_release(self._handle, ptr)
            if self.compress:
                raw = gzip.decompress(raw)
            yield pickle.loads(raw)

    def close(self) -> None:
        if self._handle:
            self._lib.rr_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

"""Fan-out for offline preprocessing (port of
``real3dportrait_tpu/preprocess/parallel_map.py``): map a function over
items with a pool of threads or of processes (started by ``spawn``, so
``fn`` and the items must pickle), results in order or as they complete."""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor, as_completed
from typing import Callable, Iterable, Iterator


def _pool(use_threads: bool, num_workers: int):
    if use_threads:
        return ThreadPoolExecutor(max_workers=num_workers)
    return ProcessPoolExecutor(max_workers=num_workers,
                               mp_context=multiprocessing.get_context("spawn"))


def parallel_map(fn: Callable, items: Iterable, num_workers: int = 4, ordered: bool = True,
                 use_threads: bool = False, desc: str = "") -> list:
    """``[fn(item) for item in items]`` on a pool, in the items' order
    whatever ``ordered`` says (the JAX package's flag, which its function
    ignores too); threads (``use_threads``) for IO-bound or unpicklable
    work, processes otherwise. ``desc`` prints progress every tenth of the
    items."""
    items = list(items)
    results: list = [None] * len(items)
    done = 0
    with _pool(use_threads, num_workers) as pool:
        futures = {pool.submit(fn, it): i for i, it in enumerate(items)}
        for fut in as_completed(futures):
            results[futures[fut]] = fut.result()
            done += 1
            if desc and done % max(len(items) // 10, 1) == 0:
                print(f"| {desc}: {done}/{len(items)}", flush=True)
    return results


def iter_parallel(fn: Callable, items: Iterable, num_workers: int = 4,
                  use_threads: bool = True) -> Iterator[tuple[int, object]]:
    """Yield ``(index, fn(item))`` as they complete (unordered)."""
    items = list(items)
    with _pool(use_threads, num_workers) as pool:
        futures = {pool.submit(fn, it): i for i, it in enumerate(items)}
        for fut in as_completed(futures):
            yield futures[fut], fut.result()

"""Tracing and phase timing (port of ``real3dportrait_tpu/utils/profiling.py``).

``named_scope`` is ``torch.profiler.record_function``: a span that shows in
a trace. ``trace_to(log_dir)`` traces the host and the CUDA device into a
Chrome trace in ``log_dir``; ``kernel_table`` reads a profile's device
kernels. ``Timer`` is the trainer's wall-clock phase map, as the JAX
package keeps it.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

# a span in the trace
named_scope = torch.profiler.record_function


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Trace what runs inside into ``log_dir/trace_<pid>_<ns>.json`` (Chrome
    trace format) and yield the profiler, whose ``key_averages()`` and
    ``events()`` the caller may read after the block. The host activity is
    always recorded, the CUDA activity where a card is visible: with CUDA
    alone some profiles hold no device event."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))



def kernel_table(prof, top: int, port: bool = True) -> tuple[float, list]:
    """(the device's kernel time in ms, its ``top`` kernels by self device
    time and, with ``port``, every other kernel of the port's below them)
    of a finished ``torch.profiler`` run. ProfilerStep ranges, which also
    appear on the device timeline, are left out; the port's kernels are
    those in anonymous namespaces outside ``at::`` (``csrc/*.cu`` keeps
    them there)."""
    from torch.autograd import DeviceType

    rows = [x for x in prof.key_averages() if x.device_type == DeviceType.CUDA
            and not x.key.startswith("ProfilerStep")]
    ranked = sorted(rows, key=lambda x: -x.self_device_time_total)
    below = [x for x in ranked[top:] if "(anonymous namespace)::" in x.key
             and "at::" not in x.key] if port else []
    return sum(x.self_device_time_total for x in rows) / 1e3, ranked[:top] + below

class Timer:
    """Named wall-clock accumulator.

    with Timer("forward", enable=True): ...
    Timer.report() -> {name: seconds}
    """

    totals: dict[str, float] = defaultdict(float)
    counts: dict[str, int] = defaultdict(int)

    def __init__(self, name: str, enable: bool = True):
        self.name = name
        self.enable = enable

    def __enter__(self):
        if self.enable:
            self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        if self.enable:
            dt = time.time() - self.t0
            Timer.totals[self.name] += dt
            Timer.counts[self.name] += 1

    @classmethod
    def report(cls) -> dict[str, float]:
        return dict(cls.totals)

    @classmethod
    def reset(cls):
        cls.totals.clear()
        cls.counts.clear()

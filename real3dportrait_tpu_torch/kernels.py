"""Build and load the port's hand-written CUDA kernels.

The sources are ``csrc/*.cu``, each with a plain C entry point. At first use
they are compiled by ``nvcc`` for Hopper (``sm_90a``), one process per
source, all started together, and linked into one shared library under
``build/torch_kernels/`` at the root of the checkout, named by a hash of
the sources, and loaded with ``ctypes``. Pointers and the CUDA
stream cross as ``c_void_p``; every entry point returns
``cudaGetLastError()``, and :func:`launch` raises if that is not 0.

Nothing here is imported or compiled on a machine without a CUDA device
until a kernel wrapper is handed a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import statistics
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong


class FirTaps(ctypes.Structure):
    """K6a's taps (``csrc/stylegan_epilogue.cu``, which hands them to the
    kernel by value): the row-major filter (at most 8 x 8) and, for a
    rank-1 filter, its factors."""

    _fields_ = [("t", ctypes.c_float * 64), ("u", ctypes.c_float * 8),
                ("v", ctypes.c_float * 8)]


class Upfirdn2dPlan(ctypes.Structure):
    """Everything of one K6a call but its pointers and stream, passed by
    address: the taps, whether they factor, the sizes, up, down and pads."""

    _fields_ = [("f", FirTaps)] + [(n, _I) for n in (
        "sep", "N", "H", "W", "up", "down", "px0", "py0", "fh", "fw", "Ho", "Wo")]


# C entry point -> argument types (the last argument is the stream)
SIGNATURES: dict[str, tuple] = {
    "r3dp_triplane_decode": (_P, _I, _I, _I, _P, _L, _F, _P, _P, _P, _P),
    "r3dp_trigrid_decode": (_P, _I, _I, _I, _I, _P, _L, _F, _P, _P, _P, _P),
    "r3dp_trigrid_decode_backward": (_P, _I, _I, _I, _I, _P, _L, _F, _P, _P, _P, _P, _P, _P,
                                     _P, _P, _P, _P, _P, _P),
    "r3dp_triplane_decode_backward": (_P, _I, _I, _I, _P, _L, _F, _P, _P, _P, _P, _P, _P, _P,
                                      _P, _P, _P, _P, _P),
    "r3dp_importance_sample": (_P, _P, _P, _L, _I, _I, _I, _P, _P),
    "r3dp_merge_composite": (_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    "r3dp_merge_composite_backward": (_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                                      _P, _P, _P, _P, _P),
    "r3dp_secc_raster": (_P, _I, _I, _P, _I, _P, _F, _F, _F, _I, _F, _F, _P, _P, _P, _P),
    "r3dp_torso_deform_input": (_P, _P, _P, *(_I,) * 8, _P, _P),
    "r3dp_torso_warp_volume": (_P, _P, _I, _I, _I, _I, _I, _P, _P),
    "r3dp_torso_deform_input_backward": (_P, _P, _P, *(_I,) * 6, _P, _P),
    "r3dp_torso_warp_volume_backward": (_P, _P, _P, *(_I,) * 5, _P, _P, _P),
    "r3dp_upfirdn2d": (_P, ctypes.POINTER(Upfirdn2dPlan), _P, _P),
    "r3dp_upfirdn2d_bf16": (_P, ctypes.POINTER(Upfirdn2dPlan), _P, _P),
    "r3dp_bias_act": (_P, _P, _P, _I, _P, _L, _I, _I, _I, _F, _F, _P, _P),
    "r3dp_bias_act_bf16": (_P, _P, _P, _I, _P, _L, _I, _I, _I, _F, _F, _P, _P),
    "r3dp_bias_act_grad": (_P, _P, _P, _P, _L, _I, _I, _I, _F, _F, _P, _P, _P, _P, _I, _P),
    "r3dp_bias_act_grad_bf16": (_P, _P, _P, _P, _L, _I, _I, _I, _F, _F, _P, _P, _P, _P, _I,
                                _P),
    "r3dp_conv3d": (_P, _P, _P, _P, _P, *(_I,) * 15, _P),
    "r3dp_conv3d_weight_grad": (_P, _P, *(_I,) * 11, _P, _P, _P),
    "r3dp_mfe_tail": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                      _P, _P, _P),
    "r3dp_mfe_tail_backward_adjoint": (*(_P,) * 10, *(_I,) * 5, _P, _P, _P, _P),
    "r3dp_mfe_tail_backward_data": (_P, _P, _P, *(_I,) * 5, _P, _P),
    "r3dp_mfe_tail_backward_occ": (_P, _P, *(_I,) * 5, _P, _P, _P),
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, str]:
    """Compile every kernel source and link one library; returns (path, log).

    Reuses a library already built from identical sources. The sources
    compile in parallel, one nvcc each. The log is nvcc's output, kept
    beside the library, with each kernel's registers, shared memory and
    spills from ``ptxas -v``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = _digest()
    lib_path = BUILD_DIR / f"libr3dp_kernels_{digest}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        return lib_path, log_path.read_text() if log_path.exists() else ""
    nvcc, tag = nvcc_path(), f"{digest}.{os.getpid()}"
    cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o",
             str(BUILD_DIR / f"{src.stem}.{tag}.o"), str(src)] for src in sources()]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp), *(c[-2] for c in cmds)]
    failed = [(c, p.returncode, o) for c, p, o in zip(cmds, procs, outs) if p.returncode]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        outs.append(proc.stdout + proc.stderr)
        if proc.returncode:
            failed = [(link, proc.returncode, outs[-1])]
    for c in cmds:
        Path(c[-2]).unlink(missing_ok=True)
    if failed:
        raise RuntimeError("\n".join(f"nvcc failed ({rc}):\n{' '.join(c)}\n{o}"
                                     for c, rc, o in failed))
    log = "".join(outs)
    log_path.write_text(log)
    os.replace(tmp, lib_path)
    return lib_path, log


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.r3dp_error_string.argtypes = [ctypes.c_int]
    lib.r3dp_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call one C entry point on the current stream; raise on a CUDA error.

    Tensor arguments pass as their data pointers; the launch runs on the
    device of the first tensor argument, on its current stream. Where that
    device is the current one (the usual case) no device context is entered.
    """
    lib = library()
    index = next(a for a in args if isinstance(a, torch.Tensor)).get_device()
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    if index == torch.cuda.current_device():
        status = getattr(lib, name)(*conv, torch.cuda.current_stream(index).cuda_stream)
    else:
        with torch.cuda.device(index):
            status = getattr(lib, name)(*conv, torch.cuda.current_stream(index).cuda_stream)
    if status != 0:
        msg = lib.r3dp_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg})")


def require(name: str, arg: str, t: torch.Tensor,
            dtype: torch.dtype | tuple[torch.dtype, ...] = torch.float32) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (or of
    one of several)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: {arg} must be a CUDA tensor, got {t.device}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: {arg} must be {' or '.join(map(str, dtypes))}, "
                         f"got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {arg} must be contiguous")


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event milliseconds of ``fn`` over ``reps`` calls, each
    timed alone on an idle device: what one call costs its caller, the host
    work before the launch included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, launches: int = 20, reps: int = 5, warmup: int = 3) -> float:
    """Device milliseconds of one call of ``fn``: the median over ``reps``
    of one event pair around ``launches`` back-to-back calls, divided by
    ``launches``. A spin kernel queued first holds the device while the host
    enqueues them, so the host's time per call does not show."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        # ~10 ms of cycles, longer than the enqueue; torch has no public
        # call that holds a stream busy (its own tests use this one)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)

"""real3dportrait_tpu_torch — the PyTorch/CUDA port of real3dportrait_tpu.

The JAX package ``real3dportrait_tpu`` is the reference; each module here
mirrors its counterpart's layout and public tensor layouts (images NHWC,
tri-planes [B,3,H,W,C] or tri-grids [B,3,D,H,W,C], rays [B,M,3], cameras
[B,25]). The main path's TPU-shaped spots are hand-written CUDA kernels
(``csrc/``, built and loaded by ``kernels.py``); every kernel wrapper runs
its plain PyTorch version for CPU tensors and launches the kernel (or
raises) for CUDA tensors. The entry points run on ``"cuda"`` unless the
caller passes another device.
"""

import torch


def entry_device(device: torch.device | str) -> torch.device:
    """The device an entry point runs on. Asking for CUDA where no CUDA
    device is visible raises: nothing drifts to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    return dev

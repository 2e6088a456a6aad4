"""The port's one fp32 policy.

Every check and timing of the port holds fp32 convolutions and matmuls to
full fp32 (the kernels' tolerances of 1e-3 / 1e-4 against their plain
versions, the parity tests against the JAX package). PyTorch runs cuDNN's
fp32 convolutions in one-pass TF32 by default, which keeps ~3 decimal
digits and which nothing of the port checks or times, so the entry points
and the tools turn it off, for cuBLAS matmuls too. TF32 stays off until a
measurement holds the TF32 result to the chip's tolerance.
"""

from __future__ import annotations

import torch


def set_fp32_policy() -> None:
    """Turn TF32 off for cuDNN convolutions and cuBLAS matmuls. These are
    process-global flags: they hold for everything the process runs after
    the call, the caller's own work included."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

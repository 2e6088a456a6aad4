"""real3dportrait_tpu_torch — the PyTorch/CUDA port of real3dportrait_tpu.

The JAX package ``real3dportrait_tpu`` is the reference; each module here
mirrors its counterpart's layout and public tensor layouts (images NHWC,
planes [B,3,H,W,C], rays [B,M,3], cameras [B,25]). The main path's
TPU-shaped spots are hand-written CUDA kernels (``csrc/``, built and loaded
by ``kernels.py``); every kernel wrapper runs its plain PyTorch version for
CPU tensors and launches the kernel (or raises) for CUDA tensors.
"""

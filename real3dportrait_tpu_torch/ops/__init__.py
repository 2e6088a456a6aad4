"""PyTorch port of ``real3dportrait_tpu.ops``."""

from real3dportrait_tpu_torch.ops.grid_sample import grid_sample_2d, grid_sample_3d

__all__ = ["grid_sample_2d", "grid_sample_3d"]

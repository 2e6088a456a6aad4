"""PyTorch port of ``real3dportrait_tpu.inference``: the pipeline, its
CLI and server, and the per-kernel timing tools."""

from real3dportrait_tpu_torch.inference.pipeline import Real3DPortraitPipeline

__all__ = ["Real3DPortraitPipeline"]

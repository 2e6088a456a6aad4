"""PyTorch port of ``real3dportrait_tpu.utils``."""

from real3dportrait_tpu_torch.utils.profiling import Timer, named_scope, trace_to

__all__ = ["Timer", "named_scope", "trace_to"]

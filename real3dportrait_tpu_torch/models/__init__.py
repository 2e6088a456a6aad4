"""PyTorch port of ``real3dportrait_tpu.models``."""

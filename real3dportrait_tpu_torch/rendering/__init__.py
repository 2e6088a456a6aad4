"""PyTorch port of ``real3dportrait_tpu.rendering``. The JAX package's
``run_model`` and ``sample_features`` have no counterpart: the plane
sample and the decoder are fused into kernels K1 / K1-trigrid
(``models/decoder.py``)."""

from real3dportrait_tpu_torch.rendering.math_utils import (
    broadcast_linspace,
    get_ray_limits_box,
)
from real3dportrait_tpu_torch.rendering.ray_marcher import march_rays
from real3dportrait_tpu_torch.rendering.ray_sampler import sample_rays
from real3dportrait_tpu_torch.rendering.renderer import (
    RenderOptions,
    render_rays,
    sample_from_planes,
    sample_from_trigrids,
    sample_importance,
)

__all__ = [
    "broadcast_linspace",
    "get_ray_limits_box",
    "march_rays",
    "sample_rays",
    "RenderOptions",
    "render_rays",
    "sample_from_planes",
    "sample_from_trigrids",
    "sample_importance",
]

"""PyTorch port of ``real3dportrait_tpu.parallel``: a mesh of processes
over ``torch.distributed``, one a card, with JAX's ``data`` axis
(data-parallel training) and ``rays`` axis (the renderer's ray context
parallelism, ``rendering/renderer.py:render_rays_sharded``)."""

from real3dportrait_tpu_torch.parallel.distributed import (
    is_main_process,
    maybe_initialize_distributed,
    process_local_batch_slice,
    shard_global_batch,
)
from real3dportrait_tpu_torch.parallel.mesh import (
    make_mesh,
    replicate_to_mesh,
    shard_batch,
)

__all__ = [
    "is_main_process",
    "make_mesh",
    "maybe_initialize_distributed",
    "process_local_batch_slice",
    "replicate_to_mesh",
    "shard_batch",
    "shard_global_batch",
]

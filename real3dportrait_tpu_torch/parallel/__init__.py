"""PyTorch port of ``real3dportrait_tpu.parallel``: data-parallel training
over ``torch.distributed``, one process a card."""

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

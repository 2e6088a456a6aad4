"""PyTorch port of ``real3dportrait_tpu.data``: the record store, its
binarizer and native reader, and the task datasets."""

from real3dportrait_tpu_torch.data.collate import batch_by_size, collate_nd, make_mask
from real3dportrait_tpu_torch.data.datasets import (
    Audio2MotionDataset,
    Motion2VideoDataset,
    SyncNetDataset,
)
from real3dportrait_tpu_torch.data.indexed_dataset import IndexedDataset, IndexedDatasetBuilder

__all__ = [
    "batch_by_size",
    "collate_nd",
    "make_mask",
    "Audio2MotionDataset",
    "Motion2VideoDataset",
    "SyncNetDataset",
    "IndexedDataset",
    "IndexedDatasetBuilder",
]

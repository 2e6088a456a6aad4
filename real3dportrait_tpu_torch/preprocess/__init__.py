"""PyTorch port of ``real3dportrait_tpu.preprocess``."""

from real3dportrait_tpu_torch.preprocess.pipeline import (
    extract_audio_features,
    process_video_to_record,
    segment_frames,
)

__all__ = ["extract_audio_features", "process_video_to_record", "segment_frames"]

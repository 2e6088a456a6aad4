"""PyTorch port of ``real3dportrait_tpu.audio``: the mel, F0 and MFCC
front end (``features.py``) and HuBERT (``hubert.py``). The JAX package's
``load_hubert_extractor`` (a HuggingFace directory) has no counterpart:
the port's HuBERT reads a converted tree (``hubert.make_hubert_extractor``)."""

from real3dportrait_tpu_torch.audio.features import (
    extract_f0,
    extract_mel,
    extract_mfcc,
    griffin_lim,
    vad,
)

__all__ = ["extract_f0", "extract_mel", "extract_mfcc", "griffin_lim", "vad"]

"""Training: the GAN task of the SECC-to-plane stage, its losses, optimiser
and loop (port of ``real3dportrait_tpu/training``)."""

from real3dportrait_tpu_torch.training.train_state import TrainState
from real3dportrait_tpu_torch.training.trainer import Trainer

__all__ = ["TrainState", "Trainer"]

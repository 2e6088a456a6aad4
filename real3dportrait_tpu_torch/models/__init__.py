"""PyTorch port of ``real3dportrait_tpu.models``."""

from real3dportrait_tpu_torch.models.audio2motion import (
    FVAE,
    PitchContourVAEModel,
    VAEModel,
)
from real3dportrait_tpu_torch.models.decoder import OSGDecoder
from real3dportrait_tpu_torch.models.eg3d import TriPlaneGenerator
from real3dportrait_tpu_torch.models.img2plane import (
    OSAvatarImg2Plane,
    OSAvatarSECCImg2Plane,
    OSAvatarSECCImg2PlaneTorso,
)
from real3dportrait_tpu_torch.models.segformer import (
    MixVisionTransformer,
    SegFormerImg2PlaneBackbone,
    SegFormerSECC2PlaneBackbone,
)
from real3dportrait_tpu_torch.models.sr_with_ref import SuperresolutionHybrid8XDCWarp
from real3dportrait_tpu_torch.models.syncnet import LandmarkHubertSyncNet, cal_sync_loss
from real3dportrait_tpu_torch.models.torso import PatchDiscriminator, WarpBasedTorsoModel
from real3dportrait_tpu_torch.models.dual_discriminator import DualDiscriminator
from real3dportrait_tpu_torch.models.stylegan2 import (
    Conv2dLayer,
    Discriminator,
    FullyConnectedLayer,
    Generator,
    MappingNetwork,
    MinibatchStdLayer,
    SynthesisBlock,
    SynthesisLayer,
    SynthesisNetwork,
    ToRGBLayer,
    modulated_conv2d,
)
from real3dportrait_tpu_torch.models.superresolution import (
    SuperresolutionHybrid4X,
    SuperresolutionHybrid8XDC,
    filtered_resizing,
    resize_bilinear,
)

__all__ = [
    "OSGDecoder",
    "FVAE",
    "PitchContourVAEModel",
    "VAEModel",
    "TriPlaneGenerator",
    "OSAvatarImg2Plane",
    "OSAvatarSECCImg2Plane",
    "OSAvatarSECCImg2PlaneTorso",
    "MixVisionTransformer",
    "SegFormerImg2PlaneBackbone",
    "SegFormerSECC2PlaneBackbone",
    "SuperresolutionHybrid8XDCWarp",
    "LandmarkHubertSyncNet",
    "cal_sync_loss",
    "WarpBasedTorsoModel",
    "PatchDiscriminator",
    "DualDiscriminator",
    "Conv2dLayer",
    "Discriminator",
    "FullyConnectedLayer",
    "Generator",
    "MappingNetwork",
    "MinibatchStdLayer",
    "SynthesisBlock",
    "SynthesisLayer",
    "SynthesisNetwork",
    "ToRGBLayer",
    "modulated_conv2d",
    "SuperresolutionHybrid4X",
    "SuperresolutionHybrid8XDC",
    "filtered_resizing",
    "resize_bilinear",
]

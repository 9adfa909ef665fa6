"""Model families of the port (so far: the gated ``partial_modality``
model and its encoders)."""

from .densenet3d import DenseNet121_3D
from .encoders import ClinicalEncoder, RNAEncoderCompact, SimpleCNN3D, image_encoder
from .gated import PartialModalityNet

__all__ = [
    "ClinicalEncoder",
    "DenseNet121_3D",
    "PartialModalityNet",
    "RNAEncoderCompact",
    "SimpleCNN3D",
    "image_encoder",
]

"""Model families of the port: all eight of the JAX package's.

| name                    | module         | reference definition                |
|-------------------------|----------------|-------------------------------------|
| RNASeqSurvivalModel     | rnaseq.py      | train_rnaseq_only.py:126-151        |
| ImageOnlyModel          | image_only.py  | generate_km_curves.py:28-54         |
| SimpleFusionModel       | fusion.py      | simple_fusion.py:160-236            |
| FlexibleMultimodalModel | fusion.py      | flexible_multimodal.py:157-256      |
| MultiModalSurvivalNet   | fusion.py      | final_multimodal.py:59-150          |
| PartialModalityNet      | gated.py       | partial_modality_training.py:165-277|
| SimMLMSurvivalNet       | moe.py         | generate_km_curves.py:160-281       |
| MMsurvNet               | mmsurv.py      | none (JAX models/mmsurv.py)         |
"""

from .densenet3d import DenseNet121_3D
from .encoders import (
    ClinicalEncoder,
    RNAEncoderCompact,
    RNAEncoderDeep,
    SimpleCNN3D,
    image_encoder,
)
from .fusion import (
    FlexibleMultimodalModel,
    MultiModalSurvivalNet,
    SimpleFusionModel,
)
from .gated import PartialModalityNet
from .image_only import ImageOnlyModel
from .mmsurv import MMsurvNet
from .moe import SimMLMSurvivalNet
from .rnaseq import RNASeqSurvivalModel

__all__ = [
    "ClinicalEncoder",
    "DenseNet121_3D",
    "FlexibleMultimodalModel",
    "ImageOnlyModel",
    "MMsurvNet",
    "MultiModalSurvivalNet",
    "PartialModalityNet",
    "RNAEncoderCompact",
    "RNAEncoderDeep",
    "RNASeqSurvivalModel",
    "SimMLMSurvivalNet",
    "SimpleCNN3D",
    "SimpleFusionModel",
    "image_encoder",
]

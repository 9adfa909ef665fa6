"""Late-fusion survival models (port of
``multimodal_survival_prediction_tpu/models/fusion.py``):

  SimpleFusionModel       — reference simple_fusion.py:160-236
  FlexibleMultimodalModel — reference flexible_multimodal.py:157-256
  MultiModalSurvivalNet   — reference final_multimodal.py:59-150

The features are concatenated in each reference's own order: [rna, img]
for simple fusion, [img, rna] for the flexible model, [ct, rna, clin] for
the final one. Keys are the reference's (``fusion.{0,1,4,7}`` for the
three-layer head, ``fusion.{0,1,4}`` + ``cox_head`` for the final model).
Each takes the compute ``dtype`` of its layers, as the JAX modules do; the
flexible model's missing-modality blend promotes to float32 there too.
"""

from __future__ import annotations

import torch
from torch import nn

from .encoders import (
    ClinicalEncoder,
    RNAEncoderCompact,
    RNAEncoderDeep,
    image_encoder,
)
from .layers import Dropout, MLPBlock, default_generator, torch_linear


def fusion_head(in_features: int, *, generator: torch.Generator,
                dtype: torch.dtype | None = None):
    """Linear->BN->ReLU->Drop(0.3) -> Linear->ReLU->Drop(0.2) -> Linear(1)
    (reference simple_fusion.py:206-215), keys ``0, 1, 4, 7``."""
    return nn.Sequential(
        *MLPBlock(in_features, 256, dropout=0.3, generator=generator,
                  dtype=dtype),
        torch_linear(256, 128, generator=generator, dtype=dtype), nn.ReLU(),
        Dropout(0.2),
        torch_linear(128, 1, generator=generator, dtype=dtype))


class SimpleFusionModel(nn.Module):
    """``forward(image, rnaseq) -> log-hazard (B,)``: deep RNA encoder (256)
    and CT encoder (128), ``cat([rna, img])``, the fusion head."""

    def __init__(self, rna_dim: int = 5005, backbone: str = "densenet121",
                 block_config: tuple | None = None,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None,
                 remat: bool = False):
        super().__init__()
        gen = default_generator(generator)
        self.rna_encoder = RNAEncoderDeep(rna_dim, generator=gen, dtype=dtype)
        self.image_encoder = image_encoder(128, backbone=backbone,
                                           block_config=block_config,
                                           remat=remat, generator=gen,
                                           dtype=dtype)
        self.fusion = fusion_head(256 + 128, generator=gen, dtype=dtype)

    def forward(self, image, rnaseq):
        fused = torch.cat([self.rna_encoder(rnaseq),
                           self.image_encoder(image)], dim=-1)
        return self.fusion(fused).squeeze(-1)


class FlexibleMultimodalModel(nn.Module):
    """``forward(image, rnaseq, mask (B, 2)) -> log-hazard (B,)``: simple
    fusion with learnable missing-modality vectors,
    ``feature = feat·mask + bias·(1 − mask)`` (reference
    flexible_multimodal.py:205-206, :249-250), then ``cat([img, rna])``.
    The bias vectors are drawn as ``torch.randn``."""

    def __init__(self, rna_dim: int = 5005, backbone: str = "densenet121",
                 block_config: tuple | None = None,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None,
                 remat: bool = False):
        super().__init__()
        gen = default_generator(generator)
        self.image_encoder = image_encoder(128, backbone=backbone,
                                           block_config=block_config,
                                           remat=remat, generator=gen,
                                           dtype=dtype)
        self.rna_encoder = RNAEncoderDeep(rna_dim, generator=gen, dtype=dtype)
        self.missing_image_bias = nn.Parameter(torch.randn(128, generator=gen))
        self.missing_rna_bias = nn.Parameter(torch.randn(256, generator=gen))
        self.fusion = fusion_head(128 + 256, generator=gen, dtype=dtype)

    def forward(self, image, rnaseq, mask):
        img_m, rna_m = mask[:, 0:1], mask[:, 1:2]
        img = (self.image_encoder(image) * img_m
               + self.missing_image_bias[None, :] * (1 - img_m))
        rna = (self.rna_encoder(rnaseq) * rna_m
               + self.missing_rna_bias[None, :] * (1 - rna_m))
        return self.fusion(torch.cat([img, rna], dim=-1)).squeeze(-1)


class MultiModalSurvivalNet(nn.Module):
    """``forward(ct, rna, clinical) -> log-hazard (B,)``: CT (128) + compact
    RNA (128) + clinical (32), ``cat([ct, rna, clin])`` -> fusion
    288 -> 256 -> 128 -> Cox head. No masking, no gate."""

    def __init__(self, rna_dim: int = 5005, backbone: str = "densenet121",
                 block_config: tuple | None = None,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None,
                 remat: bool = False):
        super().__init__()
        gen = default_generator(generator)
        self.ct_encoder = image_encoder(128, backbone=backbone,
                                        block_config=block_config,
                                        remat=remat, generator=gen,
                                        dtype=dtype)
        self.rna_encoder = RNAEncoderCompact(rna_dim, 128, generator=gen,
                                             dtype=dtype)
        self.clinical_encoder = ClinicalEncoder(1, 32, generator=gen,
                                                dtype=dtype)
        self.fusion = nn.Sequential(
            *MLPBlock(128 + 128 + 32, 256, dropout=0.3, generator=gen,
                      dtype=dtype),
            torch_linear(256, 128, generator=gen, dtype=dtype), nn.ReLU())
        self.cox_head = torch_linear(128, 1, generator=gen, dtype=dtype)

    def forward(self, ct, rna, clinical):
        fused = torch.cat([self.ct_encoder(ct), self.rna_encoder(rna),
                           self.clinical_encoder(clinical)], dim=-1)
        return self.cox_head(self.fusion(fused)).squeeze(-1)

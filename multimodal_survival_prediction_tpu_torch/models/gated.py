"""Gated partial-modality network — the flagship model (port of
``multimodal_survival_prediction_tpu/models/gated.py``).

Reference partial_modality_training.py:165-277: encoders run on zero-filled
inputs for missing modalities, features are then zero-masked (:256-259), a
gate MLP over [features ‖ mask] softmaxes to 3 modality weights (:213-218,
:262-263), gate-weighted features are fused, and a Cox head emits the
log-hazard. Returns (hazard, gate_weights).

Train/eval is torch's ``module.train()`` / ``module.eval()`` (the JAX
``train=`` flag).
"""

from __future__ import annotations

import torch
from torch import nn

from .encoders import ClinicalEncoder, RNAEncoderCompact, image_encoder
from .layers import MLPBlock, default_generator, torch_linear


class PartialModalityNet(nn.Module):
    """``forward(ct (B,D,H,W,1), rna (B,rna_dim), clinical (B,1), mask (B,3))
    -> (hazard (B,), gate_weights (B,3))``. ``dropout`` is the rate of the
    RNA encoder's and the fusion block's dropout (0.3 in the reference),
    whose masks come from ``layers.set_dropout_generator``. ``dtype`` is
    the compute dtype of every layer (JAX ``PartialModalityNet(dtype=)``);
    the masked features promote to the mask's float32, as in JAX."""

    def __init__(self, rna_dim: int = 5005, backbone: str = "densenet121",
                 block_config: tuple | None = None, trunk: str = "concat",
                 fused_bn1: bool | int = False, dropout: float = 0.3,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        gen = default_generator(generator)
        self.ct_encoder = image_encoder(128, backbone=backbone,
                                        block_config=block_config,
                                        trunk=trunk, fused_bn1=fused_bn1,
                                        generator=gen, dtype=dtype)
        self.rna_encoder = RNAEncoderCompact(rna_dim, 128, dropout=dropout,
                                             generator=gen, dtype=dtype)
        self.clinical_encoder = ClinicalEncoder(1, 32, generator=gen,
                                                dtype=dtype)
        fused_dim = 128 + 128 + 32
        self.gate = nn.Sequential(
            torch_linear(fused_dim + 3, 64, generator=gen, dtype=dtype),
            nn.ReLU(), torch_linear(64, 3, generator=gen, dtype=dtype))
        self.fusion = nn.Sequential(
            *MLPBlock(fused_dim, 256, dropout=dropout, generator=gen,
                      dtype=dtype),
            torch_linear(256, 128, generator=gen, dtype=dtype), nn.ReLU())
        self.cox_head = torch_linear(128, 1, generator=gen, dtype=dtype)

    def forward(self, ct, rna, clinical, mask):
        # Encoders run on the (possibly zero) inputs FIRST; masking is applied
        # to features afterwards — this ordering matters for BatchNorm
        # statistics and is reproduced deliberately (SURVEY §7 hard parts).
        ct_feat = self.ct_encoder(ct) * mask[:, 0:1]
        rna_feat = self.rna_encoder(rna) * mask[:, 1:2]
        clin_feat = self.clinical_encoder(clinical) * mask[:, 2:3]

        concat = torch.cat([ct_feat, rna_feat, clin_feat, mask], dim=-1)
        gate_weights = torch.softmax(self.gate(concat), dim=-1)

        fused = torch.cat([ct_feat * gate_weights[:, 0:1],
                           rna_feat * gate_weights[:, 1:2],
                           clin_feat * gate_weights[:, 2:3]], dim=-1)
        hazard = self.cox_head(self.fusion(fused)).squeeze(-1)
        return hazard, gate_weights

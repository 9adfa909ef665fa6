"""SimMLM: a dynamic mixture of modality experts with per-expert Cox heads
(port of ``multimodal_survival_prediction_tpu/models/moe.py``; reference
generate_km_curves.py:160-281).

Three ``ModalityExpert``s, each with its own Cox head on its UNMASKED
feature; a ``GatingNetwork`` over [masked features ‖ mask] whose logits of
missing modalities are filled with -1e30 (not -inf: an all-missing row
would give NaN) and whose gates are 0 on an all-missing row; the fused
feature is the gate-weighted sum, scored by the ensemble Cox head.
``forward`` returns ``(ensemble hazard (B,), expert hazards (B, 3) in
[image, rnaseq, clinical] order, gates (B, 3))``. Keys are the reference's
(``expert_image.encoder.*``, ``expert_rnaseq.cox_head.*``,
``gating.gate.{0,3,5}``, ``ensemble_cox``). Every layer takes the compute
``dtype``, as in JAX; the masked features promote to the mask's float32.
"""

from __future__ import annotations

import torch
from torch import nn

from .encoders import RNAEncoderCompact, image_encoder
from .layers import Dropout, default_generator, torch_linear

FEATURE_DIM = 128


class ModalityExpert(nn.Module):
    """``encoder`` (to 128 features) + ``cox_head``;
    ``forward(x) -> (feature, hazard)``."""

    def __init__(self, encoder: nn.Module, *, generator: torch.Generator,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.encoder = encoder
        self.cox_head = torch_linear(FEATURE_DIM, 1, generator=generator,
                                     dtype=dtype)

    def forward(self, x):
        feat = self.encoder(x)
        return feat, self.cox_head(feat).squeeze(-1)


class GatingNetwork(nn.Module):
    """MLP(3·128 + 3 -> 128 -> 64 -> 3), Dropout(0.2) after the first ReLU,
    softmax over the available modalities."""

    def __init__(self, *, generator: torch.Generator,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.gate = nn.Sequential(
            torch_linear(FEATURE_DIM * 3 + 3, 128, generator=generator,
                         dtype=dtype),
            nn.ReLU(), Dropout(0.2),
            torch_linear(128, 64, generator=generator, dtype=dtype),
            nn.ReLU(), torch_linear(64, 3, generator=generator, dtype=dtype))

    def forward(self, concat, mask):
        logits = torch.where(mask == 0, -1e30, self.gate(concat))
        gates = torch.softmax(logits, dim=-1)
        has_any = mask.sum(-1, keepdim=True) > 0
        return torch.where(has_any, gates, 0.0)


class SimMLMSurvivalNet(nn.Module):
    """``forward(image, rnaseq, clinical, mask (B, 3)) -> (ensemble,
    experts, gates)``."""

    def __init__(self, rna_dim: int = 5005, backbone: str = "densenet121",
                 block_config: tuple | None = None,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        gen = default_generator(generator)
        self.expert_image = ModalityExpert(
            image_encoder(FEATURE_DIM, backbone=backbone,
                          block_config=block_config, generator=gen,
                          dtype=dtype),
            generator=gen, dtype=dtype)
        self.expert_rnaseq = ModalityExpert(
            RNAEncoderCompact(rna_dim, FEATURE_DIM, generator=gen,
                              dtype=dtype),
            generator=gen, dtype=dtype)
        self.expert_clinical = ModalityExpert(
            nn.Sequential(
                torch_linear(1, 64, generator=gen, dtype=dtype), nn.ReLU(),
                torch_linear(64, FEATURE_DIM, generator=gen, dtype=dtype),
                nn.ReLU()),
            generator=gen, dtype=dtype)
        self.gating = GatingNetwork(generator=gen, dtype=dtype)
        self.ensemble_cox = torch_linear(FEATURE_DIM, 1, generator=gen,
                                         dtype=dtype)

    def forward(self, image, rnaseq, clinical, mask):
        feat_img, h_img = self.expert_image(image)
        feat_rna, h_rna = self.expert_rnaseq(rnaseq)
        feat_clin, h_clin = self.expert_clinical(clinical)
        feat_img = feat_img * mask[:, 0:1]
        feat_rna = feat_rna * mask[:, 1:2]
        feat_clin = feat_clin * mask[:, 2:3]
        gates = self.gating(
            torch.cat([feat_img, feat_rna, feat_clin, mask], dim=-1), mask)
        fused = (gates[:, 0:1] * feat_img + gates[:, 1:2] * feat_rna
                 + gates[:, 2:3] * feat_clin)
        ensemble = self.ensemble_cox(fused).squeeze(-1)
        return ensemble, torch.stack([h_img, h_rna, h_clin], dim=-1), gates

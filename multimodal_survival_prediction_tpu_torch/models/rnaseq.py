"""RNA-seq-only Cox MLP (port of
``multimodal_survival_prediction_tpu/models/rnaseq.py``; reference
train_rnaseq_only.py:126-151).

MLP 5005 -> 1024 -> 512 -> 256 -> 1; each hidden layer is Linear +
BatchNorm1d + ReLU + Dropout(0.3); the output is one log-hazard. Keys
``mlp.{0,1,4,5,8,9,12}``, the reference's.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import MLPBlock, default_generator, torch_linear


class RNASeqSurvivalModel(nn.Module):
    """``forward(rnaseq (B, rna_dim)) -> log-hazard (B,)``."""

    def __init__(self, rna_dim: int = 5005,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = default_generator(generator)
        self.mlp = nn.Sequential(
            *MLPBlock(rna_dim, 1024, dropout=0.3, generator=gen),
            *MLPBlock(1024, 512, dropout=0.3, generator=gen),
            *MLPBlock(512, 256, dropout=0.3, generator=gen),
            torch_linear(256, 1, generator=gen))

    def forward(self, rnaseq):
        return self.mlp(rnaseq).squeeze(-1)

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
    """``forward(rnaseq (B, rna_dim)) -> log-hazard (B,)`` in compute
    ``dtype`` (JAX ``RNASeqSurvivalModel(dtype=)``)."""

    def __init__(self, rna_dim: int = 5005,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        gen = default_generator(generator)
        self.mlp = nn.Sequential(
            *MLPBlock(rna_dim, 1024, dropout=0.3, generator=gen, dtype=dtype),
            *MLPBlock(1024, 512, dropout=0.3, generator=gen, dtype=dtype),
            *MLPBlock(512, 256, dropout=0.3, generator=gen, dtype=dtype),
            torch_linear(256, 1, generator=gen, dtype=dtype))

    def forward(self, rnaseq):
        return self.mlp(rnaseq).squeeze(-1)

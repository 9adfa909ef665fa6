"""Modality encoders shared by the model families (port of
``multimodal_survival_prediction_tpu/models/encoders.py``).

Each encoder is an ``nn.Sequential`` where the reference's torch model is
one, so its state_dict keys (``rna_encoder.0.weight``, ``ct_encoder.3.bias``,
...) are the reference's:
  * deep RNA: 5005 -> 1024 -> 512 (BN+ReLU+Drop0.3 each) -> 256, final ReLU,
    no final BN (simple_fusion.py:167-179 / flexible_multimodal.py:190-202)
  * compact RNA: 5005 -> 512 (BN+ReLU+Drop0.3) -> 128, final ReLU
    (final_multimodal.py:94-101 / partial_modality_training.py:195-202)
  * clinical: Linear(1 -> 32) + ReLU (final_multimodal.py:104-107)
  * simple CNN: three stride-2 conv/BN/ReLU blocks + global average pool,
    the MONAI-less fallback CT encoder (partial_modality_training.py:179-191)

Each takes the compute ``dtype`` of its layers (JAX ``dtype``;
``models/layers.py``), None for float32.
"""

from __future__ import annotations

import torch
from torch import nn

from .densenet3d import DenseNet121_3D
from .layers import (
    BatchNorm,
    MLPBlock,
    conv3d,
    default_generator,
    mean_f32,
    to_ncdhw,
    torch_linear,
)


class RNAEncoderDeep(nn.Sequential):
    """rna_dim -> 1024 -> 512 (BN+ReLU+Dropout(0.3) each) -> 256, final
    ReLU; keys ``0, 1, 4, 5, 8``."""

    def __init__(self, rna_dim: int,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        gen = default_generator(generator)
        super().__init__(
            *MLPBlock(rna_dim, 1024, dropout=0.3, generator=gen, dtype=dtype),
            *MLPBlock(1024, 512, dropout=0.3, generator=gen, dtype=dtype),
            torch_linear(512, 256, generator=gen, dtype=dtype),
            nn.ReLU())


class RNAEncoderCompact(nn.Sequential):
    """rna_dim -> 512 (BN+ReLU+Dropout) -> out_features, final ReLU."""

    def __init__(self, rna_dim: int, out_features: int = 128,
                 dropout: float = 0.3,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        gen = default_generator(generator)
        super().__init__(
            *MLPBlock(rna_dim, 512, dropout=dropout, generator=gen,
                      dtype=dtype),
            torch_linear(512, out_features, generator=gen, dtype=dtype),
            nn.ReLU())


class ClinicalEncoder(nn.Sequential):
    """Linear(clinical_dim -> 32) + ReLU."""

    def __init__(self, clinical_dim: int = 1, out_features: int = 32,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        gen = default_generator(generator)
        super().__init__(
            torch_linear(clinical_dim, out_features, generator=gen,
                         dtype=dtype),
            nn.ReLU())


class SimpleCNN3D(nn.Sequential):
    """Channels-last (B, D, H, W, 1) -> (B, out_features): three stride-2
    3^3 conv (bias, torch default init) -> BN -> ReLU blocks, then the
    global average pool."""

    def __init__(self, out_features: int = 128, widths: tuple = (32, 64),
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        gen = default_generator(generator)
        mods, in_ch = [], 1
        for w in (*widths, out_features):
            mods += [conv3d(in_ch, w, 3, stride=2, bias=True, kaiming=False,
                            generator=gen, dtype=dtype),
                     BatchNorm(w, dtype=dtype), nn.ReLU()]
            in_ch = w
        super().__init__(*mods)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mean_f32(super().forward(to_ncdhw(x)), (2, 3, 4))


def image_encoder(out_features: int = 128, backbone: str = "densenet121",
                  block_config: tuple | None = None, trunk: str = "concat",
                  fused_bn1: bool | int = False,
                  generator: torch.Generator | None = None,
                  dtype: torch.dtype | None = None) -> nn.Module:
    """The CT encoder — DenseNet121-3D (default, the reference's USE_MONAI
    path) or the simple CNN fallback — as the bare module (the counterpart
    of the JAX ``ImageEncoder``, which wraps it; the reference's keys have
    no wrapper level). ``block_config`` None = DenseNet121's (6, 12, 24, 16)."""
    if backbone == "densenet121":
        kwargs = ({"block_config": block_config}
                  if block_config is not None else {})
        return DenseNet121_3D(out_features=out_features, trunk=trunk,
                              fused_bn1=fused_bn1, generator=generator,
                              dtype=dtype, **kwargs)
    if backbone == "simple_cnn":
        return SimpleCNN3D(out_features=out_features, generator=generator,
                           dtype=dtype)
    raise ValueError(f"unknown backbone {backbone!r}")

"""Image-only small 3D CNN (port of
``multimodal_survival_prediction_tpu/models/image_only.py``; reference
generate_km_curves.py:28-54).

Conv3d 1 -> 16 -> 32 -> 64 (each 3^3/s2 + BN + ReLU), global average pool,
Linear 64 -> 32 + ReLU, risk head 32 -> 1. Keys ``encoder.{0,1,3,4,6,7}``,
``fc.0``, ``risk_head``, the reference's.
"""

from __future__ import annotations

import torch
from torch import nn

from .encoders import SimpleCNN3D
from .layers import default_generator, torch_linear


class ImageOnlyModel(nn.Module):
    """``forward(image (B, D, H, W, 1)) -> log-hazard (B,)`` in compute
    ``dtype`` (JAX ``ImageOnlyModel(dtype=)``)."""

    def __init__(self, generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        gen = default_generator(generator)
        self.encoder = SimpleCNN3D(out_features=64, widths=(16, 32),
                                   generator=gen, dtype=dtype)
        self.fc = nn.Sequential(
            torch_linear(64, 32, generator=gen, dtype=dtype), nn.ReLU())
        self.risk_head = torch_linear(32, 1, generator=gen, dtype=dtype)

    def forward(self, image):
        return self.risk_head(self.fc(self.encoder(image))).squeeze(-1)

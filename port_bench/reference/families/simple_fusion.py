"""Plain reference of ``SimpleFusionModel`` (``simple_fusion.py:160-236``):
an RNA MLP 5,005 -> 1,024 -> 512 -> 256 and a DenseNet121 3D image
encoder to 128, concatenated, through a fusion head to one Cox hazard."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import model as m


def param_spec(arch: dict) -> list:
    spec = []
    m.linear_spec(spec, "rna_encoder.0", arch["rna_dim"], 1024)
    m.bn_spec(spec, "rna_encoder.1", 1024)
    m.linear_spec(spec, "rna_encoder.4", 1024, 512)
    m.bn_spec(spec, "rna_encoder.5", 512)
    m.linear_spec(spec, "rna_encoder.8", 512, 256)
    m.densenet_spec(spec, "image_encoder", arch["densenet"])
    m.linear_spec(spec, "fusion.0", 256 + 128, 256)
    m.bn_spec(spec, "fusion.1", 256)
    m.linear_spec(spec, "fusion.4", 256, 128)
    m.linear_spec(spec, "fusion.7", 128, 1)
    return spec


def forward(ctx: m.Context, w: dict, arch: dict, batch: dict):
    """Late fusion ``cat([rna, image])``: ``(hazard (B,), None)``."""
    rna = m.mlp_cell(ctx, w, "rna_encoder.0", "rna_encoder.1",
                     batch["rnaseq"], 0.3)
    rna = m.mlp_cell(ctx, w, "rna_encoder.4", "rna_encoder.5", rna, 0.3)
    rna = F.relu(m.linear(w, "rna_encoder.8", rna))
    img = m.densenet(ctx, w, "image_encoder", arch["densenet"],
                     batch["image"])
    h = m.mlp_cell(ctx, w, "fusion.0", "fusion.1",
                   torch.cat([rna, img], dim=-1), 0.3)
    h = ctx.dropout(F.relu(m.linear(w, "fusion.4", h)), 0.2)
    return m.linear(w, "fusion.7", h).squeeze(-1), None

"""Plain reference of the Complete Multimodal model,
``MultiModalSurvivalNet`` (``final_multimodal.py:59-150``), with MONAI
SwinUNETR's Swin-ViT as its CT encoder (``reference/swin.py``): the CT
encoder to 128, an RNA MLP to 128 and an age encoder to 32, concatenated
``[ct, rna, clin]`` without masking or gate, a fusion MLP and one Cox
hazard. Its loss is the plain Cox loss: ``forward`` returns no gates."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import model as m
from .. import swin


def param_spec(arch: dict) -> list:
    spec = []
    swin.swin_spec(spec, "ct_encoder", arch["swin"])
    m.linear_spec(spec, "rna_encoder.0", arch["rna_dim"], 512)
    m.bn_spec(spec, "rna_encoder.1", 512)
    m.linear_spec(spec, "rna_encoder.4", 512, 128)
    m.linear_spec(spec, "clinical_encoder.0", 1, 32)
    m.linear_spec(spec, "fusion.0", 128 + 128 + 32, 256)
    m.bn_spec(spec, "fusion.1", 256)
    m.linear_spec(spec, "fusion.4", 256, 128)
    m.linear_spec(spec, "cox_head", 128, 1)
    return spec


def forward(ctx: m.Context, w: dict, arch: dict, batch: dict):
    """``(hazard (B,), None)``."""
    p = arch["dropout"]
    ct = swin.swin(w, "ct_encoder", arch["swin"], batch["image"])
    rna = m.mlp_cell(ctx, w, "rna_encoder.0", "rna_encoder.1",
                     batch["rnaseq"], p)
    rna = F.relu(m.linear(w, "rna_encoder.4", rna))
    clin = F.relu(m.linear(w, "clinical_encoder.0", batch["clinical"]))
    h = m.mlp_cell(ctx, w, "fusion.0", "fusion.1",
                   torch.cat([ct, rna, clin], dim=-1), p)
    h = F.relu(m.linear(w, "fusion.4", h))
    return m.linear(w, "cox_head", h).squeeze(-1), None

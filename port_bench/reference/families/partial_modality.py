"""Plain reference of the gated flagship, ``PartialModalityNet``
(``partial_modality_training.py:165-277``): a DenseNet121 3D CT encoder,
an RNA MLP and an age encoder, each masked by its modality bit, a 3-way
softmax gate over them and a fusion head to one Cox hazard."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import model as m


def param_spec(arch: dict) -> list:
    spec = []
    m.densenet_spec(spec, "ct_encoder", arch["densenet"])
    m.linear_spec(spec, "rna_encoder.0", arch["rna_dim"], 512)
    m.bn_spec(spec, "rna_encoder.1", 512)
    m.linear_spec(spec, "rna_encoder.4", 512, 128)
    m.linear_spec(spec, "clinical_encoder.0", 1, 32)
    m.linear_spec(spec, "gate.0", 128 + 128 + 32 + 3, 64)
    m.linear_spec(spec, "gate.2", 64, 3)
    m.linear_spec(spec, "fusion.0", 128 + 128 + 32, 256)
    m.bn_spec(spec, "fusion.1", 256)
    m.linear_spec(spec, "fusion.4", 256, 128)
    m.linear_spec(spec, "cox_head", 128, 1)
    return spec


def forward(ctx: m.Context, w: dict, arch: dict, batch: dict):
    """``(hazard (B,), gate weights (B, 3))``."""
    p = arch["dropout"]
    mask = batch["mask"]
    ct = m.densenet(ctx, w, "ct_encoder", arch["densenet"], batch["image"])
    ct = ct * mask[:, 0:1]
    rna = m.mlp_cell(ctx, w, "rna_encoder.0", "rna_encoder.1",
                     batch["rnaseq"], p)
    rna = F.relu(m.linear(w, "rna_encoder.4", rna)) * mask[:, 1:2]
    clin = F.relu(m.linear(w, "clinical_encoder.0", batch["clinical"]))
    clin = clin * mask[:, 2:3]
    gate_in = torch.cat([ct, rna, clin, mask], dim=-1)
    gates = torch.softmax(
        m.linear(w, "gate.2", F.relu(m.linear(w, "gate.0", gate_in))),
        dim=-1)
    fused = torch.cat([ct * gates[:, 0:1], rna * gates[:, 1:2],
                       clin * gates[:, 2:3]], dim=-1)
    h = m.mlp_cell(ctx, w, "fusion.0", "fusion.1", fused, p)
    h = F.relu(m.linear(w, "fusion.4", h))
    return m.linear(w, "cox_head", h).squeeze(-1), gates

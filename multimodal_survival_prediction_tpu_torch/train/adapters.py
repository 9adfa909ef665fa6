"""Per-model-family adapters: batch dict -> model inputs, outputs -> (hazard,
auxiliary loss). Port of ``multimodal_survival_prediction_tpu/train/adapters.py``;
only the ``partial_modality`` branch exists so far."""

from __future__ import annotations

import torch

from ..config import ModelRunConfig
from ..models import PartialModalityNet
from ..models.layers import set_dropout_generator
from ..ops.cox import gate_entropy_loss

# ROADMAP.md Queue 1 items that bring each remaining family
_FAMILY_TODO = {
    "rnaseq_only": "Queue 1 item 8 (models/rnaseq.py)",
    "image_only": "Queue 1 item 8 (models/image_only.py)",
    "simple_fusion": "Queue 1 item 8 (models/fusion.py)",
    "flexible_multimodal": "Queue 1 item 8 (models/fusion.py)",
    "final": "Queue 1 item 8 (models/fusion.py)",
    "simmim": "Queue 1 item 8 (models/moe.py)",
    "mmsurv": "Queue 1 item 8 (models/mmsurv.py)",
}


def make_model_and_adapters(cfg: ModelRunConfig, rna_dim: int | None = None,
                            backbone: str = "densenet121",
                            generator: torch.Generator | None = None,
                            dropout_generator: torch.Generator | None = None):
    """Returns ``(model, batch_to_inputs, hazard_and_aux)``; the model is
    built on the CPU (move it with ``.to(device)``), its weights drawn from
    ``generator`` and its dropout masks from ``dropout_generator`` (which
    must live on the device the model trains on)."""
    name = cfg.name
    if name == "partial_modality":
        model = PartialModalityNet(
            rna_dim=rna_dim if rna_dim is not None else cfg.rna_dim,
            backbone=backbone, generator=generator)
        if dropout_generator is not None:
            set_dropout_generator(model, dropout_generator)
        w = cfg.gate_entropy_weight

        def hazard_and_aux(out, batch):
            hazard, gates = out
            # gate entropy over ALL (valid) samples incl. unlabeled
            # (reference partial_modality_training.py:401-422)
            aux = w * gate_entropy_loss(gates, valid=batch["valid"])
            return hazard, aux

        return model, (lambda b: (b["image"], b["rnaseq"], b["clinical"],
                                  b["mask"])), hazard_and_aux
    if name in _FAMILY_TODO:
        raise NotImplementedError(
            f"model family {name!r} is not ported yet: ROADMAP.md "
            f"{_FAMILY_TODO[name]}")
    raise ValueError(f"unknown model {name!r}")

"""Per-model-family adapters: batch dict -> model inputs, outputs -> (hazard,
auxiliary loss). Port of ``multimodal_survival_prediction_tpu/train/adapters.py``:
every family's branch, and SimMLM's stage-1 adapter."""

from __future__ import annotations

import torch

from ..config import ModelRunConfig
from ..models import (
    FlexibleMultimodalModel,
    ImageOnlyModel,
    MMsurvNet,
    MultiModalSurvivalNet,
    PartialModalityNet,
    RNASeqSurvivalModel,
    SimMLMSurvivalNet,
    SimpleFusionModel,
)
from ..models.layers import set_dropout_generator
from ..ops.cox import cox_partial_likelihood, gate_entropy_loss


def _all_inputs(b):
    return b["image"], b["rnaseq"], b["clinical"], b["mask"]


def _expert_cox_mean(experts, batch):
    """Mean over the three experts of each one's Cox loss on the samples
    where its modality is present AND labeled (the MoFe term before λ)."""
    total = 0.0
    for m in range(3):
        total = total + cox_partial_likelihood(
            experts[:, m], batch["time"], batch["event"],
            valid=batch["svalid"] * batch["mask"][:, m])
    return total / 3.0


def make_adapters(cfg: ModelRunConfig):
    """``(batch_to_inputs, hazard_and_aux or None)`` of ``cfg``'s model
    family, without building a model (None: the output is the hazard)."""
    name = cfg.name
    if name == "rnaseq_only":
        return (lambda b: (b["rnaseq"],)), None
    if name == "image_only":
        return (lambda b: (b["image"],)), None
    if name == "simple_fusion":
        return (lambda b: (b["image"], b["rnaseq"])), None
    if name == "flexible_multimodal":
        # mask: [has_image, has_rnaseq] (reference flexible_multimodal.py:142)
        return (lambda b: (b["image"], b["rnaseq"], b["mask"][:, :2])), None
    if name == "final":
        return (lambda b: (b["image"], b["rnaseq"], b["clinical"])), None
    if name == "partial_modality":
        w = cfg.gate_entropy_weight

        def hazard_and_aux(out, batch):
            hazard, gates = out
            # gate entropy over ALL (valid) samples incl. unlabeled
            # (reference partial_modality_training.py:401-422)
            aux = w * gate_entropy_loss(gates, valid=batch["valid"])
            return hazard, aux

        return _all_inputs, hazard_and_aux
    if name == "simmim":
        lam = cfg.mofe_lambda

        def hazard_and_aux(out, batch):
            # MoFe: the ensemble's Cox loss + λ · the experts' mean Cox loss
            # (reconstructed from the per-expert Cox heads, reference
            # generate_km_curves.py:208, and mofe_lambda in
            # results/simmim/cv_results.json)
            ensemble, experts, _ = out
            return ensemble, lam * _expert_cox_mean(experts, batch)

        return _all_inputs, hazard_and_aux
    if name == "mmsurv":
        return _all_inputs, None
    raise ValueError(f"unknown model {name!r}")


def simmlm_stage1_adapter():
    """SimMLM stage 1 (expert pretraining): the experts' mean Cox loss
    alone, the ensemble head's term off (``main_scale`` 0), as in the
    two-stage schedule of results/simmim/cv_results.json
    (stage1_epochs=30 before the 50 stage-2 epochs)."""

    def hazard_and_aux(out, batch):
        ensemble, experts, _ = out
        return ensemble, _expert_cox_mean(experts, batch), 0.0

    return hazard_and_aux


_IMAGE_MODELS = {
    "simple_fusion": SimpleFusionModel,
    "flexible_multimodal": FlexibleMultimodalModel,
    "final": MultiModalSurvivalNet,
    "partial_modality": PartialModalityNet,
    "simmim": SimMLMSurvivalNet,
    "mmsurv": MMsurvNet,
}


def _build_model(name, rna_dim, backbone, generator, dtype):
    if name == "rnaseq_only":
        return RNASeqSurvivalModel(rna_dim=rna_dim, generator=generator,
                                   dtype=dtype)
    if name == "image_only":  # its own small CNN, no backbone choice
        return ImageOnlyModel(generator=generator, dtype=dtype)
    return _IMAGE_MODELS[name](rna_dim=rna_dim, backbone=backbone,
                               generator=generator, dtype=dtype)


def make_model_and_adapters(cfg: ModelRunConfig, rna_dim: int | None = None,
                            backbone: str = "densenet121",
                            generator: torch.Generator | None = None,
                            dropout_generator: torch.Generator | None = None,
                            dtype: torch.dtype | None = None):
    """Returns ``(model, batch_to_inputs, hazard_and_aux)``; the model is
    built on the CPU (move it with ``.to(device)``), its weights drawn from
    ``generator`` and its dropout masks from ``dropout_generator`` (which
    must live on the device the model trains on). ``dtype`` is the compute
    dtype every family takes (None: float32; the JAX ``dtype``), the
    parameters stay float32."""
    batch_to_inputs, hazard_and_aux = make_adapters(cfg)
    model = _build_model(cfg.name,
                         rna_dim if rna_dim is not None else cfg.rna_dim,
                         backbone, generator, dtype)
    if dropout_generator is not None:
        set_dropout_generator(model, dropout_generator)
    return model, batch_to_inputs, hazard_and_aux

"""The program under test for the ``simple_fusion`` family: the port's
``SimpleFusionModel`` at the configuration's widths (it has no fused
stages)."""

from __future__ import annotations


def model(cfg: dict, generator=None):
    from multimodal_survival_prediction_tpu_torch.models import (
        SimpleFusionModel,
    )

    if cfg["fused_bn1"]:
        raise ValueError("simple_fusion has no fused_bn1 option")
    arch = cfg["arch"]
    return SimpleFusionModel(
        rna_dim=arch["rna_dim"], backbone="densenet121",
        block_config=tuple(arch["densenet"]["block_config"]),
        generator=generator)

"""The program under test for the ``partial_modality`` family: the port's
``PartialModalityNet`` at the configuration's widths."""

from __future__ import annotations


def model(cfg: dict, generator=None):
    from multimodal_survival_prediction_tpu_torch.models import (
        PartialModalityNet,
    )

    arch = cfg["arch"]
    return PartialModalityNet(
        rna_dim=arch["rna_dim"], backbone="densenet121",
        block_config=tuple(arch["densenet"]["block_config"]),
        fused_bn1=bool(cfg["fused_bn1"]), dropout=arch["dropout"],
        generator=generator)

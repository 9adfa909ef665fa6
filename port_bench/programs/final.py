"""The program under test for the ``final`` family: the port's
``MultiModalSurvivalNet`` (the Complete Multimodal model) with the
Swin-ViT CT encoder (``backbone="swin_vit"``) at the configuration's
widths, which must be the port's published ones."""

from __future__ import annotations


def model(cfg: dict, generator=None):
    from multimodal_survival_prediction_tpu_torch.models import (
        MultiModalSurvivalNet,
    )
    from multimodal_survival_prediction_tpu_torch.models.swin3d import (
        PUBLISHED,
    )

    if cfg["fused_bn1"]:
        raise ValueError("the Swin-ViT encoder has no fused_bn1 option")
    arch = cfg["arch"]
    swin = dict(arch["swin"])
    if swin.pop("out_features") != 128 or arch["dropout"] != 0.3:
        raise ValueError("MultiModalSurvivalNet's CT features are 128 wide "
                         "and its dropout 0.3")
    published = {k: list(v) if isinstance(v, tuple) else v
                 for k, v in PUBLISHED.items()}
    if swin != published:
        raise ValueError(f"arch.swin {swin} differs from the port's Swin-ViT "
                         f"widths {published}")
    return MultiModalSurvivalNet(rna_dim=arch["rna_dim"],
                                 backbone="swin_vit", generator=generator)

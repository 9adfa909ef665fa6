"""Per-model configuration with defaults equal to the reference's
module-level constants (SURVEY §2.6, §2.11 — the reference's "config system"
is SCREAMING_SNAKE constants per script; here they are dataclasses with the
same values).

The PyTorch port's own copy of ``multimodal_survival_prediction_tpu/config.py``
(the port imports nothing from the JAX package); the values must stay equal,
which ``tests/test_torch_data.py`` checks."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ModelRunConfig:
    name: str
    display_name: str
    batch_size: int
    learning_rate: float
    weight_decay: float
    optimizer: str  # 'adam' | 'adamw'
    num_epochs: int
    n_folds: int
    scheduler: str  # 'plateau' | 'cosine'
    patience: int | None  # early-stop patience (None = run all epochs)
    grad_clip: float | None
    modalities: tuple
    gate_entropy_weight: float = 0.0
    mofe_lambda: float = 0.0
    include_unlabeled_in_train: bool = False
    stage1_epochs: int = 0  # expert-pretraining epochs before the main run
    rna_dim: int = 5005
    image_shape: tuple = (64, 64, 32)
    seed: int = 42
    # Cox ties handling: 'breslow' (reference parity — torchsurv's default,
    # final_multimodal.py:178-183 sorted-logcumsumexp form) or 'efron'
    # (ops/cox.py, more accurate under tied event times; day-resolution
    # survival data ties often)
    ties: str = "breslow"


# Reference constants, per script:
RNASEQ_ONLY = ModelRunConfig(
    # reference train_rnaseq_only.py:84-88, :271-272 (AdamW wd=1e-3, cosine,
    # no grad clip, no early stop)
    name="rnaseq_only", display_name="RNASeq-Only",
    batch_size=16, learning_rate=1e-4, weight_decay=1e-3, optimizer="adamw",
    num_epochs=50, n_folds=3, scheduler="cosine", patience=None,
    grad_clip=None, modalities=("rnaseq",),
)

SIMPLE_FUSION = ModelRunConfig(
    # reference simple_fusion.py:87-91, :391 (AdamW wd=1e-3), clip 1.0
    name="simple_fusion", display_name="Simple Fusion (RNA+Image)",
    batch_size=8, learning_rate=1e-4, weight_decay=1e-3, optimizer="adamw",
    num_epochs=50, n_folds=3, scheduler="cosine", patience=None,
    grad_clip=1.0, modalities=("image", "rnaseq"),
)

FLEXIBLE_MULTIMODAL = ModelRunConfig(
    # reference flexible_multimodal.py:81-85
    name="flexible_multimodal", display_name="Flexible Multimodal",
    batch_size=16, learning_rate=1e-4, weight_decay=1e-3, optimizer="adamw",
    num_epochs=50, n_folds=3, scheduler="cosine", patience=None,
    grad_clip=1.0, modalities=("image", "rnaseq"),
)

FINAL_MULTIMODAL = ModelRunConfig(
    # reference final_multimodal.py:221-225, :350-351 (Adam wd=1e-4,
    # plateau on val C-index, patience 15 early stop)
    name="final", display_name="Complete Multimodal",
    batch_size=4, learning_rate=1e-4, weight_decay=1e-4, optimizer="adam",
    num_epochs=50, n_folds=5, scheduler="plateau", patience=15,
    grad_clip=1.0, modalities=("image", "rnaseq", "clinical"),
)

PARTIAL_MODALITY = ModelRunConfig(
    # reference partial_modality_training.py:364-369 (N_FOLDS=3 declared;
    # shipped results used 5 — SURVEY §2.13; default here matches the code)
    name="partial_modality", display_name="Partial Modality (Gated)",
    batch_size=8, learning_rate=1e-4, weight_decay=1e-4, optimizer="adam",
    num_epochs=50, n_folds=3, scheduler="plateau", patience=15,
    grad_clip=1.0, modalities=("image", "rnaseq", "clinical"),
    gate_entropy_weight=0.01, include_unlabeled_in_train=True,
)

IMAGE_ONLY = ModelRunConfig(
    # no reference training script; results/image_only: 5 folds
    name="image_only", display_name="Image-Only",
    batch_size=8, learning_rate=1e-4, weight_decay=1e-4, optimizer="adam",
    num_epochs=50, n_folds=5, scheduler="plateau", patience=15,
    grad_clip=1.0, modalities=("image",),
)

SIMMLM = ModelRunConfig(
    # hyperparameters from results/simmim/cv_results.json (SURVEY §2.4):
    # two-stage 30+50 epochs, mofe_lambda=0.1, bs=8, 3 folds
    name="simmim", display_name="SimMLM",
    batch_size=8, learning_rate=1e-4, weight_decay=1e-4, optimizer="adam",
    num_epochs=50, n_folds=3, scheduler="plateau", patience=15,
    grad_clip=1.0, modalities=("image", "rnaseq", "clinical"),
    mofe_lambda=0.1, stage1_epochs=30,
)

MMSURV = ModelRunConfig(
    # hyperparameters from results/mmsurv/cv_results.json: bs=8, lr=1e-3,
    # wd=1e-4, dropout 0.5, 3 folds
    name="mmsurv", display_name="MMsurv",
    batch_size=8, learning_rate=1e-3, weight_decay=1e-4, optimizer="adam",
    num_epochs=50, n_folds=3, scheduler="plateau", patience=15,
    grad_clip=1.0, modalities=("image", "rnaseq", "clinical"),
)

ALL_CONFIGS = {
    c.name: c
    for c in (RNASEQ_ONLY, SIMPLE_FUSION, FLEXIBLE_MULTIMODAL,
              FINAL_MULTIMODAL, PARTIAL_MODALITY, IMAGE_ONLY, SIMMLM, MMSURV)
}

"""Gated partial-modality training over ALL patients (parity with reference scripts/training/partial_modality_training.py: zero-masked modalities, gate network with entropy regularizer 0.01, unlabeled patients appended to every fold's train set, bs=8).

    python -m multimodal_survival_prediction_tpu_torch.train.partial_modality_training \\
        --data-root <root> --pallas-resample

The port's counterpart of ``scripts/training/partial_modality_training.py``;
flags in ``train/cli.py``.
"""

from __future__ import annotations

from .cli import base_parser, run_training


def main(argv=None):
    args = base_parser(__doc__.splitlines()[0]).parse_args(argv)
    from ..config import PARTIAL_MODALITY

    return run_training(args, PARTIAL_MODALITY)


if __name__ == "__main__":
    main()

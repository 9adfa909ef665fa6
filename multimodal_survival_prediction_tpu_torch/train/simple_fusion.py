"""Simple late fusion RNA+Image (parity with reference scripts/training/simple_fusion.py: deep RNA encoder 5005-1024-512-256 + DenseNet121-3D image encoder, fusion head, bs=8, AdamW, 3-fold CV over has_imaging & has_rnaseq & has_survival patients).

    python -m multimodal_survival_prediction_tpu_torch.train.simple_fusion \\
        --data-root <root> --pallas-resample

The port's counterpart of ``scripts/training/simple_fusion.py``;
flags in ``train/cli.py``.
"""

from __future__ import annotations

from .cli import base_parser, run_training


def main(argv=None):
    args = base_parser(__doc__.splitlines()[0]).parse_args(argv)
    from ..config import SIMPLE_FUSION

    return run_training(args, SIMPLE_FUSION)


if __name__ == "__main__":
    main()

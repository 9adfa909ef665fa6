"""Complete multimodal late fusion (parity with reference scripts/training/final_multimodal.py: CT DenseNet121-3D + RNA 5005-512-128 + clinical 1-32, fusion 288-256-128, Adam lr=1e-4 wd=1e-4, ReduceLROnPlateau on val C-index, early stop patience 15, bs=4, 5-fold CV; reads data/processed/multimodal_matching_table.csv where it exists).

    python -m multimodal_survival_prediction_tpu_torch.train.final_multimodal \\
        --data-root <root> --pallas-resample

The port's counterpart of ``scripts/training/final_multimodal.py``;
flags in ``train/cli.py``.
"""

from __future__ import annotations

from .cli import base_parser, run_training


def main(argv=None):
    args = base_parser(__doc__.splitlines()[0]).parse_args(argv)
    from ..config import FINAL_MULTIMODAL

    return run_training(args, FINAL_MULTIMODAL)


if __name__ == "__main__":
    main()

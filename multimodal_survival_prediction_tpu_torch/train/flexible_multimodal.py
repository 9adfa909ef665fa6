"""Flexible multimodal with learnable missing-modality bias vectors (parity with reference scripts/training/flexible_multimodal.py: feature = feat*mask + bias*(1-mask), bs=16, 3-fold CV over all survival-labeled patients).

    python -m multimodal_survival_prediction_tpu_torch.train.flexible_multimodal \\
        --data-root <root> --pallas-resample

The port's counterpart of ``scripts/training/flexible_multimodal.py``;
flags in ``train/cli.py``.
"""

from __future__ import annotations

from .cli import base_parser, run_training


def main(argv=None):
    args = base_parser(__doc__.splitlines()[0]).parse_args(argv)
    from ..config import FLEXIBLE_MULTIMODAL

    return run_training(args, FLEXIBLE_MULTIMODAL)


if __name__ == "__main__":
    main()

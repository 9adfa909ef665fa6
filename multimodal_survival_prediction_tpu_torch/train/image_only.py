"""Image-only small 3D CNN (model from reference scripts/analysis/generate_km_curves.py:28-54; training script absent from the reference - reconstructed per results/image_only/cv_results.json: 5 folds, legacy results schema).

    python -m multimodal_survival_prediction_tpu_torch.train.image_only \\
        --data-root <root> --pallas-resample

The port's counterpart of ``scripts/training/image_only.py``;
flags in ``train/cli.py``.
"""

from __future__ import annotations

from .cli import base_parser, run_training


def main(argv=None):
    args = base_parser(__doc__.splitlines()[0]).parse_args(argv)
    from ..config import IMAGE_ONLY

    return run_training(args, IMAGE_ONLY)


if __name__ == "__main__":
    main()

"""SimMLM mixture-of-modality-experts with per-expert Cox heads, masked-softmax gating and MoFe auxiliary loss (model from reference scripts/analysis/generate_km_curves.py:160-281; training script absent - reconstructed per results/simmim/cv_results.json hyperparameters: 30 stage-1 epochs of the experts alone, then 50, mofe_lambda=0.1).

    python -m multimodal_survival_prediction_tpu_torch.train.simmlm \\
        --data-root <root> --pallas-resample

The port's counterpart of ``scripts/training/simmlm.py``;
flags in ``train/cli.py``.
"""

from __future__ import annotations

from .cli import base_parser, run_training


def main(argv=None):
    args = base_parser(__doc__.splitlines()[0]).parse_args(argv)
    from ..config import SIMMLM

    return run_training(args, SIMMLM)


if __name__ == "__main__":
    main()

"""RNA-seq-only survival training (parity with reference scripts/training/train_rnaseq_only.py: MLP 5005->1024->512->256->1, AdamW lr=1e-4 wd=1e-3, cosine schedule, bs=16, 3-fold CV, 50 epochs, cohort = has_rnaseq & has_survival; writes results/rnaseq_only/cv_results.json).

    python -m multimodal_survival_prediction_tpu_torch.train.train_rnaseq_only \\
        --data-root <root>

The port's counterpart of ``scripts/training/train_rnaseq_only.py``;
flags in ``train/cli.py``.
"""

from __future__ import annotations

from .cli import base_parser, run_training


def main(argv=None):
    args = base_parser(__doc__.splitlines()[0]).parse_args(argv)
    from ..config import RNASEQ_ONLY

    return run_training(args, RNASEQ_ONLY)


if __name__ == "__main__":
    main()

"""MMsurv Compact Bilinear Pooling + transformer fusion (no reference implementation exists - metadata-only model, results/mmsurv/cv_results.json: bs=8 lr=1e-3 wd=1e-4 dropout=0.5).

    python -m multimodal_survival_prediction_tpu_torch.train.mmsurv \\
        --data-root <root> --pallas-resample

The port's counterpart of ``scripts/training/mmsurv.py``;
flags in ``train/cli.py``.
"""

from __future__ import annotations

from .cli import base_parser, run_training


def main(argv=None):
    args = base_parser(__doc__.splitlines()[0]).parse_args(argv)
    from ..config import MMSURV

    return run_training(args, MMSURV)


if __name__ == "__main__":
    main()

"""Test-set evaluation from a predictions CSV (port of
``scripts/analysis/evaluate_model.py``): columns patient_id, risk_score,
survival_time, event -> C-index, median-split risk groups, per-group KM
curves + log-rank, and ``evaluation_summary.json``:

    python -m multimodal_survival_prediction_tpu_torch.analysis.evaluate_model \\
        --predictions results/test_predictions.csv

The figures (KM panels, risk distributions: ``analysis/figures.py`` in the
JAX package, matplotlib) are not ported: this entry point logs that it
skips them.
"""

from __future__ import annotations

import logging
from pathlib import Path

from .evaluate import evaluate_predictions, read_predictions_csv
from .generate_km_curves import base_parser

log = logging.getLogger(__name__)


def main(argv=None) -> dict:
    p = base_parser(__doc__.splitlines()[0])
    p.add_argument("--predictions", default="results/test_predictions.csv")
    args = p.parse_args(argv)

    pred_path = Path(args.predictions)
    if not pred_path.exists():
        raise SystemExit(f"predictions file not found: {pred_path}")
    pred = read_predictions_csv(pred_path)
    out = Path(args.out_dir or Path(args.results_root) / "evaluation")
    summary = evaluate_predictions(pred, out_dir=out)
    log.info("figures (km_risk_groups.png, kaplan_meier_curves.png, "
             "risk_distributions.png) skipped: analysis/figures.py is not "
             "ported (ROADMAP.md Queue 1 item 11)")
    print(f"C-index: {summary['c_index']:.4f}")
    print(f"log-rank p: {summary['logrank']['p_value']:.4g}")
    print(f"evaluation_summary.json -> {out}")
    return summary


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()

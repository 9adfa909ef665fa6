"""Test-set evaluation from a predictions CSV (port of
``scripts/analysis/evaluate_model.py``): columns patient_id, risk_score,
survival_time, event -> C-index, median-split risk groups, per-group KM
curves + log-rank, and ``evaluation_summary.json``:

    python -m multimodal_survival_prediction_tpu_torch.analysis.evaluate_model \\
        --predictions results/test_predictions.csv

The figures (``km_risk_groups.png``, ``kaplan_meier_curves.png``,
``risk_distributions.png``) need matplotlib; without it one line says they
were skipped.
"""

from __future__ import annotations

import logging
from pathlib import Path

from . import load_figures
from .evaluate import (
    evaluate_predictions,
    km_event_types,
    km_groups,
    read_predictions_csv,
)
from .generate_km_curves import base_parser

EVALUATION_FIGURES = ("km_risk_groups.png, kaplan_meier_curves.png, "
                      "risk_distributions.png")


def draw_evaluation_figures(pred: dict, out: Path,
                            km_title: str = "KM by risk group") -> None:
    """The evaluation battery's three figures of a predictions table under
    ``out`` (JAX ``scripts/analysis/evaluate_model.py``), or one line that
    skips them without matplotlib."""
    figures = load_figures(EVALUATION_FIGURES)
    if figures is None:
        return
    hi, lo, lr = km_groups(pred)
    figures.km_plot({"high risk": hi, "low risk": lo},
                    out / "km_risk_groups.png", title=km_title,
                    pvalue=lr.p_value)
    # 2-panel figure: risk groups + per-event-type curves (reference
    # evaluate_model.py:74-118 -> kaplan_meier_curves.png)
    figures.kaplan_meier_panels(
        {"Low Risk": lo, "High Risk": hi}, km_event_types(pred),
        out / "kaplan_meier_curves.png", pvalue=lr.p_value)
    figures.risk_distributions(pred, out / "risk_distributions.png")


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
    draw_evaluation_figures(pred, out)
    print(f"C-index: {summary['c_index']:.4f}")
    print(f"log-rank p: {summary['logrank']['p_value']:.4g}")
    print(f"evaluation_summary.json -> {out}")
    return summary


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()

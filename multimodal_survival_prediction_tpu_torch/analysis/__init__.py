"""Evaluation and comparison of trained models (port of
``multimodal_survival_prediction_tpu/analysis``: ``evaluate.py``,
``comparison.py`` and their entry points ``generate_km_curves``,
``evaluate_model`` and ``final_comparison``; ``figures.py`` is not ported
yet, ROADMAP.md Queue 1 item 11)."""

from .comparison import (
    collect_results,
    export_results_json,
    generate_summary_md,
    paired_t_vs_best,
    pairwise_significance,
)
from .evaluate import evaluate_predictions

__all__ = ["collect_results", "evaluate_predictions", "export_results_json",
           "generate_summary_md", "paired_t_vs_best",
           "pairwise_significance"]

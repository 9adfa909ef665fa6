"""Evaluation and comparison of trained models (port of
``multimodal_survival_prediction_tpu/analysis``: ``evaluate.py``,
``comparison.py``, ``figures.py`` and their entry points
``generate_km_curves``, ``evaluate_model``, ``final_comparison``,
``analyze_all_results``, ``comprehensive_analysis`` and
``create_report_figures``).

``figures.py`` needs matplotlib, which the card's machine lacks: the entry
points load it through :func:`load_figures` and write their tables
without it."""

import logging

from .comparison import (
    collect_results,
    export_results_json,
    generate_summary_md,
    paired_t_vs_best,
    pairwise_significance,
)
from .evaluate import evaluate_predictions

log = logging.getLogger(__name__)


def load_figures(skipped: str):
    """``analysis.figures``, or None where matplotlib does not import: then
    one warning names the missing matplotlib and the figures ``skipped``."""
    try:
        from . import figures
    except ImportError as e:
        if not (e.name or "").startswith("matplotlib"):
            raise
        log.warning("figures %s skipped: matplotlib is not installed (%s)",
                    skipped, e)
        return None
    return figures


__all__ = ["collect_results", "evaluate_predictions", "export_results_json",
           "generate_summary_md", "load_figures", "paired_t_vs_best",
           "pairwise_significance"]

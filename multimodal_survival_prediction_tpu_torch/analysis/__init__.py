"""Evaluation of scored cohorts (port of
``multimodal_survival_prediction_tpu/analysis``: ``evaluate.py`` and its two
entry points; ``comparison.py`` and ``figures.py`` are not ported yet)."""

from .evaluate import evaluate_predictions

__all__ = ["evaluate_predictions"]

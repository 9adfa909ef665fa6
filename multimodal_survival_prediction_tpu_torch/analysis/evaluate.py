"""Test-set evaluation from a predictions table (port of
``multimodal_survival_prediction_tpu/analysis/evaluate.py``).

The table is a dict of numpy columns — ``patient_id``, ``risk_score``,
``survival_time``, ``event`` — as ``train.predict.predict_risk`` returns it
and :func:`read_predictions_csv` reads it, where the JAX package takes a
DataFrame. The C-index, the median split into High/Low risk groups (strict
``>``, reference evaluate_model.py:58-60), each group's KM curve, the
log-rank test and ``evaluation_summary.json`` (the same keys and values,
inf/nan written as null) follow the JAX module.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..data.matching_table import format_cell, read_csv_rows
from ..ops.cindex import concordance_index_np
from ..ops.km import kaplan_meier, logrank_test

PREDICTION_COLUMNS = ("patient_id", "risk_score", "survival_time", "event")


def _columns(pred: dict):
    return (np.asarray(pred["risk_score"], np.float64),
            np.asarray(pred["survival_time"], np.float64),
            np.asarray(pred["event"], np.float64))


def evaluate_predictions(pred: dict, out_dir=None) -> dict:
    """The evaluation summary of a predictions table; written to
    ``<out_dir>/evaluation_summary.json`` when ``out_dir`` is given."""
    risk, time, event = _columns(pred)
    cindex = concordance_index_np(risk, time, event)

    median_risk = float(np.median(risk))
    high = risk > median_risk
    low = ~high

    km_high = kaplan_meier(time[high], event[high])
    km_low = kaplan_meier(time[low], event[low])
    lr = logrank_test(time[high], event[high], time[low], event[low])

    summary = {
        "n_patients": int(len(risk)),
        "n_events": int(event.sum()),
        "c_index": cindex,
        "median_risk_score": median_risk,
        "risk_groups": {
            "high": {
                "n": int(high.sum()),
                "events": int(event[high].sum()),
                "median_survival": km_high.median_survival_time,
            },
            "low": {
                "n": int(low.sum()),
                "events": int(event[low].sum()),
                "median_survival": km_low.median_survival_time,
            },
        },
        "logrank": {"statistic": lr.test_statistic, "p_value": lr.p_value},
        "risk_score_stats": {
            "mean": float(risk.mean()), "std": float(risk.std()),
            "min": float(risk.min()), "max": float(risk.max()),
        },
    }
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "evaluation_summary.json").write_text(
            json.dumps(_sanitize(summary), indent=2))
    return summary


def _sanitize(o):
    """inf/nan -> None so the JSON stays standards-compliant (median survival
    is inf when the KM curve never crosses 0.5)."""
    if isinstance(o, dict):
        return {k: _sanitize(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_sanitize(v) for v in o]
    if isinstance(o, float) and not np.isfinite(o):
        return None
    return o


def km_groups(pred: dict):
    """(km_high, km_low, logrank) of the median split."""
    risk, time, event = _columns(pred)
    hi = risk > np.median(risk)
    return (kaplan_meier(time[hi], event[hi]),
            kaplan_meier(time[~hi], event[~hi]),
            logrank_test(time[hi], event[hi], time[~hi], event[~hi]))


def km_event_types(pred: dict) -> dict:
    """{label: KaplanMeier} of the censored and the death subsets
    (reference evaluate_model.py:99-112; the censored-only curve stays at
    1.0 by construction). Subsets with no patients are omitted."""
    _, time, event = _columns(pred)
    curves = {}
    for label, val in (("Censored", 0), ("Death", 1)):
        mask = event == val
        if mask.sum() > 0:
            curves[label] = kaplan_meier(time[mask], event[mask])
    return curves


def write_predictions_csv(path, pred: dict) -> None:
    """The four prediction columns as CSV (each float written exactly)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    cols = [np.asarray(pred[c]) for c in PREDICTION_COLUMNS]
    lines = [",".join(PREDICTION_COLUMNS)]
    for row in zip(*cols):
        lines.append(",".join(
            format_cell(v.item() if isinstance(v, np.generic) else v)
            for v in row))
    path.write_text("\n".join(lines) + "\n")


def read_predictions_csv(path) -> dict:
    """A predictions CSV (the columns above; others are ignored) as numpy
    columns: patient ids as strings, the rest float64."""
    rows = read_csv_rows(path)
    missing = [c for c in PREDICTION_COLUMNS if rows and c not in rows[0]]
    if missing or not rows:
        raise ValueError(f"{path}: no prediction rows with columns "
                         f"{PREDICTION_COLUMNS} (missing {missing})")
    out = {"patient_id": np.asarray([r["patient_id"] for r in rows],
                                    dtype=object)}
    for c in PREDICTION_COLUMNS[1:]:
        out[c] = np.asarray([float(r[c]) for r in rows], np.float64)
    return out

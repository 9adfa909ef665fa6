"""cv_results.json writers and reader (port of
``multimodal_survival_prediction_tpu/io/results.py``), with both schemas:

  * standard: model / extra keys (n_folds, num_epochs, dataset_size, ...) /
    c_index_mean / c_index_std / fold_results / hyperparameters;
  * legacy (image_only): no "model" and no "hyperparameters", just
    c_index_mean / c_index_std and bare fold_results.

The reader takes both. The std is the population std (numpy's default).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def build_cv_payload(model_display_name: str | None, fold_results: list,
                     hyperparameters: dict | None = None,
                     extra: dict | None = None, legacy: bool = False) -> dict:
    """The cv_results payload, without touching the filesystem."""
    cs = np.array([f["best_c_index"] for f in fold_results], np.float64)
    payload: dict = {}
    if not legacy and model_display_name is not None:
        payload["model"] = model_display_name
    if extra:
        payload.update(extra)
    payload["c_index_mean"] = float(cs.mean())
    payload["c_index_std"] = float(cs.std())
    payload["fold_results"] = fold_results
    if hyperparameters and not legacy:
        payload["hyperparameters"] = hyperparameters
    return payload


def write_cv_results(out_dir, model_display_name: str | None,
                     fold_results: list, hyperparameters: dict | None = None,
                     extra: dict | None = None, legacy: bool = False) -> dict:
    """Write ``<out_dir>/cv_results.json``; fold_results is a list of
    ``{"fold": k, "best_c_index": ..., ...}``. Returns the payload."""
    payload = build_cv_payload(model_display_name, fold_results,
                               hyperparameters=hyperparameters, extra=extra,
                               legacy=legacy)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "cv_results.json", "w") as f:
        json.dump(payload, f, indent=2)
    return payload


def load_cv_results(path) -> dict:
    """Read either schema from a file or its directory: model (the
    directory's name for the legacy schema), c_index_mean / c_index_std
    (from the fold scores where absent), fold_scores, hyperparameters and
    the raw payload."""
    path = Path(path)
    if path.is_dir():
        path = path / "cv_results.json"
    with open(path) as f:
        raw = json.load(f)
    folds = raw.get("fold_results", [])
    scores = [f.get("best_c_index", f.get("c_index")) for f in folds]
    scores = [s for s in scores if s is not None]
    return {
        "model": raw.get("model", path.parent.name),
        "c_index_mean": raw.get(
            "c_index_mean", float(np.mean(scores)) if scores else float("nan")),
        "c_index_std": raw.get(
            "c_index_std", float(np.std(scores)) if scores else float("nan")),
        "fold_scores": scores,
        "hyperparameters": raw.get("hyperparameters", {}),
        "raw": raw,
    }

"""Model comparison statistics + SUMMARY.md / results.json generation (port
of ``multimodal_survival_prediction_tpu/analysis/comparison.py`` on lists of
dicts, numpy and ``scipy.stats``).

Functional equivalent of reference scripts/training/final_comparison.py:
schema-tolerant loading (:46-60), paired t-tests vs the best model (:69-85),
dataset stats from the matching table (:93-111), SUMMARY.md (:261-347) and
results.json export (:353-374) — as library functions over explicit inputs.

A results table is a list of dicts, one a model, with the keys of the JAX
frame's columns (``key``, ``model``, ``c_index_mean``, ``c_index_std``,
``fold_scores``, ``n_folds``, ``hyperparameters``, ``raw``), sorted by mean
C-index, best first (ties keep the directories' order, as pandas' sort
does for so few rows).
"""

from __future__ import annotations

import json
import math
from datetime import datetime
from pathlib import Path

import numpy as np
from scipy import stats as sstats

from ..data.matching_table import cohort_stats
from ..io.results import load_cv_results
from ..preprocess.tables import from_records, write_table


def collect_results(results_root, model_dirs=None) -> list:
    """Load every <results_root>/<model>/cv_results.json (both schema
    variants) into a list of dicts sorted by mean C-index, best first
    (NaN last)."""
    results_root = Path(results_root)
    if model_dirs is None:
        model_dirs = sorted(
            p.parent.name for p in results_root.glob("*/cv_results.json"))
    rows = []
    for d in model_dirs:
        path = results_root / d / "cv_results.json"
        if not path.exists():
            continue
        r = load_cv_results(path)
        rows.append(dict(
            key=d, model=r["model"], c_index_mean=r["c_index_mean"],
            c_index_std=r["c_index_std"], fold_scores=r["fold_scores"],
            n_folds=len(r["fold_scores"]),
            hyperparameters=r["hyperparameters"],
            raw=r["raw"],
        ))
    return sorted(rows, key=lambda r: (math.isnan(r["c_index_mean"]),
                                       -r["c_index_mean"]))


def _t_test(a, b):
    """(p, test): paired t on equal fold counts, else Welch (unpaired),
    else none."""
    a, b = np.asarray(a), np.asarray(b)
    if len(a) == len(b) and len(a) > 1:
        return float(sstats.ttest_rel(a, b).pvalue), "paired-t"
    if len(a) > 1 and len(b) > 1:
        return float(sstats.ttest_ind(a, b, equal_var=False).pvalue), \
            "welch-t"
    return math.nan, "n/a"


def paired_t_vs_best(rows: list) -> list:
    """Each row with ``p_value`` and ``test`` added: a paired t-test of its
    fold scores against the best model's (Welch on unpaired scores where
    the fold counts differ, noted in ``test``)."""
    if not rows:
        return []
    best = rows[0]
    out = []
    for r in rows:
        if r["key"] == best["key"]:
            p, test = math.nan, "-"
        else:
            p, test = _t_test(best["fold_scores"], r["fold_scores"])
        out.append(dict(r, p_value=p, test=test))
    return out


def pairwise_significance(rows: list):
    """Full p-value matrix between all model pairs (reference
    analyze_all_results.py:108-152): ``(models, (n, n) array)``, NaN on the
    diagonal and where a test is not defined."""
    n = len(rows)
    mat = np.full((n, n), np.nan)
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            p, test = _t_test(rows[i]["fold_scores"], rows[j]["fold_scores"])
            if test != "n/a":
                mat[i, j] = p
    return [r["model"] for r in rows], mat


def recommendation_tier(c: float) -> str:
    """C-index tiers (reference analyze_all_results.py:384-393)."""
    if c >= 0.70:
        return "Excellent - clinically promising"
    if c >= 0.65:
        return "Good - strong predictive signal"
    if c >= 0.60:
        return "Moderate - useful signal"
    if c >= 0.55:
        return "Weak - marginal improvement over random"
    return "Needs improvement - near random"


def generate_summary_md(rows: list, table=None, out_path=None) -> str:
    """Markdown summary structurally matching results/final_comparison/
    SUMMARY.md: dataset stats (from the matching table's row dicts, when
    given), ranked performance table, findings."""
    lines = ["# Model Comparison Summary", "",
             f"Generated: {datetime.now():%Y-%m-%d %H:%M}", ""]
    if table is not None:
        s = cohort_stats(table)
        lines += [
            "## Dataset", "",
            f"- Total patients: {s['total_patients']}",
            f"- With CT imaging: {s['with_imaging']}",
            f"- With RNA-seq: {s['with_rnaseq']}",
            f"- With clinical: {s['with_clinical']}",
            f"- With survival labels: {s['with_survival']}",
            f"- Complete (all modalities): {s['complete_multimodal']}", "",
        ]
    lines += ["## Performance (C-index, K-fold CV)", "",
              "| Rank | Model | C-index | Folds | p vs best |",
              "|---|---|---|---|---|"]
    for rank, r in enumerate(paired_t_vs_best(rows), 1):
        p = "-" if math.isnan(r["p_value"]) else f"{r['p_value']:.3f}"
        lines.append(
            f"| {rank} | {r['model']} | {r['c_index_mean']:.4f} ± "
            f"{r['c_index_std']:.4f} | {r['n_folds']} | {p} |")
    if rows:
        best = rows[0]
        lines += ["", "## Findings", "",
                  f"- Best model: **{best['model']}** "
                  f"(C-index {best['c_index_mean']:.4f})",
                  f"- Assessment: "
                  f"{recommendation_tier(best['c_index_mean'])}"]
    text = "\n".join(lines) + "\n"
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(text)
    return text


def export_results_json(rows: list, table=None, out_path=None) -> dict:
    """results.json export with the dataset_info block (the canonical cohort
    stats consumed downstream)."""
    payload = {
        "generated": datetime.now().isoformat(timespec="seconds"),
        "models": [
            dict(model=r["model"], c_index_mean=float(r["c_index_mean"]),
                 c_index_std=float(r["c_index_std"]),
                 fold_scores=list(map(float, r["fold_scores"])),
                 n_folds=int(r["n_folds"]))
            for r in rows
        ],
    }
    if table is not None:
        payload["dataset_info"] = cohort_stats(table)
    if rows:
        payload["best_model"] = rows[0]["model"]
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(payload, indent=2))
    return payload


def summary_statistics_csv(rows: list, out_path=None) -> list:
    """summary_statistics.csv (reference comprehensive_analysis.py:417-432):
    per-model mean/std/min/max/CV%/95% CI + the efficiency score
    mean/log10(dataset_size) when the results carry a dataset size.
    Returns the rows as dicts."""
    out = []
    for r in rows:
        fs = np.asarray(r["fold_scores"], np.float64)
        mean, std = float(fs.mean()), float(fs.std())
        ci = 1.96 * (std / max(math.sqrt(len(fs)), 1))
        raw = r.get("raw") or {}
        n_patients = raw.get("dataset_size") if isinstance(raw, dict) \
            else None
        eff = (mean / float(np.log10(n_patients))
               if n_patients and n_patients > 10 else math.nan)
        out.append(dict(
            model=r["model"], mean_c_index=mean, std_c_index=std,
            min_c_index=float(fs.min()), max_c_index=float(fs.max()),
            cv_percent=100 * std / mean if mean else math.nan,
            ci95_low=mean - ci, ci95_high=mean + ci, n_folds=len(fs),
            dataset_size=n_patients, efficiency_score=eff))
    if out_path:
        write_table(out_path, from_records(out))
    return out

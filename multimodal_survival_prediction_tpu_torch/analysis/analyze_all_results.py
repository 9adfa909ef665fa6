"""Cross-model results analysis with report (port of
``scripts/analysis/analyze_all_results.py``): stats summary, fold pivot,
full p-value matrix, improvement over the Image-Only baseline, the 6-panel
``model_comparison_analysis.png`` figure (reference :157-330), and
``analysis_report.txt`` with recommendation tiers.

    python -m multimodal_survival_prediction_tpu_torch.analysis.analyze_all_results \\
        --results-root results

The same flags, files and printed lines as the JAX script; the figure
needs matplotlib, and without it one line says it was skipped.
"""

from __future__ import annotations

import logging
import math
from pathlib import Path

from . import load_figures
from .comparison import (
    collect_results,
    pairwise_significance,
    recommendation_tier,
)
from .final_comparison import format_frame
from .generate_km_curves import base_parser


def fold_pivot(rows: list) -> str:
    """``pd.DataFrame({model: pd.Series(fold_scores)}).to_string()``: one
    column a model, one line a fold, NaN past a model's last fold."""
    n = max(len(r["fold_scores"]) for r in rows)
    return format_frame(
        {r["model"]: [float(v) for v in r["fold_scores"]]
         + [math.nan] * (n - len(r["fold_scores"])) for r in rows},
        range(n))


def report_lines(rows: list) -> list:
    lines = ["=" * 60, "ANALYSIS REPORT", "=" * 60, ""]
    lines.append(f"{'model':<32}{'mean':>8}{'std':>8}{'folds':>7}")
    for r in rows:
        lines.append(f"{r['model']:<32}{r['c_index_mean']:>8.4f}"
                     f"{r['c_index_std']:>8.4f}{r['n_folds']:>7}")

    lines += ["", "Fold-wise C-index:", fold_pivot(rows)]

    if len(rows) > 1:
        models, mat = pairwise_significance(rows)
        mat = mat.round(4)
        lines += ["", "Pairwise p-values:", format_frame(
            {m: list(mat[:, j]) for j, m in enumerate(models)}, models,
            "model", "model")]

    base = [r for r in rows if "image_only" in r["key"].lower()]
    if base:
        b = float(base[0]["c_index_mean"])
        lines += ["", f"Improvement over Image-Only ({b:.4f}):"]
        for r in rows:
            if r["key"] == base[0]["key"]:
                continue
            lines.append(
                f"  {r['model']}: {100 * (r['c_index_mean'] - b) / b:+.1f}%")

    lines += ["", "Recommendations:"]
    for r in rows:
        lines.append(f"  {r['model']}: "
                     f"{recommendation_tier(r['c_index_mean'])}")
    return lines


def main(argv=None):
    args = base_parser(__doc__.splitlines()[0]).parse_args(argv)
    root = Path(args.results_root)
    rows = collect_results(root)
    if not rows:
        print(f"no cv_results.json found under {root}")
        return None

    report = "\n".join(report_lines(rows)) + "\n"
    out = Path(args.out_dir or root) / "analysis_report.txt"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(report)
    print(report)
    print(f"report -> {out}")

    figures = load_figures("model_comparison_analysis.png")
    if figures is not None:
        fig_path = figures.model_comparison_analysis(
            rows, out.parent / "model_comparison_analysis.png")
        print(f"figure -> {fig_path}")
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()

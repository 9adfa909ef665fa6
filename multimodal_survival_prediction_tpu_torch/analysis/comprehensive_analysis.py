"""Comprehensive multi-model analysis (port of
``scripts/analysis/comprehensive_analysis.py``): ranked bars, fold-wise
grouped bars, pairwise significance heatmap, per-model
coefficient-of-variation and 95% CIs, and
``comprehensive_analysis/summary_statistics.csv``.

    python -m multimodal_survival_prediction_tpu_torch.analysis.comprehensive_analysis \\
        --results-root results

The same flags, files and printed table as the JAX script; the five
figures need matplotlib, and without it one line says they were skipped.
"""

from __future__ import annotations

import logging
from pathlib import Path

from . import load_figures
from .comparison import (
    collect_results,
    pairwise_significance,
    summary_statistics_csv,
)
from .final_comparison import format_table
from .generate_km_curves import base_parser


def main(argv=None):
    args = base_parser(__doc__.splitlines()[0]).parse_args(argv)
    out = Path(args.out_dir
               or Path(args.results_root) / "comprehensive_analysis")
    rows = collect_results(args.results_root)
    if not rows:
        print(f"no cv_results.json found under {args.results_root}")
        return None

    figures = load_figures(
        "ranked_comparison.png, foldwise_scores.png, violin_scatter.png, "
        "performance_vs_size.png, significance_heatmap.png")
    if figures is not None:
        figures.model_comparison_main(rows, out / "ranked_comparison.png")
        figures.foldwise_bars(rows, out / "foldwise_scores.png")
        figures.violin_scatter(rows, out / "violin_scatter.png")
        figures.performance_vs_dataset_size(rows,
                                            out / "performance_vs_size.png")
        if len(rows) > 1:
            figures.significance_heatmap(pairwise_significance(rows),
                                         out / "significance_heatmap.png")
    stats = summary_statistics_csv(rows, out / "summary_statistics.csv")
    print(format_table(stats, list(stats[0])))
    print(f"\nartifacts -> {out}")
    return stats


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()

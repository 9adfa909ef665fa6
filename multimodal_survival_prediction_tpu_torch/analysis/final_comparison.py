"""Final model comparison (parity with reference scripts/training/final_comparison.py): loads every results/<model>/cv_results.json (both schema variants), runs paired t-tests vs the best model, derives dataset stats from the matching table, and writes results/final_comparison/{SUMMARY.md, results.json}.

    python -m multimodal_survival_prediction_tpu_torch.analysis.final_comparison \\
        --results-root results --data-root <root>

The port's counterpart of ``scripts/analysis/final_comparison.py``: the
same flags and text artifacts, and the same table printed. The two figures
(``model_comparison_main.png``, ``ablation_study.png``: matplotlib, in the
JAX package's ``analysis/figures.py``) are not drawn; one line says so.
"""

from __future__ import annotations

import math
from pathlib import Path

from ..data.matching_table import load_matching_table
from .comparison import (
    collect_results,
    export_results_json,
    generate_summary_md,
    paired_t_vs_best,
)
from .generate_km_curves import base_parser

FIGURES_SKIPPED = (
    "figures model_comparison_main.png and ablation_study.png skipped: "
    "analysis/figures.py is not ported (ROADMAP.md Queue 1 item 11)")


def load_table_or_none(data_root):
    """The matching table under ``data_root``, or None where there is none
    (``scripts/analysis/common.py:load_table_or_none``)."""
    path = Path(data_root) / "data" / "processed" / "full_matching_table.csv"
    return load_matching_table(path) if path.exists() else None


def _float_cells(values: list) -> list:
    """A float column as pandas' ``to_string`` writes it: six decimals with
    the zeros every value ends in trimmed (one kept), or ``%.6e`` where a
    value would need more; NaN as ``NaN``."""
    finite = [v for v in values if not math.isnan(v)]
    if not finite:
        return ["NaN"] * len(values)
    if any(0 < abs(v) < 1e-6 or abs(v) > 1e6 for v in finite):
        fmt = [f"{v:.6e}" for v in finite]
    else:
        fmt = [f"{v:.6f}" for v in finite]
        while all(s.endswith("0") and s[-2] != "." for s in fmt):
            fmt = [s[:-1] for s in fmt]
    it = iter(fmt)
    return ["NaN" if math.isnan(v) else next(it) for v in values]


def format_table(rows: list, columns: list) -> str:
    """``DataFrame(rows)[columns].to_string(index=False)`` for string and
    float columns: each column right-aligned to its widest cell (a float
    column's header takes one more), columns joined by a space."""
    cols = []
    for c in columns:
        values = [r[c] for r in rows]
        if all(isinstance(v, float) for v in values):
            cells = _float_cells(values)
            width = max([len(c) + 1, *map(len, cells)])
        else:
            cells = [str(v) for v in values]
            width = max([len(c), *map(len, cells)])
        cols.append([c.rjust(width), *(s.rjust(width) for s in cells)])
    return "\n".join(" ".join(line) for line in zip(*cols))


def main(argv=None):
    args = base_parser(__doc__.splitlines()[0]).parse_args(argv)
    out = Path(args.out_dir or Path(args.results_root) / "final_comparison")
    rows = collect_results(args.results_root)
    if not rows:
        print(f"no cv_results.json found under {args.results_root}")
        return None
    table = load_table_or_none(args.data_root)

    print(FIGURES_SKIPPED)
    md = generate_summary_md(rows, table, out / "SUMMARY.md")
    payload = export_results_json(rows, table, out / "results.json")
    print(md)
    print(format_table(paired_t_vs_best(rows),
                       ["model", "c_index_mean", "p_value"]))
    print(f"\nartifacts -> {out}")
    return payload


if __name__ == "__main__":
    main()

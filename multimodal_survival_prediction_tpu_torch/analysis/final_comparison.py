"""Final model comparison (parity with reference scripts/training/final_comparison.py): loads every results/<model>/cv_results.json (both schema variants), runs paired t-tests vs the best model, derives dataset stats from the matching table, and writes results/final_comparison/{SUMMARY.md, results.json}.

    python -m multimodal_survival_prediction_tpu_torch.analysis.final_comparison \\
        --results-root results --data-root <root>

The port's counterpart of ``scripts/analysis/final_comparison.py``: the
same flags, artifacts and printed table. The two figures
(``model_comparison_main.png``, ``ablation_study.png``) need matplotlib;
without it one line says they were skipped.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from ..data.matching_table import load_matching_table
from . import load_figures
from .comparison import (
    collect_results,
    export_results_json,
    generate_summary_md,
    paired_t_vs_best,
)
from .generate_km_curves import base_parser

def load_table_or_none(data_root):
    """The matching table under ``data_root``, or None where there is none
    (``scripts/analysis/common.py:load_table_or_none``)."""
    path = Path(data_root) / "data" / "processed" / "full_matching_table.csv"
    return load_matching_table(path) if path.exists() else None


def _float_cells(values: list, sign: bool = False) -> list:
    """A float column as pandas' ``to_string`` writes it: six decimals with
    the zeros every value ends in trimmed (one kept), or ``%.6e`` where a
    value would need more; NaN as ``NaN``. ``sign``: a frame with an index
    writes a space where a number has no minus sign."""
    finite = [v for v in values if not math.isnan(v)]
    if not finite:
        return ["NaN"] * len(values)
    flag = " " if sign else ""
    if any(0 < abs(v) < 1e-6 or abs(v) > 1e6 for v in finite):
        fmt = [f"{v:{flag}.6e}" for v in finite]
    else:
        fmt = [f"{v:{flag}.6f}" for v in finite]
        while all(s.endswith("0") and s[-2] != "." for s in fmt):
            fmt = [s[:-1] for s in fmt]
    it = iter(fmt)
    return ["NaN" if math.isnan(v) else next(it) for v in values]


def _number(v) -> bool:
    return isinstance(v, (int, float, np.integer, np.floating)) and \
        not isinstance(v, bool)


def _column_cells(name: str, values: list, sign: bool = False):
    """``(header width, cells)`` of one column as ``pd.DataFrame(rows)``
    types it: ints stay ints, numbers with a None or a NaN among them
    become floats, anything else is an object column written by ``str``.
    A numeric column's header takes one more than its name."""
    numbers = [v for v in values if v is not None]
    if numbers and all(_number(v) for v in numbers):
        if len(numbers) == len(values) and all(
                isinstance(v, (int, np.integer)) for v in values):
            return len(name) + 1, [f"{v:{' ' if sign else ''}d}"
                                   for v in values]
        return len(name) + 1, _float_cells(
            [math.nan if v is None else float(v) for v in values], sign)
    return len(name), [str(v) for v in values]


def format_table(rows: list, columns: list) -> str:
    """``DataFrame(rows)[columns].to_string(index=False)`` for string, int
    and float columns (and None): each column right-aligned to its widest
    cell, columns joined by a space."""
    cols = []
    for c in columns:
        header, cells = _column_cells(c, [r[c] for r in rows])
        width = max([header, *map(len, cells)])
        cols.append([c.rjust(width), *(s.rjust(width) for s in cells)])
    return "\n".join(" ".join(line) for line in zip(*cols))


def format_frame(columns: dict, index: list, index_name=None,
                 columns_name=None) -> str:
    """``DataFrame(columns, index=index).to_string()`` for float columns
    of equal length (NaN where a value is missing): the index left-aligned
    in the first column; where the index and the columns are named (a
    frame indexed by a Series), the columns' name heads the first line and
    the index's has a line of its own."""
    labels = [str(i) for i in index]
    iw = max([len(s) for s in labels]
             + [len(n) for n in (index_name, columns_name) if n])
    cols = []
    for name, values in columns.items():
        header, cells = _column_cells(name, list(values), sign=True)
        width = max([header, *map(len, cells)])
        cols.append((name.rjust(width), [s.rjust(width) for s in cells]))
    lines = [" ".join([(columns_name or "").ljust(iw),
                       *(h for h, _ in cols)])]
    if index_name:
        lines.append(" ".join([index_name.ljust(iw),
                               *(" " * len(h) for h, _ in cols)]))
    for i, label in enumerate(labels):
        lines.append(" ".join([label.ljust(iw),
                               *(cells[i] for _, cells in cols)]))
    return "\n".join(lines)


def main(argv=None):
    args = base_parser(__doc__.splitlines()[0]).parse_args(argv)
    out = Path(args.out_dir or Path(args.results_root) / "final_comparison")
    rows = collect_results(args.results_root)
    if not rows:
        print(f"no cv_results.json found under {args.results_root}")
        return None
    table = load_table_or_none(args.data_root)

    figures = load_figures("model_comparison_main.png, ablation_study.png")
    if figures is not None:
        figures.model_comparison_main(rows, out / "model_comparison_main.png")
        figures.ablation_study(rows, out / "ablation_study.png")
    md = generate_summary_md(rows, table, out / "SUMMARY.md")
    payload = export_results_json(rows, table, out / "results.json")
    print(md)
    print(format_table(paired_t_vs_best(rows),
                       ["model", "c_index_mean", "p_value"]))
    print(f"\nartifacts -> {out}")
    return payload


if __name__ == "__main__":
    main()

"""Report figures (port of ``scripts/analysis/create_report_figures.py``):
sample CT mid-slices, modality-availability bars + survival-status pie,
whole-cohort Kaplan-Meier with median annotation, and the model-comparison
bars, under ``<results-root>/report_figures``.

    python -m multimodal_survival_prediction_tpu_torch.analysis.create_report_figures \\
        --results-root results --data-root <root>

The same flags, files and printed lines as the JAX script. It draws
figures only: without matplotlib one line says they were skipped.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from ..data.nifti import read_nifti
from ..ops.km import kaplan_meier
from . import load_figures
from .comparison import collect_results
from .final_comparison import load_table_or_none
from .generate_km_curves import base_parser

REPORT_FIGURES = ("modality_availability.png, cohort_km.png, "
                  "sample_ct_slices.png, model_comparison.png")


def sample_rows(rows: list, k: int, seed: int = 42) -> list:
    """``DataFrame(rows).sample(k, random_state=seed)``'s rows, in its
    order: the first ``k`` of ``RandomState(seed).permutation(len(rows))``
    (pandas' sample without replacement)."""
    return [rows[i] for i in np.random.RandomState(seed).permutation(
        len(rows))[:k]]


def main(argv=None):
    args = base_parser(__doc__.splitlines()[0]).parse_args(argv)
    out = Path(args.out_dir or Path(args.results_root) / "report_figures")
    table = load_table_or_none(args.data_root)
    if table is None:
        print("no matching table found; run preprocessing (or --synthetic "
              "training) first")
        return None
    figures = load_figures(REPORT_FIGURES)
    if figures is None:
        return None

    figures.modality_availability(table, out / "modality_availability.png")

    # whole-cohort KM (labeled patients)
    lab = [r for r in table if r["has_survival"]]
    if lab:
        km = kaplan_meier(np.asarray([r["survival_time"] for r in lab]),
                          np.asarray([r["survival_status"] for r in lab]))
        med = km.median_survival_time
        figures.km_plot({"cohort": km}, out / "cohort_km.png",
                        title=f"Cohort KM (median={med:.0f}d)"
                        if np.isfinite(med) else "Cohort KM")

    # 3 random CT mid-slices (seed 42 like the reference's sampling)
    imaged = [r for r in table if r["has_imaging"]]
    if imaged:
        vols, labels = [], []
        for row in sample_rows(imaged, min(3, len(imaged))):
            try:
                vols.append(read_nifti(row["nifti_path"]).data)
                labels.append(row["patient_id"])
            except Exception:
                pass
        if vols:
            figures.ct_slice_gallery(vols, out / "sample_ct_slices.png",
                                     labels)

    rows = collect_results(args.results_root)
    if rows:
        figures.model_comparison_main(rows, out / "model_comparison.png")
    print(f"figures -> {out}")
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()

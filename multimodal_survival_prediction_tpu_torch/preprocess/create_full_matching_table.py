"""Build the 608-cohort full matching table (parity with reference scripts/preprocessing/create_full_matching_table.py), including the shipped censoring semantics: survival_time = days_to_death only, so censored patients keep NaN time and has_survival ≈ died.

    python -m multimodal_survival_prediction_tpu_torch.preprocess.create_full_matching_table \\
        --data-root <root> [--clinical-csv FILE] [--use-followup]

The port's counterpart of
``scripts/preprocessing/create_full_matching_table.py``: the same flags,
``data/processed/full_matching_table.csv`` and printed cohort counts, over
``data.matching_table.build_full_matching_table``.
"""

from __future__ import annotations

from pathlib import Path

from ..data.matching_table import build_full_matching_table, cohort_stats
from .convert_dicom_to_nifti import base_parser


def main(argv=None):
    p = base_parser(__doc__.splitlines()[0])
    p.add_argument("--clinical-csv", default=None)
    p.add_argument("--use-followup", action="store_true",
                   help="109-cohort semantics: censored patients get "
                        "days_to_last_follow_up with event=0")
    args = p.parse_args(argv)

    root = Path(args.data_root)
    clinical = Path(args.clinical_csv) if args.clinical_csv else next(
        iter(sorted((root / "data" / "clinical").glob("*.csv"))), None)
    if clinical is None or not clinical.exists():
        print("no clinical CSV found")
        return None
    rnaseq_csv = root / "data" / "processed" / "rnaseq_normalized_mapped.csv"
    if not rnaseq_csv.exists():
        rnaseq_csv = root / "data" / "processed" / "rnaseq_normalized.csv"

    out = root / "data" / "processed" / "full_matching_table.csv"
    table = build_full_matching_table(
        clinical, root / "data" / "imaging" / "nifti",
        rnaseq_csv if rnaseq_csv.exists() else None,
        out_csv=out, use_followup=args.use_followup)
    for k, v in cohort_stats(table).items():
        print(f"  {k}: {v}")
    print(f"-> {out}")
    return table


if __name__ == "__main__":
    main()

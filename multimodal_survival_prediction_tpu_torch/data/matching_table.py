"""The full matching table — the pipeline's central data contract — without
pandas (port of ``multimodal_survival_prediction_tpu/data/matching_table.py``).

A table is a list of row dicts with the columns (reference
create_full_matching_table.py:124-134):

  patient_id, nifti_path, has_imaging, has_rnaseq, has_clinical,
  age, survival_time, survival_status, has_survival

Missing numbers are ``float('nan')``. Semantics as in the JAX module,
quirks included: age falls back to -days_to_birth/365.25; survival_time is
days_to_death only (censored patients keep NaN time, so has_survival ≈
died) unless ``use_followup``; imaging = first .nii.gz (else .nii) under
``<nifti_root>/<patient_id>/``; RNA membership = presence in the RNA matrix.
"""

from __future__ import annotations

import csv
import math
from pathlib import Path

MATCHING_COLUMNS = [
    "patient_id",
    "nifti_path",
    "has_imaging",
    "has_rnaseq",
    "has_clinical",
    "age",
    "survival_time",
    "survival_status",
    "has_survival",
]
_BOOL_COLUMNS = ("has_imaging", "has_rnaseq", "has_clinical", "has_survival")
_FLOAT_COLUMNS = ("age", "survival_time", "survival_status")


def _isnan(x) -> bool:
    try:
        return math.isnan(float(x))
    except (TypeError, ValueError):
        return True


def extract_age(row: dict) -> float:
    """age_at_index with -days_to_birth/365.25 fallback."""
    age = row.get("demographic.age_at_index")
    if age is not None and not _isnan(age):
        return float(age)
    dtb = row.get("demographic.days_to_birth")
    if dtb is not None and not _isnan(dtb):
        return -float(dtb) / 365.25
    return float("nan")


def survival_from_clinical_row(row: dict, use_followup: bool = False):
    """Returns (survival_time, survival_status, has_survival)."""
    vital = str(row.get("demographic.vital_status", ""))
    dtd = row.get("demographic.days_to_death")
    if vital == "Dead" and dtd is not None and not _isnan(dtd):
        return float(dtd), 1, True
    if use_followup:
        fu = row.get("diagnoses.days_to_last_follow_up")
        if fu is not None and not _isnan(fu):
            return float(fu), 0, True
    status = 1 if vital == "Dead" else 0
    return float("nan"), status, False


def find_first_nifti(nifti_root, patient_id: str):
    pdir = Path(nifti_root) / patient_id
    if not pdir.is_dir():
        return None
    hits = sorted(pdir.glob("*.nii.gz")) or sorted(pdir.glob("*.nii"))
    return str(hits[0]) if hits else None


def format_cell(v) -> str:
    """One CSV cell as pandas writes it: NaN/None empty, bools True/False,
    floats in their shortest round-trip form."""
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return ""
    if isinstance(v, float):
        return repr(v)
    return str(v)


def read_csv_rows(path) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def write_table(path, table: list[dict], columns=MATCHING_COLUMNS) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(columns)
        for row in table:
            w.writerow([format_cell(row[c]) for c in columns])


def read_rnaseq_ids(rnaseq_csv) -> set:
    """Patient ids (first column) of an RNA matrix CSV, header skipped."""
    with open(rnaseq_csv, newline="") as f:
        reader = csv.reader(f)
        next(reader, None)
        return {r[0] for r in reader if r}


def build_full_matching_table(clinical_csv, nifti_root, rnaseq_csv,
                              out_csv=None,
                              use_followup: bool = False) -> list[dict]:
    """Assemble the matching table from the three upstream artifacts."""
    clinical = read_csv_rows(clinical_csv)
    id_col = ("submitter_id" if clinical and "submitter_id" in clinical[0]
              else "patient_id")
    rna_ids: set = set()
    if rnaseq_csv is not None and Path(rnaseq_csv).exists():
        rna_ids = read_rnaseq_ids(rnaseq_csv)

    table = []
    for crow in clinical:
        pid = crow[id_col]
        nifti = find_first_nifti(nifti_root, pid) if nifti_root else None
        t, s, has_s = survival_from_clinical_row(crow, use_followup)
        age = extract_age(crow)
        table.append(dict(
            patient_id=pid,
            nifti_path=nifti if nifti else "",
            has_imaging=nifti is not None,
            has_rnaseq=pid in rna_ids,
            has_clinical=not _isnan(age),
            age=age,
            survival_time=t,
            survival_status=s,
            has_survival=has_s,
        ))
    if out_csv is not None:
        write_table(out_csv, table)
    return table


def _parse_bool(v: str) -> bool:
    s = v.strip().lower()
    if s in ("true", "false", ""):
        return s == "true"
    return bool(float(s))


def load_matching_table(path) -> list[dict]:
    """Read a matching-table CSV into row dicts: flags as bools, age /
    survival_time / survival_status as floats (NaN when empty)."""
    rows = []
    for raw in read_csv_rows(path):
        row = dict(raw)
        for c in _BOOL_COLUMNS:
            row[c] = _parse_bool(raw[c])
        for c in _FLOAT_COLUMNS:
            row[c] = float(raw[c]) if raw[c].strip() else float("nan")
        rows.append(row)
    return rows


def cohort_stats(table) -> dict:
    """The dataset_info block of results/final_comparison/results.json."""
    rows = list(table)
    count = lambda *cols: int(sum(all(bool(r[c]) for c in cols)  # noqa: E731
                                  for r in rows))
    return {
        "total_patients": len(rows),
        "with_imaging": count("has_imaging"),
        "with_rnaseq": count("has_rnaseq"),
        "with_clinical": count("has_clinical"),
        "with_survival": count("has_survival"),
        "complete_multimodal": count(*_BOOL_COLUMNS),
    }

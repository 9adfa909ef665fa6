"""Synthetic TCGA-OV-like cohort generator, pandas-free (port of
``multimodal_survival_prediction_tpu/data/synthetic.py``).

Draws the same random numbers in the same order as the JAX module, so one
spec and seed give the same cohort: NIfTI CT volumes, a 5,005-gene RNA
matrix CSV, a clinical CSV and the full matching table, with planted risk
signal (a linear risk on a gene subset + an imaging intensity effect).

Two options the JAX module lacks, for real-size CTs on the card:
``image_dtype`` ('float32' as there, or 'int16' — the voxel values rounded,
as scanners store them) and ``compress`` (False writes ``.nii``, which
decodes without gzip).
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .matching_table import build_full_matching_table, format_cell
from .nifti import write_nifti

RNA_DIM = 5005  # shipped matrix width (SURVEY §2.13)


@dataclass
class SyntheticCohortSpec:
    n_patients: int = 64
    p_imaging: float = 0.25
    p_rnaseq: float = 0.7
    p_clinical: float = 0.95
    p_dead: float = 0.57  # -> has_survival fraction (608-cohort: 348/608)
    rna_dim: int = RNA_DIM
    image_shapes: tuple = ((48, 96, 96), (32, 80, 80), (40, 64, 64))
    seed: int = 42
    image_dtype: str = "float32"  # or "int16"
    compress: bool = True  # .nii.gz, else .nii


def generate_synthetic_cohort(root, spec: SyntheticCohortSpec | None = None):
    """Writes the phase-2 artifact set under `root`:

      data/clinical/clinical.csv
      data/imaging/nifti/<pid>/series_00.nii[.gz]
      data/processed/rnaseq_normalized_mapped.csv
      data/processed/full_matching_table.csv

    Returns (matching table as row dicts, paths dict).
    """
    spec = spec or SyntheticCohortSpec()
    if spec.image_dtype not in ("float32", "int16"):
        raise ValueError(f"image_dtype must be float32 or int16, got "
                         f"{spec.image_dtype!r}")
    rng = np.random.default_rng(spec.seed)
    root = Path(root)
    clin_dir = root / "data" / "clinical"
    nifti_root = root / "data" / "imaging" / "nifti"
    proc = root / "data" / "processed"
    for d in (clin_dir, nifti_root, proc):
        d.mkdir(parents=True, exist_ok=True)

    n = spec.n_patients
    pids = [f"TCGA-SY-{i:04d}" for i in range(n)]
    has_img = rng.uniform(size=n) < spec.p_imaging
    has_rna = rng.uniform(size=n) < spec.p_rnaseq
    has_clin = rng.uniform(size=n) < spec.p_clinical
    dead = rng.uniform(size=n) < spec.p_dead

    # --- planted risk signal ---
    gene_expr = rng.normal(size=(n, spec.rna_dim)).astype(np.float32)
    beta = np.zeros(spec.rna_dim, np.float32)
    beta[:20] = rng.normal(scale=0.5, size=20)
    risk = gene_expr @ beta
    base_time = rng.exponential(scale=1000.0, size=n)
    surv_days = np.maximum(base_time * np.exp(-0.5 * risk), 5.0)

    # --- clinical CSV (GDC-expanded column names) ---
    age = rng.uniform(35, 85, size=n).round(0)
    clin_cols = ["submitter_id", "demographic.vital_status",
                 "demographic.age_at_index", "demographic.days_to_birth",
                 "demographic.days_to_death",
                 "diagnoses.days_to_last_follow_up"]
    nan = float("nan")
    clin_rows = []
    for i, pid in enumerate(pids):
        row = {
            "submitter_id": pid,
            "demographic.vital_status": "Dead" if dead[i] else "Alive",
            "demographic.age_at_index": float(age[i]) if has_clin[i] else nan,
            "demographic.days_to_birth": float(-age[i] * 365.25),
            "demographic.days_to_death": float(surv_days[i]) if dead[i] else nan,
            "diagnoses.days_to_last_follow_up": (
                nan if dead[i] else float(surv_days[i] * rng.uniform(0.3, 1.0))
            ),
        }
        if not has_clin[i]:
            row["demographic.age_at_index"] = nan
            row["demographic.days_to_birth"] = nan
        clin_rows.append(row)
    clinical_csv = clin_dir / "clinical.csv"
    with open(clinical_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(clin_cols)
        for row in clin_rows:
            w.writerow([format_cell(row[c]) for c in clin_cols])

    # --- RNA matrix for patients that have it ---
    genes = [f"ENSG{j:011d}" for j in range(spec.rna_dim)]
    rnaseq_csv = proc / "rnaseq_normalized_mapped.csv"
    with open(rnaseq_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["", *genes])
        for i, pid in enumerate(pids):
            if has_rna[i]:
                # 9 significant digits round-trip every float32 exactly
                w.writerow([pid, *(f"{v:.9g}" for v in gene_expr[i].tolist())])

    # --- NIfTI volumes; intensity correlates (weakly) with risk ---
    suffix = ".nii.gz" if spec.compress else ".nii"
    for i, pid in enumerate(pids):
        if not has_img[i]:
            continue
        shape = spec.image_shapes[i % len(spec.image_shapes)]
        vol = rng.normal(loc=100 + 20 * risk[i], scale=50, size=shape)
        if spec.image_dtype == "int16":
            vol = np.rint(vol).clip(-32768, 32767).astype(np.int16)
        else:
            vol = vol.astype(np.float32)
        pdir = nifti_root / pid
        pdir.mkdir(exist_ok=True)
        write_nifti(pdir / f"series_00{suffix}", vol, spacing=(0.7, 0.7, 2.5))
        del vol

    table = build_full_matching_table(
        clinical_csv, nifti_root, rnaseq_csv,
        out_csv=proc / "full_matching_table.csv",
    )
    paths = {
        "root": root,
        "clinical_csv": clinical_csv,
        "nifti_root": nifti_root,
        "rnaseq_csv": rnaseq_csv,
        "matching_table": proc / "full_matching_table.csv",
    }
    return table, paths

"""Build the complete-cohort (109-patient-style) dataset artifacts (parity with reference scripts/preprocessing/create_multimodal_dataset.py): multimodal_matching_table.csv restricted to complete patients, survival from days_to_death (event=1) else days_to_last_follow_up (event=0), a stratified 70/15/15 train/val/test split on survival_status with seed 42 -> data_splits.json, and a code-generated importable dataset module (multimodal_dataset.py) exposing the cohort through this framework.

    python -m multimodal_survival_prediction_tpu_torch.preprocess.create_multimodal_dataset \\
        --data-root <root> [--target-size D,H,W]

The port's counterpart of
``scripts/preprocessing/create_multimodal_dataset.py``: the same flags,
files and printed lines. The split is sklearn's ``train_test_split(...,
random_state=42, stratify=...)`` twice, through its numpy twin
``train.kfold.stratified_split``; the generated module loads the cohort
through this package.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from ..data.matching_table import load_matching_table
from ..train.kfold import stratified_split
from .convert_dicom_to_nifti import base_parser
from .tables import read_table, write_table

MODULE_TEMPLATE = '''"""Code-generated multimodal dataset module.

Generated by multimodal_survival_prediction_tpu_torch.preprocess.
create_multimodal_dataset (the reference pipeline code-generates an
equivalent importable module, reference create_multimodal_dataset.py:
345-445). Exposes the complete-cohort arrays through
multimodal_survival_prediction_tpu_torch.
"""

from pathlib import Path

_HERE = Path(__file__).resolve().parent
MATCHING_TABLE = _HERE / "multimodal_matching_table.csv"
DATA_SPLITS = _HERE / "data_splits.json"
TARGET_SIZE = {target_size}
RNA_DIM = {rna_dim}


def load(split=None, device="cuda"):
    """Returns (CohortArrays, split_patient_ids or None); the arrays are
    built on ``device``."""
    import json

    from multimodal_survival_prediction_tpu_torch.data.datasets import (
        build_cohort_arrays,
        load_rnaseq_matrix,
    )
    from multimodal_survival_prediction_tpu_torch.data.matching_table import (
        load_matching_table,
    )

    table = load_matching_table(MATCHING_TABLE)
    rnaseq_csv = _HERE / "rnaseq_normalized_mapped.csv"
    rnaseq = load_rnaseq_matrix(rnaseq_csv) if rnaseq_csv.exists() else None
    arrays = build_cohort_arrays(table, rnaseq, with_image=True,
                                 image_shape=TARGET_SIZE, device=device)
    ids = None
    if split is not None:
        ids = json.loads(DATA_SPLITS.read_text())[split]
    return arrays, ids
'''
BOOL_COLUMNS = ("has_imaging", "has_rnaseq", "has_clinical", "has_survival")


def split_ids(ids: list, strat) -> tuple:
    """``(train, val, test)``: 70/15/15 stratified on ``strat`` (the JAX
    script's two ``train_test_split`` calls, seed 42), or a plain split in
    order for cohorts under 7 patients or with one class."""
    if len(ids) >= 7 and len(np.unique(strat)) > 1:
        tr, rest = stratified_split(strat, 0.3, 42)
        va, te = stratified_split(strat[rest], 0.5, 42)
        rest_ids = [ids[i] for i in rest]
        return ([ids[i] for i in tr], [rest_ids[i] for i in va],
                [rest_ids[i] for i in te])
    n = len(ids)  # tiny cohorts: simple split
    return (ids[: int(0.7 * n)], ids[int(0.7 * n): int(0.85 * n)],
            ids[int(0.85 * n):])


def main(argv=None):
    p = base_parser(__doc__.splitlines()[0])
    p.add_argument("--target-size", default="128,128,64",
                   help="D,H,W (reference default 128,128,64)")
    args = p.parse_args(argv)

    root = Path(args.data_root)
    proc = root / "data" / "processed"
    full = proc / "full_matching_table.csv"
    if not full.exists():
        print(f"missing {full}; run create_full_matching_table.py first")
        return None

    # the CSV's columns typed as pandas reads them, the flags as
    # load_matching_table makes them booleans
    frame = read_table(full)
    for c, values in zip(BOOL_COLUMNS, zip(*(
            [r[c] for c in BOOL_COLUMNS] for r in load_matching_table(full)))):
        frame.data[c] = list(values)
    # complete patients; 109-cohort survival semantics: follow-up counts as
    # censored label (reference create_multimodal_dataset.py:92-109)
    cols = frame.data
    complete = frame.rows([
        img and rna and clin
        and (not math.isnan(float(t)) or float(s) == 0)
        for img, rna, clin, t, s in zip(
            cols["has_imaging"], cols["has_rnaseq"], cols["has_clinical"],
            cols["survival_time"], cols["survival_status"])])
    out_table = proc / "multimodal_matching_table.csv"
    write_table(out_table, complete)

    ids = complete.column("patient_id")
    tr, va, te = split_ids(ids, np.asarray(complete.column("survival_status")))
    splits = {"train": list(tr), "val": list(va), "test": list(te),
              "seed": 42, "stratify": "survival_status"}
    (proc / "data_splits.json").write_text(json.dumps(splits, indent=2))

    target = tuple(int(x) for x in args.target_size.split(","))
    (proc / "multimodal_dataset.py").write_text(
        MODULE_TEMPLATE.format(target_size=target, rna_dim=5005))

    print(f"complete patients: {len(complete)}")
    print(f"splits: train={len(tr)} val={len(va)} test={len(te)}")
    print(f"-> {out_table}\n-> {proc/'data_splits.json'}\n"
          f"-> {proc/'multimodal_dataset.py'}")
    return splits


if __name__ == "__main__":
    main()

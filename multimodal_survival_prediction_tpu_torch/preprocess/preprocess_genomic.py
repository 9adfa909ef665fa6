"""Genomic preprocessing (parity with reference scripts/preprocessing/preprocess_genomic.py): RNA-seq STAR counts -> log2 -> z-score -> top-K variance genes -> data/processed/rnaseq_normalized.csv + selected_genes.txt; mutation MAF -> binary per-patient gene matrix; CNV segments concatenated; clinical cohort filter.

    python -m multimodal_survival_prediction_tpu_torch.preprocess.preprocess_genomic \\
        --data-root <root> [--top-k 5000]

The port's counterpart of ``scripts/preprocessing/preprocess_genomic.py``
(the same flags and artifacts, without pandas).
"""

from __future__ import annotations

from pathlib import Path

from .convert_dicom_to_nifti import base_parser
from .genomic import (
    build_rnaseq_matrix,
    concat_cnv_segments,
    merge_mutation_matrices,
    mutation_matrix_from_maf,
    normalize_rnaseq,
)
from .tables import read_table, write_table


def main(argv=None):
    p = base_parser(__doc__.splitlines()[0])
    p.add_argument("--top-k", type=int, default=5000)
    args = p.parse_args(argv)

    root = Path(args.data_root)
    gen = root / "data" / "genomic"
    proc = root / "data" / "processed"
    proc.mkdir(parents=True, exist_ok=True)

    # RNA-seq
    rnaseq_root = gen / "rnaseq"
    if rnaseq_root.is_dir():
        mat = build_rnaseq_matrix(rnaseq_root)
        if len(mat):
            norm, genes = normalize_rnaseq(mat, top_k=args.top_k)
            norm.to_csv(proc / "rnaseq_normalized.csv")
            (proc / "selected_genes.txt").write_text("\n".join(genes) + "\n")
            print(f"RNA-seq: {norm.shape[0]} samples x {norm.shape[1]} genes "
                  f"-> {proc/'rnaseq_normalized.csv'}")
        else:
            print(f"no readable counts under {rnaseq_root}")
    else:
        print(f"skipping RNA-seq (no {rnaseq_root})")

    # Mutations
    mut_root = gen / "mutation"
    mafs = sorted(mut_root.rglob("*.maf*")) if mut_root.is_dir() else []
    if mafs:
        mut = merge_mutation_matrices(
            [mutation_matrix_from_maf(m) for m in mafs])
        mut.to_csv(proc / "mutation_matrix.csv", index_label="patient")
        print(f"mutations: {mut.shape} -> {proc/'mutation_matrix.csv'}")
    else:
        print("skipping mutations (no MAF files)")

    # CNV
    cnv_root = gen / "cnv"
    if cnv_root.is_dir():
        cnv = concat_cnv_segments(cnv_root)
        if len(cnv):
            write_table(proc / "cnv_segments.csv", cnv)
            print(f"CNV: {len(cnv)} segments -> {proc/'cnv_segments.csv'}")
    else:
        print("skipping CNV (no cnv dir)")

    # Clinical filter: restrict the clinical CSV to cohort patients
    clin = root / "data" / "clinical"
    cohort_csv = root / "data" / "multimodal_patients.csv"
    for cand in sorted(clin.glob("*.csv")) if clin.is_dir() else []:
        df = read_table(cand)
        idc = "submitter_id" if "submitter_id" in df.columns else None
        if idc and cohort_csv.exists():
            first = read_table(cohort_csv)
            cohort = set(first.column(first.columns[0]))
            df = df.rows([v in cohort for v in df.column(idc)])
            write_table(proc / "clinical_processed.csv", df)
            print(f"clinical: {len(df)} cohort rows -> "
                  f"{proc/'clinical_processed.csv'}")
            break


if __name__ == "__main__":
    main()

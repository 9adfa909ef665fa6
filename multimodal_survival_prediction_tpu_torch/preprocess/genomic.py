"""Genomic preprocessing: RNA-seq normalization, mutation / CNV matrices,
on ``csv`` + ``gzip`` + numpy (the port of
``multimodal_survival_prediction_tpu/preprocess/genomic.py``, which uses
pandas).

Capabilities of reference scripts/preprocessing/preprocess_genomic.py:
  * scan data/genomic/rnaseq/<uuid>/ for STAR gene-counts TSVs; pick the
    'unstranded' or 'tpm_unstranded' count column, else the last column
    (:45-88)
  * strip ENSG version suffixes; samples x genes matrix
  * log2(x+1) -> per-gene z-score -> top-K genes by variance (:104-138)
  * mutation MAF -> per-patient binary gene-mutation matrix keyed on
    Tumor_Sample_Barcode[:12] (:151-197)
  * CNV segment concatenation (:209-239)

Gene selection turns on the last bits of each gene's variance, so the
matrix must hold the float64 values the JAX module's pandas frame holds:
counts are parsed as ``pd.read_csv`` and ``pd.to_numeric`` parse them
(``tables.parse_float`` follows pandas' C converter, which is not always
the correctly rounded double for 17-digit decimals), and
:func:`normalize_rnaseq` runs the same numpy expression in the same order.
"""

from __future__ import annotations

import logging
import math
import re
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import tables

log = logging.getLogger(__name__)

PREFERRED_COUNT_COLUMNS = ("unstranded", "tpm_unstranded", "tpm")
_VERSION = re.compile(r"\.\d+$")


@dataclass
class Matrix:
    """A labelled 2-D frame: row labels, column labels and the values."""

    index: list
    columns: list
    values: np.ndarray

    def __len__(self) -> int:
        return len(self.index)

    @property
    def shape(self) -> tuple:
        return self.values.shape

    def to_csv(self, path, index_label: str = "") -> None:
        """``DataFrame.to_csv(path)``: the index first, under
        ``index_label``."""
        tables.write_csv(path, [index_label, *self.columns],
                         ([label, *row] for label, row in
                          zip(self.index, self.values.tolist())))


def _as_str(v) -> str:
    """A cell as pandas' ``astype(str)`` writes it (NaN as ``nan``)."""
    return "nan" if tables.is_missing(v) else tables.format_value(v)


def read_star_counts_tsv(path):
    """One STAR gene-counts TSV -> ``(gene_ids, values)`` (a list of str and
    a float64 array), or None.

    ``#`` comments skipped, ``N_`` summary rows dropped, the count column
    ``unstranded`` / ``tpm_unstranded`` / ``tpm`` (else the last column),
    version suffixes stripped from the gene ids, values coerced to numbers
    and the non-numeric ones dropped — as the JAX module's pandas calls do.
    """
    try:
        t = tables.read_table(path, sep="\t", comment="#")
    except (OSError, EOFError, ValueError, UnicodeDecodeError) as e:
        log.warning("unreadable counts file %s: %s", path, e)
        return None
    if "gene_id" not in t.columns:
        return None
    genes = [_as_str(g) for g in t.column("gene_id")]
    keep = [not g.startswith("N_") for g in genes]
    col = next((c for c in PREFERRED_COUNT_COLUMNS if c in t.columns),
               t.columns[-1])
    values = np.array([tables.to_numeric(v) for v, k in
                       zip(t.column(col), keep) if k], np.float64)
    ids = [_VERSION.sub("", g) for g, k in zip(genes, keep) if k]
    ok = ~np.isnan(values)
    return [g for g, o in zip(ids, ok) if o], values[ok]


def build_rnaseq_matrix(rnaseq_root) -> Matrix:
    """Scan <root>/<uuid>/ dirs for counts TSVs -> (samples x genes)
    :class:`Matrix`: rows the directory names in sorted order, columns the
    union of the genes in string order, NaN where a sample lacks a gene."""
    rows = {}
    root = Path(rnaseq_root)
    for d in sorted(p for p in root.iterdir() if p.is_dir()):
        tsvs = sorted(
            list(d.glob("*.tsv")) + list(d.glob("*.tsv.gz"))
            + list(d.glob("*counts*"))
        )
        for t in tsvs:
            s = read_star_counts_tsv(t)
            if s is not None and len(s[0]):
                rows[d.name] = dict(zip(*s))
                break
    if not rows:
        return Matrix([], [], np.zeros((0, 0)))
    genes = sorted(set().union(*rows.values()))
    values = np.array([[r.get(g, math.nan) for g in genes]
                       for r in rows.values()], np.float64)
    return Matrix(list(rows), genes, values)


def normalize_rnaseq(matrix: Matrix, top_k: int = 5000, eps: float = 1e-8):
    """log2(x+1) -> per-gene z-score -> top_k genes by variance.

    Returns (normalized :class:`Matrix`, selected gene list)."""
    x = np.log2(matrix.values.astype(np.float64) + 1.0)
    mean = x.mean(axis=0)
    std = x.std(axis=0)
    z = (x - mean) / (std + eps)
    var = z.var(axis=0)
    k = min(top_k, z.shape[1])
    top = np.argsort(var)[::-1][:k]
    top = np.sort(top)  # keep gene order stable
    genes = [matrix.columns[i] for i in top]
    return Matrix(list(matrix.index), genes, z[:, top]), genes


def mutation_matrix_from_maf(maf_path, min_patients: int = 0) -> Matrix:
    """MAF -> binary (patients x genes) int64 mutation :class:`Matrix`
    (``pd.crosstab`` clipped at 1: rows and columns sorted).

    Patient id = Tumor_Sample_Barcode[:12] (TCGA-XX-XXXX)."""
    maf = tables.read_table(maf_path, sep="\t", comment="#")
    need = {"Hugo_Symbol", "Tumor_Sample_Barcode"}
    if not need <= set(maf.columns):
        raise ValueError(f"MAF missing columns {need - set(maf.columns)}")
    pairs = {(str(b)[:12], str(g)) for b, g in
             zip(maf.column("Tumor_Sample_Barcode"),
                 maf.column("Hugo_Symbol"))
             if not tables.is_missing(b) and not tables.is_missing(g)}
    patients = sorted({p for p, _ in pairs})
    genes = sorted({g for _, g in pairs})
    values = np.zeros((len(patients), len(genes)), np.int64)
    pi = {p: i for i, p in enumerate(patients)}
    gi = {g: j for j, g in enumerate(genes)}
    for p, g in pairs:
        values[pi[p], gi[g]] = 1
    if min_patients:
        keep = values.sum(axis=0) >= min_patients
        genes = [g for g, k in zip(genes, keep) if k]
        values = values[:, keep]
    return Matrix(patients, genes, values)


def merge_mutation_matrices(mats: list) -> Matrix:
    """Several MAFs' matrices as one: ``pd.concat(mats).groupby(level=0)
    .max().fillna(0).astype(int)`` (rows sorted, columns in order of first
    appearance)."""
    genes = list(dict.fromkeys(g for m in mats for g in m.columns))
    patients = sorted({p for m in mats for p in m.index})
    pi = {p: i for i, p in enumerate(patients)}
    gi = {g: j for j, g in enumerate(genes)}
    values = np.zeros((len(patients), len(genes)), np.int64)
    for m in mats:
        rows = [pi[p] for p in m.index]
        cols = [gi[g] for g in m.columns]
        block = values[np.ix_(rows, cols)]
        values[np.ix_(rows, cols)] = np.maximum(block, m.values)
    return Matrix(patients, genes, values)


def concat_cnv_segments(cnv_root) -> tables.Table:
    """Concatenate raw CNV segment files (the reference keeps them raw)."""
    frames = []
    for p in sorted(Path(cnv_root).rglob("*.txt")) + sorted(
            Path(cnv_root).rglob("*.tsv")):
        try:
            frames.append(tables.read_table(p, sep="\t"))
        except (OSError, ValueError, UnicodeDecodeError) as e:
            log.warning("skipping CNV file %s: %s", p, e)
    return tables.concat(frames) if frames else tables.Table([])

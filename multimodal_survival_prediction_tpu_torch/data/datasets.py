"""Array dataset builders: matching table + RNA CSV + NIfTIs -> arrays.

Port of ``multimodal_survival_prediction_tpu/data/datasets.py`` without
pandas: a table is a sequence of row dicts (``load_matching_table``, or
``df.to_dict("records")`` of a DataFrame), the RNA matrix an
:class:`RNAMatrix`. Each volume is decoded once and resampled/normalized on
the device; the cohort comes back as fixed-shape numpy arrays:

  image   (N, D, H, W, 1) float32   zeros when missing
  rnaseq  (N, rna_dim)    float32   zeros when missing
  clinical(N, 1)          float32   age/100, 0 when missing
  mask    (N, 3)          float32   [has_image, has_rnaseq, has_clinical]
  time    (N,)            float32   survival_time (0 when NaN)
  event   (N,)            float32   survival_status (0 when NaN and unlabeled)
  svalid  (N,)            float32   has_survival (labels usable)

Failure semantics preserved: an unreadable NIfTI degrades to a zero volume
with mask=0 (the reference's silent ``except: pass``), logged here.
"""

from __future__ import annotations

import csv
import logging
import math
from dataclasses import dataclass, field

import numpy as np

log = logging.getLogger(__name__)


def _isnan(x) -> bool:
    try:
        return math.isnan(float(x))
    except (TypeError, ValueError):
        return True


@dataclass
class CohortArrays:
    patient_ids: list
    arrays: dict  # str -> np.ndarray, all leading dim N
    # where the CT resample ran ('device'; None = no imaging) — recorded
    # into fold .meta.json so scoring-time ingest matches training-time
    ingest_mode: str | None = None
    index: dict = field(init=False)

    def __post_init__(self):
        self.index = {p: i for i, p in enumerate(self.patient_ids)}

    @property
    def n(self) -> int:
        return len(self.patient_ids)

    def rows(self, patient_ids) -> np.ndarray:
        return np.asarray([self.index[p] for p in patient_ids], np.int32)

    def to_device(self, device="cuda") -> dict:
        """The arrays as tensors on ``device`` (the trainer's data dict)."""
        import torch

        from ..utils.device import resolve_device

        dev = resolve_device(device)
        return {k: torch.from_numpy(v).to(dev) for k, v in self.arrays.items()}


@dataclass
class RNAMatrix:
    """The mapped RNA-seq matrix: one row per patient (duplicates dropped,
    first kept — reference map_rnaseq_via_gdc_api.py:104-108)."""

    patient_ids: list
    genes: list
    values: np.ndarray  # (n_patients, n_genes) float32
    index: dict = field(init=False)

    def __post_init__(self):
        self.index = {p: i for i, p in enumerate(self.patient_ids)}

    @property
    def n_genes(self) -> int:
        return self.values.shape[1]

    def row(self, patient_id) -> np.ndarray:
        return self.values[self.index[patient_id]]


def select_cohort(table, model_name: str) -> list:
    """Per-model cohort rules, matching each reference script's filter
    (the JAX ``select_cohort``):

      rnaseq_only:     has_rnaseq & has_survival
      simple_fusion:   has_imaging & has_rnaseq & has_survival
      flexible/simmim/mmsurv: has_survival
      final:           has_imaging & survival_time notna
      partial_modality: ALL patients; labels handled via svalid
      image_only:      has_imaging & has_survival
    """
    rules = {
        "rnaseq_only": lambda r: r["has_rnaseq"] and r["has_survival"],
        "simple_fusion": lambda r: (r["has_imaging"] and r["has_rnaseq"]
                                    and r["has_survival"]),
        "flexible_multimodal": lambda r: r["has_survival"],
        "simmim": lambda r: r["has_survival"],
        "mmsurv": lambda r: r["has_survival"],
        "final": lambda r: r["has_imaging"] and not _isnan(r["survival_time"]),
        "partial_modality": lambda r: True,
        "image_only": lambda r: r["has_imaging"] and r["has_survival"],
    }
    if model_name not in rules:
        raise ValueError(f"unknown model {model_name!r}")
    keep = rules[model_name]
    return [r for r in table if bool(keep(r))]


def load_rnaseq_matrix(rnaseq_csv) -> RNAMatrix:
    """Read the RNA CSV (patient id column, then one column per gene)."""
    with open(rnaseq_csv, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        ids, rows, seen = [], [], set()
        for r in reader:
            if not r or r[0] in seen:
                continue
            seen.add(r[0])
            ids.append(r[0])
            rows.append([v if v.strip() else "nan" for v in r[1:]])
    genes = header[1:]
    values = (np.asarray(rows, dtype=np.float64).astype(np.float32)
              if rows else np.zeros((0, len(genes)), np.float32))
    return RNAMatrix(patient_ids=ids, genes=genes, values=values)


def build_cohort_arrays(
    table,
    rnaseq: RNAMatrix | None,
    with_image: bool,
    image_shape=(64, 64, 32),
    use_pallas: bool = False,
    prefetcher=None,
    hu_window=None,
    resample: str | None = None,
    device="cuda",
) -> CohortArrays:
    """Build the fixed-shape array set for one cohort.

    ``use_pallas`` keeps the JAX name: True routes every CT through the
    fused CUDA resample (``ops.resample.resample_normalize_cuda``).
    ``prefetcher``: optional ``pipeline.VolumePrefetcher``; the default one
    resamples on ``device``."""
    table = list(table)
    pids = [r["patient_id"] for r in table]
    n = len(pids)
    rna_dim = rnaseq.n_genes if rnaseq is not None else 0

    arrays = {
        "rnaseq": np.zeros((n, rna_dim), np.float32),
        "clinical": np.zeros((n, 1), np.float32),
        "mask": np.zeros((n, 3), np.float32),
        "time": np.zeros((n,), np.float32),
        "event": np.zeros((n,), np.float32),
        "svalid": np.zeros((n,), np.float32),
    }
    if with_image:
        arrays["image"] = np.zeros((n, *image_shape, 1), np.float32)

    for i, row in enumerate(table):
        pid = row["patient_id"]
        if rnaseq is not None and pid in rnaseq.index:
            arrays["rnaseq"][i] = rnaseq.row(pid)
            arrays["mask"][i, 1] = 1.0
        age = row["age"]
        if not _isnan(age):
            arrays["clinical"][i, 0] = float(age) / 100.0
            arrays["mask"][i, 2] = 1.0
        t = row["survival_time"]
        arrays["time"][i] = 0.0 if _isnan(t) else float(t)
        # NaN-guard like `time` (0 * NaN would poison the masked loss); a
        # LABELED row with a NaN status is contradictory upstream data, so
        # it fails loudly instead of silently training as censored
        ev = row["survival_status"]
        if _isnan(ev) and bool(row["has_survival"]):
            raise ValueError(
                f"patient {pid}: has_survival is set but survival_status "
                "is NaN — fix the matching table (a labeled row cannot "
                "have an undefined event status)")
        arrays["event"][i] = 0.0 if _isnan(ev) else float(ev)
        arrays["svalid"][i] = float(bool(row["has_survival"]))

    ingest_mode = None
    if with_image:
        if prefetcher is None:
            from .pipeline import VolumePrefetcher

            prefetcher = VolumePrefetcher(device=device)
        jobs = [(i, row["nifti_path"]) for i, row in enumerate(table)
                if bool(row["has_imaging"]) and row["nifti_path"]]
        for i, vol in prefetcher.run(jobs, image_shape, use_pallas,
                                     hu_window=hu_window, resample=resample):
            if vol is not None:
                arrays["image"][i, ..., 0] = vol
                arrays["mask"][i, 0] = 1.0
        ingest_mode = prefetcher.last_mode

    return CohortArrays(patient_ids=pids, arrays=arrays,
                        ingest_mode=ingest_mode)

"""Inference: load fold checkpoints, score a cohort, emit predictions.

Port of ``multimodal_survival_prediction_tpu/train/predict.py``
(``predict_risk``, ``fold_checkpoints``) with the same semantics — meta
defaults, the ``use_pallas_resample`` pin, the fold-ensemble z-score — over
fold checkpoints in any of the three formats of ``io/checkpoint.py``
(``fold_K_best.pt``, the JAX package's ``.msgpack``, the reference's
``.pth``; an ensemble may mix them). It returns a dict of numpy columns
instead of a DataFrame:

    pred = predict_risk(cfg, "models/partial_modality/fold_1_best.pt",
                        load_matching_table(csv), rnaseq_csv)
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import numpy as np
import torch

from ..config import ModelRunConfig
from ..data.datasets import build_cohort_arrays, load_rnaseq_matrix, select_cohort
from ..io.checkpoint import SUFFIXES, load_checkpoint, load_fold_meta
from ..utils.device import resolve_device
from .adapters import make_model_and_adapters


def predict_risk(
    cfg: ModelRunConfig,
    checkpoint_path,
    table,
    rnaseq_csv=None,
    backbone: str | None = None,
    labeled_only: bool = True,
    batch_size: int = 64,
    use_pallas: bool | None = None,
    hu_window=None,
    return_fold_stats: bool = False,
    device="cuda",
):
    """Score a cohort with a fold checkpoint — or a FOLD ENSEMBLE when
    ``checkpoint_path`` is a sequence of paths (per-fold z-scored
    log-hazards averaged).

    ``table`` is a sequence of matching-table row dicts. ``backbone`` /
    ``hu_window`` / image shape / ``use_pallas`` (the fused CUDA CT
    resample) default from the checkpoint's ``.meta.json``; explicit
    arguments win. A ``resample_mode`` of 'host' in the meta raises (the
    host engine is not ported).

    Returns ``{"patient_id", "risk_score", "survival_time", "event"}``
    numpy columns (labeled patients only unless ``labeled_only=False``);
    with ``return_fold_stats`` also the per-fold (mu, sd) over the whole
    cohort, the pairs ``serving.RiskScorer(fold_calibration=...)`` takes."""
    dev = resolve_device(device)
    paths = ([checkpoint_path]
             if isinstance(checkpoint_path, (str, Path))
             else list(checkpoint_path))
    meta = load_fold_meta(paths[0]) or {}
    backbone = backbone or meta.get("backbone") or "densenet121"
    if hu_window is None and meta.get("hu_window"):
        hu_window = tuple(meta["hu_window"])
    if use_pallas is None:
        use_pallas = bool(meta.get("use_pallas_resample", False))
    resample_mode = meta.get("resample_mode")
    if meta.get("image_shape") and tuple(meta["image_shape"]) != tuple(
            cfg.image_shape):
        cfg = dataclasses.replace(cfg, image_shape=tuple(meta["image_shape"]))

    cohort = select_cohort(table, cfg.name)
    rnaseq = None
    if "rnaseq" in cfg.modalities and rnaseq_csv is not None and Path(
            rnaseq_csv).exists():
        rnaseq = load_rnaseq_matrix(rnaseq_csv)
        if cfg.name == "rnaseq_only":
            cohort = [r for r in cohort if r["patient_id"] in rnaseq.index]

    # hu_window / use_pallas must match what training ingest used
    arrays = build_cohort_arrays(
        cohort, rnaseq, with_image="image" in cfg.modalities,
        image_shape=cfg.image_shape, use_pallas=use_pallas,
        hu_window=hu_window, resample=resample_mode, device=dev)
    data = arrays.arrays
    n = arrays.n

    model, batch_to_inputs, hazard_and_aux = make_model_and_adapters(
        cfg, rna_dim=data["rnaseq"].shape[1], backbone=backbone)
    hazard_and_aux = hazard_and_aux or (lambda out, b: (out, 0.0))
    model = model.to(dev).eval()

    per_ckpt = np.empty((len(paths), n), np.float32)
    with torch.inference_mode():
        for ci, cp in enumerate(paths):
            model.load_state_dict(
                load_checkpoint(cp, dev, model_name=cfg.name), strict=True)
            for start in range(0, n, batch_size):
                end = min(start + batch_size, n)
                batch = {k: torch.from_numpy(v[start:end]).to(dev)
                         for k, v in data.items()}
                batch["valid"] = batch["svalid"]
                out = model(*batch_to_inputs(batch))
                per_ckpt[ci, start:end] = (
                    hazard_and_aux(out, batch)[0].float().cpu().numpy())

    if len(paths) == 1:
        hazards = per_ckpt[0]
    else:
        # Cox log-hazards are defined up to a per-model shift (and scale
        # across folds): z-score each fold over the cohort, then average
        mu = per_ckpt.mean(axis=1, keepdims=True)
        sd = per_ckpt.std(axis=1, keepdims=True) + 1e-8
        hazards = ((per_ckpt - mu) / sd).mean(axis=0)

    pred = {
        "patient_id": np.asarray(arrays.patient_ids, dtype=object),
        "risk_score": hazards,
        "survival_time": data["time"],
        "event": data["event"],
    }
    if labeled_only:
        keep = data["svalid"] > 0
        pred = {k: v[keep] for k, v in pred.items()}
    if return_fold_stats:
        stats = [(float(per_ckpt[ci].mean()), float(per_ckpt[ci].std()))
                 for ci in range(len(paths))]
        return pred, stats
    return pred


def fold_checkpoints(models_dir, name: str):
    """All models/<name>/fold_K_best.{pt,msgpack,pth} paths, fold-ordered;
    raises if one fold has files of two formats."""
    d = Path(models_dir) / name
    by_fold: dict = {}
    for p in d.glob("fold_*_best.*"):
        m = re.fullmatch(r"fold_(\d+)_best(\.\w+)", p.name)
        if m and m[2] in SUFFIXES:
            by_fold.setdefault(int(m[1]), []).append(p)
    if not by_fold:
        raise FileNotFoundError(f"no fold checkpoints under {d}")
    twice = {k: sorted(v) for k, v in by_fold.items() if len(v) > 1}
    if twice:
        raise ValueError(f"folds with checkpoints in two formats under {d}: "
                         f"{ {k: [p.name for p in v] for k, v in twice.items()} }")
    return [by_fold[k][0] for k in sorted(by_fold)]


def fold_checkpoint(models_dir, name: str, fold: int):
    """models/<name>/fold_<fold>_best in whichever format it was written."""
    for p in fold_checkpoints(models_dir, name):
        if p.name.startswith(f"fold_{fold}_best."):
            return p
    raise FileNotFoundError(
        f"no checkpoint of fold {fold} under {Path(models_dir) / name}")

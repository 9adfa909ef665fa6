"""Shared CLI plumbing of the port's training entry points (the
counterpart of ``scripts/training/common.py``).

Each entry point is a thin wrapper over :func:`run_training`: the same
cohort rules, hyperparameter defaults and artifacts as the JAX scripts
(``results/<model>/cv_results.json`` and ``models/<model>/fold_K_best.pt``
with its ``.meta.json``), with flags instead of edited constants.

The CLI pins the precision policy of the process
(``utils.device.pin_fp32_policy``: TF32 off for cuDNN and for matmuls, so
convolutions and products run in true fp32 as the JAX reference computes
them) and logs both flags. Library functions set no global flags.

Flags of the JAX scripts that have no port yet stay in the parser and raise
``NotImplementedError`` naming their ROADMAP.md item; ``--device`` (default
``cuda``) is the port's own.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
from pathlib import Path

import torch

from ..data.matching_table import load_matching_table
from ..data.synthetic import SyntheticCohortSpec, generate_synthetic_cohort
from ..utils import parse_hu_window
from ..utils.device import pin_fp32_policy
from .cv import run_cross_validation

log = logging.getLogger(__name__)

# (flag, attribute, value when unused, ROADMAP.md item)
_NOT_PORTED = (
    ("--mesh", "mesh", 0, "Queue 1 item 10 (multi-device paths)"),
    ("--fold-parallel", "fold_parallel", 0,
     "Queue 1 item 9 (fold-parallel CV)"),
    ("--fold-dp", "fold_dp", 1, "Queue 1 item 9 (fold-parallel CV)"),
    ("--tp", "tp", 1, "Queue 1 item 10 (multi-device paths)"),
    ("--remat", "remat", False, "Queue 1 item 16 (remat)"),
    ("--streaming", "streaming", False,
     "Queue 1 item 11 (streaming epochs)"),
    ("--sharded-risk-set", "sharded_risk_set", False,
     "Queue 1 item 10 (multi-device paths)"),
    ("--multihost", "multihost", False,
     "Queue 1 item 10 (multi-device paths)"),
    ("--aot-cache", "aot_cache", None, "Queue 1 item 12 (io/aot_cache.py)"),
    ("--profile-dir", "profile_dir", None,
     "Queue 1 item 11 (utils/profiling.py)"),
)


def base_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--data-root", default=".",
                   help="root containing data/processed/full_matching_table.csv")
    p.add_argument("--results-dir", default="results")
    p.add_argument("--models-dir", default="models")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--n-folds", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--backbone", default="densenet121",
                   choices=["densenet121", "simple_cnn"],
                   help="CT encoder (simple_cnn = the reference's MONAI-less "
                        "fallback)")
    p.add_argument("--synthetic", action="store_true",
                   help="generate & train on a synthetic cohort under "
                        "--data-root (no TCGA data)")
    p.add_argument("--synthetic-patients", type=int, default=64)
    p.add_argument("--image-shape", default=None,
                   help="D,H,W for the CT training tensor (default 64,64,32)")
    p.add_argument("--pallas-resample", action="store_true",
                   help="resample every CT with the CUDA W-pass kernel (the "
                        "JAX flag's name, kept)")
    p.add_argument("--hu-window", default=None,
                   help="CT Hounsfield window 'lo,hi' (use the = form for "
                        "negative bounds: --hu-window=-150,250) applied "
                        "before normalization")
    p.add_argument("--ties", default=None, choices=["breslow", "efron"],
                   help="Cox ties handling (default breslow = reference "
                        "parity)")
    p.add_argument("--resume", action="store_true",
                   help="checkpoint the full train state periodically and "
                        "resume an interrupted CV run")
    p.add_argument("--checkpoint-every", type=int, default=10)
    p.add_argument("--stage1-epochs", type=int, default=None,
                   help="SimMLM's expert-pretraining epochs (two-stage "
                        "models only)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute dtype for every layer of the model "
                        "(parameters, optimizer state and checkpoints stay "
                        "float32)")
    p.add_argument("--device", default="cuda",
                   help="where to train: cuda (default) or cpu")
    for flag, dest, unused, item in _NOT_PORTED:
        kw = ({"action": "store_true"} if unused is False
              else {"type": int if isinstance(unused, int) else str,
                    "default": unused})
        p.add_argument(flag, dest=dest, help=f"not ported yet: {item}", **kw)
    return p


def run_training(args, cfg):
    """Train ``cfg`` under K-fold CV as the parsed ``args`` say; returns the
    cv_results payload."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    for flag, dest, unused, item in _NOT_PORTED:
        if getattr(args, dest) != unused:
            raise NotImplementedError(
                f"{flag} is not ported yet: ROADMAP.md {item}")
    if args.stage1_epochs is not None and not cfg.stage1_epochs:
        raise SystemExit(
            f"--stage1-epochs only applies to two-stage models (SimMLM); "
            f"'{cfg.name}' has no stage 1")
    log.info(pin_fp32_policy())

    cfg = dataclasses.replace(cfg, **{k: v for k, v in dict(
        num_epochs=args.epochs, n_folds=args.n_folds,
        batch_size=args.batch_size, learning_rate=args.learning_rate,
        seed=args.seed, stage1_epochs=args.stage1_epochs, ties=args.ties,
        image_shape=(tuple(int(x) for x in args.image_shape.split(","))
                     if args.image_shape else None),
    ).items() if v is not None})

    root = Path(args.data_root)
    if args.synthetic:
        table, paths = generate_synthetic_cohort(
            root, SyntheticCohortSpec(n_patients=args.synthetic_patients))
        rnaseq_csv = paths["rnaseq_csv"]
    else:
        table_csv = root / "data" / "processed" / "full_matching_table.csv"
        if cfg.name == "final":
            # final_multimodal reads the 109-patient table while every other
            # trainer reads the 608-patient one (reference
            # final_multimodal.py:205, SURVEY §2.13)
            mm = root / "data" / "processed" / "multimodal_matching_table.csv"
            if mm.exists():
                table_csv = mm
        table = load_matching_table(table_csv)
        rnaseq_csv = root / "data" / "processed" / "rnaseq_normalized_mapped.csv"
        if not rnaseq_csv.exists():
            rnaseq_csv = None

    payload, outcomes = run_cross_validation(
        cfg, table, rnaseq_csv=rnaseq_csv, results_dir=args.results_dir,
        models_dir=args.models_dir, backbone=args.backbone,
        dtype=torch.bfloat16 if args.bf16 else None,
        use_pallas_resample=args.pallas_resample,
        hu_window=parse_hu_window(args.hu_window), resume=args.resume,
        checkpoint_every=args.checkpoint_every, device=args.device)
    print(f"\n{cfg.display_name}: C-index "
          f"{payload['c_index_mean']:.4f} ± {payload['c_index_std']:.4f}")
    for o in outcomes:
        print(f"  fold {o.fold}: best {o.best_c_index:.4f} "
              f"@ epoch {o.best_epoch} ({o.epochs_run} epochs run)")
    return payload

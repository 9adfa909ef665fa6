"""Vmapped hyperparameter sweep: many (seed, learning-rate) candidates
trained in the same step on one fold's split (port of
``multimodal_survival_prediction_tpu/train/sweep.py``), and its CLI (the
counterpart of ``scripts/training/sweep.py``):

    python -m multimodal_survival_prediction_tpu_torch.train.sweep \\
        --model rnaseq_only --seeds 42,43 --lrs 1e-4,3e-4 --data-root <root>

The candidates' states are stacked on a leading axis and trained by the
fold-parallel driver's epochs (``train/cv_parallel.py:train_stacked``):
seeds vary through each candidate's init, shuffle and dropout generators,
learning rates through the per-candidate LR vector. A candidate with seed ``s``
starts as the sequential driver's fold ``fold`` would with ``cfg.seed =
s``: ``Trainer.init_state(fold, seed=s)`` (weights, and dropout from
``s*1000 + fold``) and ``default_rng(s + fold)``; so the candidate with
``cfg.seed`` and ``cfg.learning_rate`` follows that driver's trajectory.
Candidates that differ in weight decay or optimizer family need separate
sweeps.

A candidate mesh (``mesh``, from ``cv_parallel.make_fold_mesh``) spreads
the candidates over its fold axis as the fold-parallel driver spreads
folds: padded to a multiple of the axis (the dummies are not reported),
each fold row training its block, every rank keeping every candidate's
record; the coordinator writes ``sweep_results.json``. ``--sweep-mesh N``
starts N ranks (``train/cli.py:spawn_ranks``), one a GPU under NCCL or
gloo CPU ranks with ``--device cpu``. ``remat`` recomputes the DenseNet
dense layers in the backward.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

import torch.distributed as dist

from ..config import ModelRunConfig
from ..parallel.mesh import mesh_shape
from ..parallel.multihost import is_coordinator
from ..utils.device import resolve_device
from .cv import _compute_dtype, make_trainers, prepare_cv_data
from .cv_parallel import (
    fold_placement,
    init_stacked,
    make_fold_mesh,
    train_stacked,
)

log = logging.getLogger(__name__)


def run_hyperparameter_sweep(
    cfg: ModelRunConfig,
    table,
    rnaseq_csv=None,
    seeds=(42,),
    learning_rates=None,
    fold: int = 1,
    mesh=None,
    fold_axis: str = "fold",
    backbone: str = "densenet121",
    dtype=None,
    remat: bool = False,
    num_epochs: int | None = None,
    results_dir=None,
    use_pallas_resample: bool = False,
    hu_window=None,
    prepared=None,
    init_hook=None,
    device="cuda",
):
    """Train every (seed, lr) candidate in parallel on fold ``fold``'s
    split (1-based, of the seed-``cfg.seed`` KFold) on ``device``.

    ``prepared``: an ``(arrays, splits)`` from ``prepare_cv_data``;
    ``init_hook``: ``(candidate, state) -> state | None`` after each
    candidate's ``init_state`` (``candidate`` 0-based, in the order of
    ``[(s, lr) for s in seeds for lr in learning_rates]``). ``mesh``:
    a fold mesh whose ``fold_axis`` carries the candidates (module
    docstring; every rank calls with the same arguments).

    Returns the leaderboard: dicts ``{seed, learning_rate, best_c_index,
    best_epoch, history}`` sorted by best val C-index, best first; with
    ``results_dir``, also writes ``<results_dir>/<model>/
    sweep_results.json`` (JAX's keys; the coordinator writes)."""
    num_epochs = num_epochs or cfg.num_epochs
    learning_rates = list(learning_rates or [cfg.learning_rate])
    points = [(s, lr) for s in seeds for lr in learning_rates]
    n_points = len(points)
    dev = resolve_device(device)
    dtype = _compute_dtype(dtype)

    arrays, splits = prepared if prepared is not None else prepare_cv_data(
        cfg, table, rnaseq_csv=rnaseq_csv,
        use_pallas_resample=use_pallas_resample, hu_window=hu_window,
        device=dev)
    train_rows, val_rows, _ = splits[fold - 1]
    rna_dim = arrays.arrays["rnaseq"].shape[1]
    placement = fold_placement(n_points, mesh, fold_axis)
    # the dummy candidates (k_pad > n_points) repeat the last one; they
    # compute but are never reported
    padded = points + [points[-1]] * (placement.k_pad - n_points)
    data_mesh = mesh if mesh_shape(mesh).get("data", 1) > 1 else None
    trainer, stage1_trainer = make_trainers(cfg, rna_dim, backbone, dtype,
                                            dev, remat=remat, mesh=data_mesh)
    data = arrays.to_device(dev)

    t_start = time.monotonic()
    hook = init_hook and (lambda k, st: init_hook(k, st)
                          if k < n_points else None)
    state = init_stacked(trainer, [(k, fold, padded[k][0])
                                   for k in placement.local], hook)

    run = train_stacked(
        trainer, stage1_trainer, state, cfg, data,
        [train_rows] * placement.k_pad, [val_rows] * placement.k_pad,
        [lr for _, lr in padded],
        [np.random.default_rng(s + fold) for s, _ in padded], num_epochs,
        keep_best=False, tag="sweep", unit="candidate", placement=placement)

    leaderboard = sorted(
        (dict(seed=s, learning_rate=lr, best_c_index=float(run.best_c[k]),
              best_epoch=int(run.best_epoch[k]), history=run.histories[k])
         for k, (s, lr) in enumerate(points)),
        key=lambda r: -r["best_c_index"])
    elapsed = time.monotonic() - t_start
    log.info("[%s sweep] %d candidates x %d epochs in %.1fs; top: seed=%d "
             "lr=%g C=%.4f", cfg.name, n_points, num_epochs, elapsed,
             leaderboard[0]["seed"], leaderboard[0]["learning_rate"],
             leaderboard[0]["best_c_index"])
    if results_dir is not None and is_coordinator():
        out = Path(results_dir) / cfg.name / "sweep_results.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({
            "model": cfg.display_name, "fold": fold,
            "num_epochs": num_epochs,
            "candidates": [{k: v for k, v in r.items() if k != "history"}
                           for r in leaderboard]}, indent=2))
    return leaderboard


# base_parser flags the sweep driver does not honour: (flag, attribute,
# value when unused), as scripts/training/sweep.py refuses them
_REFUSED = (("--mesh", "mesh", 0), ("--tp", "tp", 1),
            ("--fold-parallel", "fold_parallel", 0),
            ("--fold-dp", "fold_dp", 1), ("--resume", "resume", False),
            ("--profile-dir", "profile_dir", None),
            ("--streaming", "streaming", False),
            ("--sharded-risk-set", "sharded_risk_set", False),
            ("--aot-cache", "aot_cache", None),
            ("--multihost", "multihost", False))


def main(argv=None):
    """The sweep CLI; returns the leaderboard."""
    from ..config import ALL_CONFIGS
    from ..utils.device import pin_fp32_policy
    from .cli import base_parser, check_ranks_fit, load_cohort, spawn_ranks

    p: argparse.ArgumentParser = base_parser(__doc__.splitlines()[0])
    p.add_argument("--model", default="rnaseq_only",
                   help="config key (see config.ALL_CONFIGS)")
    p.add_argument("--seeds", default=None,
                   help="comma-separated init/shuffle seeds to sweep "
                        "(default: the model's base seed)")
    p.add_argument("--lrs", default=None,
                   help="comma-separated base learning rates to sweep "
                        "(default: --learning-rate or the model's base LR)")
    p.add_argument("--fold", type=int, default=1,
                   help="which seed-42 KFold split supplies train/val")
    p.add_argument("--sweep-mesh", type=int, default=0,
                   help="shard candidates over an N-device fold mesh (N "
                        "ranks, started here unless a process group "
                        "exists)")
    args = p.parse_args(argv)
    for flag, dest, unused in _REFUSED:
        if getattr(args, dest) != unused:
            raise SystemExit(f"{flag} is not supported by the sweep driver "
                             f"(candidates parallelize via --sweep-mesh)")

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    cfg = ALL_CONFIGS[args.model]
    if args.stage1_epochs is not None and not cfg.stage1_epochs:
        raise SystemExit(
            f"--stage1-epochs only applies to two-stage models (SimMLM); "
            f"'{cfg.name}' has no stage 1")
    log.info(pin_fp32_policy())
    cfg = dataclasses.replace(cfg, **{k: v for k, v in dict(
        n_folds=args.n_folds, batch_size=args.batch_size,
        stage1_epochs=args.stage1_epochs, ties=args.ties,
        image_shape=(tuple(int(x) for x in args.image_shape.split(","))
                     if args.image_shape else None),
    ).items() if v is not None})
    seeds = (tuple(int(s) for s in args.seeds.split(","))
             if args.seeds else
             ((args.seed,) if args.seed is not None else (cfg.seed,)))
    lrs = (tuple(float(x) for x in args.lrs.split(","))
           if args.lrs else
           ((args.learning_rate,) if args.learning_rate is not None
            else None))
    if args.sweep_mesh > 1 and not dist.is_initialized():
        check_ranks_fit(args.sweep_mesh, args.device, "--sweep-mesh")
    # the 608-patient table for every model, as scripts/training/sweep.py
    table, rnaseq_csv = load_cohort(args, cfg, final_table=False)
    if args.sweep_mesh > 1 and not dist.is_initialized():
        board = spawn_ranks(args.sweep_mesh, args.device, args.results_dir,
                            _sweep_on_rank, args, cfg, table, rnaseq_csv,
                            seeds, lrs)
    else:
        board = _sweep_on_rank(args.device, args, cfg, table, rnaseq_csv,
                               seeds, lrs)
    if is_coordinator():
        print(f"\n{cfg.display_name} sweep — top candidates:")
        for r in board[:10]:
            print(f"  seed={r['seed']:<4d} lr={r['learning_rate']:<8g} "
                  f"best C={r['best_c_index']:.4f} @ epoch "
                  f"{r['best_epoch']}")
    return board


def _sweep_on_rank(device, args, cfg, table, rnaseq_csv, seeds, lrs):
    """The CLI's sweep on this process's ``device``, on a fold mesh of
    ``--sweep-mesh`` ranks when it is larger than 1 (module level: the
    spawned ranks run it)."""
    from ..utils import parse_hu_window

    mesh = (make_fold_mesh(args.sweep_mesh, device=device)
            if args.sweep_mesh > 1 else None)
    return run_hyperparameter_sweep(
        cfg, table, rnaseq_csv=rnaseq_csv, seeds=seeds, learning_rates=lrs,
        fold=args.fold, mesh=mesh, backbone=args.backbone,
        dtype=torch.bfloat16 if args.bf16 else None, remat=args.remat,
        num_epochs=args.epochs, results_dir=args.results_dir,
        use_pallas_resample=args.pallas_resample,
        hu_window=parse_hu_window(args.hu_window), device=device)


if __name__ == "__main__":
    main()
